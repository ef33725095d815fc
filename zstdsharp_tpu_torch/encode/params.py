"""Compression parameters of a level (the port's copy of the parts of
zstdsharp_tpu/encode/params.py that ``compress`` reaches; reference:
ZSTD_getCParams_internal, ZSTD_adjustCParams_internal, Clevels.cs:8).

``resolve(level, src_size, checksum)`` is the reference's
``CCtxParams(compression_level=level, checksum_flag=checksum).resolve(
src_size)``: the level's row for the source-size class, shrunk to the
source size, with the automatic long-distance-matching and block-splitter
switches.  No parameter can be overridden.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

from .. import constants as C
from ..constants import Strategy
from ..errors import ZstdErrorCode, check


def _size_class(src_size_hint: int, dict_size: int = 0) -> int:
    """The row family by source size (ZSTD_getCParams_internal)."""
    if src_size_hint < 0:  # unknown
        return 0
    add = src_size_hint + dict_size
    if add == 0:
        return 0
    b0, b1, b2 = C.ZSTD_SRCSIZEHINT_CLASSES
    if add >= b0:
        return 0
    if add > b1:
        return 1
    if add > b2:
        return 2
    return 3


@dataclass(frozen=True)
class CompressionParameters:
    window_log: int
    chain_log: int
    hash_log: int
    search_log: int
    min_match: int
    target_length: int
    strategy: Strategy

    @classmethod
    def from_level(cls, level: int,
                   src_size_hint: int = -1) -> "CompressionParameters":
        check(C.ZSTD_MIN_CLEVEL <= level <= C.ZSTD_MAX_CLEVEL,
              ZstdErrorCode.parameter_outOfBound, f"level {level}")
        if level == 0:
            level = C.ZSTD_DEFAULT_CLEVEL
        row = C.ZSTD_DEFAULT_CPARAMETERS[_size_class(src_size_hint)]
        if level < 0:
            # negative (fast) levels: the level-1 row with targetLength
            # = -level
            base = row[0]
            p = cls(*base[:5], -level, Strategy(base[6]))
        else:
            base = row[min(level, C.ZSTD_MAX_CLEVEL)]
            p = cls(*base[:6], Strategy(base[6]))
        return p.adjust(src_size_hint)

    def adjust(self, src_size: int = -1) -> "CompressionParameters":
        """ZSTD_adjustCParams_internal:2023 without a dictionary: shrink
        the logs to the content size (an unknown or empty source keeps
        the row)."""
        if src_size <= 0:
            return self
        known = max(src_size, 513)  # the reference's minimum source size
        p = self
        if known <= 1 << p.window_log:
            src_log = max(max(known - 1, 1).bit_length(), C.ZSTD_HASHLOG_MIN)
            if src_log < p.window_log:
                p = replace(p, window_log=src_log)
        bt = p.strategy in (Strategy.BTLAZY2, Strategy.BTOPT,
                            Strategy.BTULTRA, Strategy.BTULTRA2)
        cycle_log = p.chain_log - (1 if bt else 0)
        if cycle_log > p.window_log:
            p = replace(p, chain_log=p.chain_log - (cycle_log - p.window_log))
        if p.window_log < C.ZSTD_WINDOWLOG_ABSOLUTEMIN:
            p = replace(p, window_log=C.ZSTD_WINDOWLOG_ABSOLUTEMIN)
        if p.hash_log > p.window_log + 1:
            p = replace(p, hash_log=p.window_log + 1)
        return p


@dataclass
class ResolvedParams:
    cparams: CompressionParameters
    checksum: bool
    ldm: bool
    block_splitter: bool


def resolve(level: int, src_size_hint: int = -1,
            checksum: bool = False) -> ResolvedParams:
    cp = CompressionParameters.from_level(level, src_size_hint)
    # automatic switches: long-distance matching for large windows at high
    # levels, the block splitter from btopt up
    ldm = cp.window_log >= 27 and level >= 16
    split = int(cp.strategy) >= int(Strategy.BTOPT)
    return ResolvedParams(cp, bool(checksum), ldm, split)
