"""Compression parameters and level resolution: the port's copy of
zstdsharp_tpu/encode/params.py.

Reference: ZSTD_getCParams_internal (ZstdCompress.cs:7891),
ZSTD_adjustCParams_internal (:2023), bounds (ZSTD_cParam_getBounds:444),
level tables (Clevels.cs:8, mirrored exactly in constants.py).

Two-phase lifecycle like the reference (§3.5 of SURVEY.md): user-facing
`CompressionParameters.from_level` resolves the table row; `adjust` then
shrinks window/chain/hash logs to the actual source size at frame start.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

from .. import constants as C
from ..constants import Strategy
from ..errors import ZstdError, ZstdErrorCode, check


def _size_class(src_size_hint: int, dict_size: int = 0) -> int:
    """Pick the row family by source size (ZSTD_getCParams_internal)."""
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
    def from_level(cls, level: int, src_size_hint: int = -1,
                   dict_size: int = 0) -> "CompressionParameters":
        check(C.ZSTD_MIN_CLEVEL <= level <= C.ZSTD_MAX_CLEVEL,
              ZstdErrorCode.parameter_outOfBound, f"level {level}")
        if level == 0:
            level = C.ZSTD_DEFAULT_CLEVEL
        row = _size_class(src_size_hint, dict_size)
        if level < 0:
            # Negative (fast) levels: level-1 row with targetLength = -level
            # (ZSTD_getCParams_internal:7891 tail).
            base = C.ZSTD_DEFAULT_CPARAMETERS[row][0]
            p = cls(*base[:5], -level, Strategy(base[6]))
        else:
            lvl = min(level, C.ZSTD_MAX_CLEVEL)
            base = C.ZSTD_DEFAULT_CPARAMETERS[row][lvl]
            p = cls(base[0], base[1], base[2], base[3], base[4], base[5],
                    Strategy(base[6]))
        return p.adjust(src_size_hint, dict_size)

    def adjust(self, src_size: int = -1, dict_size: int = 0) -> "CompressionParameters":
        """ZSTD_adjustCParams_internal:2023 — shrink logs to content size.

        Unknown-size streams with a dictionary are attach-mode
        (ZSTD_cpm_attachDict zeroes dictSize): the dict must not shrink
        the window a long stream will need."""
        if src_size < 0:
            return self
        known = max(src_size, 0) + dict_size
        if known == 0:
            return self
        min_src_size = 513  # (1 << ZSTD_WINDOWLOG_ABSOLUTEMIN) + 1? ref uses 513
        if known < min_src_size and dict_size == 0 and src_size >= 0:
            known = min_src_size
        p = self
        if known <= 1 << p.window_log:
            src_log = max(known - 1, 1).bit_length()
            src_log = max(src_log, C.ZSTD_HASHLOG_MIN)
            if src_log < p.window_log:
                p = replace(p, window_log=src_log)
        cycle_log = p.chain_log - (1 if p.strategy in (Strategy.BTLAZY2, Strategy.BTOPT,
                                                       Strategy.BTULTRA, Strategy.BTULTRA2) else 0)
        # keep chainLog <= windowLog (+1 for BT strategies handled via cycleLog)
        if cycle_log > p.window_log:
            p = replace(p, chain_log=p.chain_log - (cycle_log - p.window_log))
        if p.window_log < C.ZSTD_WINDOWLOG_ABSOLUTEMIN:
            p = replace(p, window_log=C.ZSTD_WINDOWLOG_ABSOLUTEMIN)
        if p.hash_log > p.window_log + 1:
            p = replace(p, hash_log=p.window_log + 1)
        return p

    def validate(self) -> None:
        check(C.ZSTD_WINDOWLOG_MIN <= self.window_log <= C.ZSTD_WINDOWLOG_MAX,
              ZstdErrorCode.parameter_outOfBound, "windowLog")
        check(C.ZSTD_CHAINLOG_MIN <= self.chain_log <= C.ZSTD_CHAINLOG_MAX,
              ZstdErrorCode.parameter_outOfBound, "chainLog")
        check(C.ZSTD_HASHLOG_MIN <= self.hash_log <= C.ZSTD_HASHLOG_MAX,
              ZstdErrorCode.parameter_outOfBound, "hashLog")
        check(C.ZSTD_MINMATCH_MIN <= self.min_match <= C.ZSTD_MINMATCH_MAX,
              ZstdErrorCode.parameter_outOfBound, "minMatch")


@dataclass
class FrameParameters:
    content_size_flag: bool = True
    checksum_flag: bool = False
    no_dict_id_flag: bool = False


# Per-parameter set-time bounds (ZSTD_cParam_getBounds:444).  For the
# cParams 0 means "auto" and is always accepted, like the reference's
# advanced API where 0 resets a parameter to its level default.
PARAM_BOUNDS = {
    "compression_level": (C.ZSTD_MIN_CLEVEL, C.ZSTD_MAX_CLEVEL),
    "window_log": (C.ZSTD_WINDOWLOG_MIN, C.ZSTD_WINDOWLOG_MAX),
    "hash_log": (C.ZSTD_HASHLOG_MIN, C.ZSTD_HASHLOG_MAX),
    "chain_log": (C.ZSTD_CHAINLOG_MIN, C.ZSTD_CHAINLOG_MAX),
    "search_log": (C.ZSTD_SEARCHLOG_MIN, C.ZSTD_SEARCHLOG_MAX),
    "min_match": (C.ZSTD_MINMATCH_MIN, C.ZSTD_MINMATCH_MAX),
    "target_length": (C.ZSTD_TARGETLENGTH_MIN, C.ZSTD_TARGETLENGTH_MAX),
    "strategy": (1, 9),
    "target_cblock_size": (64, 1 << 17),  # experimentalParam6 bounds
    "n_workers": (0, 256),
}
_ZERO_IS_AUTO = frozenset(PARAM_BOUNDS) - {"compression_level", "n_workers"}
_BOOL_PARAMS = frozenset({"checksum_flag", "content_size_flag",
                          "dict_id_flag"})
_TRI_STATE_PARAMS = frozenset({"ldm", "block_splitter"})

# Parameters that may change while a stream is mid-frame
# (ZSTD_isUpdateAuthorized:724); everything else raises stage_wrong then.
UPDATABLE_DURING_STREAM = frozenset({
    "compression_level", "hash_log", "chain_log", "search_log",
    "min_match", "target_length", "strategy",
})


def get_parameter_bounds(name: str) -> tuple[int, int]:
    """ZSTD_cParam_getBounds:444 — (lower, upper) for a public parameter."""
    if name in PARAM_BOUNDS:
        return PARAM_BOUNDS[name]
    if name in _BOOL_PARAMS or name in _TRI_STATE_PARAMS:
        return (0, 1)
    raise ZstdError(ZstdErrorCode.parameter_unsupported, name)


@dataclass
class CCtxParams:
    """Advanced parameter set (subset of ZSTD_CCtx_params, ZstdCompress.cs:784).

    Parameters follow the same pending->applied model: mutate freely, then
    `resolve()` freezes them against the source size at frame start.
    `set_parameter` is the validating entry point: bounds are enforced at
    SET time (ZSTD_CCtx_setParameter:784 semantics), and while a stream is
    active only the ZSTD_isUpdateAuthorized:724 whitelist may change.
    """

    compression_level: int = C.ZSTD_DEFAULT_CLEVEL
    window_log: int = 0  # 0 = auto
    hash_log: int = 0
    chain_log: int = 0
    search_log: int = 0
    min_match: int = 0
    target_length: int = 0
    strategy: int = 0  # 0 = auto
    checksum_flag: bool = False
    content_size_flag: bool = True
    dict_id_flag: bool = True
    # Experimental/auto switches (tri-state: None = auto)
    ldm: bool | None = None
    block_splitter: bool | None = None
    target_cblock_size: int = 0
    n_workers: int = 0  # accepted; data-parallel device sharding instead

    def set_parameter(self, name: str, value) -> None:
        """Validating setter: unknown names raise parameter_unsupported,
        out-of-bounds values raise parameter_outOfBound immediately (the
        reference validates at set time, not at first compress), and
        non-whitelisted updates while a stream is mid-frame raise
        stage_wrong.  compression_level clamps to its bounds
        (ZSTD_cParam_clampBounds:702), matching libzstd's tolerance for
        out-of-range levels."""
        check(name in self.__dataclass_fields__,
              ZstdErrorCode.parameter_unsupported, name)
        if getattr(self, "_stream_active", False):
            check(name in UPDATABLE_DURING_STREAM, ZstdErrorCode.stage_wrong,
                  f"{name} cannot change mid-stream")
        if name in _TRI_STATE_PARAMS:
            check(value is None or isinstance(value, (bool, int)),
                  ZstdErrorCode.parameter_outOfBound, name)
            setattr(self, name, None if value is None else bool(value))
            return
        if name in _BOOL_PARAMS:
            check(isinstance(value, (bool, int)) and int(value) in (0, 1),
                  ZstdErrorCode.parameter_outOfBound, name)
            setattr(self, name, bool(value))
            return
        check(isinstance(value, int) and not isinstance(value, bool),
              ZstdErrorCode.parameter_outOfBound, name)
        lo, hi = PARAM_BOUNDS[name]
        if name == "compression_level":
            value = min(max(value, lo), hi)
        elif not (value == 0 and name in _ZERO_IS_AUTO):
            check(lo <= value <= hi, ZstdErrorCode.parameter_outOfBound,
                  f"{name}={value} outside [{lo}, {hi}]")
        setattr(self, name, value)

    def resolve(self, src_size_hint: int = -1, dict_size: int = 0) -> "ResolvedParams":
        cp = CompressionParameters.from_level(self.compression_level,
                                              src_size_hint, dict_size)
        overrides = {}
        for name in ("window_log", "hash_log", "chain_log", "search_log",
                     "min_match", "target_length"):
            v = getattr(self, name)
            if v:
                overrides[name] = v
        if self.strategy:
            overrides["strategy"] = Strategy(self.strategy)
        if overrides:
            cp = replace(cp, **overrides)
        cp.validate()
        ldm = self.ldm
        if ldm is None:  # auto: on for large windows at high levels (ref :276)
            ldm = cp.window_log >= 27 and self.compression_level >= 16
        split = self.block_splitter
        if split is None:  # auto: on from btopt up (ref :255)
            split = int(cp.strategy) >= int(Strategy.BTOPT)
        return ResolvedParams(cp, FrameParameters(self.content_size_flag,
                                                  self.checksum_flag,
                                                  not self.dict_id_flag),
                              ldm=ldm, block_splitter=split,
                              target_cblock_size=self.target_cblock_size)


@dataclass
class ResolvedParams:
    cparams: CompressionParameters
    fparams: FrameParameters
    ldm: bool = False
    block_splitter: bool = True
    target_cblock_size: int = 0


def estimate_cctx_size(level: int = C.ZSTD_DEFAULT_CLEVEL,
                       src_size_hint: int = -1) -> int:
    """ZSTD_estimateCCtxSize:2212 analog: bytes of matcher/entropy working
    state the native engine allocates for one frame at this level."""
    cp = CompressionParameters.from_level(level, src_size_hint)
    size = (1 << cp.hash_log) * 8            # hash heads
    if int(cp.strategy) >= 6:
        size += (2 << cp.chain_log) * 4      # binary-tree links
        size += (1 << 16) * 8                # hash3 heads
    elif int(cp.strategy) >= 2:
        size += (1 << cp.chain_log) * 8      # chain links
    size += ((1 << 17) // 3 + 16) * 12       # sequence scratch
    size += 1 << 17                          # literals scratch
    return size


def estimate_dctx_size() -> int:
    """ZSTD_estimateDCtxSize analog: decoder working state (entropy tables
    + literal/sequence scratch)."""
    huf = (1 << 12) * (1 + 1 + 2 + 4) + 256  # X1 + fused + X2 tables
    fse = 3 * ((1 << 10) * (4 + 1 + 2 + 1 + 8))
    return huf + fse + (1 << 17) + 64 + ((1 << 17) // 3 + 16) * 12
