"""Zstandard (RFC 8878) format constants: the port's copy of the parts of
zstdsharp_tpu/constants.py that its host tier and its device planes use.

The values are mandated by the format and must match the reference bit for
bit; ``tests/test_torch_host.py`` compares every one with the JAX package's.
"""

from __future__ import annotations

import enum

import numpy as np

# ---------------------------------------------------------------------------
# Frame level (RFC 8878 §3.1.1)
# ---------------------------------------------------------------------------

ZSTD_MAGICNUMBER = 0xFD2FB528
ZSTD_MAGIC_SKIPPABLE_START = 0x184D2A50
ZSTD_MAGIC_SKIPPABLE_MASK = 0xFFFFFFF0
ZSTD_MAGIC_DICTIONARY = 0xEC30A437

ZSTD_FRAMEHEADERSIZE_PREFIX = 5  # bytes needed to probe the header size
ZSTD_FRAMEHEADERSIZE_MIN = 6
ZSTD_FRAMEHEADERSIZE_MAX = 18
ZSTD_BLOCKSIZELOG_MAX = 17
ZSTD_BLOCKSIZE_MAX = 1 << ZSTD_BLOCKSIZELOG_MAX  # 128 KiB
ZSTD_BLOCKHEADERSIZE = 3

# Parameter bounds (ZSTD_cParam_getBounds)
ZSTD_WINDOWLOG_MAX = 31
ZSTD_WINDOWLOG_MIN = 10
ZSTD_WINDOWLOG_LIMIT_DEFAULT = 27
ZSTD_WINDOWLOG_ABSOLUTEMIN = 10
ZSTD_HASHLOG_MAX = 30
ZSTD_HASHLOG_MIN = 6
ZSTD_CHAINLOG_MAX = 30
ZSTD_CHAINLOG_MIN = 6
ZSTD_SEARCHLOG_MAX = ZSTD_WINDOWLOG_MAX - 1
ZSTD_SEARCHLOG_MIN = 1
ZSTD_MINMATCH_MAX = 7
ZSTD_MINMATCH_MIN = 3
ZSTD_TARGETLENGTH_MAX = ZSTD_BLOCKSIZE_MAX
ZSTD_TARGETLENGTH_MIN = 0

MINMATCH = 3

# Frame-content-size / dict-id field sizes, indexed by the 2-bit
# descriptor fields of the frame-header byte.
ZSTD_FCS_FIELD_SIZE = (0, 2, 4, 8)
ZSTD_DID_FIELD_SIZE = (0, 1, 2, 4)

REP_START_VALUE = (1, 4, 8)


class BlockType(enum.IntEnum):
    RAW = 0
    RLE = 1
    COMPRESSED = 2
    RESERVED = 3


class LiteralsBlockType(enum.IntEnum):
    RAW = 0
    RLE = 1
    COMPRESSED = 2
    REPEAT = 3  # reuse the previous Huffman table


class SymbolEncodingType(enum.IntEnum):
    """Sequence-section symbol compression modes (RFC 8878 §3.1.1.3.2.1)."""

    PREDEFINED = 0
    RLE = 1
    FSE = 2
    REPEAT = 3


# ---------------------------------------------------------------------------
# Sequence codes (RFC 8878 §3.1.1.3.2.1.1) and default distributions (§4)
# ---------------------------------------------------------------------------

MAX_LL = 35
MAX_ML = 52
MAX_OFF = 31
DEFAULT_MAX_OFF = 28  # offset-code bound of the predefined distribution

LL_BITS = np.array(
    [0] * 16 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16],
    dtype=np.uint32,
)
LL_BASE = np.array(
    list(range(16))
    + [16, 18, 20, 22, 24, 28, 32, 40, 48, 64, 0x80, 0x100, 0x200, 0x400, 0x800,
       0x1000, 0x2000, 0x4000, 0x8000, 0x10000],
    dtype=np.uint32,
)
LL_DEFAULT_NORM = np.array(
    [4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2,
     2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1],
    dtype=np.int16,
)
LL_DEFAULT_NORM_LOG = 6

ML_BITS = np.array(
    [0] * 32 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16],
    dtype=np.uint32,
)
ML_BASE = np.array(
    list(range(3, 35))
    + [35, 37, 39, 41, 43, 47, 51, 59, 67, 83, 99, 131, 259, 515, 1027, 2051,
       4099, 8195, 16387, 32771, 65539],
    dtype=np.uint32,
)
ML_DEFAULT_NORM = np.array(
    [1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
     1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1,
     -1, -1, -1, -1, -1],
    dtype=np.int16,
)
ML_DEFAULT_NORM_LOG = 6

OF_BITS = np.arange(32, dtype=np.uint32)
OF_BASE = np.array([0, 1] + [(1 << n) - 3 for n in range(2, 32)], dtype=np.uint32)
OF_DEFAULT_NORM = np.array(
    [1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
     -1, -1, -1, -1, -1],
    dtype=np.int16,
)
OF_DEFAULT_NORM_LOG = 5

LL_FSE_LOG = 9  # max accuracy log of a literal-length table
ML_FSE_LOG = 9
OF_FSE_LOG = 8

FSE_MIN_TABLELOG = 5
FSE_TABLELOG_ABSOLUTE_MAX = 15

HUF_TABLELOG_DEFAULT = 11
HUF_TABLELOG_ABSOLUTEMAX = 12
HUF_SYMBOLVALUE_MAX = 255

# ---------------------------------------------------------------------------
# Compression levels (Clevels.cs:8)
# ---------------------------------------------------------------------------


class Strategy(enum.IntEnum):
    """Match-finder strategies, from fastest to strongest."""

    FAST = 1
    DFAST = 2
    GREEDY = 3
    LAZY = 4
    LAZY2 = 5
    BTLAZY2 = 6
    BTOPT = 7
    BTULTRA = 8
    BTULTRA2 = 9


ZSTD_MAX_CLEVEL = 22
ZSTD_MIN_CLEVEL = -(1 << 17)
ZSTD_DEFAULT_CLEVEL = 3

# (windowLog, chainLog, hashLog, searchLog, minMatch, targetLength, strategy)
# for 4 source-size classes x levels 0..22 (ZSTD_defaultCParameters).
_S = Strategy
ZSTD_DEFAULT_CPARAMETERS = (
    (  # > 256 KB or unknown
        (19, 12, 13, 1, 6, 1, _S.FAST), (19, 13, 14, 1, 7, 0, _S.FAST),
        (20, 15, 16, 1, 6, 0, _S.FAST), (21, 16, 17, 1, 5, 0, _S.DFAST),
        (21, 18, 18, 1, 5, 0, _S.DFAST), (21, 18, 19, 3, 5, 2, _S.GREEDY),
        (21, 18, 19, 3, 5, 4, _S.LAZY), (21, 19, 20, 4, 5, 8, _S.LAZY),
        (21, 19, 20, 4, 5, 16, _S.LAZY2), (22, 20, 21, 4, 5, 16, _S.LAZY2),
        (22, 21, 22, 5, 5, 16, _S.LAZY2), (22, 21, 22, 6, 5, 16, _S.LAZY2),
        (22, 22, 23, 6, 5, 32, _S.LAZY2), (22, 22, 22, 4, 5, 32, _S.BTLAZY2),
        (22, 22, 23, 5, 5, 32, _S.BTLAZY2), (22, 23, 23, 6, 5, 32, _S.BTLAZY2),
        (22, 22, 22, 5, 5, 48, _S.BTOPT), (23, 23, 22, 5, 4, 64, _S.BTOPT),
        (23, 23, 22, 6, 3, 64, _S.BTULTRA), (23, 24, 22, 7, 3, 256, _S.BTULTRA2),
        (25, 25, 23, 7, 3, 256, _S.BTULTRA2), (26, 26, 24, 7, 3, 512, _S.BTULTRA2),
        (27, 27, 25, 9, 3, 999, _S.BTULTRA2),
    ),
    (  # <= 256 KB
        (18, 12, 13, 1, 5, 1, _S.FAST), (18, 13, 14, 1, 6, 0, _S.FAST),
        (18, 14, 14, 1, 5, 0, _S.DFAST), (18, 16, 16, 1, 4, 0, _S.DFAST),
        (18, 16, 17, 3, 5, 2, _S.GREEDY), (18, 17, 18, 5, 5, 2, _S.GREEDY),
        (18, 18, 19, 3, 5, 4, _S.LAZY), (18, 18, 19, 4, 4, 4, _S.LAZY),
        (18, 18, 19, 4, 4, 8, _S.LAZY2), (18, 18, 19, 5, 4, 8, _S.LAZY2),
        (18, 18, 19, 6, 4, 8, _S.LAZY2), (18, 18, 19, 5, 4, 12, _S.BTLAZY2),
        (18, 19, 19, 7, 4, 12, _S.BTLAZY2), (18, 18, 19, 4, 4, 16, _S.BTOPT),
        (18, 18, 19, 4, 3, 32, _S.BTOPT), (18, 18, 19, 6, 3, 128, _S.BTOPT),
        (18, 19, 19, 6, 3, 128, _S.BTULTRA), (18, 19, 19, 8, 3, 256, _S.BTULTRA),
        (18, 19, 19, 6, 3, 128, _S.BTULTRA2), (18, 19, 19, 8, 3, 256, _S.BTULTRA2),
        (18, 19, 19, 10, 3, 512, _S.BTULTRA2), (18, 19, 19, 12, 3, 512, _S.BTULTRA2),
        (18, 19, 19, 13, 3, 999, _S.BTULTRA2),
    ),
    (  # <= 128 KB
        (17, 12, 12, 1, 5, 1, _S.FAST), (17, 12, 13, 1, 6, 0, _S.FAST),
        (17, 13, 15, 1, 5, 0, _S.FAST), (17, 15, 16, 2, 5, 0, _S.DFAST),
        (17, 17, 17, 2, 4, 0, _S.DFAST), (17, 16, 17, 3, 4, 2, _S.GREEDY),
        (17, 16, 17, 3, 4, 4, _S.LAZY), (17, 16, 17, 3, 4, 8, _S.LAZY2),
        (17, 16, 17, 4, 4, 8, _S.LAZY2), (17, 16, 17, 5, 4, 8, _S.LAZY2),
        (17, 16, 17, 6, 4, 8, _S.LAZY2), (17, 17, 17, 5, 4, 8, _S.BTLAZY2),
        (17, 18, 17, 7, 4, 12, _S.BTLAZY2), (17, 18, 17, 3, 4, 12, _S.BTOPT),
        (17, 18, 17, 4, 3, 32, _S.BTOPT), (17, 18, 17, 6, 3, 256, _S.BTOPT),
        (17, 18, 17, 6, 3, 128, _S.BTULTRA), (17, 18, 17, 8, 3, 256, _S.BTULTRA),
        (17, 18, 17, 10, 3, 512, _S.BTULTRA), (17, 18, 17, 5, 3, 256, _S.BTULTRA2),
        (17, 18, 17, 7, 3, 512, _S.BTULTRA2), (17, 18, 17, 9, 3, 512, _S.BTULTRA2),
        (17, 18, 17, 11, 3, 999, _S.BTULTRA2),
    ),
    (  # <= 16 KB
        (14, 12, 13, 1, 5, 1, _S.FAST), (14, 14, 15, 1, 5, 0, _S.FAST),
        (14, 14, 15, 1, 4, 0, _S.FAST), (14, 14, 15, 2, 4, 0, _S.DFAST),
        (14, 14, 14, 4, 4, 2, _S.GREEDY), (14, 14, 14, 3, 4, 4, _S.LAZY),
        (14, 14, 14, 4, 4, 8, _S.LAZY2), (14, 14, 14, 6, 4, 8, _S.LAZY2),
        (14, 14, 14, 8, 4, 8, _S.LAZY2), (14, 15, 14, 5, 4, 8, _S.BTLAZY2),
        (14, 15, 14, 9, 4, 8, _S.BTLAZY2), (14, 15, 14, 3, 4, 12, _S.BTOPT),
        (14, 15, 14, 4, 3, 24, _S.BTOPT), (14, 15, 14, 5, 3, 32, _S.BTULTRA),
        (14, 15, 15, 6, 3, 64, _S.BTULTRA), (14, 15, 15, 7, 3, 256, _S.BTULTRA),
        (14, 15, 15, 5, 3, 48, _S.BTULTRA2), (14, 15, 15, 6, 3, 128, _S.BTULTRA2),
        (14, 15, 15, 7, 3, 256, _S.BTULTRA2), (14, 15, 15, 8, 3, 256, _S.BTULTRA2),
        (14, 15, 15, 8, 3, 512, _S.BTULTRA2), (14, 15, 15, 9, 3, 512, _S.BTULTRA2),
        (14, 15, 15, 10, 3, 999, _S.BTULTRA2),
    ),
)

# Source-size class boundaries that pick the row family above.
ZSTD_SRCSIZEHINT_CLASSES = (256 * 1024, 128 * 1024, 16 * 1024)
