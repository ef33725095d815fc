"""Dictionary parsing: the decode half of zstdsharp_tpu/dictionary.py
(``ParsedDict``, ``parse_dictionary``; reference: ZSTD_loadDEntropy,
ZstdDecompress.cs:1770).

Wire format: [magic 0xEC30A437][dictID u32][HUF weights][OF NCount]
[ML NCount][LL NCount][rep0..rep2 u32][content].  Input without the magic,
or under 8 bytes, is raw content.  The port has no dictionary encoder, so
no encoder tables are built.  ``ParsedDict.native`` opens the engine's
decompression dictionary on the same bytes.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from . import constants as C
from . import native
from .decode.block import EntropyState
from .entropy import fse, huffman
from .errors import ZstdErrorCode, check


@dataclass
class ParsedDict:
    dict_id: int
    content: np.ndarray
    entropy: EntropyState | None  # decode-side tables; None for raw content
    raw: bytes = b""

    def native(self) -> native.NativeDDict:
        """The engine's handle of this dictionary; the caller closes it."""
        return native.NativeDDict(self.raw, len(self.content), self.dict_id)


def parse_dictionary(data: bytes) -> ParsedDict:
    """Parse a zstd dictionary; raw-content fallback if no magic
    (ZSTD_loadDictionaryContent auto mode).  Broken tables or repcodes
    raise ZstdError."""
    data = bytes(data)
    if (len(data) < 8
            or int.from_bytes(data[0:4], "little") != C.ZSTD_MAGIC_DICTIONARY):
        return ParsedDict(0, np.frombuffer(data, dtype=np.uint8), None, data)
    dict_id = int.from_bytes(data[4:8], "little")
    pos = 8
    ent = EntropyState()

    weights, tlog, consumed = huffman.read_weights(data[pos:])
    ent.huf = huffman.build_dtable(weights, tlog)
    pos += consumed

    for name, max_sym, max_log, base, bits in (
            ("of", C.MAX_OFF, C.OF_FSE_LOG, C.OF_BASE, C.OF_BITS),
            ("ml", C.MAX_ML, C.ML_FSE_LOG, C.ML_BASE, C.ML_BITS),
            ("ll", C.MAX_LL, C.LL_FSE_LOG, C.LL_BASE, C.LL_BITS)):
        norm, msym, log, n = fse.read_ncount(data[pos:], max_sym, max_log)
        setattr(ent, name,
                fse.build_sequence_dtable(norm, msym, log, base, bits))
        pos += n

    check(len(data) >= pos + 12, ZstdErrorCode.dictionary_corrupted,
          "missing repcodes")
    reps = [int.from_bytes(data[pos + 4 * i:pos + 4 * i + 4], "little")
            for i in range(3)]
    pos += 12
    content = np.frombuffer(data[pos:], dtype=np.uint8)
    for r in reps:
        check(0 < r <= len(content) + (1 << 31),
              ZstdErrorCode.dictionary_corrupted)
    ent.rep = reps
    return ParsedDict(dict_id, content, ent, data)
