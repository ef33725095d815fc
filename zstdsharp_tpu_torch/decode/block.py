"""Block decoding on the host: literal sections, sequence-section headers
and sequence decode -- the port's copy of the parts of
zstdsharp_tpu/decode/block.py that its device planner reaches (reference:
Unsafe/ZstdDecompressBlock.cs: ZSTD_decodeLiteralsBlock:88,
ZSTD_buildSeqTable:1746, ZSTD_decodeSeqHeaders:1845,
ZSTD_decodeSequence:2360).

The planner decodes here what the device kernels do not take: the sequence
sections of multi-block frames (so the repcode and repeat-table chains
resolve at plan time) and oversized literal or sequence sections.
``decode_block`` (with ``execute_sequences``, ZSTD_execSequence:2187)
decodes a whole block for the host frame decoder's dictionary route and
the streaming decoder's dictionary frames.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .. import constants as C
from .. import native
from ..entropy import fse, huffman
from ..entropy.bitstream import BitReader
from ..errors import ZstdError, ZstdErrorCode, check

# Predefined sequence decode tables, built once.
_LL_DEFAULT_DTABLE = fse.build_sequence_dtable(
    C.LL_DEFAULT_NORM, C.MAX_LL, C.LL_DEFAULT_NORM_LOG, C.LL_BASE, C.LL_BITS)
_ML_DEFAULT_DTABLE = fse.build_sequence_dtable(
    C.ML_DEFAULT_NORM, C.MAX_ML, C.ML_DEFAULT_NORM_LOG, C.ML_BASE, C.ML_BITS)
_OF_DEFAULT_DTABLE = fse.build_sequence_dtable(
    C.OF_DEFAULT_NORM, C.DEFAULT_MAX_OFF, C.OF_DEFAULT_NORM_LOG, C.OF_BASE, C.OF_BITS)


def _rle_sequence_dtable(symbol: int, base: np.ndarray, bits: np.ndarray) -> fse.FseDTable:
    """Single-cell table for RLE symbol mode (ZSTD_buildSeqTable_rle:1521)."""
    return fse.FseDTable(
        table_log=0,
        symbol=np.array([symbol], dtype=np.uint8),
        nb_bits=np.array([0], dtype=np.uint8),
        new_state=np.array([0], dtype=np.uint16),
        base_value=np.array([base[symbol]], dtype=np.uint32),
        nb_add_bits=np.array([bits[symbol]], dtype=np.uint8),
    )


@dataclass
class EntropyState:
    """Cross-block repeat state (huffman table + FSE tables), per frame.

    Mirrors ZSTD_entropyDTables_t; loaded from a dictionary when present.
    """

    huf: huffman.HufDTable | None = None
    ll: fse.FseDTable | None = None
    ml: fse.FseDTable | None = None
    of: fse.FseDTable | None = None
    rep: list[int] = field(default_factory=lambda: list(C.REP_START_VALUE))


# ---------------------------------------------------------------------------
# Literals
# ---------------------------------------------------------------------------


def decode_literals(src: bytes, entropy: EntropyState) -> tuple[np.ndarray, int]:
    """ZSTD_decodeLiteralsBlock:88.  Returns (literals, bytes_consumed)."""
    check(len(src) >= 1, ZstdErrorCode.corruption_detected)
    b0 = src[0]
    lit_type = C.LiteralsBlockType(b0 & 3)
    size_format = (b0 >> 2) & 3

    if lit_type in (C.LiteralsBlockType.RAW, C.LiteralsBlockType.RLE):
        if size_format in (0, 2):  # 00 / 10 -> 5-bit size, 1 byte header
            lit_size = b0 >> 3
            hdr = 1
        elif size_format == 1:  # 12-bit size, 2 bytes
            check(len(src) >= 2, ZstdErrorCode.corruption_detected)
            lit_size = (b0 >> 4) + (src[1] << 4)
            hdr = 2
        else:  # 20-bit size, 3 bytes
            check(len(src) >= 3, ZstdErrorCode.corruption_detected)
            lit_size = (b0 >> 4) + (src[1] << 4) + (src[2] << 12)
            hdr = 3
        if lit_type == C.LiteralsBlockType.RAW:
            check(len(src) >= hdr + lit_size, ZstdErrorCode.corruption_detected)
            return np.frombuffer(src[hdr : hdr + lit_size], dtype=np.uint8).copy(), hdr + lit_size
        check(len(src) >= hdr + 1, ZstdErrorCode.corruption_detected)
        return np.full(lit_size, src[hdr], dtype=np.uint8), hdr + 1

    # Compressed / repeat-table literals.
    check(len(src) >= 5, ZstdErrorCode.corruption_detected, "literals header")
    if size_format == 0:  # single stream, 10+10 bits, 3-byte header
        v = int.from_bytes(src[0:3], "little")
        regen = (v >> 4) & 0x3FF
        comp = (v >> 14) & 0x3FF
        hdr, streams = 3, 1
    elif size_format == 1:  # 4 streams, 10+10 bits, 3-byte header
        v = int.from_bytes(src[0:3], "little")
        regen = (v >> 4) & 0x3FF
        comp = (v >> 14) & 0x3FF
        hdr, streams = 3, 4
    elif size_format == 2:  # 4 streams, 14+14 bits, 4-byte header
        v = int.from_bytes(src[0:4], "little")
        regen = (v >> 4) & 0x3FFF
        comp = (v >> 18) & 0x3FFF
        hdr, streams = 4, 4
    else:  # 4 streams, 18+18 bits, 5-byte header
        v = int.from_bytes(src[0:5], "little")
        regen = (v >> 4) & 0x3FFFF
        comp = (v >> 22) & 0x3FFFF
        hdr, streams = 5, 4
    check(len(src) >= hdr + comp, ZstdErrorCode.corruption_detected)
    payload = src[hdr : hdr + comp]

    if lit_type == C.LiteralsBlockType.COMPRESSED:
        weights, tlog, whdr = huffman.read_weights(payload)
        dt = huffman.build_dtable(weights, tlog)
        entropy.huf = dt
        payload = payload[whdr:]
    else:  # REPEAT
        check(entropy.huf is not None, ZstdErrorCode.dictionary_corrupted,
              "repeat literals without prior table")
        dt = entropy.huf
    if streams == 1:
        lit = huffman.decode_1x(payload, dt, regen)
    else:
        lit = huffman.decode_4x(payload, dt, regen)
    return lit, hdr + comp


# ---------------------------------------------------------------------------
# Sequence section headers
# ---------------------------------------------------------------------------


def _build_seq_table(mode: C.SymbolEncodingType, src: bytes, kind: str,
                     prev: fse.FseDTable | None):
    """ZSTD_buildSeqTable:1746.  Returns (dtable, bytes_consumed)."""
    base, bits, default, max_sym, max_log = {
        "ll": (C.LL_BASE, C.LL_BITS, _LL_DEFAULT_DTABLE, C.MAX_LL, C.LL_FSE_LOG),
        "ml": (C.ML_BASE, C.ML_BITS, _ML_DEFAULT_DTABLE, C.MAX_ML, C.ML_FSE_LOG),
        "of": (C.OF_BASE, C.OF_BITS, _OF_DEFAULT_DTABLE, C.MAX_OFF, C.OF_FSE_LOG),
    }[kind]
    if mode == C.SymbolEncodingType.PREDEFINED:
        return default, 0
    if mode == C.SymbolEncodingType.RLE:
        check(len(src) >= 1, ZstdErrorCode.corruption_detected)
        check(src[0] <= max_sym, ZstdErrorCode.corruption_detected, "RLE symbol oob")
        return _rle_sequence_dtable(src[0], base, bits), 1
    if mode == C.SymbolEncodingType.FSE:
        norm, sym, tlog, consumed = fse.read_ncount(src, max_symbol_limit=max_sym,
                                                    max_table_log=max_log)
        return fse.build_sequence_dtable(norm, sym, tlog, base, bits), consumed
    # REPEAT
    check(prev is not None, ZstdErrorCode.dictionary_corrupted,
          f"repeat {kind} table without prior")
    return prev, 0


def decode_sequence_headers(src: bytes, entropy: EntropyState):
    """ZSTD_decodeSeqHeaders:1845.

    Returns (nb_seq, ll_table, of_table, ml_table, bytes_consumed).
    """
    check(len(src) >= 1, ZstdErrorCode.srcSize_wrong)
    b0 = src[0]
    if b0 < 128:
        nb_seq, pos = b0, 1
    elif b0 < 255:
        check(len(src) >= 2, ZstdErrorCode.srcSize_wrong)
        nb_seq, pos = ((b0 - 128) << 8) + src[1], 2
    else:
        check(len(src) >= 3, ZstdErrorCode.srcSize_wrong)
        nb_seq, pos = src[1] + (src[2] << 8) + 0x7F00, 3
    if nb_seq == 0:
        return 0, None, None, None, pos

    check(len(src) >= pos + 1, ZstdErrorCode.srcSize_wrong)
    mode_byte = src[pos]
    pos += 1
    check(mode_byte & 3 == 0, ZstdErrorCode.corruption_detected, "reserved seq mode bits")
    ll_mode = C.SymbolEncodingType(mode_byte >> 6)
    of_mode = C.SymbolEncodingType((mode_byte >> 4) & 3)
    ml_mode = C.SymbolEncodingType((mode_byte >> 2) & 3)

    ll, n = _build_seq_table(ll_mode, src[pos:], "ll", entropy.ll)
    pos += n
    of, n = _build_seq_table(of_mode, src[pos:], "of", entropy.of)
    pos += n
    ml, n = _build_seq_table(ml_mode, src[pos:], "ml", entropy.ml)
    pos += n
    entropy.ll, entropy.of, entropy.ml = ll, of, ml
    return nb_seq, ll, of, ml, pos


# ---------------------------------------------------------------------------
# Sequence decode (the 3-state interleaved FSE machine)
# ---------------------------------------------------------------------------


def decode_sequences(payload: bytes, nb_seq: int, ll: fse.FseDTable,
                     of: fse.FseDTable, ml: fse.FseDTable,
                     rep: list[int]) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """ZSTD_decodeSequence:2360 driven nb_seq times.

    Returns (lit_len, match_len, offset) uint32 arrays with offsets fully
    resolved through the repcode history (`rep` is updated in place).
    """
    if nb_seq > 8:
        res = native.fse_decode_sequences(bytes(payload), nb_seq, ll, of, ml, rep)
        if res is None:
            raise ZstdError(ZstdErrorCode.corruption_detected,
                            "sequence bitstream corrupt")
        return res

    reader = BitReader(payload)
    state_ll = reader.read(ll.table_log)
    state_of = reader.read(of.table_log)
    state_ml = reader.read(ml.table_log)

    lls = np.empty(nb_seq, dtype=np.uint32)
    mls = np.empty(nb_seq, dtype=np.uint32)
    ofs = np.empty(nb_seq, dtype=np.uint32)

    ll_sym, ll_nb, ll_ns = ll.base_value.tolist(), ll.nb_add_bits.tolist(), ll.new_state.tolist()
    ll_snb = ll.nb_bits.tolist()
    ml_sym, ml_nb, ml_ns = ml.base_value.tolist(), ml.nb_add_bits.tolist(), ml.new_state.tolist()
    ml_snb = ml.nb_bits.tolist()
    of_sym, of_nb, of_ns = of.base_value.tolist(), of.nb_add_bits.tolist(), of.new_state.tolist()
    of_snb = of.nb_bits.tolist()
    read = reader.read
    r0, r1, r2 = rep

    for i in range(nb_seq):
        ll_base = ll_sym[state_ll]
        ll_bits = ll_nb[state_ll]
        ml_base = ml_sym[state_ml]
        ml_bits = ml_nb[state_ml]
        of_base = of_sym[state_of]
        of_bits = of_nb[state_of]

        # Offset + repcode resolution (ZSTD_decodeSequence:2360).
        if of_bits > 1:
            offset = of_base + read(of_bits)
            r2, r1 = r1, r0
            r0 = offset
        else:
            ll0 = ll_base == 0
            if of_bits == 0:
                offset = r1 if ll0 else r0
                if ll0:
                    r0, r1 = r1, r0
            else:
                idx = of_base + ll0 + read(1)  # 1..3
                tmp = (r0 - 1) if idx == 3 else (r0, r1, r2)[idx]
                if tmp == 0:
                    tmp = 1  # corrupted input forces offset 1
                if idx != 1:
                    r2 = r1
                r1 = r0
                r0 = offset = tmp

        match_len = ml_base + (read(ml_bits) if ml_bits else 0)
        lit_len = ll_base + (read(ll_bits) if ll_bits else 0)

        lls[i] = lit_len
        mls[i] = match_len
        ofs[i] = offset

        if i != nb_seq - 1:
            # State updates in LL, ML, OF order (ZSTD_decompressSequences body).
            state_ll = ll_ns[state_ll] + read(ll_snb[state_ll])
            state_ml = ml_ns[state_ml] + read(ml_snb[state_ml])
            state_of = of_ns[state_of] + read(of_snb[state_of])
            if reader.pos < 0:
                raise ZstdError(ZstdErrorCode.corruption_detected, "seq bitstream overrun")

    check(reader.pos == 0, ZstdErrorCode.corruption_detected,
          "sequence bitstream not fully consumed")
    rep[0], rep[1], rep[2] = r0, r1, r2
    return lls, mls, ofs


# ---------------------------------------------------------------------------
# Sequence execution (LZ copy)
# ---------------------------------------------------------------------------


def execute_sequences(out: np.ndarray, out_pos: int, prefix_start: int,
                      literals: np.ndarray, lls: np.ndarray, mls: np.ndarray,
                      ofs: np.ndarray) -> int:
    """ZSTD_execSequence:2187 over a whole block.

    `out` is the frame-wide output buffer; `out_pos` the write cursor;
    `prefix_start` the first valid history byte (0 unless dictionary content
    was virtually prepended).  Returns the new out_pos.
    """
    if len(lls) > 4:
        res = native.execute_sequences(out, out_pos, prefix_start, literals,
                                       lls, mls, ofs)
        if res is None:
            raise ZstdError(ZstdErrorCode.corruption_detected,
                            "sequence execution failed (offset/window)")
        return res

    lit_pos = 0
    n = len(lls)
    lls_l = lls.tolist()
    mls_l = mls.tolist()
    ofs_l = ofs.tolist()
    for i in range(n):
        ll = lls_l[i]
        ml = mls_l[i]
        offset = ofs_l[i]
        if ll:
            out[out_pos : out_pos + ll] = literals[lit_pos : lit_pos + ll]
            out_pos += ll
            lit_pos += ll
        check(offset <= out_pos - prefix_start, ZstdErrorCode.corruption_detected,
              "offset beyond window")
        start = out_pos - offset
        if offset >= ml:
            out[out_pos : out_pos + ml] = out[start : start + ml]
            out_pos += ml
        else:
            # Overlapped copy: doubling pattern replication.
            remaining = ml
            avail = offset
            while remaining > 0:
                chunk = min(avail, remaining)
                out[out_pos : out_pos + chunk] = out[start : start + chunk]
                out_pos += chunk
                remaining -= chunk
                avail += chunk
    # Trailing literals.
    rest = len(literals) - lit_pos
    if rest:
        out[out_pos : out_pos + rest] = literals[lit_pos:]
        out_pos += rest
    return out_pos


def decode_block(src: bytes, entropy: EntropyState, out: np.ndarray,
                 out_pos: int, prefix_start: int = 0) -> int:
    """Decode one compressed block into `out` at `out_pos`; returns new pos
    (ZSTD_decompressBlock_internal:3090)."""
    literals, consumed = decode_literals(src, entropy)
    nb_seq, ll, of, ml, n = decode_sequence_headers(src[consumed:], entropy)
    consumed += n
    if nb_seq == 0:
        end = out_pos + len(literals)
        out[out_pos:end] = literals
        return end
    lls, mls, ofs = decode_sequences(src[consumed:], nb_seq, ll, of, ml, entropy.rep)
    total = int(lls.sum()) + int(mls.sum()) + (len(literals) - int(lls.sum()))
    check(out_pos + total <= len(out), ZstdErrorCode.dstSize_tooSmall)
    return execute_sequences(out, out_pos, prefix_start, literals, lls, mls, ofs)
