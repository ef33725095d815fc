"""Block entropy encoding: seqStore -> compressed block body; the port's
copy of zstdsharp_tpu/encode/block.py.

Reference: ZSTD_entropyCompressSeqStore_internal (ZstdCompress.cs:3236),
ZSTD_compressLiterals (ZstdCompressLiterals.cs:86), ZSTD_seqToCodes
(ZstdCompress.cs:3069), ZSTD_encodeSequences_body
(ZstdCompressSequences.cs:585).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .. import constants as C
from .. import native
from ..entropy import fse, huffman
from ..entropy.bitstream import BitWriter
from ..errors import ZstdError, ZstdErrorCode
from .seqstore import SeqStore

# Cached compress tables for the predefined distributions.
_LL_DEFAULT_CTABLE = fse.build_ctable(C.LL_DEFAULT_NORM, C.MAX_LL, C.LL_DEFAULT_NORM_LOG)
_ML_DEFAULT_CTABLE = fse.build_ctable(C.ML_DEFAULT_NORM, C.MAX_ML, C.ML_DEFAULT_NORM_LOG)
_OF_DEFAULT_CTABLE = fse.build_ctable(C.OF_DEFAULT_NORM, C.DEFAULT_MAX_OFF, C.OF_DEFAULT_NORM_LOG)

_LL_DEFAULT_NORMF = C.LL_DEFAULT_NORM.astype(np.float64)
_ML_DEFAULT_NORMF = C.ML_DEFAULT_NORM.astype(np.float64)
_OF_DEFAULT_NORMF = C.OF_DEFAULT_NORM.astype(np.float64)


def _rle_ctable(symbol: int) -> fse.FseCTable:
    """tableLog-0 CTable for RLE symbol mode (FSE_buildCTable_rle)."""
    mx = symbol + 1
    dnb = np.zeros(mx, dtype=np.uint32)  # nbBitsOut = (state + 0) >> 16 = 0
    dfs = np.zeros(mx, dtype=np.int32)
    norm = np.zeros(mx, dtype=np.int16)
    norm[symbol] = 1
    return fse.FseCTable(0, np.zeros(2, dtype=np.uint16), dnb, dfs,
                         norm=norm, max_symbol=symbol)


@dataclass
class EncoderEntropy:
    """Cross-block encoder entropy state (repeat-mode support)."""

    huf: huffman.HufCTable | None = None
    ll: fse.FseCTable | None = None
    ml: fse.FseCTable | None = None
    of: fse.FseCTable | None = None


def seq_to_codes(seqs: SeqStore) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """ZSTD_seqToCodes:3069 — map (ll, ml, offBase) to code symbols."""
    ll_code = (np.searchsorted(C.LL_BASE, seqs.lit_len, side="right") - 1).astype(np.uint8)
    ml_code = (np.searchsorted(C.ML_BASE, seqs.match_len, side="right") - 1).astype(np.uint8)
    # ofCode = highbit(offBase), via power-of-two bins for exactness.
    pow2 = np.uint64(1) << np.arange(32, dtype=np.uint64)
    of_code = (np.searchsorted(pow2, seqs.off_base.astype(np.uint64), side="right") - 1).astype(np.uint8)
    return ll_code, ml_code, of_code


# ---------------------------------------------------------------------------
# Literals section
# ---------------------------------------------------------------------------


def _literals_header(lit_type: C.LiteralsBlockType, size_format: int,
                     regen: int, comp: int) -> bytes:
    if lit_type in (C.LiteralsBlockType.RAW, C.LiteralsBlockType.RLE):
        if size_format == 0:
            return bytes([int(lit_type) | (regen << 3)])
        if size_format == 1:
            v = int(lit_type) | (1 << 2) | (regen << 4)
            return v.to_bytes(2, "little")
        v = int(lit_type) | (3 << 2) | (regen << 4)
        return v.to_bytes(3, "little")
    v = int(lit_type) | (size_format << 2) | (regen << 4)
    if size_format in (0, 1):
        v |= comp << 14
        return v.to_bytes(3, "little")
    if size_format == 2:
        v |= comp << 18
        return v.to_bytes(4, "little")
    v |= comp << 22
    return v.to_bytes(5, "little")


def _raw_literals(lit: np.ndarray) -> bytes:
    n = len(lit)
    if n < 32:
        hdr = _literals_header(C.LiteralsBlockType.RAW, 0, n, 0)
    elif n < 4096:
        hdr = _literals_header(C.LiteralsBlockType.RAW, 1, n, 0)
    else:
        hdr = _literals_header(C.LiteralsBlockType.RAW, 3, n, 0)
    return hdr + lit.tobytes()


def encode_literals(lit: np.ndarray, entropy: EncoderEntropy,
                    strategy_min_gain_log: int = 6) -> bytes:
    """ZSTD_compressLiterals:86 — raw / RLE / Huffman-compressed choice."""
    n = len(lit)
    if n == 0:
        return _literals_header(C.LiteralsBlockType.RAW, 0, 0, 0)
    if n >= 2 and (lit == lit[0]).all():
        if n < 32:
            hdr = _literals_header(C.LiteralsBlockType.RLE, 0, n, 0)
        elif n < 4096:
            hdr = _literals_header(C.LiteralsBlockType.RLE, 1, n, 0)
        else:
            hdr = _literals_header(C.LiteralsBlockType.RLE, 3, n, 0)
        return hdr + bytes([int(lit[0])])
    # With a valid previous/dictionary table, much smaller literal runs are
    # worth compressing (ZSTD_compressLiterals minLitSize 6 vs 63).
    min_lit_size = 6 if entropy.huf is not None else 63
    if n <= min_lit_size:
        return _raw_literals(lit)

    counts = np.bincount(lit, minlength=256).astype(np.int64)
    max_sym = int(np.nonzero(counts)[0][-1])
    single = n < 256

    def _encode_with(ct):
        if single:
            return huffman.encode_1x(lit, ct)
        return huffman.encode_4x(lit, ct)

    # Candidate 1: fresh table.
    fresh = None
    try:
        ct = huffman.build_ctable(counts, max_sym)
        table_bytes = huffman.write_ctable(ct)
        payload = _encode_with(ct)
        if payload is not None:
            fresh = (len(table_bytes) + len(payload), ct, table_bytes + payload,
                     C.LiteralsBlockType.COMPRESSED)
    except (ZstdError, AssertionError):
        fresh = None

    # Candidate 2: repeat the previous/dictionary table (type 3, no header).
    repeat = None
    prev = entropy.huf
    if prev is not None and max_sym <= prev.max_symbol and \
            (prev.nb_bits[: max_sym + 1][counts[: max_sym + 1] > 0] > 0).all():
        payload = _encode_with(prev)
        if payload is not None:
            repeat = (len(payload), prev, payload, C.LiteralsBlockType.REPEAT)

    best = min((c for c in (fresh, repeat) if c is not None),
               key=lambda c: c[0], default=None)
    min_gain = (n >> strategy_min_gain_log) + 2
    if best is None or best[0] >= n - min_gain:
        return _raw_literals(lit)
    comp, ct, body, lit_type = best
    if lit_type == C.LiteralsBlockType.COMPRESSED:
        entropy.huf = ct
    # Size format: single stream -> 00; 4 streams pick smallest header.
    if single:
        size_format = 0
        assert n < 1024 and comp < 1024
    elif n < 1024 and comp < 1024:
        size_format = 1
    elif n < 16384 and comp < 16384:
        size_format = 2
    else:
        size_format = 3
    hdr = _literals_header(lit_type, size_format, n, comp)
    return hdr + body


# ---------------------------------------------------------------------------
# Sequence table selection & encoding
# ---------------------------------------------------------------------------


def _estimate_fse_cost_bits(counts: np.ndarray, norm: np.ndarray, table_log: int) -> float:
    """Cross-entropy of `counts` under distribution `norm` (ZSTD_fseBitCost)."""
    normp = np.zeros(len(counts), dtype=np.float64)
    normp[: len(norm)] = norm
    nz = counts > 0
    if (nz & (normp == 0)).any():
        return np.inf
    p = np.abs(normp[nz]) / (1 << table_log)
    return float(np.sum(counts[nz] * -np.log2(p)))


def _select_table(codes: np.ndarray, max_code_allowed: int, default_norm: np.ndarray,
                  default_log: int, default_ct: fse.FseCTable, max_log: int,
                  default_allowed: bool, prev_ct: fse.FseCTable | None = None):
    """Returns (mode, ctable, header_bytes).

    ZSTD_selectEncodingType/buildCTable shape: RLE for single-symbol, else
    cheapest of predefined / repeat (previous or dictionary table) / fresh
    FSE table, by estimated bits.
    """
    nb_seq = len(codes)
    counts = np.bincount(codes, minlength=max_code_allowed + 1).astype(np.int64)
    max_code = int(np.nonzero(counts)[0][-1])
    distinct = int(np.count_nonzero(counts))

    if distinct == 1:
        return C.SymbolEncodingType.RLE, _rle_ctable(int(codes[0])), bytes([int(codes[0])])

    default_cost = (_estimate_fse_cost_bits(counts, default_norm, default_log)
                    if default_allowed else np.inf)

    repeat_cost = np.inf
    if prev_ct is not None and prev_ct.norm is not None and max_code <= prev_ct.max_symbol:
        repeat_cost = _estimate_fse_cost_bits(counts, prev_ct.norm.astype(np.int64),
                                              prev_ct.table_log)

    fse_cost = np.inf
    norm = hdr = None
    tlog = 0
    if nb_seq >= 2:
        try:
            tlog = fse.optimal_table_log(max_log, nb_seq, max_code)
            norm = fse.normalize_count(counts[: max_code + 1], tlog, nb_seq, max_code,
                                       use_low_prob=nb_seq >= 2048)
            hdr = fse.write_ncount(norm, max_code, tlog)
            fse_cost = _estimate_fse_cost_bits(counts, norm.astype(np.int64), tlog) + len(hdr) * 8
        except ZstdError:
            fse_cost = np.inf

    best = min(default_cost, repeat_cost, fse_cost)
    if best == np.inf:
        raise ZstdError(ZstdErrorCode.generic, "no encodable table mode")
    if best == repeat_cost:
        return C.SymbolEncodingType.REPEAT, prev_ct, b""
    if best == fse_cost:
        return C.SymbolEncodingType.FSE, fse.build_ctable(norm, max_code, tlog), hdr
    return C.SymbolEncodingType.PREDEFINED, default_ct, b""


def encode_sequences_bitstream(seqs: SeqStore, ll_codes, ml_codes, of_codes,
                               ll_ct: fse.FseCTable, of_ct: fse.FseCTable,
                               ml_ct: fse.FseCTable) -> bytes:
    """ZSTD_encodeSequences_body:585 — interleaved 3-state backward stream."""
    n = seqs.nb_seq
    if n > 4:
        out = native.encode_sequences(
            seqs.lit_len, seqs.match_len - C.MINMATCH, seqs.off_base,
            ll_codes, ml_codes, of_codes,
            C.LL_BITS.astype(np.uint8), C.ML_BITS.astype(np.uint8),
            ll_ct, of_ct, ml_ct)
        if out is not None:
            return out

    w = BitWriter()
    ll_bits_tab = C.LL_BITS
    ml_bits_tab = C.ML_BITS
    lls = seqs.lit_len.tolist()
    mls = (seqs.match_len - C.MINMATCH).tolist()
    obs = seqs.off_base.tolist()
    llc = ll_codes.tolist()
    mlc = ml_codes.tolist()
    ofc = of_codes.tolist()

    st_ml = fse.FseEncoder(ml_ct, mlc[n - 1])
    st_of = fse.FseEncoder(of_ct, ofc[n - 1])
    st_ll = fse.FseEncoder(ll_ct, llc[n - 1])
    w.add(lls[n - 1], int(ll_bits_tab[llc[n - 1]]))
    w.add(mls[n - 1], int(ml_bits_tab[mlc[n - 1]]))
    w.add(obs[n - 1], int(ofc[n - 1]))

    for i in range(n - 2, -1, -1):
        st_of.encode(w, ofc[i])
        st_ml.encode(w, mlc[i])
        st_ll.encode(w, llc[i])
        w.add(lls[i], int(ll_bits_tab[llc[i]]))
        w.add(mls[i], int(ml_bits_tab[mlc[i]]))
        w.add(obs[i], int(ofc[i]))
    st_ml.flush(w)
    st_of.flush(w)
    st_ll.flush(w)
    return w.close()


def encode_block_body(block: np.ndarray, seqs: SeqStore,
                      entropy: EncoderEntropy) -> bytes | None:
    """Full compressed-block body (literals + sequences sections);
    returns None when entropy compression isn't worth it (caller emits a raw
    block) — ZSTD_entropyCompressSeqStore:3357 bail-out included."""
    n = seqs.nb_seq
    # Literal bytes = block minus all matched spans (vectorized via a
    # +-1 coverage delta and prefix sum).
    if n:
        spans = (seqs.lit_len + seqs.match_len).astype(np.int64)
        ends = np.cumsum(spans)
        match_starts = ends - seqs.match_len
        # starts/ends are each strictly increasing -> plain fancy assignment.
        inc = np.zeros(len(block) + 1, dtype=np.int8)
        dec = np.zeros(len(block) + 1, dtype=np.int8)
        inc[match_starts] = 1
        dec[ends] = 1
        covered = (np.cumsum(inc[: len(block)]) - np.cumsum(dec[: len(block)])) > 0
        lit = block[~covered]
    else:
        lit = block

    out = bytearray(encode_literals(lit, entropy))

    # nbSeq header (ZstdCompress.cs:3285-3300).
    if n < 128:
        out.append(n)
    elif n < 0x7F00:
        out.append((n >> 8) + 128)
        out.append(n & 0xFF)
    else:
        out.append(255)
        out += (n - 0x7F00).to_bytes(2, "little")

    if n:
        ll_codes, ml_codes, of_codes = seq_to_codes(seqs)
        ll_mode, ll_ct, ll_hdr = _select_table(
            ll_codes, C.MAX_LL, _LL_DEFAULT_NORMF, C.LL_DEFAULT_NORM_LOG,
            _LL_DEFAULT_CTABLE, C.LL_FSE_LOG, True, entropy.ll)
        of_max = int(of_codes.max())
        of_mode, of_ct, of_hdr = _select_table(
            of_codes, C.MAX_OFF, _OF_DEFAULT_NORMF, C.OF_DEFAULT_NORM_LOG,
            _OF_DEFAULT_CTABLE, C.OF_FSE_LOG, of_max <= C.DEFAULT_MAX_OFF, entropy.of)
        ml_mode, ml_ct, ml_hdr = _select_table(
            ml_codes, C.MAX_ML, _ML_DEFAULT_NORMF, C.ML_DEFAULT_NORM_LOG,
            _ML_DEFAULT_CTABLE, C.ML_FSE_LOG, True, entropy.ml)
        out.append((int(ll_mode) << 6) | (int(of_mode) << 4) | (int(ml_mode) << 2))
        out += ll_hdr + of_hdr + ml_hdr
        out += encode_sequences_bitstream(seqs, ll_codes, ml_codes, of_codes,
                                          ll_ct, of_ct, ml_ct)
        entropy.ll, entropy.of, entropy.ml = ll_ct, of_ct, ml_ct

    # Compressibility bail-out: body must beat raw by the margin zstd uses.
    max_size = len(block) - (len(block) >> 6) - 3
    if len(out) >= max_size:
        return None
    return bytes(out)
