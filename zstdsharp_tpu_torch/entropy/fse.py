"""FSE (tANS) entropy codec: the port's copy of
zstdsharp_tpu/entropy/fse.py (reference: Unsafe/Fse.cs, FseCompress.cs,
FseDecompress.cs, EntropyCommon.cs).

Covers the complete FSE surface the zstd format needs:

* NCount (normalized-count header) read/write — EntropyCommon.cs:52,
  FseCompress.cs:203
* decode-table build — FseDecompress.cs:25 / ZstdDecompressBlock.cs:1571
* 2-state interleaved decompress (Huffman weights) — FseDecompress.cs:230
* count normalization incl. the M2 fallback — FseCompress.cs:574/443
* compress-table build — FseCompress.cs:13
* 2-state interleaved compress — FseCompress.cs:722

Exact integer semantics are load-bearing: the normalization heuristics decide
every downstream bit of an encoded frame.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..constants import FSE_MIN_TABLELOG, FSE_TABLELOG_ABSOLUTE_MAX
from ..errors import ZstdError, ZstdErrorCode, check
from .bitstream import BitReader, BitWriter

# Restart threshold table for the "round up small probabilities" heuristic
# (FSE_normalizeCount, FseCompress.cs:633; values from Arrays.cs:8).
_RTB_TABLE = (0, 473195, 504333, 520860, 550000, 700000, 750000, 830000)


def highbit32(v: int) -> int:
    """Position of highest set bit (BIT_highbit32); v must be > 0."""
    assert v > 0
    return v.bit_length() - 1


# ---------------------------------------------------------------------------
# NCount header
# ---------------------------------------------------------------------------


def read_ncount(src: bytes | np.ndarray, max_symbol_limit: int = 255,
                max_table_log: int = FSE_TABLELOG_ABSOLUTE_MAX):
    """Parse a normalized-count header (FSE_readNCount_body).

    Returns (norm: np.int16[max_symbol+1], max_symbol, table_log, bytes_read).
    The NCount bitstream is *forward* little-endian (unlike entropy payloads).
    """
    src = bytes(src)
    if len(src) < 1:
        raise ZstdError(ZstdErrorCode.srcSize_wrong, "NCount too small")
    # Forward bit cursor over a zero-padded window.
    buf = src + b"\x00" * 8

    def field(bitpos: int, n: int) -> int:
        byte = bitpos >> 3
        window = int.from_bytes(buf[byte : byte + 8], "little")
        return (window >> (bitpos & 7)) & ((1 << n) - 1)

    bitpos = 0
    table_log = field(bitpos, 4) + FSE_MIN_TABLELOG
    bitpos += 4
    check(table_log <= max_table_log, ZstdErrorCode.tableLog_tooLarge)

    remaining = (1 << table_log) + 1
    threshold = 1 << table_log
    nb_bits = table_log + 1
    norm = np.zeros(max_symbol_limit + 1, dtype=np.int16)
    charnum = 0
    previous0 = False

    while remaining > 1 and charnum <= max_symbol_limit:
        if previous0:
            n0 = charnum
            while field(bitpos, 16) == 0xFFFF:
                n0 += 24
                bitpos += 16
                check(bitpos <= len(src) * 8 + 7, ZstdErrorCode.corruption_detected)
            while field(bitpos, 2) == 3:
                n0 += 3
                bitpos += 2
                check(bitpos <= len(src) * 8 + 7, ZstdErrorCode.corruption_detected)
            n0 += field(bitpos, 2)
            bitpos += 2
            check(n0 <= max_symbol_limit, ZstdErrorCode.maxSymbolValue_tooSmall)
            charnum = n0  # zeros already in norm
        cap = 2 * threshold - 1 - remaining
        count = field(bitpos, nb_bits)
        if (count & (threshold - 1)) < cap:
            count &= threshold - 1
            bitpos += nb_bits - 1
        else:
            if count >= threshold:
                count -= cap
            bitpos += nb_bits
        count -= 1  # extra accuracy; -1 encodes lowprob
        remaining -= -count if count < 0 else count
        check(charnum <= max_symbol_limit, ZstdErrorCode.maxSymbolValue_tooSmall)
        norm[charnum] = count
        charnum += 1
        previous0 = count == 0
        while remaining < threshold:
            nb_bits -= 1
            threshold >>= 1
        check(bitpos <= len(src) * 8 + 7, ZstdErrorCode.corruption_detected)

    check(remaining == 1, ZstdErrorCode.corruption_detected, "NCount sum mismatch")
    check(bitpos <= len(src) * 8, ZstdErrorCode.srcSize_wrong)
    max_symbol = charnum - 1
    nbytes = (bitpos + 7) >> 3
    return norm[: max_symbol + 1], max_symbol, table_log, nbytes


def write_ncount(norm: np.ndarray, max_symbol: int, table_log: int) -> bytes:
    """Serialize a normalized-count header (FSE_writeNCount_generic:203)."""
    out = bytearray()
    acc = 0
    bit_count = 0

    def push(value: int, nbits: int) -> None:
        nonlocal acc, bit_count
        acc |= (value & ((1 << nbits) - 1)) << bit_count
        bit_count += nbits
        while bit_count >= 16:
            out.append(acc & 0xFF)
            out.append((acc >> 8) & 0xFF)
            acc >>= 16
            bit_count -= 16

    table_size = 1 << table_log
    push(table_log - FSE_MIN_TABLELOG, 4)
    remaining = table_size + 1
    threshold = table_size
    nb_bits = table_log + 1
    symbol = 0
    previous_is_0 = False

    while remaining > 1:
        if previous_is_0:
            start = symbol
            while symbol <= max_symbol and norm[symbol] == 0:
                symbol += 1
            check(symbol <= max_symbol or remaining <= 1,
                  ZstdErrorCode.generic, "trailing zeros")
            while symbol >= start + 24:
                start += 24
                push(0xFFFF, 16)
            while symbol >= start + 3:
                start += 3
                push(3, 2)
            push(symbol - start, 2)
        count = int(norm[symbol])
        symbol += 1
        cap = (2 * threshold - 1) - remaining
        remaining -= -count if count < 0 else count
        count += 1  # +1 for extra accuracy
        if count >= threshold:
            count += cap
        push(count, nb_bits if count >= cap else nb_bits - 1)
        previous_is_0 = count == 1
        check(remaining >= 1, ZstdErrorCode.generic)
        while remaining < threshold:
            nb_bits -= 1
            threshold >>= 1

    # Flush remaining bits, byte-aligned.
    while bit_count > 0:
        out.append(acc & 0xFF)
        acc >>= 8
        bit_count -= 8
    check(symbol <= max_symbol + 1, ZstdErrorCode.generic)
    return bytes(out)


# ---------------------------------------------------------------------------
# Decode tables
# ---------------------------------------------------------------------------


@dataclass
class FseDTable:
    table_log: int
    symbol: np.ndarray  # uint8 [tableSize]
    nb_bits: np.ndarray  # uint8 [tableSize]
    new_state: np.ndarray  # uint16 [tableSize] (pre-shift base)
    # Optional sequence extensions (ZSTD_seqSymbol):
    base_value: np.ndarray | None = None  # uint32
    nb_add_bits: np.ndarray | None = None  # uint8


def _spread_symbols(norm: np.ndarray, max_symbol: int, table_log: int):
    """Symbol spread shared by C/D table builds (FseCompress.cs:13 inner).

    Returns (table_symbol: uint8[tableSize], high_threshold).
    """
    table_size = 1 << table_log
    table_mask = table_size - 1
    step = (table_size >> 1) + (table_size >> 3) + 3
    table_symbol = np.zeros(table_size, dtype=np.uint8)
    high_threshold = table_size - 1

    # Low-prob (-1) symbols sit at the top of the table.
    for s in range(max_symbol + 1):
        if norm[s] == -1:
            table_symbol[high_threshold] = s
            high_threshold -= 1

    if high_threshold == table_size - 1:
        # No lowprob symbols: positions are a pure stride walk; vectorize.
        reps = np.maximum(norm[: max_symbol + 1].astype(np.int64), 0)
        spread = np.repeat(np.arange(max_symbol + 1, dtype=np.uint8), reps)
        assert len(spread) == table_size
        positions = (np.arange(table_size, dtype=np.uint64) * np.uint64(step)) & np.uint64(table_mask)
        table_symbol[positions] = spread
    else:
        position = 0
        for s in range(max_symbol + 1):
            for _ in range(int(norm[s]) if norm[s] > 0 else 0):
                table_symbol[position] = s
                position = (position + step) & table_mask
                while position > high_threshold:
                    position = (position + step) & table_mask
        assert position == 0
    return table_symbol, high_threshold


def build_dtable(norm: np.ndarray, max_symbol: int, table_log: int) -> FseDTable:
    """Build an FSE decode table (ZSTD_buildFSETable_body:1571 semantics).

    The per-cell state fill is vectorized: the running per-symbol counter is
    each cell's rank among same-symbol cells (stable grouping by symbol).
    """
    table_size = 1 << table_log
    table_symbol, _ = _spread_symbols(norm, max_symbol, table_log)

    base = np.where(norm[: max_symbol + 1] == -1, 1,
                    np.maximum(norm[: max_symbol + 1], 0)).astype(np.int64)

    order = np.argsort(table_symbol, kind="stable")
    counts = np.bincount(table_symbol, minlength=max_symbol + 1).astype(np.int64)
    group_start = np.concatenate([[0], np.cumsum(counts)[:-1]])
    rank_sorted = np.arange(table_size) - group_start[table_symbol[order]]
    next_state = np.empty(table_size, dtype=np.int64)
    next_state[order] = base[table_symbol[order]] + rank_sorted

    high = np.zeros(table_size, dtype=np.int64)
    nz = next_state > 0
    high[nz] = np.floor(np.log2(next_state[nz])).astype(np.int64)
    nb = (table_log - high).astype(np.int64)
    nb_bits = nb.astype(np.uint8)
    new_state = ((next_state << nb) - table_size).astype(np.uint16)
    return FseDTable(table_log, table_symbol, nb_bits, new_state)


def build_sequence_dtable(norm: np.ndarray, max_symbol: int, table_log: int,
                          base_values: np.ndarray, add_bits: np.ndarray) -> FseDTable:
    """Decode table annotated with sequence base values / extra-bit widths."""
    dt = build_dtable(norm, max_symbol, table_log)
    dt.base_value = base_values[dt.symbol].astype(np.uint32)
    dt.nb_add_bits = add_bits[dt.symbol].astype(np.uint8)
    return dt


def fse_decompress(src: bytes, dtable: FseDTable, max_dst: int) -> bytes:
    """2-state interleaved FSE decode (FSE_decompress_usingDTable_generic:230).

    Used for Huffman weight payloads.
    """
    reader = BitReader(src)
    tlog = dtable.table_log
    sym = dtable.symbol
    nbb = dtable.nb_bits
    nst = dtable.new_state
    state1 = reader.read(tlog)
    state2 = reader.read(tlog)
    out = bytearray()

    def step(state: int) -> tuple[int, int]:
        s = sym[state]
        nb = nbb[state]
        low = reader.read(int(nb))
        return int(s), int(nst[state]) + low

    while True:
        if len(out) > max_dst - 2:
            raise ZstdError(ZstdErrorCode.dstSize_tooSmall, "weights overflow")
        s, state1 = step(state1)
        out.append(s)
        if reader.pos < 0:
            out.append(int(sym[state2]))
            break
        s, state2 = step(state2)
        out.append(s)
        if reader.pos < 0:
            out.append(int(sym[state1]))
            break
    return bytes(out)


# ---------------------------------------------------------------------------
# Normalization (encode side)
# ---------------------------------------------------------------------------


def min_table_log(src_size: int, max_symbol: int) -> int:
    min_bits_src = highbit32(src_size) + 1
    min_bits_symbols = highbit32(max(max_symbol, 1)) + 2
    return min(min_bits_src, min_bits_symbols)


def optimal_table_log(max_table_log: int, src_size: int, max_symbol: int,
                      minus: int = 2) -> int:
    """FSE_optimalTableLog_internal (FseCompress.cs)."""
    assert src_size > 1
    max_bits_src = highbit32(src_size - 1) - minus
    table_log = max_table_log if max_table_log else 11  # FSE_DEFAULT_TABLELOG
    table_log = min(table_log, max_bits_src)
    table_log = max(table_log, min_table_log(src_size, max_symbol))
    table_log = max(table_log, 5)
    table_log = min(table_log, 12)  # FSE_MAX_TABLELOG as compiled (14 - 2)
    return table_log


def _normalize_m2(norm: np.ndarray, table_log: int, count: np.ndarray,
                  total: int, max_symbol: int, low_prob: int) -> None:
    """Secondary normalization (FSE_normalizeM2:443) — exact port of logic."""
    NOT_YET = -2
    distributed = 0
    low_threshold = total >> table_log
    low_one = (total * 3) >> (table_log + 1)
    for s in range(max_symbol + 1):
        c = int(count[s])
        if c == 0:
            norm[s] = 0
        elif c <= low_threshold:
            norm[s] = low_prob
            distributed += 1
            total -= c
        elif c <= low_one:
            norm[s] = 1
            distributed += 1
            total -= c
        else:
            norm[s] = NOT_YET
    to_distribute = (1 << table_log) - distributed
    if to_distribute == 0:
        return
    if to_distribute and (total // to_distribute) > low_one:
        low_one = (total * 3) // (to_distribute * 2)
        for s in range(max_symbol + 1):
            if norm[s] == NOT_YET and int(count[s]) <= low_one:
                norm[s] = 1
                distributed += 1
                total -= int(count[s])
        to_distribute = (1 << table_log) - distributed
    if distributed == max_symbol + 1:
        # All low: dump the remainder on the most frequent symbol.
        max_v = int(np.argmax(count[: max_symbol + 1]))
        norm[max_v] += to_distribute
        return
    if total == 0:
        s = 0
        while to_distribute > 0:
            if norm[s] > 0:
                to_distribute -= 1
                norm[s] += 1
            s = (s + 1) % (max_symbol + 1)
        return
    v_step_log = 62 - table_log
    mid = (1 << (v_step_log - 1)) - 1
    r_step = ((1 << v_step_log) * to_distribute + mid) // total
    tmp_total = mid
    for s in range(max_symbol + 1):
        if norm[s] == NOT_YET:
            end = tmp_total + int(count[s]) * r_step
            s_start = tmp_total >> v_step_log
            s_end = end >> v_step_log
            weight = s_end - s_start
            check(weight >= 1, ZstdErrorCode.generic, "M2 weight underflow")
            norm[s] = weight
            tmp_total = end
    assert int(norm[: max_symbol + 1].sum()) != 0


def normalize_count(count: np.ndarray, table_log: int, total: int,
                    max_symbol: int, use_low_prob: bool) -> np.ndarray:
    """FSE_normalizeCount:574 — exact integer semantics.

    Returns norm (int16); raises on invalid inputs.  Caller guarantees no
    single symbol holds all occurrences (RLE handled upstream).
    """
    check(5 <= table_log <= 12, ZstdErrorCode.tableLog_tooLarge)
    check(table_log >= min_table_log(total, max_symbol), ZstdErrorCode.generic)
    low_prob = -1 if use_low_prob else 1
    scale = 62 - table_log
    step = (1 << 62) // total
    v_step = 1 << (scale - 20)
    still_to_distribute = 1 << table_log
    largest = 0
    largest_p = 0
    low_threshold = total >> table_log
    norm = np.zeros(max_symbol + 1, dtype=np.int64)
    for s in range(max_symbol + 1):
        c = int(count[s])
        if c == total:
            raise ZstdError(ZstdErrorCode.generic, "RLE input to normalize")
        if c == 0:
            norm[s] = 0
            continue
        if c <= low_threshold:
            norm[s] = low_prob
            still_to_distribute -= 1
        else:
            proba = (c * step) >> scale
            if proba < 8:
                rest_to_beat = v_step * _RTB_TABLE[proba]
                if c * step - (proba << scale) > rest_to_beat:
                    proba += 1
            if proba > largest_p:
                largest_p = proba
                largest = s
            norm[s] = proba
            still_to_distribute -= proba
    if -still_to_distribute >= (int(norm[largest]) >> 1):
        _normalize_m2(norm, table_log, count, total, max_symbol, low_prob)
    else:
        norm[largest] += still_to_distribute
    assert int(np.abs(norm).sum()) <= (1 << table_log)
    return norm.astype(np.int16)


# ---------------------------------------------------------------------------
# Compress tables & encoding
# ---------------------------------------------------------------------------


@dataclass
class FseCTable:
    table_log: int
    state_table: np.ndarray  # uint16 [tableSize]: next-state numbers
    delta_nb_bits: np.ndarray  # uint32 [maxSymbol+1]
    delta_find_state: np.ndarray  # int32 [maxSymbol+1]
    # Distribution metadata for repeat-mode cost estimation.
    norm: np.ndarray | None = None  # int16 [maxSymbol+1]
    max_symbol: int = -1


def build_ctable(norm: np.ndarray, max_symbol: int, table_log: int) -> FseCTable:
    """FSE_buildCTable_wksp:13 — state table + symbol transforms."""
    table_size = 1 << table_log
    table_symbol, _ = _spread_symbols(norm, max_symbol, table_log)

    normv = np.asarray(norm[: max_symbol + 1], dtype=np.int64)
    occ = np.where(normv == -1, 1, np.maximum(normv, 0))
    cumul = np.concatenate([[0], np.cumsum(occ)])[: max_symbol + 1]

    # state_table[cumul[s] + rank_of(u within symbol s)] = tableSize + u
    order = np.argsort(table_symbol, kind="stable")
    counts = np.bincount(table_symbol, minlength=max_symbol + 1).astype(np.int64)
    group_start = np.concatenate([[0], np.cumsum(counts)[:-1]])
    rank_sorted = np.arange(table_size) - group_start[table_symbol[order]]
    slots = cumul[table_symbol[order]] + rank_sorted
    state_table = np.zeros(table_size, dtype=np.uint16)
    state_table[slots] = (table_size + order).astype(np.uint16)

    nlow = (normv == -1) | (normv == 1)
    nbig = normv > 1
    high = np.zeros(max_symbol + 1, dtype=np.int64)
    high[nbig] = np.floor(np.log2(normv[nbig] - 1)).astype(np.int64)
    max_bits_out = table_log - high

    delta_nb = np.zeros(max_symbol + 1, dtype=np.int64)
    delta_nb[normv == 0] = ((table_log + 1) << 16) - table_size
    delta_nb[nlow] = (table_log << 16) - table_size
    delta_nb[nbig] = (max_bits_out[nbig] << 16) - (normv[nbig] << max_bits_out[nbig])

    total_before = np.concatenate([[0], np.cumsum(occ)[:-1]])
    delta_fs = np.zeros(max_symbol + 1, dtype=np.int64)
    delta_fs[nlow] = total_before[nlow] - 1
    delta_fs[nbig] = total_before[nbig] - normv[nbig]
    return FseCTable(table_log, state_table,
                     delta_nb.astype(np.uint32), delta_fs.astype(np.int32),
                     norm=normv.astype(np.int16), max_symbol=max_symbol)


class FseEncoder:
    """One FSE encode state machine (FSE_initCState2/encodeSymbol/flush)."""

    __slots__ = ("ct", "value")

    def __init__(self, ct: FseCTable, first_symbol: int):
        # initCState2: establish state from first symbol without emitting bits.
        nb_out = (int(ct.delta_nb_bits[first_symbol]) + (1 << 15)) >> 16
        value = (nb_out << 16) - int(ct.delta_nb_bits[first_symbol])
        self.value = int(ct.state_table[(value >> nb_out) + int(ct.delta_find_state[first_symbol])])
        self.ct = ct

    def encode(self, writer: BitWriter, symbol: int) -> None:
        nb_out = (self.value + int(self.ct.delta_nb_bits[symbol])) >> 16
        writer.add(self.value, nb_out)
        self.value = int(self.ct.state_table[(self.value >> nb_out) + int(self.ct.delta_find_state[symbol])])

    def flush(self, writer: BitWriter) -> None:
        writer.add(self.value, self.ct.table_log)


def fse_compress(symbols: bytes | np.ndarray, ct: FseCTable) -> bytes:
    """2-state interleaved FSE encode (FSE_compress_usingCTable_generic:722).

    Symbols are consumed back-to-front; states alternate exactly like the
    reference so the output is decodable by any conformant decoder.
    """
    sym = np.asarray(bytearray(bytes(symbols)) if not isinstance(symbols, np.ndarray) else symbols, dtype=np.uint8)
    n = len(sym)
    assert n > 1
    w = BitWriter()
    ip = n
    if n & 1:
        c1 = FseEncoder(ct, int(sym[ip - 1]))
        c2 = FseEncoder(ct, int(sym[ip - 2]))
        c1.encode(w, int(sym[ip - 3]))
        ip -= 3
    else:
        c2 = FseEncoder(ct, int(sym[ip - 1]))
        c1 = FseEncoder(ct, int(sym[ip - 2]))
        ip -= 2
    if (n - 2) & 2:
        c2.encode(w, int(sym[ip - 1]))
        c1.encode(w, int(sym[ip - 2]))
        ip -= 2
    while ip > 0:
        c2.encode(w, int(sym[ip - 1]))
        c1.encode(w, int(sym[ip - 2]))
        c2.encode(w, int(sym[ip - 3]))
        c1.encode(w, int(sym[ip - 4]))
        ip -= 4
    c2.flush(w)
    c1.flush(w)
    return w.close()
