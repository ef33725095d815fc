"""Match finding: source bytes -> sequence store (ll, ml, offBase); the
port's copy of zstdsharp_tpu/encode/seqstore.py.  Each strategy calls the
native engine's parser; the Python matchers below run where it declines.

Reference strategies (SURVEY.md §2.1):
  fast        ZstdFast.cs:96   (single hash table, greedy, step skipping)
  dfast       ZstdDoubleFast.cs (long+short tables)
  greedy/lazy ZstdLazy.cs:1743 (hash chain, 0/1/2-step lookahead)

These host implementations define the sequence semantics (offBase encoding:
1..3 = repcodes, >3 = offset+3, matching ZSTD_storeSeq
ZstdCompressInternal.cs:204) and serve as the oracle for the batched device
matchers in ops/.  They are deliberately *not* bit-compatible with the
reference's parse decisions — frames are validated by decodability and
compressed-size parity instead (see PARITY.md).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .. import native
from ..constants import Strategy

HASH_READ_LIMIT = 8  # stop matching this close to block end (wildcopy margin)
SEARCH_STRENGTH_FAST = 6
SEARCH_STRENGTH_LAZY = 8
MIN_MATCH = 3


@dataclass
class SeqStore:
    lit_len: np.ndarray  # uint32
    match_len: np.ndarray  # uint32 (actual length, >= 3)
    off_base: np.ndarray  # uint32 (1..3 rep, else offset+3)
    last_literals: int

    @property
    def nb_seq(self) -> int:
        return len(self.lit_len)


def _u32view(src: np.ndarray) -> np.ndarray:
    """Little-endian u32 read at every byte position (length n-3)."""
    n = len(src)
    a = src.astype(np.uint32)
    return a[: n - 3] | (a[1 : n - 2] << 8) | (a[2 : n - 1] << 16) | (a[3:n] << 24)


def _hash_u32(v32: np.ndarray, hash_log: int) -> np.ndarray:
    return ((v32 * np.uint32(2654435761)) >> np.uint32(32 - hash_log)).astype(np.int64)


def _match_length(src: np.ndarray, a: int, b: int, end: int) -> int:
    """Length of common prefix of src[a:end] and src[b:end-(a-b)]; a > b."""
    n = min(end - a, len(src) - a)
    step = 512
    length = 0
    while length < n:
        c = min(step, n - length)
        ea = src[a + length : a + length + c]
        eb = src[b + length : b + length + c]
        neq = np.nonzero(ea != eb)[0]
        if len(neq):
            return length + int(neq[0])
        length += c
        step = min(step * 2, 1 << 16)
    return n


class MatchState:
    """Persistent cross-block matcher state for one frame (hash tables +
    repcodes), the moral equivalent of ZSTD_matchState_t."""

    def __init__(self, cparams, window_start: int = 0):
        self.cparams = cparams
        self.hash_table = np.zeros(1 << cparams.hash_log, dtype=np.int64) - 1
        self.chain_table = (np.zeros(1 << cparams.chain_log, dtype=np.int64) - 1
                            if cparams.strategy >= Strategy.GREEDY else None)
        self.rep = [1, 4, 8]
        self.window_start = window_start


def fill_hash_table(state: MatchState, src: np.ndarray, start: int, end: int) -> None:
    """Index history bytes (dictionary content / RLE-skipped spans) into the
    fast hash table (ZSTD_fillHashTable, ZstdFast.cs:9).  Vectorized scatter:
    later positions overwrite earlier, matching the sequential fill."""
    cp = state.cparams
    end = min(end, len(src) - 4)
    if end <= start:
        return
    v32 = _u32view(src[: end + 4])
    h = _hash_u32(v32[start:end], cp.hash_log)
    state.hash_table[h] = np.arange(start, end, dtype=np.int64)


# ---------------------------------------------------------------------------
# Fast strategy (levels 1-2): greedy single-table
# ---------------------------------------------------------------------------


def compress_block_fast(src: np.ndarray, start: int, end: int,
                        state: MatchState) -> SeqStore:
    """Greedy fast matcher (ZSTD_compressBlock_fast_noDict_generic:96 shape:
    rep0-check at ip+1, accelerated stride on miss, backward extension)."""
    cp = state.cparams
    if end - start >= 16:
        acc = cp.target_length if cp.target_length else 1
        res = native.fast_find_matches(
            np.ascontiguousarray(src), start, end, state.window_start,
            1 << cp.window_log, state.hash_table, cp.hash_log,
            state.rep, acc, mls=cp.min_match)
        if res is not None:
            lls, mls, obs, last_lit = res
            return SeqStore(lls, mls, obs, last_lit)
    hlog = cp.hash_log
    table = state.hash_table
    window = 1 << cp.window_log
    rep0, rep1 = state.rep[0], state.rep[1]

    n = len(src)
    if end - start < 16:
        return SeqStore(np.empty(0, np.uint32), np.empty(0, np.uint32),
                        np.empty(0, np.uint32), end - start)
    v32 = _u32view(src[: min(n, end + 4)])
    h = _hash_u32(v32, hlog)
    v32_l = v32.tolist()
    h_l = h.tolist()
    limit = end - HASH_READ_LIMIT

    lls, mls, obs = [], [], []
    anchor = start
    pos = start + (state.window_start == 0 and start == 0)

    acceleration = cp.target_length if cp.target_length else 1

    while pos < limit:
        hv = h_l[pos]
        cand = table[hv]
        table[hv] = pos
        cur = v32_l[pos]
        # rep0 probe at pos+1 (matches the reference's ip1 rep check).
        if pos + 1 - rep0 >= state.window_start and pos + 1 < limit and \
                v32_l[pos + 1] == v32_l[pos + 1 - rep0]:
            ml = 4 + _match_length(src, pos + 5, pos + 5 - rep0, end)
            p = pos + 1
            lls.append(p - anchor)
            mls.append(ml)
            obs.append(1)
            pos = p + ml
            anchor = pos
            if pos + 4 < limit:
                table[h_l[pos - 2]] = pos - 2
            # rep continuation probes
            while pos < limit and v32_l[pos] == v32_l[pos - rep1]:
                ml = 4 + _match_length(src, pos + 4, pos + 4 - rep1, end)
                rep0, rep1 = rep1, rep0
                table[h_l[pos]] = pos
                lls.append(0)
                mls.append(ml)
                obs.append(1)
                pos += ml
                anchor = pos
            continue
        if cand >= state.window_start and cand >= pos - (window - 1) and v32_l[cand] == cur:
            ml = 4 + _match_length(src, pos + 4, cand + 4, end)
            # backward extension
            while pos > anchor and cand > state.window_start and \
                    src[pos - 1] == src[cand - 1]:
                pos -= 1
                cand -= 1
                ml += 1
            offset = pos - cand
            lls.append(pos - anchor)
            mls.append(ml)
            obs.append(offset + 3)
            rep1 = rep0
            rep0 = offset
            pos += ml
            anchor = pos
            if pos + 4 < limit:
                table[h_l[pos - 2]] = pos - 2
            while pos < limit and v32_l[pos] == v32_l[pos - rep1]:
                ml = 4 + _match_length(src, pos + 4, pos + 4 - rep1, end)
                rep0, rep1 = rep1, rep0
                table[h_l[pos]] = pos
                lls.append(0)
                mls.append(ml)
                obs.append(1)
                pos += ml
                anchor = pos
            continue
        pos += acceleration + ((pos - anchor) >> SEARCH_STRENGTH_FAST)

    state.rep[0], state.rep[1] = rep0, rep1
    return SeqStore(np.array(lls, np.uint32), np.array(mls, np.uint32),
                    np.array(obs, np.uint32), end - anchor)


# ---------------------------------------------------------------------------
# Hash-chain lazy strategy (levels 5-12; also serves greedy with depth=0)
# ---------------------------------------------------------------------------


def compress_block_lazy(src: np.ndarray, start: int, end: int,
                        state: MatchState, depth: int = 1) -> SeqStore:
    """Hash-chain lazy matcher (ZSTD_compressBlock_lazy_generic:1743 shape).

    depth 0 = greedy, 1 = lazy, 2 = lazy2 lookahead arbitration.
    """
    cp = state.cparams
    if end - start >= 16:
        res = native.lazy_find_matches(
            np.ascontiguousarray(src), start, end, state.window_start,
            1 << cp.window_log, state.hash_table, cp.hash_log,
            state.chain_table, 1 << cp.search_log, depth,
            getattr(state, "_next_to_insert", start), state.rep,
            mls=cp.min_match)
        if res is not None:
            lls, mls, obs, last_lit, ins = res
            state._next_to_insert = ins
            return SeqStore(lls, mls, obs, last_lit)
    hlog = cp.hash_log
    table = state.hash_table
    chain = state.chain_table
    chain_mask = len(chain) - 1
    window = 1 << cp.window_log
    max_attempts = 1 << cp.search_log
    rep = list(state.rep)

    n = len(src)
    if end - start < 16:
        return SeqStore(np.empty(0, np.uint32), np.empty(0, np.uint32),
                        np.empty(0, np.uint32), end - start)
    v32 = _u32view(src[: min(n, end + 4)])
    h = _hash_u32(v32, hlog)
    v32_l = v32.tolist()
    h_l = h.tolist()
    limit = end - HASH_READ_LIMIT
    ws = state.window_start

    insert_from = getattr(state, "_next_to_insert", start)

    def insert_upto(p: int) -> None:
        nonlocal insert_from
        while insert_from < min(p, limit):
            hv = h_l[insert_from]
            chain[insert_from & chain_mask] = table[hv]
            table[hv] = insert_from
            insert_from += 1

    def search(p: int) -> tuple[int, int]:
        """Best (length, offset) via hash chain; (0,0) if none."""
        insert_upto(p)
        hv = h_l[p]
        cand = table[hv]
        cur = v32_l[p]
        best_len, best_off = 0, 0
        low = max(ws, p - (window - 1))
        for _ in range(max_attempts):
            if cand < low or cand < 0:
                break
            if v32_l[cand] == cur:
                length = 4 + _match_length(src, p + 4, cand + 4, end)
                if length > best_len:
                    best_len, best_off = length, p - cand
            nxt = chain[cand & chain_mask]
            if nxt >= cand:
                break
            cand = nxt
        return best_len, best_off

    def rep_len(p: int, r: int) -> int:
        if p - r >= ws and p + 4 <= end and v32_l[p] == v32_l[p - r]:
            return 4 + _match_length(src, p + 4, p + 4 - r, end)
        return 0

    lls, mls, obs = [], [], []
    anchor = start
    pos = start + (ws == 0 and start == 0)

    while pos < limit:
        # rep0 probe only with litLength >= 1: offset_value 1 with ll==0 means
        # rep1 to the decoder (RFC 8878 §3.1.1.5), so a rep0 match at the
        # anchor is inexpressible; the continuation loop below covers rep1.
        rl = rep_len(pos, rep[0]) if pos > anchor else 0
        ml, off = search(pos)
        if rl >= 4 and rl + 3 >= ml:  # prefer rep (cheap offset)
            ml, off = rl, 0  # off 0 marks rep0
        if ml < 4:
            pos += 1 + ((pos - anchor) >> SEARCH_STRENGTH_LAZY)
            continue
        # Lazy lookahead: is a match starting one byte later better?
        d = depth
        while d > 0 and pos + 1 < limit:
            gain_thresh = ml + (3 if off == 0 else 0)
            rl2 = rep_len(pos + 1, rep[0])
            ml2, off2 = search(pos + 1)
            cand_best = max(rl2 + 3 if rl2 >= 4 else 0, ml2 - (0 if off2 == 0 else 1))
            better = False
            if rl2 >= 4 and rl2 + 3 > gain_thresh - 3:
                pos, ml, off = pos + 1, rl2, 0
                better = True
            elif ml2 >= 4 and ml2 > ml + (off2 != off):
                pos, ml, off = pos + 1, ml2, off2
                better = True
            if not better:
                break
            d -= 1
        # Backward extension for offset matches.
        if off > 0:
            cand = pos - off
            while pos > anchor and cand > ws and src[pos - 1] == src[cand - 1]:
                pos -= 1
                cand -= 1
                ml += 1
            rep[1] = rep[0]
            rep[0] = off
            ob = off + 3
        else:
            ob = 1
        lls.append(pos - anchor)
        mls.append(ml)
        obs.append(ob)
        pos += ml
        anchor = pos
        insert_upto(min(pos, limit))
        # rep1-continuation after a match (swap reps, zstd lazy tail loop)
        while pos < limit:
            rl = rep_len(pos, rep[1])
            if rl < 4:
                break
            rep[0], rep[1] = rep[1], rep[0]
            lls.append(0)
            mls.append(rl)
            obs.append(1)
            pos += rl
            anchor = pos
            insert_upto(min(pos, limit))

    state._next_to_insert = insert_from
    state.rep[:] = rep
    return SeqStore(np.array(lls, np.uint32), np.array(mls, np.uint32),
                    np.array(obs, np.uint32), end - anchor)


# ---------------------------------------------------------------------------
# Strategy dispatch (ZSTD_selectBlockCompressor:3397)
# ---------------------------------------------------------------------------


def compress_block(src: np.ndarray, start: int, end: int, state: MatchState) -> SeqStore:
    s = state.cparams.strategy
    if s <= Strategy.DFAST:
        return compress_block_fast(src, start, end, state)
    if s == Strategy.GREEDY:
        return compress_block_lazy(src, start, end, state, depth=0)
    if s == Strategy.LAZY:
        return compress_block_lazy(src, start, end, state, depth=1)
    # lazy2 and all bt* strategies use depth-2 lazy until the optimal parser
    # lands (PARITY.md).
    return compress_block_lazy(src, start, end, state, depth=2)
