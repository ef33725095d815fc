"""Device batch encoder in torch: greedy parse -> FSE-coded sequences and
Huffman literals -> one standard zstd frame row per record (counterpart of
zstdsharp_tpu/ops/device_encode.py).

Three phases per batch of B padded records ``[B, N]``, as the reference:

1. parse (device): the greedy parse, the literal compaction and the
   36/32/53 bin sequence-code histograms, on a GPU in one launch of the
   ``csrc/lz_parse.cu`` kernel (``lz_parse.parse_lanes``) and on the CPU
   in its plain torch version (``lz_parse.parse_plain``), then the literal
   byte histogram through ``histogram.histogram_u8`` (the
   ``csrc/histogram.cu`` kernel on a GPU, plain torch on the CPU);
2. tables (host): one copy of every count to the host -- the batch's only
   host synchronisation -- then the reference's numpy table builders
   (canonical Huffman literal tables, fresh/RLE/predefined FSE tables at
   the default logs), uploaded once;
3. assembly (device): the FSE state chains, the sequence and 4-stream
   Huffman bitstreams and the frame row, on a GPU in one launch of the
   ``csrc/assemble.cu`` kernel (``assemble.assemble_lanes``) and on the
   CPU in its plain torch version (``assemble.assemble_plain``: the state
   chains by permutation-map composition, the prefix-scan packer and a
   byte-position classifier).

The reference vmaps one-lane functions; here the lane axis is the leading
dimension of every tensor.  Integer semantics are the reference's with
JAX's x64 mode off (see ``ops.common``): u32 quantities live in int64
tensors.  Nothing here synchronises with the host except step 2.

The host builders (``_tables``, ``_symbol_maps``, ``_build_lit_tables``,
``_build_seq_tables``, ``seq_budget``, ``word_budget``) are copied from
the reference; they call the port's own host tier (``..entropy``,
``..constants``).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import constants as C
from ..entropy import fse, huffman
from ..utils import trace

from .common import highbit
from .histogram import histogram_u8
from . import assemble, lz_parse

MINMATCH = 3  # format minimum (the parse emits >= 4)


# ---------------------------------------------------------------------------
# Host-built constants: predefined encode tables + code LUTs
# ---------------------------------------------------------------------------

_CONST_CACHE: dict = {}


def _tables():
    """Predefined FSE encode tables (RFC8878 defaults) + code LUTs, as
    numpy constants."""
    if "t" in _CONST_CACHE:
        return _CONST_CACHE["t"]
    ll = fse.build_ctable(C.LL_DEFAULT_NORM, C.MAX_LL, C.LL_DEFAULT_NORM_LOG)
    ml = fse.build_ctable(C.ML_DEFAULT_NORM, C.MAX_ML, C.ML_DEFAULT_NORM_LOG)
    of = fse.build_ctable(C.OF_DEFAULT_NORM, C.DEFAULT_MAX_OFF,
                          C.OF_DEFAULT_NORM_LOG)

    def pack(ct):
        d = {
            "tlog": int(ct.table_log),
            "dnb": np.asarray(ct.delta_nb_bits, np.int64).astype(np.int32),
            "dfs": np.asarray(ct.delta_find_state, np.int32),
            # state numbers relative to table start (u in [0, TS))
            "st": (np.asarray(ct.state_table, np.int64)
                   - (1 << ct.table_log)).astype(np.int32),
        }
        d["maps"], d["nbs"], d["init"] = _symbol_maps(d)
        return d

    # value -> code LUTs (ZSTD_LLcode/ZSTD_MLcode small-value tables)
    ll_lut = (np.searchsorted(C.LL_BASE, np.arange(64), side="right")
              - 1).astype(np.int32)
    mlv = np.arange(128) + MINMATCH
    ml_lut = (np.searchsorted(C.ML_BASE, mlv, side="right") - 1).astype(np.int32)
    t = {
        "ll": pack(ll), "ml": pack(ml), "of": pack(of),
        "ll_lut": ll_lut, "ml_lut": ml_lut,
        "ll_bits": C.LL_BITS.astype(np.int32),
        "ml_bits": C.ML_BITS.astype(np.int32),
    }
    _CONST_CACHE["t"] = t
    return t


def _symbol_maps(stream):
    """[NSYM, TS] next-state permutation + emitted-bit-count tables and
    the [NSYM] init states: the per-symbol FSE transition precomputed
    over every state, so the device builds its scan operands with one
    row-gather instead of in-kernel arithmetic + table probes."""
    tlog = stream["tlog"]
    TS = 1 << tlog
    dnb = stream["dnb"].astype(np.int64)
    dfs = stream["dfs"].astype(np.int64)
    st = stream["st"].astype(np.int64)
    u = np.arange(TS)[None, :]
    val = TS + u
    nb = (val + dnb[:, None]) >> 16
    nxt = st[np.clip((val >> nb) + dfs[:, None], 0, TS - 1)]
    # FSE_initCState2 per symbol (pure function of the table)
    nb0 = (dnb + (1 << 15)) >> 16
    v0 = (nb0 << 16) - dnb
    init = st[np.clip((v0 >> nb0) + dfs, 0, TS - 1)]
    return nxt.astype(np.int32), nb.astype(np.uint8), init.astype(np.int32)


_DEV_CACHE: dict = {}


def _dev_consts(device: torch.device) -> dict:
    """``_tables()``'s code LUTs and the frame magic as int64 tensors on
    `device`, uploaded once per device."""
    key = str(device)
    if key not in _DEV_CACHE:
        t = _tables()

        def up(a):
            return torch.from_numpy(np.asarray(a)).to(device=device,
                                                      dtype=torch.int64)

        d = {k: up(t[k]) for k in ("ll_lut", "ml_lut", "ll_bits", "ml_bits")}
        d["magic"] = up([0x28, 0xB5, 0x2F, 0xFD, 0xA0])  # magic | FHD 0xA0
        _DEV_CACHE[key] = d
    return _DEV_CACHE[key]


def _codes_from_values(ll, mlv, ofb, lut):
    """ZSTD_seqToCodes: (litLen, matchLen-3, offBase) -> (llCode, mlCode,
    ofCode), int64."""
    ll_code = torch.where(ll > 63, highbit(ll) + 19,
                          lut["ll_lut"][ll.clamp(0, 63)])
    ml_code = torch.where(mlv > 127, highbit(mlv) + 36,
                          lut["ml_lut"][mlv.clamp(0, 127)])
    return ll_code, ml_code, highbit(ofb)


def _seq_values(starts, mls, offs, nseq):
    """Per-sequence (real, litLen, matchLen-3, offBase) of each row, int64
    [B, S].  An offset equal to the previous sequence's, with literals in
    between, is repcode 1 (rep0): zero extra bits."""
    B, S = starts.shape
    i = torch.arange(S, device=starts.device)
    real = i < nseq.to(torch.int64)[:, None]
    st, ml, of = starts.to(torch.int64), mls.to(torch.int64), offs.to(torch.int64)
    zero = torch.zeros(B, 1, dtype=torch.int64, device=starts.device)
    prev_end = torch.cat([zero, (st + ml)[:, :-1]], 1)
    ll = torch.where(real, st - prev_end, 0)
    mlv = torch.where(real, ml - MINMATCH, 0)
    prev_off = torch.cat([zero, of[:, :-1]], 1)
    rep0 = (i > 0) & (of == prev_off) & (ll > 0)
    ofb = torch.where(real, torch.where(rep0, 1, of + 3), 1)
    return real, ll, mlv, ofb


def _code_hist(codes, real, n_sym):
    """[B, n_sym] int32 counts of the real sequences' codes (codes outside
    [0, n_sym) count nowhere, as the reference's compare-reduce)."""
    ok = (codes >= 0) & (codes < n_sym)
    out = torch.zeros(codes.shape[0], n_sym + 1, dtype=torch.int32,
                      device=codes.device)
    out.scatter_add_(1, torch.where(ok, codes, n_sym), real.to(torch.int32))
    return out[:, :n_sym]


# ---------------------------------------------------------------------------
# FSE state chain via permutation-map suffix composition
# ---------------------------------------------------------------------------

_G = 64  # maps composed serially within a chunk


def _fse_stream_states(codes, nseq, stream, tables=None):
    """All encoder states of one FSE stream of every row at once.

    codes: [B, S] code symbols per sequence (garbage beyond nseq); nseq
    [B].  `tables` optionally overrides the predefined encode table with
    per-row (maps [B, NSYM, TS] int32, nbs [B, NSYM, TS] uint8, init
    [B, NSYM] int32) of the SAME table log.  Returns (emit_val [B, S],
    emit_nb [B, S], flush_val [B]), int64: slot i holds the state bits
    written when encoding symbol i (zero-width for i >= nseq-1), flush_val
    the final tableLog-bit state field.

    Each symbol's transition is a permutation map over the TS states, so
    the chain is a composition of maps, taken back to front: 64-step
    serial compositions within chunks (all chunks at once), then a
    log-depth suffix composition over the chunk composites.  Composition
    is associative, so this gives the reference's integers exactly.  Maps
    stay int32 ([B, S, TS] is 215 MB per stream at the 128 KB bucket);
    only gather indices are widened.
    """
    B, S = codes.shape
    dev = codes.device
    TS = 1 << stream["tlog"]
    if tables is None:
        tables = tuple(torch.from_numpy(stream[k]).to(dev).expand(
            B, *stream[k].shape) for k in ("maps", "nbs", "init"))
    sym_maps, sym_nbs, sym_init = tables
    nsym = sym_maps.shape[1]
    i64 = torch.int64
    i = torch.arange(S, device=dev)
    ns = nseq.to(i64)[:, None]
    c = codes.to(i64).clamp(0, nsym - 1)

    # init state from the LAST real symbol (FSE_initCState2, host-built)
    c_last = torch.gather(c, 1, (ns - 1).clamp(0, S - 1))
    u_init = torch.gather(sym_init.to(i64), 1, c_last)            # [B, 1]

    # per-symbol permutation maps, one row-gather; identity past nseq-2
    rows = (torch.arange(B, device=dev)[:, None] * nsym + c).reshape(-1)
    nxt = sym_maps.reshape(B * nsym, TS)[rows].reshape(B, S, TS)
    u = torch.arange(TS, dtype=torch.int32, device=dev)
    S_pad = -(-S // _G) * _G
    NC = S_pad // _G
    maps = torch.empty(B, S_pad, TS, dtype=torch.int32, device=dev)
    maps[:] = u
    maps[:, :S] = torch.where((i <= ns - 2)[:, :, None], nxt, u)
    mc = maps.reshape(B, NC, _G, TS)

    # within-chunk suffix trajectories wc[c, g](x) = M_g(M_{g+1}(...(x)))
    wc = torch.empty_like(mc)
    carry = u.expand(B, NC, TS)
    for g in range(_G - 1, -1, -1):
        carry = torch.gather(mc[:, :, g], 2, carry.to(i64))
        wc[:, :, g] = carry

    # suffix composites over chunks, comp[c](x) = cm[c](cm[c+1](...(x))),
    # by doubling; entry[c] = state entering chunk c from the right
    comp = wc[:, :, 0]
    step = 1
    while step < NC:
        head = torch.gather(comp[:, :-step], 2, comp[:, step:].to(i64))
        comp = torch.cat([head, comp[:, NC - step:]], 1)
        step *= 2
    entry = torch.cat([torch.gather(comp[:, 1:], 2,
                                    u_init[:, :, None].expand(B, NC - 1, 1)
                                    )[:, :, 0].to(i64), u_init], 1)  # [B, NC]

    # state AFTER encoding symbol i: u_i = wc[chunk(i), pos(i)][entry];
    # the emission at step i uses the INCOMING state u_{i+1}
    u_all = torch.gather(wc, 3, entry[:, :, None, None].expand(B, NC, _G, 1)
                         ).reshape(B, S_pad)[:, :S].to(i64)
    u_next = torch.cat([u_all[:, 1:], torch.zeros_like(u_all[:, :1])], 1)

    emit_val = TS + u_next
    nb = torch.gather(sym_nbs.reshape(B, nsym * TS), 1, c * TS + u_next)
    emit_nb = torch.where(i <= ns - 2, nb.to(i64), 0)
    flush_val = torch.where(ns[:, 0] > 0, u_all[:, 0], 0)
    return emit_val, emit_nb, flush_val


# ---------------------------------------------------------------------------
# Phase 1 (device): parse, literal compaction, histograms
# ---------------------------------------------------------------------------


def _parse_phase(blocks, n_valid, S: int, hash_log: int):
    """Greedy parse + literal compaction + literal and code histograms.
    Returns (parsed, lit_sorted uint8 [B, N], lit_count int32 [B],
    lit_hist int32 [B, 256], (ll [B, 36], of [B, 32], ml [B, 53]) int32).
    On a card everything but the literal histogram is one launch of the
    ``csrc/lz_parse.cu`` kernel (``lz_parse.parse_lanes``); on the CPU its
    plain torch version (``lz_parse.parse_plain``)."""
    out = lz_parse.parse(blocks, n_valid, S, hash_log, 8, 8, compact=True)
    parsed = {k: out[k] for k in lz_parse.PARSE_KEYS}
    lit_sorted, lit_count = out["lit_sorted"], out["lit_count"]
    idx = torch.arange(blocks.shape[1], device=blocks.device)
    lit_hist = histogram_u8(lit_sorted,
                            mask=idx < lit_count.to(torch.int64)[:, None])
    hists = tuple(out[name] for name, _ in lz_parse.HIST_BINS)
    return parsed, lit_sorted, lit_count, lit_hist, hists


# ---------------------------------------------------------------------------
# Phase 2 (host): table builders, copied from the reference
# ---------------------------------------------------------------------------

DESC_MAX = 160   # serialized Huffman table descriptor cap


def _build_lit_tables(lit_hist: np.ndarray, lit_count: np.ndarray):
    """Host middle phase: canonical Huffman tables per lane from device
    histograms (HUF_buildCTable/HUF_writeCTable role).  Returns
    (codes [B,256] u32, nbits [B,256] u32, desc [B,DESC_MAX] u8,
    desc_len [B] i32, huf_ok [B] bool)."""
    B = lit_hist.shape[0]
    codes = np.zeros((B, 256), np.uint32)
    nbits = np.zeros((B, 256), np.uint32)
    desc = np.zeros((B, DESC_MAX), np.uint8)
    desc_len = np.zeros(B, np.int32)
    huf_ok = np.zeros(B, bool)
    for b in range(B):
        n = int(lit_count[b])
        counts = lit_hist[b]
        nz = np.nonzero(counts)[0]
        if n < 64 or len(nz) < 2 or int(counts.max()) >= n:
            continue  # raw/RLE territory
        try:
            ct = huffman.build_ctable(counts, int(nz[-1]), 11)
            d = huffman.write_ctable(ct)
        except Exception:
            continue
        if len(d) > DESC_MAX:
            continue
        codes[b, :ct.max_symbol + 1] = ct.code
        nbits[b, :ct.max_symbol + 1] = ct.nb_bits
        desc[b, :len(d)] = np.frombuffer(d, np.uint8)
        desc_len[b] = len(d)
        huf_ok[b] = True
    return codes, nbits, desc, desc_len, huf_ok


TBL_MAX = 128   # per-lane sequence-tables area cap (3 NCounts)


def _build_seq_tables(hists, nseq: np.ndarray, t):
    """Host middle phase: per-lane FSE tables from device code histograms
    (ZSTD_selectEncodingType + FSE_normalizeCount role, restricted to the
    DEFAULT table logs so every device shape stays static).  Per channel:
    fresh FSE (mode 2) when it pays, RLE (mode 1) for single-symbol
    streams, predefined (mode 0) otherwise."""
    chans = (("ll", 0, 35), ("of", 1, 31), ("ml", 2, 52))
    B = nseq.shape[0]
    mode = np.zeros((B, 3), np.int32)
    tbl = np.zeros((B, TBL_MAX), np.uint8)
    tbl_len = np.zeros(B, np.int32)
    out = {}
    for name, ci, max_code in chans:
        st_def = t[name]
        nsym = st_def["dnb"].shape[0]
        TS = 1 << st_def["tlog"]
        maps = np.broadcast_to(st_def["maps"], (B, nsym, TS)).copy()
        nbs = np.broadcast_to(st_def["nbs"], (B, nsym, TS)).copy()
        init = np.broadcast_to(st_def["init"], (B, nsym)).copy()
        flush = np.full(B, st_def["tlog"], np.int32)
        out[name] = (maps, nbs, init, flush)
    for b in range(B):
        n = int(nseq[b])
        if n < 32:
            continue
        parts = []
        ok_modes = [0, 0, 0]
        for name, ci, max_code in chans:
            counts = np.asarray(hists[ci][b], np.int64)
            nz = np.nonzero(counts)[0]
            st_def = _tables()[name]
            if len(nz) == 1:
                ok_modes[ci] = 1
                parts.append(bytes([int(nz[0])]))
                out[name][0][b] = 0      # zero-width channel
                out[name][1][b] = 0
                out[name][2][b] = 0
                out[name][3][b] = 0
                continue
            try:
                max_sym = int(nz[-1])
                tlog = st_def["tlog"]
                norm = fse.normalize_count(counts[:max_sym + 1], tlog,
                                           n, max_sym, False)
                hdr = fse.write_ncount(norm, max_sym, tlog)
                ct = fse.build_ctable(norm, max_sym, tlog)
            except Exception:
                continue
            ok_modes[ci] = 2
            parts.append(hdr)
            fresh = {
                "tlog": tlog,
                "dnb": np.asarray(ct.delta_nb_bits, np.int64).astype(
                    np.int32),
                "dfs": np.asarray(ct.delta_find_state, np.int32),
                "st": (np.asarray(ct.state_table, np.int64)
                       - (1 << tlog)).astype(np.int32),
            }
            fm, fn_, fi = _symbol_maps(fresh)
            out[name][0][b, :max_sym + 1] = fm
            out[name][1][b, :max_sym + 1] = fn_
            out[name][2][b, :max_sym + 1] = fi
        area = b"".join(parts)
        if len(area) > TBL_MAX or all(m == 0 for m in ok_modes):
            # roll back to predefined for this lane
            for name, ci, _mc in chans:
                st_def = _tables()[name]
                out[name][0][b] = st_def["maps"]
                out[name][1][b] = st_def["nbs"]
                out[name][2][b] = st_def["init"]
                out[name][3][b] = st_def["tlog"]
            continue
        # channels that stayed predefined emit nothing in the area
        mode[b] = ok_modes
        tbl[b, :len(area)] = np.frombuffer(area, np.uint8)
        tbl_len[b] = len(area)
    mode_byte = (mode[:, 0] << 6) | (mode[:, 1] << 4) | (mode[:, 2] << 2)
    return out, mode_byte.astype(np.int32), tbl, tbl_len


def seq_budget(n: int) -> int:
    """Max sequences the encoder plans for an n-byte block (word-like
    text emits one match per ~6 bytes; the format ceiling is n/4 — /5
    keeps the cap from truncating real parses into literals)."""
    return max(16, n // 5)


def word_budget(s: int) -> int:
    """Bitstream u32 capacity for S sequences: <= 17 state bits + 49
    extra bits per sequence, + 24 flush/end bits."""
    return (66 * s + 24 + 31) // 32 + 2


# ---------------------------------------------------------------------------
# Entry
# ---------------------------------------------------------------------------

def encode_frames_device(blocks: torch.Tensor, n_valid: torch.Tensor,
                         S: int, W: int, hash_log: int = 15,
                         huf_literals: bool = True,
                         timings: dict | None = None):
    """Batched device encode: uint8 [B, N] padded records (and their int
    lengths [B]) on one device -> zstd frame rows uint8 [B, N+16] + lengths
    int32 [B] on that device.

    timings: when a dict is given, each phase's wall seconds are added
    under its key, the device synchronised at the phase's end: "parse"
    (the parse kernel and the counts' copy), "tables" (inside it
    "tables.lit" and "tables.seq", the host builders, and
    "tables.upload", their tables' copies) and "assembly".  Under a
    running torch.profiler the builders are also recorded as
    "encode.tables.lit" and "encode.tables.seq" (``utils.trace``)."""
    t = _tables()
    dev = blocks.device
    B, N = blocks.shape
    with trace.stage("parse", timings, dev):
        parsed, lit_sorted, lit_count, lit_hist, code_hists = _parse_phase(
            blocks, n_valid, S, hash_log)
        # the batch's one host synchronisation: every count, in one copy
        counts = torch.cat([lit_hist, lit_count[:, None],
                            parsed["nseq"][:, None], *code_hists],
                           1).cpu().numpy()

    with trace.stage("tables", timings, dev):
        with trace.stage("tables.lit", timings, plane="encode"):
            if huf_literals:
                ch, nh, dh_, dl, ok = _build_lit_tables(
                    np.ascontiguousarray(counts[:, :256]),
                    counts[:, 256].copy())
            else:
                ch = np.zeros((B, 256), np.uint32)
                nh = np.zeros((B, 256), np.uint32)
                dh_ = np.zeros((B, DESC_MAX), np.uint8)
                dl = np.zeros(B, np.int32)
                ok = np.zeros(B, bool)
        with trace.stage("tables.seq", timings, plane="encode"):
            hists_np = (np.ascontiguousarray(counts[:, 258:294]),
                        np.ascontiguousarray(counts[:, 294:326]),
                        np.ascontiguousarray(counts[:, 326:379]))
            seq_t, mode_byte, tbl, tbl_len = _build_seq_tables(
                hists_np, counts[:, 257].copy(), t)

        def up(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        with trace.stage("tables.upload", timings):
            huf = (up(ch.astype(np.int64)), up(nh.astype(np.int64)),
                   up(dh_), up(dl), up(ok))
            seq = {name: tuple(up(a) for a in seq_t[name])
                   for name in ("ll", "of", "ml")}
            seq.update(mode=up(mode_byte), tbl=up(tbl), tbl_len=up(tbl_len))

    SEGMAX = N // 4 + 1
    WQ = (SEGMAX * 11 + 24) // 32 + 2
    # phase 3: the frame rows (the kernel on a card, its plain version on
    # the CPU)
    with trace.stage("assembly", timings, dev):
        out = assemble.assemble(blocks, n_valid, parsed, lit_sorted,
                                lit_count, huf, seq, W, WQ)
    return out
