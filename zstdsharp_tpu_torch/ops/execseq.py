"""LZ sequence execution: CUDA kernel and plain torch version (counterpart
of zstdsharp_tpu/ops/execseq.py, ZSTD_execSequence:2187 role, and of the
reference decode plane's _fused_decode, its literal assembly included).

``execute_lanes(meta, src, S, O, window, ...)`` is the one entry: every
lane of a batch straight from the decode plane's sources (the literal
pool, the Huffman kernel's int32 rows, the FSE kernel's and the host's
sequence rows) through its int64 meta row, its window and its output
optionally at a start within a row (a multi-block round reads and writes
its frame accumulator in place).  CUDA tensors launch
``csrc/lz_exec.cu``'s ``zt_lz_decode`` once for all lanes (one block per
lane walking its sequences in order; its source note says what bounds it
and how the design answers); CPU tensors run its plain version,
``lanes_plain``: ``assemble`` (the torch literal assembly) gives each
lane's operands, and ``execute_plain`` (``make_executor``'s run and
``lane_flags``) executes them.  Both give the same bytes and the same
per-lane flags on any meta and sources.

The flags are libzstd's checks on a block's sequences (ZSTD_execSequence,
ZSTD_decompressSequences), computed on the operands: bit 0, the literal
lengths overrun the literal section (``last_lit < 0``); bit 1, the lane's
output is not ``out_len`` bytes long (sum of ll and ml as u32, plus
``last_lit``); bit 2, a match reaches before the bytes it may read (its
offset as u32 is 0, which libzstd turns into -1, or exceeds the bytes the
lane has produced before it plus ``win_len``, the real bytes in front of
the lane's first output byte).  A valid block sets none.

The plain version is plain torch, as the reference is plain XLA: the same
three stages run on whatever device the operands are on.
1. Segment layout: exclusive prefix sums over (ll, ml) give every literal
   run's and match run's output start; each output byte's segment comes from
   the reference's vectorised binary search.
2. Sources: a literal byte maps to its literal index, a match byte to an
   earlier output position or a window byte.  Self-overlapping matches are
   collapsed analytically onto [start - off, start), so no chain walks
   within a segment.
3. Pointer jumping until no source is unresolved (each round syncs with
   the host through ``.any()``), then one gather from literals || window.

Integer semantics follow the reference under JAX's x64 mode: lengths and
offsets are taken as u32 and reinterpreted as int32, an offset reaching
past the window reads the literal region, and a jump to a
position at or past O resolves to the last pool byte (the reference's
out-of-bounds gather fill).  A pool index below 0 (an offset reaching past
the literal region too, or a negative literal index) encodes as a source
>= 0, i.e. output position -index - 1, as in the reference.  Unlike the
reference's unbounded while loop, jumping stops after ceil(log2 O) + 2
rounds: an acyclic chain resolves by then, and a cycle (possible only with
corrupt operands) reads pool byte 0 instead of hanging.  The prefix sums
run in int64, where the reference's stay int32 (``jnp.cumsum`` keeps
int32) and wrap once a lane's sums pass 2^31, which only corrupt operands
reach: there the two differ, and this version is the kernel's definition.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from .. import _build
from ._launch import check_cuda, check_operand, launch

# stands in for the reference's gather fill value (INT64_MIN): any value
# this negative clips to the last pool index in the final gather
_OOB = -(1 << 62)


def _as_i32(a: torch.Tensor) -> torch.Tensor:
    """u32 -> int32 reinterpretation, widened to int64 for arithmetic."""
    return a.to(torch.int64).to(torch.int32).to(torch.int64)


# the kernel's output row lives in shared memory: 227 KB, the most a block
# may opt into, less 8 KB for its static part (csrc/lz_exec.cu kSmemMax)
MAX_O = 232448 - 8192
# shared memory an H100 SM holds, and what each resident block takes
# besides its dynamic part: the 1 KB the CUDA runtime reserves a block and
# the static allowance
_SM_SMEM, _BLOCK_SMEM = 233472, 1024 + 8192


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _stage_bytes(N: int, S: int, O: int, n_sm: int) -> int:
    """Shared memory a block of the lane decode gets past its O-byte row
    for staging its lane's sequence rows (12 bytes a live sequence) and
    literals (at most O): as much as they can need, but no more than lets
    ceil(N / n_sm) blocks (at most 8) share an SM, so a batch that fits
    one wave still does; a multiple of 16."""
    o16 = (O + 15) & ~15
    per_sm = min(max(-(-N // max(n_sm, 1)), 1), 8)
    room = _SM_SMEM // per_sm - _BLOCK_SMEM - o16
    return max(min(room, o16 + 12 * S, MAX_O - o16), 0) & ~15


def _rounds(S: int, O: int) -> tuple[int, int]:
    """(binary-search rounds, pointer-jumping rounds) of the shape."""
    return (int(np.ceil(np.log2(S + 2))) + 1,
            int(np.ceil(np.log2(max(O, 2)))) + 2)


def make_executor(B: int, S: int, L: int, W: int, O: int):
    """Executor for one shape: returns run(lit [B, L] u8, window [B, W] u8,
    ll/ml/off [B, S], n_seq/last_lit/out_len [B]) -> uint8 [B, O] outputs
    (bytes beyond out_len[b] are zero)."""
    search_rounds, jump_rounds = _rounds(S, O)

    def run(lit, window, ll, ml, off, n_seq, last_lit, out_len):
        for name, t, shape in (("lit", lit, (B, L)), ("window", window, (B, W)),
                               ("ll", ll, (B, S)), ("ml", ml, (B, S)),
                               ("off", off, (B, S)), ("n_seq", n_seq, (B,)),
                               ("last_lit", last_lit, (B,)),
                               ("out_len", out_len, (B,))):
            if tuple(t.shape) != shape:
                raise ValueError(f"{name}: shape {tuple(t.shape)}, "
                                 f"expected {shape}")
        dev = lit.device
        i64 = torch.int64
        n_seq = n_seq.to(i64)
        out_len = out_len.to(i64)
        seq_idx = torch.arange(S + 1, device=dev)[None, :]
        live = seq_idx < n_seq[:, None]                     # [B, S+1]
        tail = seq_idx == n_seq[:, None]

        def ext(a, fill):
            a = torch.nn.functional.pad(_as_i32(a), (0, 1))
            return torch.where(live, a, fill)

        # one trailing pseudo-sequence carries the last literals
        ll_e = torch.where(tail, _as_i32(last_lit)[:, None], ext(ll, 0))
        ml_e = ext(ml, 0)
        off_e = ext(off, 1).clamp(min=1)

        size = ll_e + ml_e
        run_start = torch.cumsum(size, dim=1) - size        # exclusive
        match_start = run_start + ll_e
        lit_before = torch.cumsum(ll_e, dim=1) - ll_e

        # segment id per output byte: binary search for the last
        # run_start <= pos, exactly as the reference's `search` lowering
        pos = torch.arange(O, device=dev)[None, :]
        dead_start = torch.where(live | tail, run_start, 1 << 30)
        lo = torch.zeros(B, O, dtype=i64, device=dev)
        hi = torch.full((B, O), S, dtype=i64, device=dev)
        for _ in range(search_rounds):
            mid = (lo + hi + 1) >> 1
            right = torch.gather(dead_start, 1, mid) <= pos
            lo = torch.where(right, mid, lo)
            hi = torch.where(right, hi, mid - 1)
        seg = lo.clamp(0, S)

        def g(a):
            return torch.gather(a, 1, seg)

        s_run, s_match = g(run_start), g(match_start)
        s_lit0, s_off = g(lit_before), g(off_e)

        in_lit = pos < s_match
        lit_ref = -(1 + s_lit0 + (pos - s_run))            # literal index
        j = pos - s_off
        j = torch.where(j >= s_match,
                        s_match - s_off + torch.remainder(pos - s_match, s_off),
                        j)
        win_ref = -(1 + L + (W + j))                       # j < 0: window
        src = torch.where(in_lit, lit_ref, torch.where(j >= 0, j, win_ref))
        src = torch.where(pos < out_len[:, None], src, lit_ref)

        for _ in range(jump_rounds):
            unresolved = src >= 0
            if not bool(unresolved.any()):
                break
            tgt = torch.gather(src, 1, src.clamp(0, O - 1))
            tgt = torch.where(src < O, tgt, _OOB)
            src = torch.where(unresolved, tgt, src)

        pool = torch.cat([lit, window], dim=1)              # [B, L+W]
        idx = (-src - 1).clamp(0, L + W - 1)
        out = torch.gather(pool, 1, idx)
        return torch.where(pos < out_len[:, None], out, 0).to(torch.uint8)

    return run


def lane_flags(ll, ml, off, n_seq, last_lit, out_len, win_len
               ) -> torch.Tensor:
    """The plain version of the kernel's per-lane flags: int32 [B], bit 0
    ``last_lit < 0``, bit 1 ``sum(ll) + sum(ml) + last_lit != out_len``,
    bit 2 some live offset is 0 or exceeds its match's output position
    plus ``win_len``.  ll/ml/off are read as u32, the live sequences are
    the first ``clamp(n_seq, 0, S)``, and every sum is int64 (wrapping,
    as the kernel's)."""
    S = ll.shape[1]
    dev = ll.device
    i64 = torch.int64

    def u32(a):
        return a.to(i64) & 0xFFFFFFFF

    live = (torch.arange(S, device=dev)[None, :]
            < n_seq.to(i64).clamp(0, S)[:, None])
    llu = torch.where(live, u32(ll), 0)
    mlu = torch.where(live, u32(ml), 0)
    size = llu + mlu
    match_start = torch.cumsum(size, dim=1) - size + llu
    offu = u32(off)
    reach = (offu == 0) | (offu > match_start + win_len.to(i64)[:, None])
    total = size.sum(dim=1) + last_lit.to(i64)
    bad = ((last_lit < 0).to(torch.int32)
           | ((total != out_len.to(i64)).to(torch.int32) << 1)
           | ((live & reach).any(dim=1).to(torch.int32) << 2))
    return bad


def execute_plain(lit, window, ll, ml, off, n_seq, last_lit, out_len,
                  win_len) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain executor on assembled operands, on their device: lit uint8
    [B, O] (the literal rows are as wide as the output, as ``assemble``
    builds them), window uint8 [B, W], ll/ml/off [B, S] (u32 bits),
    n_seq/last_lit/out_len/win_len [B] -> (uint8 [B, O], bytes at or past
    out_len zero, by ``make_executor``'s run; int32 [B], ``lane_flags``)."""
    B, O = lit.shape
    return (make_executor(B, ll.shape[1], O, window.shape[1], O)(
                lit, window, ll, ml, off, n_seq, last_lit, out_len),
            lane_flags(ll, ml, off, n_seq, last_lit, out_len, win_len))


def _check_window(window, B: int, dev: torch.device) -> int:
    """Raise unless window is uint8 [B, W] on dev whose rows are contiguous
    and either W bytes apart or one row broadcast to all (stride 0, as
    ``_window_rows`` builds it).  Returns the row stride the kernel takes."""
    if not isinstance(window, torch.Tensor):
        raise TypeError(f"window: expected a torch.Tensor, got {type(window)}")
    if window.dtype != torch.uint8:
        raise TypeError(f"window: expected torch.uint8, got {window.dtype}")
    if window.device != dev:
        raise ValueError(f"window: on {window.device}, expected {dev}")
    if window.dim() != 2 or window.shape[0] != B:
        raise ValueError(f"window: shape {tuple(window.shape)}, expected "
                         f"({B}, W)")
    W = window.shape[1]
    if W > 1 and window.stride(1) != 1:
        raise ValueError("window: rows must be contiguous")
    ws = window.stride(0) if B > 1 else 0
    if ws not in (0, W):
        raise ValueError(f"window: row stride {ws}, expected 0 or {W}")
    return ws


# ---------------------------------------------------------------------------
# the decode plane's entry: every lane from its meta row and the sources

META_COLS = 12  # lit_kind, pool_base, pool_len, huf_lane0, huf_seg, seq_kind,
#                 fse_lane, host_row, n_seq, lit_regen, out_len, win_len


class LaneSources(NamedTuple):
    """What a lane's meta row points into: the literal pool (uint8 [n_raw];
    the decode plane appends one zero byte), the Huffman kernel's rows
    flattened (int32 [n_huf], huf_T a row; a lane's 4 streams are 4
    consecutive rows) or None, and the sequence rows of the FSE kernel and
    of the host (each 3 int32 [rows, T]: ll, ml, off) or None."""

    raw: torch.Tensor
    huf: torch.Tensor | None = None
    huf_T: int = 0
    fse: tuple | None = None
    host: tuple | None = None


def _dyn_slice(flat: torch.Tensor, starts: torch.Tensor, size: int):
    """Rows flat[start : start+size] per start, with each start clamped so
    the slice fits (jax.lax.dynamic_slice semantics)."""
    st = starts.clamp(0, flat.numel() - size)
    return flat[st[:, None] + torch.arange(size, device=flat.device)]


def assemble(meta, src: LaneSources, S: int, O: int) -> tuple:
    """The torch literal assembly (reference _fused_decode with its L = O:
    the literal rows are as wide as the output): meta int64 [B, 12] ->
    ``execute_plain``'s operands but the window: (lit uint8 [B, O],
    ll/ml/off int32 [B, S], n_seq, last_lit, out_len, win_len int64
    [B])."""
    dev = meta.device
    B, L = meta.shape[0], O
    lit_kind, pool_base, pool_len, lane0 = meta[:, 0], meta[:, 1], \
        meta[:, 2], meta[:, 3]
    seg = meta[:, 4].clamp(min=1)
    seq_kind = meta[:, 5]
    fse_lane = meta[:, 6].clamp(min=0)
    host_row = meta[:, 7].clamp(min=0)
    n_seq, lit_regen = meta[:, 8], meta[:, 9]

    i = torch.arange(L, device=dev)[None, :]
    # raw-pool span per lane; an RLE span (pool_len 1) repeats its byte
    raw_pad = torch.nn.functional.pad(src.raw, (0, L + 8))
    lit = _dyn_slice(raw_pad, pool_base, L)
    lit = torch.where(pool_len[:, None] == 1, lit[:, :1], lit)
    if src.huf is not None:
        # a lane's 4 streams are 4 consecutive T-rows of the flat kernel
        # output; stitch the quarters at their real lengths
        T = src.huf_T
        huf_pad = torch.nn.functional.pad(src.huf, (0, 4 * T + 8))
        quads = _dyn_slice(huf_pad, lane0.clamp(min=0) * T, 4 * T)
        s = (i // seg[:, None]).clamp(max=3)
        qi = (s * T + (i - s * seg[:, None])).clamp(0, 4 * T - 1)
        lit_huf = torch.gather(quads, 1, qi).to(torch.uint8)
        lit = torch.where(lit_kind[:, None] == 1, lit_huf, lit)

    def rows_from(rows, idx):
        r = rows[idx.clamp(max=rows.shape[0] - 1)]
        T = rows.shape[1]
        if T < S:
            r = torch.nn.functional.pad(r, (0, S - T))
        return r[:, :S]

    zero = torch.zeros(B, S, dtype=torch.int32, device=dev)
    ll, ml, off = zero, zero, torch.ones_like(zero)
    for kind, rows, idx in ((1, src.fse, fse_lane), (2, src.host, host_row)):
        if rows is None:
            continue
        m = (seq_kind == kind)[:, None]
        ll = torch.where(m, rows_from(rows[0], idx), ll)
        ml = torch.where(m, rows_from(rows[1], idx), ml)
        off = torch.where(m, rows_from(rows[2], idx), off)

    live = torch.arange(S, device=dev)[None, :] < n_seq[:, None]
    sum_ll = torch.where(live, ll.to(torch.int64), 0).sum(dim=1)
    last_lit = lit_regen - sum_ll
    return (lit, ll, ml, off, n_seq.contiguous(), last_lit,
            meta[:, 10].contiguous(), meta[:, 11].contiguous())


def lane_windows(window, win_start, W: int) -> torch.Tensor:
    """Each lane's W-byte window: the bytes at ``clamp(win_start[k], 0, A -
    W)`` of row k of window [N, A] (win_start None: 0); the rows as they
    are, a broadcast row included, when that is all of them."""
    A = window.shape[1]
    if win_start is None:
        if W == A:
            return window
        win_start = torch.zeros(window.shape[0], dtype=torch.int64,
                                device=window.device)
    return torch.gather(window, 1, win_start.clamp(0, A - W)[:, None]
                        + torch.arange(W, device=window.device))


def lanes_plain(meta, src: LaneSources, S: int, O: int, window,
                win_start=None, W: int | None = None, out=None,
                out_start=None, chunk: int = 64):
    """``execute_lanes``' plain version on the operands' device, `chunk`
    lanes at a time (lanes are independent; this bounds the plain
    executor's [chunk, O] int64 temporaries): ``assemble``, each lane's
    window (``lane_windows``), ``execute_plain`` and the rows scattered
    into `out` at their clamped starts, or returned as [N, O]."""
    dev = meta.device
    N = meta.shape[0]
    W = window.shape[1] if W is None else W
    rows, flags = [], []
    for c0 in range(0, N, chunk):
        sl = slice(c0, c0 + chunk)
        lit, *ops = assemble(meta[sl], src, S, O)
        win = lane_windows(window[sl], None if win_start is None
                           else win_start[sl], W)
        r, bad = execute_plain(lit, win, *ops)
        flags.append(bad)
        if out is None:
            rows.append(r)
            continue
        st = (out_start[sl] if out_start is not None else
              torch.zeros(r.shape[0], dtype=torch.int64, device=dev))
        out[sl].scatter_(1, st.clamp(0, out.shape[1] - O)[:, None]
                         + torch.arange(O, device=dev), r)
    if out is None:
        out = (torch.cat(rows) if rows else
               torch.zeros((0, O), dtype=torch.uint8, device=dev))
    bad = (torch.cat(flags) if flags else
           torch.zeros(0, dtype=torch.int32, device=dev))
    return out, bad


def _check_sources(src: LaneSources, dev: torch.device) -> None:
    if not isinstance(src.raw, torch.Tensor) or src.raw.dim() != 1:
        raise ValueError("src.raw: expected a uint8 tensor [n_raw]")
    check_operand("src.raw", src.raw, (src.raw.shape[0],), dev, torch.uint8)
    if src.huf is not None:
        check_operand("src.huf", src.huf, (None,), dev)
        if src.huf_T < 1:
            raise ValueError(f"src.huf_T {src.huf_T}: expected >= 1")
    for name, rows in (("src.fse", src.fse), ("src.host", src.host)):
        if rows is None:
            continue
        if len(rows) != 3:
            raise ValueError(f"{name}: expected (ll, ml, off)")
        shape = tuple(rows[0].shape) if isinstance(
            rows[0], torch.Tensor) and rows[0].dim() == 2 else (None, None)
        if shape[0] is None or shape[0] < 1:
            raise ValueError(f"{name}: expected int32 [rows >= 1, T]")
        for k, t in zip("ll ml off".split(), rows):
            check_operand(f"{name}.{k}", t, shape, dev)


def execute_lanes(meta, src: LaneSources, S: int, O: int, window,
                  win_start=None, W: int | None = None, out=None,
                  out_start=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Decode every lane of a batch: meta int64 [N, 12] (the decode plane's
    meta rows), `src` its sources, S the sequence rows' width, O the output
    (and literal) width.  window uint8 [N, A] (contiguous rows, or one row
    broadcast with stride 0): lane k's window is the W bytes (default A)
    at ``clamp(win_start[k], 0, A - W)`` of its row (win_start int64 [N];
    None: 0).  out: None for a new uint8 [N, O], or uint8 [N, A_o] whose
    row k takes lane k's O bytes at ``clamp(out_start[k], 0, A_o - O)``
    (out_start int64 [N]; None: 0) in place, bytes at or past out_len
    zero; it may be the window tensor itself when each lane owns its row.
    Returns (out, int32 [N] flags, ``lane_flags`` of the assembled
    operands).  CPU tensors run ``lanes_plain``; CUDA tensors launch the
    kernel once on the current stream.  Any other device, dtype, shape or
    layout raises, and so does an O outside [1, MAX_O] on the card."""
    if not isinstance(meta, torch.Tensor) or meta.dim() != 2:
        raise ValueError(f"meta: expected an int64 tensor [N, {META_COLS}]")
    dev = meta.device
    N = meta.shape[0]
    check_operand("meta", meta, (N, META_COLS), dev, torch.int64)
    _check_sources(src, dev)
    ws = _check_window(window, N, dev)
    A = window.shape[1]
    W = A if W is None else int(W)
    if not 0 <= W <= A:
        raise ValueError(f"W {W}: expected 0 to the window's {A}")
    for name, t in (("win_start", win_start), ("out_start", out_start)):
        if t is not None:
            check_operand(name, t, (N,), dev, torch.int64)
    if out is not None:
        check_operand("out", out, (N, None), dev, torch.uint8)
        if out.shape[1] < O:
            raise ValueError(f"out: rows of {out.shape[1]} bytes, "
                             f"expected at least O = {O}")
    elif out_start is not None:
        raise ValueError("out_start without out")
    if dev.type == "cpu":
        return lanes_plain(meta, src, S, O, window, win_start, W, out,
                           out_start)
    check_cuda(dev)
    if not 0 < O <= MAX_O:
        raise ValueError(f"O {O}: the kernel takes 1 to {MAX_O}")
    if out is None:
        out = torch.empty((N, O), dtype=torch.uint8, device=dev)
    bad = torch.empty(N, dtype=torch.int32, device=dev)
    if N == 0:
        return out, bad
    # written only by lanes that take the exact path (corrupt operands)
    seg = torch.empty((N, 2, S + 1), dtype=torch.int64, device=dev)
    code = torch.empty((N, O), dtype=torch.int32, device=dev)
    search_rounds, jump_rounds = _rounds(S, O)

    def ptr(t):
        return None if t is None else t.data_ptr()

    fse = src.fse or (None, None, None)
    host = src.host or (None, None, None)
    launch("lz_exec", dev, _build.load().zt_lz_decode, meta.data_ptr(), N,
           src.raw.data_ptr(), src.raw.numel(), ptr(src.huf),
           0 if src.huf is None else src.huf.numel(), src.huf_T,
           *map(ptr, fse), 0 if src.fse is None else fse[0].shape[0],
           0 if src.fse is None else fse[0].shape[1], *map(ptr, host),
           0 if src.host is None else host[0].shape[0],
           0 if src.host is None else host[0].shape[1],
           window.data_ptr(), W, ws, A, ptr(win_start), out.data_ptr(), O,
           out.shape[1], out.shape[1], ptr(out_start), S,
           _stage_bytes(N, S, O, _sm_count(dev.index)), bad.data_ptr(),
           seg.data_ptr(), code.data_ptr(), search_rounds, jump_rounds)
    execute_lanes.launches += 1
    return out, bad


execute_lanes.launches = 0
