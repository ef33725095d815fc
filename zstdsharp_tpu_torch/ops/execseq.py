"""LZ sequence execution: CUDA kernel and plain torch version (counterpart
of zstdsharp_tpu/ops/execseq.py, ZSTD_execSequence:2187 role).

``execute(lit, window, ll, ml, off, n_seq, last_lit, out_len, win_len)``
is the decode plane's entry: CPU tensors run the plain versions
(``make_executor``'s run and ``lane_flags``), CUDA tensors launch
``csrc/lz_exec.cu`` (one block per lane walking its sequences in order;
its source note says what bounds it and how the design answers).  Both
give the same bytes and the same per-lane flags on any operands.

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


def execute(lit, window, ll, ml, off, n_seq, last_lit, out_len, win_len
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Execute each lane's sequences: lit uint8 [B, O] (the literal rows
    are as wide as the output, as the decode plane builds them), window
    uint8 [B, W] (contiguous, or one row broadcast with stride 0),
    ll/ml/off int32 [B, S] (u32 bits), n_seq/last_lit/out_len/win_len
    int64 [B] -> (uint8 [B, O], bytes at or past out_len zero; int32 [B],
    each lane's ``lane_flags``).  CPU tensors run the plain versions; CUDA
    tensors launch the kernel on the current stream.  Any other device,
    dtype, shape or layout raises, and so does an O outside [1, MAX_O] on
    the card."""
    if not isinstance(lit, torch.Tensor):
        raise TypeError(f"lit: expected a torch.Tensor, got {type(lit)}")
    if lit.dim() != 2:
        raise ValueError(f"lit: shape {tuple(lit.shape)}, expected [B, L]")
    dev = lit.device
    B, O = lit.shape
    check_operand("lit", lit, (B, O), dev, torch.uint8)
    ws = _check_window(window, B, dev)
    W = window.shape[1]
    if not isinstance(ll, torch.Tensor) or ll.dim() != 2:
        raise ValueError("ll: expected an int32 tensor [B, S]")
    S = ll.shape[1]
    for name, t in (("ll", ll), ("ml", ml), ("off", off)):
        check_operand(name, t, (B, S), dev, torch.int32)
    for name, t in (("n_seq", n_seq), ("last_lit", last_lit),
                    ("out_len", out_len), ("win_len", win_len)):
        check_operand(name, t, (B,), dev, torch.int64)
    if dev.type == "cpu":
        return (make_executor(B, S, O, W, O)(lit, window, ll, ml, off, n_seq,
                                             last_lit, out_len),
                lane_flags(ll, ml, off, n_seq, last_lit, out_len, win_len))
    check_cuda(dev)
    if not 0 < O <= MAX_O:
        raise ValueError(f"O {O}: the kernel takes 1 to {MAX_O}")
    out = torch.empty((B, O), dtype=torch.uint8, device=dev)
    bad = torch.empty(B, dtype=torch.int32, device=dev)
    if B == 0:
        return out, bad
    # written only by lanes that take the exact path (corrupt operands)
    seg = torch.empty((B, 2, S + 1), dtype=torch.int64, device=dev)
    code = torch.empty((B, O), dtype=torch.int32, device=dev)
    search_rounds, jump_rounds = _rounds(S, O)
    launch("lz_exec", dev, _build.load().zt_lz_exec, lit.data_ptr(), O,
           window.data_ptr(), W, ws, ll.data_ptr(), ml.data_ptr(),
           off.data_ptr(), S, n_seq.data_ptr(), last_lit.data_ptr(),
           out_len.data_ptr(), win_len.data_ptr(), out.data_ptr(), O,
           bad.data_ptr(), seg.data_ptr(), code.data_ptr(), search_rounds,
           jump_rounds, B)
    execute.launches += 1
    return out, bad


execute.launches = 0
