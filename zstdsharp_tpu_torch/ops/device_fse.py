"""Batched zstd sequence-section decode (three FSE states plus the repcode
history): CUDA kernel and plain torch version (counterpart of
zstdsharp_tpu/ops/device_fse.py).

Operands are the native planner's lane-major rows (see
``decode.device_pipeline._NativeOps.fse_ops``), one block per lane:

    words  [NL, Wb]  int32   sequence bitstream as little-endian u32 words
    ll     [NL, 512] int32   LL table, entries sym | ns << 8 | nb << 20
    of     [NL, 256] int32   OF table
    ml     [NL, 512] int32   ML table
    st     [NL, 8]   int32   pos, r0, r1, r2, s_ll, s_of, s_ml, unused: the
                             state after the three-state preamble
    nseq   [NL]      int32   sequences to decode

The kernel (``csrc/fse_decode.cu``) replaces the Pallas kernel
``zstdsharp_tpu/ops/device_fse.py:_decode_fn``; its source note says what
bounds it on the H100 and how the design answers.  Output is three
``[NL, T]`` int32 arrays (literal lengths, match lengths, offsets), T =
``bucket_t(t_max)``; row l holds block l's first nseq[l] sequences, then
zeros.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build
from ._launch import check_cuda, check_operand, launch

# Copied from zstdsharp_tpu/ops/device_fse.py (importing it would import
# JAX through zstdsharp_tpu/ops/__init__.py), but for the word window: the
# reference's ends at REF_MAX_W words (8 KiB), this one at MAX_W (32 KiB),
# so a 128 KiB block's sequence bitstream fits and decodes on the card
# (csrc/fse_decode.cu takes any width; at 8,192 words up to 5 lanes
# share a block).  The buckets up to REF_MAX_W are the reference's.
LANES = 1024
NSTATES = 512          # LL/ML table size (tableLog 9)
NSTATES_OF = 256       # OF table size (tableLog 8)
REF_MAX_W = 2048
MAX_W = 8192
_W_BUCKETS = (64, 256, 512, 768, 1024, 1536, 2048, 3072, 4096, 6144, 8192)
_T_BUCKETS = (256, 1024, 4096, 16384, 32768)

LL_BASE = np.array(
    [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 18, 20, 22,
     24, 28, 32, 40, 48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384,
     32768, 65536], np.int64)
LL_BITS = np.array(
    [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3,
     4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16], np.int64)
ML_BASE = np.array(
    [3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22,
     23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 37, 39, 41, 43, 47,
     51, 59, 67, 83, 99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771,
     65539], np.int64)
ML_BITS = np.array(
    [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
     0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10,
     11, 12, 13, 14, 15, 16], np.int64)


def bucket_w(w: int) -> int:
    return next(b for b in _W_BUCKETS if b >= max(w, 2))


def bucket_t(t: int) -> int:
    return next(b for b in _T_BUCKETS if b >= max(t, 1))


def pack_table(dt) -> np.ndarray:
    """Pack an FseDTable (symbol/new_state/nb_bits indexed by state) into
    sym | ns << 8 | nb << 20 entries; `sym` is the code (llCode, ofCode,
    mlCode).  Returns int64 [NSTATES]."""
    size = 1 << dt.table_log
    out = np.zeros(NSTATES, np.int64)
    sym = dt.symbol.astype(np.int64)
    ns = dt.new_state.astype(np.int64)
    sb = dt.nb_bits.astype(np.int64)
    out[:size] = sym | (ns << 8) | (sb << 20)
    return out


_OPERANDS = ("words", "ll", "of", "ml", "st", "nseq")


def decode_plain(words, ll, of, ml, st, nseq, t_len: int):
    """Plain torch version of the kernel: vectorised over lanes, one Python
    step per sequence, in int64 (stream words are u32).  Returns
    (ll, ml, of) [NL, T] int32 on the operands' device."""
    dev = words.device
    nl, wb = words.shape
    i64 = torch.int64
    w64 = words.to(i64) & 0xFFFFFFFF
    lane = torch.arange(nl, device=dev)
    ll_t, of_t, ml_t = ll.to(i64), of.to(i64), ml.to(i64)
    s = st.to(i64)
    pos = s[:, 0]
    r0, r1, r2 = s[:, 1], s[:, 2], s[:, 3]
    s_ll, s_of, s_ml = s[:, 4], s[:, 5], s[:, 6]
    llb, llx = (torch.from_numpy(a).to(dev) for a in (LL_BASE, LL_BITS))
    mlb, mlx = (torch.from_numpy(a).to(dev) for a in (ML_BASE, ML_BITS))
    n = nseq.to(i64).clamp(0, t_len)
    outs = [torch.zeros(nl, t_len, dtype=torch.int32, device=dev)
            for _ in range(3)]
    steps = int(n.max()) if nl else 0

    def word(k):
        return torch.where((k >= 0) & (k < wb),
                           w64[lane, k.clamp(0, wb - 1)], 0)

    def read(nb):
        nonlocal pos
        p0 = pos - nb
        k = p0 >> 5
        sh = p0 & 31
        w0, w1 = word(k), word(k + 1)
        v = torch.where(sh == 0, w0,
                        (w0 >> sh) | ((w1 << (32 - sh)) & 0xFFFFFFFF))
        pos = p0
        return v & ((1 << nb) - 1)

    for t in range(steps):
        e_ll = ll_t[lane, s_ll.clamp(0, NSTATES - 1)]
        e_of = of_t[lane, s_of.clamp(0, NSTATES_OF - 1)]
        e_ml = ml_t[lane, s_ml.clamp(0, NSTATES - 1)]
        llc = (e_ll & 255).clamp(max=35)
        ofc = (e_of & 255).clamp(max=31)
        mlc = (e_ml & 255).clamp(max=52)
        ll_base, ll_bits = llb[llc], llx[llc]
        ml_base, ml_bits = mlb[mlc], mlx[mlc]
        of_base = torch.where(ofc > 1, (1 << ofc) - 3, ofc)
        ofv = read(ofc)
        big = ofc > 1
        ll0 = (ll_base == 0).to(i64)
        idx = 1 + ll0 + ofv                      # meaningful when ofc == 1
        case_a = ~big & (ofc == 0) & (ll0 == 0)
        swap = ~big & (((ofc == 0) & (ll0 == 1)) | ((ofc == 1) & (idx == 1)))
        rot = ~big & (ofc == 1) & (idx == 2)
        dec = ~big & (ofc == 1) & (idx == 3)
        r0n = torch.where(big, of_base + ofv, torch.where(
            dec, (r0 - 1).clamp(min=1), torch.where(
                rot, r2, torch.where(swap, r1, r0))))
        r1n = torch.where(case_a, r1, r0)
        r2n = torch.where(case_a | swap, r2, r1)
        r0, r1, r2 = r0n, r1n, r2n
        mle = read(ml_bits)
        lle = read(ll_bits)
        live = t < n
        for o, v in zip(outs, (ll_base + lle, ml_base + mle, r0)):
            # int64 -> int32 keeps the low 32 bits, as the kernel does
            o[:, t] = torch.where(live, v, 0).to(torch.int32)
        s_ll = ((e_ll >> 8) & 4095) + read((e_ll >> 20) & 31)
        s_ml = ((e_ml >> 8) & 4095) + read((e_ml >> 20) & 31)
        s_of = ((e_of >> 8) & 4095) + read((e_of >> 20) & 31)
    return tuple(outs)


def decode_lanemajor(ops: dict):
    """Decode lane-major operands (module docstring) into (ll, ml, of)
    [NL, T] int32 rows.  CPU tensors run ``decode_plain``; CUDA tensors
    launch the CUDA kernel on the current stream.  Any other device, dtype,
    shape or layout raises."""
    words = ops["words"]
    if not isinstance(words, torch.Tensor):
        raise TypeError("words: expected a torch.Tensor")
    dev = words.device
    nl, wb = words.shape
    shapes = {"words": (nl, None), "ll": (nl, NSTATES),
              "of": (nl, NSTATES_OF), "ml": (nl, NSTATES), "st": (nl, 8),
              "nseq": (nl,)}
    for k in _OPERANDS:
        check_operand(k, ops[k], shapes[k], dev)
    t_len = bucket_t(int(ops["t_max"]))
    args = [ops[k] for k in _OPERANDS]
    if dev.type == "cpu":
        return decode_plain(*args, t_len)
    check_cuda(dev)
    # the kernel stages rows with 16-byte copies: operands start aligned
    args = [a if a.data_ptr() % 16 == 0 else a.clone() for a in args]
    outs = [torch.empty((nl, t_len), dtype=torch.int32, device=dev)
            for _ in range(3)]
    a = [x.data_ptr() for x in args]
    launch("fse_decode", dev, _build.load().zt_fse_decode, a[0], wb, *a[1:],
           *(o.data_ptr() for o in outs), nl, t_len)
    decode_lanemajor.launches += 1
    return tuple(outs)


decode_lanemajor.launches = 0


def _initial_states(words, pos, logs, rep) -> np.ndarray:
    """Host read of the three initial FSE states, as
    zstdsharp_tpu/ops/device_fse.py:initial_states computes it.  words
    [W, LANES] u32 as int64, pos [LANES], logs [3, LANES] (ll, of, ml),
    rep [3, LANES].  Returns [LANES, 8] int32 (pos, r0, r1, r2, s_ll, s_of,
    s_ml, 0)."""
    w = words.shape[0]
    lane = np.arange(words.shape[1])
    pos = pos.astype(np.int64).copy()

    def read(nb):
        nonlocal pos
        p0 = pos - nb
        k = p0 >> 5
        sh = p0 & 31
        w0 = np.where((k >= 0) & (k < w), words[np.clip(k, 0, w - 1), lane], 0)
        w1 = np.where((k + 1 >= 0) & (k + 1 < w),
                      words[np.clip(k + 1, 0, w - 1), lane], 0)
        v = np.where(sh == 0, w0,
                     (w0 >> sh) | ((w1 << (32 - sh)) & 0xFFFFFFFF))
        pos = p0
        return v & ((np.int64(1) << nb) - 1)

    st_ll, st_of, st_ml = (read(logs[i].astype(np.int64)) for i in range(3))
    zero = np.zeros_like(pos)
    st = np.stack([pos, rep[0], rep[1], rep[2], st_ll, st_of, st_ml, zero])
    return np.ascontiguousarray(st.T.astype(np.int32))


def ops_from_batch(batch, device) -> dict:
    """The port's lane-major operands from a reference ``FseSeqBatch``
    (zstdsharp_tpu/ops/device_fse.py prepare_batch, kernel layout
    [K, SUB, LN]), as int32 tensors on `device`; `st` is the state after
    the three-state preamble, read on the host."""
    lanes = batch.pos.size
    w = batch.words.shape[0]
    words = batch.words.reshape(w, lanes).astype(np.uint32).astype(np.int64)
    logs = np.stack([np.asarray(a).reshape(lanes)
                     for a in (batch.ll_log, batch.of_log, batch.ml_log)])
    st = _initial_states(words, np.asarray(batch.pos).reshape(lanes), logs,
                         np.asarray(batch.rep).reshape(3, lanes).astype(np.int64))

    def lm(a, k):
        a = np.asarray(a).reshape(k, lanes).T
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)

    return dict(
        words=lm(batch.words, w), ll=lm(batch.ll_tab, NSTATES),
        of=lm(batch.of_tab, NSTATES_OF), ml=lm(batch.ml_tab, NSTATES),
        st=torch.from_numpy(st).to(device),
        nseq=lm(batch.n_seq, 1)[:, 0].contiguous(), t_max=int(batch.t_max))
