"""Batched zstd Huffman X1 literal decode: CUDA kernel and plain torch
version (counterpart of zstdsharp_tpu/ops/device_huf.py).

Operands are the native planner's lane-major rows (see
``decode.device_pipeline._NativeOps.huf_ops``), one stream per lane:

    words   [NL, Wb] int32   stream bytes as little-endian u32 words
    limits  [NL, 16] int32   11-bit class thresholds
    bases   [NL, 16] int32   rank base per class
    offs    [NL, 16] int32   11-bit value offset per class
    shifts  [NL, 16] int32   rank shift per class
    planes  [NL, 64] int32   rank->symbol permutation as 8 bit-planes x 8 words
    pos     [NL]     int32   initial bit position
    nsym    [NL]     int32   symbols to decode

The kernel (``csrc/huf_decode.cu``) replaces the Pallas kernel
``zstdsharp_tpu/ops/device_huf.py:_decode_fn``; its source note says what
bounds it on the H100 and how the design answers.  Output is
``[NL, T]`` int32, T = ``bucket_t(t_max)``; row l holds stream l's first
nsym[l] symbols, then zeros.

Stream bit semantics follow the reference exactly: bit i of a stream is bit
(i & 7) of byte (i >> 3); a peek reads bits [pos - 11, pos), zeros below bit
0 and past the row.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build
from ._launch import check_cuda, check_operand, launch

# Copied from zstdsharp_tpu/ops/device_huf.py (importing it would import
# JAX through zstdsharp_tpu/ops/__init__.py).
LN = 128
LANES = 1024
MAXLOG = 11
MAX_W = 2048
_W_BUCKETS = (64, 256, 512, 768, 1024, 1536, 2048)
_T_BUCKETS = (256, 1024, 4096, 8192, 16384, 32768)


def round_lanes(n: int) -> int:
    """Smallest 128*2^k >= n (kernel lane widths), capped at LANES."""
    nl = LN
    while nl < n and nl < LANES:
        nl *= 2
    return nl


def bucket_w(w: int) -> int:
    return next(b for b in _W_BUCKETS if b >= max(w, 2))


def bucket_t(t: int) -> int:
    return next(b for b in _T_BUCKETS if b >= max(t, 1))


_OPERANDS = ("words", "limits", "bases", "offs", "shifts", "planes", "pos",
             "nsym")


def _perm_from_planes(planes: torch.Tensor) -> torch.Tensor:
    """[NL, 64] bit-planes -> [NL, 256] int64 rank->symbol table."""
    nl = planes.shape[0]
    rk = torch.arange(256, device=planes.device)
    words = (planes.to(torch.int64) & 0xFFFFFFFF).view(nl, 8, 8)[:, :, rk >> 5]
    bits = (words >> (rk & 31)) & 1                       # [NL, 8, 256]
    weight = (1 << torch.arange(8, device=planes.device))[None, :, None]
    return (bits * weight).sum(dim=1)


def decode_plain(words, limits, bases, offs, shifts, planes, pos, nsym,
                 t_len: int) -> torch.Tensor:
    """Plain torch version of the kernel: vectorised over lanes, one Python
    step per symbol.  Works in int64 (torch's int32 `>>` is arithmetic and
    the stream words are u32), on whatever device the operands are on."""
    dev = words.device
    nl, wb = words.shape
    w64 = words.to(torch.int64) & 0xFFFFFFFF
    lim = limits.to(torch.int64)
    zero = torch.zeros(nl, 1, dtype=torch.int64, device=dev)
    # class 16 (a peek at or above every limit) selects zeros
    bas = torch.cat([bases.to(torch.int64), zero], dim=1)
    off = torch.cat([offs.to(torch.int64), zero], dim=1)
    shf = torch.cat([shifts.to(torch.int64), zero], dim=1)
    perm = _perm_from_planes(planes)
    lane = torch.arange(nl, device=dev)
    n = nsym.to(torch.int64).clamp(0, t_len)
    p = pos.to(torch.int64)
    out = torch.zeros(nl, t_len, dtype=torch.int32, device=dev)
    steps = int(n.max()) if nl else 0

    def word(k):
        return torch.where((k >= 0) & (k < wb),
                           w64[lane, k.clamp(0, wb - 1)], 0)

    for t in range(steps):
        p0 = p - MAXLOG
        k = p0 >> 5
        sh = p0 & 31
        w0, w1 = word(k), word(k + 1)
        v = torch.where(sh == 0, w0,
                        (w0 >> sh) | ((w1 << (32 - sh)) & 0xFFFFFFFF))
        v = v & ((1 << MAXLOG) - 1)
        cls = (v[:, None] >= lim).sum(dim=1)
        s = shf[lane, cls]
        rank = bas[lane, cls] + ((v - off[lane, cls]) >> s.clamp(0, 31))
        sym = perm[lane, rank.clamp(0, 255)]
        out[:, t] = torch.where(t < n, sym, 0).to(torch.int32)
        p = p - (MAXLOG - s)
    return out


def decode_lanemajor(ops: dict) -> torch.Tensor:
    """Decode lane-major operands (module docstring) into [NL, T] int32
    rows.  CPU tensors run ``decode_plain``; CUDA tensors launch the CUDA
    kernel on the current stream.  Any other device, dtype, shape or
    layout raises."""
    words = ops["words"]
    if not isinstance(words, torch.Tensor):
        raise TypeError("words: expected a torch.Tensor")
    dev = words.device
    nl, wb = words.shape
    shapes = {"words": (nl, None), "limits": (nl, 16), "bases": (nl, 16),
              "offs": (nl, 16), "shifts": (nl, 16), "planes": (nl, 64),
              "pos": (nl,), "nsym": (nl,)}
    for k in _OPERANDS:
        check_operand(k, ops[k], shapes[k], dev)
    t_len = bucket_t(int(ops["t_max"]))
    args = [ops[k] for k in _OPERANDS]
    if dev.type == "cpu":
        return decode_plain(*args, t_len)
    check_cuda(dev)
    out = torch.empty((nl, t_len), dtype=torch.int32, device=dev)
    a = [x.data_ptr() for x in args]
    launch("huf_decode", dev, _build.load().zt_huf_decode, a[0], wb, *a[1:],
           out.data_ptr(), nl, t_len)
    decode_lanemajor.launches += 1
    return out


decode_lanemajor.launches = 0


def ops_from_batch(batch, device) -> dict:
    """The port's lane-major operands from a reference ``HufBatch``
    (zstdsharp_tpu/ops/device_huf.py prepare_batch, kernel layout
    [K, SUB, LN]), as int32 tensors on `device`."""
    lanes = batch.pos.size

    def lm(a, k):
        a = np.asarray(a).reshape(k, lanes).T
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)

    w = batch.words.shape[0]
    return dict(
        words=lm(batch.words, w), limits=lm(batch.limits, 16),
        bases=lm(batch.bases, 16), offs=lm(batch.offs, 16),
        shifts=lm(batch.shifts, 16), planes=lm(batch.planes, 64),
        pos=lm(batch.pos, 1)[:, 0].contiguous(),
        nsym=lm(batch.n_sym, 1)[:, 0].contiguous(), t_max=int(batch.t_max))
