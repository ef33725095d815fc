"""Byte histograms: CUDA kernel and plain torch version (counterpart of
zstdsharp_tpu/ops/histogram.py, HIST_count role).

``histogram_u8(data, mask=None)`` keeps the reference's signature: data is
uint8 ``[N]`` or ``[B, N]``, mask an optional bool tensor of the same
shape, and the result int32 ``[256]`` or ``[B, 256]``.  An unmasked 1-D
call computes what the Pallas kernel ``histogram_u8_pallas`` computes, a
masked call what the XLA ``histogram_u8`` computes.  The kernel
(``csrc/histogram.cu``) replaces ``_hist_kernel``; its source note says
what bounds it and how the design answers.
"""

from __future__ import annotations

import torch

from .. import _build
from ._launch import check_operand, launch, stream_handle


def histogram_plain(data: torch.Tensor,
                    mask: torch.Tensor | None = None) -> torch.Tensor:
    """Plain torch version of the kernel: a scatter-add of ones (of the
    mask) into 256 bins per row, on whatever device data is on."""
    rows = data if data.dim() == 2 else data[None]
    ones = (torch.ones_like(rows, dtype=torch.int32) if mask is None
            else mask.reshape(rows.shape).to(torch.int32))
    out = torch.zeros(rows.shape[0], 256, dtype=torch.int32,
                      device=data.device)
    out.scatter_add_(1, rows.to(torch.int64), ones)
    return out.reshape(*data.shape[:-1], 256)


def histogram_u8(data: torch.Tensor,
                 mask: torch.Tensor | None = None) -> torch.Tensor:
    """counts per byte value of each row; `mask` gates positions.  CPU
    tensors run ``histogram_plain``; CUDA tensors launch the CUDA kernel on
    the current stream.  Any other device, dtype, shape or layout raises."""
    if not isinstance(data, torch.Tensor):
        raise TypeError("data: expected a torch.Tensor")
    if data.dim() not in (1, 2):
        raise ValueError(f"data: shape {tuple(data.shape)}, expected [N] "
                         "or [B, N]")
    dev = data.device
    shape = tuple(data.shape)
    check_operand("data", data, shape, dev, torch.uint8)
    if mask is not None:
        check_operand("mask", mask, shape, dev, torch.bool)
    if dev.type == "cpu":
        return histogram_plain(data, mask)
    stream_handle(dev)  # raises off CUDA
    b, n = (1, shape[0]) if data.dim() == 1 else shape
    out = torch.zeros(b, 256, dtype=torch.int32, device=dev)
    if data.numel() == 0:
        return out.reshape(*shape[:-1], 256)
    launch("histogram", dev, _build.load().zt_histogram, data.data_ptr(),
           mask.data_ptr() if mask is not None else None, b, n,
           out.data_ptr())
    histogram_u8.launches += 1
    return out.reshape(*shape[:-1], 256)


histogram_u8.launches = 0
