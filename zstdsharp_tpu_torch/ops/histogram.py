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
from ._launch import check_cuda, check_operand, launch

MAX_ROWS = 2**31 - 1       # the launcher's `int b` and its 1-D grid
MAX_PORTABLE_CLUSTER = 8
MASKED_SHARE = 16 << 10    # a block's share of a masked row
UNMASKED_SHARE = 4 << 10   # ... of an unmasked row
SPLIT_SHARE = 8 << 10      # ... when a row takes several clusters
BLOCKS_PER_SM = 2          # blocks the plan puts on each SM at most

_sm_count: dict = {}


def plan(b: int, n: int, sms: int, masked: bool) -> tuple[int, int]:
    """(cs, cpr) for `b` rows of `n` bytes on a card of `sms` SMs: each
    row takes cpr clusters of cs blocks.  A cluster of more than one block
    pays about 0.9 us for its barriers (H100), which a block's share of
    the row has to earn back; a mask leaves few bytes to count (the
    encoder's literal rows keep about 1 % of their positions), so masked
    rows take MASKED_SHARE bytes a block and unmasked rows UNMASKED_SHARE.
    Rows so few that one cluster of 8 each would leave more than half the
    SMs idle take several clusters of about SPLIT_SHARE bytes a block, and
    the call a second, reducing kernel.  The grid never holds more than
    BLOCKS_PER_SM blocks an SM beyond one a row."""
    fill = -(-sms * BLOCKS_PER_SM // b)
    share = MASKED_SHARE if masked else UNMASKED_SHARE
    per_row = max(1, min(-(-n // share), fill))
    if per_row <= MAX_PORTABLE_CLUSTER:
        return per_row, 1
    if 2 * b * MAX_PORTABLE_CLUSTER > sms:
        return MAX_PORTABLE_CLUSTER, 1
    per_row = min(-(-n // SPLIT_SHARE), fill)
    return MAX_PORTABLE_CLUSTER, -(-per_row // MAX_PORTABLE_CLUSTER)


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
    the current stream.  Any other device, dtype, shape or layout raises,
    and so do more than MAX_ROWS rows."""
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
    b, n = (1, shape[0]) if data.dim() == 1 else shape
    if b > MAX_ROWS:
        raise ValueError(f"data: {b} rows, the kernel takes at most "
                         f"{MAX_ROWS}")
    if dev.type == "cpu":
        return histogram_plain(data, mask)
    check_cuda(dev)
    if b == 0 or n == 0:
        return torch.zeros(*shape[:-1], 256, dtype=torch.int32, device=dev)
    sms = _sm_count.get(dev.index)
    if sms is None:
        sms = _sm_count[dev.index] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    cs, cpr = plan(b, n, sms, mask is not None)
    out = torch.empty(*shape[:-1], 256, dtype=torch.int32, device=dev)
    scratch = (torch.empty(b, cpr, 256, dtype=torch.int32, device=dev)
               if cpr > 1 else None)
    launch("histogram", dev, _build.load().zt_histogram, data.data_ptr(),
           mask.data_ptr() if mask is not None else None, b, n,
           out.data_ptr(), scratch.data_ptr() if scratch is not None else None,
           cs, cpr)
    histogram_u8.launches += 2 if cpr > 1 else 1  # and the reducing kernel
    return out


histogram_u8.launches = 0
