"""LDM anchor scan in torch (counterpart of zstdsharp_tpu/ops/ldm.py,
ZSTD_ldm_gear_feed role).

The gear rolling hash is h_i = 2*h_{i-1} + gear(src_i) and position i is an
anchor when (h_i & (2^r - 1)) == 0.  Because gear(.) << k has zero low k
bits, h_i mod 2^r depends only on the last r bytes:

    h_i mod 2^r  ==  (sum_{k=0}^{r-1} gear(src_{i-k}) << k) mod 2^r

with gear() of a position before 0 taken as 0, so the serial recurrence is r
shifted adds.  gear() is arithmetic, as in the reference and the native
engine's ldm_init:

    gear(b) = (((b + 1) * 0x9E3779B1) mod 2^32) >> 12, masked to r + 8 bits

torch has no full uint32 arithmetic and its int32 multiply is signed, so the
product is taken in int64 and wrapped with ``& 0xFFFFFFFF``.  One fused
elementwise pass with no caller on a hot path: plain torch ops on the
input's device, no hand kernel.
"""

from __future__ import annotations

import numpy as np
import torch

DEFAULT_RATE_LOG = 7   # native ldm_scan default (splits every ~128 bytes)
GEAR_MULT = 0x9E3779B1
GEAR_SHIFT = 12


def _gear_values(b: torch.Tensor, rate_log: int) -> torch.Tensor:
    """gear(b) as int64 (values < 2^(rate_log + 8))."""
    v = ((b.to(torch.int64) + 1) * GEAR_MULT) & 0xFFFFFFFF
    return (v >> GEAR_SHIFT) & ((1 << (rate_log + 8)) - 1)


def ldm_anchor_mask(src: torch.Tensor,
                    rate_log: int = DEFAULT_RATE_LOG) -> torch.Tensor:
    """uint8 mask [N] on src's device: 1 where position i is an LDM anchor.

    Positions i < rate_log - 1 see only the gear values from 0 to i (the
    serial hash starting at 0); the native ldm_scan skips them anyway.
    Unlike the reference, any N works, 0 and N < rate_log - 1 included."""
    r = rate_log
    g = _gear_values(src.reshape(-1), r)
    acc = g.clone()
    n = g.shape[0]
    for k in range(1, min(r, n)):
        acc[k:] += g[:n - k] << k
    return ((acc & ((1 << r) - 1)) == 0).to(torch.uint8)


def ldm_anchor_mask_reference(src: np.ndarray,
                              rate_log: int = DEFAULT_RATE_LOG) -> np.ndarray:
    """Exact serial reference (the native gear feed), for tests."""
    h = np.uint64(0)
    out = np.zeros(len(src), dtype=np.uint8)
    mask = np.uint64((1 << rate_log) - 1)
    gmask = np.uint64((1 << (rate_log + 8)) - 1)
    m32 = np.uint64((1 << 32) - 1)
    with np.errstate(over="ignore"):
        for i, b in enumerate(src):
            g = (((np.uint64(int(b) + 1) * np.uint64(GEAR_MULT)) & m32)
                 >> np.uint64(GEAR_SHIFT)) & gmask
            h = (h << np.uint64(1)) + g
            out[i] = (h & mask) == 0
    return out
