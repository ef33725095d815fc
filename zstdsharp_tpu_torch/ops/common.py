"""Primitives of the device encoder in torch (counterpart of
zstdsharp_tpu/ops/common.py): u32/u64 window views, the ZSTD_hash4
multiplicative hash, previous-occurrence candidates, vectorised match
lengths and the prefix-scan bit packer.

Every function is batched over leading dimensions: a ``[..., N]`` input
gives a ``[..., N]`` output, row by row, where the reference works on one
``[N]`` vector and is vmapped.

Integer semantics are the reference's with JAX's x64 mode off.  torch has
no usable uint32, so u32 quantities are carried in int64 tensors holding
values in [0, 2^32), wrapped with ``& 0xFFFFFFFF`` where the reference's
u32 arithmetic wraps; shifts of such values are therefore logical.  The
u64 view is returned as int64 with the same bit pattern.
"""

from __future__ import annotations

import math

import torch

HASH4_PRIME = 2654435761
U32 = 0xFFFFFFFF


def u32_at_every_byte(block: torch.Tensor) -> torch.Tensor:
    """Little-endian u32 read at each byte position: uint8 [..., N] ->
    int64 [..., N] in [0, 2^32), zeros past the end."""
    b = block.to(torch.int64)
    n = b.shape[-1]
    v = b.clone()
    for k in (1, 2, 3):
        if k < n:
            v[..., :n - k] |= b[..., k:] << (8 * k)
    return v


def u64_at_every_byte(block: torch.Tensor) -> torch.Tensor:
    """Little-endian u64 read at each byte position (zeros past the end),
    as int64 with the u64's bit pattern."""
    v32 = u32_at_every_byte(block)
    hi = torch.zeros_like(v32)
    n = v32.shape[-1]
    if n > 4:
        hi[..., :n - 4] = v32[..., 4:]
    v = v32 | ((hi & 0x7FFFFFFF) << 32)
    return torch.where(hi >> 31 == 1, v | (-(1 << 63)), v)


def hash4(v32: torch.Tensor, hash_log: int) -> torch.Tensor:
    """ZSTD-style multiplicative hash into 2^hash_log buckets: u32 product
    mod 2^32, taken in 16-bit halves so no int64 product overflows."""
    v = v32.to(torch.int64)
    lo, hi = v & 0xFFFF, (v >> 16) & 0xFFFF
    prod = (lo * HASH4_PRIME + (((hi * HASH4_PRIME) & 0xFFFF) << 16)) & U32
    return (prod >> (32 - hash_log)).to(torch.int32)


def previous_occurrence(h: torch.Tensor,
                        valid: torch.Tensor | None = None) -> torch.Tensor:
    """For each position i of each row, the most recent j < i with
    h[j] == h[i]; -1 if none (stable sort on (h, i), int32)."""
    order = torch.sort(h, dim=-1, stable=True).indices
    h_sorted = torch.gather(h, -1, order)
    same = torch.zeros_like(h_sorted, dtype=torch.bool)
    same[..., 1:] = h_sorted[..., 1:] == h_sorted[..., :-1]
    before = torch.full_like(order, -1)
    before[..., 1:] = order[..., :-1]
    prev_sorted = torch.where(same, before, -1)
    prev = torch.empty_like(order).scatter_(-1, order, prev_sorted)
    if valid is not None:
        prev = torch.where(valid, prev, -1)
    return prev.to(torch.int32)


def highbit(v: torch.Tensor) -> torch.Tensor:
    """floor(log2(max(v, 1))) by a 5-step binary search (torch has no clz;
    a float log2 is not exact).  v holds values below 2^32; int64 out."""
    v = v.to(torch.int64).clamp(min=1)
    r = torch.zeros_like(v)
    for s in (16, 8, 4, 2, 1):
        m = v >= (1 << s)
        r = r + torch.where(m, s, 0)
        v = torch.where(m, v >> s, v)
    return r


def ctz32(x: torch.Tensor) -> torch.Tensor:
    """Count trailing zeros of u32 values (32 for x == 0), int64."""
    x = x.to(torch.int64) & U32
    return torch.where(x == 0, 32, highbit(x & -x))


def match_lengths(block: torch.Tensor, cand: torch.Tensor,
                  u64_rounds: int = 16, stride_rounds: int = 24) -> torch.Tensor:
    """Vectorised LCP of block[i:] vs block[cand[i]:] for every position of
    every row (reference ``match_lengths``): 8-byte XOR+ctz steps as u32
    pairs, then 64-byte stride jumps, then an 8-byte refinement.  Reads
    clamp to the last position.  uint8 [..., N], int [..., N] -> int32."""
    n = block.shape[-1]
    idx = torch.arange(n, device=block.device)
    v32 = u32_at_every_byte(block)
    cap = n - 1
    cand = cand.to(torch.int64)
    j = cand.clamp(min=0)

    def at(p):
        return torch.gather(v32, -1, p.clamp(max=cap))

    def u64_phase(length, active, rounds):
        for _ in range(rounds):
            x0 = at(idx + length) ^ at(j + length)
            x1 = at(idx + length + 4) ^ at(j + length + 4)
            step = torch.where(x0 != 0, ctz32(x0) >> 3,
                               4 + (ctz32(x1) >> 3).clamp(max=4))
            length = torch.where(active, length + step, length)
            active = active & (x0 == 0) & (x1 == 0)
        return length, active

    length = torch.zeros_like(cand)
    active = cand >= 0
    length, active = u64_phase(length, active, u64_rounds)
    if stride_rounds:
        for _ in range(stride_rounds):
            eq = active
            for k in range(0, 64, 4):
                eq = eq & (at(idx + length + k) == at(j + length + k))
            length = torch.where(eq, length + 64, length)
            active = active & eq
        length, active = u64_phase(length, active | (cand >= 0), 8)
    return torch.minimum(torch.where(cand >= 0, length, 0),
                         n - idx).to(torch.int32)


def pack_bits_device(values: torch.Tensor, nbits: torch.Tensor,
                     out_words: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Prefix-scan bit packer, row by row (reference ``pack_bits_device``).

    values, nbits: [..., F] (fields <= 31 bits).  Returns (words int64
    [..., out_words] holding little-endian u32 words, total_bits int64
    [...] including the end mark).  Bit ranges are disjoint, so a
    scatter-add realises the OR.  Writes at or past out_words are dropped,
    as the reference's ``mode="drop"``: they go to a dump column that is
    sliced off (an out-of-range index would fault on CUDA)."""
    lead = values.shape[:-1]
    f = values.shape[-1]
    rows = math.prod(lead)
    v = values.reshape(rows, f).to(torch.int64) & U32
    nb = nbits.reshape(rows, f).to(torch.int64) & U32
    v = v & (((1 << nb.clamp(max=32)) - 1) & U32)
    end = torch.cumsum(nb, dim=-1) & U32
    offsets = (end - nb) & U32
    last = end[:, -1] if f else torch.zeros(v.shape[0], dtype=torch.int64,
                                             device=v.device)
    total = (last + 1) & U32

    def drop(i):
        return torch.where((i >= 0) & (i < out_words), i, out_words)

    widx = offsets >> 5
    s = offsets & 31
    w_lo = (v << s) & U32
    w_hi = (v >> (31 - s)) >> 1
    words = torch.zeros(v.shape[0], out_words + 1, dtype=torch.int64,
                        device=v.device)
    words.scatter_add_(1, drop(widx), w_lo)
    words.scatter_add_(1, drop(widx + 1), w_hi)
    tm = (total - 1) & U32
    words.scatter_add_(1, drop(tm >> 5)[:, None], (1 << (tm & 31))[:, None])
    words = words[:, :out_words] & U32
    return words.reshape(*lead, out_words), total.reshape(lead)
