"""Device match finder in torch (counterpart of
zstdsharp_tpu/ops/matcher.py): the greedy LZ parse with log-depth
selection (``parse_blocks_ptrjump``, and ``parse_block`` built on it), the
sort-based candidate stage of the data-parallel pipeline
(``candidate_stage``) and the parse statistics of the entry point's
forward step (``parse_block_stats``).

Every row of a ``[B, N]`` batch is parsed independently (window reset at
the row start), where the reference works on one ``[N]`` row and is
vmapped.  The parse runs where the rows are: on a card as one launch of
the ``csrc/lz_parse.cu`` kernel for all rows, on the CPU as its plain
torch version (both in ``ops/lz_parse.py``).  ``candidate_stage`` and the
statistics around the parse are plain torch on whatever device the rows
are on (the literal histogram through ``histogram_u8``, the CUDA kernel on
a card).  Nothing here synchronises with the host.
"""

from __future__ import annotations

import torch

from .common import U32, hash4, highbit, u32_at_every_byte, u64_at_every_byte
from .histogram import histogram_u8
from . import lz_parse


def parse_blocks_ptrjump(blocks: torch.Tensor, n_valid: torch.Tensor,
                         hash_log: int = 16, max_seq: int | None = None,
                         ml_u64_rounds: int = 8, ml_stride_rounds: int = 8):
    """Greedy parse of each row of uint8 ``[B, N]``; ``n_valid [B]`` marks
    the real bytes.  Returns a dict of padded tensors, as the reference:

      starts  int32 [B, max_seq]  match start positions (N = padding)
      mls     int32 [B, max_seq]  match lengths
      offs    int32 [B, max_seq]  match distances
      nseq    int32 [B]           number of real sequences
      covered bool  [B, N]        positions covered by matches

    CUDA rows go through one launch of the ``csrc/lz_parse.cu`` kernel
    (``lz_parse.parse_lanes``), CPU rows through its plain torch version
    (``lz_parse.parse_plain``)."""
    if max_seq is None:
        max_seq = blocks.shape[-1] // 8
    return lz_parse.parse(blocks, n_valid, max_seq, hash_log, ml_u64_rounds,
                          ml_stride_rounds, compact=False)


def parse_block(blocks: torch.Tensor, n_valid: torch.Tensor,
                hash_log: int = 16, max_seq: int | None = None):
    """Greedy parse of each row (reference ``parse_block``, vmapped).

    The reference walks the cursor with a ``max_seq``-step ``lax.scan``;
    the orbit of cursor 0 marked by pointer doubling selects the same
    matches, so this is ``parse_blocks_ptrjump`` with parse_block's match
    extension budget (16 u64 rounds, 24 stride rounds).  Same outputs."""
    return parse_blocks_ptrjump(blocks, n_valid, hash_log, max_seq,
                                ml_u64_rounds=16, ml_stride_rounds=24)


def candidate_stage(blocks: torch.Tensor, hash_log: int = 16):
    """Sort-based match candidates of each row (reference
    ``candidate_stage``): (hash, position) packed into one unique key per
    byte, one sort per row, and each sorted entry's predecessor taken as its
    candidate when the two share the hash and their first 4 bytes.  The key
    is ``(h << pos_bits) | pos`` when hash_log + pos_bits <= 32, else
    ``(h << 32) | pos``, as the reference's u32 and u64 layouts; both fit a
    non-negative int64, and unique keys make the sort order the reference's.

    uint8 [B, N] -> (ps, cand) int32 [B, N] in sorted order: the positions,
    and each one's most recent previous occurrence (-1 if none)."""
    n = blocks.shape[-1]
    pos_bits = max((n - 1).bit_length(), 1)
    hshift = pos_bits if hash_log + pos_bits <= 32 else 32
    h = hash4(u32_at_every_byte(blocks), hash_log).to(torch.int64)
    key = (h << hshift) | torch.arange(n, device=blocks.device)
    ks, order = torch.sort(key, dim=-1)
    vs = torch.gather(u64_at_every_byte(blocks), -1, order)
    ps = (ks & ((1 << hshift) - 1)).to(torch.int32)
    valid = torch.zeros_like(ks, dtype=torch.bool)
    valid[..., 1:] = (((ks[..., 1:] >> hshift) == (ks[..., :-1] >> hshift))
                      & (((vs[..., 1:] ^ vs[..., :-1]) & U32) == 0))
    cand = torch.full_like(ps, -1)
    cand[..., 1:] = torch.where(valid[..., 1:], ps[..., :-1], -1)
    return ps, cand


def parse_block_stats(blocks: torch.Tensor, n_valid: torch.Tensor,
                      hash_log: int = 16):
    """Parse plus code statistics of each row (reference
    ``parse_block_stats``, vmapped): the ``parse_block`` outputs and
    lit_count, match_bytes (int64 [B]), of_hist (int32 [B, 32], the offset
    codes' histogram) and lit_hist (int32 [B, 256], the uncovered valid
    bytes' histogram through ``histogram_u8``, the CUDA kernel on a GPU)."""
    r = parse_block(blocks, n_valid, hash_log)
    n = blocks.shape[-1]
    real = r["starts"] < n
    match_bytes = torch.where(real, r["mls"], 0).sum(-1)
    lit_count = n_valid.to(torch.int64) - match_bytes
    of_code = highbit(torch.where(real, r["offs"].to(torch.int64) + 3, 1))
    of_hist = torch.zeros(*real.shape[:-1], 32, dtype=torch.int32,
                          device=blocks.device)
    of_hist.scatter_add_(-1, of_code, real.to(torch.int32))
    lit_mask = (~r["covered"]) & (torch.arange(n, device=blocks.device)
                                  < n_valid.to(torch.int64)[..., None])
    lit_hist = histogram_u8(blocks.contiguous(), lit_mask)
    return {**r, "lit_count": lit_count, "match_bytes": match_bytes,
            "of_hist": of_hist, "lit_hist": lit_hist}
