"""The encode plane's greedy LZ parse: CUDA kernel and plain torch version
(counterpart of zstdsharp_tpu/ops/device_encode.py ``_parse_phase`` and
zstdsharp_tpu/ops/matcher.py ``parse_blocks_ptrjump``).

``parse_lanes(blocks, n_valid, S, hash_log, u64_rounds, stride_rounds,
compact=...)`` parses every row of uint8 ``[B, N]`` independently (window
reset at the row start) and launches ``csrc/lz_parse.cu``'s
``zt_lz_parse`` once for all rows (one block a row; its source note says
what bounds it and how the design answers).  It takes CUDA tensors only
and raises on any other device, dtype, shape or layout; ``parse``, which
``matcher.parse_blocks_ptrjump`` and ``device_encode._parse_phase``
call, takes ``parse_plain`` on CPU tensors.  ``parse_plain`` is the torch
composition of the reference's program, the same integers on any device:
hash every position, previous-occurrence candidates by one stable sort,
vectorised match lengths, then the cursor walk "next match at or after
pos, jump past it" as the orbit of cursor 0 under the jump map, marked by
pointer doubling; with ``compact``, the literal compaction by one sort on
unique keys a row and the 36/32/53-bin sequence-code histograms.

Both return a dict of tensors on the rows' device:

  starts  int32 [B, S]  match start positions (N = padding)
  mls     int32 [B, S]  match lengths
  offs    int32 [B, S]  match distances
  nseq    int32 [B]     number of real sequences (at most S)
  covered bool  [B, N]  positions covered by the real sequences

and with ``compact`` also

  lit_sorted  uint8 [B, N]  the literals (positions below n_valid not
                            covered) in position order, then every other
                            byte in position order
  lit_count   int32 [B]     n_valid - the sum of the real match lengths
  ll_hist, of_hist, ml_hist int32 [B, 36], [B, 32], [B, 53]
"""

from __future__ import annotations

import torch

from .. import _build
from ._launch import check_cuda, check_operand, launch
from .common import (hash4, match_lengths, previous_occurrence,
                     u32_at_every_byte)

MIN_MATCH = 4
MAX_N = 1 << 17          # the row and its three bitmasks in 227 KB
SHARED_HASH_LOG = 15     # tables up to 128 KB live in shared memory
MAX_HASH_LOG = 24        # past 15 the table is a [B, 2^hash_log] scratch
PARSE_KEYS = ("starts", "mls", "offs", "nseq", "covered")
HIST_BINS = (("ll_hist", 36), ("of_hist", 32), ("ml_hist", 53))


def _parse_torch(blocks, n_valid, hash_log, max_seq, ml_u64_rounds,
                 ml_stride_rounds):
    """The greedy parse of every row in plain torch (reference
    ``parse_blocks_ptrjump``, vmapped); the five ``PARSE_KEYS``."""
    B, n = blocks.shape
    dev = blocks.device
    i64 = torch.int64
    idx = torch.arange(n, device=dev)
    nv = n_valid.to(i64)[:, None]

    v32 = u32_at_every_byte(blocks)
    h = hash4(v32, hash_log)
    cand = previous_occurrence(h).to(i64)
    valid = ((cand >= 0)
             & (torch.gather(v32, 1, cand.clamp(min=0)) == v32)
             & (idx + MIN_MATCH <= nv))
    ml = match_lengths(blocks, torch.where(valid, cand, -1),
                       u64_rounds=ml_u64_rounds,
                       stride_rounds=ml_stride_rounds).to(i64)
    ml = torch.minimum(ml, nv - idx)
    valid = valid & (ml >= MIN_MATCH)

    # next_valid[i] = smallest j >= i with valid[j]: reverse cumulative min
    cand_pos = torch.where(valid, idx, n)
    next_valid = torch.flip(torch.cummin(torch.flip(cand_pos, [1]), 1).values,
                            [1])
    pad = torch.full((B, 1), n, dtype=i64, device=dev)
    j = torch.cat([next_valid, pad], 1)                    # match at cursor p
    ml_pad = torch.cat([ml, torch.zeros_like(pad)], 1)
    f = torch.where(j < n, (j + torch.gather(ml_pad, 1, j.clamp(0, n))
                            ).clamp(max=n), n)

    # orbit of cursor 0: R <- R | f^(2^k)(R), doubling f each round
    orbit = torch.zeros(B, n + 1, dtype=torch.int32, device=dev)
    orbit[:, 0] = 1
    fk = f
    for _ in range(max(1, (max_seq + 1).bit_length())):
        hit = torch.zeros_like(orbit).scatter_reduce_(
            1, fk, orbit, "amax", include_self=True)
        orbit = torch.maximum(orbit, hit)
        fk = torch.gather(fk, 1, fk)

    # selected match starts = nv of orbit cursors (distinct by progress)
    take = (orbit > 0) & (j < n)
    sel = torch.zeros_like(orbit).scatter_reduce_(
        1, torch.where(take, j, n), take.to(torch.int32), "amax",
        include_self=True)[:, :n]
    nseq = sel.sum(1).clamp(max=max_seq)

    # compact the selected positions in order via one sort (unique keys)
    key = torch.where(sel > 0, idx, n + idx)
    sorted_idx = torch.sort(key, dim=1).values[:, :max_seq]
    k = torch.arange(max_seq, device=dev)
    live = k < nseq[:, None]
    starts = torch.where(live, sorted_idx, n)
    sc = starts.clamp(0, n - 1)
    mls = torch.where(live, torch.gather(ml, 1, sc), 0)
    offs = torch.where(live, sc - torch.gather(cand, 1, sc), 0)

    real = starts < n
    delta = torch.zeros(B, n + 1, dtype=i64, device=dev)
    delta.scatter_add_(1, torch.where(real, starts, n), real.to(i64))
    ends = torch.clamp(starts + mls, max=n)
    delta.scatter_add_(1, torch.where(real, ends, n), -real.to(i64))
    covered = torch.cumsum(delta[:, :n], 1) > 0
    return {"starts": starts.to(torch.int32), "mls": mls.to(torch.int32),
            "offs": offs.to(torch.int32), "nseq": nseq.to(torch.int32),
            "covered": covered}


def parse_plain(blocks, n_valid, S: int, hash_log: int, u64_rounds: int,
                stride_rounds: int, *, compact: bool) -> dict:
    """Plain torch version of the kernel, on whatever device the rows are
    on (the reference's program: ``parse_blocks_ptrjump``, then with
    `compact` the literal compaction and code histograms of
    ``_parse_phase``).  Issues no host synchronisation."""
    from . import device_encode as de

    out = _parse_torch(blocks, n_valid, hash_log, S, u64_rounds,
                       stride_rounds)
    if not compact:
        return out
    B, N = blocks.shape
    dev = blocks.device
    nv = n_valid.to(torch.int64)
    # literals first, in position order: one sort on unique keys per row
    idx = torch.arange(N, device=dev)
    drop = out["covered"] | (idx >= nv[:, None])
    key = drop.to(torch.int64) * N + idx
    out["lit_sorted"] = torch.gather(blocks, 1,
                                     torch.sort(key, dim=1).indices)
    i = torch.arange(S, device=dev)
    real_mls = torch.where(i < out["nseq"].to(torch.int64)[:, None],
                           out["mls"].to(torch.int64), 0)
    out["lit_count"] = (nv - real_mls.sum(1)).to(torch.int32)

    real, ll, mlv, ofb = de._seq_values(out["starts"], out["mls"],
                                        out["offs"], out["nseq"])
    llc, mlc, ofc = de._codes_from_values(ll, mlv, ofb, de._dev_consts(dev))
    for (name, bins), codes in zip(HIST_BINS, (llc, ofc, mlc)):
        out[name] = de._code_hist(codes, real, bins)
    return out


_LUT_CACHE: dict = {}


def _lut(dev: torch.device) -> torch.Tensor:
    """int32 [192] on `dev`: the ll code LUT (64) then the ml code LUT
    (128) of ``device_encode._tables()``, uploaded once per device."""
    key = str(dev)
    if key not in _LUT_CACHE:
        import numpy as np

        from . import device_encode as de

        t = de._tables()
        _LUT_CACHE[key] = torch.from_numpy(np.concatenate(
            [t["ll_lut"], t["ml_lut"]]).astype(np.int32)).to(dev)
    return _LUT_CACHE[key]


def parse_lanes(blocks, n_valid, S: int, hash_log: int, u64_rounds: int,
                stride_rounds: int, *, compact: bool,
                stamps: torch.Tensor | None = None) -> dict:
    """Every row of `blocks` (uint8 [B, N], contiguous, on a CUDA device)
    in one launch of the kernel, on the current stream; n_valid [B] of an
    integer dtype on the same device.  Raises on any other device, dtype,
    shape or layout, and for N outside [1, MAX_N], S < 1, hash_log outside
    [1, MAX_HASH_LOG] or negative rounds.  `stamps` (int64 [B, 6] on the
    same device), when given, receives each row's SM clock at the start
    and after each of the kernel's passes.  Counts its launches in
    ``parse_lanes.launches``."""
    if not isinstance(blocks, torch.Tensor) or blocks.dim() != 2:
        raise ValueError("blocks: expected a uint8 tensor [B, N]")
    B, N = blocks.shape
    dev = blocks.device
    check_operand("blocks", blocks, (B, N), dev, torch.uint8)
    if not isinstance(n_valid, torch.Tensor) or n_valid.dtype == torch.bool \
            or n_valid.dtype.is_floating_point or n_valid.dtype.is_complex:
        raise TypeError("n_valid: expected an integer tensor [B]")
    if n_valid.device != dev or tuple(n_valid.shape) != (B,):
        raise ValueError(f"n_valid: shape {tuple(n_valid.shape)} on "
                         f"{n_valid.device}, expected ({B},) on {dev}")
    if not 1 <= N <= MAX_N:
        raise ValueError(f"N {N}: the kernel takes 1 to {MAX_N}")
    if S < 1:
        raise ValueError(f"S {S}: expected >= 1")
    if not 1 <= hash_log <= MAX_HASH_LOG:
        raise ValueError(f"hash_log {hash_log}: expected 1 to {MAX_HASH_LOG}")
    if u64_rounds < 0 or stride_rounds < 0:
        raise ValueError("rounds must be >= 0")
    if stamps is not None:
        check_operand("stamps", stamps, (B, 6), dev, torch.int64)
    check_cuda(dev)
    out, args, _keep = launch_args(blocks, n_valid, S, hash_log, u64_rounds,
                                   stride_rounds, compact, stamps)
    if B:
        launch("lz_parse", dev, _build.load().zt_lz_parse, *args)
        parse_lanes.launches += 1
    return out


def parse(blocks, n_valid, S: int, hash_log: int, u64_rounds: int,
          stride_rounds: int, *, compact: bool) -> dict:
    """The parse where the rows are: ``parse_plain`` on CPU tensors,
    ``parse_lanes`` (the kernel, or a raise) on any other."""
    fn = parse_plain if blocks.device.type == "cpu" else parse_lanes
    return fn(blocks, n_valid, S, hash_log, u64_rounds, stride_rounds,
              compact=compact)


def launch_args(blocks, n_valid, S, hash_log, u64_rounds, stride_rounds,
                compact, stamps=None):
    """The outputs of one ``zt_lz_parse`` call on checked operands (as
    ``parse_lanes`` returns them, allocated), its arguments but the
    stream, and the scratch tensors those point into, which must outlive
    the launch."""
    B, N = blocks.shape
    dev = blocks.device
    i32 = torch.int32
    nv = n_valid.to(i32).contiguous()
    out = {"starts": torch.empty(B, S, dtype=i32, device=dev),
           "mls": torch.empty(B, S, dtype=i32, device=dev),
           "offs": torch.empty(B, S, dtype=i32, device=dev),
           "nseq": torch.empty(B, dtype=i32, device=dev),
           "covered": torch.empty(B, N, dtype=torch.bool, device=dev)}
    lit_count = torch.empty(B, dtype=i32, device=dev)
    if compact:
        out["lit_sorted"] = torch.empty(B, N, dtype=torch.uint8, device=dev)
        out["lit_count"] = lit_count
        for name, bins in HIST_BINS:
            out[name] = torch.empty(B, bins, dtype=i32, device=dev)
    scratch = torch.empty(3, B, N, dtype=i32, device=dev)
    table = (torch.empty(B, 1 << hash_log, dtype=i32, device=dev)
             if hash_log > SHARED_HASH_LOG else None)

    def ptr(t):
        return None if t is None else t.data_ptr()

    args = (blocks.data_ptr(), nv.data_ptr(), B, N, S, hash_log, u64_rounds,
            stride_rounds, ptr(_lut(dev)) if compact else None,
            *(ptr(out[k]) for k in ("starts", "mls", "offs", "nseq")),
            lit_count.data_ptr(), ptr(out["covered"]),
            *(ptr(out.get(k)) for k in ("lit_sorted", "ll_hist", "of_hist",
                                        "ml_hist")),
            scratch.data_ptr(), ptr(table), ptr(stamps))
    return out, args, (nv, lit_count, scratch, table)


parse_lanes.launches = 0
