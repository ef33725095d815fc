"""End-to-end batch compression on a torch device (counterpart of
zstdsharp_tpu/encode/device_pipeline.py).

``compress_batch_device(records, device=device)`` compresses a batch of byte
records on `device`: greedy parse, literal and code histograms (the byte
histogram is the hand-written CUDA kernel on a GPU), FSE sequence coding,
Huffman literals, bit packing and frame assembly run there, with one host
step per 32-record chunk for the entropy tables (``ops.device_encode``).
Frame rows stay in device memory unless ``materialize`` asks for bytes.

Envelope, as the reference: records up to 128 KB become single-segment
single-block frames, padded into the 4/16/64/128 KB buckets; larger
records go to the port's host ``compress(rec, 1)`` and are reported in the
stats.  Every frame is standard zstd, byte-identical to the reference's.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops._launch import check_flag, resolve_device
from ..ops.device_encode import encode_frames_device, seq_budget, word_budget
from ..utils import trace
from .frame import compress

# records per device chunk, and the record-size buckets (the reference's)
LANES = 32
_N_BUCKETS = (1 << 12, 1 << 14, 1 << 16, 1 << 17)


def _bucket(n: int) -> int:
    """The smallest bucket that holds n bytes, or -1 (host route)."""
    for b in _N_BUCKETS:
        if n <= b:
            return b
    return -1


def compress_batch_device(records, materialize: bool = False,
                          hash_log: int = 15, *, device="cuda",
                          timings: dict | None = None):
    """Compress a batch of records on `device` (a torch device or its
    name; the card unless the caller names another, and without a card
    the default raises).  The positional parameters are the reference's,
    in its order; `device` and `timings` are keywords only, and a device
    passed in `materialize`'s place raises TypeError.

    Returns (chunks, host_results): chunks is a list of (record_indices,
    rows [LANES, N+16] uint8, lens [LANES] int32), both tensors on
    `device`; host_results maps record_idx -> frame bytes for records
    outside the device envelope.  With materialize=True, returns (frames,
    stats): every record's frame bytes in order plus routing stats.

    timings: when a dict is given, each stage's wall seconds are added
    under its key, the device synchronised at the stage's end: "pack"
    (the records packed into each bucket's arrays; inside it
    "pack.upload", their copy), "parse", "tables" (with "tables.lit",
    "tables.seq" and "tables.upload") and "assembly" of every chunk
    (``encode_frames_device``), and with materialize=True "materialize"
    (the frames' copies and each record's bytes).  Under a running
    torch.profiler the host stretches of "pack" and "materialize" are
    also recorded as "encode.pack" and "encode.materialize"
    (``utils.trace``).
    """
    check_flag("materialize", materialize)
    device = resolve_device(device)
    host_results = {}
    by_bucket: dict = {}
    for ri, rec in enumerate(records):
        b = _bucket(len(rec))
        if b < 0:
            host_results[ri] = compress(bytes(rec), 1)
            continue
        by_bucket.setdefault(b, []).append(ri)

    chunks = []
    for N, idxs in sorted(by_bucket.items()):
        S = seq_budget(N)
        W = word_budget(S)
        n_chunks = -(-len(idxs) // LANES)
        # one upload per bucket: every chunk's padded records at once
        with trace.stage("pack", timings, device):
            with trace.stage("pack", None, plane="encode"):
                blocks = np.zeros((n_chunks * LANES, N), np.uint8)
                nv = np.zeros(n_chunks * LANES, np.int32)
                for k, ri in enumerate(idxs):
                    r = records[ri]
                    blocks[k, :len(r)] = np.frombuffer(r, np.uint8)
                    nv[k] = len(r)
            with trace.stage("pack.upload", timings):
                blocks_d = torch.from_numpy(blocks).to(device)
                nv_d = torch.from_numpy(nv).to(device)
        for c in range(n_chunks):
            lanes = slice(c * LANES, (c + 1) * LANES)
            rows, lens = encode_frames_device(
                blocks_d[lanes], nv_d[lanes], S, W, hash_log,
                timings=timings)
            chunks.append((idxs[lanes], rows, lens))

    if not materialize:
        return chunks, host_results

    frames: list = [None] * len(records)
    for ri, f in host_results.items():
        frames[ri] = f
    with trace.stage("materialize", timings, device):
        for part, rows, lens in chunks:
            h = rows.cpu().numpy()
            ln = lens.cpu().numpy()
            with trace.stage("materialize", None, plane="encode"):
                for k, ri in enumerate(part):
                    frames[ri] = h[k, :ln[k]].tobytes()
    stats = {"device_frames": sum(len(p) for p, _, _ in chunks),
             "host_frames": len(host_results)}
    return frames, stats
