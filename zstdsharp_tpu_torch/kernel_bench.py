"""Kernel measurements on one NVIDIA GPU, and the bounds every kernel is
held to.

    python -m zstdsharp_tpu_torch.kernel_bench [--hist-baseline FILE.cu]
                                               [--huf-baseline FILE.cu]
                                               [--fse-baseline FILE.cu]
                                               [--parse-baseline FILE.cu]
                                               [--parse-only]
                                               [--assemble-baseline FILE.cu]
                                               [--assemble-only]
                                               [--tables-only]
                                               [--out FILE.json]

1. The histogram kernel (``csrc/histogram.cu``) on every shape the main
   path gives it -- the encoder's literal rows ([32, 16384] and, for the
   top bucket, [32, 131072], with their prefix masks) and
   ``parse_block_stats``'s rows in ``graft_entry.entry`` ([4, 32768], the
   uncovered bytes' mask) -- on dense unmasked text rows [32, 131072], on
   32 rows of one byte value and 32 of ``b"ab" * 8192`` (skewed bytes),
   and on the 4 MB + 1 vector of chip_smoke.py's phase 6.  Each
   ``--hist-baseline`` (another source of ``zt_histogram``, e.g. the
   earlier kernel that adds into a zeroed output, which the harness
   zeroes) is built alone beside it, checked against the plain version
   and timed in turns: device time of the histogram's own kernels per
   call (``torch.profiler``), CUDA events through the raw launcher (an
   adding kernel with and without its fill), the launch floor (empty
   kernels of the same grid and cluster shape), events and host time
   (``perf_counter``, the enqueue alone) through the wrapper,
   and ``torch.bincount`` (a yardstick the port never calls; the mask as
   weights).  Then the (cs, cpr) configurations of ``HIST_CONFIGS``.  The
   bound counts every mask byte but only the data sectors that hold a
   kept position (``hist_work``).
2. The two decode kernels, the Huffman literal decode
   (``csrc/huf_decode.cu``) and the FSE sequence decode
   (``csrc/fse_decode.cu``), each at the main path's operands -- the
   planner's window of the bench's decode batch (the first 6 MB of
   ``bench.make_corpus`` as 256 records of 24 KB at level 9: Huffman
   [1024 lanes, Wb 256, T 1024], FSE [256 lanes, Wb 1024, T 4096]) -- at
   a larger Wb bucket (256 records of 48 KB at level 9: Huffman Wb 768,
   FSE Wb 2048) and on the main window's longest lane alone (its time
   over its symbol or sequence count is the serial chain's latency per
   item).  Each ``--huf-baseline`` / ``--fse-baseline`` names another
   source of the same ``zt_huf_decode`` / ``zt_fse_decode`` entry point
   (an earlier version of the kernel); every source is built alone,
   checked against the plain version on each window and timed in turns
   (the baselines, the kernel twice, the baselines in reverse).

``capture_exec``, ``run_lanes``, ``exec_args``, ``lz_work`` and
``lz_corrupt_lanes`` serve the LZ executor kernel (``csrc/lz_exec.cu``),
which chip_smoke.py and the card tests check and time on the calls the
decode plane makes; ``capture_parse``, ``run_parse``, ``parse_lane``,
``parse_passes``, ``pass_cycles`` and ``parse_work`` serve the encode
plane's parse kernel (``csrc/lz_parse.cu``) the same way, and
``capture_assemble``, ``run_assemble``, ``assemble_lane``,
``assemble_passes`` and ``assemble_work`` its assembly kernel
(``csrc/assemble.cu``).

3. The parse kernel (``csrc/lz_parse.cu``) on the main path's calls of
   ``lz_parse.parse_lanes`` (``parse_windows``: the encode cell's first
   chunk [32, 16384], the 128 KB bucket's chunk and the 16 KB chunk's
   slowest lane alone), and each ``--parse-baseline``
   (another source of ``zt_lz_parse``): every source built alone,
   checked against the plain version and timed in turns (CUDA events
   through the raw launcher), with the SM cycles of each pass on the
   slowest lane and on the lane with the most sequences
   (``pass_cycles``).  ``--parse-only`` runs this part alone.
4. The assembly kernel (``csrc/assemble.cu``) on the main path's calls of
   ``assemble.assemble`` (``assemble_windows``: the encode cell's eight
   chunks [32, 16384] together, its first chunk, a 128 KB bucket's chunk
   and the first chunk's lane with the most sequences alone), and each
   ``--assemble-baseline`` (another source of ``zt_assemble``): every
   source built alone, checked against the plain version on every call
   and timed in turns (CUDA events through the raw launcher, and the
   profiler's device time), with the SM cycles of each pass
   (``assemble_passes``' passes, ``pass_cycles``).  ``--assemble-only``
   runs this part alone; ``--parse-only`` leaves it out.

5. The encode plane's host table builders (``tables_bench``): the plain
   Python builders (``device_encode._build_lit_tables_plain``,
   ``_build_seq_tables_plain``) and the native ones
   (``csrc/host_tables.cpp``, one call a chunk), each timed on the host
   (``perf_counter``) on the counts of one 32-lane chunk of each encode
   cell's payload (``TABLE_CELLS``, made by the benchmark's generator and
   parsed by the encode plane), in µs a lane, with their outputs checked
   equal.  ``--tables-only`` runs this part alone.

Prints what ``nvcc -Xptxas -v`` reports for each source built alone.
Every time is printed beside the card's name and power limit, and the
whole result goes to a JSON file (``--out``, by default
``build/kernel_bench.json``).  Needs a CUDA device and ``nvcc``; raises
without them.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from .ops import (assemble, device_encode, device_fse, device_huf, execseq,
                  lz_parse)

ROOT = Path(__file__).resolve().parent.parent
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA's data sheet
CORE_OPS_PER_S = 67e12      # float32 outside the tensor cores, the same
REC_SIZE = 24 << 10
N_RECORDS = 256


# ---------------------------------------------------------------------------
# bounds: the larger of bytes over the memory rate and operations over the
# core rate; bytes count each input read once and each output written once,
# and only what this run's data needs
# ---------------------------------------------------------------------------


def bound(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """(least ms, "bytes" or "operations")."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / CORE_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _live_words(pos: torch.Tensor, wb: int) -> torch.Tensor:
    return ((pos.long() + 31) >> 5).clamp(0, wb)


def fse_work(ops: dict, t_len: int) -> tuple[int, int]:
    """(bytes, operations) of one FSE decode call: the tables and live
    words of every lane with sequences, st and nseq, the three outputs;
    about 40 integer operations a sequence."""
    nl, wb = ops["words"].shape
    n = ops["nseq"].long().clamp(0, t_len)
    live = n > 0
    words = int(_live_words(ops["st"][:, 0], wb)[live].sum())
    n_bytes = (int(live.sum()) * 4 * (512 + 256 + 512) + 4 * words
               + nl * 4 * (8 + 1) + 3 * nl * t_len * 4)
    return n_bytes, 40 * int(n.sum())


def huf_work(ops: dict, t_len: int) -> tuple[int, int]:
    """(bytes, operations) of one Huffman decode call: the per-lane tables
    (limits, bases, offs, shifts, planes) and live words of every lane with
    symbols, pos and nsym, the output; about 20 operations a symbol."""
    nl, wb = ops["words"].shape
    n = ops["nsym"].long().clamp(0, t_len)
    live = n > 0
    words = int(_live_words(ops["pos"], wb)[live].sum())
    n_bytes = (int(live.sum()) * 4 * (4 * 16 + 64) + 4 * words + nl * 8
               + nl * t_len * 4)
    return n_bytes, 20 * int(n.sum())


def hist_work(data: torch.Tensor, mask=None) -> tuple[int, int]:
    """(bytes, operations) of one histogram call: every mask byte read, the
    data bytes read -- all of them unmasked, else only the 32-byte sectors
    that hold a kept position -- and 256 int32 counts per row written; two
    operations a position."""
    rows = data.shape[0] if data.dim() == 2 else 1
    n_bytes = data.numel()
    if mask is not None:
        lead = data.data_ptr() % 32
        kept = torch.zeros(-(-(lead + mask.numel()) // 32) * 32,
                           dtype=torch.bool, device=mask.device)
        kept[lead:lead + mask.numel()] = mask.reshape(-1)
        n_bytes = mask.numel() + 32 * int(kept.view(-1, 32).any(1).sum())
    return n_bytes + rows * 256 * 4, 2 * data.numel()


def lz_work(call) -> tuple[int, int]:
    """(bytes, operations) of one ``execseq.execute_lanes`` call (a
    ``capture_exec`` record), counted as the fused kernel reads and
    writes: each lane's live literals (its live ll and last_lit, at most
    O) from their source -- an int32 Huffman symbol, 4 bytes, a literal; a
    raw pool byte; an RLE lane's one byte --, 12 bytes a live sequence of
    a lane with sequence rows, the distinct window bytes its matches read
    (one row for a broadcast window), 96 bytes of meta, the O output bytes
    and the 4-byte flags written; about 4 operations an output byte below
    out_len and 24 a sequence (the walk and the flags' checks)."""
    lit, window, ll, ml, off, n_seq, last_lit, out_len, _ = exec_args(call)
    meta, src = call["meta"], call["src"]
    N, O = lit.shape
    W, S = window.shape[1], ll.shape[1]
    dev = lit.device
    n = n_seq.clamp(0, S)
    live = torch.arange(S, device=dev)[None, :] < n[:, None]
    lk = torch.where(live, ll.long(), 0).clamp(min=0)
    mk = torch.where(live, ml.long(), 0).clamp(min=0)
    lit_bytes = (lk.sum(1) + last_lit.clamp(min=0)).clamp(max=O)
    huf = (meta[:, 0] == 1) & (src.huf is not None)
    rle = ~huf & (meta[:, 2] == 1)
    lit_read = torch.where(huf, 4 * lit_bytes,
                           torch.where(rle, lit_bytes.clamp(max=1),
                                       lit_bytes))
    rows = (((meta[:, 5] == 1) & (src.fse is not None))
            | ((meta[:, 5] == 2) & (src.host is not None)))
    # the window bytes: the union of each lane's match sources below 0
    size = lk + mk
    ms = torch.cumsum(size, 1) - size + lk
    o = off.long().clamp(min=1)
    a = (W + ms - o).clamp(0, W)
    e = (W + ms - o + torch.minimum(mk, o)).clamp(0, W)
    shared = N > 1 and window.stride(0) == 0
    row = torch.zeros(N, S, dtype=torch.long, device=dev) if shared else \
        torch.arange(N, device=dev)[:, None].expand(N, S)
    keep = live & (e > a)
    marks = torch.zeros(1 if shared else N, W + 1, dtype=torch.long,
                        device=dev)
    marks.index_put_((row[keep], a[keep]), torch.ones_like(a[keep]),
                     accumulate=True)
    marks.index_put_((row[keep], e[keep]), -torch.ones_like(e[keep]),
                     accumulate=True)
    win_bytes = int((torch.cumsum(marks[:, :W], 1) > 0).sum())
    seqs = int(n.sum())
    n_bytes = (N * O + int(lit_read.sum()) + win_bytes
               + 12 * int(torch.where(rows, n, 0).sum()) + 100 * N)
    return n_bytes, 4 * int(out_len.clamp(0, O).sum()) + 24 * seqs


def capture_exec(run) -> list:
    """Call ``run()`` with the decode plane's ``execute_lanes`` recording
    each call: a dict of its arguments (meta, src, S, O, window,
    win_start, W, out, out_start), the tensors as passed (none is written
    after the call) except an output written in place (a multi-block
    round's accumulator), recorded as a copy taken before the call and
    recorded as the window too where it was one."""
    from .decode import device_pipeline as dp

    calls, real = [], dp.execute_lanes

    def spy(meta, src, S, O, window, win_start=None, W=None, out=None,
            out_start=None):
        snap = None if out is None else out.clone()
        calls.append({"meta": meta, "src": src, "S": S, "O": O,
                      "window": snap if window is out else window,
                      "win_start": win_start, "W": W, "out": snap,
                      "out_start": out_start})
        return real(meta, src, S, O, window, win_start, W, out, out_start)

    dp.execute_lanes = spy
    try:
        run()
    finally:
        dp.execute_lanes = real
    return calls


def run_lanes(call, fn=None):
    """`fn` (default ``execseq.execute_lanes``; ``execseq.lanes_plain``
    for the plain version) on a ``capture_exec`` record, an in-place
    output on a fresh copy of the record's: (rows or that output, the
    lanes' flags)."""
    fn = execseq.execute_lanes if fn is None else fn
    c = dict(call)
    if c["out"] is not None:
        acc = c["out"].clone()
        c["window"] = acc if call["window"] is call["out"] else c["window"]
        c["out"] = acc
    return fn(**c)


def exec_args(call) -> list:
    """``execseq.execute_plain``'s operands for all the lanes of a
    ``capture_exec`` record: ``execseq.assemble``'s, with each lane's
    window from its row (``execseq.lane_windows``) second."""
    lit, *ops = execseq.assemble(call["meta"], call["src"], call["S"],
                                 call["O"])
    window = call["window"]
    W = window.shape[1] if call["W"] is None else call["W"]
    return [lit, execseq.lane_windows(window, call["win_start"], W), *ops]


def lz_corrupt_lanes(rng, N: int, S: int, O: int, W: int, dev,
                     sources: str = "all", broadcast: bool = False) -> dict:
    """An ``execute_lanes`` call (a ``capture_exec`` record) no planner
    would make: random sources (a pool, Huffman rows of a random width T,
    FSE rows narrower than S, host rows; `sources` "all", or "raw" for the
    pool alone) with random bytes and int32 values (half of the sequence
    values small), and meta rows whose every column runs past both ends
    of what it indexes: literal kinds 0-2, pool_base and huf_lane0 past
    the pool and the rows, pool_len 0-2, huf_seg from -2 to O, seq kinds
    0-3, fse_lane and host_row past their rows, n_seq past S, lit_regen
    any, out_len up to O, win_len up to 2 W; windows of W bytes a lane, or
    with `broadcast` one row for every lane (stride 0)."""
    def i32(shape, mod):
        v = rng.integers(-2**31, 2**31, shape).astype(np.int32)
        return np.where(rng.random(shape) < 0.5, v % mod, v).astype(np.int32)

    n_raw = int(rng.integers(1, 3 * O))
    T = int(rng.integers(8, max(O // 2, 9)))
    n_huf = int(rng.integers(4, 40))
    n_fse, T_f = int(rng.integers(1, 9)), int(rng.integers(1, S + 1))
    n_host = int(rng.integers(1, 9))
    full = sources == "all"
    src = execseq.LaneSources(
        torch.from_numpy(rng.integers(0, 256, n_raw, dtype=np.uint8)),
        torch.from_numpy(i32(n_huf * T, 256)) if full else None, T,
        tuple(torch.from_numpy(i32((n_fse, T_f), m)) for m in
              (40, 60, 2 * O + W)) if full else None,
        tuple(torch.from_numpy(i32((n_host, S), m)) for m in
              (40, 60, 2 * O + W)) if full else None)
    cols = [rng.integers(0, 3, N), rng.integers(-10, n_raw + 50, N),
            rng.choice([0, 1, 1, 2, 500], N),
            rng.integers(-3, n_huf + 5, N), rng.integers(-2, O + 1, N),
            rng.integers(0, 4, N), rng.integers(-3, n_fse + 3, N),
            rng.integers(-3, n_host + 3, N), rng.integers(-3, S + 4, N),
            rng.integers(-2**40, 2**40, N), rng.integers(-5, O + 1, N),
            rng.integers(0, 2 * W + 1, N)]
    meta = torch.from_numpy(np.stack(cols, 1).astype(np.int64))
    src = execseq.LaneSources(*(
        t.to(dev) if isinstance(t, torch.Tensor) else
        tuple(r.to(dev) for r in t) if isinstance(t, tuple) else t
        for t in src))
    window = torch.from_numpy(rng.integers(
        0, 256, (1 if broadcast else N, W), dtype=np.uint8)).to(dev)
    return {"meta": meta.to(dev), "src": src, "S": S, "O": O,
            "window": window.expand(N, W), "win_start": None, "W": None,
            "out": None, "out_start": None}


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------


def capture_parse(run) -> list:
    """Call ``run()`` with ``lz_parse.parse_lanes`` recording each call: a
    dict of its arguments (blocks and n_valid as copies taken before the
    call, S, hash_log, u64_rounds, stride_rounds, compact)."""
    calls, real = [], lz_parse.parse_lanes

    def spy(blocks, n_valid, S, hash_log, u64_rounds, stride_rounds, *,
            compact, stamps=None):
        calls.append({"blocks": blocks.clone(), "n_valid": n_valid.clone(),
                      "S": S, "hash_log": hash_log, "u64_rounds": u64_rounds,
                      "stride_rounds": stride_rounds, "compact": compact})
        return real(blocks, n_valid, S, hash_log, u64_rounds, stride_rounds,
                    compact=compact, stamps=stamps)

    # the wrapper counts its launches on the module's parse_lanes, the spy
    # while it stands in
    spy.launches = real.launches
    lz_parse.parse_lanes = spy
    try:
        run()
    finally:
        lz_parse.parse_lanes = real
        real.launches = spy.launches
    return calls


def run_parse(call, fn=None) -> dict:
    """`fn` (default ``lz_parse.parse_lanes``; ``lz_parse.parse_plain`` for
    the plain version) on a ``capture_parse`` record."""
    fn = lz_parse.parse_lanes if fn is None else fn
    c = dict(call)
    return fn(c.pop("blocks"), c.pop("n_valid"), c.pop("S"),
              c.pop("hash_log"), c.pop("u64_rounds"), c.pop("stride_rounds"),
              **c)


def parse_lane(call, lane: int) -> dict:
    """Lane `lane` of a ``capture_parse`` record alone (the serial floor
    of the slowest lane: the kernel's time is then that lane's passes)."""
    c = dict(call)
    c["blocks"] = call["blocks"][lane:lane + 1].contiguous()
    c["n_valid"] = call["n_valid"][lane:lane + 1].contiguous()
    return c


PARSE_PASSES = ("setup", "previous_occurrence", "match_lengths", "selection",
                "outputs")


def pass_cycles(stamps: torch.Tensor, nseq: torch.Tensor,
                passes: tuple = PARSE_PASSES) -> dict:
    """The SM cycles of each pass (`passes`, one fewer than the stamps a
    lane) from a launch's clock stamps (int64 [B, len(passes) + 1]) and
    its nseq: on the lane whose launch took longest ("lane"), on the lane
    with the most sequences ("most_sequences_lane"), and the most any lane
    took in each pass ("max_cycles")."""
    d = (stamps[:, 1:] - stamps[:, :-1]).cpu()
    lane = int((stamps[:, -1] - stamps[:, 0]).argmax())
    most = int(nseq.argmax())
    return {"lane": lane,
            "lane_cycles": dict(zip(passes, d[lane].tolist())),
            "most_sequences_lane": most,
            "most_sequences": int(nseq[most]),
            "most_sequences_cycles": dict(zip(passes, d[most].tolist())),
            "max_cycles": dict(zip(passes, d.max(0).values.tolist()))}


def parse_passes(call) -> dict:
    """The SM cycles each pass of the parse kernel takes on a
    ``capture_parse`` record (clock64 stamps of thread 0 after each pass's
    barrier, ``parse_lanes(stamps=)``, after one warm-up launch), as
    ``pass_cycles`` gives them.  The passes are ``PARSE_PASSES``: the
    set-up (the cleared table and masks; a baseline source may count v32
    here), the previous occurrence (v32, hash groups and the table walk,
    overlapped), the match lengths along diagonals, the selection (jump
    bytes, the segments' walks and the stitching), and the outputs
    (offsets, covered, the literal permutation, the histograms)."""
    blocks = call["blocks"]
    stamps = torch.zeros(blocks.shape[0], 6, dtype=torch.int64,
                         device=blocks.device)
    run_parse(call)
    out = run_parse(call, lambda *a, **k: lz_parse.parse_lanes(
        *a, **k, stamps=stamps))
    return pass_cycles(stamps, out["nseq"])


def sm_clock_mhz() -> int:
    """The SM clock nvidia-smi reads now (MHz), to turn cycles into
    time."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                        "--format=csv,noheader,nounits", "-i", "0"],
                       capture_output=True, text=True, timeout=60)
    if r.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {r.stderr}")
    return int(r.stdout.strip())


def parse_work(call, out: dict) -> tuple[int, int]:
    """(bytes, operations) of one ``lz_parse.parse_lanes`` call (a
    ``capture_parse`` record) and its outputs `out`: each row's N bytes
    and its n_valid read once; covered (N bytes), starts/mls/offs (12 bytes
    a sequence slot) and nseq written, with ``compact`` also lit_sorted (N
    bytes), lit_count and the 121 code-histogram counts.  Operations, as
    this data needs them: about 20 a position that may start a match (its
    u32, hash, table step, candidate check, bitmask bit and place in the
    permutation), 10 a u32 compare of the extension rounds of each
    candidate that passes the 4-byte check -- counted as the match length
    over 4 plus 2 -- and 30 a selected sequence (the walk, the offset, the
    covered bits, the codes)."""
    blocks = call["blocks"]
    B, N = blocks.shape
    S = call["S"]
    n_bytes = 2 * B * N + 4 * B + 12 * B * S + 4 * B
    if call["compact"]:
        n_bytes += B * N + 4 * B + 4 * B * sum(b for _, b in
                                                lz_parse.HIST_BINS)
    nv = call["n_valid"].long()
    cnt = int((nv - 3).clamp(0, N).sum())
    nseq = out["nseq"].long()
    live = torch.arange(S, device=blocks.device)[None, :] < nseq[:, None]
    matched = int(torch.where(live, out["mls"].long(), 0).sum())
    ops = 20 * cnt + 10 * (matched // 4 + 2 * int(nseq.sum())) \
        + 30 * int(nseq.sum())
    return n_bytes, ops


ASSEMBLE_ARGS = ("blocks", "n_valid", "parsed", "lit_sorted", "lit_count",
                 "huf", "seq", "W", "WQ")


def capture_assemble(run) -> list:
    """Call ``run()`` with ``assemble.assemble`` (the dispatch that
    ``device_encode.encode_frames_device`` calls: the kernel on a card, the
    plain version on the CPU) recording each call: a dict of its
    arguments (``ASSEMBLE_ARGS``; tensors as copies, ``parsed`` with its
    four sequence keys only)."""
    calls, real = [], assemble.assemble

    def spy(*args):
        c = dict(zip(ASSEMBLE_ARGS, args))
        copy = {k: (v.clone() if isinstance(v, torch.Tensor) else v)
                for k, v in c.items() if k not in ("parsed", "huf", "seq")}
        copy["parsed"] = {k: c["parsed"][k].clone()
                          for k in ("starts", "mls", "offs", "nseq")}
        copy["huf"] = tuple(t.clone() for t in c["huf"])
        copy["seq"] = {k: (tuple(t.clone() for t in v)
                           if isinstance(v, tuple) else v.clone())
                       for k, v in c["seq"].items()}
        calls.append(copy)
        return real(*args)

    assemble.assemble = spy
    try:
        run()
    finally:
        assemble.assemble = real
    return calls


def run_assemble(call, fn=None):
    """`fn` (default ``assemble.assemble_lanes``; ``assemble.assemble_plain``
    for the plain version) on a ``capture_assemble`` record: (rows,
    out_len)."""
    fn = assemble.assemble_lanes if fn is None else fn
    return fn(*(call[k] for k in ASSEMBLE_ARGS))


def assemble_lane(call, lane: int) -> dict:
    """Lane `lane` of a ``capture_assemble`` record alone (the serial floor:
    the kernel's time is then that lane's chains and passes)."""
    def one(t):
        return t[lane:lane + 1].contiguous()

    c = dict(call)
    for k in ("blocks", "n_valid", "lit_sorted", "lit_count"):
        c[k] = one(call[k])
    c["parsed"] = {k: one(v) for k, v in call["parsed"].items()}
    c["huf"] = tuple(one(t) for t in call["huf"])
    c["seq"] = {k: (tuple(one(t) for t in v) if isinstance(v, tuple)
                    else one(v)) for k, v in call["seq"].items()}
    return c


# the assembly kernel's passes, between its clock stamps
ASSEMBLE_PASSES = ("tables", "codes", "chains", "widths_scan", "fixed_bytes",
                   "bitstreams", "cut_streams", "row_out")


def assemble_passes(call) -> dict:
    """The SM cycles each pass of the assembly kernel takes on a
    ``capture_assemble`` record (clock64 stamps of thread 0 after each
    pass's barrier, ``assemble_lanes(stamps=)``, after one warm-up
    launch), as ``pass_cycles`` gives them.  The passes are
    ``ASSEMBLE_PASSES``: the lane's tables into shared memory and the row
    cleared, the values and codes, the three state chains (with the
    Huffman quarters' widths), the sequences' widths and the block scan,
    the sizes and the fixed-form bytes, the bitstreams, the streams cut at
    their capacity, and the row out."""
    stamps = torch.zeros(call["blocks"].shape[0], assemble.STAMPS,
                         dtype=torch.int64, device=call["blocks"].device)
    run_assemble(call)
    run_assemble(call, lambda *a: assemble.assemble_lanes(*a, stamps=stamps))
    return pass_cycles(stamps, call["parsed"]["nseq"], ASSEMBLE_PASSES)


def assemble_work(call, out) -> tuple[int, int]:
    """(bytes, operations) of one ``assemble.assemble_lanes`` call (a
    ``capture_assemble`` record) and its outputs `out` (rows, out_len),
    counted as the kernel reads and writes for this data: the rows and
    out_len written; a lane's lit_count literals where it sizes the
    Huffman streams (a Huffman table and a sequence) or copies raw
    literals (a compressed block), its n_valid record bytes where it is a
    raw block (out_len = 12 + n_valid), 12 bytes a live sequence (starts,
    mls, offs), every lane's FSE tables (maps, nbs, init, flush) and
    Huffman codes and widths, the descriptor bytes of a Huffman section,
    the table area of a compressed block, seven scalars a lane and the
    281-entry LUT once.  Operations: about 40 a live sequence (its values
    and codes, three chain steps, six fields masked, shifted and ORed), 10
    a literal read (its Huffman width and field, or its copy) and one a row
    byte (cleared, masked, stored)."""
    blocks = call["blocks"]
    B, N = blocks.shape
    S = call["parsed"]["starts"].shape[1]
    rows, out_len = out
    codes, nbits, _, dlen, ok = call["huf"]
    seq = call["seq"]
    ns_raw = call["parsed"]["nseq"].long()
    ns = ns_raw.clamp(0, S)
    nv = call["n_valid"].long().clamp(0, N)
    lc = call["lit_count"].long().clamp(0, N)
    raw = out_len.long() == 12 + call["n_valid"].long()
    huf = ~raw & ((rows[:, 12].long() & 3) == 2)
    lits = torch.where((ok & (ns_raw > 0)) | ~raw, lc, 0)
    tables = [t for name in assemble.STREAMS for t in seq[name]]
    n_bytes = (rows.numel() + 4 * B + int(lits.sum())
               + int(torch.where(raw, nv, 0).sum()) + 12 * int(ns.sum())
               + sum(t.numel() * t.element_size()
                     for t in (*tables, codes, nbits))
               + int(torch.where(huf, dlen.long(), 0).sum())
               + int(torch.where(raw, 0, seq["tbl_len"].long()).sum())
               + 25 * B + 4 * 281)
    return n_bytes, 40 * int(ns.sum()) + 10 * int(lits.sum()) + rows.numel()


def card() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader", "-i", "0"],
                       capture_output=True, text=True, timeout=60)
    if r.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {r.stderr}")
    return r.stdout.strip()


def event_ms(fn, reps: int = 20) -> float:
    """Mean ms per call over `reps` calls between two CUDA events, after
    one warm-up call."""
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def host_ms(fn, reps: int = 200) -> float:
    """Host time per call to enqueue `fn` (perf_counter over `reps` calls,
    the card's own time not waited for), after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    return t


def device_ms(fn, reps: int = 20, names=None) -> float:
    """Device time per call: the sum of the device events torch.profiler
    records over `reps` calls, after one warm-up call; only the events
    whose name holds one of `names`, when given.  A session in which the
    profiler recorded no such event (it happens, rarely) is run again, up
    to three times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events()
                  if e.device_type == DeviceType.CUDA
                  and (names is None or any(k in e.name for k in names))]
        if events:
            return sum(e.time_range.elapsed_us() for e in events) / reps / 1e3
    raise RuntimeError("the profiler recorded no device event")


# ---------------------------------------------------------------------------
# the FSE kernel
# ---------------------------------------------------------------------------


def _build_variant(src: Path, out: Path) -> tuple[ctypes.CDLL, list]:
    """nvcc `src` alone into `out`; returns the library (its
    ``zt_fse_decode``, ``zt_huf_decode``, ``zt_lz_parse`` or
    ``zt_assemble`` declared, whichever it has) and the ptxas lines of
    its log."""
    from . import _build

    out.parent.mkdir(parents=True, exist_ok=True)
    obj = out.with_suffix(".o")
    log = _build._run_all([[_build._nvcc(), *_build.NVCC_FLAGS,
                            "-c", "-o", str(obj), str(src)]])
    log += _build._run_all([[_build._nvcc(), "-shared", "-o", str(out),
                             str(obj)]])
    lib = ctypes.CDLL(str(out))
    p, i = ctypes.c_void_p, ctypes.c_int
    for name in ("zt_fse_decode", "zt_huf_decode"):
        if hasattr(lib, name):
            getattr(lib, name).restype = i
            getattr(lib, name).argtypes = [p, i, p, p, p, p, p, p, p, p, i, i,
                                           p]
    if hasattr(lib, "zt_lz_parse"):
        lib.zt_lz_parse.restype = i
        lib.zt_lz_parse.argtypes = [p, p, i, i, i, i, i, i] + [p] * 15
    if hasattr(lib, "zt_assemble"):
        lib.zt_assemble.restype = i
        lib.zt_assemble.argtypes = [p] * 32 + [i] * 13 + [p, p]
        lib.zt_assemble_scratch.restype = ctypes.c_longlong
        lib.zt_assemble_scratch.argtypes = [i] * 8
    return lib, [ln.strip() for ln in log.splitlines()
                 if "ptxas" in ln or "spill" in ln]


def _build_all(kernel: str, others: list) -> tuple[dict, dict]:
    """Build `others` ((name, source) pairs) and csrc/<kernel>.cu, each
    alone: ({name: library}, {name: ptxas register/spill lines})."""
    from . import _build

    libs, ptxas = {}, {}
    for name, src in others + [("kernel", _build.CSRC / f"{kernel}.cu")]:
        libs[name], log = _build_variant(
            src, ROOT / "build" / "ab" / f"lib{kernel}_{name}.so")
        ptxas[name] = [ln for ln in log if "Used" in ln or "spill" in ln
                       or "stack" in ln]
        print(f"{name} ({src}) ptxas: {ptxas[name]}")
    return libs, ptxas


def launcher(lib, kernel: str, ops: dict):
    """A call of `lib`'s ``zt_<kernel>`` on `ops` into preallocated outputs
    (the wrapper's host work left out), and those outputs."""
    mod, n_out = KERNELS[kernel][:2]
    nl, wb = ops["words"].shape
    t_len = mod.bucket_t(int(ops["t_max"]))
    outs = [torch.empty(nl, t_len, dtype=torch.int32,
                        device=ops["words"].device) for _ in range(n_out)]
    args = [ops[k].data_ptr() for k in mod._OPERANDS]
    stream = torch.cuda.current_stream().cuda_stream
    fn = getattr(lib, f"zt_{kernel}")

    def run():
        rc = fn(args[0], wb, *args[1:], *(o.data_ptr() for o in outs), nl,
                t_len, stream)
        if rc:
            raise RuntimeError(f"zt_{kernel}: cudaError_t {rc}")
    return run, outs


def one_lane(ops: dict, lane: int, count: str) -> dict:
    """Lane `lane` of a window alone, its T bucket set by its own count
    (`count`: "nsym" or "nseq")."""
    out = {k: (v if k == "t_max" else v[lane:lane + 1].clone())
           for k, v in ops.items()}
    out["t_max"] = int(ops[count][lane])
    return out


# kernel -> (its wrapper module, outputs, planner window, count operand,
# what it counts, its work)
KERNELS = {
    "huf_decode": (device_huf, 1, "huf_ops", "nsym", "symbol", huf_work),
    "fse_decode": (device_fse, 3, "fse_ops", "nseq", "sequence", fse_work),
}


def kernel_ab(kernel: str, windows: dict, others: list) -> dict:
    """csrc/<kernel>.cu and `others` ((name, source) pairs of the same
    entry point, e.g. an earlier version), each built alone, checked
    against the plain version on each of `windows` ({name: operands}) and
    timed in turns: the others in order, the kernel twice, the others in
    reverse.  For each the longest lane's time per item follows from the
    ``longest_lane`` window."""
    mod, _, _, count, unit, work = KERNELS[kernel]
    libs, ptxas = _build_all(kernel, others)
    res = {"windows": {}, "ptxas": ptxas}
    order = [n for n, _ in others]
    turns = order + ["kernel", "kernel"] + order[::-1]
    for wname, ops in windows.items():
        nl, wb = ops["words"].shape
        t_len = mod.bucket_t(int(ops["t_max"]))
        want = mod.decode_plain(*(ops[k] for k in mod._OPERANDS), t_len)
        want = want if isinstance(want, tuple) else (want,)
        row = {"shape": [nl, wb, t_len], f"{count}_max": int(ops[count].max()),
               f"{unit}s": int(ops[count].clamp(min=0).sum())}
        runs = {}
        for name, lib in libs.items():
            run, outs = launcher(lib, kernel, ops)
            run()
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(outs, want)):
                raise RuntimeError(f"{kernel} {wname}: {name} differs from "
                                   "plain")
            runs[name] = run
        for name in turns:
            row.setdefault(f"{name}_ms", []).append(event_ms(runs[name], 20))
        n_bytes, n_ops = work(ops, t_len)
        row["bound_ms"], row["bound_by"] = bound(n_bytes, n_ops)
        row["bytes"] = n_bytes
        for name in libs:
            row[f"{name}_ns_per_{unit}_of_longest"] = (
                min(row[f"{name}_ms"]) * 1e6 / max(row[f"{count}_max"], 1))
        res["windows"][wname] = row
        times = "; ".join(f"{n} ms {row[n + '_ms']}" for n in libs)
        per = ", ".join(f"{n} {row[f'{n}_ns_per_{unit}_of_longest']:.1f}"
                        for n in libs)
        print(f"{kernel} {wname} {row['shape']}: all equal plain; {times}; "
              f"bound {row['bound_ms']:.5f} ms ({row['bound_by']}, {n_bytes}"
              f" B); longest lane {row[f'{count}_max']} {unit}s, ns each: "
              f"{per}")
    return res


def decode_windows(data: bytes, dev) -> dict:
    """Each decode kernel's windows: the main path's (the bench's 256 x 24
    KB records at level 9), a larger Wb bucket (256 x 48 KB records), and
    the main window's longest lane alone.  {kernel: {name: operands}}."""
    from .decode import device_pipeline as dp
    from .encode.frame import compress

    plans = [dp.plan_batch([compress(data[i:i + size], 9)
                            for i in range(0, N_RECORDS * size, size)])
             for size in (REC_SIZE, 2 * REC_SIZE)]
    out = {}
    for kernel, (_, _, ops_of, count, _, _) in KERNELS.items():
        main, big = (dp.ops_to_device(getattr(p.nb, ops_of)(0), dev)
                     for p in plans)
        longest = int(torch.argmax(main[count]))
        out[kernel] = {"main": main, f"wb{big['words'].shape[1]}": big,
                       "longest_lane": one_lane(main, longest, count)}
    for p in plans:
        dp._release_ops(p.nb, None)
    return out


# ---------------------------------------------------------------------------
# the histogram kernel: A/B against earlier sources, its launch floor, and
# torch.bincount
# ---------------------------------------------------------------------------

# (cs, cpr) configurations timed beside the wrapper's plan, by input
_CLUSTERS = [(1, 1), (2, 1), (4, 1), (8, 1)]
HIST_CONFIGS = {"literal_rows_masked": _CLUSTERS,
                "literal_rows_128KB_masked": _CLUSTERS,
                "parse_stats_rows": _CLUSTERS + [(8, 2), (8, 4), (8, 8)],
                "text_rows_128KB": _CLUSTERS + [(8, 2), (8, 4)],
                "vector_4MB": [(8, 1), (8, 9), (8, 17), (8, 33), (8, 65),
                               (1, 264)]}


def _hist_lib(lib) -> str:
    """Declare `lib`'s histogram entry points: "cluster" for this
    repository's kernel (zt_histogram fills every bin; zt_histogram_floor
    beside it), "atomic" for the earlier adding kernel (out zeroed by the
    caller)."""
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.zt_histogram.restype = i
    if hasattr(lib, "zt_histogram_floor"):
        lib.zt_histogram.argtypes = [p, p, i, ll, p, p, i, i, p]
        lib.zt_histogram_floor.restype = i
        lib.zt_histogram_floor.argtypes = [i, i, i, p]
        return "cluster"
    lib.zt_histogram.argtypes = [p, p, i, ll, p, p]
    return "atomic"


def hist_launcher(lib, data: torch.Tensor, mask=None, config=None):
    """A call of `lib`'s ``zt_histogram`` on `data` (and `mask`) into a
    preallocated output (the wrapper's host work left out), the output,
    and the (cs, cpr) it launches with: the wrapper's plan unless `config`
    is given.  The earlier adding kernel adds into its output, which the
    call does not zero: its counts are right only after
    ``out.zero_()``."""
    from .ops import histogram as hg

    b, n = (1, data.shape[0]) if data.dim() == 1 else tuple(data.shape)
    dev = data.device
    out = torch.empty(b, 256, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    mptr = mask.data_ptr() if mask is not None else None
    if _hist_lib(lib) == "atomic":
        def run():
            rc = lib.zt_histogram(data.data_ptr(), mptr, b, n,
                                  out.data_ptr(), stream)
            if rc:
                raise RuntimeError(f"zt_histogram: cudaError_t {rc}")
        return run, out, None
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    cs, cpr = config or hg.plan(b, n, sms, mask is not None)
    scratch = torch.empty(b, cpr, 256, dtype=torch.int32, device=dev)

    def run():
        rc = lib.zt_histogram(data.data_ptr(), mptr, b, n, out.data_ptr(),
                              scratch.data_ptr(), cs, cpr, stream)
        if rc:
            raise RuntimeError(f"zt_histogram: cudaError_t {rc}")
    return run, out, (cs, cpr)


def hist_floor(lib, b: int, cs: int, cpr: int):
    """A call of ``zt_histogram_floor``: empty kernels of the histogram's
    grid, cluster shape and block size."""
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        rc = lib.zt_histogram_floor(b, cs, cpr, stream)
        if rc:
            raise RuntimeError(f"zt_histogram_floor: cudaError_t {rc}")
    return run


def _literal_rows(data: bytes, n: int, dev):
    """The encoder's literal rows of the first 32 records of `n` bytes
    (the parse phase's sorted literals) and their prefix masks."""
    from .encode.device_pipeline import LANES
    from .ops import device_encode as de

    blocks = np.frombuffer(data[:LANES * n], np.uint8).reshape(LANES, n)
    nv = torch.full((LANES,), n, dtype=torch.int32, device=dev)
    _, rows, count, _, _ = de._parse_phase(
        torch.from_numpy(blocks.copy()).to(dev), nv, de.seq_budget(n), 15)
    return (rows.contiguous(),
            torch.arange(n, device=dev)[None, :] < count[:, None].long())


def _parse_stats_rows(dev):
    """``parse_block_stats``'s histogram operands in ``graft_entry.entry``:
    its 4 blocks of 32 KiB and the mask of their uncovered valid bytes,
    made as parse_block_stats makes them."""
    from .graft_entry import entry
    from .ops.matcher import parse_block

    _, (blocks, n_valid) = entry(dev)
    r = parse_block(blocks, n_valid, 15)
    n = blocks.shape[-1]
    mask = (~r["covered"]) & (torch.arange(n, device=dev)
                              < n_valid.to(torch.int64)[..., None])
    return blocks.contiguous(), mask


def hist_inputs(data: bytes, dev) -> dict:
    """{name: (rows, mask)}: the main path's masked shapes (the encoder's
    literal rows of 16 KB and 128 KB records, parse_block_stats's rows),
    then dense text rows of 128 KB, 32 rows of one byte value, 32 rows of
    ``b"ab" * 8192`` and the 4 MB + 1 vector, these four unmasked."""
    from .encode.device_pipeline import LANES

    n = 16 << 10
    vec = torch.from_numpy(np.frombuffer(data[:(4 << 20) + 1], np.uint8)
                           .copy()).to(dev)
    text = np.frombuffer(data[:LANES << 17], np.uint8).reshape(LANES, -1)
    ab = torch.from_numpy(np.frombuffer(b"ab" * (n // 2), np.uint8).copy())
    return {"literal_rows_masked": _literal_rows(data, n, dev),
            "literal_rows_128KB_masked": _literal_rows(data, 128 << 10, dev),
            "parse_stats_rows": _parse_stats_rows(dev),
            "text_rows_128KB": (torch.from_numpy(text.copy()).to(dev), None),
            "one_byte_rows": (torch.full((LANES, n), 0x20, dtype=torch.uint8,
                                         device=dev), None),
            "ab_rows": (ab.to(dev).repeat(LANES, 1), None),
            "vector_4MB": (vec, None)}


def _bincount(rows, mask):
    """torch.bincount over the rows (the mask as weights): one call, the
    sum of the rows' histograms."""
    flat = rows.reshape(-1)
    if mask is None:
        return lambda: torch.bincount(flat, minlength=256)
    weights = mask.reshape(-1).to(torch.float32)
    return lambda: torch.bincount(flat, weights=weights, minlength=256)


_HIST_KERNELS = ("histogram_kernel", "reduce_kernel")


def hist_ab(data: bytes, dev, others: list) -> dict:
    """csrc/histogram.cu and `others` ((name, source) pairs: an
    earlier kernel or another version of the same entry point), each built
    alone, checked against the plain
    version on every input of ``hist_inputs`` and timed in turns (the
    others, the kernel twice, the others in reverse): device ms of the
    histogram's own kernels (torch.profiler), events ms of the raw
    launcher (an adding kernel with and without the fill its output
    needs), the launch floor, the wrapper, torch.bincount, and the
    (cs, cpr) sweep of HIST_CONFIGS."""
    from . import _build
    from .ops import histogram as hg

    src = _build.CSRC / "histogram.cu"
    libs, ptxas = {}, {}
    for name, path in others + [("kernel", src)]:
        libs[name], log = _build_variant(
            path, ROOT / "build" / "ab" / f"libhistogram_{name}.so")
        ptxas[name] = [ln for ln in log if "Used" in ln or "spill" in ln
                       or "stack" in ln]
        print(f"histogram {name} ({path}) ptxas: {ptxas[name]}")
    order = [n for n, _ in others]
    turns = order + ["kernel", "kernel"] + order[::-1]
    res = {"inputs": {}, "configs": {}, "ptxas": ptxas}
    for iname, (rows, mask) in hist_inputs(data, dev).items():
        want = hg.histogram_plain(rows, mask).reshape(-1, 256)
        b = want.shape[0]
        row = {"shape": list(rows.shape), "masked": mask is not None,
               "kept": int(mask.sum()) if mask is not None else rows.numel()}
        runs = {}
        for name, lib in libs.items():
            run, out, cfg = hist_launcher(lib, rows, mask)
            if cfg is None:         # an adding kernel: zero first, then add
                runs[f"{name}_with_fill"] = (
                    lambda run=run, out=out: (out.zero_(), run()))
            runs[name] = run
            (runs.get(f"{name}_with_fill") or run)()
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                raise RuntimeError(f"histogram {iname}: {name} differs from "
                                   "plain")
            row["config"] = row.get("config") or cfg
        for name in turns:
            for key in [k for k in runs if k == name
                        or k == f"{name}_with_fill"]:
                row.setdefault(f"{key}_event_ms", []).append(
                    event_ms(runs[key]))
                row.setdefault(f"{key}_device_ms", []).append(
                    device_ms(runs[key], names=_HIST_KERNELS))
        floor = hist_floor(libs["kernel"], b, *row["config"])
        row["launch_floor_event_ms"] = event_ms(floor)
        row["launch_floor_device_ms"] = device_ms(floor)
        row["wrapper_event_ms"] = event_ms(lambda: hg.histogram_u8(rows,
                                                                   mask))
        row["wrapper_host_ms"] = host_ms(lambda: hg.histogram_u8(rows, mask))
        row["launcher_host_ms"] = host_ms(runs["kernel"])
        lib_fn = _bincount(rows, mask)
        if not torch.equal(lib_fn().long(), want.sum(0).long()):
            raise RuntimeError(f"histogram {iname}: bincount differs")
        row["bincount_event_ms"] = event_ms(lib_fn)
        row["bincount_device_ms"] = device_ms(lib_fn)
        row["bytes"], n_ops = hist_work(rows, mask)
        row["bound_ms"], row["bound_by"] = bound(row["bytes"], n_ops)
        res["inputs"][iname] = row
        print(f"histogram {iname} {row['shape']} kept {row['kept']} config "
              f"{row['config']} bytes {row['bytes']}: "
              + "; ".join(f"{k} {v}" for k, v in row.items()
                          if k.endswith("_ms")))
        for cs, cpr in HIST_CONFIGS.get(iname, []):
            run, out, _ = hist_launcher(libs["kernel"], rows, mask,
                                        (cs, cpr))
            run()
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                raise RuntimeError(f"histogram {iname} at cs {cs} cpr {cpr}"
                                   " differs from plain")
            c = {"device_ms": device_ms(run, names=_HIST_KERNELS),
                 "event_ms": event_ms(run),
                 "floor_device_ms": device_ms(hist_floor(libs["kernel"], b,
                                                         cs, cpr))}
            res["configs"][f"{iname} cs{cs} cpr{cpr}"] = c
            print(f"histogram {iname} cs {cs} cpr {cpr}: {c}")
    return res


def parse_launcher(lib, call, stamps=None):
    """A call of `lib`'s ``zt_lz_parse`` on a ``capture_parse`` record
    into preallocated outputs, the arguments ``lz_parse.parse_lanes``
    passes: (run, the outputs as ``parse_lanes`` returns them)."""
    out, args, keep = lz_parse.launch_args(
        call["blocks"], call["n_valid"], call["S"], call["hash_log"],
        call["u64_rounds"], call["stride_rounds"], call["compact"], stamps)
    stream = torch.cuda.current_stream(call["blocks"].device).cuda_stream

    def run():
        rc = lib.zt_lz_parse(*args, stream)
        if rc:
            raise RuntimeError(f"zt_lz_parse: cudaError_t {rc}")
    run.keep = keep
    return run, out


def parse_windows(data: bytes, dev) -> dict:
    """The parse kernel's main-path calls: the encode cell's first chunk
    (32 records of 16 KB of `data`), the 128 KB bucket's chunk (32
    records of 128 KB) and the 16 KB chunk's slowest lane (by its clock
    stamps) alone, as ``capture_parse`` records."""
    from .encode.device_pipeline import compress_batch_device

    recs = [data[i:i + (16 << 10)] for i in range(0, 32 << 14, 16 << 10)]
    big = [data[i:i + (128 << 10)] for i in range(0, 32 << 17, 128 << 10)]
    calls = capture_parse(lambda: compress_batch_device(recs + big,
                                                        device=dev))
    lane = parse_passes(calls[0])["lane"]
    return {"chunk_16KB": calls[0], "chunk_128KB": calls[1],
            "slowest_lane_16KB": parse_lane(calls[0], lane)}


def parse_ab(data: bytes, dev, others: list) -> dict:
    """csrc/lz_parse.cu and `others` ((name, source) pairs of the same
    entry point), each built alone, checked against the plain version on
    each of ``parse_windows`` and timed in turns (the others, the kernel
    twice, the others in reverse): CUDA events over 20 calls of the raw
    launcher, and the SM cycles of each pass on the slowest lane and on the
    lane with the most sequences (clock64 stamps, ``pass_cycles``)."""
    libs, ptxas = _build_all("lz_parse", others)
    res = {"windows": {}, "ptxas": ptxas}
    order = [n for n, _ in others]
    turns = order + ["kernel", "kernel"] + order[::-1]
    for wname, call in parse_windows(data, dev).items():
        want = run_parse(call, lz_parse.parse_plain)
        row = {"shape": list(call["blocks"].shape),
               "nseq_max": int(want["nseq"].max())}
        runs, stamps = {}, {}
        for name, lib in libs.items():
            st = torch.zeros(call["blocks"].shape[0], 6, dtype=torch.int64,
                             device=dev)
            run, outs = parse_launcher(lib, call)
            run()
            srun, _ = parse_launcher(lib, call, st)
            srun()
            torch.cuda.synchronize()
            if not all(torch.equal(outs[k], want[k]) for k in want):
                raise RuntimeError(f"lz_parse {wname}: {name} differs from "
                                   "plain")
            runs[name] = run
            stamps[name] = pass_cycles(st, want["nseq"])
        for name in turns:
            row.setdefault(f"{name}_ms", []).append(event_ms(runs[name], 20))
        row["pass_cycles"] = stamps
        row["bound_ms"], row["bound_by"] = bound(*parse_work(call, want))
        res["windows"][wname] = row
        times = "; ".join(f"{n} ms {row[n + '_ms']}" for n in libs)
        print(f"lz_parse {wname} {row['shape']}: all equal plain; {times}; "
              f"bound {row['bound_ms']:.5f} ms ({row['bound_by']}); "
              f"cycles by pass on the slowest lane and on the lane with the "
              f"most sequences {stamps}")
    res["sm_clock_mhz"] = sm_clock_mhz()
    return res


def assemble_launcher(lib, call, stamps=None):
    """A call of `lib`'s ``zt_assemble`` on a ``capture_assemble`` record
    into preallocated outputs, the arguments ``assemble.assemble_lanes``
    passes: (run, (rows, out_len))."""
    out, args, keep = assemble.launch_args(
        *(call[k] for k in ASSEMBLE_ARGS), stamps, lib)
    stream = torch.cuda.current_stream(call["blocks"].device).cuda_stream

    def run():
        rc = lib.zt_assemble(*args, stream)
        if rc:
            raise RuntimeError(f"zt_assemble: cudaError_t {rc}")
    run.keep = keep
    return run, out


def assemble_windows(data: bytes, dev) -> dict:
    """The assembly kernel's main-path calls, as ``capture_assemble``
    records: the encode cell's eight chunks (256 records of 16 KB of
    `data`, "encode_8_chunks", a list), its first chunk, a 128 KB
    bucket's chunk (32 records of 128 KB) and the first chunk's lane with
    the most sequences alone."""
    from .encode.device_pipeline import compress_batch_device

    recs = [data[i:i + (16 << 10)] for i in range(0, 256 << 14, 16 << 10)]
    big = [data[i:i + (128 << 10)] for i in range(0, 32 << 17, 128 << 10)]
    calls = capture_assemble(lambda: compress_batch_device(recs + big,
                                                           device=dev))
    small = [c for c in calls if c["blocks"].shape[1] == 16 << 10]
    lane = int(small[0]["parsed"]["nseq"].argmax())
    return {"encode_8_chunks": small, "chunk_16KB": small[0],
            "chunk_128KB": next(c for c in calls
                                if c["blocks"].shape[1] == 128 << 10),
            "most_sequences_lane_16KB": assemble_lane(small[0], lane)}


def assemble_ab(data: bytes, dev, others: list) -> dict:
    """csrc/assemble.cu and `others` ((name, source) pairs of the same
    entry point), each built alone, checked against the plain version
    (rows and out_len) on every call of ``assemble_windows`` and timed in
    turns (the others, the kernel twice, the others in reverse): CUDA
    events over 20 runs of the raw launcher (the eight chunks' window runs
    all eight), the profiler's device time of the same, and the SM cycles
    of each pass (clock64 stamps, ``pass_cycles``)."""
    libs, ptxas = _build_all("assemble", others)
    res = {"windows": {}, "ptxas": ptxas}
    order = [n for n, _ in others]
    turns = order + ["kernel", "kernel"] + order[::-1]
    for wname, window in assemble_windows(data, dev).items():
        calls = window if isinstance(window, list) else [window]
        wants = [run_assemble(c, assemble.assemble_plain) for c in calls]
        row = {"shape": list(calls[0]["blocks"].shape),
               "launches": len(calls),
               "nseq_max": max(int(c["parsed"]["nseq"].max())
                               for c in calls)}
        runs, stamps = {}, {}
        for name, lib in libs.items():
            st = torch.zeros(calls[0]["blocks"].shape[0], assemble.STAMPS,
                             dtype=torch.int64, device=dev)
            ones = []
            for c, want in zip(calls, wants):
                run, outs = assemble_launcher(lib, c)
                run()
                torch.cuda.synchronize()
                if not all(torch.equal(g, w) for g, w in zip(outs, want)):
                    raise RuntimeError(f"assemble {wname}: {name} differs "
                                       "from plain")
                ones.append(run)
            srun, _ = assemble_launcher(lib, calls[0], st)
            srun()
            torch.cuda.synchronize()
            runs[name] = (lambda rs: lambda: [r() for r in rs])(ones)
            stamps[name] = pass_cycles(st, calls[0]["parsed"]["nseq"],
                                       ASSEMBLE_PASSES)
        for name in turns:
            row.setdefault(f"{name}_ms", []).append(event_ms(runs[name], 20))
            row.setdefault(f"{name}_device_ms", []).append(
                device_ms(runs[name], 20, ("assemble_kernel",)))
        row["pass_cycles"] = stamps
        n_bytes, n_ops = map(sum, zip(*(assemble_work(c, w)
                                        for c, w in zip(calls, wants))))
        row["bound_ms"], row["bound_by"] = bound(n_bytes, n_ops)
        res["windows"][wname] = row
        times = "; ".join(f"{n} ms {row[n + '_ms']} device "
                          f"{row[n + '_device_ms']}" for n in libs)
        print(f"assemble {wname} {row['shape']} x {len(calls)}: all equal "
              f"plain; {times}; bound {row['bound_ms']:.6f} ms "
              f"({row['bound_by']}); cycles by pass on the slowest lane and "
              f"on the lane with the most sequences {stamps}")
    res["sm_clock_mhz"] = sm_clock_mhz()
    return res


# (cell, configuration, traffic) of the encode cells in BENCHMARK.json
TABLE_CELLS = (("kafka16k.produce", "kafka_zstd_batch16k",
                "encode_1024x45k-60k"),
               ("zfs128k.write", "openzfs_zstd_rec128k", "encode_256x128k"))


def table_counts(config: str, traffic: str, seed: int, dev) -> tuple:
    """The counts the table builders take for the first 32-lane chunk of
    an encode cell's payload: (lit_hist, lit_count, (ll, of, ml) code
    histograms, nseq), as ``encode_frames_device`` passes them."""
    sys.path.insert(0, str(ROOT))
    from benchmark.gen import make_batches

    from .encode.device_pipeline import compress_batch_device

    bench = ROOT / "benchmark"
    cfg = json.loads((bench / "configs" / f"{config}.json").read_text())
    mix = json.loads((bench / "traffic" / f"{traffic}.json").read_text())
    mix.update(pool_batches=1, records=32)
    seen = {}
    lit, seq = device_encode._build_lit_tables, device_encode._build_seq_tables

    def lit_spy(*a):
        seen.setdefault("lit", a)
        return lit(*a)

    def seq_spy(*a):
        seen.setdefault("seq", a)
        return seq(*a)

    device_encode._build_lit_tables = lit_spy
    device_encode._build_seq_tables = seq_spy
    try:
        compress_batch_device(make_batches(cfg, mix, seed)[0], False,
                              int(cfg["hash_log"]), device=dev)
    finally:
        device_encode._build_lit_tables = lit
        device_encode._build_seq_tables = seq
    (lit_hist, lit_count), (hists, nseq, _) = seen["lit"], seen["seq"]
    return lit_hist, lit_count, hists, nseq


def _host_us(fn, reps: int) -> float:
    """Mean host µs a call over `reps` calls, after one warm-up call."""
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e6


def tables_bench(dev, seed: int = 4419000332, reps: int = 200) -> dict:
    """The plain and the native table builders on the counts of one chunk
    of each encode cell (``TABLE_CELLS``), in µs a lane: the plain ones
    over 3 calls, the native ones over `reps`; every output of the two
    checked equal first."""
    de, t = device_encode, device_encode._tables()
    res = {}
    for cell, config, traffic in TABLE_CELLS:
        lit_hist, lit_count, hists, nseq = table_counts(config, traffic,
                                                        seed, dev)
        B = lit_hist.shape[0]
        got = de._build_lit_tables(lit_hist, lit_count)
        want = de._build_lit_tables_plain(lit_hist, lit_count)
        sgot = de._build_seq_tables(hists, nseq, t)
        swant = de._build_seq_tables_plain(hists, nseq, t)
        same = (all(np.array_equal(g, w) for g, w in zip(got, want))
                and all(np.array_equal(g, w) for n in ("ll", "of", "ml")
                        for g, w in zip(sgot[0][n], swant[0][n]))
                and all(np.array_equal(g, w)
                        for g, w in zip(sgot[1:], swant[1:])))
        if not same:
            raise RuntimeError(f"tables {cell}: native differs from plain")
        row = {"lanes": B, "huf_lanes": int(got[4].sum()),
               "literals": int(np.sum(lit_count)),
               "sequences": int(np.sum(nseq))}
        for kind, plain, native, args in (
                ("lit", de._build_lit_tables_plain, de._build_lit_tables,
                 (lit_hist, lit_count)),
                ("seq", de._build_seq_tables_plain, de._build_seq_tables,
                 (hists, nseq, t))):
            p = _host_us(lambda: plain(*args), 3) / B
            n = _host_us(lambda: native(*args), reps) / B
            row[f"{kind}_plain_us_a_lane"] = p
            row[f"{kind}_native_us_a_lane"] = n
            row[f"{kind}_speedup"] = p / n
        res[cell] = row
        print(f"tables {cell} ({B} lanes, {row['huf_lanes']} Huffman): "
              f"literal {row['lit_plain_us_a_lane']:.1f} -> "
              f"{row['lit_native_us_a_lane']:.2f} us a lane "
              f"({row['lit_speedup']:.0f}x), sequence "
              f"{row['seq_plain_us_a_lane']:.1f} -> "
              f"{row['seq_native_us_a_lane']:.2f} us a lane "
              f"({row['seq_speedup']:.0f}x); outputs equal")
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    for k, entry, src in (("huf", "zt_huf_decode", "huf_decode.cu"),
                          ("fse", "zt_fse_decode", "fse_decode.cu"),
                          ("hist", "zt_histogram", "histogram.cu")):
        ap.add_argument(f"--{k}-baseline", type=Path, action="append",
                        default=[], metavar="FILE.cu",
                        help=f"another source of {entry} to build and "
                             f"time beside csrc/{src} (repeatable)")
    ap.add_argument("--parse-baseline", type=Path, action="append",
                    default=[], metavar="FILE.cu",
                    help="another source of zt_lz_parse to build and time "
                         "beside csrc/lz_parse.cu (repeatable)")
    ap.add_argument("--parse-only", action="store_true",
                    help="run the parse kernel's A/B alone")
    ap.add_argument("--assemble-baseline", type=Path, action="append",
                    default=[], metavar="FILE.cu",
                    help="another source of zt_assemble to build and time "
                         "beside csrc/assemble.cu (repeatable)")
    ap.add_argument("--assemble-only", action="store_true",
                    help="run the assembly kernel's A/B alone")
    ap.add_argument("--tables-only", action="store_true",
                    help="time the host table builders alone")
    ap.add_argument("--out", type=Path,
                    default=ROOT / "build" / "kernel_bench.json",
                    help="where to write the JSON result")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("kernel_bench needs a CUDA device")
    sys.path.insert(0, str(ROOT))
    from bench import make_corpus

    dev = torch.device("cuda", 0)
    name = card()
    print(name)
    t0 = time.perf_counter()
    out = {"card": name}
    if not (args.parse_only or args.assemble_only):
        out["tables"] = tables_bench(dev)
    if not args.tables_only:
        data = make_corpus(2 * N_RECORDS * REC_SIZE)
        if not args.assemble_only:
            out["lz_parse"] = parse_ab(data, dev,
                                       [(f.stem, f)
                                        for f in args.parse_baseline])
        if not args.parse_only:
            out["assemble"] = assemble_ab(data, dev,
                                          [(f.stem, f)
                                           for f in args.assemble_baseline])
        if not (args.parse_only or args.assemble_only):
            out["histogram"] = hist_ab(data, dev,
                                       [(f.stem, f)
                                        for f in args.hist_baseline])
            windows = decode_windows(data, dev)
            for k, files in (("huf", args.huf_baseline),
                             ("fse", args.fse_baseline)):
                out[k] = kernel_ab(f"{k}_decode", windows[f"{k}_decode"],
                                   [(f.stem, f) for f in files])
    out["seconds"] = time.perf_counter() - t0
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(out, indent=1))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
