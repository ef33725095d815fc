"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Drives the port's two record-batch paths, its data-parallel stream codec
and the entry points of graft_entry.py once each through their user entry
points:

* decode: ``zstdsharp_tpu_torch.decode.frame.Decompressor().unwrap_many_device``
  on the bench's decode workload (bench.py: the first 6 MB of
  ``make_corpus`` as 256 records of 24 KB, each compressed at level 9) plus
  two 400 KB multi-block frames at level 3, one frame with a raw block and
  one with an RLE block (level 9);
* encode: ``zstdsharp_tpu_torch.encode.device_pipeline.compress_batch_device``
  on the bench's encode workload (bench.py: the first 4 MB of the same
  corpus as 256 records of 16 KB) plus one 128 KB record (the top bucket),
  one of 200 KB (routed to the host encoder), 9000 random bytes (raw
  fallback), an empty record and ``b"ab" * 9000``.

Phases, each printed on its own line:
  1. the card (nvidia-smi) and the build of the CUDA kernels from csrc/;
  2. the Huffman kernel against its plain torch version on the card, on
     the operands the native planner packs for the decode workload, with
     its bound (``kernel_bench.huf_work``: bytes each input read once and
     each output written once over 3.35 TB/s, or operations over the
     core rate, whichever is larger), timed through the wrapper (``ms``,
     as for every kernel) and through the raw launcher (``launcher_ms``),
     and its serial floor: the window's longest lane alone, checked and
     timed through the raw launcher (``serial_floor_ms``);
  3. the same for the FSE kernel (``kernel_bench.fse_work``);
  4. decode end to end: decoded bytes equal the inputs, none of the 256
     records is routed to the host, both decode kernels were launched;
  5. decode timings (printed, not asserted): each kernel and its plain
     version, the pipeline's end-to-end and marginal GB/s and its stage
     times, and the host decoder on the same frames;
  6. the histogram kernel against its plain torch version on the encode
     workload's literal rows (the first chunk's [32, 16384] with their
     prefix masks) and on an unmasked 1-D vector of odd length, timed
     beside ``torch.bincount`` on the same inputs (the mask as weights;
     a yardstick the port never calls), with its bound; ``ms`` through
     the wrapper, ``launcher_ms`` through the raw launcher and
     ``launch_floor_ms``, empty kernels of the same grid and cluster shape
     (``zt_histogram_floor``), on the literal rows;
  7. encode end to end: every frame decodes byte-exact with the host tier,
     the 256 records' frames decode byte-exact through the port's decode
     plane with none routed to the host, none of the 256 records is
     routed to the host encoder, the first 32-record chunk's frames equal
     the port's CPU run byte for byte, and the histogram kernel was
     launched;
  8. encode timings (printed, not asserted): marginal GB/s, stage times,
     compressed bytes, and the host tier's level-1 compress on the same
     records;
  9. stream compress at level 1 through
     ``zstdsharp_tpu_torch.parallel.pipeline.compress_data_parallel`` on a
     one-card mesh, over ``make_corpus(211_938_580)`` (Silesia's byte
     count; the 8 MB the phases above use is its prefix): the frame
     decodes byte-exact with the host tier, the native body ran, the
     candidates lived on the card, and the frame of the first 8 MB equals
     the port's CPU-mesh run; prints GB/s, parse_ms / body_ms, compressed
     bytes, peak device memory, the host tier's level-1 compress, and the
     stage times of the same steps called in turn with the card
     synchronised after each (their frame body equals the pipeline's);
 10. stream decode through ``decompress_data_parallel`` of the 256 decode
     frames concatenated: bytes equal the records, all 256 frames decoded
     on the card, both decode kernels launched; prints GB/s and telemetry;
 11. records encode through ``compress_records_device`` on the 256 x 16 KB
     encode records: every frame decodes byte-exact with the host tier,
     the frames equal ``compress_batch_device``'s, the histogram kernel
     launched;
 12. ``zstdsharp_tpu_torch.graft_entry``: ``entry("cuda")`` equals
     ``entry("cpu")`` and launched the histogram kernel, and
     ``dryrun_multichip(1)`` completes on the card (its lines printed);
 13. one more level-1 stream compress of phase 9's input under
     torch.profiler: device events, the device's busy share (the union of
     their intervals over the call's wall time) and the time of the
     copies and sorts.  It runs last so that no timed phase follows a
     profiler session.

Each path runs with every kernel's launch count set to 0 just before it
and read just after; a kernel's "launches" in the JSON line sums them.
The script imports the port and ``bench.make_corpus`` (a data generator)
only: nothing of JAX or of the JAX package.

Run from the root of a checkout:  python3 chip_smoke.py
It needs one CUDA device and exits non-zero, printing no result, when there
is none or when any phase fails.  The last two lines are a JSON object
describing each kernel and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SILESIA_BYTES = 211_938_580
REC_SIZE = 24 << 10
N_RECORDS = 256
ENC_REC_SIZE = 16 << 10


def _check(cond, what):
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def _gpu_ms(fn, reps):
    import torch

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


def _timed(fn):
    t = time.perf_counter()
    fn()
    return time.perf_counter() - t


def _first_block(frame: bytes):
    """(last-block flag, block type) of a frame's first block."""
    import numpy as np

    from zstdsharp_tpu_torch.decode.frame import parse_frame_header

    p = parse_frame_header(np.frombuffer(frame, np.uint8)).header_size
    bh = int.from_bytes(frame[p:p + 3], "little")
    return bh & 1, (bh >> 1) & 3


def _workload(data):
    """(records, their frames, extra inputs, their frames)."""
    import numpy as np

    from zstdsharp_tpu_torch.encode.frame import compress

    recs = [data[i:i + REC_SIZE] for i in range(0, 6 << 20, REC_SIZE)]
    _check(len(recs) == N_RECORDS, "256 records of 24 KB")
    frames = [compress(r, 9) for r in recs]
    base = 6 << 20
    extras = [data[base:base + 400_000], data[base + 400_000:base + 800_000],
              np.random.default_rng(5).integers(0, 256, 5000,
                                                dtype=np.uint8).tobytes(),
              b"Q" * 30_000]
    # multi-block frames at level 3; raw and RLE blocks at the records' level
    extra_frames = [compress(x, lvl) for x, lvl in zip(extras, (3, 3, 9, 9))]
    for f in extra_frames[:2]:
        _check(_first_block(f)[0] == 0, "400 KB frame is multi-block")
    _check(_first_block(extra_frames[2]) == (1, 0), "raw-block frame")
    _check(_first_block(extra_frames[3]) == (1, 1), "RLE-block frame")
    return recs, frames, extras, extra_frames


def _frame_bytes(n, outs, lens, host):
    """Each frame's decoded bytes from unwrap_many_device's return: rows
    follow the frames that host_results does not hold, in frame order."""
    rows = [r for o in outs for r in o.cpu().numpy()]
    got, k = [], 0
    for fi in range(n):
        if fi in host:
            v = host[fi]
            got.append(v if isinstance(v, bytes) else v.cpu().numpy().tobytes())
        else:
            got.append(rows[k][:lens[k]].tobytes())
            k += 1
    return got


def _kernel_phase(name, mod, ops, outputs_of, mask_key, work, card):
    """Kernel vs plain version on the card at the workload's shapes.
    Returns the kernel's JSON fields; `work` gives the call's (bytes,
    operations) from its operands.  ms times the wrapper, as for every
    kernel; launcher_ms and serial_floor_ms time the raw launcher (the
    wrapper's host work left out) on the window and on its longest lane
    alone."""
    import torch

    from zstdsharp_tpu_torch import _build
    from zstdsharp_tpu_torch.kernel_bench import bound, launcher, one_lane

    args = [ops[k] for k in mod._OPERANDS]
    got = outputs_of(mod.decode_lanemajor(ops))
    torch.cuda.synchronize()
    t_len = got[0].shape[1]
    want = outputs_of(mod.decode_plain(*args, t_len))
    torch.cuda.synchronize()
    live = (torch.arange(t_len, device=got[0].device)[None, :]
            < ops[mask_key].long()[:, None])
    err = max(float((g.long() - w.long()).abs().masked_select(live).max())
              if bool(live.any()) else 0.0 for g, w in zip(got, want))
    _check(err == 0.0, f"{name} kernel equals its plain version")
    _check(all(bool((g.masked_select(~live) == 0).all()) for g in got),
           f"{name} kernel zero-fills past each lane's count")
    ms = _gpu_ms(lambda: mod.decode_lanemajor(ops), 20)
    run, _ = launcher(_build.load(), name, ops)
    launcher_ms = _gpu_ms(run, 20)
    longest = int(torch.argmax(ops[mask_key]))
    lane = one_lane(ops, longest, mask_key)
    run1, outs1 = launcher(_build.load(), name, lane)
    run1()
    want1 = outputs_of(mod.decode_plain(*(lane[k] for k in mod._OPERANDS),
                                        outs1[0].shape[1]))
    torch.cuda.synchronize()
    _check(all(torch.equal(a, b) for a, b in zip(outs1, want1)),
           f"{name} kernel equals its plain version on the longest lane")
    floor_ms = _gpu_ms(run1, 20)
    n_max = int(ops[mask_key][longest])
    plain_ms = _gpu_ms(lambda: mod.decode_plain(*args, t_len), 1)
    bound_ms, bound_by = bound(*work(ops, t_len))
    print(f"phase {name}: kernel == plain over {int(live.sum())} entries of "
          f"{len(got)} x {tuple(got[0].shape)} (max_abs_err {err}); "
          f"kernel {ms:.4f} ms through the wrapper ({launcher_ms:.4f} ms "
          f"through the raw launcher), plain {plain_ms:.2f} ms, bound {bound_ms:.5f} ms "
          f"({bound_by}); serial floor: the longest lane alone ({n_max} "
          f"items) {floor_ms:.4f} ms, {floor_ms * 1e6 / max(n_max, 1):.1f} "
          f"ns each; no single PyTorch call computes it, on {card}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "launcher_ms": launcher_ms, "serial_floor_ms": floor_ms}


def _kernel_wrappers():
    from zstdsharp_tpu_torch.ops import device_fse, device_huf, histogram

    return {"huf_decode": device_huf.decode_lanemajor,
            "fse_decode": device_fse.decode_lanemajor,
            "histogram": histogram.histogram_u8}


def _reset_counts():
    for fn in _kernel_wrappers().values():
        fn.launches = 0


def _counts():
    return {k: fn.launches for k, fn in _kernel_wrappers().items()}


def _encode_workload(data):
    """(the bench's 256 records of 16 KB, the coverage inputs)."""
    import numpy as np

    recs = [data[i:i + ENC_REC_SIZE] for i in range(0, 4 << 20, ENC_REC_SIZE)]
    _check(len(recs) == N_RECORDS, "256 records of 16 KB")
    base = 4 << 20
    extras = [data[base:base + (128 << 10)],                # top bucket
              data[base + (128 << 10):base + (328 << 10)],  # 200 KB: host
              np.random.default_rng(9).integers(0, 256, 9000,
                                                dtype=np.uint8).tobytes(),
              b"", b"ab" * 9000]
    return recs, extras


def _hist_phase(lit_sorted, mask, odd, card):
    """Histogram kernel vs plain version on the card: the literal rows with
    their prefix masks, and an unmasked odd-length vector.  The yardstick
    is ``torch.bincount`` on the same rows with the mask as weights (the
    port never calls it).  Returns the kernel's JSON fields at the literal
    rows."""
    import torch

    from zstdsharp_tpu_torch import _build
    from zstdsharp_tpu_torch.kernel_bench import (bound, hist_floor,
                                                  hist_launcher, hist_work)
    from zstdsharp_tpu_torch.ops import histogram as hg

    err = 0.0
    for d, m in ((lit_sorted, mask), (odd, None)):
        got = hg.histogram_u8(d, m)
        torch.cuda.synchronize()
        want = hg.histogram_plain(d, m)
        torch.cuda.synchronize()
        _check(got.shape == want.shape and got.dtype == torch.int32,
               "histogram shape and dtype")
        err = max(err, float((got.long() - want.long()).abs().max()))
    _check(err == 0.0, "histogram kernel equals its plain version")
    _check(int(hg.histogram_u8(lit_sorted, mask).sum())
           == int(mask.sum()), "histogram counts every masked byte")
    ms = _gpu_ms(lambda: hg.histogram_u8(lit_sorted, mask), 20)
    run, out, (cs, cpr) = hist_launcher(_build.load(), lit_sorted, mask)
    run()
    torch.cuda.synchronize()
    _check(torch.equal(out, hg.histogram_plain(lit_sorted, mask)),
           "the raw launcher's histogram equals the plain version")
    launcher_ms = _gpu_ms(run, 20)
    floor_ms = _gpu_ms(hist_floor(_build.load(), lit_sorted.shape[0], cs,
                                  cpr), 20)
    plain_ms = _gpu_ms(lambda: hg.histogram_plain(lit_sorted, mask), 20)
    odd_ms = _gpu_ms(lambda: hg.histogram_u8(odd), 20)
    odd_plain = _gpu_ms(lambda: hg.histogram_plain(odd), 20)
    flat, weights = lit_sorted.reshape(-1), mask.reshape(-1).float()
    _check(torch.equal(torch.bincount(flat, weights=weights, minlength=256)
                       .long(), hg.histogram_plain(lit_sorted, mask).sum(0)
                       .long()),
           "torch.bincount agrees with the histogram")
    lib_ms = _gpu_ms(lambda: torch.bincount(flat, weights=weights,
                                            minlength=256), 20)
    odd_lib = _gpu_ms(lambda: torch.bincount(odd, minlength=256), 20)
    bound_ms, bound_by = bound(*hist_work(lit_sorted, mask))
    print(f"phase histogram: kernel == plain on lit_sorted "
          f"{tuple(lit_sorted.shape)} masked ({int(mask.sum())} literals) and "
          f"on {odd.shape[0]} unmasked bytes (max_abs_err {err}); kernel "
          f"{ms:.4f} ms through the wrapper ({launcher_ms:.4f} ms through the "
          f"raw launcher, clusters of {cs} blocks, {cpr} a row; launch floor "
          f"{floor_ms:.4f} ms), plain {plain_ms:.4f} ms, torch.bincount "
          f"{lib_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by}); odd "
          f"vector kernel {odd_ms:.4f} ms, plain {odd_plain:.4f} ms, "
          f"torch.bincount {odd_lib:.4f} ms (CUDA events) on {card}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms,
            "launcher_ms": launcher_ms, "launch_floor_ms": floor_ms}


def _encode_phases(data, dev, card):
    """Phases 6-8.  Returns (the histogram kernel's JSON fields, its
    launches in the encode path)."""
    import numpy as np
    import torch

    from zstdsharp_tpu_torch.decode.frame import decompress
    from zstdsharp_tpu_torch.encode.frame import compress
    from zstdsharp_tpu_torch.decode.frame import Decompressor
    from zstdsharp_tpu_torch.encode.device_pipeline import (
        LANES, compress_batch_device)
    from zstdsharp_tpu_torch.ops import device_encode as de

    recs, extras = _encode_workload(data)
    print(f"encode workload: {len(recs)} records x {ENC_REC_SIZE} B, plus "
          f"{[len(x) for x in extras]} B (128 KB bucket, host-routed, raw, "
          f"empty, match-heavy)")

    # ---- the histogram kernel at the main path's literal shapes ----
    N = ENC_REC_SIZE
    blocks = np.zeros((LANES, N), np.uint8)
    for k, r in enumerate(recs[:LANES]):
        blocks[k] = np.frombuffer(r, np.uint8)
    nv = torch.full((LANES,), N, dtype=torch.int32, device=dev)
    _, lit_sorted, lit_count, _, _ = de._parse_phase(
        torch.from_numpy(blocks).to(dev), nv, de.seq_budget(N), 15)
    mask = torch.arange(N, device=dev)[None, :] < lit_count[:, None].long()
    odd = torch.from_numpy(np.frombuffer(data[:(4 << 20) + 1], np.uint8)
                           .copy()).to(dev)
    hist = _hist_phase(lit_sorted, mask, odd, card)

    # ---- the encode path, once, through the user entry point ----
    all_in = recs + extras
    _reset_counts()
    chunks, host = compress_batch_device(all_in, dev)
    torch.cuda.synchronize()
    launches = _counts()["histogram"]
    _check(launches > 0, f"histogram kernel launched ({launches})")
    _check(all(r.device == dev and ln.device == dev for _, r, ln in chunks),
           "frame rows stay on the card")
    frames = [None] * len(all_in)
    for i, f in host.items():
        frames[i] = f
    for part, rows, lens in chunks:
        h, ln = rows.cpu().numpy(), lens.cpu().numpy()
        for k, i in enumerate(part):
            frames[i] = h[k, :ln[k]].tobytes()
    _check(not [i for i in host if i < N_RECORDS],
           "no record is routed to the host encoder")
    _check([decompress(f) for f in frames] == all_in,
           "every frame decodes byte-exact with the host tier")
    outs, lens, dhost = Decompressor().unwrap_many_device(frames[:N_RECORDS],
                                                          dev)
    torch.cuda.synchronize()
    got = _frame_bytes(N_RECORDS, outs, lens, dhost)
    _check(got == recs, "the records' frames decode byte-exact through the "
           "port's decode plane")
    _check(not dhost, f"decode planner routes {len(dhost)} frames to the "
           "host")
    cpu_frames, _ = compress_batch_device(recs[:LANES], "cpu",
                                          materialize=True)
    _check(cpu_frames == frames[:LANES],
           "the first chunk's frames equal the port's CPU run")
    csize = sum(map(len, frames[:N_RECORDS]))
    print(f"phase encode: {len(all_in)} records via compress_batch_device on "
          f"{torch.cuda.get_device_name(0)}: every frame decodes byte-exact "
          f"(host tier); {N_RECORDS} record frames byte-exact through "
          f"unwrap_many_device, decode host-routed {len(dhost)}; host-encoded "
          f"{sorted(host)} (records: 0); first {LANES} frames == CPU port; "
          f"histogram launches {launches}; records {sum(map(len, recs))} B "
          f"-> {csize} B")

    # ---- timings ----
    payload = sum(map(len, recs))

    def run_encode():
        ch, _ = compress_batch_device(recs, dev)
        torch.cuda.synchronize()
        return ch

    run_encode()
    pairs = sorted((_timed(lambda: [run_encode() for _ in range(3)])
                    - _timed(run_encode)) / 2 for _ in range(3))
    marg = max(pairs[1], 1e-9)
    e2e = sorted(_timed(run_encode) for _ in range(3))[1]
    stages = {}
    compress_batch_device(recs, dev, timings=stages)
    host_s = sorted(_timed(lambda: [compress(r, 1) for r in recs])
                    for _ in range(3))[1]
    host_size = sum(len(compress(r, 1)) for r in recs)
    print(f"phase encode timings: {payload} B in {N_RECORDS} records: "
          f"marginal {payload / marg / 1e9:.4f} GB/s ({marg * 1e3:.2f} ms), "
          f"end-to-end {payload / e2e / 1e9:.4f} GB/s ({e2e * 1e3:.2f} ms); "
          f"stages ms { {k: round(v * 1e3, 3) for k, v in stages.items()} }; "
          f"compressed {csize} B; host compress L1 "
          f"{payload / host_s / 1e9:.4f} GB/s ({host_s * 1e3:.2f} ms) -> "
          f"{host_size} B on {card}")
    return hist, launches


def _compress_phase(big, data, mesh, dev, card):
    """Phase 9: level-1 stream compress at Silesia's size on the card."""
    import torch

    from zstdsharp_tpu_torch import native
    from zstdsharp_tpu_torch.decode.frame import decompress
    from zstdsharp_tpu_torch.encode.frame import compress
    from zstdsharp_tpu_torch.parallel import pipeline as pp

    _check(native.get_lib() is not None, "the native engine loads, so "
           "compress_data_parallel runs the native dp_frame_body")
    seen = []
    step = pp._device_step

    def spy(blocks, hash_log):
        out = step(blocks, hash_log)
        seen.append(out[1].device)
        return out

    pp._device_step = spy
    try:
        torch.cuda.reset_peak_memory_stats(dev)
        tels, secs = [{}, {}], []
        for tel in tels:
            t = time.perf_counter()
            frame = pp.compress_data_parallel(big, mesh, level=1,
                                              telemetry=tel)
            secs.append(time.perf_counter() - t)
        peak = torch.cuda.max_memory_allocated(dev)
    finally:
        pp._device_step = step
    _check(decompress(frame) == big, "the level-1 stream frame decodes "
           "byte-exact with the host tier")
    _check(all("body_ms" in t and t["blocks"] == -(-len(big) // pp.BLOCK)
               for t in tels), f"telemetry {tels}")
    _check(seen and all(d == dev for d in seen),
           f"the candidate tensors lived on {dev} ({set(map(str, seen))})")
    head = pp.compress_data_parallel(data, mesh, level=1)
    _check(head == pp.compress_data_parallel(data, ["cpu"], level=1),
           "the first 8 MB's frame equals the port's CPU-mesh run")
    host = []
    host_s = _timed(lambda: host.append(compress(big, 1)))
    host_size = len(host[0])
    stages = _stream_breakdown(big, frame, dev)
    gbs = [len(big) / s / 1e9 for s in secs]
    print(f"phase stream compress: L1 {len(big)} B over {len(mesh)} card(s) "
          f"({tels[1]['blocks']} blocks of {pp.BLOCK} B) -> {len(frame)} B, "
          f"byte-exact via the host decoder, first 8 MB == CPU mesh; "
          f"end-to-end {gbs[0]:.4f} GB/s (first call, {secs[0] * 1e3:.1f} "
          f"ms), {gbs[1]:.4f} GB/s (second, {secs[1] * 1e3:.1f} ms); "
          f"parse_ms {[t['parse_ms'] for t in tels]}, body_ms "
          f"{[t['body_ms'] for t in tels]}; peak device memory "
          f"{peak} B; host compress L1 {len(big) / host_s / 1e9:.4f} GB/s "
          f"({host_s * 1e3:.1f} ms) -> {host_size} B; stages in turn, ms "
          f"{stages} on {card}")


def _stream_breakdown(big, frame, dev):
    """Phase 9's stage times (ms): the steps of compress_data_parallel at
    level 1 on a one-card mesh, called in turn with the card synchronised
    after each.  Checks that they make the pipeline's frame body."""
    import numpy as np
    import torch

    from zstdsharp_tpu_torch import native
    from zstdsharp_tpu_torch.parallel import pipeline as pp

    ms = {}

    def stage(name, fn):
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize(dev)
        ms[name] = round((time.perf_counter() - t) * 1e3, 2)
        return out

    blocks, _, n_blocks = stage("shard_blocks",
                                lambda: pp.shard_blocks(big, 1))
    rows = stage("h2d", lambda: torch.from_numpy(blocks).to(dev))
    ps, cand, _ = stage("candidate_stage", lambda: pp._device_step(rows, 16))
    by_pos = stage("unsort", lambda: torch.empty_like(cand).scatter_(
        1, ps.to(torch.int64), cand))
    host = stage("d2h", lambda: by_pos.cpu().numpy())
    body = stage("native_body", lambda: native.dp_frame_body(
        np.frombuffer(big, np.uint8), host[:n_blocks].reshape(-1), pp.BLOCK))
    _check(body is not None and frame.endswith(body),
           "the staged steps make the pipeline's frame body")
    ms["sum"] = round(sum(ms.values()), 2)
    return ms


def _stream_profile(big, dev, card):
    """Phase 13: one level-1 stream compress under torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from zstdsharp_tpu_torch.parallel import pipeline as pp

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t = time.perf_counter()
        pp.compress_data_parallel(big, [dev], level=1)
        torch.cuda.synchronize(dev)
        wall = (time.perf_counter() - t) * 1e3
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    _check(events, "the profiler recorded device events")
    busy, end = 0.0, float("-inf")
    for e in sorted(events, key=lambda e: e.time_range.start):
        lo, hi = max(e.time_range.start, end), e.time_range.end
        busy += max(hi - lo, 0.0)
        end = max(end, hi)

    def total(*keys):
        return sum(e.time_range.elapsed_us() for e in events
                   if any(k in e.name for k in keys)) / 1e3

    print(f"phase stream compress profile: L1 {len(big)} B, wall "
          f"{wall:.1f} ms (profiled), {len(events)} device events, device "
          f"busy {busy / 1e3:.2f} ms (share {busy / 1e3 / wall:.4f}); "
          f"Memcpy DtoH {total('Memcpy DtoH'):.2f} ms, Memcpy HtoD "
          f"{total('Memcpy HtoD'):.2f} ms, sort kernels "
          f"{total('Sort', 'sort'):.2f} ms on {card}")


def _stream_phases(big, data, recs, frames, enc_recs, dev, card):
    """Phases 9-12.  Returns each kernel's launches in their paths."""
    import torch

    from zstdsharp_tpu_torch.decode.frame import decompress
    from zstdsharp_tpu_torch import graft_entry
    from zstdsharp_tpu_torch.encode.device_pipeline import (
        compress_batch_device)
    from zstdsharp_tpu_torch.parallel import pipeline as pp

    mesh = pp.make_mesh()
    _check(mesh[0] == dev, f"the mesh starts at {dev}: {mesh}")
    _compress_phase(big, data, mesh, dev, card)
    launches = dict.fromkeys(_counts(), 0)

    # ---- 10: stream decode of the record log ----
    stream = b"".join(frames)
    payload = b"".join(recs)
    tel = {}
    _reset_counts()
    out = pp.decompress_data_parallel(stream, mesh, telemetry=tel)
    torch.cuda.synchronize()
    counts = _counts()
    _check(out == payload, "the stream decodes to the records")
    _check(tel["device_frames"] == N_RECORDS,
           f"device_frames {tel['device_frames']}")
    _check(counts["huf_decode"] > 0 and counts["fse_decode"] > 0,
           f"decode kernels launched {counts}")
    for k, v in counts.items():
        launches[k] += v
    tel2 = {}
    secs = _timed(lambda: pp.decompress_data_parallel(stream, mesh,
                                                      telemetry=tel2))
    print(f"phase stream decode: {len(frames)} frames, {len(stream)} B -> "
          f"{len(payload)} B byte-exact via decompress_data_parallel; "
          f"launches {counts}; {len(payload) / secs / 1e9:.4f} GB/s "
          f"({secs * 1e3:.1f} ms, second call); telemetry first {tel}, "
          f"second {tel2} on {card}")

    # ---- 11: records encode ----
    tel = {}
    _reset_counts()
    eframes = pp.compress_records_device(enc_recs, mesh, telemetry=tel)
    torch.cuda.synchronize()
    counts = _counts()
    _check(counts["histogram"] > 0, f"histogram launched {counts}")
    for k, v in counts.items():
        launches[k] += v
    _check([decompress(f) for f in eframes] == enc_recs,
           "every record frame decodes byte-exact with the host tier")
    _check(eframes == compress_batch_device(enc_recs, dev,
                                            materialize=True)[0],
           "the frames equal compress_batch_device's")
    _check(tel["device_frames"] == len(enc_recs), f"telemetry {tel}")
    print(f"phase records encode: {len(enc_recs)} records, "
          f"{sum(map(len, enc_recs))} B -> {sum(map(len, eframes))} B via "
          f"compress_records_device, byte-exact via the host decoder, == "
          f"compress_batch_device; launches {counts}; telemetry {tel} "
          f"on {card}")

    # ---- 12: the entry points of graft_entry.py ----
    _reset_counts()
    fn, args = graft_entry.entry("cuda")
    got = fn(*args)
    torch.cuda.synchronize()
    counts = _counts()
    _check(all(a.device == dev for a in args), "entry() arguments on card")
    _check(counts["histogram"] > 0, f"entry() launched histogram {counts}")
    c_fn, c_args = graft_entry.entry("cpu")
    want = c_fn(*c_args)
    _check(set(got) == set(want) and all(
        torch.equal(got[k].cpu(), want[k]) for k in want),
        "entry('cuda') equals entry('cpu')")
    _reset_counts()
    t = time.perf_counter()
    graft_entry.dryrun_multichip(1)
    torch.cuda.synchronize()
    dry = _counts()
    _check(all(v > 0 for v in dry.values()),
           f"dryrun_multichip(1) launched every kernel {dry}")
    for k in launches:
        launches[k] += counts[k] + dry[k]
    print(f"phase entry points: entry('cuda') == entry('cpu') "
          f"(nseq {got['nseq'].tolist()}, launches {counts}); "
          f"dryrun_multichip(1) completed in {time.perf_counter() - t:.2f} s "
          f"(launches {dry}) on {card}")
    return launches


def main() -> int:
    if not (ROOT / "zstdsharp_tpu_torch").is_dir():
        print("chip_smoke.py: zstdsharp_tpu_torch/ not found beside this "
              "script; run it from a checkout of the repository",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device; the port's kernels need one",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True, timeout=60)
    _check(smi.returncode == 0, "nvidia-smi reads the card")
    card = smi.stdout.strip()
    print(card)

    from zstdsharp_tpu_torch.decode.frame import decompress
    from zstdsharp_tpu_torch import _build
    from zstdsharp_tpu_torch.decode import device_pipeline as dp
    from zstdsharp_tpu_torch.decode.frame import Decompressor
    from zstdsharp_tpu_torch.kernel_bench import fse_work, huf_work
    from zstdsharp_tpu_torch.ops import device_fse as df
    from zstdsharp_tpu_torch.ops import device_huf as dh

    t0 = time.perf_counter()
    _build.load()
    built = _build.BuildInfo.seconds
    regs = [ln.strip() for ln in _build.BuildInfo.log.splitlines()
            if "registers" in ln]
    print(f"phase build: {_build.LIB_PATH.name} "
          f"{'built in %.2f s' % built if built is not None else 'up to date'}"
          f", loaded after {time.perf_counter() - t0:.2f} s; {regs}")

    from bench import make_corpus

    big = make_corpus(SILESIA_BYTES)
    data = big[:8 << 20]
    recs, frames, extras, extra_frames = _workload(data)
    print(f"workload: {len(frames)} records x {REC_SIZE} B at level 9 -> "
          f"{sum(map(len, frames))} B, plus {len(extra_frames)} frames "
          f"(2 x 400 KB multi-block L3, raw block, RLE block)")

    # ---- kernels against their plain versions, planner operands ----
    plan = dp.plan_batch(frames + extra_frames)
    hops = dp.ops_to_device(plan.nb.huf_ops(0), dev)
    fops = dp.ops_to_device(plan.nb.fse_ops(0), dev)
    dp._release_ops(plan.nb, None)
    huf = _kernel_phase("huf_decode", dh, hops, lambda o: (o,), "nsym",
                        huf_work, card)
    fse = _kernel_phase("fse_decode", df, fops, lambda o: o, "nseq",
                        fse_work, card)

    # ---- the decode path, once, through the user entry point ----
    all_in = recs + extras
    all_frames = frames + extra_frames
    _reset_counts()
    outs, lens, host = Decompressor().unwrap_many_device(all_frames, dev)
    torch.cuda.synchronize()
    counts = _counts()
    launches = {k: counts[k] for k in ("huf_decode", "fse_decode")}
    got = _frame_bytes(len(all_frames), outs, lens, host)
    host_routed = [fi for fi, v in host.items() if isinstance(v, bytes)]
    _check(got == all_in, "decoded bytes equal the inputs")
    _check(not [fi for fi in host_routed if fi < N_RECORDS],
           "no record frame is host-routed")
    _check(all(n > 0 for n in launches.values()), f"kernels launched {launches}")
    results, stats = dp.decode_batch_device(all_frames, dev, materialize=True)
    _check(results == all_in, "materialized bytes equal the inputs")
    print(f"phase end-to-end: {len(all_frames)} frames byte-exact via "
          f"unwrap_many_device on {torch.cuda.get_device_name(0)}; host-routed"
          f" {len(host_routed)} (records: 0), materialize stats {stats}; "
          f"launches {launches}")

    # ---- timings ----
    payload = sum(map(len, recs))

    def run_pipeline():
        o, _, h = Decompressor().unwrap_many_device(frames, dev)
        torch.cuda.synchronize()
        return len(h)

    run_pipeline()
    pairs = sorted((_timed(lambda: [run_pipeline() for _ in range(3)])
                    - _timed(run_pipeline)) / 2 for _ in range(3))
    marg = max(pairs[1], 1e-9)
    e2e = sorted(_timed(run_pipeline) for _ in range(3))[1]
    stages = {}
    dp.decode_batch_device(frames, dev, timings=stages)
    host_s = _timed(lambda: [decompress(f) for f in frames])
    print(f"phase timings: pipeline {payload} B in {N_RECORDS} frames: "
          f"end-to-end {payload / e2e / 1e9:.4f} GB/s ({e2e * 1e3:.2f} ms), "
          f"marginal {payload / marg / 1e9:.4f} GB/s ({marg * 1e3:.2f} ms); "
          f"stages ms { {k: round(v * 1e3, 3) for k, v in stages.items()} }; "
          f"host decompress {payload / host_s / 1e9:.4f} GB/s "
          f"({host_s * 1e3:.2f} ms) on {card}")

    hist, hist_launches = _encode_phases(data, dev, card)
    launches["histogram"] = hist_launches
    dp_launches = _stream_phases(big, data, recs, frames,
                                 _encode_workload(data)[0], dev, card)
    launches = {k: launches[k] + dp_launches[k] for k in launches}
    _stream_profile(big, dev, card)

    kernels = [{"name": name, "route": "cuda",
                "source": f"zstdsharp_tpu_torch/csrc/{src}",
                "replaces": f"zstdsharp_tpu/ops/{rep}",
                "launches": launches[name], **fields}
               for name, fields, src, rep in (
                   ("huf_decode", huf, "huf_decode.cu", "device_huf.py:238"),
                   ("fse_decode", fse, "fse_decode.cu", "device_fse.py:292"),
                   ("histogram", hist, "histogram.cu", "histogram.py:36"))]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:  # report any failed phase and exit non-zero
        import traceback

        traceback.print_exc()
        sys.exit(1)
