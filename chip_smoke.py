"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Drives the port's two record-batch paths (decode with and without a
dictionary), its data-parallel stream codec, the entry points of
graft_entry.py and the LDM anchor scan once each through their user entry
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
  fallback), an empty record and ``b"ab" * 9000``;
* dictionary decode: ``Decompressor().load_dictionary(d)`` then
  ``unwrap_many_device`` on the two committed sets of
  tests/torch_data/dict_sets.py: the bench's dictionary batch (5,000 JSON
  records, a 4,096-byte dictionary, level 3) and 128 records of 24 KB of
  ``make_corpus`` with a 112,640-byte dictionary at level 19 plus two
  300 KB multi-block frames at level 3.

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
 3b. lz_exec: the LZ executor kernel (``csrc/lz_exec.cu``) against its
     plain versions, rows byte for byte and per-lane flags, on every call
     the decode plane makes to its entry ``execseq.execute_lanes``
     (captured through ``kernel_bench.capture_exec``): the decode cell's
     256 lanes [O 24576] in one launch, each round of the two 400 KB
     multi-block frames (one launch in place on the frame accumulator),
     set 1's 5,000 lanes in one launch, set 2's lanes (its 128 KB window
     row broadcast with stride 0) and rounds, none of which flags a lane,
     and random corrupt meta; on each call also ``execseq.execute`` (the
     same kernel body on the assembled operands) against its plain
     version, and on two random corrupt operand sets; the launch counts
     of each decode (the decode cell and set 1 once); then the A/B on the
     decode cell's launch, in turns (plain, kernel, kernel, plain; the
     plain version is ``lanes_plain`` on the same CUDA tensors: the torch
     assembly, ``make_executor``'s run and ``lane_flags``), printed beside
     ``execute``'s time on the assembled operands, the serial floor (the
     cell's longest lane alone) and the bound
     (``kernel_bench.lz_work``);
 3c. corrupt frames: 8 records of 6,000 B at level 9 without a checksum,
     300 trials from random.Random(7) each flipping 1-4 bits of one frame:
     ``decode_batch_device(materialize=True)`` raises wherever the host
     ``decompress`` raises and otherwise returns the host's bytes, and the
     fused kernel equals its plain version on every call of every trial;
  4. decode end to end: decoded bytes equal the inputs, none of the 256
     records is routed to the host, both decode kernels and the LZ
     executor kernel were launched;
  5. decode timings (printed, not asserted): each kernel and its plain
     version, the pipeline's end-to-end and marginal GB/s and its stage
     times, and the host decoder on the same frames, through its route
     (``native.host_route()``: the ``_ztpy`` extension where it builds) and
     once more through ctypes with the extension off;
  6. the histogram kernel against its plain torch version on the encode
     workload's literal rows (the first chunk's [32, 16384] with their
     prefix masks) and on an unmasked 1-D vector of odd length, timed
     beside ``torch.bincount`` on the same inputs (the mask as weights;
     a yardstick the port never calls), with its bound; ``ms`` through
     the wrapper, ``launcher_ms`` through the raw launcher and
     ``launch_floor_ms``, empty kernels of the same grid and cluster shape
     (``zt_histogram_floor``), on the literal rows;
 6b. lz_parse: the parse kernel (``csrc/lz_parse.cu``) against its plain
     version (``lz_parse.parse_plain``), every output exactly, on every
     call the encode plane makes to ``lz_parse.parse_lanes`` for the
     encode workload and the coverage records (captured through
     ``kernel_bench.capture_parse``: nine 16 KB chunks and one each of the
     4, 64 and 128 KB buckets) and on ``graft_entry.entry``'s
     ``parse_block_stats`` rows ([4, 32768], hash_log 15, (16, 24)
     rounds); on the encode cell's first chunk its time through the
     wrapper, the plain version's, the SM cycles of each pass on the
     slowest lane and on the lane with the most sequences
     (``kernel_bench.parse_passes``, also on the 128 KB chunk), the
     serial floor (the slowest lane alone) and the bound
     (``kernel_bench.parse_work``);
 6c. assemble: the assembly kernel (``csrc/assemble.cu``) against its
     plain version (``assemble.assemble_plain``), rows and out_len byte
     for byte, on every call the encode plane makes to ``assemble.assemble``
     for the encode workload and the coverage records (captured through
     ``kernel_bench.capture_assemble``: nine 16 KB chunks and one each of
     the 4, 64 and 128 KB buckets); on the encode cell's first chunk its
     time through the wrapper, its device time (profiler) and the
     wrapper's host time, the plain version's, the serial floor (the lane
     with the most sequences alone, through the wrapper and in device
     time), the bound (``kernel_bench.assemble_work``) and the 128 KB
     chunk's time, and the SM cycles of each of its passes on the slowest
     lane of the 16 KB chunk and of the 128 KB chunk
     (``kernel_bench.assemble_passes``, ``assemble_lanes(stamps=)``);
  7. encode end to end: every frame decodes byte-exact with the host tier,
     the 256 records' frames decode byte-exact through the port's decode
     plane with none routed to the host, none of the 256 records is
     routed to the host encoder, the first 32-record chunk's frames equal
     the port's CPU run byte for byte, and the histogram and the parse
     kernels were launched, the assembly kernel once a chunk;
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
     on the card, both decode kernels and the LZ executor launched;
     prints GB/s and telemetry;
 11. records encode through ``compress_records_device`` on the 256 x 16 KB
     encode records: every frame decodes byte-exact with the host tier,
     the frames equal ``compress_batch_device``'s, the histogram, the
     parse and the assembly kernels launched;
 12. ``zstdsharp_tpu_torch.graft_entry``: ``entry("cuda")`` equals
     ``entry("cpu")`` and launched the histogram and the parse kernels,
     and
     ``dryrun_multichip(1)`` completes on the card (its lines printed);
 13. dictionary decode of each set: bytes equal the records, the rows
     equal the port's CPU run and so does the host-routed count (0), each
     decode kernel and the LZ executor launched across the two sets, and
     each decode kernel equals
     its plain version on a set's operands (Huffman: set 2, FSE: set 1);
     prints (not asserted) end-to-end and marginal GB/s, the stage times
     and the engine's ``NativeDDict.decompress_many`` on the same frames;
 14. ``ops.ldm.ldm_anchor_mask`` over the 8 MB corpus prefix on the card
     equals its CPU run; prints its time (torch ops, no hand kernel);
 15. public API, through ``import zstdsharp_tpu_torch as z`` only: (a) the
     json set made on this host: ``z.train_dictionary`` on its first
     1,000 records equals the committed dictionary, ``z.Compressor(3)``
     with it frames the 5,000 records into the committed frames, and
     ``z.Decompressor().unwrap_many_device(frames)`` with no device
     decodes them byte-exact on cuda:0 (the FSE kernel and the LZ executor
     launched), as does ``unwrap_many`` on the host; (b)
     ``Compressor(9).wrap_many`` over phase 4's 256 x 24 KB records, then
     ``unwrap_many_device()``: byte-exact, both decode kernels and the LZ
     executor launched, the host-routed count
     printed; (c) a level-3 ``CompressionStream`` with a checksum over the
     8 MB prefix, written in chunks of 1, 7, 4,096 and 65,536 bytes in
     turn and flushed every 1 MB, read back by ``DecompressionStream`` in
     reads of 7 and 65,536 bytes and by ``decompress``, and ``compress``
     with ``CCtxParams(compression_level=3, n_workers=4)`` decoded by
     ``decompress(..., n_workers=4)``; prints (not asserted) each call's
     time and the streams' MB/s;
 16. one decode of the decode cell under torch.profiler: its device
     events and the LZ executor kernel's device ms; one encode of the
     encode cell: its device events (in all and a chunk), the device's
     busy share, and the parse and the assembly kernels' launches (the
     assembly's once a chunk, 8) and device ms; then one more level-1
     stream compress of phase 9's input under torch.profiler: device
     events, the device's busy share (the union of their intervals over
     the call's wall time) and the time of the copies and sorts.  They
     run last so that no timed phase follows a profiler session.

Each path runs with every kernel's launch count set to 0 just before it
and read just after; a kernel's "launches" in the JSON line sums them.
The script imports the port, ``bench.make_corpus`` (a data generator) and
the loader of the committed dictionary sets only: nothing of JAX or of the
JAX package.

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


def _stage_ms(stages: dict) -> dict:
    """A `timings=` dict for printing: spans in ms, counters ("n.*") as
    counted."""
    return {k: v if k.startswith("n.") else round(v * 1e3, 3)
            for k, v in stages.items()}


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


def _lz_equal(call, name):
    """The fused kernel against its plain version on one captured
    ``execute_lanes`` call (an in-place output on copies), then
    ``execute``'s kernel against its plain version on the same lanes'
    assembled operands.  Returns (max_abs_err, the flags)."""
    import torch

    from zstdsharp_tpu_torch.kernel_bench import exec_args, run_lanes
    from zstdsharp_tpu_torch.ops.execseq import (execute, execute_plain,
                                                 lanes_plain)

    got, bad = run_lanes(call)
    torch.cuda.synchronize()
    want, want_bad = run_lanes(call, lanes_plain)
    _check(got.shape == want.shape, f"{name}: the fused kernel's shape")
    err = float((got.long() - want.long()).abs().max()) if got.numel() \
        else 0.0
    _check(torch.equal(bad, want_bad),
           f"{name}: the fused kernel's flags equal the plain version's")
    args = exec_args(call)
    got, ebad = execute(*args)
    torch.cuda.synchronize()
    want, want_bad = execute_plain(*args)
    err = max(err, float((got.long() - want.long()).abs().max()))
    _check(torch.equal(ebad, want_bad) and torch.equal(ebad, bad),
           f"{name}: execute's flags equal the plain version's")
    return err, bad


def _decode_profile(run):
    """One run() under torch.profiler: (device events, the lz_exec
    kernel's device ms)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    return len(events), sum(e.time_range.elapsed_us() for e in events
                            if "lz_kernel" in e.name) / 1e3


def _lz_phase(frames, mb_frames, big, dev, card):
    """Phase 3b: the LZ executor kernel against its plain version on every
    call the decode plane makes, its launch counts, and its timings on the
    decode cell.  Returns the kernel's JSON fields (ms, plain_ms and
    bound_ms of the decode cell's one launch)."""
    import numpy as np
    import torch

    from zstdsharp_tpu_torch.decode import device_pipeline as dp
    from zstdsharp_tpu_torch.dictionary import parse_dictionary
    from zstdsharp_tpu_torch.kernel_bench import (bound, capture_exec,
                                                  exec_args, lz_corrupt,
                                                  lz_corrupt_lanes, lz_work,
                                                  run_lanes)
    from zstdsharp_tpu_torch.ops.execseq import (execute, execute_lanes,
                                                 execute_plain, lanes_plain)

    sets = _dict_sets()
    runs = {"decode cell": lambda: dp.decode_batch_device(frames, device=dev),
            "multi-block": lambda: dp.decode_batch_device(mb_frames,
                                                          device=dev)}
    for name in ("json", "corpus"):
        d, dframes, _ = sets.load(name, big)
        runs[f"dictionary {name}"] = (
            lambda f=dframes, pd=parse_dictionary(d):
            dp.decode_batch_device(f, device=dev, ddict=pd))
    groups, launched = {}, {}
    for name, run in runs.items():
        execute_lanes.launches = 0
        groups[name] = capture_exec(run)
        launched[name] = execute_lanes.launches
    rng = np.random.default_rng(10)
    groups["corrupt meta"] = [
        lz_corrupt_lanes(rng, *shape, dev, srcs) for *shape, srcs in (
            (64, 256, 4096, 8, "all"), (200, 1024, 24576, 1 << 15, "all"),
            (5, 4096, 1 << 17, 1 << 17, "all"), (33, 100, 3000, 0, "raw"))]
    cell = groups["decode cell"]
    _check(launched["decode cell"] == 1 and len(cell) == 1
           and tuple(cell[0]["meta"].shape) == (N_RECORDS, 12)
           and cell[0]["O"] == REC_SIZE,
           f"the decode cell's 256 lanes [O {REC_SIZE}] in one launch")
    _check(launched["dictionary json"] == 1,
           "set 1's 5,000 lanes in one launch")
    for name in ("multi-block", "dictionary corpus"):
        rounds = [c for c in groups[name] if c["out"] is not None]
        _check(rounds and all(c["window"] is c["out"]
                              and c["win_start"] is not None
                              for c in rounds),
               f"{name}: each round one launch in place on its accumulator")
    _check(any(c["window"].shape[1] == 1 << 17 and c["window"].stride(0) == 0
               for c in groups["dictionary corpus"]),
           "set 2 runs its 128 KB window row broadcast to the lanes")
    err, shapes, flagged = 0.0, {}, {}
    for name, calls in groups.items():
        _check(calls, f"{name}: the decode plane called execute_lanes")
        flagged[name] = 0
        for call in calls:
            e, bad = _lz_equal(call, name)
            err = max(err, e)
            flagged[name] += int((bad != 0).sum())
        _check(name == "corrupt meta" or flagged[name] == 0,
               f"{name}: valid frames flag no lane ({flagged[name]})")
        shapes[name] = sorted({(c["meta"].shape[0], c["O"], c["S"],
                                c["window"].shape[1], c["W"],
                                c["out"] is not None) for c in calls})
    rng = np.random.default_rng(11)
    for *shape, bc in ((64, 4096, 24576, 8, False),
                       (16, 1024, 24576, 1 << 15, True)):
        args = lz_corrupt(rng, *shape, dev, bc)
        got, bad = execute(*args)
        want, want_bad = execute_plain(*args)
        err = max(err, float((got.long() - want.long()).abs().max()))
        _check(torch.equal(bad, want_bad), "execute's flags, corrupt operands")
    _check(err == 0.0, "lz_exec kernel equals its plain version")
    _check(flagged["corrupt meta"] > 0, "corrupt meta flags lanes")

    # the decode cell's one launch against its plain version on the card,
    # in turns: plain, kernel, kernel, plain; execute on the assembled
    # operands (the same kernel body) beside it
    call = cell[0]
    a = _gpu_ms(lambda: run_lanes(call, lanes_plain), 3)
    k1 = _gpu_ms(lambda: run_lanes(call), 20)
    k2 = _gpu_ms(lambda: run_lanes(call), 20)
    b = _gpu_ms(lambda: run_lanes(call, lanes_plain), 3)
    ms, plain_ms = (k1 + k2) / 2, (a + b) / 2
    args = exec_args(call)
    exec_ms = _gpu_ms(lambda: execute(*args), 20)
    bound_ms, bound_by = bound(*lz_work(call))
    longest = int(torch.argmax(call["meta"][:, 8]))
    lane = dict(call, meta=call["meta"][longest:longest + 1],
                window=call["window"][:1])
    got, want = run_lanes(lane), run_lanes(lane, lanes_plain)
    _check(all(torch.equal(x, y) for x, y in zip(got, want)),
           "lz_exec kernel equals its plain version on the longest lane")
    floor_ms = _gpu_ms(lambda: run_lanes(lane), 20)
    n_max = int(lane["meta"][0, 8])
    print(f"phase lz_exec: fused kernel == plain on "
          f"{sum(map(len, groups.values()))} calls (max_abs_err {err}; "
          f"flags equal, flagged lanes {flagged}; execute == plain on the "
          f"same lanes' assembled operands and 2 corrupt operand sets): "
          f"{ {k: len(v) for k, v in groups.items()} } calls of (lanes, O, "
          f"S, window row, W, in place) {shapes}; launches a decode "
          f"{launched} (the chunked executor: decode cell 4, set 1 79, "
          f"PERF.md); decode cell, one launch of 256 lanes "
          f"({int(call['meta'][:, 8].clamp(min=0).sum())} sequences): "
          f"kernel {k1:.4f} / {k2:.4f} ms, plain {a:.3f} / {b:.3f} ms "
          f"(turns plain, kernel, kernel, plain; CUDA events), execute on "
          f"the assembled operands {exec_ms:.4f} ms, bound {bound_ms:.5f} "
          f"ms ({bound_by}); serial floor: the longest lane alone ({n_max} "
          f"sequences) {floor_ms:.4f} ms, "
          f"{floor_ms * 1e6 / max(n_max, 1):.1f} ns a sequence; no single "
          f"PyTorch call computes it, on {card}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "serial_floor_ms": floor_ms, "execute_ms": exec_ms}


def _decode_profile_phase(frames, dev, card):
    """Phase 16, first part: one decode of the decode cell under
    torch.profiler (after every timed phase): its device events and the
    fused kernel's device ms, beside the chunked executor's."""
    from zstdsharp_tpu_torch.decode import device_pipeline as dp

    events, dev_ms = _decode_profile(
        lambda: dp.decode_batch_device(frames, device=dev))
    _check(dev_ms > 0, "the profiler saw the fused kernel")
    print(f"phase decode profile: one decode of the {len(frames)} records: "
          f"{events} device events, the lz_exec kernel {dev_ms:.4f} ms of "
          f"device time in one launch (the chunked executor: 246 events, "
          f"0.7407 ms over 4 launches, PERF.md) on {card}")
    return {"decode_device_ms": dev_ms, "decode_events": events}


def _corrupt_phase(data, dev, card):
    """Phase 3c: frames the host decoder rejects raise on the device plane
    too.  8 records of 6,000 B at level 9 (no checksum, so only the
    executor's flags can catch a corrupt body), 300 trials each flipping
    1-4 bits of one frame (random.Random(7))."""
    import random

    from zstdsharp_tpu_torch.decode import device_pipeline as dp
    from zstdsharp_tpu_torch.decode.frame import decompress
    from zstdsharp_tpu_torch.encode.frame import compress
    from zstdsharp_tpu_torch.errors import ZstdError, ZstdErrorCode
    from zstdsharp_tpu_torch.kernel_bench import capture_exec

    recs = [data[i * 6000:(i + 1) * 6000] for i in range(8)]
    frames = [compress(r, 9) for r in recs]
    results, _ = dp.decode_batch_device(frames, device=dev, materialize=True)
    _check(results == recs, "the unmutated batch decodes byte-exact")
    rng = random.Random(7)
    n = {"accepted": 0, "rejected": 0, "flagged": 0, "calls": 0,
         "flagged lanes": 0}
    for _ in range(300):
        fi = rng.randrange(8)
        f = bytearray(frames[fi])
        for _ in range(rng.randint(1, 4)):
            f[rng.randrange(len(f))] ^= 1 << rng.randrange(8)
        batch = frames[:fi] + [bytes(f)] + frames[fi + 1:]
        try:
            want = decompress(bytes(f))
        except ZstdError:
            want = None
        out = {}

        def run():
            try:
                out["got"] = dp.decode_batch_device(batch, device=dev,
                                                    materialize=True)[0]
            except ZstdError as e:
                out["error"] = e

        for call in capture_exec(run):
            e, bad = _lz_equal(call, f"trial of frame {fi}")
            _check(e == 0.0, "lz_exec kernel equals its plain version on "
                   "a corrupt-frame trial")
            n["calls"] += 1
            n["flagged lanes"] += int((bad != 0).sum())
        got = out.get("got")
        if "error" in out:
            e = out["error"]
            _check(want is None, f"frame {fi} raised ({e}) where the host "
                   "decoder accepts it")
            n["rejected"] += 1
            n["flagged"] += (e.code == ZstdErrorCode.corruption_detected
                             and str(e).startswith(f"frame {fi}: "))
            continue
        _check(want is not None, f"frame {fi} decoded where the host "
               "decoder raises")
        _check(got[fi] == want and got[:fi] + got[fi + 1:]
               == recs[:fi] + recs[fi + 1:], "accepted trial's bytes")
        n["accepted"] += 1
    _check(n["rejected"] > 0 and n["flagged"] > 0, f"trials {n}")
    print(f"phase corrupt frames: 300 trials over 8 x 6000 B level-9 "
          f"frames: the device plane raised wherever the host decompress "
          f"raised and returned its bytes elsewhere: {n} (flagged: raised "
          f"by the executor's flags, the rest by the host route) on {card}")


def _kernel_wrappers():
    from zstdsharp_tpu_torch.ops import assemble, device_fse, device_huf
    from zstdsharp_tpu_torch.ops import execseq, histogram, lz_parse

    return {"huf_decode": device_huf.decode_lanemajor,
            "fse_decode": device_fse.decode_lanemajor,
            "histogram": histogram.histogram_u8,
            "lz_exec": execseq.execute_lanes,
            "lz_parse": lz_parse.parse_lanes,
            "assemble": assemble.assemble_lanes}

DECODE_KERNELS = ("huf_decode", "fse_decode", "lz_exec")
ENCODE_KERNELS = ("histogram", "lz_parse", "assemble")
PARSE_KERNELS = ("histogram", "lz_parse")  # entry(): parse_block_stats


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


def _parse_equal(call, name):
    """The parse kernel against its plain version on one captured
    ``parse_lanes`` call.  Returns (max_abs_err, the kernel's outputs)."""
    import torch

    from zstdsharp_tpu_torch.kernel_bench import run_parse
    from zstdsharp_tpu_torch.ops import lz_parse as lp

    got = run_parse(call)
    torch.cuda.synchronize()
    want = run_parse(call, lp.parse_plain)
    _check(set(got) == set(want), f"{name}: the kernel's outputs")
    err = 0.0
    for k, w in want.items():
        _check(got[k].shape == w.shape and got[k].dtype == w.dtype,
               f"{name}: {k}'s shape and dtype")
        if w.numel():
            err = max(err, float((got[k].long() - w.long()).abs().max()))
    _check(err == 0.0, f"{name}: the parse kernel equals its plain version")
    return err, got


def _lz_parse_phase(recs, extras, dev, card):
    """Phase 6b: the parse kernel (``csrc/lz_parse.cu``) against its plain
    version on every call the encode plane makes to ``parse_lanes`` for
    the encode workload and the coverage records (captured through
    ``kernel_bench.capture_parse``: the 16 KB chunks, the 4, 64 and 128 KB
    buckets) and on ``graft_entry.entry``'s ``parse_block_stats`` rows;
    then, on the encode cell's first chunk, the kernel's time through the
    wrapper, the plain version's, the SM cycles of each pass on the
    slowest lane and on the lane with the most sequences
    (``kernel_bench.parse_passes``), the serial floor (the lane whose
    launch took longest, alone) and the bound (``kernel_bench.parse_work``).
    Returns the kernel's JSON fields."""
    from zstdsharp_tpu_torch import graft_entry
    from zstdsharp_tpu_torch.encode.device_pipeline import (
        compress_batch_device)
    from zstdsharp_tpu_torch.kernel_bench import (bound, capture_parse,
                                                  parse_lane, parse_passes,
                                                  parse_work, run_parse,
                                                  sm_clock_mhz)
    from zstdsharp_tpu_torch.ops import lz_parse as lp

    calls = capture_parse(lambda: compress_batch_device(recs + extras,
                                                        device=dev))
    widths = sorted({c["blocks"].shape[1] for c in calls})
    _check(widths == [4 << 10, 16 << 10, 64 << 10, 128 << 10],
           f"the encode plane parses every bucket {widths}")
    fn, args = graft_entry.entry(dev)
    stats = capture_parse(lambda: fn(*args))
    _check(len(stats) == 1 and not stats[0]["compact"],
           "parse_block_stats parses once")
    err, shapes = 0.0, {}
    for i, c in enumerate(calls + stats):
        e, _ = _parse_equal(c, f"parse call {i}")
        err = max(err, e)
        key = (tuple(c["blocks"].shape), c["hash_log"], c["u64_rounds"],
               c["stride_rounds"], c["compact"])
        shapes[key] = shapes.get(key, 0) + 1
    cell = next(c for c in calls if c["blocks"].shape[1] == ENC_REC_SIZE)
    _, out = _parse_equal(cell, "the encode cell's first chunk")
    ms = _gpu_ms(lambda: run_parse(cell), 20)
    plain_ms = _gpu_ms(lambda: run_parse(cell, lp.parse_plain), 3)
    big = next(c for c in calls if c["blocks"].shape[1] == 128 << 10)
    passes = {"16KB": parse_passes(cell), "128KB": parse_passes(big)}
    mhz = sm_clock_mhz()
    slowest = passes["16KB"]["lane"]
    one = parse_lane(cell, slowest)
    _parse_equal(one, "the slowest lane alone")
    floor_ms = _gpu_ms(lambda: run_parse(one), 20)
    big_ms = _gpu_ms(lambda: run_parse(big), 5)
    stats_ms = _gpu_ms(lambda: run_parse(stats[0]), 20)
    bound_ms, bound_by = bound(*parse_work(cell, out))
    n_slow = int(out["nseq"][slowest])
    print(f"phase lz_parse: kernel == plain on {len(calls)} encode-plane "
          f"calls and parse_block_stats's rows (calls by (shape, hash_log, "
          f"rounds, compact): {shapes}; max_abs_err {err}); encode cell's "
          f"first chunk {tuple(cell['blocks'].shape)}: kernel {ms:.4f} ms "
          f"through the wrapper, plain {plain_ms:.2f} ms, bound "
          f"{bound_ms:.5f} ms ({bound_by}); serial floor: the slowest lane "
          f"(by its clock stamps; {n_slow} sequences) alone {floor_ms:.4f} "
          f"ms; 128 KB chunk "
          f"{big_ms:.4f} ms; parse_block_stats rows [4, 32768] at hash_log "
          f"15, (16, 24) rounds {stats_ms:.4f} ms; no single PyTorch call "
          f"computes it (CUDA events) on {card}")
    print(f"phase lz_parse passes: SM cycles by pass on the slowest lane, "
          f"on the lane with the most sequences and the most of any lane, "
          f"16 KB and 128 KB chunks: {passes}; "
          f"SM clock {mhz} MHz now on {card}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "serial_floor_ms": floor_ms, "chunk_128KB_ms": big_ms,
            "passes_cycles": passes, "sm_clock_mhz": mhz}


def _assemble_equal(call, name):
    """The assembly kernel against its plain version on one captured
    ``assemble`` call: rows and out_len.  Returns (max_abs_err, the
    kernel's (rows, out_len))."""
    import torch

    from zstdsharp_tpu_torch.kernel_bench import run_assemble
    from zstdsharp_tpu_torch.ops import assemble as asm

    got = run_assemble(call)
    torch.cuda.synchronize()
    want = run_assemble(call, asm.assemble_plain)
    err = 0.0
    for g, w in zip(got, want):
        _check(g.shape == w.shape and g.dtype == w.dtype,
               f"{name}: the kernel's shapes and dtypes")
        err = max(err, float((g.long() - w.long()).abs().max()))
    _check(err == 0.0, f"{name}: the assembly kernel equals its plain "
           "version")
    return err, got


def _assemble_phase(recs, extras, dev, card):
    """Phase 6c: the assembly kernel (``csrc/assemble.cu``) against its
    plain version, rows and out_len byte for byte, on every call the
    encode plane makes to ``assemble`` for the encode workload and the
    coverage records (captured through ``kernel_bench.capture_assemble``:
    nine 16 KB chunks and one each of the 4, 64 and 128 KB buckets); then,
    on the encode cell's first chunk, the kernel's time through the
    wrapper, its device time and the wrapper's host time, the plain
    version's, the serial floor (the lane with the most sequences alone)
    and the bound (``kernel_bench.assemble_work``), and the 128 KB chunk's
    time; and the SM cycles of each of the kernel's passes on the 16 KB
    chunk's slowest lane and on the 128 KB chunk's lane
    (``kernel_bench.assemble_passes``, clock stamps).  Returns the
    kernel's JSON fields."""
    from zstdsharp_tpu_torch.encode.device_pipeline import (
        compress_batch_device)
    from zstdsharp_tpu_torch.kernel_bench import (assemble_lane,
                                                  assemble_passes,
                                                  assemble_work, bound,
                                                  capture_assemble,
                                                  device_ms, host_ms,
                                                  run_assemble)
    from zstdsharp_tpu_torch.ops import assemble as asm

    calls = capture_assemble(lambda: compress_batch_device(recs + extras,
                                                           device=dev))
    widths = sorted({c["blocks"].shape[1] for c in calls})
    _check(widths == [4 << 10, 16 << 10, 64 << 10, 128 << 10],
           f"the encode plane assembles every bucket {widths}")
    err, shapes = 0.0, {}
    for i, c in enumerate(calls):
        e, _ = _assemble_equal(c, f"assemble call {i}")
        err = max(err, e)
        key = tuple(c["blocks"].shape)
        shapes[key] = shapes.get(key, 0) + 1
    cell = next(c for c in calls if c["blocks"].shape[1] == ENC_REC_SIZE)
    _, out = _assemble_equal(cell, "the encode cell's first chunk")
    ms = _gpu_ms(lambda: run_assemble(cell), 20)
    plain_ms = _gpu_ms(lambda: run_assemble(cell, asm.assemble_plain), 3)
    lane = int(cell["parsed"]["nseq"].argmax())
    n_lane = int(cell["parsed"]["nseq"][lane])
    one = assemble_lane(cell, lane)
    _assemble_equal(one, "the lane with the most sequences alone")
    floor_ms = _gpu_ms(lambda: run_assemble(one), 20)
    names = ("assemble_kernel",)
    dev_ms = device_ms(lambda: run_assemble(cell), 20, names)
    floor_dev_ms = device_ms(lambda: run_assemble(one), 20, names)
    wrapper_ms = host_ms(lambda: run_assemble(cell), 200)
    big = next(c for c in calls if c["blocks"].shape[1] == 128 << 10)
    big_ms = _gpu_ms(lambda: run_assemble(big), 5)
    n_big = int(big["parsed"]["nseq"].max())
    bound_ms, bound_by = bound(*assemble_work(cell, out))
    passes = {"chunk_16KB": assemble_passes(cell),
              "chunk_128KB": assemble_passes(big)}
    cycles = {k: {"lane": v["lane"], "cycles": v["lane_cycles"]}
              for k, v in passes.items()}
    print(f"phase assemble: kernel == plain on {len(calls)} encode-plane "
          f"calls (calls by shape: {shapes}; max_abs_err {err}); encode "
          f"cell's first chunk {tuple(cell['blocks'].shape)}: kernel "
          f"{ms:.4f} ms through the wrapper ({dev_ms:.4f} ms of device time; "
          f"the wrapper's host time {wrapper_ms:.4f} ms a call), plain "
          f"{plain_ms:.2f} ms, bound {bound_ms:.5f} ms ({bound_by}); serial "
          f"floor: the lane with the most sequences ({n_lane}) alone "
          f"{floor_ms:.4f} ms ({floor_dev_ms:.4f} ms of device time); 128 KB "
          f"chunk {big_ms:.4f} ms (most sequences {n_big}); no single "
          f"PyTorch call computes it (CUDA events, profiler) on {card}")
    print(f"phase assemble: SM cycles by pass (clock stamps) on the slowest "
          f"lane of the 16 KB chunk and of the 128 KB chunk: {cycles}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "serial_floor_ms": floor_ms, "serial_floor_nseq": n_lane,
            "device_ms": dev_ms, "serial_floor_device_ms": floor_dev_ms,
            "wrapper_host_ms": wrapper_ms, "chunk_128KB_ms": big_ms,
            "pass_cycles": cycles}


def _encode_profile_phase(recs, dev, card):
    """Phase 16, second part: one encode of the encode cell under
    torch.profiler: device events (a chunk and in all), the device's busy
    share (the union of their intervals over the call's wall time), and
    the parse and the assembly kernels' launches (as the profiler records
    them; the assembly's once a chunk by its wrapper's count) and device
    ms.  Returns the parse's and the assembly's JSON fields."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from zstdsharp_tpu_torch.encode.device_pipeline import (
        LANES, compress_batch_device)
    from zstdsharp_tpu_torch.ops import assemble as asm

    compress_batch_device(recs, device=dev)
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        before = asm.assemble_lanes.launches
        t = time.perf_counter()
        compress_batch_device(recs, device=dev)
        torch.cuda.synchronize(dev)
        wall = (time.perf_counter() - t) * 1e3
        launched = asm.assemble_lanes.launches - before
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    _check(events, "the profiler recorded device events")
    busy, end = 0.0, float("-inf")
    for e in sorted(events, key=lambda e: e.time_range.start):
        lo, hi = max(e.time_range.start, end), e.time_range.end
        busy += max(hi - lo, 0.0)
        end = max(end, hi)
    parse = [e for e in events if "parse_kernel" in e.name]
    _check(parse, "the profiler saw the parse kernel")
    parse_ms = sum(e.time_range.elapsed_us() for e in parse) / 1e3
    asmb = [e for e in events if "assemble_kernel" in e.name]
    _check(asmb, "the profiler saw the assembly kernel")
    chunks = -(-len(recs) // LANES)
    _check(launched == chunks, f"the assembly kernel once a chunk "
           f"({launched} launches, {chunks} chunks)")
    asm_ms = sum(e.time_range.elapsed_us() for e in asmb) / 1e3
    print(f"phase encode profile: one encode of the {len(recs)} records "
          f"({chunks} chunks): wall {wall:.1f} ms (profiled), "
          f"{len(events)} device events ({len(events) / chunks:.0f} a "
          f"chunk), device busy {busy / 1e3:.3f} ms (share "
          f"{busy / 1e3 / wall:.4f}); the lz_parse kernel {len(parse)} "
          f"launches, {parse_ms:.4f} ms of device time; the assemble kernel "
          f"{launched} launches ({len(asmb)} recorded by the profiler), "
          f"{asm_ms:.4f} ms of device time on {card}")
    common = {"encode_events": len(events),
              "encode_busy_share": busy / 1e3 / wall}
    return ({**common, "encode_device_ms": parse_ms},
            {**common, "encode_device_ms": asm_ms,
             "encode_launches": launched})


def _encode_phases(data, dev, card):
    """Phases 6-8.  Returns (the histogram's, the parse kernel's and the
    assembly kernel's JSON fields, their launches in the encode path)."""
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
    lzp = _lz_parse_phase(recs, extras, dev, card)
    asmb = _assemble_phase(recs, extras, dev, card)

    # ---- the encode path, once, through the user entry point ----
    all_in = recs + extras
    _reset_counts()
    chunks, host = compress_batch_device(all_in, device=dev)
    torch.cuda.synchronize()
    counts = _counts()
    launches = {k: counts[k] for k in ENCODE_KERNELS}
    _check(all(v > 0 for v in launches.values()),
           f"encode kernels launched ({launches})")
    _check(launches["assemble"] == len(chunks),
           f"the assembly kernel once a chunk ({launches}, {len(chunks)} "
           "chunks)")
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
    cpu_frames, _ = compress_batch_device(recs[:LANES], device="cpu",
                                          materialize=True)
    _check(cpu_frames == frames[:LANES],
           "the first chunk's frames equal the port's CPU run")
    csize = sum(map(len, frames[:N_RECORDS]))
    print(f"phase encode: {len(all_in)} records via compress_batch_device on "
          f"{torch.cuda.get_device_name(0)}: every frame decodes byte-exact "
          f"(host tier); {N_RECORDS} record frames byte-exact through "
          f"unwrap_many_device, decode host-routed {len(dhost)}; host-encoded "
          f"{sorted(host)} (records: 0); first {LANES} frames == CPU port; "
          f"launches {launches}; records {sum(map(len, recs))} B "
          f"-> {csize} B")

    # ---- timings ----
    payload = sum(map(len, recs))

    def run_encode():
        ch, _ = compress_batch_device(recs, device=dev)
        torch.cuda.synchronize()
        return ch

    run_encode()
    pairs = sorted((_timed(lambda: [run_encode() for _ in range(3)])
                    - _timed(run_encode)) / 2 for _ in range(3))
    marg = max(pairs[1], 1e-9)
    e2e = sorted(_timed(run_encode) for _ in range(3))[1]
    stages = {}
    compress_batch_device(recs, device=dev, timings=stages)
    host_s = sorted(_timed(lambda: [compress(r, 1) for r in recs])
                    for _ in range(3))[1]
    host_size = sum(len(compress(r, 1)) for r in recs)
    print(f"phase encode timings: {payload} B in {N_RECORDS} records: "
          f"marginal {payload / marg / 1e9:.4f} GB/s ({marg * 1e3:.2f} ms), "
          f"end-to-end {payload / e2e / 1e9:.4f} GB/s ({e2e * 1e3:.2f} ms); "
          f"stages ms {_stage_ms(stages)}; "
          f"compressed {csize} B; host compress L1 "
          f"{payload / host_s / 1e9:.4f} GB/s ({host_s * 1e3:.2f} ms) -> "
          f"{host_size} B on {card}")
    return hist, lzp, asmb, launches


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
    _check(all(counts[k] > 0 for k in DECODE_KERNELS),
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
    _check(all(counts[k] > 0 for k in ENCODE_KERNELS),
           f"encode kernels launched {counts}")
    for k, v in counts.items():
        launches[k] += v
    _check([decompress(f) for f in eframes] == enc_recs,
           "every record frame decodes byte-exact with the host tier")
    _check(eframes == compress_batch_device(enc_recs, device=dev,
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
    _check(all(counts[k] > 0 for k in PARSE_KERNELS),
           f"entry() launched the histogram and the parse {counts}")
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


def _dict_sets():
    """tests/torch_data/dict_sets.py: the committed dictionary frames."""
    sys.path.insert(0, str(ROOT / "tests" / "torch_data"))
    import dict_sets

    return dict_sets


def _dict_kernel_check(mod, ops, outputs_of, name):
    """One decode kernel against its plain version on a dictionary batch's
    operands (launches outside the counted runs).  Returns max_abs_err."""
    import torch

    got = outputs_of(mod.decode_lanemajor(ops))
    torch.cuda.synchronize()
    want = outputs_of(mod.decode_plain(*(ops[k] for k in mod._OPERANDS),
                                       got[0].shape[1]))
    torch.cuda.synchronize()
    err = max(float((g.long() - w.long()).abs().max()) for g, w in
              zip(got, want))
    _check(err == 0.0, f"{name} kernel equals its plain version on the "
           "dictionary operands")
    return err


def _dict_phases(big, dev, card):
    """Phase 13: dictionary decode of both committed sets.  Returns each
    decode kernel's launches in the two counted runs."""
    import numpy as np
    import torch

    from zstdsharp_tpu_torch.decode import device_pipeline as dp
    from zstdsharp_tpu_torch.decode.frame import Decompressor
    from zstdsharp_tpu_torch.dictionary import parse_dictionary
    from zstdsharp_tpu_torch.ops import device_fse as df
    from zstdsharp_tpu_torch.ops import device_huf as dh

    sets = _dict_sets()
    launches = dict.fromkeys(DECODE_KERNELS, 0)
    for name, mod, which, outputs_of in (
            ("json", df, "fse", lambda o: o),
            ("corpus", dh, "huf", lambda o: (o,))):
        d, frames, recs = sets.load(name, big)
        pd = parse_dictionary(d)
        plan = dp.plan_batch(frames, pd)
        ops = dp.ops_to_device(getattr(plan.nb, f"{which}_ops")(0), dev)
        dp._release_ops(plan.nb, None)
        err = _dict_kernel_check(mod, ops, outputs_of, f"{which} ({name})")

        dec = Decompressor()
        dec.load_dictionary(d)
        _reset_counts()
        outs, lens, host = dec.unwrap_many_device(frames, dev)
        torch.cuda.synchronize()
        counts = _counts()
        for k in launches:
            launches[k] += counts[k]
        _check(_frame_bytes(len(frames), outs, lens, host) == recs,
               f"set {name}: decoded bytes equal the records")
        c_outs, c_lens, c_host = dp.decode_batch_device(frames, device="cpu",
                                                        ddict=pd)
        routed = [fi for fi, v in host.items() if isinstance(v, bytes)]
        c_routed = [fi for fi, v in c_host.items() if isinstance(v, bytes)]
        _check(routed == c_routed == [], f"set {name}: host-routed {routed},"
               f" CPU port {c_routed}")
        _check(np.array_equal(lens, c_lens) and len(outs) == len(c_outs)
               and all(torch.equal(o.cpu(), c) for o, c in zip(outs, c_outs))
               and all(torch.equal(v.cpu(), c_host[k])
                       for k, v in host.items()),
               f"set {name}: rows equal the port's CPU run")

        payload = sum(map(len, recs))

        def run():
            dec.unwrap_many_device(frames, dev)
            torch.cuda.synchronize()

        run()
        e2e = sorted(_timed(run) for _ in range(3))[1]
        marg = max((_timed(lambda: [run() for _ in range(3)]) - _timed(run))
                   / 2, 1e-9)
        stages = {}
        dp.decode_batch_device(frames, device=dev, ddict=pd, timings=stages)
        with pd.native() as dd:
            _check(dd.decompress_many(frames) == recs,
                   f"set {name}: NativeDDict.decompress_many")
            host_s = sorted(_timed(lambda: dd.decompress_many(frames))
                            for _ in range(3))[1]
        print(f"phase dictionary {name}: {len(frames)} frames, "
              f"{sum(map(len, frames))} B -> {payload} B byte-exact via "
              f"load_dictionary ({len(d)} B) + unwrap_many_device, rows == "
              f"CPU port, host-routed 0 (CPU port 0); {which} kernel == plain "
              f"on the set's operands (max_abs_err {err}); launches {counts}; "
              f"end-to-end {payload / e2e / 1e9:.4f} GB/s ({e2e * 1e3:.2f} "
              f"ms), marginal {payload / marg / 1e9:.4f} GB/s "
              f"({marg * 1e3:.2f} ms); stages ms "
              f"{_stage_ms(stages)}; host "
              f"NativeDDict.decompress_many {payload / host_s / 1e9:.4f} GB/s "
              f"({host_s * 1e3:.2f} ms) on {card}")
    _check(all(v > 0 for v in launches.values()),
           f"decode kernels launched on the dictionary path {launches}")
    return launches


def _ldm_phase(data, dev, card):
    """Phase 14: the LDM anchor scan over the 8 MB prefix on the card."""
    import numpy as np
    import torch

    from zstdsharp_tpu_torch.kernel_bench import bound
    from zstdsharp_tpu_torch.ops.ldm import DEFAULT_RATE_LOG, ldm_anchor_mask

    src = torch.from_numpy(np.frombuffer(data, np.uint8).copy())
    src_d = src.to(dev)
    got = ldm_anchor_mask(src_d)
    torch.cuda.synchronize()
    want = ldm_anchor_mask(src)
    _check(got.device == dev and torch.equal(got.cpu(), want),
           "ldm_anchor_mask on the card equals its CPU run")
    ms = _gpu_ms(lambda: ldm_anchor_mask(src_d), 20)
    cpu_ms = _timed(lambda: ldm_anchor_mask(src)) * 1e3
    n, r = len(data), DEFAULT_RATE_LOG
    # a byte in and a mask byte out; gear (5 operations), r - 1 shifted
    # adds, the mask and the compare
    bound_ms, bound_by = bound(2 * n, n * (5 + 2 * (r - 1) + 2))
    print(f"phase ldm: ldm_anchor_mask(rate_log {r}) over {n} B on the "
          f"card == CPU run, {int(got.sum())} anchors; {ms:.4f} ms (CUDA "
          f"events over 20 calls; torch ops, no hand kernel), bound "
          f"{bound_ms:.5f} ms ({bound_by}); host CPU {cpu_ms:.1f} ms on "
          f"{card}")


def _api_phase(recs, data, card):
    """Phase 15: the public API of ``zstdsharp_tpu_torch`` on the card
    host.  Returns each decode kernel's launches in its counted runs."""
    import io

    import torch

    import zstdsharp_tpu_torch as z
    from zstdsharp_tpu_torch.encode.params import CCtxParams

    sets = _dict_sets()
    d0, frames0, jrecs = sets.load("json")
    launches = dict.fromkeys(DECODE_KERNELS, 0)
    cuda0 = torch.device("cuda", 0)

    def counted(dec, frames):
        _reset_counts()
        t = time.perf_counter()
        outs, lens, host = dec.unwrap_many_device(frames)
        torch.cuda.synchronize()
        s = time.perf_counter() - t
        counts = _counts()
        for k in launches:
            launches[k] += counts[k]
        _check(all(o.device == cuda0 for o in outs)
               and all(v.device == cuda0 for v in host.values()
                       if not isinstance(v, bytes)),
               "unwrap_many_device() with no device decodes on cuda:0")
        return _frame_bytes(len(frames), outs, lens, host), host, counts, s

    # (a) the json set, made on this host
    t = time.perf_counter()
    d = z.train_dictionary(jrecs[:1000], sets.JSON_DICT_SIZE)
    train_s = time.perf_counter() - t
    _check(d == d0, "train_dictionary equals the committed dictionary")
    comp = z.Compressor(level=sets.JSON_LEVEL)
    comp.load_dictionary(d)
    t = time.perf_counter()
    frames = comp.wrap_many(jrecs)
    wrap_s = time.perf_counter() - t
    _check(frames == frames0, "wrap_many equals the committed frames")
    dec = z.Decompressor()
    dec.load_dictionary(d)
    got, _, counts_a, dev_s = counted(dec, frames)
    _check(got == jrecs, "dictionary frames decode byte-exact on the card")
    _check(counts_a["fse_decode"] > 0 and counts_a["lz_exec"] > 0,
           f"FSE and LZ executor kernels launched {counts_a}")
    t = time.perf_counter()
    _check(dec.unwrap_many(frames) == jrecs, "unwrap_many on the host")
    host_s = time.perf_counter() - t
    print(f"phase public API (a): json set made here: train_dictionary "
          f"{train_s * 1e3:.1f} ms == committed ({len(d)} B), wrap_many "
          f"{wrap_s * 1e3:.1f} ms == committed {len(frames)} frames, "
          f"unwrap_many_device() {dev_s * 1e3:.1f} ms byte-exact on cuda:0 "
          f"(launches {counts_a}), unwrap_many {host_s * 1e3:.1f} ms on the "
          f"host, on {card}")

    # (b) a batch without a dictionary
    t = time.perf_counter()
    frames9 = z.Compressor(level=9).wrap_many(recs)
    wrap9_s = time.perf_counter() - t
    got, host, counts_b, dev9_s = counted(z.Decompressor(), frames9)
    _check(got == recs, "level-9 frames decode byte-exact on the card")
    _check(all(counts_b[k] > 0 for k in launches),
           f"the decode kernels launched {counts_b}")
    routed = sum(isinstance(v, bytes) for v in host.values())
    print(f"phase public API (b): Compressor(9).wrap_many of {len(recs)} x "
          f"{REC_SIZE} B {wrap9_s * 1e3:.1f} ms, unwrap_many_device() "
          f"{dev9_s * 1e3:.1f} ms byte-exact, host-routed {routed}, "
          f"launches {counts_b}, on {card}")

    # (c) streams and the multi-frame compress
    sink = io.BytesIO()
    t = time.perf_counter()
    cs = z.CompressionStream(sink, level=3, checksum=True)
    pos = writes = flushes = flushed = 0
    while pos < len(data):
        n = (1, 7, 4096, 65_536)[writes % 4]
        cs.write(data[pos:pos + n])
        pos += n
        writes += 1
        if pos - flushed >= 1 << 20:
            cs.flush()
            flushed = pos
            flushes += 1
    cs.close()
    cstream_s = time.perf_counter() - t
    stream = sink.getvalue()
    t = time.perf_counter()
    ds = z.DecompressionStream(io.BytesIO(stream))
    parts, k = [], 0
    while True:
        b = ds.read((7, 65_536)[k % 2])
        k += 1
        if not b:
            break
        parts.append(b)
    dstream_s = time.perf_counter() - t
    _check(b"".join(parts) == data, "DecompressionStream returns the prefix")
    _check(z.decompress(stream) == data, "decompress of the stream")
    t = time.perf_counter()
    multi = z.compress(data, params=CCtxParams(compression_level=3,
                                               n_workers=4))
    mc_s = time.perf_counter() - t
    t = time.perf_counter()
    _check(z.decompress(multi, n_workers=4) == data,
           "compress(n_workers=4) decodes with decompress(n_workers=4)")
    md_s = time.perf_counter() - t
    mb = len(data) / 1e6
    print(f"phase public API (c): CompressionStream L3+checksum {len(data)} B"
          f" in {writes} writes, {flushes} flushes -> {len(stream)} B "
          f"{mb / cstream_s:.1f} MB/s, DecompressionStream (reads of 7 and "
          f"65536 B) {mb / dstream_s:.1f} MB/s; compress(n_workers=4) "
          f"{mb / mc_s:.1f} MB/s -> {len(multi)} B, decompress(n_workers=4) "
          f"{mb / md_s:.1f} MB/s; host CPU, on {card}")
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
    from zstdsharp_tpu_torch import _build, native
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
    lz = _lz_phase(frames, extra_frames[:2], big, dev, card)
    _corrupt_phase(data, dev, card)

    # ---- the decode path, once, through the user entry point ----
    all_in = recs + extras
    all_frames = frames + extra_frames
    _reset_counts()
    outs, lens, host = Decompressor().unwrap_many_device(all_frames, dev)
    torch.cuda.synchronize()
    counts = _counts()
    launches = {k: counts[k] for k in DECODE_KERNELS}
    got = _frame_bytes(len(all_frames), outs, lens, host)
    host_routed = [fi for fi, v in host.items() if isinstance(v, bytes)]
    _check(got == all_in, "decoded bytes equal the inputs")
    _check(not [fi for fi in host_routed if fi < N_RECORDS],
           "no record frame is host-routed")
    _check(all(n > 0 for n in launches.values()), f"kernels launched {launches}")
    results, stats = dp.decode_batch_device(all_frames, device=dev,
                                            materialize=True)
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
    dp.decode_batch_device(frames, device=dev, timings=stages)
    route = native.host_route()
    host_s = sorted(_timed(lambda: [decompress(f) for f in frames])
                    for _ in range(5))[2]
    real_ext = native.get_ext
    native.get_ext = lambda: None  # the ctypes route, in the same process
    try:
        _check(native.host_route() == "ctypes", "the extension is off")
        ctypes_s = sorted(_timed(lambda: [decompress(f) for f in frames])
                          for _ in range(5))[2]
    finally:
        native.get_ext = real_ext
    print(f"phase timings: pipeline {payload} B in {N_RECORDS} frames: "
          f"end-to-end {payload / e2e / 1e9:.4f} GB/s ({e2e * 1e3:.2f} ms), "
          f"marginal {payload / marg / 1e9:.4f} GB/s ({marg * 1e3:.2f} ms); "
          f"stages ms {_stage_ms(stages)}; "
          f"host decompress (route {route}) {payload / host_s / 1e9:.4f} "
          f"GB/s ({host_s * 1e3:.2f} ms), through ctypes with the extension "
          f"off {payload / ctypes_s / 1e9:.4f} GB/s ({ctypes_s * 1e3:.2f} "
          f"ms), medians of 5 on {card}")

    hist, lzp, asmb, enc_launches = _encode_phases(data, dev, card)
    launches.update(enc_launches)
    dp_launches = _stream_phases(big, data, recs, frames,
                                 _encode_workload(data)[0], dev, card)
    launches = {k: launches[k] + dp_launches[k] for k in launches}
    for k, v in _dict_phases(big, dev, card).items():
        launches[k] += v
    _ldm_phase(data, dev, card)
    for k, v in _api_phase(recs, data, card).items():
        launches[k] += v
    lz.update(_decode_profile_phase(frames, dev, card))
    parse_prof, asm_prof = _encode_profile_phase(_encode_workload(data)[0],
                                                 dev, card)
    lzp.update(parse_prof)
    asmb.update(asm_prof)
    _stream_profile(big, dev, card)

    kernels = [{"name": name, "route": "cuda",
                "source": f"zstdsharp_tpu_torch/csrc/{src}",
                "replaces": f"zstdsharp_tpu/ops/{rep}",
                "launches": launches[name], **fields}
               for name, fields, src, rep in (
                   ("huf_decode", huf, "huf_decode.cu", "device_huf.py:238"),
                   ("fse_decode", fse, "fse_decode.cu", "device_fse.py:292"),
                   ("histogram", hist, "histogram.cu", "histogram.py:36"),
                   ("lz_exec", lz, "lz_exec.cu", "execseq.py:41"),
                   ("lz_parse", lzp, "lz_parse.cu", "device_encode.py:421"),
                   ("assemble", asmb, "assemble.cu", "device_encode.py:643"))]
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
