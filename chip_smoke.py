"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Drives the port's two record-batch paths once each through their user
entry points:

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
     the operands the native planner packs for the decode workload;
  3. the same for the FSE kernel;
  4. decode end to end: decoded bytes equal the inputs, none of the 256
     records is routed to the host, both decode kernels were launched;
  5. decode timings (printed, not asserted): each kernel and its plain
     version, the pipeline's end-to-end and marginal GB/s and its stage
     times, and the host decoder on the same frames;
  6. the histogram kernel against its plain torch version on the encode
     workload's literal rows (the first chunk's [32, 16384] with their
     prefix masks) and on an unmasked 1-D vector of odd length;
  7. encode end to end: every frame decodes byte-exact with the host tier,
     the 256 records' frames decode byte-exact through the port's decode
     plane with none routed to the host, none of the 256 records is
     routed to the host encoder, the first 32-record chunk's frames equal
     the port's CPU run byte for byte, and the histogram kernel was
     launched;
  8. encode timings (printed, not asserted): marginal GB/s, stage times,
     compressed bytes, and the host tier's level-1 compress on the same
     records.

Each path runs with every kernel's launch count set to 0 just before it
and read just after.

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

    from zstdsharp_tpu.decode.frame import parse_frame_header

    p = parse_frame_header(np.frombuffer(frame, np.uint8)).header_size
    bh = int.from_bytes(frame[p:p + 3], "little")
    return bh & 1, (bh >> 1) & 3


def _workload(data):
    """(records, their frames, extra inputs, their frames)."""
    import numpy as np

    from zstdsharp_tpu.encode.frame import compress

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


def _kernel_phase(name, mod, ops, outputs_of, mask_key, card):
    """Kernel vs plain version on the card at the workload's shapes."""
    import torch

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
    plain_ms = _gpu_ms(lambda: mod.decode_plain(*args, t_len), 1)
    print(f"phase {name}: kernel == plain over {int(live.sum())} entries of "
          f"{len(got)} x {tuple(got[0].shape)} (max_abs_err {err}); "
          f"kernel {ms:.4f} ms, plain {plain_ms:.2f} ms on {card}")
    return err, ms, plain_ms


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
    their prefix masks, and an unmasked odd-length vector."""
    import torch

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
    plain_ms = _gpu_ms(lambda: hg.histogram_plain(lit_sorted, mask), 20)
    odd_ms = _gpu_ms(lambda: hg.histogram_u8(odd), 20)
    odd_plain = _gpu_ms(lambda: hg.histogram_plain(odd), 20)
    print(f"phase histogram: kernel == plain on lit_sorted "
          f"{tuple(lit_sorted.shape)} masked ({int(mask.sum())} literals) and "
          f"on {odd.shape[0]} unmasked bytes (max_abs_err {err}); kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms; odd vector kernel "
          f"{odd_ms:.4f} ms, plain {odd_plain:.4f} ms on {card}")
    return err, ms, plain_ms


def _encode_phases(data, dev, card):
    """Phases 6-8.  Returns ((max_abs_err, ms, plain_ms) of the histogram
    kernel, its launches in the encode path)."""
    import numpy as np
    import torch

    from zstdsharp_tpu.decode.frame import decompress
    from zstdsharp_tpu.encode.frame import compress
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

    from zstdsharp_tpu.decode.frame import decompress
    from zstdsharp_tpu_torch import _build
    from zstdsharp_tpu_torch.decode import device_pipeline as dp
    from zstdsharp_tpu_torch.decode.frame import Decompressor
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

    data = make_corpus(8 << 20)
    recs, frames, extras, extra_frames = _workload(data)
    print(f"workload: {len(frames)} records x {REC_SIZE} B at level 9 -> "
          f"{sum(map(len, frames))} B, plus {len(extra_frames)} frames "
          f"(2 x 400 KB multi-block L3, raw block, RLE block)")

    # ---- kernels against their plain versions, planner operands ----
    plan = dp.plan_batch(frames + extra_frames)
    hops = dp.ops_to_device(plan.nb.huf_ops(0), dev)
    fops = dp.ops_to_device(plan.nb.fse_ops(0), dev)
    dp._release_ops(plan.nb, None)
    huf = _kernel_phase("huf_decode", dh, hops, lambda o: (o,), "nsym", card)
    fse = _kernel_phase("fse_decode", df, fops, lambda o: o, "nseq", card)

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

    kernels = []
    for name, (err, ms, plain_ms), src, rep in (
            ("huf_decode", huf, "huf_decode.cu", "device_huf.py:238"),
            ("fse_decode", fse, "fse_decode.cu", "device_fse.py:292"),
            ("histogram", hist, "histogram.cu", "histogram.py:36")):
        kernels.append({"name": name, "route": "cuda",
                        "source": f"zstdsharp_tpu_torch/csrc/{src}",
                        "replaces": f"zstdsharp_tpu/ops/{rep}",
                        "launches": launches[name], "max_abs_err": err,
                        "ms": ms, "plain_ms": plain_ms})
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
