"""A/B of the torch port's record-batch encode between checkouts, on one GPU.

For each turn a fresh process imports one checkout's ``zstdsharp_tpu_torch``
and ``bench.make_corpus``, builds its kernels, encodes the bench's encode
workload (the first 4 MB of ``make_corpus`` as 256 records of 16 KB)
through ``compress_batch_device``, checks that every frame decodes
byte-exact through the checkout's host ``decompress`` with no record routed
to the host encoder, and times it: the end-to-end ms of each of ``--reps``
calls (each ending in ``torch.cuda.synchronize``), the marginal ms of a
call ((3 calls - 1 call) / 2, ``--reps`` pairs), over as many more calls
the stage times of ``compress_batch_device(timings=)`` (``parse``,
``tables``, ``assembly``), and the host ``compress(x, 1)`` of the same
records.  Each turn ends with one encode under torch.profiler: wall ms,
device events (in all and a chunk), the device's busy ms (the union of
their intervals) and share, the parse kernel's and the assembly kernel's
launches and device ms (``csrc/lz_parse.cu``'s ``parse_kernel``,
``csrc/assemble.cu``'s ``assemble_kernel``; none in a checkout without
them) and device ms by kernel name.  Before the profile each turn times
the host work of the assembly kernel's wrapper on the first chunk's
call (``kernel_bench.host_ms`` over 200 calls, the enqueue alone; in a
checkout whose ``kernel_bench`` has ``capture_assemble``).  Checkouts
run in turns, A B B A for two (``--rounds`` times).  Prints one JSON line
per turn with the medians,
and writes every turn to ``--out``.  The frames' SHA-256 is printed too,
so that two checkouts can be seen to write the same bytes.

    python tools/torch_encode_ab.py --tree build/ab/parent --tree . \\
        --out build/encode_ab.json
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

REC_SIZE = 16 << 10
N_RECORDS = 256
LANES = 32


def _profile(call) -> dict:
    """One call() under torch.profiler: wall ms, device events, busy ms
    and share, the parse kernel's launches and device ms, and the 8
    largest device ms by kernel name."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        call()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy, end, by_name = 0.0, float("-inf"), {}
    for e in sorted(events, key=lambda e: e.time_range.start):
        lo, hi = max(e.time_range.start, end), e.time_range.end
        busy += max(hi - lo, 0.0)
        end = max(end, hi)
        by_name[e.name] = by_name.get(e.name, 0.0) + \
            e.time_range.elapsed_us() / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    parse = [e for e in events if "parse_kernel" in e.name]
    asm = [e for e in events if "assemble_kernel" in e.name]
    return {"wall_ms": wall, "device_events": len(events),
            "events_a_chunk": len(events) / (N_RECORDS // LANES),
            "device_busy_ms": busy / 1e3, "busy_share": busy / 1e3 / wall,
            "parse_launches": len(parse),
            "parse_device_ms": sum(e.time_range.elapsed_us()
                                   for e in parse) / 1e3,
            "assemble_launches": len(asm),
            "assemble_device_ms": sum(e.time_range.elapsed_us()
                                      for e in asm) / 1e3,
            "device_ms_by_name": dict(top)}


def child(tree: Path, reps: int) -> dict:
    sys.path.insert(0, str(tree))
    import torch

    from bench import make_corpus
    from zstdsharp_tpu_torch.decode.frame import decompress
    from zstdsharp_tpu_torch.encode.device_pipeline import (
        compress_batch_device)
    from zstdsharp_tpu_torch.encode.frame import compress

    data = make_corpus(4 << 20)
    recs = [data[i:i + REC_SIZE] for i in range(0, 4 << 20, REC_SIZE)]
    dev = torch.device("cuda", 0)
    frames, stats = compress_batch_device(recs, device=dev, materialize=True)
    if [decompress(f) for f in frames] != recs or stats["host_frames"]:
        raise RuntimeError(f"{tree}: frames not byte-exact or host-routed")

    def run(tm=None):
        compress_batch_device(recs, device=dev, timings=tm)
        torch.cuda.synchronize()

    def ms(fn):
        t = time.perf_counter()
        fn()
        return (time.perf_counter() - t) * 1e3

    run()
    e2e = [ms(run) for _ in range(reps)]
    marginal = [(ms(lambda: [run() for _ in range(3)]) - ms(run)) / 2
                for _ in range(reps)]
    stages: dict = {}
    for _ in range(reps):
        tm: dict = {}
        run(tm)
        for k, v in tm.items():
            stages.setdefault(k, []).append(v * 1e3)
    host = [ms(lambda: [compress(r, 1) for r in recs]) for _ in range(reps)]
    wrapper = None
    from zstdsharp_tpu_torch import kernel_bench
    if hasattr(kernel_bench, "capture_assemble"):
        cell = kernel_bench.capture_assemble(
            lambda: compress_batch_device(recs[:LANES], device=dev))[0]
        wrapper = kernel_bench.host_ms(
            lambda: kernel_bench.run_assemble(cell), 200)
    return {"tree": str(tree), "card": torch.cuda.get_device_name(0),
            "frames_sha256": hashlib.sha256(b"".join(frames)).hexdigest(),
            "compressed_bytes": sum(map(len, frames)),
            "e2e_ms": e2e, "marginal_ms": marginal, "stages_ms": stages,
            "host_ms": host, "assemble_wrapper_host_ms": wrapper,
            "profile": _profile(run)}  # last: runs after a profile are slower


def _median(v):
    return sorted(v)[len(v) // 2]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", type=Path, action="append", required=True,
                    help="a checkout's root (repeatable)")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--out", type=Path, default=Path("build/encode_ab.json"))
    ap.add_argument("--child", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child is not None:
        print(json.dumps(child(args.child.resolve(), args.reps)))
        return 0
    trees = [t.resolve() for t in args.tree]
    order = []
    for _ in range(args.rounds):
        order += trees + trees[::-1]
    turns = []
    for tree in order:
        r = subprocess.run([sys.executable, __file__, "--tree", str(tree),
                            "--child", str(tree), "--reps", str(args.reps)],
                           capture_output=True, text=True, timeout=1200)
        if r.returncode != 0:
            print(r.stderr[-4000:], file=sys.stderr)
            return 1
        t = json.loads(r.stdout.strip().splitlines()[-1])
        turns.append(t)
        print(json.dumps({
            "tree": t["tree"], "card": t["card"],
            "frames_sha256": t["frames_sha256"],
            "compressed_bytes": t["compressed_bytes"],
            "e2e_ms_median": _median(t["e2e_ms"]),
            "marginal_ms_median": _median(t["marginal_ms"]),
            "stages_ms_median": {k: _median(v)
                                 for k, v in t["stages_ms"].items()},
            "host_ms_median": _median(t["host_ms"]),
            "assemble_wrapper_host_ms": t["assemble_wrapper_host_ms"],
            "profile": t["profile"]}))
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(turns))
    return 0


if __name__ == "__main__":
    sys.exit(main())
