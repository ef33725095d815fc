"""A/B of the torch port's record-batch decode between checkouts, on one GPU.

For each turn a fresh process imports one checkout's ``zstdsharp_tpu_torch``
and ``bench.make_corpus``, builds its kernels, checks that
``Decompressor().unwrap_many_device`` decodes the bench's decode workload
(the first 6 MB of ``make_corpus`` as 256 records of 24 KB at level 9)
byte-exact with no frame routed to the host, and times it: the end-to-end
ms of each of ``--reps`` calls (each ending in ``torch.cuda.synchronize``)
and, over as many more calls, the stage times of
``decode_batch_device(timings=)``, then the ms of ``--reps`` calls of
``decode_batch_device(materialize=True)`` (the rows brought to the host
and checked) and of the host decoder ``decompress`` over the same frames,
with the checkout's host route (``native.host_route()``: "ztpy" or
"ctypes"; a checkout without it has only ctypes).  Checkouts run in turns,
A B B A for two
(``--rounds`` times), so drift on the machine hits both alike.  The two
committed dictionary sets of tests/torch_data/dict_sets.py (``json`` and
``corpus``) are decoded the same way in the same turn through
``decode_batch_device(ddict=)``: byte-exact, then end-to-end ms and stage
times (set ``corpus`` has multi-block frames, so ``mb_exec``).  Each turn
ends with one decode of the workload under torch.profiler: wall ms, device
events, the device's busy ms (the union of their intervals) and share,
the LZ executor kernel's launches and device ms (``lz_exec_launches``,
``lz_exec_device_ms``), and device ms by kernel name.  Prints one JSON
line per turn, the ``exec`` / ``mb_exec`` stages among its stage medians,
and writes the list to ``--out``.

    python tools/torch_decode_ab.py --tree build/ab/parent --tree . \\
        --out build/decode_ab.json
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

REC_SIZE = 24 << 10
DICT_SETS = ("json", "corpus")
# the LZ executor kernel's name in csrc/lz_exec.cu: the one-chunk executor
# (lz_exec_kernel) and the fused lane decode that replaced it (lz_kernel)
LZ_KERNELS = ("lz_exec_kernel", "lz_kernel")


def _time(call, reps: int) -> tuple[list, dict]:
    """(end-to-end ms of `reps` calls, stage ms of `reps` timed calls):
    call(timings) decodes once, ending in a synchronise."""
    call(None)
    e2e, stages = [], {}
    for _ in range(reps):
        t = time.perf_counter()
        call(None)
        e2e.append((time.perf_counter() - t) * 1e3)
    for _ in range(reps):
        tm: dict = {}
        call(tm)
        for k, v in tm.items():
            stages.setdefault(k, []).append(
                v if k.startswith("n.") else v * 1e3)
    return e2e, stages


def _profile(call) -> dict:
    """One call(None) under torch.profiler: wall ms, device events, busy
    ms and share, and the 8 largest device ms by kernel name."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        call(None)
        wall = (time.perf_counter() - t) * 1e3
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy, end, by_name = 0.0, float("-inf"), {}
    for e in sorted(events, key=lambda e: e.time_range.start):
        lo, hi = max(e.time_range.start, end), e.time_range.end
        busy += max(hi - lo, 0.0)
        end = max(end, hi)
        by_name[e.name] = by_name.get(e.name, 0.0) + \
            e.time_range.elapsed_us() / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    lz = [e for e in events if any(k in e.name for k in LZ_KERNELS)]
    return {"wall_ms": wall, "device_events": len(events),
            "device_busy_ms": busy / 1e3, "busy_share": busy / 1e3 / wall,
            "lz_exec_launches": len(lz),
            "lz_exec_device_ms": sum(e.time_range.elapsed_us()
                                     for e in lz) / 1e3,
            "device_ms_by_name": dict(top)}


def child(tree: Path, reps: int) -> dict:
    sys.path.insert(0, str(tree))
    import torch

    from bench import make_corpus
    from zstdsharp_tpu_torch.decode import device_pipeline as dp
    from zstdsharp_tpu_torch.decode.frame import Decompressor
    from zstdsharp_tpu_torch.encode.frame import compress

    data = make_corpus(6 << 20)
    recs = [data[i:i + REC_SIZE] for i in range(0, 6 << 20, REC_SIZE)]
    frames = [compress(r, 9) for r in recs]
    dev = torch.device("cuda", 0)
    results, stats = dp.decode_batch_device(frames, device=dev,
                                            materialize=True)
    if results != recs or stats["host_frames"]:
        raise RuntimeError(f"{tree}: decode not byte-exact or host-routed")

    def run(tm):
        if tm is None:
            Decompressor().unwrap_many_device(frames, dev)
        else:
            dp.decode_batch_device(frames, device=dev, timings=tm)
        torch.cuda.synchronize()

    e2e, stages = _time(run, reps)
    from zstdsharp_tpu_torch import native
    from zstdsharp_tpu_torch.decode.frame import decompress

    def ms_of(fn):
        fn()
        times = []
        for _ in range(reps):
            t = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t) * 1e3)
        return times

    def materialize():
        dp.decode_batch_device(frames, device=dev, materialize=True)

    out = {"tree": str(tree), "card": torch.cuda.get_device_name(0),
           "e2e_ms": e2e, "stages_ms": stages,
           "materialize_ms": ms_of(materialize),
           "host_route": getattr(native, "host_route", lambda: "ctypes")(),
           "host_ms": ms_of(lambda: [decompress(f) for f in frames])}
    sys.path.insert(0, str(tree / "tests" / "torch_data"))
    import dict_sets as sets

    from zstdsharp_tpu_torch.dictionary import parse_dictionary
    for name in DICT_SETS:
        d, dframes, drecs = sets.load(name)
        pd = parse_dictionary(d)
        results, stats = dp.decode_batch_device(dframes, device=dev, ddict=pd,
                                                materialize=True)
        if results != drecs or stats["host_frames"]:
            raise RuntimeError(f"{tree}: set {name} not byte-exact or "
                               "host-routed")

        def run_set(tm):
            dp.decode_batch_device(dframes, device=dev, ddict=pd, timings=tm)
            torch.cuda.synchronize()

        out[f"dict_{name}"] = dict(zip(("e2e_ms", "stages_ms"),
                                       _time(run_set, reps)))
    out["profile"] = _profile(run)  # last: runs after a profile are slower
    return out


def _medians(r: dict) -> dict:
    def median(v):
        return sorted(v)[len(v) // 2]

    out = {"e2e_ms_median": median(r["e2e_ms"]),
           "stages_ms_median": {k: median(v)
                                for k, v in r["stages_ms"].items()}}
    for k in ("materialize_ms", "host_ms"):
        if k in r:
            out[f"{k}_median"] = median(r[k])
    if "host_route" in r:
        out["host_route"] = r["host_route"]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", type=Path, action="append", required=True,
                    help="a checkout's root (repeatable)")
    ap.add_argument("--reps", type=int, default=15)
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--out", type=Path, default=Path("build/decode_ab.json"))
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
                           capture_output=True, text=True, timeout=900)
        if r.returncode != 0:
            print(r.stderr[-4000:], file=sys.stderr)
            return 1
        turns.append(json.loads(r.stdout.strip().splitlines()[-1]))
        line = {"tree": str(tree), **_medians(turns[-1]),
                "profile": turns[-1]["profile"]}
        for name in DICT_SETS:
            line[f"dict_{name}"] = _medians(turns[-1][f"dict_{name}"])
        print(json.dumps(line))
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(turns))
    return 0


if __name__ == "__main__":
    sys.exit(main())
