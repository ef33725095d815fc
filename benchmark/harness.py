"""Runs one cell of ``BENCHMARK.json`` once and builds its result line.

Everything that belongs to one configuration, traffic mix, plane or metric
is a file of its own, found by the name ``BENCHMARK.json`` gives:

- ``configs/<config>.json``: the deployment (its payload, record size,
  level, guarantees);
- ``traffic/<traffic>.json``: the mix (its plane, records a call, their
  lengths, the pool of distinct batches, the records the check samples);
- ``planes/<plane>.py``: the program's entry for that plane (``prepare``,
  ``call``, ``account``, ``check``, ``control``);
- ``metrics/<metric>.py``: each metric's unit, layer, the end-to-end metric
  it moves and its reader (``read(ctx)``, None where it finds nothing).

A run: set-up (the pool from the seed, one warm call), then
a closed loop of one caller for ``--seconds`` (each call one batch, the next
after the previous call's synchronisation, the batches in turn).  With
``--trace 1`` the window is two halves: the first under torch.profiler, the
second with the program's stage ``timings``.  Outputs of calls drawn from
the seed are kept and checked once the window has closed.
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "zstdsharp_tpu")
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA's data sheet
PROFILE_CAP_S = 4.0         # the profiled half of a traced run, at most
KEEP_CALLS = 6              # calls kept for the check, besides the last


def load_spec() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def find_cell(spec: dict, name: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def load_json(kind: str, name: str, root: Path = ROOT) -> dict:
    return json.loads((root / "benchmark" / kind / f"{name}.json").read_text())


def config_of(spec: dict, cell: dict, root: Path = ROOT) -> dict:
    entry = next(c for c in spec["configs"] if c["name"] == cell["config"])
    return json.loads((root / entry["file"]).read_text())


def load_module(kind: str, name: str, root: Path = ROOT):
    """``<root>/benchmark/<kind>/<name>.py`` (a plane or a metric)."""
    path = root / "benchmark" / kind / f"{name}.py"
    s = importlib.util.spec_from_file_location(
        f"benchmark.{kind}.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(s)
    s.loader.exec_module(mod)
    return mod


def cell_metrics(spec: dict, cell: str, trace: bool) -> list:
    """The metric entries this cell reports in a run of this kind."""
    group = spec["per_layer"] if trace else spec["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


class Keeper:
    """Draws from the seed which calls' outputs are kept for the check:
    KEEP_CALLS of the window's calls, each call as likely as any other
    (a reservoir sample), and the window's last call besides."""

    def __init__(self, seed: int):
        self.rng = np.random.default_rng([seed, 1])
        self.seen = 0
        self.kept: list = []

    def offer(self, k: int, res) -> bool:
        self.seen += 1
        if len(self.kept) < KEEP_CALLS:
            self.kept.append((k, res))
            return True
        j = int(self.rng.integers(0, self.seen))
        if j < KEEP_CALLS:
            self.kept[j] = (k, res)
            return True
        return False


def timed_window(plane, st, seconds: float, keeper: Keeper, sync,
                 first: int = 0, timings: dict | None = None,
                 annotate: bool = False) -> dict:
    """Calls batches first, first + 1, ... (mod the pool) one after another
    until `seconds` have passed; the window runs from the first call's start
    to the last call's end."""
    from torch.profiler import record_function

    w = {"calls": 0, "latencies": [], "batches": [], "items": 0,
         "content_bytes": 0, "frame_bytes": 0, "host_routed": 0}
    i = first
    start = time.perf_counter()
    while True:
        k = i % st.n_batches
        t0 = time.perf_counter()
        if annotate:
            with record_function("benchmark.call"):
                res = plane.call(st, k, timings)
                sync()
        else:
            res = plane.call(st, k, timings)
            sync()
        t1 = time.perf_counter()
        w["latencies"].append(t1 - t0)
        w["batches"].append(k)
        for key, v in plane.account(st, k, res).items():
            w[key] += v
        w["calls"] += 1
        i += 1
        done = t1 - start >= seconds
        if not keeper.offer(k, res) and done:
            keeper.kept.append((k, res))
        res = None  # the caller is done with it before the next call
        if done:
            break
    w["seconds"] = t1 - start
    w["next"] = i
    return w


def _power_limit() -> str:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
        return r.stdout.strip().splitlines()[0] if r.stdout.strip() else "?"
    except (OSError, subprocess.TimeoutExpired):
        return "nvidia-smi not available"


def run_cell(spec: dict, name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: float | None = None,
             root: Path = ROOT):
    """One run of cell `name`, its files found under `root`.  Returns
    (result dict, stderr lines)."""
    import torch

    from benchmark import devtrace as tr

    t_start = time.perf_counter() if t_start is None else t_start
    cell = find_cell(spec, name)
    cfg = config_of(spec, cell, root)
    mix = load_json("traffic", cell["traffic"], root)
    plane = load_module("planes", mix["plane"], root)
    on_card = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    notes = []

    # ---- set-up: the pool; one warm call, which loads every kernel (they
    # are built ahead, so no shape of the pool compiles anything) ----
    st = plane.prepare(cfg, mix, seed, device)
    t0 = time.perf_counter()
    plane.call(st, 0)
    sync()
    warm = time.perf_counter() - t0
    setup_s = time.perf_counter() - t_start
    keeper = Keeper(seed)

    ctx = {"plane": mix["plane"], "on_card": on_card, "setup_s": setup_s,
           "window": None, "profile": None, "stages": None,
           "counter_specs": None, "peak_bytes_per_s": PEAK_BYTES_PER_S}
    windows = []
    if not trace:
        ctx["window"] = timed_window(plane, st, seconds, keeper, sync)
        windows.append(ctx["window"])
    else:
        from torch.profiler import ProfilerActivity, profile, record_function

        specs = tr.counter_specs()
        ctx["counter_specs"] = specs
        a_s = min(PROFILE_CAP_S, seconds / 2)
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if on_card else [])
        before = tr.read_counters(specs)
        with profile(activities=acts) as prof:
            with record_function(tr.WINDOW):
                pw = timed_window(plane, st, a_s, keeper, sync,
                                  annotate=True)
        after = tr.read_counters(specs)
        t_read = time.perf_counter()
        pw.update(tr.reduce_profile(tr.profiler_events(prof), specs,
                                    before, after))
        notes.append(f"profile read in {time.perf_counter() - t_read:.1f} s")
        del prof
        timings: dict = {}
        sw = timed_window(plane, st, max(seconds - pw["seconds"], 0.0),
                          keeper, sync, first=pw["next"], timings=timings)
        sw["timings"] = timings
        ctx["profile"], ctx["stages"] = pw, sw
        windows += [pw, sw]
        notes.append(f"card: {_power_limit() if on_card else 'none'}")
        notes.append(f"traced calls: {pw['calls']} profiled, "
                     f"{sw['calls']} with stage timings")
        for kern, (counted, recorded) in pw.get("launch_counts", {}).items():
            notes.append(f"{kern}: {counted} launches counted by the "
                         f"wrapper, {recorded} recorded by the profiler")
    peak = int(torch.cuda.max_memory_allocated()) if on_card else 0
    for w in windows:
        lat = 1e3 * np.array(w["latencies"])
        notes.append(f"{w['calls']} calls in {w['seconds']:.3f} s, ms a call: "
                     f"min {lat.min():.2f} median {np.median(lat):.2f} "
                     f"p90 {np.percentile(lat, 90):.2f} max {lat.max():.2f}; "
                     "median by batch " + " ".join(
                         f"{np.median(lat[np.array(w['batches']) == k]):.2f}"
                         for k in sorted(set(w["batches"]))))
    notes.append(f"set-up {setup_s:.2f} s, warm call {1e3 * warm:.1f} ms")

    # ---- the check, once the window has closed ----
    kept = keeper.kept
    keeper.kept = []
    windows_items = sum(w["items"] for w in windows)
    t_check = time.perf_counter()
    limits = plane.check(st, mix, kept, np.random.default_rng([seed, 2]))
    del kept
    notes.append(f"check took {time.perf_counter() - t_check:.1f} s")
    correct = windows_items > 0 and all(
        (v["value"] <= v["at_most"]) if "at_most" in v
        else (v["value"] >= v["at_least"]) for v in limits.values())
    failed = sum(v["value"] for v in limits.values() if "at_most" in v)

    metrics = {}
    for m in cell_metrics(spec, name, trace):
        value = load_module("metrics", m["name"], root).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": int(cell["chips"]), "memory_peak_bytes": peak}
    result = {"correct": bool(correct), "attempted": int(windows_items),
              "failed": int(failed), "metrics": metrics, "device": dev}
    if trace and on_card and "busy_s" in (ctx["profile"] or {}):
        dev["busy_s"] = ctx["profile"]["busy_s"]
        dev["window_s"] = ctx["profile"]["window_s"]
        result["breakdown"] = ctx["profile"]["breakdown"]
    result["limits"] = limits
    lines = notes + [
        f"{n} = {v['value']} ({'at most' if 'at_most' in v else 'at least'} "
        f"{v.get('at_most', v.get('at_least'))})" for n, v in limits.items()]
    return result, lines


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def main(args, t_start: float) -> int:
    try:
        spec = load_spec()
        cell = find_cell(spec, args.workload)
    except (OSError, KeyError, ValueError) as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    import torch

    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < int(cell["chips"]):
        print(f"benchmark: {args.workload} needs {cell['chips']} CUDA "
              f"device(s); found {found}", file=sys.stderr)
        return 3
    result, lines = run_cell(spec, args.workload, args.seed, args.seconds,
                             bool(args.trace), "cuda", t_start)
    leaked = forbidden_modules()
    if leaked:
        print(f"benchmark: the run loaded {', '.join(leaked)}",
              file=sys.stderr)
        return 4
    for line in lines:
        print(line, file=sys.stderr)
    print(json.dumps(result))
    return 0
