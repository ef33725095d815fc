"""What a traced run reads from torch.profiler: the device's busy time
inside the window (the union of every device operation's interval), the
device time and recorded launches of each kernel, the operations that took
the most device time, and the idle gaps labelled by what the host was
doing; and, around the window, the program's launch counters named in
``counters/<kernel>.json``.
"""

from __future__ import annotations

import bisect
import importlib
import json
from pathlib import Path

COUNTERS = Path(__file__).resolve().parent / "counters"
WINDOW = "benchmark.window"
CALL = "benchmark.call"


def counter_specs() -> list:
    """Every ``counters/*.json``: {"kernel": a substring of the kernel's
    name, "counters": ["module:function", ...] whose ``launches`` count
    it}."""
    return [json.loads(p.read_text()) for p in sorted(COUNTERS.glob("*.json"))]


def read_counters(specs) -> dict:
    """"module:function" -> its ``launches`` now (absent: not counted)."""
    out = {}
    for spec in specs:
        for name in spec["counters"]:
            mod, fn = name.split(":")
            try:
                out[name] = int(getattr(importlib.import_module(mod), fn)
                                .launches)
            except (ImportError, AttributeError):
                pass
    return out


def _is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset", "cudaMemcpy",
                                 "cudaMemset"))


def _union(intervals) -> list:
    merged = []
    for lo, hi in sorted(intervals):
        if merged and lo <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], hi)
        else:
            merged.append([lo, hi])
    return merged


def reduce_profile(events, specs, before: dict, after: dict) -> dict:
    """The profile's figures inside the window annotation.  `events` are
    (name, is_device, start_us, end_us) tuples."""
    win = [(s, e) for n, dev, s, e in events if not dev and n == WINDOW]
    if not win:
        return {}
    w0, w1 = win[0]
    device, host = [], []
    for n, dev, s, e in events:
        s, e = max(s, w0), min(e, w1)
        if e <= s or (dev and n in (WINDOW, CALL)):
            continue  # the annotations' mirrors on the device's timeline
        (device if dev else host).append((n, s, e))
    busy = _union([(s, e) for _, s, e in device])
    busy_us = sum(e - s for s, e in busy)
    by_op, kernel_us, recorded = {}, {}, {}
    for n, s, e in device:
        by_op[n] = by_op.get(n, 0.0) + (e - s)
        if _is_kernel(n):
            kernel_us[n] = kernel_us.get(n, 0.0) + (e - s)
            recorded[n] = recorded.get(n, 0) + 1
    # idle gaps, each labelled by the innermost host event around its middle
    gaps, end = [], w0
    for s, e in busy:
        if s > end:
            gaps.append((end, s))
        end = max(end, e)
    if w1 > end:
        gaps.append((end, w1))
    calls = sorted((s, e) for n, s, e in host if n == CALL)
    call_starts = [s for s, _ in calls]
    host = sorted((h for h in host if h[0] not in (WINDOW, CALL)),
                  key=lambda h: h[1])
    starts = [h[1] for h in host]
    idle = {}
    for lo, hi in gaps:
        mid = (lo + hi) / 2
        c = bisect.bisect_right(call_starts, mid) - 1
        label = ("host Python between torch calls"
                 if c >= 0 and calls[c][1] >= mid else "between calls")
        j = bisect.bisect_right(starts, mid) - 1
        best = None
        for h in host[max(0, j - 400):j + 1]:
            if h[2] >= mid and (best is None or h[1] >= best[1]):
                best = h
        if best is not None:
            label = best[0]
        idle[label] = idle.get(label, 0.0) + (hi - lo)
    counts = {}
    for spec in specs:
        names = [n for n in kernel_us if spec["kernel"] in n]
        got = [after[c] - before[c] for c in spec["counters"]
               if c in after and c in before]
        if names and got:
            counts[spec["kernel"]] = (sum(got),
                                      sum(recorded[n] for n in names))
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
    gaps_top = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return {
        "window_s": (w1 - w0) / 1e6, "busy_s": busy_us / 1e6,
        "kernel_s": {n: v / 1e6 for n, v in kernel_us.items()},
        "launch_counts": counts,
        "breakdown": {"device_ops": [[n, v / 1e6] for n, v in top],
                      "idle_gaps": [[n, v / 1e6] for n, v in gaps_top]},
    }


def kernel_seconds(trace: dict, specs) -> float:
    """Every kernel's device time in the window; a kernel whose wrapper
    counted more launches than the profiler recorded scaled by counted /
    recorded."""
    total = 0.0
    for n, t in trace["kernel_s"].items():
        for spec in specs:
            c = trace["launch_counts"].get(spec["kernel"])
            if spec["kernel"] in n and c and c[0] > c[1] > 0:
                t *= c[0] / c[1]
                break
        total += t
    return total


def profiler_events(prof) -> list:
    """(name, is_device, start_us, end_us) of every event of a finished
    torch.profiler profile, read from its raw events (no event tree)."""
    from torch.autograd import DeviceType

    cuda = DeviceType.CUDA
    return [(e.name(), e.device_type() == cuda, e.start_ns() / 1e3,
             (e.start_ns() + e.duration_ns()) / 1e3)
            for e in prof.profiler.kineto_results.events()]
