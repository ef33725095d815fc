"""Runs one cell several times, one process after another, and reports each
metric's spread: the distance between the first and the third quartile
(``statistics.quantiles(values, n=4)``) as a share of the median.

    python3 benchmark/sets.py --workload <cell> --seeds 11,12,13,14,15,16 \
        --sets 2 --seconds 51 --trace 0 --out <file>.jsonl

Every set runs the same seeds in the same order.  Each run's seed, exit
code, wall seconds, result line and the end of its standard error go to
``--out``, one JSON object a line; the summary goes to standard output.
The first run of the call is left out of ``setup_s``'s spread: it may
build the kernels.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def spread(values: list) -> float | None:
    if len(values) < 2:
        return None
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / abs(med) if med else None


def run_one(workload: str, seed: int, seconds: float, trace: int) -> dict:
    t = time.perf_counter()
    p = subprocess.run(
        [sys.executable, str(ROOT / "benchmark" / "run.py"), "--workload",
         workload, "--seed", str(seed), "--seconds", str(seconds), "--trace",
         str(trace)], cwd=ROOT, capture_output=True, text=True, timeout=1500)
    line = p.stdout.strip().splitlines()[-1] if p.stdout.strip() else ""
    try:
        result = json.loads(line)
    except json.JSONDecodeError:
        result = None
    return {"workload": workload, "seed": seed, "trace": trace, "rc":
            p.returncode, "wall_s": time.perf_counter() - t, "result": result,
            "stderr_tail": p.stderr[-3000:]}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--sets", type=int, default=1)
    ap.add_argument("--seconds", type=float, default=30)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--out", required=True)
    a = ap.parse_args()
    seeds = [int(s) for s in a.seeds.split(",")]
    out = Path(a.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    runs = []
    with out.open("a") as f:
        for s in range(a.sets):
            for seed in seeds:
                r = run_one(a.workload, seed, a.seconds, a.trace)
                r["set"] = s
                runs.append(r)
                f.write(json.dumps(r) + "\n")
                f.flush()
                res = r["result"] or {}
                print(f"set {s} seed {seed} rc {r['rc']} wall "
                      f"{r['wall_s']:.1f} correct {res.get('correct')} "
                      + " ".join(f"{k}={v['value']:.6g}" for k, v in
                                 res.get("metrics", {}).items()), flush=True)
                if r["rc"] != 0 or not res.get("correct"):
                    print(r["stderr_tail"][-1500:], flush=True)
    for s in range(a.sets):
        got = [r for r in runs if r["set"] == s and r["result"]]
        names = sorted({k for r in got for k in r["result"]["metrics"]})
        for n in names:
            vals = [r["result"]["metrics"][n]["value"] for r in got
                    if n in r["result"]["metrics"]
                    and not (n == "setup_s" and r is runs[0])]
            if not vals:
                continue
            sp = spread(vals)
            print(f"set {s} {n}: median {statistics.median(vals):.6g} "
                  f"spread {sp if sp is None else round(sp, 5)} "
                  f"n {len(vals)}")
    return 0 if all(r["rc"] == 0 and r["result"] and r["result"]["correct"]
                    for r in runs) else 1


if __name__ == "__main__":
    sys.exit(main())
