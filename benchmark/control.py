"""The check's two readings on a cell, at the cell's own size: the program's
and the control's, seed by seed, in one process.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 \
        [--device cuda] [--out <file>.jsonl]

For each seed the pool is made as a run makes it; then two calls of every
batch go through the program, and two of every batch through the plane's
control (the reference in the program's place with the configuration's
guarantee broken), and each set is judged by the plane's ``check``.  The
program has to come out correct and the control not.  The benchmark's own
runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def readings(spec: dict, name: str, seed: int, device: str,
             root: Path = ROOT) -> dict:
    import numpy as np
    import torch

    from benchmark import harness

    cell = harness.find_cell(spec, name)
    cfg = harness.config_of(spec, cell, root)
    mix = harness.load_json("traffic", cell["traffic"], root)
    plane = harness.load_module("planes", mix["plane"], root)
    st = plane.prepare(cfg, mix, seed, device)
    sync = (torch.cuda.synchronize if torch.device(device).type == "cuda"
            else (lambda: None))
    out = {"workload": name, "seed": seed}
    for side in ("program", "control"):
        rng = np.random.default_rng([seed, 3])
        kept = []
        for k in list(range(st.n_batches)) * 2:
            res = (plane.call(st, k) if side == "program"
                   else plane.control(st, k, rng))
            sync()
            kept.append((k, res))
        limits = plane.check(st, mix, kept, np.random.default_rng([seed, 2]))
        out[side] = {"limits": limits, "correct": all(
            (v["value"] <= v["at_most"]) if "at_most" in v
            else (v["value"] >= v["at_least"]) for v in limits.values())}
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out")
    a = ap.parse_args()
    sys.path[0] = str(ROOT)
    from benchmark import harness

    spec = harness.load_spec()
    ok = True
    for seed in (int(s) for s in a.seeds.split(",")):
        r = readings(spec, a.workload, seed, a.device)
        ok &= r["program"]["correct"] and not r["control"]["correct"]
        line = json.dumps(r)
        print(line, flush=True)
        if a.out:
            Path(a.out).parent.mkdir(parents=True, exist_ok=True)
            with open(a.out, "a") as f:
                f.write(line + "\n")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
