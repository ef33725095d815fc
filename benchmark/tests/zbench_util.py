"""Helpers of the benchmark's tests."""

import json
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def tiny_root(dst: Path, records: int = 6, pool: int = 2,
              shrink: int = 8) -> tuple[Path, dict]:
    """A copy of the benchmark under `dst` whose mixes carry `records`
    records a call, `pool` batches and lengths cut by `shrink`, so every
    cell runs on the CPU in seconds.  Returns (root, spec)."""
    shutil.copytree(ROOT / "benchmark", dst / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for p in (dst / "benchmark" / "traffic").glob("*.json"):
        m = json.loads(p.read_text())
        m.update(records=records, pool_batches=pool,
                 len_lo=m["len_lo"] // shrink, len_hi=m["len_hi"] // shrink,
                 check_records=min(m["check_records"], 4))
        p.write_text(json.dumps(m))
    (dst / "BENCHMARK.json").write_text(json.dumps(spec))
    return dst, spec
