"""One run of one benchmark cell on the card this process is started on.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Prints its checks' numbers beside their limits as the last lines of standard
error, and one JSON object as the last line of standard output.  Exits with
another code than 0, printing no result, when the cell's cards are missing,
when the program is missing (a directory holding only the benchmark), or
when the run loaded JAX or the JAX package.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _caches() -> None:
    """Every kernel or build cache at a fixed place inside the checkout."""
    base = ROOT / "build" / "benchmark"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(base / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(base / "cuda_cache")


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


if __name__ == "__main__":
    args = parse()
    _caches()
    # the checkout, not this directory, heads the path: its files'
    # names must not stand in for other modules
    sys.path[0] = str(ROOT)
    from benchmark import harness

    sys.exit(harness.main(args, T_START))
