"""A/B of the torch port's record-batch decode between checkouts, on one GPU.

For each turn a fresh process imports one checkout's ``zstdsharp_tpu_torch``
and ``bench.make_corpus``, builds its kernels, checks that
``Decompressor().unwrap_many_device`` decodes the bench's decode workload
(the first 6 MB of ``make_corpus`` as 256 records of 24 KB at level 9)
byte-exact with no frame routed to the host, and times it: the end-to-end
ms of each of ``--reps`` calls (each ending in ``torch.cuda.synchronize``)
and, over as many more calls, the stage times of
``decode_batch_device(timings=)``.  Checkouts run in turns, A B B A for two
(``--rounds`` times), so drift on the machine hits both alike.  Prints one
JSON line per turn and writes the list to ``--out``.

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
    results, stats = dp.decode_batch_device(frames, dev, materialize=True)
    if results != recs or stats["host_frames"]:
        raise RuntimeError(f"{tree}: decode not byte-exact or host-routed")

    def run():
        Decompressor().unwrap_many_device(frames, dev)
        torch.cuda.synchronize()

    run()
    e2e = []
    for _ in range(reps):
        t = time.perf_counter()
        run()
        e2e.append((time.perf_counter() - t) * 1e3)
    stages: dict = {}
    for _ in range(reps):
        tm: dict = {}
        dp.decode_batch_device(frames, dev, timings=tm)
        for k, v in tm.items():
            stages.setdefault(k, []).append(v * 1e3)
    return {"tree": str(tree), "card": torch.cuda.get_device_name(0),
            "e2e_ms": e2e, "stages_ms": stages}


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
        e2e = sorted(turns[-1]["e2e_ms"])
        print(json.dumps({"tree": str(tree), "e2e_ms_median": e2e[len(e2e) // 2],
                          "stages_ms_median": {
                              k: sorted(v)[len(v) // 2]
                              for k, v in turns[-1]["stages_ms"].items()}}))
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(turns))
    return 0


if __name__ == "__main__":
    sys.exit(main())
