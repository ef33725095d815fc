"""How fast the FSE encoder's state paths merge on the encode plane's data.

Each FSE encode step maps the TS states onto norm[s] states, so paths that
start apart can meet.  This measures, on the CPU, the chains the assembly
kernel walks (``csrc/assemble.cu``): for the encode cell's first chunk (32
records of 16 KB, the first 512 KB of ``bench.make_corpus(8 MB)``) and a
128 KB chunk (4 records of 128 KB from 4 MB on), through the port's own
parse and table builders (``compress_batch_device(device="cpu")``), for
each stream (ll, of, ml) of every lane with two sequences or more:

* meet: started from state 0 at step j (ns - 1 ... 1), the steps until
  that path holds the true chain's state ("never" when it has not by step
  0); what a speculative segment walk, guessing state 0, would have to
  follow the true chain for;
* merge: started from every state at once at every (ns // 50)-th step,
  the steps until all paths hold one state; what a composition that stops
  where its paths merge would save.

Prints one JSON object: per chunk and stream the mean, median, 90th and
99th percentiles and maximum of each, and the count that never got there.
Takes about a minute.

    python tools/fse_paths.py
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent


def _stats(v, never) -> dict:
    v = np.asarray(v, np.float64)
    return {"mean": float(v.mean()), "p50": float(np.median(v)),
            "p90": float(np.percentile(v, 90)),
            "p99": float(np.percentile(v, 99)), "max": float(v.max()),
            "never": int(never)}


def _chains(call, name, codes):
    """(next-state maps [ns, TS], true states [ns]) of each lane with two
    sequences or more: the chain as the kernel walks it, from
    init[c[ns - 1]] down to step 0."""
    maps_all = call["seq"][name][0].numpy()
    init_all = call["seq"][name][2].numpy()
    for b, ns in enumerate(call["parsed"]["nseq"].tolist()):
        if ns < 2:
            continue
        nsym, ts = maps_all[b].shape
        c = np.clip(codes[b, :ns].numpy(), 0, nsym - 1)
        m = np.clip(maps_all[b][c], 0, ts - 1)
        u = np.zeros(ns, np.int64)
        u[ns - 1] = np.clip(init_all[b][c[ns - 1]], 0, ts - 1)
        for i in range(ns - 2, -1, -1):
            u[i] = m[i, u[i + 1]]
        yield m, u


def paths(call) -> dict:
    from zstdsharp_tpu_torch.ops import device_encode as de

    import torch

    p = call["parsed"]
    _, ll, mlv, ofb = de._seq_values(p["starts"], p["mls"], p["offs"],
                                     p["nseq"])
    ll_c, ml_c, of_c = de._codes_from_values(
        ll, mlv, ofb, de._dev_consts(torch.device("cpu")))
    out = {}
    for name, codes in (("ll", ll_c), ("of", of_c), ("ml", ml_c)):
        meet, merge, meet_never, merge_never = [], [], 0, 0
        for m, u in _chains(call, name, codes):
            ns, ts = m.shape[0], m.shape[1]
            for j in range(ns - 1, 0, -1):
                g, i, k = 0, j, 0
                while g != u[i]:
                    if i == 0:
                        break
                    i -= 1
                    g = m[i, g]
                    k += 1
                if g == u[i]:
                    meet.append(k)
                else:
                    meet_never += 1
            for j in range(ns - 1, 0, -max(1, ns // 50)):
                s, i, k = np.arange(ts), j, 0
                while len(np.unique(s)) > 1 and i > 0:
                    i -= 1
                    s = m[i, s]
                    k += 1
                if len(np.unique(s)) == 1:
                    merge.append(k)
                else:
                    merge_never += 1
        out[name] = {"ts": int(call["seq"][name][0].shape[2]),
                     "meet": _stats(meet, meet_never),
                     "merge": _stats(merge, merge_never)}
    return out


def main() -> int:
    sys.path.insert(0, str(ROOT))
    from bench import make_corpus
    from zstdsharp_tpu_torch.encode.device_pipeline import (
        compress_batch_device)
    from zstdsharp_tpu_torch.kernel_bench import capture_assemble

    data = make_corpus(8 << 20)
    recs = [data[i:i + (16 << 10)] for i in range(0, 32 << 14, 16 << 10)]
    big = [data[(4 << 20) + i:(4 << 20) + i + (128 << 10)]
           for i in range(0, 4 << 17, 128 << 10)]
    calls = capture_assemble(lambda: compress_batch_device(recs + big,
                                                           device="cpu"))
    res = {}
    for call in calls:
        key = f"{call['blocks'].shape[1] >> 10} KB"
        res[key] = {"nseq_max": int(call["parsed"]["nseq"].max()),
                    **paths(call)}
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
