"""Kernel measurements on one NVIDIA GPU, and the bounds every kernel is
held to.

    python -m zstdsharp_tpu_torch.kernel_bench [--huf-baseline FILE.cu]
                                               [--fse-baseline FILE.cu]
                                               [--out FILE.json]

1. The two decode kernels, the Huffman literal decode
   (``csrc/huf_decode.cu``) and the FSE sequence decode
   (``csrc/fse_decode.cu``), each at the main path's operands -- the
   planner's window of the bench's decode batch (the first 6 MB of
   ``bench.make_corpus`` as 256 records of 24 KB at level 9: Huffman
   [1024 lanes, Wb 256, T 1024], FSE [256 lanes, Wb 1024, T 4096]) -- at
   a larger Wb bucket (256 records of 48 KB at level 9: Huffman Wb 768,
   FSE Wb 2048) and on the main window's longest lane alone (its time
   over its symbol or sequence count is the serial chain's latency per
   item).  Each ``--huf-baseline`` / ``--fse-baseline`` names another
   source of the same ``zt_huf_decode`` / ``zt_fse_decode`` entry point
   (an earlier version of the kernel); every source is built alone,
   checked against the plain version on each window and timed in turns
   (the baselines, the kernel twice, the baselines in reverse).  Prints
   what ``nvcc -Xptxas -v`` reports for each.
2. The histogram kernel against ``torch.bincount`` (a yardstick the port
   never calls): device time per call from ``torch.profiler`` on the 4 MB
   vector of chip_smoke.py's phase 6 and on the encoder's literal rows
   ([32, 16384] with their prefix masks; ``bincount`` with the mask as
   weights).

Every time is printed beside the card's name and power limit, and the
whole result goes to a JSON file (``--out``, by default
``build/kernel_bench.json``).  Needs a CUDA device and ``nvcc``; raises
without them.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from .ops import device_fse, device_huf

ROOT = Path(__file__).resolve().parent.parent
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA's data sheet
CORE_OPS_PER_S = 67e12      # float32 outside the tensor cores, the same
REC_SIZE = 24 << 10
N_RECORDS = 256


# ---------------------------------------------------------------------------
# bounds: the larger of bytes over the memory rate and operations over the
# core rate; bytes count each input read once and each output written once,
# and only what this run's data needs
# ---------------------------------------------------------------------------


def bound(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """(least ms, "bytes" or "operations")."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / CORE_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _live_words(pos: torch.Tensor, wb: int) -> torch.Tensor:
    return ((pos.long() + 31) >> 5).clamp(0, wb)


def fse_work(ops: dict, t_len: int) -> tuple[int, int]:
    """(bytes, operations) of one FSE decode call: the tables and live
    words of every lane with sequences, st and nseq, the three outputs;
    about 40 integer operations a sequence."""
    nl, wb = ops["words"].shape
    n = ops["nseq"].long().clamp(0, t_len)
    live = n > 0
    words = int(_live_words(ops["st"][:, 0], wb)[live].sum())
    n_bytes = (int(live.sum()) * 4 * (512 + 256 + 512) + 4 * words
               + nl * 4 * (8 + 1) + 3 * nl * t_len * 4)
    return n_bytes, 40 * int(n.sum())


def huf_work(ops: dict, t_len: int) -> tuple[int, int]:
    """(bytes, operations) of one Huffman decode call: the per-lane tables
    (limits, bases, offs, shifts, planes) and live words of every lane with
    symbols, pos and nsym, the output; about 20 operations a symbol."""
    nl, wb = ops["words"].shape
    n = ops["nsym"].long().clamp(0, t_len)
    live = n > 0
    words = int(_live_words(ops["pos"], wb)[live].sum())
    n_bytes = (int(live.sum()) * 4 * (4 * 16 + 64) + 4 * words + nl * 8
               + nl * t_len * 4)
    return n_bytes, 20 * int(n.sum())


def hist_work(data: torch.Tensor, mask=None) -> tuple[int, int]:
    """(bytes, operations) of one histogram call: the bytes and the mask
    read, 256 int32 counts per row written; two operations a byte."""
    rows = data.shape[0] if data.dim() == 2 else 1
    n_bytes = data.numel() + (mask.numel() if mask is not None else 0)
    return n_bytes + rows * 256 * 4, 2 * data.numel()


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------


def card() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader", "-i", "0"],
                       capture_output=True, text=True, timeout=60)
    if r.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {r.stderr}")
    return r.stdout.strip()


def event_ms(fn, reps: int = 20) -> float:
    """Mean ms per call over `reps` calls between two CUDA events, after
    one warm-up call."""
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def device_ms(fn, reps: int = 20) -> float:
    """Device time per call: the sum of the device events torch.profiler
    records over `reps` calls, after one warm-up call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not events:
        raise RuntimeError("the profiler recorded no device event")
    return sum(e.time_range.elapsed_us() for e in events) / reps / 1e3


# ---------------------------------------------------------------------------
# the FSE kernel
# ---------------------------------------------------------------------------


def _build_variant(src: Path, out: Path) -> tuple[ctypes.CDLL, list]:
    """nvcc `src` alone into `out`; returns the library (its
    ``zt_fse_decode`` or ``zt_huf_decode`` declared, whichever it has)
    and the ptxas lines of its log."""
    from . import _build

    out.parent.mkdir(parents=True, exist_ok=True)
    obj = out.with_suffix(".o")
    log = _build._run_all([[_build._nvcc(), *_build.NVCC_FLAGS, "-c", "-o",
                            str(obj), str(src)]])
    log += _build._run_all([[_build._nvcc(), "-shared", "-o", str(out),
                             str(obj)]])
    lib = ctypes.CDLL(str(out))
    p, i = ctypes.c_void_p, ctypes.c_int
    for name in ("zt_fse_decode", "zt_huf_decode"):
        if hasattr(lib, name):
            getattr(lib, name).restype = i
            getattr(lib, name).argtypes = [p, i, p, p, p, p, p, p, p, p, i, i,
                                           p]
    return lib, [ln.strip() for ln in log.splitlines()
                 if "ptxas" in ln or "spill" in ln]


def _build_all(kernel: str, others: list) -> tuple[dict, dict]:
    """Build `others` ((name, source) pairs) and csrc/<kernel>.cu, each
    alone: ({name: library}, {name: ptxas register/spill lines})."""
    from . import _build

    libs, ptxas = {}, {}
    for name, src in others + [("kernel", _build.CSRC / f"{kernel}.cu")]:
        libs[name], log = _build_variant(
            src, ROOT / "build" / "ab" / f"lib{kernel}_{name}.so")
        ptxas[name] = [ln for ln in log if "Used" in ln or "spill" in ln
                       or "stack" in ln]
        print(f"{name} ({src}) ptxas: {ptxas[name]}")
    return libs, ptxas


def launcher(lib, kernel: str, ops: dict):
    """A call of `lib`'s ``zt_<kernel>`` on `ops` into preallocated outputs
    (the wrapper's host work left out), and those outputs."""
    mod, n_out = KERNELS[kernel][:2]
    nl, wb = ops["words"].shape
    t_len = mod.bucket_t(int(ops["t_max"]))
    outs = [torch.empty(nl, t_len, dtype=torch.int32,
                        device=ops["words"].device) for _ in range(n_out)]
    args = [ops[k].data_ptr() for k in mod._OPERANDS]
    stream = torch.cuda.current_stream().cuda_stream
    fn = getattr(lib, f"zt_{kernel}")

    def run():
        rc = fn(args[0], wb, *args[1:], *(o.data_ptr() for o in outs), nl,
                t_len, stream)
        if rc:
            raise RuntimeError(f"zt_{kernel}: cudaError_t {rc}")
    return run, outs


def one_lane(ops: dict, lane: int, count: str) -> dict:
    """Lane `lane` of a window alone, its T bucket set by its own count
    (`count`: "nsym" or "nseq")."""
    out = {k: (v if k == "t_max" else v[lane:lane + 1].clone())
           for k, v in ops.items()}
    out["t_max"] = int(ops[count][lane])
    return out


# kernel -> (its wrapper module, outputs, planner window, count operand,
# what it counts, its work)
KERNELS = {
    "huf_decode": (device_huf, 1, "huf_ops", "nsym", "symbol", huf_work),
    "fse_decode": (device_fse, 3, "fse_ops", "nseq", "sequence", fse_work),
}


def kernel_ab(kernel: str, windows: dict, others: list) -> dict:
    """csrc/<kernel>.cu and `others` ((name, source) pairs of the same
    entry point, e.g. an earlier version), each built alone, checked
    against the plain version on each of `windows` ({name: operands}) and
    timed in turns: the others in order, the kernel twice, the others in
    reverse.  For each the longest lane's time per item follows from the
    ``longest_lane`` window."""
    mod, _, _, count, unit, work = KERNELS[kernel]
    libs, ptxas = _build_all(kernel, others)
    res = {"windows": {}, "ptxas": ptxas}
    order = [n for n, _ in others]
    turns = order + ["kernel", "kernel"] + order[::-1]
    for wname, ops in windows.items():
        nl, wb = ops["words"].shape
        t_len = mod.bucket_t(int(ops["t_max"]))
        want = mod.decode_plain(*(ops[k] for k in mod._OPERANDS), t_len)
        want = want if isinstance(want, tuple) else (want,)
        row = {"shape": [nl, wb, t_len], f"{count}_max": int(ops[count].max()),
               f"{unit}s": int(ops[count].clamp(min=0).sum())}
        runs = {}
        for name, lib in libs.items():
            run, outs = launcher(lib, kernel, ops)
            run()
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(outs, want)):
                raise RuntimeError(f"{kernel} {wname}: {name} differs from "
                                   "plain")
            runs[name] = run
        for name in turns:
            row.setdefault(f"{name}_ms", []).append(event_ms(runs[name], 20))
        n_bytes, n_ops = work(ops, t_len)
        row["bound_ms"], row["bound_by"] = bound(n_bytes, n_ops)
        row["bytes"] = n_bytes
        for name in libs:
            row[f"{name}_ns_per_{unit}_of_longest"] = (
                min(row[f"{name}_ms"]) * 1e6 / max(row[f"{count}_max"], 1))
        res["windows"][wname] = row
        times = "; ".join(f"{n} ms {row[n + '_ms']}" for n in libs)
        per = ", ".join(f"{n} {row[f'{n}_ns_per_{unit}_of_longest']:.1f}"
                        for n in libs)
        print(f"{kernel} {wname} {row['shape']}: all equal plain; {times}; "
              f"bound {row['bound_ms']:.5f} ms ({row['bound_by']}, {n_bytes}"
              f" B); longest lane {row[f'{count}_max']} {unit}s, ns each: "
              f"{per}")
    return res


def decode_windows(data: bytes, dev) -> dict:
    """Each decode kernel's windows: the main path's (the bench's 256 x 24
    KB records at level 9), a larger Wb bucket (256 x 48 KB records), and
    the main window's longest lane alone.  {kernel: {name: operands}}."""
    from .decode import device_pipeline as dp
    from .encode.frame import compress

    plans = [dp.plan_batch([compress(data[i:i + size], 9)
                            for i in range(0, N_RECORDS * size, size)])
             for size in (REC_SIZE, 2 * REC_SIZE)]
    out = {}
    for kernel, (_, _, ops_of, count, _, _) in KERNELS.items():
        main, big = (dp.ops_to_device(getattr(p.nb, ops_of)(0), dev)
                     for p in plans)
        longest = int(torch.argmax(main[count]))
        out[kernel] = {"main": main, f"wb{big['words'].shape[1]}": big,
                       "longest_lane": one_lane(main, longest, count)}
    for p in plans:
        dp._release_ops(p.nb, None)
    return out


# ---------------------------------------------------------------------------
# the histogram kernel against torch.bincount
# ---------------------------------------------------------------------------


def hist_vs_bincount(data: bytes, dev) -> dict:
    from .encode.device_pipeline import LANES
    from .ops import device_encode as de
    from .ops import histogram as hg

    vec = torch.from_numpy(np.frombuffer(data[:(4 << 20) + 1], np.uint8)
                           .copy()).to(dev)
    n = 16 << 10
    blocks = np.zeros((LANES, n), np.uint8)
    for k in range(LANES):
        blocks[k] = np.frombuffer(data[k * n:(k + 1) * n], np.uint8)
    nv = torch.full((LANES,), n, dtype=torch.int32, device=dev)
    _, rows, count, _, _ = de._parse_phase(
        torch.from_numpy(blocks).to(dev), nv, de.seq_budget(n), 15)
    mask = torch.arange(n, device=dev)[None, :] < count[:, None].long()
    weights = mask.reshape(-1).to(torch.float32)
    flat = rows.reshape(-1)
    want = torch.bincount(flat.long(), weights=weights, minlength=256)
    res = {}
    for name, kern, lib, shape_of, work in (
            ("vector_4MB", lambda: hg.histogram_u8(vec),
             lambda: torch.bincount(vec, minlength=256),
             tuple(vec.shape), hist_work(vec)),
            ("literal_rows_masked", lambda: hg.histogram_u8(rows, mask),
             lambda: torch.bincount(flat, weights=weights, minlength=256),
             tuple(rows.shape), hist_work(rows, mask))):
        got = kern()
        ref = lib()
        torch.cuda.synchronize()
        got_flat = got.reshape(-1, 256).sum(0).long()
        if not torch.equal(got_flat, ref.long()):
            raise RuntimeError(f"histogram {name}: kernel != bincount")
        row = {"shape": list(shape_of),
               "kernel_device_ms": device_ms(kern),
               "bincount_device_ms": device_ms(lib),
               "kernel_event_ms": event_ms(kern),
               "bincount_event_ms": event_ms(lib)}
        row["bound_ms"], row["bound_by"] = bound(*work)
        res[name] = row
        print(f"histogram {name} {row['shape']}: device ms kernel "
              f"{row['kernel_device_ms']:.5f}, bincount "
              f"{row['bincount_device_ms']:.5f}; event ms kernel "
              f"{row['kernel_event_ms']:.5f}, bincount "
              f"{row['bincount_event_ms']:.5f}; bound {row['bound_ms']:.5f} "
              f"ms ({row['bound_by']})")
    assert torch.equal(want.long(), hg.histogram_plain(rows, mask).sum(0).long())
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    for k in ("huf", "fse"):
        ap.add_argument(f"--{k}-baseline", type=Path, action="append",
                        default=[], metavar="FILE.cu",
                        help=f"another source of zt_{k}_decode to build and "
                             f"time beside csrc/{k}_decode.cu (repeatable)")
    ap.add_argument("--out", type=Path,
                    default=ROOT / "build" / "kernel_bench.json",
                    help="where to write the JSON result")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("kernel_bench needs a CUDA device")
    sys.path.insert(0, str(ROOT))
    from bench import make_corpus

    dev = torch.device("cuda", 0)
    name = card()
    print(name)
    t0 = time.perf_counter()
    data = make_corpus(2 * N_RECORDS * REC_SIZE)
    windows = decode_windows(data, dev)
    out = {"card": name}
    for k, files in (("huf", args.huf_baseline), ("fse", args.fse_baseline)):
        out[k] = kernel_ab(f"{k}_decode", windows[f"{k}_decode"],
                           [(f.stem, f) for f in files])
    out["histogram"] = hist_vs_bincount(data, dev)
    out["seconds"] = time.perf_counter() - t0
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(out, indent=1))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
