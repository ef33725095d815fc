"""Kernel measurements on one NVIDIA GPU, and the bounds every kernel is
held to.

    python -m zstdsharp_tpu_torch.kernel_bench [--hist-baseline FILE.cu]
                                               [--huf-baseline FILE.cu]
                                               [--fse-baseline FILE.cu]
                                               [--out FILE.json]

1. The histogram kernel (``csrc/histogram.cu``) on every shape the main
   path gives it -- the encoder's literal rows ([32, 16384] and, for the
   top bucket, [32, 131072], with their prefix masks) and
   ``parse_block_stats``'s rows in ``graft_entry.entry`` ([4, 32768], the
   uncovered bytes' mask) -- on dense unmasked text rows [32, 131072], on
   32 rows of one byte value and 32 of ``b"ab" * 8192`` (skewed bytes),
   and on the 4 MB + 1 vector of chip_smoke.py's phase 6.  Each
   ``--hist-baseline`` (another source of ``zt_histogram``, e.g. the
   earlier kernel that adds into a zeroed output, which the harness
   zeroes) is built alone beside it, checked against the plain version
   and timed in turns: device time of the histogram's own kernels per
   call (``torch.profiler``), CUDA events through the raw launcher (an
   adding kernel with and without its fill), the launch floor (empty
   kernels of the same grid and cluster shape), events and host time
   (``perf_counter``, the enqueue alone) through the wrapper,
   and ``torch.bincount`` (a yardstick the port never calls; the mask as
   weights).  Then the (cs, cpr) configurations of ``HIST_CONFIGS``.  The
   bound counts every mask byte but only the data sectors that hold a
   kept position (``hist_work``).
2. The two decode kernels, the Huffman literal decode
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
   (the baselines, the kernel twice, the baselines in reverse).

Prints what ``nvcc -Xptxas -v`` reports for each source built alone.
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
    """(bytes, operations) of one histogram call: every mask byte read, the
    data bytes read -- all of them unmasked, else only the 32-byte sectors
    that hold a kept position -- and 256 int32 counts per row written; two
    operations a position."""
    rows = data.shape[0] if data.dim() == 2 else 1
    n_bytes = data.numel()
    if mask is not None:
        lead = data.data_ptr() % 32
        kept = torch.zeros(-(-(lead + mask.numel()) // 32) * 32,
                           dtype=torch.bool, device=mask.device)
        kept[lead:lead + mask.numel()] = mask.reshape(-1)
        n_bytes = mask.numel() + 32 * int(kept.view(-1, 32).any(1).sum())
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


def host_ms(fn, reps: int = 200) -> float:
    """Host time per call to enqueue `fn` (perf_counter over `reps` calls,
    the card's own time not waited for), after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    return t


def device_ms(fn, reps: int = 20, names=None) -> float:
    """Device time per call: the sum of the device events torch.profiler
    records over `reps` calls, after one warm-up call; only the events
    whose name holds one of `names`, when given.  A session in which the
    profiler recorded no such event (it happens, rarely) is run again, up
    to three times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events()
                  if e.device_type == DeviceType.CUDA
                  and (names is None or any(k in e.name for k in names))]
        if events:
            return sum(e.time_range.elapsed_us() for e in events) / reps / 1e3
    raise RuntimeError("the profiler recorded no device event")


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
    log = _build._run_all([[_build._nvcc(), *_build.NVCC_FLAGS,
                            "-c", "-o", str(obj), str(src)]])
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
# the histogram kernel: A/B against earlier sources, its launch floor, and
# torch.bincount
# ---------------------------------------------------------------------------

# (cs, cpr) configurations timed beside the wrapper's plan, by input
_CLUSTERS = [(1, 1), (2, 1), (4, 1), (8, 1)]
HIST_CONFIGS = {"literal_rows_masked": _CLUSTERS,
                "literal_rows_128KB_masked": _CLUSTERS,
                "parse_stats_rows": _CLUSTERS + [(8, 2), (8, 4), (8, 8)],
                "text_rows_128KB": _CLUSTERS + [(8, 2), (8, 4)],
                "vector_4MB": [(8, 1), (8, 9), (8, 17), (8, 33), (8, 65),
                               (1, 264)]}


def _hist_lib(lib) -> str:
    """Declare `lib`'s histogram entry points: "cluster" for this
    repository's kernel (zt_histogram fills every bin; zt_histogram_floor
    beside it), "atomic" for the earlier adding kernel (out zeroed by the
    caller)."""
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.zt_histogram.restype = i
    if hasattr(lib, "zt_histogram_floor"):
        lib.zt_histogram.argtypes = [p, p, i, ll, p, p, i, i, p]
        lib.zt_histogram_floor.restype = i
        lib.zt_histogram_floor.argtypes = [i, i, i, p]
        return "cluster"
    lib.zt_histogram.argtypes = [p, p, i, ll, p, p]
    return "atomic"


def hist_launcher(lib, data: torch.Tensor, mask=None, config=None):
    """A call of `lib`'s ``zt_histogram`` on `data` (and `mask`) into a
    preallocated output (the wrapper's host work left out), the output,
    and the (cs, cpr) it launches with: the wrapper's plan unless `config`
    is given.  The earlier adding kernel adds into its output, which the
    call does not zero: its counts are right only after
    ``out.zero_()``."""
    from .ops import histogram as hg

    b, n = (1, data.shape[0]) if data.dim() == 1 else tuple(data.shape)
    dev = data.device
    out = torch.empty(b, 256, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    mptr = mask.data_ptr() if mask is not None else None
    if _hist_lib(lib) == "atomic":
        def run():
            rc = lib.zt_histogram(data.data_ptr(), mptr, b, n,
                                  out.data_ptr(), stream)
            if rc:
                raise RuntimeError(f"zt_histogram: cudaError_t {rc}")
        return run, out, None
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    cs, cpr = config or hg.plan(b, n, sms, mask is not None)
    scratch = torch.empty(b, cpr, 256, dtype=torch.int32, device=dev)

    def run():
        rc = lib.zt_histogram(data.data_ptr(), mptr, b, n, out.data_ptr(),
                              scratch.data_ptr(), cs, cpr, stream)
        if rc:
            raise RuntimeError(f"zt_histogram: cudaError_t {rc}")
    return run, out, (cs, cpr)


def hist_floor(lib, b: int, cs: int, cpr: int):
    """A call of ``zt_histogram_floor``: empty kernels of the histogram's
    grid, cluster shape and block size."""
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        rc = lib.zt_histogram_floor(b, cs, cpr, stream)
        if rc:
            raise RuntimeError(f"zt_histogram_floor: cudaError_t {rc}")
    return run


def _literal_rows(data: bytes, n: int, dev):
    """The encoder's literal rows of the first 32 records of `n` bytes
    (the parse phase's sorted literals) and their prefix masks."""
    from .encode.device_pipeline import LANES
    from .ops import device_encode as de

    blocks = np.frombuffer(data[:LANES * n], np.uint8).reshape(LANES, n)
    nv = torch.full((LANES,), n, dtype=torch.int32, device=dev)
    _, rows, count, _, _ = de._parse_phase(
        torch.from_numpy(blocks.copy()).to(dev), nv, de.seq_budget(n), 15)
    return (rows.contiguous(),
            torch.arange(n, device=dev)[None, :] < count[:, None].long())


def _parse_stats_rows(dev):
    """``parse_block_stats``'s histogram operands in ``graft_entry.entry``:
    its 4 blocks of 32 KiB and the mask of their uncovered valid bytes,
    made as parse_block_stats makes them."""
    from .graft_entry import entry
    from .ops.matcher import parse_block

    _, (blocks, n_valid) = entry(dev)
    r = parse_block(blocks, n_valid, 15)
    n = blocks.shape[-1]
    mask = (~r["covered"]) & (torch.arange(n, device=dev)
                              < n_valid.to(torch.int64)[..., None])
    return blocks.contiguous(), mask


def hist_inputs(data: bytes, dev) -> dict:
    """{name: (rows, mask)}: the main path's masked shapes (the encoder's
    literal rows of 16 KB and 128 KB records, parse_block_stats's rows),
    then dense text rows of 128 KB, 32 rows of one byte value, 32 rows of
    ``b"ab" * 8192`` and the 4 MB + 1 vector, these four unmasked."""
    from .encode.device_pipeline import LANES

    n = 16 << 10
    vec = torch.from_numpy(np.frombuffer(data[:(4 << 20) + 1], np.uint8)
                           .copy()).to(dev)
    text = np.frombuffer(data[:LANES << 17], np.uint8).reshape(LANES, -1)
    ab = torch.from_numpy(np.frombuffer(b"ab" * (n // 2), np.uint8).copy())
    return {"literal_rows_masked": _literal_rows(data, n, dev),
            "literal_rows_128KB_masked": _literal_rows(data, 128 << 10, dev),
            "parse_stats_rows": _parse_stats_rows(dev),
            "text_rows_128KB": (torch.from_numpy(text.copy()).to(dev), None),
            "one_byte_rows": (torch.full((LANES, n), 0x20, dtype=torch.uint8,
                                         device=dev), None),
            "ab_rows": (ab.to(dev).repeat(LANES, 1), None),
            "vector_4MB": (vec, None)}


def _bincount(rows, mask):
    """torch.bincount over the rows (the mask as weights): one call, the
    sum of the rows' histograms."""
    flat = rows.reshape(-1)
    if mask is None:
        return lambda: torch.bincount(flat, minlength=256)
    weights = mask.reshape(-1).to(torch.float32)
    return lambda: torch.bincount(flat, weights=weights, minlength=256)


_HIST_KERNELS = ("histogram_kernel", "reduce_kernel")


def hist_ab(data: bytes, dev, others: list) -> dict:
    """csrc/histogram.cu and `others` ((name, source) pairs: an
    earlier kernel or another version of the same entry point), each built
    alone, checked against the plain
    version on every input of ``hist_inputs`` and timed in turns (the
    others, the kernel twice, the others in reverse): device ms of the
    histogram's own kernels (torch.profiler), events ms of the raw
    launcher (an adding kernel with and without the fill its output
    needs), the launch floor, the wrapper, torch.bincount, and the
    (cs, cpr) sweep of HIST_CONFIGS."""
    from . import _build
    from .ops import histogram as hg

    src = _build.CSRC / "histogram.cu"
    libs, ptxas = {}, {}
    for name, path in others + [("kernel", src)]:
        libs[name], log = _build_variant(
            path, ROOT / "build" / "ab" / f"libhistogram_{name}.so")
        ptxas[name] = [ln for ln in log if "Used" in ln or "spill" in ln
                       or "stack" in ln]
        print(f"histogram {name} ({path}) ptxas: {ptxas[name]}")
    order = [n for n, _ in others]
    turns = order + ["kernel", "kernel"] + order[::-1]
    res = {"inputs": {}, "configs": {}, "ptxas": ptxas}
    for iname, (rows, mask) in hist_inputs(data, dev).items():
        want = hg.histogram_plain(rows, mask).reshape(-1, 256)
        b = want.shape[0]
        row = {"shape": list(rows.shape), "masked": mask is not None,
               "kept": int(mask.sum()) if mask is not None else rows.numel()}
        runs = {}
        for name, lib in libs.items():
            run, out, cfg = hist_launcher(lib, rows, mask)
            if cfg is None:         # an adding kernel: zero first, then add
                runs[f"{name}_with_fill"] = (
                    lambda run=run, out=out: (out.zero_(), run()))
            runs[name] = run
            (runs.get(f"{name}_with_fill") or run)()
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                raise RuntimeError(f"histogram {iname}: {name} differs from "
                                   "plain")
            row["config"] = row.get("config") or cfg
        for name in turns:
            for key in [k for k in runs if k == name
                        or k == f"{name}_with_fill"]:
                row.setdefault(f"{key}_event_ms", []).append(
                    event_ms(runs[key]))
                row.setdefault(f"{key}_device_ms", []).append(
                    device_ms(runs[key], names=_HIST_KERNELS))
        floor = hist_floor(libs["kernel"], b, *row["config"])
        row["launch_floor_event_ms"] = event_ms(floor)
        row["launch_floor_device_ms"] = device_ms(floor)
        row["wrapper_event_ms"] = event_ms(lambda: hg.histogram_u8(rows,
                                                                   mask))
        row["wrapper_host_ms"] = host_ms(lambda: hg.histogram_u8(rows, mask))
        row["launcher_host_ms"] = host_ms(runs["kernel"])
        lib_fn = _bincount(rows, mask)
        if not torch.equal(lib_fn().long(), want.sum(0).long()):
            raise RuntimeError(f"histogram {iname}: bincount differs")
        row["bincount_event_ms"] = event_ms(lib_fn)
        row["bincount_device_ms"] = device_ms(lib_fn)
        row["bytes"], n_ops = hist_work(rows, mask)
        row["bound_ms"], row["bound_by"] = bound(row["bytes"], n_ops)
        res["inputs"][iname] = row
        print(f"histogram {iname} {row['shape']} kept {row['kept']} config "
              f"{row['config']} bytes {row['bytes']}: "
              + "; ".join(f"{k} {v}" for k, v in row.items()
                          if k.endswith("_ms")))
        for cs, cpr in HIST_CONFIGS.get(iname, []):
            run, out, _ = hist_launcher(libs["kernel"], rows, mask,
                                        (cs, cpr))
            run()
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                raise RuntimeError(f"histogram {iname} at cs {cs} cpr {cpr}"
                                   " differs from plain")
            c = {"device_ms": device_ms(run, names=_HIST_KERNELS),
                 "event_ms": event_ms(run),
                 "floor_device_ms": device_ms(hist_floor(libs["kernel"], b,
                                                         cs, cpr))}
            res["configs"][f"{iname} cs{cs} cpr{cpr}"] = c
            print(f"histogram {iname} cs {cs} cpr {cpr}: {c}")
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    for k, entry, src in (("huf", "zt_huf_decode", "huf_decode.cu"),
                          ("fse", "zt_fse_decode", "fse_decode.cu"),
                          ("hist", "zt_histogram", "histogram.cu")):
        ap.add_argument(f"--{k}-baseline", type=Path, action="append",
                        default=[], metavar="FILE.cu",
                        help=f"another source of {entry} to build and "
                             f"time beside csrc/{src} (repeatable)")
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
    out = {"card": name,
           "histogram": hist_ab(data, dev, [(f.stem, f)
                                            for f in args.hist_baseline])}
    windows = decode_windows(data, dev)
    for k, files in (("huf", args.huf_baseline), ("fse", args.fse_baseline)):
        out[k] = kernel_ab(f"{k}_decode", windows[f"{k}_decode"],
                           [(f.stem, f) for f in files])
    out["seconds"] = time.perf_counter() - t0
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(out, indent=1))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
