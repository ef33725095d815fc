"""The device planes' stage spans and counters (``utils.trace``): the keys
``timings=`` gets, children inside their parents, the counters against the
plan, no profiler call when nothing records, the host-only spans as host
events of a CPU torch.profiler, the benchmark's readers of them; and, on a
card, no span of the program copied onto the device's timeline.

Imports only the port, so the card test runs on a machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_trace.py
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.autograd.profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile, record_function

from zstdsharp_tpu_torch.decode import device_pipeline as dp
from zstdsharp_tpu_torch.encode.device_pipeline import compress_batch_device
from zstdsharp_tpu_torch.encode.frame import compress
from zstdsharp_tpu_torch.ops import device_fse as df
from zstdsharp_tpu_torch.utils import trace

ROOT = Path(__file__).resolve().parent.parent

DECODE_KEYS = {"plan", "plan.native", "plan.python", "plan.host_seqs",
               "huf", "huf.upload", "fse", "fse.upload", "exec",
               "exec.upload", "materialize", "n.lanes", "n.host_seq_lanes"}
ENCODE_KEYS = {"pack", "pack.upload", "parse", "tables", "tables.lit",
               "tables.seq", "tables.upload", "assembly", "materialize"}
# the spans a running profiler records, by plane (host work only)
DECODE_HOST = {"decode.plan", "decode.plan.native", "decode.plan.python",
               "decode.plan.host_seqs", "decode.exec.upload",
               "decode.materialize"}
ENCODE_HOST = {"encode.pack", "encode.tables.lit", "encode.tables.seq",
               "encode.materialize"}
SINK_ONLY = {"decode.huf", "decode.huf.upload", "decode.fse",
             "decode.fse.upload", "decode.exec", "decode.host",
             "encode.parse", "encode.tables", "encode.tables.upload",
             "encode.pack.upload", "encode.assembly"}


def _text(n, seed):
    """Words of a 400-word vocabulary: at 32 KB its level-3 frame's
    sequence bitstream is wider than the FSE kernel's window."""
    vocab = np.random.default_rng(1)
    words = [bytes(vocab.integers(97, 123, int(vocab.integers(3, 9)),
                                  dtype=np.uint8)) + b" " for _ in range(400)]
    r = np.random.default_rng(seed)
    return b"".join(words[int(i)] for i in r.integers(0, 400, n // 4))[:n]


@pytest.fixture(scope="module")
def batch():
    """Six frames the native planner takes and one whose sequences the
    Python planner decodes on the host."""
    records = [_text(3000, s) for s in range(6)] + [_text(1 << 15, 6)]
    frames = [compress(r, 3) for r in records]
    plan = dp.plan_batch(frames)
    dp._release_ops(plan.nb, None)
    assert 0 < len(plan.host_seqs) < len(plan.blocks)
    return records, frames, plan


def _records(n=5, size=4000):
    return [_text(size, 100 + s) for s in range(n)]


# each span's parent: a child runs inside it ("plan.host_seqs" inside the
# Python planner's frames)
PARENT = {"plan.native": "plan", "plan.python": "plan",
          "plan.host_seqs": "plan.python", "huf.upload": "huf",
          "fse.upload": "fse", "exec.upload": "exec", "pack.upload": "pack",
          "tables.lit": "tables", "tables.seq": "tables",
          "tables.upload": "tables"}


def _children_inside(timings):
    """Each parent's children sum to at most the parent."""
    for k in timings:
        if "." in k and not k.startswith("n."):
            assert PARENT[k] in timings, k
    for parent in set(PARENT.values()) & set(timings):
        kids = [v for k, v in timings.items() if PARENT.get(k) == parent]
        assert sum(kids) <= timings[parent], (parent, kids)


def test_wide_frame_passes_the_fse_window(batch):
    _, frames, _ = batch
    plan = dp.plan_batch(frames[-1:])
    dp._release_ops(plan.nb, None)
    assert plan.host_seqs and plan.blocks[0].seq_kind == 2
    assert len(frames[-1]) > df.MAX_W * 4


def test_decode_keys_and_counters(batch):
    records, frames, plan = batch
    timings = {}
    res, stats = dp.decode_batch_device(frames, True, device="cpu",
                                        timings=timings)
    assert res == records and stats["host_frames"] == 0
    assert set(timings) == DECODE_KEYS
    assert timings["n.host_seq_lanes"] == len(plan.host_seqs) == 1
    assert timings["n.lanes"] == len(plan.blocks) == len(frames)
    assert all(v >= 0 for v in timings.values())
    _children_inside(timings)


def test_decode_keys_accumulate_over_calls(batch):
    _, frames, plan = batch
    timings = {}
    for _ in range(2):
        dp.decode_batch_device(frames, device="cpu", timings=timings)
    assert set(timings) == DECODE_KEYS - {"materialize"}
    assert timings["n.lanes"] == 2 * len(plan.blocks)
    assert timings["n.host_seq_lanes"] == 2 * len(plan.host_seqs)
    _children_inside(timings)


def test_decode_native_batch_has_no_python_span(batch):
    _, frames, _ = batch
    timings = {}
    dp.decode_batch_device(frames[:6], device="cpu", timings=timings)
    assert "plan.python" not in timings and "plan.host_seqs" not in timings
    assert timings["n.host_seq_lanes"] == 0 and timings["n.lanes"] == 6
    _children_inside(timings)


def test_encode_keys(batch):
    recs = _records()
    timings = {}
    frames, stats = compress_batch_device(recs, True, device="cpu",
                                          timings=timings)
    assert stats == {"device_frames": len(recs), "host_frames": 0}
    assert [dp.decompress(f) for f in frames] == recs
    assert set(timings) == ENCODE_KEYS
    assert all(v >= 0 for v in timings.values())
    _children_inside(timings)


def test_encode_rows_without_materialize_have_no_materialize_key():
    timings = {}
    compress_batch_device(_records(2), device="cpu", timings=timings)
    assert set(timings) == ENCODE_KEYS - {"materialize"}


def _raise(*a, **k):
    raise AssertionError("record_function entered")


@pytest.mark.parametrize("timings", [None, {}], ids=["no_sink", "sink"])
def test_no_profiler_no_record_function(batch, monkeypatch, timings):
    monkeypatch.setattr(autograd_profiler, "record_function", _raise)
    monkeypatch.setattr(torch.profiler, "record_function", _raise)
    records, frames, _ = batch
    assert not trace.profiling()
    res, _ = dp.decode_batch_device(frames, True, device="cpu",
                                    timings=timings)
    assert res == records
    compress_batch_device(_records(2), True, device="cpu", timings=timings)


def test_span_off_is_shared_and_free():
    a = trace.stage("plan", None, plane="decode")
    b = trace.stage("exec", None, torch.device("cpu"))
    assert a is b
    with a:
        pass
    trace.count("lanes", 3, None)


def test_stage_and_count_add_to_the_sink():
    sink = {}
    for _ in range(2):
        with trace.stage("a", sink):
            with trace.stage("a.b", sink, torch.device("cpu"), "x"):
                pass
        trace.count("lanes", 3, sink)
    assert set(sink) == {"a", "a.b", "n.lanes"}
    assert sink["n.lanes"] == 6 and 0 <= sink["a.b"] <= sink["a"]


def test_stage_adds_on_an_exception():
    sink = {}
    with pytest.raises(KeyError):
        with trace.stage("a", sink, plane="x"):
            raise KeyError
    assert set(sink) == {"a"}


def _names(prof, device: bool):
    from torch.autograd import DeviceType

    cuda = DeviceType.CUDA
    return {e.name() for e in prof.profiler.kineto_results.events()
            if (e.device_type() == cuda) == device}


@pytest.mark.parametrize("plane", ["decode", "encode"])
def test_profiler_records_host_spans(batch, plane):
    records, frames, _ = batch
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert trace.profiling()
        if plane == "decode":
            res, _ = dp.decode_batch_device(frames, True, device="cpu")
            assert res == records
        else:
            compress_batch_device(_records(2), True, device="cpu")
    assert not trace.profiling()
    names = _names(prof, False)
    want = DECODE_HOST if plane == "decode" else ENCODE_HOST
    assert want <= names
    assert not names & SINK_ONLY


def _load_metric(name):
    sys.path.insert(0, str(ROOT))
    try:
        from benchmark import harness
    finally:
        sys.path.remove(str(ROOT))
    return harness.load_module("metrics", name, ROOT)


def _ctx(plane, timings, calls):
    return {"plane": plane, "stages": {"calls": calls, "timings": timings}}


DECODE_METRICS = ["decode.plan_native_ms", "decode.plan_python_ms",
                  "decode.plan_self_ms", "decode.host_seqs_ms",
                  "decode.host_seq_share", "decode.upload_ms"]
ENCODE_METRICS = ["encode.lit_tables_ms", "encode.seq_tables_ms",
                  "encode.upload_ms", "encode.pack_ms",
                  "encode.materialize_ms"]


def test_benchmark_reads_the_decode_spans(batch):
    _, frames, plan = batch
    timings = {}
    for _ in range(3):
        dp.decode_batch_device(frames, True, device="cpu", timings=timings)
    got = {m: _load_metric(m).read(_ctx("decode", timings, 3))
           for m in DECODE_METRICS}
    assert all(v is not None and v >= 0 for v in got.values()), got
    assert got["decode.host_seq_share"] == pytest.approx(
        100 * len(plan.host_seqs) / len(plan.blocks))
    assert got["decode.host_seqs_ms"] <= got["decode.plan_python_ms"]
    assert got["decode.plan_self_ms"] == pytest.approx(
        1e3 * (timings["plan"] - timings["plan.native"]
               - timings["plan.python"]) / 3)
    # a program without the spans: the readers find nothing
    old = {k: timings[k] for k in ("plan", "huf", "fse", "exec")}
    assert all(_load_metric(m).read(_ctx("decode", old, 3)) is None
               for m in DECODE_METRICS)
    assert all(_load_metric(m).read(_ctx("encode", timings, 3)) is None
               for m in DECODE_METRICS)


def test_benchmark_reads_the_encode_spans():
    timings = {}
    compress_batch_device(_records(3), True, device="cpu", timings=timings)
    got = {m: _load_metric(m).read(_ctx("encode", timings, 1))
           for m in ENCODE_METRICS}
    assert all(v is not None and v >= 0 for v in got.values()), got
    tables = 1e3 * timings["tables"]
    assert (got["encode.lit_tables_ms"] + got["encode.seq_tables_ms"]
            + 1e3 * timings["tables.upload"]) <= tables
    old = {k: timings[k] for k in ("parse", "tables", "assembly")}
    assert all(_load_metric(m).read(_ctx("encode", old, 1)) is None
               for m in ENCODE_METRICS)


@pytest.mark.cuda
def test_card_copies_no_program_span_to_the_device():
    """Over a profiled decode and encode on the card, the host-only spans
    are host events and none of the program's names is a device event; the
    enclosing annotation, which holds device work, is copied (the check
    can see a copy)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    dev = torch.device("cuda", 0)
    records = [_text(3000, s) for s in range(40)] + [_text(1 << 15, 6)]
    frames = [compress(r, 3) for r in records]
    recs = _records(40, 16000)
    dp.decode_batch_device(frames, True, device=dev)  # builds, warms
    compress_batch_device(recs, True, device=dev)
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        with record_function("test.window"):
            res, _ = dp.decode_batch_device(frames, True, device=dev)
            enc, _ = compress_batch_device(recs, True, device=dev)
            torch.cuda.synchronize()
    assert res == records
    assert [dp.decompress(f) for f in enc] == recs
    host, device = _names(prof, False), _names(prof, True)
    assert DECODE_HOST | ENCODE_HOST <= host
    assert "test.window" in device
    program = {n for n in device if n.startswith(("decode.", "encode."))}
    assert not program, sorted(program)
