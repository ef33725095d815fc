"""The reduction of a profile, the metric readers and the spread, on fixed
inputs."""

import numpy as np
import pytest

from benchmark import devtrace, harness, sets

SPECS = [{"kernel": "lz_kernel", "counters": ["m:execute_lanes"]}]


def events():
    w, c = devtrace.WINDOW, devtrace.CALL
    return [
        (w, False, 1000.0, 2000.0),            # the window: 1 ms
        (c, False, 1000.0, 1500.0), (c, False, 1500.0, 2000.0),
        ("aten::copy_", False, 1100.0, 1200.0),
        ("cudaMemcpyAsync", False, 1600.0, 1700.0),
        # device: 100 us of copy, 2 launches of 50 us recorded (3 counted)
        ("Memcpy HtoD (Pageable -> Device)", True, 1150.0, 1250.0),
        ("lz_kernel(Params)", True, 1300.0, 1350.0),
        ("lz_kernel(Params)", True, 1340.0, 1390.0),  # overlaps the first
        (w, True, 1000.0, 2000.0),              # the annotation's mirror
        ("other", True, 2500.0, 2600.0),        # outside the window
    ]


def test_reduce_profile():
    t = devtrace.reduce_profile(events(), SPECS, {"m:execute_lanes": 5},
                                {"m:execute_lanes": 8})
    assert t["window_s"] == pytest.approx(1e-3)
    assert t["busy_s"] == pytest.approx(190e-6)  # 100 + 90 (the union)
    assert t["kernel_s"] == {"lz_kernel(Params)": pytest.approx(100e-6)}
    assert t["launch_counts"] == {"lz_kernel": (3, 2)}
    # scaled by counted / recorded
    assert devtrace.kernel_seconds(t, SPECS) == pytest.approx(150e-6)
    ops = dict(t["breakdown"]["device_ops"])
    assert ops["Memcpy HtoD (Pageable -> Device)"] == pytest.approx(100e-6)
    gaps = dict(t["breakdown"]["idle_gaps"])
    assert sum(gaps.values()) == pytest.approx(1e-3 - 190e-6)
    # 1000-1150 inside the first call (its middle at 1075: no op), 1250-1300
    # the same, 1390-2000's middle 1695 in cudaMemcpyAsync
    assert gaps["host Python between torch calls"] == pytest.approx(200e-6)
    assert gaps["cudaMemcpyAsync"] == pytest.approx(610e-6)


def test_no_window_no_figures():
    events = [("x", True, 0.0, 1.0)]
    assert devtrace.reduce_profile(events, SPECS, {}, {}) == {}


def window(**kw):
    w = {"calls": 4, "seconds": 2.0, "content_bytes": 8e9, "frame_bytes": 2e9,
         "items": 100, "host_routed": 5, "latencies": [0.01] * 19 + [0.1],
         "timings": {"plan": 0.4, "huf": 0.1, "fse": 0.3, "tables": 1.0}}
    w.update(kw)
    return w


def ctx(plane="decode", **kw):
    c = {"plane": plane, "on_card": True, "setup_s": 7.5, "window": window(),
         "stages": window(), "counter_specs": SPECS,
         "profile": {"window_s": 2.0, "busy_s": 0.5, "content_bytes": 3.35e9,
                     "frame_bytes": 3.35e9, "kernel_s": {"lz_kernel": 1.0},
                     "launch_counts": {"lz_kernel": (4, 2)}},
         "peak_bytes_per_s": 3.35e12}
    c.update(kw)
    return c


@pytest.mark.parametrize("name,plane,want", [
    ("setup_s", "decode", 7.5),
    ("decode_GBps", "decode", 4.0),
    ("decode_GBps", "encode", None),
    ("encode_GBps", "encode", 4.0),
    ("encode_ratio", "encode", 4.0),
    ("encode_ratio", "decode", None),
    ("decode.plan_ms", "decode", 100.0),
    ("decode.entropy_ms", "decode", 100.0),
    ("decode.exec_ms", "decode", None),       # no such stage ran
    ("decode.host_routed_share", "decode", 5.0),
    ("decode.call_p95_ms", "decode", 1e3 * (0.01 + 0.05 * 0.09)),
    ("decode.device_idle", "decode", 75.0),
    ("decode.kernel_roofline", "decode", 0.1),  # 6.7 GB / 3.35 TB/s / 2 s
    ("encode.tables_ms", "encode", 250.0),
    ("encode.parse_ms", "encode", None),
    ("encode.kernel_roofline", "encode", 0.1),
    ("encode.device_idle", "encode", 75.0),
])
def test_readers(name, plane, want):
    got = harness.load_module("metrics", name).read(ctx(plane))
    if want is None:
        assert got is None
    else:
        assert got == pytest.approx(want)


def test_device_readers_silent_off_the_card():
    for name in ("decode.device_idle", "decode.kernel_roofline"):
        assert harness.load_module("metrics", name).read(
            ctx(on_card=False)) is None


def test_spread():
    assert sets.spread([1.0]) is None
    # quartiles of 1..5 by the exclusive method: 1.5 and 4.5, median 3
    assert sets.spread([1.0, 2.0, 3.0, 4.0, 5.0]) == pytest.approx(1.0)
    assert sets.spread([2.0, 2.0, 2.0]) == 0.0


def test_keeper_draws_from_the_seed():
    a = harness.Keeper(5)
    b = harness.Keeper(5)
    got_a = [a.offer(i, i) for i in range(200)]
    got_b = [b.offer(i, i) for i in range(200)]
    assert got_a == got_b
    assert len(a.kept) == harness.KEEP_CALLS
    assert a.kept != [(i, i) for i in range(harness.KEEP_CALLS)]
    # with fewer calls than it keeps, it keeps them all
    c = harness.Keeper(5)
    assert all(c.offer(i, i) for i in range(3)) and len(c.kept) == 3


def test_keeper_samples_the_whole_window():
    """Each call of a long window is about as likely to be kept: the
    check sees late calls as often as early ones."""
    hits = np.zeros(60)
    for seed in range(400):
        kp = harness.Keeper(seed)
        for i in range(60):
            kp.offer(i, i)
        for k, _ in kp.kept:
            hits[k] += 1
    share = hits / 400
    assert abs(share[:30].mean() - share[30:].mean()) < 0.02
    assert share.mean() == pytest.approx(harness.KEEP_CALLS / 60)
