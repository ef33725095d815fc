"""The Parquet cell: its payload (TPC-H ``lineitem`` PLAIN pages, one row
group a batch), its files found by name, and its multi-block metrics."""

import json

import numpy as np
import pytest

from benchmark import harness
from benchmark.engine import Engine
from benchmark.gen import make_batches
from benchmark.payloads import tpch_lineitem_plain as lineitem
from benchmark.reference import zstd_plain
from zbench_util import tiny_root

CELL = "parquet1m.scan"
MB_METRICS = ("decode.mb_plan_ms", "decode.mb_exec_ms", "decode.mb_upload_ms",
              "decode.mb_host_lit_share")


@pytest.fixture(scope="module")
def small(spec):
    """The cell's configuration with pages cut to 1/128 of their size."""
    cell = harness.find_cell(spec, CELL)
    cfg = harness.config_of(spec, cell)
    mix = harness.load_json("traffic", cell["traffic"])
    mix.update(pool_batches=2, len_lo=mix["len_lo"] // 128,
               len_hi=mix["len_hi"] // 128)
    return cfg, mix


def _column(batch, name) -> bytes:
    """A row group's stream of one column: its pages in order."""
    return b"".join(p for c, p in zip(lineitem.PLAN, batch) if c == name)


def _values(batch, name, dtype):
    s = _column(batch, name)
    n = np.dtype(dtype).itemsize
    return np.frombuffer(s[:len(s) // n * n], dtype)


def test_page_plan_is_one_row_group():
    pages = dict(lineitem.COLUMNS)
    assert len(lineitem.PLAN) == sum(pages.values()) == 136
    assert pages == {
        "l_orderkey": 8, "l_partkey": 8, "l_suppkey": 8, "l_linenumber": 4,
        "l_quantity": 8, "l_extendedprice": 8, "l_discount": 8, "l_tax": 8,
        "l_returnflag": 5, "l_linestatus": 5, "l_shipdate": 4,
        "l_commitdate": 4, "l_receiptdate": 4, "l_shipinstruct": 16,
        "l_shipmode": 8, "l_comment": 30}
    # each column's pages lie together, in the columns' order
    assert [c for i, c in enumerate(lineitem.PLAN)
            if i == 0 or lineitem.PLAN[i - 1] != c] == list(pages)


def test_a_batch_is_a_whole_row_group(spec):
    cell = harness.find_cell(spec, CELL)
    mix = harness.load_json("traffic", cell["traffic"])
    cfg = harness.config_of(spec, cell)
    assert mix["plane"] == "decode" and mix["records"] == len(lineitem.PLAN)
    assert mix["len_lo"] == 1 << 20 and mix["len_hi"] == cfg[
        "max_record_bytes"] == (1 << 20) + (32 << 10)
    assert cfg["level"] == 1 and not cfg["checksum"]
    assert mix["pool_batches"] == cfg["row_groups"] == 4


def test_same_seed_same_pages_other_seed_same_plan(small):
    cfg, mix = small
    a = make_batches(cfg, mix, 2**31 + 5)
    b = make_batches(cfg, mix, 2**31 + 5)
    c = make_batches(cfg, mix, 7)
    assert a == b and a != c
    assert [len(x) for x in a] == [len(x) for x in c] == [136, 136]
    lens = sorted(len(p) for batch in a for p in batch)
    assert lens == sorted(len(p) for batch in c for p in batch)
    assert min(lens) >= mix["len_lo"] and max(lens) <= mix["len_hi"]


def test_values_in_the_tpch_domains(small):
    cfg, mix = small
    for batch in make_batches(cfg, mix, 2**31 + 11):
        q = _values(batch, "l_quantity", "<f8")
        assert q.size and q.min() >= 1 and q.max() <= 50
        assert np.all(q == np.round(q))
        d = _values(batch, "l_discount", "<f8")
        assert d.min() >= 0 and d.max() <= 0.10 + 1e-12
        t = _values(batch, "l_tax", "<f8")
        assert t.min() >= 0 and t.max() <= 0.08 + 1e-12
        keys = _values(batch, "l_orderkey", "<i8")
        assert np.all(np.diff(keys) >= 0) and np.all(keys % 32 < 8)
        line = _values(batch, "l_linenumber", "<i4")
        assert line.min() == 1 and line.max() <= 7
        ship = _values(batch, "l_shipdate", "<i4")
        receipt = _values(batch, "l_receiptdate", "<i4")
        n = min(ship.size, receipt.size)
        assert np.all(receipt[:n] > ship[:n])
        assert np.all(receipt[:n] - ship[:n] <= 30)
        assert ship.min() > lineitem.STARTDATE
        mode = _column(batch, "l_shipmode")
        assert mode[:4] in [len(m).to_bytes(4, "little")
                            for m in lineitem.MODES]


def test_comments_are_length_prefixed_grammar_text(small):
    cfg, mix = small
    s = _column(make_batches(cfg, mix, 3)[0], "l_comment")
    p, lens = 0, []
    while p + 4 <= len(s):
        n = int.from_bytes(s[p:p + 4], "little")
        lens.append(n)
        p += 4 + n
    assert 10 <= min(lens) and max(lens) <= 43
    words = set(s.replace(b"\x00", b" ").split())
    assert b"furiously" in words or b"carefully" in words


def test_cell_files_found_by_name(spec):
    cell = harness.find_cell(spec, CELL)
    assert cell["chips"] == 1 and cell["traffic"] == "decode_136x1m"
    assert harness.config_of(spec, cell)["payload"] == "tpch_lineitem_plain"
    assert harness.load_module("planes", "decode")
    names = [m["name"] for m in harness.cell_metrics(spec, CELL, False)]
    assert names == ["setup_s", "decode_GBps"]
    traced = {m["name"] for m in harness.cell_metrics(spec, CELL, True)}
    assert set(MB_METRICS) <= traced
    assert "decode.host_routed_share" not in traced
    for name in traced:
        mod = harness.load_module("metrics", name)
        assert mod.MOVES == "decode_GBps"


def test_small_pages_round_trip_through_the_reference(small):
    cfg, mix = small
    eng = Engine()
    batch = make_batches(cfg, mix, 2**31 + 13)[0]
    for i in (0, 3 * 8 + 4, len(batch) - 1):  # key, quantity, comment pages
        f = eng.frame(batch[i], cfg["level"], cfg["checksum"])
        assert zstd_plain.frame_header(f)["content_size"] == len(batch[i])
        assert zstd_plain.decode_frame(f) == batch[i]
        # the tiny pages (8-8.5 KiB) are one block; the cell's are 8-9
        p = zstd_plain.frame_header(f)["header_size"]
        assert f[p] & 1


def test_tiny_cell_reads_its_multiblock_metrics(tmp_path):
    root, spec = tiny_root(tmp_path)
    mix = json.loads((root / "benchmark/traffic/decode_136x1m.json")
                     .read_text())
    # the tiny pages are past 128 KiB (the lengths are midpoints of steps
    # above len_lo), so each is a frame of 2 blocks
    assert mix["len_lo"] >= 1 << 17
    res, _ = harness.run_cell(spec, CELL, 2**31 + 21, 0.3, True, "cpu",
                              root=root)
    assert res["correct"] and res["attempted"] > 0
    got = res["metrics"]
    assert set(MB_METRICS) <= set(got)
    assert 0 <= got["decode.mb_host_lit_share"]["value"] <= 100
    assert got["decode.mb_upload_ms"]["value"] <= got[
        "decode.mb_exec_ms"]["value"]


@pytest.mark.parametrize("name", MB_METRICS)
def test_metric_reads_none_without_its_counters(name):
    """Without the multi-block counters in the timings, as from a program
    that lacks them, a metric reads None, as it does on another plane."""
    mod = harness.load_module("metrics", name)
    timings = {"plan": 1.0, "plan.python": 0.9, "plan.host_seqs": 0.2,
               "mb_exec": 0.5, "n.lanes": 9, "n.host_seq_lanes": 9}
    ctx = {"plane": "decode", "stages": {"calls": 2, "timings": timings}}
    assert mod.read(ctx) is None
    timings.update({"n.mb_frames": 1, "n.mb_lit_bytes": 100,
                    "n.mb_host_lit_bytes": 25, "plan.multiblock": 0.8,
                    "mb_exec.upload": 0.1})
    assert mod.read(ctx) == {"decode.mb_plan_ms": 400.0,
                             "decode.mb_exec_ms": 250.0,
                             "decode.mb_upload_ms": 50.0,
                             "decode.mb_host_lit_share": 25.0}[name]
    assert mod.read(dict(ctx, plane="encode")) is None
