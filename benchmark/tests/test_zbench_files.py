"""BENCHMARK.json's shape (keys, names, sizes, bounds), and every file it
names found by name."""

import json
import re

import pytest

from benchmark import harness
from zbench_util import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
METRICS = SPEC["end_to_end"] + SPEC["per_layer"]


def test_top_level_keys(spec):
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert spec["command"] == ["python3", "benchmark/run.py"]
    assert spec["paths"] == ["benchmark"]
    assert 1 <= spec["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 << 10


def test_check_fits_the_limit(spec):
    # 2 + 14 runs a cell at 24 cells, each run_seconds + 60 s, 2 x 90 s of
    # compile a cell and 1200 s spare within 43,200 s
    cells = 24
    total = ((2 + 14 * cells) * (spec["run_seconds"] + 60) + cells * 180
             + 1200)
    assert total <= 43200


@pytest.mark.parametrize("entry", SPEC["configs"], ids=lambda c: c["name"])
def test_config_file(entry):
    assert NAME.match(entry["name"])
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    path = ROOT / entry["file"]
    assert entry["file"].startswith("benchmark/configs/")
    cfg = json.loads(path.read_text())
    assert cfg["name"] == entry["name"]
    assert cfg["source"] == entry["source"]
    assert cfg["reduced"] == entry["reduced"]
    for key in ("payload", "max_record_bytes", "level", "checksum",
                "hash_log", "assumed"):
        assert key in cfg
    assert (ROOT / "benchmark" / "payloads" / f"{cfg['payload']}.py").exists()
    assert 1 <= len(entry["why"]) <= 200


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda w: w["name"])
def test_cell_files_found_by_name(cell, spec):
    assert NAME.match(cell["name"]) and NAME.match(cell["traffic"])
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert cell["chips"] == 1
    assert 1 <= len(cell["why"]) <= 200
    mix = harness.load_json("traffic", cell["traffic"])
    assert (ROOT / "benchmark" / "planes" / f"{mix['plane']}.py").exists()
    cfg = harness.config_of(spec, cell)
    assert mix["len_hi"] <= cfg["max_record_bytes"]
    reported = [m["name"] for m in harness.cell_metrics(spec, cell["name"],
                                                        False)]
    assert "setup_s" in reported and len(reported) >= 2
    assert harness.cell_metrics(spec, cell["name"], True)


def test_cells_unique(spec):
    names = [w["name"] for w in spec["workloads"]]
    pairs = [(w["config"], w["traffic"]) for w in spec["workloads"]]
    assert len(set(names)) == len(names) and len(set(pairs)) == len(pairs)
    used = {w["config"] for w in spec["workloads"]}
    assert used == {c["name"] for c in spec["configs"]}


@pytest.mark.parametrize("m", METRICS, ids=lambda m: m["name"])
def test_metric_file_matches_its_entry(m, spec):
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    mod = harness.load_module("metrics", m["name"])
    assert mod.UNIT == m["unit"]
    assert callable(mod.read)
    if m in spec["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert mod.MOVES is None
    else:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert mod.LAYER == m["layer"] and mod.MOVES == m["moves"]
        assert m["moves"] in {e["name"] for e in spec["end_to_end"]}
        # every cell it lists reports the end-to-end metric it moves
        e2e = next(e for e in spec["end_to_end"] if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(e2e.get("workloads", m["workloads"]))


def test_setup_bound(spec):
    setup = next(e for e in spec["end_to_end"] if e["name"] == "setup_s")
    assert setup["bound"] == 0.25 and "workloads" not in setup


def test_counter_files():
    from benchmark import devtrace

    specs = devtrace.counter_specs()
    assert {s["kernel"] for s in specs} >= {"huf_decode_kernel",
                                            "fse_decode_kernel", "lz_kernel",
                                            "parse_kernel", "assemble_kernel"}
    got = devtrace.read_counters(specs)
    assert set(got) == {c for s in specs for c in s["counters"]}
