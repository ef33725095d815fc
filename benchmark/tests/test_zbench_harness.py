"""Whole runs on the CPU at tiny sizes (the port's plain paths), a cell, a
mix and a metric added by new files alone, and the run's guards: no card,
no program, JAX loaded."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark import harness
from zbench_util import ROOT, tiny_root

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_tiny_run(cell, trace, tiny):
    root, spec = tiny
    res, lines = harness.run_cell(spec, cell, 2**31 + 99, 0.5, bool(trace),
                                  "cpu", root=root)
    assert res["correct"] and res["attempted"] > 0 and res["failed"] == 0
    assert list(res)[-1] == "limits"
    want = {m["name"] for m in harness.cell_metrics(spec, cell, bool(trace))}
    got = set(res["metrics"])
    assert got <= want
    if not trace:
        assert got == want  # every end-to-end metric of the cell
    else:  # the device's metrics are not read off the card
        assert got == {n for n in want if "roofline" not in n
                       and "idle" not in n and "p95" not in n}
        assert "busy_s" not in res["device"]
    assert lines[-1].startswith(list(res["limits"])[-1] + " = ")


def test_new_cell_mix_and_metric_are_new_files(tmp_path):
    """A dummy cell on a dummy mix with a dummy per-layer metric: new files
    and new entries only, no file of the benchmark edited."""
    root, spec = tiny_root(tmp_path)
    before = {p: p.read_bytes() for p in (root / "benchmark").rglob("*")
              if p.is_file()}
    mix = json.loads((root / "benchmark/traffic/encode_256x128k.json")
                     .read_text())
    mix.update(records=3, len_lo=1000, len_hi=3000)
    (root / "benchmark/traffic/dummy_mix.json").write_text(json.dumps(mix))
    (root / "benchmark/metrics/dummy.calls.py").write_text(
        'UNIT = "1"\nLAYER = "encode entry"\nMOVES = "encode_GBps"\n\n\n'
        'def read(ctx):\n    s = ctx["stages"]\n'
        '    return s["calls"] if s else None\n')
    spec["workloads"].append({"name": "dummy.cell", "config":
                              "kafka_zstd_batch16k", "traffic": "dummy_mix",
                              "chips": 1, "why": "a test"})
    for e in spec["end_to_end"]:
        if "encode_GBps" == e["name"] or "encode_ratio" == e["name"]:
            e["workloads"].append("dummy.cell")
    spec["per_layer"].append({"name": "dummy.calls", "unit": "1",
                              "better": "higher", "source": "host_clock",
                              "layer": "encode entry", "moves": "encode_GBps",
                              "workloads": ["dummy.cell"]})
    res, _ = harness.run_cell(spec, "dummy.cell", 5, 0.3, False, "cpu",
                              root=root)
    assert res["correct"]
    assert set(res["metrics"]) == {"setup_s", "encode_GBps", "encode_ratio"}
    res, _ = harness.run_cell(spec, "dummy.cell", 5, 0.3, True, "cpu",
                              root=root)
    assert res["correct"] and res["metrics"]["dummy.calls"]["value"] >= 1
    after = {p: p.read_bytes() for p in before}
    assert after == before


def test_forbidden_modules_compared_whole(monkeypatch):
    for name in ("zstdsharp_tpu_torch", "zstdsharp_tpu_torchx.y", "jaxtyping"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "zstdsharp_tpu.ops", sys)
    monkeypatch.setitem(sys.modules, "jax", sys)
    assert harness.forbidden_modules() == ["jax", "zstdsharp_tpu"]


def test_a_run_loads_no_jax(tmp_path):
    """A whole tiny run in a fresh process: no module whose top-level name
    is jax, jaxlib, flax or zstdsharp_tpu is loaded."""
    root, _ = tiny_root(tmp_path)
    code = (
        "import json, sys; sys.path.insert(0, %r)\n"
        "from pathlib import Path\n"
        "from benchmark import harness\n"
        "root = Path(%r)\n"
        "spec = json.loads((root / 'BENCHMARK.json').read_text())\n"
        "for cell in ('kafka16k.consume', 'kafka16k.produce'):\n"
        "    res, _ = harness.run_cell(spec, cell, 3, 0.2, True, 'cpu',\n"
        "                              root=root)\n"
        "    assert res['correct']\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n"
        % (str(ROOT), str(root)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, check=True).stdout
    tops = set(json.loads(out.strip().splitlines()[-1]))
    assert "zstdsharp_tpu_torch" in tops
    assert not tops & set(harness.FORBIDDEN)


def _run(cwd, *extra):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", CELLS[0], "--seed",
         "1", "--seconds", "1", "--trace", "0", *extra], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    p = _run(ROOT)
    assert p.returncode != 0 and p.stdout == ""
    assert "CUDA" in p.stderr


def test_benchmark_alone_no_result(tmp_path):
    """A directory holding only BENCHMARK.json and the benchmark's files."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run(tmp_path)
    assert p.returncode != 0 and p.stdout == ""


def test_unknown_cell_no_result():
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "no.such.cell", "--seed", "1", "--seconds", "1"],
                       cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout == ""


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_on_the_card(cell, card):
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell,
                        "--seed", "2147483711", "--seconds", "3", "--trace",
                        "1"], cwd=ROOT, capture_output=True, text=True,
                       timeout=900)
    assert p.returncode == 0, p.stderr[-3000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
