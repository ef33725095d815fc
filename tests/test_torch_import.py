"""The port stands alone: importing it pulls in no JAX and initialises no
CUDA, its sources import no JAX, and chip_smoke.py refuses to report a
result without a CUDA device or outside a checkout."""

import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent


def _clean_env():
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_"))}
    env["PYTHONPATH"] = str(ROOT)
    return env


def test_import_pulls_in_no_jax_and_no_cuda():
    code = (
        "import sys, torch\n"
        "import zstdsharp_tpu_torch\n"
        "from zstdsharp_tpu_torch import _build\n"
        "from zstdsharp_tpu_torch.decode import device_pipeline, frame\n"
        "from zstdsharp_tpu_torch.encode import device_pipeline as enc\n"
        "from zstdsharp_tpu_torch.ops import device_fse, device_huf, execseq\n"
        "from zstdsharp_tpu_torch.ops import common, device_encode, histogram\n"
        "from zstdsharp_tpu_torch.ops import matcher\n"
        "from zstdsharp_tpu_torch.parallel import pipeline\n"
        "from zstdsharp_tpu_torch import graft_entry\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n"
        "assert not torch.cuda.is_initialized(), 'CUDA initialised'\n"
        "assert _build._lib is None, 'kernels loaded at import'\n"
        "print('ok')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_clean_env(),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"


def test_sources_import_no_jax():
    pat = re.compile(r"^\s*(import jax|from jax)", re.M)
    files = sorted((ROOT / "zstdsharp_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) >= 17
    for f in files:
        assert not pat.search(f.read_text()), f


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_fails_without_card_or_checkout(where, tmp_path):
    script = ROOT / "chip_smoke.py"
    if where == "alone":
        script = Path(shutil.copy(script, tmp_path / "chip_smoke.py"))
    env = _clean_env()
    env.pop("PYTHONPATH")
    env["CUDA_VISIBLE_DEVICES"] = ""
    r = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
