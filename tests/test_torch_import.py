"""The port stands alone: importing it pulls in no JAX and initialises no
CUDA, its sources import neither JAX nor the JAX package, running its CPU
paths loads no module of the JAX package, its native loader writes nothing
under native/, and chip_smoke.py refuses to report a result without a CUDA
device or outside a checkout."""

import os
import re
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent


def _clean_env():
    """The environment of the checks' fresh processes: no JAX settings,
    the repository on the path, and one torch thread, so that their CPU
    paths do not stall on a machine whose cores other test workers hold
    (torch's threads, one a core, then wait on each other)."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_"))}
    env["PYTHONPATH"] = str(ROOT)
    env["OMP_NUM_THREADS"] = "1"
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
        "from zstdsharp_tpu_torch import graft_entry, dictionary, streaming\n"
        "from zstdsharp_tpu_torch.decode import streaming as dstreaming\n"
        "from zstdsharp_tpu_torch.encode import block, params, seqstore\n"
        "from zstdsharp_tpu_torch.encode import sequences_api\n"
        "from zstdsharp_tpu_torch.utils import trace, xxhash\n"
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


_REF_IMPORT = re.compile(r"^\s*(from|import)\s+zstdsharp_tpu(\.|\s|$)", re.M)


def _port_files():
    files = sorted((ROOT / "zstdsharp_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


_OPTIONAL_IMPORT = re.compile(
    r"^\s*(from|import)\s+(xxhash|zstandard)(\.|\s|$)", re.M)


def test_sources_import_no_xxhash_or_zstandard():
    """The GPU host has neither module: the port hashes through its engine
    and never imports the oracle."""
    bad = [str(f.relative_to(ROOT)) for f in _port_files()
           if _OPTIONAL_IMPORT.search(f.read_text())]
    assert not bad, f"files importing xxhash or zstandard: {bad}"


def test_public_api_loads_no_reference_module():
    """``import zstdsharp_tpu_torch as z``, then its public names: every
    name resolves, a compress / decompress round trip and a stream run,
    and neither JAX nor any module of the JAX package is loaded."""
    code = textwrap.dedent("""\
        import io, sys
        import zstdsharp_tpu_torch as z
        for name in z.__all__:
            getattr(z, name)
        data = b"public api " * 5000
        f = z.compress(data, 3)
        assert z.decompress(f) == data
        sink = io.BytesIO()
        s = z.CompressionStream(sink, level=3, checksum=True)
        s.write(data)
        s.close()
        r = z.DecompressionStream(io.BytesIO(sink.getvalue()))
        assert r.read() == data
        d = z.train_dictionary([b"rec %d" % i * 9 for i in range(300)], 1024)
        c = z.Compressor(3)
        c.load_dictionary(d)
        dec = z.Decompressor()
        dec.load_dictionary(d)
        assert dec.unwrap_many(c.wrap_many([b"rec 7" * 9])) == [b"rec 7" * 9]
        bad = sorted(k for k in sys.modules
                     if k == "zstdsharp_tpu" or k.startswith("zstdsharp_tpu.")
                     or k in ("jax", "xxhash", "zstandard"))
        assert not bad, bad
        print("ok")
        """)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_clean_env(),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"


def test_reference_import_pattern():
    """The pattern catches the JAX package and not the port's own name."""
    for line in ("import zstdsharp_tpu", "from zstdsharp_tpu import native",
                 "  from zstdsharp_tpu.decode.frame import decompress",
                 "import zstdsharp_tpu.ops as ops"):
        assert _REF_IMPORT.search(line), line
    for line in ("import zstdsharp_tpu_torch",
                 "from zstdsharp_tpu_torch.decode import frame",
                 "    from zstdsharp_tpu_torch import native",
                 "# from zstdsharp_tpu import native"):
        assert not _REF_IMPORT.search(line), line


def test_sources_import_no_reference_package():
    files = _port_files()
    assert len(files) >= 25
    bad = [str(f.relative_to(ROOT)) for f in files
           if _REF_IMPORT.search(f.read_text())]
    assert not bad, f"files importing zstdsharp_tpu: {bad}"


def test_cpu_paths_load_no_reference_module():
    """Import every port module, then run the CPU decode plane (a
    multi-block frame and a host-routed one among the frames), the CPU
    encode plane, the port's compress / decompress, a dictionary batch
    through ``Decompressor.load_dictionary`` and ``unwrap_many_device``
    (a frame of another dictionary host-decoded beside them) and
    ``ldm_anchor_mask`` in a clean process: no module of the JAX package,
    and no JAX, may be loaded."""
    code = textwrap.dedent("""\
        import importlib, pkgutil, sys
        import numpy as np
        import zstdsharp_tpu_torch as pkg
        for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
            importlib.import_module(m.name)
        from zstdsharp_tpu_torch.decode.device_pipeline import (
            decode_batch_device)
        from zstdsharp_tpu_torch.decode.frame import decompress
        from zstdsharp_tpu_torch.encode.device_pipeline import (
            compress_batch_device)
        from zstdsharp_tpu_torch.encode.frame import compress

        r = np.random.default_rng(1)
        words = [b"alpha ", b"beta ", b"gamma ", b"delta "]
        text = lambda n: b"".join(words[i] for i in r.integers(0, 4, n))
        recs = [text(n) for n in (700, 900, 1200)]
        multi = text(60_000)      # 360 KB: multi-block, on the device
        huge = text(900_000)      # over 4 MB: routed to the host engine
        frames = [compress(x, 9) for x in recs]
        frames += [compress(multi, 3), compress(huge, 1)]
        out, stats = decode_batch_device(frames, device="cpu",
                                         materialize=True)
        assert out == recs + [multi, huge], "decode"
        assert stats == {"device_frames": 4, "host_frames": 1}, stats
        enc, estats = compress_batch_device(recs, device="cpu",
                                            materialize=True)
        assert [decompress(f) for f in enc] == recs, "encode"
        assert estats["device_frames"] == 3, estats
        assert decompress(compress(multi, 5, checksum=True)) == multi
        import zstandard
        from zstdsharp_tpu_torch.decode.frame import Decompressor
        d = zstandard.train_dictionary(2048, [text(40) for _ in range(200)])
        dec = Decompressor()
        dec.load_dictionary(d.as_bytes())
        assert dec._dict.dict_id == d.dict_id(), "dictionary"
        drecs = [text(n) for n in (30, 90, 300)]
        dframes = [zstandard.ZstdCompressor(level=3, dict_data=d).compress(x)
                   for x in drecs]
        raw = zstandard.ZstdCompressionDict(
            recs[0], dict_type=zstandard.DICT_TYPE_RAWCONTENT)
        dframes.append(zstandard.ZstdCompressor(
            level=3, dict_data=raw).compress(recs[0][100:400]))
        dec.load_dictionary(recs[0])          # raw content, ID 0
        outs, lens, host = dec.unwrap_many_device(dframes[3:], "cpu")
        assert outs[0][0, :lens[0]].numpy().tobytes() == recs[0][100:400]
        dec.load_dictionary(d.as_bytes())
        outs, lens, host = dec.unwrap_many_device(dframes[:3], "cpu")
        assert not host and [outs[0][k, :lens[k]].numpy().tobytes()
                             for k in range(3)] == drecs, "dictionary batch"
        import torch
        from zstdsharp_tpu_torch.ops.ldm import (ldm_anchor_mask,
                                                 ldm_anchor_mask_reference)
        src = np.frombuffer(huge[:5000], np.uint8)
        assert np.array_equal(ldm_anchor_mask(torch.from_numpy(src.copy()))
                              .numpy(), ldm_anchor_mask_reference(src))
        bad = sorted(k for k in sys.modules
                     if k == "zstdsharp_tpu" or k.startswith("zstdsharp_tpu."))
        assert not bad, bad
        assert "jax" not in sys.modules, "jax imported"
        print("ok")
        """)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_clean_env(),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"


@pytest.mark.parametrize("tracked_fresh", [True, False],
                         ids=["tracked", "build"])
def test_native_loader_writes_nothing_under_native(tmp_path, tracked_fresh):
    """In a copy of the port beside the engine's source and tracked
    library: a library not older than the source is loaded as it is;
    otherwise the source is built into build/host/ and that is loaded.
    Either way native/ is left as it was (no file added, none rewritten).
    The copy keeps the check apart from the JAX package, which rebuilds the
    real native/ library in place when it finds it stale."""
    shutil.copytree(ROOT / "zstdsharp_tpu_torch",
                    tmp_path / "zstdsharp_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    native_dir = tmp_path / "native"
    native_dir.mkdir()
    for name in ("zstdtpu_core.cpp", "libzstdtpu_core.so"):
        shutil.copy2(ROOT / "native" / name, native_dir / name)
    t = (native_dir / "zstdtpu_core.cpp").stat().st_mtime
    t += 10 if tracked_fresh else -10
    os.utime(native_dir / "libzstdtpu_core.so", (t, t))

    def snapshot():
        return {p.name: (p.stat().st_mtime_ns, p.stat().st_size)
                for p in native_dir.iterdir()}

    before = snapshot()
    code = ("from zstdsharp_tpu_torch import native\n"
            "lib = native.get_lib()\n"
            "assert native.xxh64(b'abc') == 0x44BC2CF5AD770999\n"
            "print(lib._name)\n")
    env = _clean_env()
    env["PYTHONPATH"] = str(tmp_path)
    r = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stderr
    assert snapshot() == before
    built = sorted((tmp_path / "build" / "host").glob("libzstdtpu_core.*.so"))
    loaded = Path(r.stdout.strip())
    if tracked_fresh:
        assert loaded == native_dir / "libzstdtpu_core.so" and not built
    else:
        assert built == [loaded]


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
