"""The plain decoder (the encode cells' reference) against frames it did not
make, and its independence from the program."""

import ast
import json
import subprocess
import sys

import numpy as np
import pytest

from benchmark.engine import Engine
from benchmark.planes.encode import raw_frame
from benchmark.reference import zstd_plain as Z
from zbench_util import ROOT

ENGINE_LEVELS = (-3, 1, 3, 16, 19, 22)  # fast, dfast and the optimal family


def inputs():
    rng = np.random.default_rng(11)
    words = [b"alpha", b"beta", b"gamma", b"delta", b"zstd", b"frame"]
    text = b" ".join(words[i] for i in rng.integers(0, 6, 30_000))
    return {
        "empty": b"", "one": b"x", "short": b"abcabcabcabc",
        "text": text[:100_000],
        "random": rng.integers(0, 256, 20_000, dtype=np.uint8).tobytes(),
        "run": b"\x07" * 70_000,
        "skewed": rng.integers(0, 3, 131_072).astype(np.uint8).tobytes(),
        "mixed": (text[:40_000]
                  + rng.integers(0, 256, 30_000, dtype=np.uint8).tobytes()
                  + b"\x00" * 20_000 + bytes(range(256)) * 100),
        "multi_block": text * 3,  # past 128 KB: several blocks
    }


@pytest.mark.parametrize("level", ENGINE_LEVELS)
@pytest.mark.parametrize("name", list(inputs()))
def test_engine_frames(level, name):
    data = inputs()[name]
    frame = Engine().frame(data, level, False)
    assert Z.decode_frame(frame) == data
    h = Z.frame_header(frame)
    assert h["content_size"] == len(data) and not h["has_checksum"]


def test_checksum_flag_reported():
    data = inputs()["text"]
    frame = Engine().frame(data, 3, True)
    assert Z.frame_header(frame)["has_checksum"]
    assert Z.decode_frame(frame) == data


def test_port_device_encoder_frames_on_the_cpu():
    """Frames of the port's device encode plane (its CPU path) at each of
    its buckets."""
    from zstdsharp_tpu_torch.encode.device_pipeline import \
        compress_batch_device

    d = inputs()
    recs = [d["text"][:4000], d["text"][:16000], d["mixed"][:60000],
            d["skewed"], d["short"], d["random"][:3000], d["run"][:9000]]
    frames, _ = compress_batch_device(recs, True, device="cpu")
    for f, r in zip(frames, recs):
        assert Z.decode_frame(f) == r


def test_raw_frame():
    for data in (b"", b"q", inputs()["random"], inputs()["skewed"]):
        assert Z.decode_frame(raw_frame(data)) == data


@pytest.mark.parametrize("cut", [1, 3, 7, 50])
def test_truncated_frames_raise(cut):
    frame = Engine().frame(inputs()["mixed"], 3, False)
    with pytest.raises(Z.FrameError):
        Z.decode_frame(frame[:-cut])


def test_corrupt_frames_never_pass():
    """Bit flips in the compressed body: each either raises or decodes to
    other bytes, as the content size and the exact ends of every bitstream
    are checked."""
    data = inputs()["mixed"]
    frame = Engine().frame(data, 3, False)
    rng = np.random.default_rng(5)
    for _ in range(200):
        b = bytearray(frame)
        p = int(rng.integers(6, len(b)))
        b[p] ^= 1 << int(rng.integers(0, 8))
        try:
            out = Z.decode_frame(bytes(b))
        except (Z.FrameError, IndexError, KeyError, TypeError):
            continue
        assert out != data


def test_header_fields():
    f = raw_frame(b"abc")
    h = Z.frame_header(f)
    assert h == {"header_size": 9, "content_size": 3, "window_size": 3,
                 "has_checksum": False, "dict_id": 0, "single_segment": True}
    with pytest.raises(Z.FrameError):
        Z.frame_header(b"\x00" * 12)


def test_reference_imports_nothing_of_the_program():
    ref = ROOT / "benchmark" / "reference"
    for path in ref.glob("*.py"):
        tree = ast.parse(path.read_text())
        names = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
                 for a in n.names}
        names |= {n.module for n in ast.walk(tree)
                  if isinstance(n, ast.ImportFrom) and n.module}
        tops = {n.split(".")[0] for n in names}
        assert not tops & {"zstdsharp_tpu_torch", "zstdsharp_tpu", "jax",
                           "torch"}, path
    code = ("import json, sys; sys.path.insert(0, %r); "
            "import benchmark.reference.zstd_plain as z; "
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"
            % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout
    tops = set(json.loads(out))
    assert not tops & {"zstdsharp_tpu_torch", "zstdsharp_tpu", "jax",
                       "torch", "numpy"}
