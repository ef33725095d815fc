"""The benchmark's own ctypes binding of the repository's C++ engine
(``native/zstdtpu_core.cpp``), used for one thing: making the decode cells'
frames at set-up (``zt_compress_exact``, level 3, no checksum).

It does not go through the port's ``native.py``, so a change to the port's
host tier cannot change a decode cell's input.  The library is the tracked
``native/libzstdtpu_core.so`` when it is not older than the source and loads
on this host; otherwise the source is compiled once into
``build/benchmark/libzstdtpu_core.<hash>.so`` inside the checkout (a file
lock and an atomic rename, so concurrent runs build it once).
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import platform
import subprocess
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
SRC = ROOT / "native" / "zstdtpu_core.cpp"
TRACKED = ROOT / "native" / "libzstdtpu_core.so"
BUILD = ROOT / "build" / "benchmark"
CXX = ("g++", "-O2", "-march=native", "-shared", "-fPIC", "-std=c++17")


class Engine:
    """``frame(record, level, checksum)``: one zstd frame."""

    def __init__(self):
        self.lib = _open()
        f = self.lib.zt_compress_exact
        u8p = ctypes.POINTER(ctypes.c_uint8)
        f.restype = ctypes.c_int64
        f.argtypes = [u8p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
                      u8p, ctypes.c_int64]

    def frame(self, rec: bytes, level: int, checksum: bool) -> bytes:
        src = np.frombuffer(rec, np.uint8)
        cap = len(src) + (len(src) >> 2) + 4096
        out = np.empty(cap, np.uint8)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        n = self.lib.zt_compress_exact(
            src.ctypes.data_as(u8p), len(src), level, int(checksum),
            out.ctypes.data_as(u8p), cap)
        if n < 0:
            raise RuntimeError(f"zt_compress_exact returned {n}")
        return out[:n].tobytes()


def _open() -> ctypes.CDLL:
    if not SRC.exists():
        raise FileNotFoundError(f"{SRC} is missing: run from a checkout")
    if TRACKED.exists() and TRACKED.stat().st_mtime >= SRC.stat().st_mtime:
        try:
            return ctypes.CDLL(str(TRACKED))
        except OSError:
            pass  # built for another CPU: build this host's copy below
    key = hashlib.sha256(SRC.read_bytes())
    key.update(" ".join(CXX).encode())
    key.update(f"{platform.node()} {platform.machine()}".encode())
    path = BUILD / f"libzstdtpu_core.{key.hexdigest()[:16]}.so"
    BUILD.mkdir(parents=True, exist_ok=True)
    with open(BUILD / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not path.exists():
            tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
            try:
                subprocess.run([*CXX, str(SRC), "-o", str(tmp)], check=True,
                               capture_output=True, timeout=900)
                os.replace(tmp, path)
            finally:
                tmp.unlink(missing_ok=True)
    return ctypes.CDLL(str(path))
