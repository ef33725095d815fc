"""Build the port's CUDA kernels with nvcc and load them with ctypes.

The sources under ``csrc/`` have a plain C interface (pointers, ints and a
``cudaStream_t`` passed as ``void*``), so they compile in seconds without
PyTorch's headers.  One nvcc per source runs at once, then one links::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \\
         -Xcompiler -fPIC -c -o build/<name>.o csrc/<name>.cu   # each
    nvcc -shared -o build/libzt_kernels.so build/*.o

The library goes into ``build/`` at the repository root (ignored by git)
and is rebuilt when any source is newer.  Nothing is built or loaded at
import: the first kernel launch calls :func:`load`.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build"
SOURCES = ("huf_decode.cu", "fse_decode.cu", "histogram.cu")
LIB_PATH = BUILD_DIR / "libzt_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib = None


class BuildInfo:
    """What the last build in this process did (None: the library was
    already up to date and only loaded)."""

    seconds: float | None = None
    log: str = ""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _stale() -> bool:
    if not LIB_PATH.exists():
        return True
    built = LIB_PATH.stat().st_mtime
    return any((CSRC / s).stat().st_mtime > built for s in SOURCES)


def _run_all(cmds: list) -> str:
    """Run the commands at once; raise if any fails.  Returns their
    output."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs, failed = [], []
    try:
        for c, p in zip(cmds, procs):
            out, _ = p.communicate(timeout=600)
            logs.append(out)
            if p.returncode != 0:
                failed.append(f"{' '.join(c)} ({p.returncode}):\n{out}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    return "".join(logs)


def _build() -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = os.getpid()
    objs = [BUILD_DIR / f"{Path(s).stem}.{tag}.o" for s in SOURCES]
    tmp = LIB_PATH.with_name(f"{LIB_PATH.name}.{tag}.tmp")
    nvcc = _nvcc()
    t0 = time.perf_counter()
    try:
        log = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(CSRC / s)]
                        for s, o in zip(SOURCES, objs)])
        log += _run_all([[nvcc, "-shared", "-o", str(tmp),
                          *(str(o) for o in objs)]])
        os.replace(tmp, LIB_PATH)
    finally:
        tmp.unlink(missing_ok=True)
        for o in objs:
            o.unlink(missing_ok=True)
    BuildInfo.seconds = time.perf_counter() - t0
    BuildInfo.log = log


def load() -> ctypes.CDLL:
    """The kernel library, built first if missing or stale.  Once loaded
    it is returned without taking the lock: every launch calls this."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        if _stale():
            _build()
        lib = ctypes.CDLL(str(LIB_PATH))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.zt_huf_decode.restype = i
        lib.zt_huf_decode.argtypes = [p, i, p, p, p, p, p, p, p, p, i, i, p]
        lib.zt_fse_decode.restype = i
        lib.zt_fse_decode.argtypes = [p, i, p, p, p, p, p, p, p, p, i, i, p]
        lib.zt_histogram.restype = i
        lib.zt_histogram.argtypes = [p, p, i, ctypes.c_longlong, p, p, i, i,
                                     p]
        lib.zt_histogram_floor.restype = i
        lib.zt_histogram_floor.argtypes = [i, i, i, p]
        _lib = lib
        return lib
