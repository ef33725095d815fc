"""The port's ctypes binding of the C++ host engine (native/zstdtpu_core.cpp,
the repository's source, compiled and bound here; counterpart of
zstdsharp_tpu/native.py).  It binds only the entry points the port calls:

* the device decode planner: ``DPlaneCtx``, ``zt_dplane_batch`` and the
  ``zt_dplane_pack_*`` entry points;
* whole-frame codecs: ``compress_exact``, ``compress_frame_body``,
  ``NativeEStream`` (the streaming encoder, for frames the whole-frame
  routes decline), ``decode_frame_body``, ``dp_frame_body``;
* the decompression dictionary ``NativeDDict`` (``zt_ddict_*``,
  ``zt_decode_frame_body_ddict``, ``zt_decompress_many_ddict``);
* the block-level decoders the planner's host route uses:
  ``huf_decode_stream``, ``fse_decode_sequences``, and ``execute_sequences``
  (the LZ copy of the host block decoder);
* the compression dictionary ``NativeCDict`` (``zt_cdict_*``: prefilled
  matcher tables, batch and single-frame encode, the trainer's entropy
  statistics) and the streaming block decoder ``NativeDStream``
  (``zt_dstream_*``);
* the host block encoder's kernels: ``fast_find_matches``,
  ``lazy_find_matches``, ``encode_sequences``, ``huf_encode_stream``;
* ``xxh64``;
* the zero-copy CPython route ``get_ext`` (the repository's
  ``native/ztpy.cpp``, ``_ztpy``): ``decode_frame_body`` and
  ``compress_exact`` written straight into a ``bytes`` object, for the
  frame decoder and ``compress_exact``; ``host_route`` names the route.

The handles that keep per-call scratch in the engine (``NativeCDict``,
``NativeDDict``, ``NativeDStream``) hold a lock around every call, since
ctypes releases the GIL and one handle may be shared across threads;
``close`` (or leaving a ``with`` block) frees them.

Which library is loaded: ``native/libzstdtpu_core.so`` (a tracked file)
when it is not older than the source; otherwise the source is compiled
with g++ into ``build/host/`` at the repository root (ignored by git),
under a file lock, through a temporary file and an atomic rename, so
that concurrent processes build once and never see a partial library.
Nothing is ever written under ``native/``.  The built library's name
carries a hash of the source, the flags and the host, so a build made on
one machine is not loaded on another.  Where the engine can be neither
loaded nor built, :func:`get_lib` raises: the port has no pure-Python
codec to fall back on.

The extension is optional, as in the reference: ``get_ext`` builds
``native/ztpy.cpp`` with g++ against Python's headers into
``build/host/_ztpy.<hash><EXT_SUFFIX>`` (the same lock and atomic rename;
the hash covers the source, the flags, the Python ABI, the host and the
engine file with its contents) and links it to the very engine file the
ctypes binding loaded, so both share one engine image.  It never loads the
tracked ``native/_ztpy.so``, which links ``native/`` by rpath.  Without
Python's headers, when the build fails, or with ``ZSTDTPU_NO_EXT`` set, it
returns None and the ctypes route serves every call.

The encode plane's table builders are the port's own source,
``zstdsharp_tpu_torch/csrc/host_tables.cpp`` (``zt_build_lit_tables``,
``zt_build_seq_tables``): ``get_tables_lib`` builds it with g++ into
``build/host/libzt_tables.<hash>.so`` by the same lock and atomic rename
(the hash covers the source, the flags and the host) and raises with the
compiler's error where it cannot.  The decode planner's block walk of
multi-block frames, ``zstdsharp_tpu_torch/csrc/mb_plan.cpp``
(``zt_mb_plan``, its rows in an ``MbOut``), is built and loaded the same
way by ``get_mb_lib`` into ``build/host/libzt_mb_plan.<hash>.so``.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import platform
import subprocess
import sys
import sysconfig
import threading
from pathlib import Path

import numpy as np

_REPO = Path(__file__).resolve().parent.parent
SRC = _REPO / "native" / "zstdtpu_core.cpp"
TRACKED_LIB = _REPO / "native" / "libzstdtpu_core.so"
BUILD_DIR = _REPO / "build" / "host"
# The reference's flags: -O2 globally, hot decode loops pin O3 in the source.
CXX_FLAGS = ("-O2", "-march=native", "-shared", "-fPIC", "-std=c++17")
EXT_SRC = _REPO / "native" / "ztpy.cpp"
EXT_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")
TABLES_SRC = _REPO / "zstdsharp_tpu_torch" / "csrc" / "host_tables.cpp"
TABLES_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")
MB_SRC = _REPO / "zstdsharp_tpu_torch" / "csrc" / "mb_plan.cpp"
MB_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")


class DPlaneCtx(ctypes.Structure):
    """Mirror of ZtDPlaneCtx (native/zstdtpu_core.cpp): the device-plane
    planner's caller-owned operand buffers and counters."""

    _fields_ = (
        [(n, ctypes.c_int64) for n in
         ("pool_cap", "pool_off", "huf_cap", "n_huf", "fse_cap", "n_fse",
          "huf_maxw", "fse_maxw", "s_cap", "huf_wmax", "fse_wmax",
          "max_seq", "max_out")]
        + [("raw_pool", ctypes.POINTER(ctypes.c_uint8)),
           ("huf_words", ctypes.POINTER(ctypes.c_uint32))]
        + [(n, ctypes.POINTER(ctypes.c_int32)) for n in
           ("huf_limits", "huf_bases", "huf_offs", "huf_shifts",
            "huf_planes", "huf_pos", "huf_nsym", "huf_wlen")]
        + [("fse_words", ctypes.POINTER(ctypes.c_uint32))]
        + [(n, ctypes.POINTER(ctypes.c_int32)) for n in
           ("fse_ll", "fse_of", "fse_ml", "fse_logs", "fse_pos",
            "fse_rep", "fse_nseq", "fse_wlen", "fse_st")]
    )


class SeqChannel(ctypes.Structure):
    """Mirror of ZtSeqChannel (csrc/host_tables.cpp): one sequence
    channel's code histograms and predefined rows in, its per-lane table
    rows out (each pointer an array's address)."""

    _fields_ = (
        [("hist", ctypes.c_void_p)]
        + [(n, ctypes.c_int64) for n in ("nbins", "nsym", "tlog")]
        + [(n, ctypes.c_void_p) for n in
           ("pre_maps", "pre_nbs", "pre_init", "maps", "nbs", "init",
            "flush")]
    )


class MbOut(ctypes.Structure):
    """Mirror of ZtMbOut (csrc/mb_plan.cpp): one block-walk call's limits
    in, its frame, block and sequence rows out (each pointer an array's
    address), how far it went and why it stopped."""

    _fields_ = (
        [(n, ctypes.c_int64) for n in ("maxlog", "content_cap",
                                       "window_cap")]
        + [(n, ctypes.c_void_p) for n in ("frames", "blocks", "ll", "ml",
                                          "of")]
        + [(n, ctypes.c_int64) for n in
           ("blk_cap", "seq_cap", "n_blocks", "n_seqs", "seq_ns", "stop",
            "room", "want_pool", "want_huf", "want_blocks", "want_seqs")]
    )


_lock = threading.Lock()
_lib = None
_tables_lib = None   # csrc/host_tables.cpp, built and loaded
_mb_lib = None       # csrc/mb_plan.cpp, built and loaded
_lib_file = None     # the engine file get_lib loaded
_ext_lock = threading.Lock()
_ext = None          # the _ztpy extension module
_ext_tried = False


def built_lib_path() -> Path:
    """Where this host's build of the source goes."""
    key = hashlib.sha256(SRC.read_bytes())
    key.update(" ".join(CXX_FLAGS).encode())
    key.update(f"{platform.node()} {platform.machine()}".encode())
    return BUILD_DIR / f"libzstdtpu_core.{key.hexdigest()[:16]}.so"


def _compile(path: Path, cmd: list) -> str | None:
    """Run the g++ command `cmd` (its output the last argument) into
    `path` once, whatever the number of processes asking at the same
    time: under the build lock, into a temporary file renamed atomically.
    Returns None once `path` exists, else the compiler's error."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if path.exists():
            return None
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        try:
            r = subprocess.run([*cmd, str(tmp)], capture_output=True,
                               text=True, timeout=600)
            if r.returncode != 0:
                return r.stderr[-4000:]
            os.replace(tmp, path)
            return None
        except (OSError, subprocess.TimeoutExpired) as e:
            return str(e)
        finally:
            tmp.unlink(missing_ok=True)


def _build(path: Path) -> None:
    """Compile the engine's source into `path`; raise if it fails."""
    err = _compile(path, ["g++", *CXX_FLAGS, str(SRC), "-o"])
    if err is not None:
        raise RuntimeError(
            f"the native host engine ({SRC.name}) failed to build:\n{err}")


def _open() -> ctypes.CDLL:
    global _lib_file
    if (TRACKED_LIB.exists()
            and TRACKED_LIB.stat().st_mtime >= SRC.stat().st_mtime):
        try:
            lib = ctypes.CDLL(str(TRACKED_LIB))
            _lib_file = TRACKED_LIB
            return lib
        except OSError:
            pass  # e.g. built for another CPU: build this host's below
    path = built_lib_path()
    if not path.exists():
        _build(path)
    lib = ctypes.CDLL(str(path))
    _lib_file = path
    return lib


def ext_path(lib_file: Path) -> Path:
    """Where this host's build of the extension against the engine file
    `lib_file` goes."""
    key = hashlib.sha256(EXT_SRC.read_bytes())
    key.update(" ".join(EXT_FLAGS).encode())
    key.update(f"{sys.implementation.cache_tag} "
               f"{sysconfig.get_config_var('EXT_SUFFIX')}".encode())
    key.update(f"{platform.node()} {platform.machine()}".encode())
    key.update(str(lib_file.resolve()).encode())
    key.update(hashlib.sha256(lib_file.read_bytes()).digest())
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    return BUILD_DIR / f"_ztpy.{key.hexdigest()[:16]}{suffix}"


def get_ext():
    """The ``_ztpy`` extension module (zero-copy ``decode_frame_body`` and
    ``compress_exact``), built on first use and linked to the engine file
    ``get_lib`` loaded; None where it cannot be built or loaded or
    ``ZSTDTPU_NO_EXT`` is set, and the ctypes route serves instead."""
    global _ext, _ext_tried
    if _ext is not None or _ext_tried:
        return _ext
    get_lib()
    with _ext_lock:
        if _ext is not None or _ext_tried:
            return _ext
        _ext_tried = True
        if os.environ.get("ZSTDTPU_NO_EXT"):
            return None
        include = sysconfig.get_paths()["include"]
        if not (Path(include) / "Python.h").exists():
            return None
        lib_file = _lib_file.resolve()
        path = ext_path(lib_file)
        if not path.exists() and _compile(path, [
                "g++", *EXT_FLAGS, f"-I{include}", str(EXT_SRC),
                f"-L{lib_file.parent}", f"-l:{lib_file.name}",
                f"-Wl,-rpath,{lib_file.parent}", "-o"]) is not None:
            return None
        try:
            import importlib.util

            spec = importlib.util.spec_from_file_location("_ztpy", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
        except (ImportError, OSError):
            return None
        _ext = mod
    return _ext


def host_route() -> str:
    """The host codec's whole-frame route: "ztpy" (the extension) or
    "ctypes"."""
    return "ztpy" if get_ext() is not None else "ctypes"


def get_lib() -> ctypes.CDLL:
    """The engine, loaded (and built first if needed) on first use.
    Raises RuntimeError when it can be neither loaded nor built."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        try:
            lib = _open()
        except OSError as e:
            raise RuntimeError(
                f"the native host engine cannot be loaded or built: {e}"
            ) from e
        u8p = ctypes.POINTER(ctypes.c_uint8)
        u16p = ctypes.POINTER(ctypes.c_uint16)
        u32p = ctypes.POINTER(ctypes.c_uint32)
        i32p = ctypes.POINTER(ctypes.c_int32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        i64, i32, vp = ctypes.c_int64, ctypes.c_int32, ctypes.c_void_p
        sigs = {
            "huf_decode_stream": (i64, [u8p, i64, u8p, u8p, i32, u8p, i64]),
            "execute_sequences": (
                i64, [u8p, i64, i64, i64, u8p, i64, u32p, u32p, u32p, i64]),
            "fast_find_matches": (
                i64, [u8p, i64, i64, i64, i64, i64, i64p, i32, i32, u32p,
                      u32p, u32p, u32p, i64, i64p, i32]),
            "lazy_find_matches": (
                i64, [u8p, i64, i64, i64, i64, i64, i64p, i32, i64p, i64,
                      i64, i32, i64p, u32p, u32p, u32p, u32p, i64, i64p,
                      i32]),
            "encode_sequences": (
                i64, [u32p, u32p, u32p, u8p, u8p, u8p, u8p, u8p, i64]
                + [u16p, u32p, i32p, i32] * 3 + [u8p, i64]),
            "huf_encode_stream": (i64, [u8p, i64, u16p, u8p, u8p, i64]),
            "zt_cdict_create": (vp, [u8p, i64] + [i32] * 6),
            "zt_cdict_stats": (i64, [vp, u8p, i64p, i64] + [i64p] * 5),
            "zt_cdict_free": (None, [vp]),
            "zt_compress_frame_body_cdict": (i64, [vp, u8p, i64, u8p, i64]),
            "zt_compress_many_cdict": (
                i64, [vp, u8p, i64p, i64, ctypes.c_uint32, u8p, i64, i64p]),
            "zt_estream_preload": (i64, [vp, u8p, i64]),
            "zt_dstream_new": (vp, []),
            "zt_dstream_block": (i64, [vp, u8p, i64, u8p, i64, i64, i64]),
            "zt_dstream_drain": (
                i64, [vp, u8p, i64, u8p, i64, i64, i64, i64p,
                      ctypes.POINTER(ctypes.c_int)]),
            "zt_dstream_free": (None, [vp]),
            "fse_decode_sequences": (
                i64, [u8p, i64, i64] + [u32p, u8p, u16p, u8p, i32] * 3
                + [u32p, u32p, u32p, u32p]),
            "zt_dp_frame_body": (i64, [u8p, i64, i32p, i64, u8p, i64]),
            "xxh64": (ctypes.c_uint64, [u8p, i64, ctypes.c_uint64]),
            "compress_frame_body_ldm_c": (
                i64, [u8p, i64] + [i32] * 10 + [u8p, i64]),
            "decode_frame_body_c": (i64, [u8p, i64, u8p, i64, i64p]),
            "zt_estream_new2": (vp, [i32] * 7 + [i64, i32]),
            "zt_estream_feed": (i64, [vp, u8p, i64, i32, u8p, i64]),
            "zt_estream_free": (None, [vp]),
            "zt_estream_pending": (i64, [vp]),
            "zt_compress_exact": (i64, [u8p, i64, i32, i32, u8p, i64]),
            "zt_ddict_create": (vp, [u8p, i64]),
            "zt_ddict_free": (None, [vp]),
            "zt_decode_frame_body_ddict": (i64, [u8p, i64, vp, u8p, i64,
                                                 i64p]),
            "zt_decompress_many_ddict": (
                i64, [vp, u8p, i64p, i64, ctypes.c_uint32, u8p, i64, i64p]),
        }
        ctxp = ctypes.POINTER(DPlaneCtx)
        sigs.update({
            "zt_dplane_batch": (i64, [ctxp, u8p, i64p, i64, i32p, i32p]),
            "zt_dplane_pack_huf": (i64, [ctxp, u8p, i64, u8p, i64, i64, i64]),
            "zt_dplane_pack_fse": (
                i64, [ctxp, u8p, i64, i32p, i32p, i32p, i64, i64, i64, i32p,
                      i64]),
        })
        for name, (res, args) in sigs.items():
            fn = getattr(lib, name)
            fn.restype = res
            fn.argtypes = args
        _lib = lib
        return lib


def _port_lib_path(src: Path, flags: tuple, stem: str) -> Path:
    """Where this host's build of one of the port's own sources goes."""
    key = hashlib.sha256(src.read_bytes())
    key.update(" ".join(flags).encode())
    key.update(f"{platform.node()} {platform.machine()}".encode())
    return BUILD_DIR / f"{stem}.{key.hexdigest()[:16]}.so"


def _port_lib(src: Path, flags: tuple, stem: str, what: str) -> ctypes.CDLL:
    """One of the port's own sources, built with g++ if need be and
    loaded; RuntimeError with the compiler's error where it cannot be
    built."""
    path = _port_lib_path(src, flags, stem)
    err = _compile(path, ["g++", *flags, str(src), "-o"])
    if err is not None:
        raise RuntimeError(f"{what} ({src.name}) failed to build:\n{err}")
    return ctypes.CDLL(str(path))


def tables_lib_path() -> Path:
    """Where this host's build of the table builders' source goes."""
    return _port_lib_path(TABLES_SRC, TABLES_FLAGS, "libzt_tables")


def get_tables_lib() -> ctypes.CDLL:
    """The encode plane's table builders (``csrc/host_tables.cpp``),
    built on first use and loaded.  Raises RuntimeError with the
    compiler's error when it cannot be built."""
    global _tables_lib
    if _tables_lib is not None:
        return _tables_lib
    with _lock:
        if _tables_lib is not None:
            return _tables_lib
        lib = _port_lib(TABLES_SRC, TABLES_FLAGS, "libzt_tables",
                        "the encode plane's table builders")
        i64, vp = ctypes.c_int64, ctypes.c_void_p
        lib.zt_build_lit_tables.restype = i64
        lib.zt_build_lit_tables.argtypes = [i64] + [vp] * 7 + [i64]
        lib.zt_build_seq_tables.restype = i64
        lib.zt_build_seq_tables.argtypes = [
            i64, vp, ctypes.POINTER(SeqChannel), i64, vp, vp, vp]
        _tables_lib = lib
        return lib


def get_mb_lib() -> ctypes.CDLL:
    """The decode planner's block walk of multi-block frames
    (``csrc/mb_plan.cpp``), built on first use and loaded.  Raises
    RuntimeError with the compiler's error when it cannot be built."""
    global _mb_lib
    if _mb_lib is not None:
        return _mb_lib
    with _lock:
        if _mb_lib is not None:
            return _mb_lib
        lib = _port_lib(MB_SRC, MB_FLAGS, "libzt_mb_plan",
                        "the decode planner's block walk")
        i64, vp = ctypes.c_int64, ctypes.c_void_p
        lib.zt_mb_plan.restype = i64
        lib.zt_mb_plan.argtypes = [ctypes.POINTER(DPlaneCtx), vp, vp, vp,
                                   i64, ctypes.POINTER(MbOut)]
        _mb_lib = lib
        return lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _u8(a) -> np.ndarray:
    return (np.ascontiguousarray(a, np.uint8) if isinstance(a, np.ndarray)
            else np.frombuffer(a, dtype=np.uint8))


def _pad_payload(payload: bytes) -> np.ndarray:
    buf = np.zeros(16 + len(payload), dtype=np.uint8)
    buf[16:] = np.frombuffer(payload, dtype=np.uint8)
    return buf


def huf_decode_stream(payload: bytes, sym: np.ndarray, nb: np.ndarray,
                      table_log: int, n_out: int) -> np.ndarray | None:
    """One Huffman X1 stream of n_out symbols, or None if it overruns."""
    padded = _pad_payload(payload)
    out = np.empty(n_out, dtype=np.uint8)
    rc = get_lib().huf_decode_stream(
        _ptr(padded, ctypes.c_uint8), len(payload),
        _ptr(np.ascontiguousarray(sym, np.uint8), ctypes.c_uint8),
        _ptr(np.ascontiguousarray(nb, np.uint8), ctypes.c_uint8),
        table_log, _ptr(out, ctypes.c_uint8), n_out)
    return out if rc == 0 else None


def fse_decode_sequences(payload: bytes, nb_seq: int, ll, of, ml,
                         rep: list[int]):
    """nb_seq sequences through the three FSE tables (FseDTable with
    base_value / nb_add_bits / new_state / nb_bits); `rep` is updated in
    place.  Returns (ll, ml, of) uint32 arrays, or None if corrupt."""
    padded = _pad_payload(payload)
    outs = [np.empty(nb_seq, dtype=np.uint32) for _ in range(3)]
    rep_arr = np.array(rep, dtype=np.uint32)
    holds = []

    def tbl(t):
        arrs = (np.ascontiguousarray(t.base_value, np.uint32),
                np.ascontiguousarray(t.nb_add_bits, np.uint8),
                np.ascontiguousarray(t.new_state, np.uint16),
                np.ascontiguousarray(t.nb_bits, np.uint8))
        holds.append(arrs)
        return (_ptr(arrs[0], ctypes.c_uint32), _ptr(arrs[1], ctypes.c_uint8),
                _ptr(arrs[2], ctypes.c_uint16), _ptr(arrs[3], ctypes.c_uint8),
                t.table_log)

    rc = get_lib().fse_decode_sequences(
        _ptr(padded, ctypes.c_uint8), len(payload), nb_seq,
        *tbl(ll), *tbl(of), *tbl(ml), _ptr(rep_arr, ctypes.c_uint32),
        *(_ptr(o, ctypes.c_uint32) for o in outs))
    if rc != 0:
        return None
    rep[0], rep[1], rep[2] = (int(v) for v in rep_arr)
    return tuple(outs)


def execute_sequences(out: np.ndarray, out_pos: int, prefix_start: int,
                      literals: np.ndarray, lls, mls, ofs) -> int | None:
    """The LZ copy of one block into `out` from `out_pos` (history from
    `prefix_start`); the new write position, or None on a bad offset."""
    lit_src = np.ascontiguousarray(literals, np.uint8)
    lits = np.zeros(len(lit_src) + 16, dtype=np.uint8)  # wildcopy slack
    lits[:len(lit_src)] = lit_src
    rc = get_lib().execute_sequences(
        _ptr(out, ctypes.c_uint8), out_pos, len(out), prefix_start,
        _ptr(lits, ctypes.c_uint8), len(lit_src),
        _ptr(np.ascontiguousarray(lls, np.uint32), ctypes.c_uint32),
        _ptr(np.ascontiguousarray(mls, np.uint32), ctypes.c_uint32),
        _ptr(np.ascontiguousarray(ofs, np.uint32), ctypes.c_uint32), len(lls))
    return int(rc) if rc >= 0 else None


def fast_find_matches(src: np.ndarray, start: int, end: int, window_start: int,
                      window_size: int, table: np.ndarray, hash_log: int,
                      rep: list[int], acceleration: int = 1, mls: int = 4):
    """The fast strategy's parse of src[start:end] (hash table `table`
    updated in place, rep[0:2] too): (ll, ml, offBase, last literals), or
    None when the engine declines."""
    max_seq = max((end - start) // 3 + 8, 16)
    outs = [np.empty(max_seq, dtype=np.uint32) for _ in range(3)]
    rep_arr = np.array(rep[:2], dtype=np.uint32)
    last_lit = np.zeros(1, dtype=np.int64)
    n = get_lib().fast_find_matches(
        _ptr(src, ctypes.c_uint8), len(src), start, end, window_start,
        window_size, _ptr(table, ctypes.c_int64), hash_log,
        max(4, min(8, mls)), _ptr(rep_arr, ctypes.c_uint32),
        *(_ptr(o, ctypes.c_uint32) for o in outs), max_seq,
        _ptr(last_lit, ctypes.c_int64), acceleration)
    if n < 0:
        return None
    rep[0], rep[1] = int(rep_arr[0]), int(rep_arr[1])
    return outs[0][:n], outs[1][:n], outs[2][:n], int(last_lit[0])


def lazy_find_matches(src: np.ndarray, start: int, end: int, window_start: int,
                      window_size: int, table: np.ndarray, hash_log: int,
                      chain: np.ndarray, attempts: int, depth: int,
                      insert_from: int, rep: list[int], mls: int = 4):
    """The hash-chain parse (depth 0 greedy, 1 lazy, 2 lazy2) of
    src[start:end]: (ll, ml, offBase, last literals, next position to
    insert), or None when the engine declines."""
    max_seq = max((end - start) // 3 + 8, 16)
    outs = [np.empty(max_seq, dtype=np.uint32) for _ in range(3)]
    rep_arr = np.array(rep[:2], dtype=np.uint32)
    last_lit = np.zeros(1, dtype=np.int64)
    ins = np.array([insert_from], dtype=np.int64)
    n = get_lib().lazy_find_matches(
        _ptr(src, ctypes.c_uint8), len(src), start, end, window_start,
        window_size, _ptr(table, ctypes.c_int64), hash_log,
        _ptr(chain, ctypes.c_int64), len(chain), attempts, depth,
        _ptr(ins, ctypes.c_int64), _ptr(rep_arr, ctypes.c_uint32),
        *(_ptr(o, ctypes.c_uint32) for o in outs), max_seq,
        _ptr(last_lit, ctypes.c_int64), max(4, min(8, mls)))
    if n < 0:
        return None
    rep[0], rep[1] = int(rep_arr[0]), int(rep_arr[1])
    return (outs[0][:n], outs[1][:n], outs[2][:n], int(last_lit[0]),
            int(ins[0]))


def encode_sequences(lls, mls_minus3, obs, llc, mlc, ofc, ll_bits, ml_bits,
                     ll_ct, of_ct, ml_ct) -> bytes | None:
    """The interleaved three-state FSE bitstream of a block's sequences
    (ZSTD_encodeSequences_body), or None when it overflows."""
    n = len(lls)
    cap = 32 + n * 16
    out = np.empty(cap, dtype=np.uint8)
    holds = []  # the padded arrays live across the native call

    def ctbl(ct):
        # the engine reads the full alphabet range (36/53/32 entries):
        # tables built for a smaller max symbol are padded
        dnb = np.ascontiguousarray(ct.delta_nb_bits, np.uint32)
        dfs = np.ascontiguousarray(ct.delta_find_state, np.int32)
        if len(dnb) < 53:
            dnb = np.concatenate([dnb, np.zeros(53 - len(dnb), np.uint32)])
        if len(dfs) < 53:
            dfs = np.concatenate([dfs, np.zeros(53 - len(dfs), np.int32)])
        st = np.ascontiguousarray(ct.state_table, np.uint16)
        holds.extend((dnb, dfs, st))
        return (_ptr(st, ctypes.c_uint16), _ptr(dnb, ctypes.c_uint32),
                _ptr(dfs, ctypes.c_int32), ct.table_log)

    arrs = [np.ascontiguousarray(a, np.uint32) for a in (lls, mls_minus3, obs)]
    arrs += [np.ascontiguousarray(a, np.uint8)
             for a in (llc, mlc, ofc, ll_bits, ml_bits)]
    size = get_lib().encode_sequences(
        *(_ptr(a, ctypes.c_uint32) for a in arrs[:3]),
        *(_ptr(a, ctypes.c_uint8) for a in arrs[3:]),
        n, *ctbl(ll_ct), *ctbl(of_ct), *ctbl(ml_ct),
        _ptr(out, ctypes.c_uint8), cap)
    return None if size < 0 else out[:size].tobytes()


def huf_encode_stream(symbols: np.ndarray, code: np.ndarray,
                      nbits: np.ndarray) -> bytes | None:
    """One Huffman 1X stream of `symbols` (256-entry code and length
    tables), or None when it overflows."""
    symbols = np.ascontiguousarray(symbols, np.uint8)
    cap = 16 + len(symbols) * 2
    out = np.empty(cap, dtype=np.uint8)
    size = get_lib().huf_encode_stream(
        _ptr(symbols, ctypes.c_uint8), len(symbols),
        _ptr(np.ascontiguousarray(code, np.uint16), ctypes.c_uint16),
        _ptr(np.ascontiguousarray(nbits, np.uint8), ctypes.c_uint8),
        _ptr(out, ctypes.c_uint8), cap)
    return None if size < 0 else out[:size].tobytes()


def dp_frame_body(src: np.ndarray, cand: np.ndarray,
                  block_size: int) -> bytes | None:
    """One-pass frame body (no header or checksum): greedy selection over
    device candidates plus entropy coding per block (zt_dp_frame_body)."""
    if len(src) == 0:
        return None
    src = _u8(src)
    cap = len(src) + (len(src) >> 2) + 4096
    out = np.empty(cap, dtype=np.uint8)
    n = get_lib().zt_dp_frame_body(
        _ptr(src, ctypes.c_uint8), len(src),
        _ptr(np.ascontiguousarray(cand, np.int32), ctypes.c_int32),
        block_size, _ptr(out, ctypes.c_uint8), cap)
    return None if n < 0 else out[:n].tobytes()


def compress_frame_body(src: np.ndarray, strategy: int, hash_log: int,
                        chain_log: int, search_log: int, window_log: int,
                        accel: int = 1, use_ldm: bool = False,
                        min_match: int = 4, block_splitter: bool = True,
                        target_cblock: int = 0) -> bytes | None:
    """Whole-frame encode, every block, no header or checksum; None where
    the engine declines."""
    src = _u8(src)
    n = len(src)
    cap = n + (n >> 6) + 4096
    out = np.empty(cap, dtype=np.uint8)
    size = get_lib().compress_frame_body_ldm_c(
        _ptr(src, ctypes.c_uint8), n, strategy, hash_log, chain_log,
        search_log, window_log, accel, int(use_ldm), min_match,
        int(block_splitter), target_cblock, _ptr(out, ctypes.c_uint8), cap)
    return None if size < 0 else out[:size].tobytes()


def compress_exact(data: bytes, level: int,
                   checksum: bool = False) -> bytes | None:
    """A whole zstd frame from the exact encoder (ZSTD_compress2 semantics
    for the fast, dfast and bt-optimal strategies); None for a level and
    size it does not cover."""
    ext = get_ext()
    if ext is not None:  # the frame is written straight into the bytes
        return ext.compress_exact(data, level, bool(checksum))
    src = np.frombuffer(data, dtype=np.uint8)
    cap = len(src) + (len(src) >> 2) + 4096
    out = np.empty(cap, dtype=np.uint8)
    size = get_lib().zt_compress_exact(
        _ptr(src, ctypes.c_uint8), len(src), level, int(bool(checksum)),
        _ptr(out, ctypes.c_uint8), cap)
    return None if size < 0 else out[:size].tobytes()


class NativeEStream:
    """The engine's streaming encoder context (zt_estream_*): emits frame
    body blocks; the caller writes the frame header and checksum."""

    def __init__(self, strategy: int, hash_log: int, chain_log: int,
                 search_log: int, window_log: int, min_match: int,
                 accel: int = 1, tcbs: int = 0, ldm: int = 0):
        self._lib = get_lib()
        self._h = self._lib.zt_estream_new2(strategy, hash_log, chain_log,
                                            search_log, window_log,
                                            min_match, accel, tcbs, ldm)
        if not self._h:
            raise RuntimeError("zt_estream_new2 failed")

    def preload(self, dict_data: bytes) -> None:
        """Seed the context with a dictionary (prefix history, matcher
        table prefill, repcode and entropy seed); before any feed."""
        arr = _u8(bytes(dict_data))
        rc = self._lib.zt_estream_preload(
            self._h, _ptr(arr, ctypes.c_uint8), len(arr))
        if rc < 0:
            raise RuntimeError("zt_estream_preload failed")

    @property
    def pending(self) -> int:
        """Input bytes buffered in the context, not yet in a block."""
        return int(self._lib.zt_estream_pending(self._h))

    def feed(self, data: np.ndarray, mode: int) -> bytes:
        """mode: 0 accumulate, 1 flush, 2 end (writes the last block)."""
        arr = _u8(data)
        total = self.pending + len(arr)
        cap = total + (total >> 6) + (1 << 18)
        out = np.empty(cap, dtype=np.uint8)
        size = self._lib.zt_estream_feed(
            self._h, _ptr(arr, ctypes.c_uint8), len(arr), mode,
            _ptr(out, ctypes.c_uint8), cap)
        if size < 0:
            raise RuntimeError("zt_estream_feed failed")
        return out[:size].tobytes()

    def close(self) -> None:
        if self._h:
            self._lib.zt_estream_free(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass


def decode_frame_body(src, out_cap: int):
    """Whole-frame decode after the frame header, before the checksum.
    Returns (content uint8 array, bytes consumed), or None if corrupt."""
    arr = _u8(src)
    out = np.empty(out_cap, dtype=np.uint8)
    consumed = np.zeros(1, dtype=np.int64)
    produced = get_lib().decode_frame_body_c(
        _ptr(arr, ctypes.c_uint8), len(arr), _ptr(out, ctypes.c_uint8),
        out_cap, _ptr(consumed, ctypes.c_int64))
    if produced < 0:
        return None
    return out[:produced], int(consumed[0])


class _Handle:
    """An engine handle that keeps per-call scratch: every call holds the
    object's lock.  ``close`` (or leaving a ``with`` block) frees it, and
    a closed handle raises.  ``valid`` is False once closed, or when the
    engine refused to create it."""

    _free = ""  # the engine's free function

    def __init__(self):
        self._lib = get_lib()
        self._mtx = threading.Lock()
        self._h = None

    @property
    def valid(self) -> bool:
        return bool(self._h)

    def _handle(self):
        if not self._h:
            raise ValueError(f"{type(self).__name__} is closed")
        return self._h

    def close(self) -> None:
        with self._mtx:
            if self._h:
                getattr(self._lib, self._free)(self._h)
                self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass


class NativeDDict(_Handle):
    """The engine's decompression dictionary (DDictC, the ZSTD_DDict role):
    the content as history and the entropy tables loaded once.  Counterpart
    of the reference's NativeDDict; `content_len` and `dict_id` are the
    parsed dictionary's (the engine keeps the content after the tables).
    Raises RuntimeError when the engine refuses the dictionary."""

    _free = "zt_ddict_free"

    def __init__(self, dict_raw: bytes, content_len: int, dict_id: int = 0):
        super().__init__()
        self.content_len = content_len
        self.dict_id = dict_id
        raw = _u8(bytes(dict_raw))
        self._h = self._lib.zt_ddict_create(_ptr(raw, ctypes.c_uint8),
                                            len(raw))
        if not self._h:
            raise RuntimeError("zt_ddict_create refused the dictionary")

    def decode_frame_body(self, src, content_cap: int):
        """One frame body (after the header, before the checksum) against
        the dictionary.  Returns (content uint8 array, bytes consumed), or
        None if corrupt."""
        arr = _u8(src)
        cap = self.content_len + content_cap + 64
        out = np.empty(cap, dtype=np.uint8)
        consumed = np.zeros(1, dtype=np.int64)
        with self._mtx:
            size = self._lib.zt_decode_frame_body_ddict(
                _ptr(arr, ctypes.c_uint8), len(arr), self._handle(),
                _ptr(out, ctypes.c_uint8), cap,
                _ptr(consumed, ctypes.c_int64))
        if size < 0:
            return None
        return (out[self.content_len:self.content_len + size],
                int(consumed[0]))

    def decompress_many(self, frames: list[bytes],
                        expect_dict_id: int | None = None,
                        fallback=None) -> list[bytes] | None:
        """Every frame's content from native calls (the host bar for a
        dictionary batch; checksums are verified natively).  A frame
        outside a call's reach -- no content size, another dictionary's
        ID than `expect_dict_id` (default: this dictionary's), a corrupt
        body or a bad checksum -- goes to `fallback(frame)`, the caller's
        one-frame decoder that raises the proper error, and the batch
        resumes natively after it; without a fallback the call returns
        None."""
        if expect_dict_id is None:
            expect_dict_id = self.dict_id
        results: list[bytes] = [b""] * len(frames)
        start = 0
        while start < len(frames):
            sub = frames[start:]
            concat = np.frombuffer(b"".join(sub), dtype=np.uint8)
            flens = np.array([len(f) for f in sub], dtype=np.int64)
            cap = int(len(concat) * 64 + (1 << 20))
            out = np.empty(cap, dtype=np.uint8)
            out_lens = np.zeros(len(sub), dtype=np.int64)
            with self._mtx:
                total = self._lib.zt_decompress_many_ddict(
                    self._handle(), _ptr(concat, ctypes.c_uint8),
                    _ptr(flens, ctypes.c_int64), len(sub), expect_dict_id,
                    _ptr(out, ctypes.c_uint8), cap,
                    _ptr(out_lens, ctypes.c_int64))
            failed = len(sub) if total >= 0 else -int(total) - 2
            if total < 0 and (failed < 0 or failed >= len(sub)
                              or fallback is None):
                return None
            ends = np.cumsum(out_lens[:failed]).tolist()
            for j, (e, n) in enumerate(zip(ends, out_lens.tolist())):
                results[start + j] = out[e - n:e].tobytes()
            if total >= 0:
                return results
            # the one frame the native call cannot serve; its error
            # (dictionary_wrong, checksum_wrong, ...) propagates
            results[start + failed] = fallback(sub[failed])
            start += failed + 1
        return results


class NativeCDict(_Handle):
    """The engine's compression dictionary (CDictC, the ZSTD_CDict role):
    the content as history, matcher tables prefilled at these parameters
    and the dictionary's entropy as the starting tables.  ``valid`` is
    False when the engine refused to create it (the callers then take the
    Python block tier)."""

    _free = "zt_cdict_free"

    def __init__(self, dict_raw: bytes, strategy: int, hash_log: int,
                 chain_log: int, search_log: int, window_log: int,
                 min_match: int):
        super().__init__()
        raw = _u8(bytes(dict_raw))
        self._h = self._lib.zt_cdict_create(
            _ptr(raw, ctypes.c_uint8), len(raw), strategy, hash_log,
            chain_log, search_log, window_log, min_match)

    def entropy_stats(self, records: list[bytes]):
        """Histograms of the records' attach-parse against the dictionary
        (the ZDICT_countEStats role): (lit, ll, ml, of, rep_off) int64
        arrays, or None."""
        concat = np.frombuffer(b"".join(records), dtype=np.uint8)
        lens = np.array([len(r) for r in records], dtype=np.int64)
        hists = [np.zeros(n, np.int64) for n in (256, 36, 53, 29, 1024)]
        with self._mtx:
            rc = self._lib.zt_cdict_stats(
                self._handle(), _ptr(concat, ctypes.c_uint8),
                _ptr(lens, ctypes.c_int64), len(records),
                *(_ptr(h, ctypes.c_int64) for h in hists))
        return tuple(hists) if rc == 0 else None

    def compress_many(self, records: list[bytes],
                      dict_id: int) -> list[bytes] | None:
        """Every record's whole frame from one native call, or None."""
        concat = np.frombuffer(b"".join(records), dtype=np.uint8)
        lens = np.array([len(r) for r in records], dtype=np.int64)
        cap = int(len(concat) + 64 * len(records) + 4096)
        out = np.empty(cap, dtype=np.uint8)
        out_lens = np.zeros(len(records), dtype=np.int64)
        with self._mtx:
            total = self._lib.zt_compress_many_cdict(
                self._handle(), _ptr(concat, ctypes.c_uint8),
                _ptr(lens, ctypes.c_int64), len(records), dict_id,
                _ptr(out, ctypes.c_uint8), cap,
                _ptr(out_lens, ctypes.c_int64))
        if total < 0:
            return None
        raw = out[:int(total)].tobytes()
        ends = np.cumsum(out_lens).tolist()
        return [raw[e - n:e] for e, n in zip(ends, out_lens.tolist())]

    def compress_frame_body(self, src: np.ndarray) -> bytes | None:
        """One frame body (no header or checksum) against the dictionary,
        or None."""
        if len(src) == 0:
            return None
        n = len(src)
        cap = n + (n >> 6) + 4096
        out = np.empty(cap, dtype=np.uint8)
        with self._mtx:
            size = self._lib.zt_compress_frame_body_cdict(
                self._handle(), _ptr(_u8(src), ctypes.c_uint8), n,
                _ptr(out, ctypes.c_uint8), cap)
        return None if size < 0 else out[:size].tobytes()


class NativeDStream(_Handle):
    """The engine's per-frame block decoder state (entropy tables and
    repcodes) for the streaming decoder: one call per compressed block, or
    one call per run of complete blocks, writing into the caller's window
    buffer."""

    _free = "zt_dstream_free"

    def __init__(self):
        super().__init__()
        self._h = self._lib.zt_dstream_new()
        if not self._h:
            raise RuntimeError("zt_dstream_new failed")

    def block(self, body: bytes, out: np.ndarray, out_pos: int,
              prefix_start: int = 0) -> int:
        """Decode one compressed block body into out[out_pos:]; the new
        write position, negative on corruption."""
        arr = _u8(body)
        with self._mtx:
            return int(self._lib.zt_dstream_block(
                self._handle(), _ptr(arr, ctypes.c_uint8), len(arr),
                _ptr(out, ctypes.c_uint8), out_pos, len(out), prefix_start))

    def drain(self, src, out: np.ndarray, out_pos: int,
              prefix_start: int = 0) -> tuple[int, int, bool]:
        """Decode every complete block in `src` (any buffer-protocol
        object); returns (new write position, input consumed, whether the
        last block was seen)."""
        arr = np.frombuffer(src, dtype=np.uint8)
        consumed = ctypes.c_int64(0)
        saw_last = ctypes.c_int(0)
        with self._mtx:
            r = self._lib.zt_dstream_drain(
                self._handle(), _ptr(arr, ctypes.c_uint8), len(arr),
                _ptr(out, ctypes.c_uint8), out_pos, len(out), prefix_start,
                ctypes.byref(consumed), ctypes.byref(saw_last))
        return int(r), int(consumed.value), bool(saw_last.value)


def xxh64(data, seed: int = 0) -> int:
    arr = _u8(data)
    return int(get_lib().xxh64(_ptr(arr, ctypes.c_uint8), len(arr), seed))
