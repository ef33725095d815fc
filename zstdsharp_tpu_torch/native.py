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
  ``huf_decode_stream``, ``fse_decode_sequences``;
* ``xxh64``.

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
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path

import numpy as np

_REPO = Path(__file__).resolve().parent.parent
SRC = _REPO / "native" / "zstdtpu_core.cpp"
TRACKED_LIB = _REPO / "native" / "libzstdtpu_core.so"
BUILD_DIR = _REPO / "build" / "host"
# The reference's flags: -O2 globally, hot decode loops pin O3 in the source.
CXX_FLAGS = ("-O2", "-march=native", "-shared", "-fPIC", "-std=c++17")


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


_lock = threading.Lock()
_lib = None


def built_lib_path() -> Path:
    """Where this host's build of the source goes."""
    key = hashlib.sha256(SRC.read_bytes())
    key.update(" ".join(CXX_FLAGS).encode())
    key.update(f"{platform.node()} {platform.machine()}".encode())
    return BUILD_DIR / f"libzstdtpu_core.{key.hexdigest()[:16]}.so"


def _build(path: Path) -> None:
    """Compile the source into `path` once, whatever the number of
    processes asking at the same time."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if path.exists():
            return
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        try:
            r = subprocess.run(["g++", *CXX_FLAGS, str(SRC), "-o", str(tmp)],
                               capture_output=True, text=True, timeout=600)
            if r.returncode != 0:
                raise RuntimeError(
                    f"the native host engine ({SRC.name}) failed to build:\n"
                    f"{r.stderr[-4000:]}")
            os.replace(tmp, path)
        except OSError as e:
            raise RuntimeError(
                f"the native host engine ({SRC.name}) cannot be built: {e}"
            ) from e
        finally:
            tmp.unlink(missing_ok=True)


def _open() -> ctypes.CDLL:
    if (TRACKED_LIB.exists()
            and TRACKED_LIB.stat().st_mtime >= SRC.stat().st_mtime):
        try:
            return ctypes.CDLL(str(TRACKED_LIB))
        except OSError:
            pass  # e.g. built for another CPU: build this host's below
    path = built_lib_path()
    if not path.exists():
        _build(path)
    return ctypes.CDLL(str(path))


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

    def feed(self, data: np.ndarray, mode: int) -> bytes:
        """mode: 0 accumulate, 1 flush, 2 end (writes the last block)."""
        arr = _u8(data)
        total = int(self._lib.zt_estream_pending(self._h)) + len(arr)
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


class NativeDDict:
    """The engine's decompression dictionary (DDictC, the ZSTD_DDict role):
    the content as history and the entropy tables loaded once.  Counterpart
    of the reference's NativeDDict; `content_len` and `dict_id` are the
    parsed dictionary's (the engine keeps the content after the tables).

    The handle keeps a per-call entropy scratch, so every call on it holds
    the object's lock.  ``close`` (or leaving a ``with`` block) frees the
    handle; a closed dictionary raises."""

    def __init__(self, dict_raw: bytes, content_len: int, dict_id: int = 0):
        self._lib = get_lib()
        self._mtx = threading.Lock()
        self.content_len = content_len
        self.dict_id = dict_id
        raw = _u8(bytes(dict_raw))
        self._h = self._lib.zt_ddict_create(_ptr(raw, ctypes.c_uint8),
                                            len(raw))
        if not self._h:
            raise RuntimeError("zt_ddict_create refused the dictionary")

    def _handle(self):
        if not self._h:
            raise ValueError("NativeDDict is closed")
        return self._h

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

    def decompress_many(self, frames: list[bytes]) -> list[bytes] | None:
        """Every frame's content from one native call (the host bar for a
        dictionary batch; checksums are verified natively), or None when
        a frame is outside the call's reach: no content size, another
        dictionary's ID, a corrupt body or a bad checksum (``decode_frame``
        names the error)."""
        concat = np.frombuffer(b"".join(frames), dtype=np.uint8)
        flens = np.array([len(f) for f in frames], dtype=np.int64)
        cap = int(len(concat) * 64 + (1 << 20))
        out = np.empty(cap, dtype=np.uint8)
        out_lens = np.zeros(len(frames), dtype=np.int64)
        with self._mtx:
            total = self._lib.zt_decompress_many_ddict(
                self._handle(), _ptr(concat, ctypes.c_uint8),
                _ptr(flens, ctypes.c_int64), len(frames), self.dict_id,
                _ptr(out, ctypes.c_uint8), cap,
                _ptr(out_lens, ctypes.c_int64))
        if total < 0:
            return None
        ends = np.cumsum(out_lens).tolist()
        return [out[e - n:e].tobytes() for e, n in zip(ends, out_lens.tolist())]

    def close(self) -> None:
        with self._mtx:
            if self._h:
                self._lib.zt_ddict_free(self._h)
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


def xxh64(data, seed: int = 0) -> int:
    arr = _u8(data)
    return int(get_lib().xxh64(_ptr(arr, ctypes.c_uint8), len(arr), seed))
