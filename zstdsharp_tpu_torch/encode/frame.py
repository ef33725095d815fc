"""One-shot frame compression on the host (counterpart of
zstdsharp_tpu/encode/frame.py; reference: ZSTD_writeFrameHeader
(ZstdCompress.cs:4817), the epilogue ZSTD_writeEpilogue (:5598)).

``compress(data, level, checksum)`` takes the reference's routes through
the native engine, in its order:

1. ``exact``: the exact encoder (``native.compress_exact``), for levels
   >= 1 and -1; it declines the lazy levels and some level / size pairs;
2. ``frame_body``: the whole-frame encoder at the level's resolved
   parameters (``native.compress_frame_body``), for inputs of 256 bytes
   and more;
3. ``estream``: the engine's streaming encoder fed the whole input at
   once, for what is left (inputs under 256 bytes, or a body the
   whole-frame encoder declines) -- the reference's FrameEncoder on its
   native context.

The reference drops to its pure-Python encoder only without the engine;
the port raises then (``native.get_lib``).  ``tests/test_torch_host.py``
pins which route each input takes.
"""

from __future__ import annotations

import numpy as np

from .. import constants as C
from .. import native
from ..utils.xxhash import content_checksum
from .params import ResolvedParams, resolve


def _write_frame_header(src_size: int, window_log: int, checksum: bool,
                        content_size_flag: bool, dict_id: int = 0) -> bytes:
    window_size = 1 << window_log
    single_segment = (content_size_flag and src_size >= 0
                      and src_size <= window_size)
    if content_size_flag and src_size >= 0:
        fcs_code = ((src_size >= 256) + (src_size >= 65536 + 256)
                    + (src_size > 0xFFFFFFFF))
    else:
        fcs_code = 0
    did_code = (0 if dict_id == 0 else 1 if dict_id < 256
                else 2 if dict_id < 65536 else 3)
    fhd = ((fcs_code << 6) | (int(single_segment) << 5)
           | (int(checksum) << 2) | did_code)
    out = bytearray(C.ZSTD_MAGICNUMBER.to_bytes(4, "little"))
    out.append(fhd)
    if not single_segment:
        out.append((window_log - C.ZSTD_WINDOWLOG_ABSOLUTEMIN) << 3)
    if did_code:
        out += dict_id.to_bytes(C.ZSTD_DID_FIELD_SIZE[did_code], "little")
    if fcs_code == 0:
        if single_segment:
            out.append(src_size)
    elif fcs_code == 1:
        out += (src_size - 256).to_bytes(2, "little")
    elif fcs_code == 2:
        out += src_size.to_bytes(4, "little")
    else:
        out += src_size.to_bytes(8, "little")
    return bytes(out)


def _block_header(last: bool, btype: C.BlockType, size: int) -> bytes:
    return (int(last) | (int(btype) << 1) | (size << 3)).to_bytes(3, "little")


def _exact_eligible(level: int) -> bool:
    """The exact encoder covers positive levels and -1 (the other negative
    levels differ from libzstd's and stay on the frame routes)."""
    return level >= 1 or level == -1


def _frame(src: np.ndarray, params: ResolvedParams, body: bytes) -> bytes:
    cp = params.cparams
    out = bytearray(_write_frame_header(len(src), cp.window_log,
                                        params.checksum, True))
    out += body
    if params.checksum:
        out += content_checksum(src).to_bytes(4, "little")
    return bytes(out)


def _accel(cp) -> int:
    """The fast strategies' acceleration: targetLength, else 1."""
    return cp.target_length if cp.strategy <= 2 and cp.target_length else 1


def _frame_body(src: np.ndarray, params: ResolvedParams) -> bytes | None:
    cp = params.cparams
    return native.compress_frame_body(
        src, int(cp.strategy), cp.hash_log, cp.chain_log, cp.search_log,
        cp.window_log, accel=_accel(cp), use_ldm=params.ldm,
        min_match=cp.min_match, block_splitter=params.block_splitter)


def _estream_body(src: np.ndarray, params: ResolvedParams) -> bytes:
    cp = params.cparams
    stream = native.NativeEStream(
        int(cp.strategy), cp.hash_log, cp.chain_log, cp.search_log,
        cp.window_log, cp.min_match, accel=_accel(cp), ldm=int(params.ldm))
    try:
        return stream.feed(src, 2)
    finally:
        stream.close()


def compress(data: bytes, level: int = 3, checksum: bool = False) -> bytes:
    """One-shot compression (ZSTD_compress2 at `level`, content size
    written, an optional xxh64 checksum): byte for byte the reference's
    ``zstdsharp_tpu.encode.frame.compress(data, level, checksum)``."""
    data = bytes(data)
    if _exact_eligible(level):
        out = native.compress_exact(data, level, checksum)
        if out is not None:
            return out
    src = np.frombuffer(data, dtype=np.uint8)
    params = resolve(level, len(src), checksum)
    if len(src) >= 256:
        body = _frame_body(src, params)
        if body is not None:
            return _frame(src, params, body)
    return _frame(src, params, _estream_body(src, params))
