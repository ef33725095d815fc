"""Frame-level decoding on the host and the port's decode entry point
(counterpart of zstdsharp_tpu/decode/frame.py; reference:
Unsafe/ZstdDecompress.cs).

Frame-header parse (ZSTD_getFrameHeader_advanced:462), the frame-size walk
(ZSTD_findFrameCompressedSize:958) and ``decompress``: the multi-frame loop
(ZSTD_decompressMultiFrame:1216, skippable frames skipped) with every
frame body decoded by the native engine, as the reference does when its
engine is present, and the stored checksum verified (:1186-1208).
``decode_frame`` decodes one frame, with a dictionary through the engine's
``NativeDDict`` where the reference runs its Python ``FrameDecoder``.  The
port has no pure-Python frame decoder: without the engine it raises.

``Decompressor.unwrap_many_device`` runs the device plane
(``decode.device_pipeline.decode_batch_device``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .. import constants as C
from .. import native
from ..dictionary import parse_dictionary
from ..errors import ZstdError, ZstdErrorCode, check
from ..utils.xxhash import content_checksum


@dataclass
class FrameHeader:
    header_size: int
    frame_content_size: int  # -1 if unknown
    window_size: int
    dict_id: int
    has_checksum: bool
    single_segment: bool


def parse_frame_header(src: bytes) -> FrameHeader:
    """ZSTD_getFrameHeader_advanced:462 for a zstd (non-skippable) frame."""
    check(len(src) >= C.ZSTD_FRAMEHEADERSIZE_MIN, ZstdErrorCode.srcSize_wrong)
    magic = int.from_bytes(src[0:4], "little")
    check(magic == C.ZSTD_MAGICNUMBER, ZstdErrorCode.prefix_unknown)
    fhd = src[4]
    dict_id_code = fhd & 3
    checksum_flag = (fhd >> 2) & 1
    check((fhd >> 3) & 1 == 0, ZstdErrorCode.frameParameter_unsupported,
          "reserved bit set")
    single_segment = (fhd >> 5) & 1
    fcs_code = fhd >> 6

    pos = 5
    if not single_segment:
        check(len(src) > pos, ZstdErrorCode.srcSize_wrong)
        wd = src[pos]
        window_log = 10 + (wd >> 3)
        check(window_log <= C.ZSTD_WINDOWLOG_MAX,
              ZstdErrorCode.frameParameter_windowTooLarge)
        window_base = 1 << window_log
        window_size = window_base + (window_base >> 3) * (wd & 7)
        pos += 1
    else:
        window_size = 0  # the content size, below

    did_size = C.ZSTD_DID_FIELD_SIZE[dict_id_code]
    check(len(src) >= pos + did_size, ZstdErrorCode.srcSize_wrong)
    dict_id = (int.from_bytes(src[pos:pos + did_size], "little")
               if did_size else 0)
    pos += did_size

    fcs_size = C.ZSTD_FCS_FIELD_SIZE[fcs_code]
    if fcs_code == 0 and single_segment:
        fcs_size = 1
    check(len(src) >= pos + fcs_size, ZstdErrorCode.srcSize_wrong)
    if fcs_size == 0:
        fcs = -1
    else:
        fcs = int.from_bytes(src[pos:pos + fcs_size], "little")
        if fcs_size == 2:
            fcs += 256
    pos += fcs_size
    if single_segment:
        window_size = fcs
    return FrameHeader(pos, fcs, window_size, dict_id, bool(checksum_flag),
                       bool(single_segment))


def _is_skippable(magic: int) -> bool:
    return (magic & C.ZSTD_MAGIC_SKIPPABLE_MASK) == C.ZSTD_MAGIC_SKIPPABLE_START


def find_frame_compressed_size(src: bytes) -> int:
    """ZSTD_findFrameCompressedSize:958 -- bytes of the first frame
    (header, blocks and checksum, or the whole skippable frame)."""
    buf = bytes(src)
    check(len(buf) >= 4, ZstdErrorCode.srcSize_wrong, "input too small")
    if _is_skippable(int.from_bytes(buf[:4], "little")):
        check(len(buf) >= 8, ZstdErrorCode.srcSize_wrong)
        return 8 + int.from_bytes(buf[4:8], "little")
    hdr = parse_frame_header(np.frombuffer(buf, np.uint8))
    pos = hdr.header_size
    while True:
        check(len(buf) >= pos + 3, ZstdErrorCode.srcSize_wrong)
        bh = int.from_bytes(buf[pos:pos + 3], "little")
        btype = (bh >> 1) & 3
        check(btype != 3, ZstdErrorCode.corruption_detected, "reserved block")
        pos += 3 + (1 if btype == 1 else bh >> 3)
        if bh & 1:
            break
    if hdr.has_checksum:
        pos += 4
    check(pos <= len(buf), ZstdErrorCode.srcSize_wrong)
    return pos


def decode_frame(src, ddict=None) -> tuple[np.ndarray, int]:
    """One frame through the native engine: the reference's
    FrameDecoder.decode at the default window limit, its checks in its
    order.  With a dictionary (`ddict`, a ``native.NativeDDict``) a frame
    that names another dictionary's ID raises dictionary_wrong, and the
    body decodes against the dictionary's content and tables.  Returns
    (content, bytes of the frame consumed)."""
    hdr = parse_frame_header(src)
    if hdr.window_size and not hdr.single_segment:
        check(hdr.window_size <= (1 << C.ZSTD_WINDOWLOG_LIMIT_DEFAULT),
              ZstdErrorCode.frameParameter_windowTooLarge,
              f"window {hdr.window_size} > limit")
    d_id = ddict.dict_id if ddict is not None else 0
    if hdr.dict_id and d_id and hdr.dict_id != d_id:
        raise ZstdError(ZstdErrorCode.dictionary_wrong,
                        f"frame wants dict {hdr.dict_id}, have {d_id}")
    if hdr.frame_content_size >= 0:
        # a frame of B bytes holds at most ~B/3 blocks of <= 128 KB each; a
        # larger claimed content size is a corrupt header
        max_possible = (len(src) // 3 + 2) * C.ZSTD_BLOCKSIZE_MAX
        check(hdr.frame_content_size <= max_possible,
              ZstdErrorCode.corruption_detected,
              "content size impossible for frame size")
        cap = hdr.frame_content_size
    else:
        # exact bound: blocks x block size max
        n_blocks = 0
        p = hdr.header_size
        while p + 3 <= len(src):
            bh = int.from_bytes(src[p:p + 3], "little")
            p += 3 + (1 if (bh >> 1) & 3 == C.BlockType.RLE else bh >> 3)
            n_blocks += 1
            if bh & 1:
                break
        cap = n_blocks * min(C.ZSTD_BLOCKSIZE_MAX,
                             hdr.window_size or C.ZSTD_BLOCKSIZE_MAX)
    body = np.frombuffer(src, np.uint8)[hdr.header_size:]
    res = (native.decode_frame_body(body, cap) if ddict is None
           else ddict.decode_frame_body(body, cap))
    if res is None:
        raise ZstdError(ZstdErrorCode.corruption_detected,
                        "frame body corrupt")
    content, consumed = res
    pos = hdr.header_size + consumed
    if hdr.frame_content_size >= 0:
        check(len(content) == hdr.frame_content_size,
              ZstdErrorCode.corruption_detected, "content size mismatch")
    if hdr.has_checksum:
        check(len(src) >= pos + 4, ZstdErrorCode.srcSize_wrong)
        stored = int.from_bytes(src[pos:pos + 4], "little")
        pos += 4
        check(content_checksum(content) == stored,
              ZstdErrorCode.checksum_wrong, "content checksum mismatch")
    return content, pos


def decompress(src: bytes) -> bytes:
    """Decompress every frame in src, skipping skippable frames
    (ZSTD_decompressMultiFrame:1216), each stored checksum verified."""
    src = bytes(src)
    check(len(src) >= 4, ZstdErrorCode.srcSize_wrong, "input too small")
    pos = 0
    outputs = []
    mv = memoryview(src)  # per-frame tails without copying the buffer
    while pos < len(src):
        check(len(src) - pos >= 4, ZstdErrorCode.srcSize_wrong)
        if _is_skippable(int.from_bytes(src[pos:pos + 4], "little")):
            check(len(src) - pos >= 8, ZstdErrorCode.srcSize_wrong)
            size = int.from_bytes(src[pos + 4:pos + 8], "little")
            check(len(src) - pos >= 8 + size, ZstdErrorCode.srcSize_wrong)
            pos += 8 + size
            continue
        content, consumed = decode_frame(mv[pos:])
        outputs.append(content)
        pos += consumed
    return b"".join(o.tobytes() for o in outputs)


class Decompressor:
    """The port's Decompressor: the reference's ``unwrap_many_device`` on a
    torch device, and its ``load_dictionary``, whose dictionary
    ``unwrap_many_device`` decodes against."""

    def __init__(self):
        self._dict = None

    def load_dictionary(self, dict_data: bytes | None) -> None:
        """Parse and keep a dictionary (None drops it).  A dictionary with
        the magic and broken tables raises ZstdError here, as the
        reference's does."""
        self._dict = (parse_dictionary(dict_data) if dict_data is not None
                      else None)

    def unwrap_many_device(self, frames: list[bytes], device):
        """Batch unwrap on `device`: entropy kernels and LZ execution run
        there and the decoded rows stay in device memory.

        Returns (outputs, lengths, host_results): outputs is a list of
        uint8 [B, O] tensors on `device` whose rows follow the
        device-planned single-block frames in frame order, lengths the
        per-row content sizes, host_results a dict frame_idx -> bytes for
        host-routed frames (uint8 device tensors for multi-block frames).
        With a loaded dictionary every frame decodes against it: its
        content tail as the shared window, its tables and repcodes as the
        starting entropy (``decode_batch_device``'s ``ddict``)."""
        from .device_pipeline import decode_batch_device

        return decode_batch_device(frames, device, ddict=self._dict)
