"""Frame-level decoding on the host and the port's decode entry points:
the port's copy of zstdsharp_tpu/decode/frame.py (reference:
Unsafe/ZstdDecompress.cs).

Covers: frame-header parse (ZSTD_getFrameHeader_advanced:462), the frame
block loop (ZSTD_decompressFrame:1062), multi-frame + skippable handling
(ZSTD_decompressMultiFrame:1216), bound computation (ZSTD_decompressBound:971)
and checksum verification (:1186-1208).

A frame without a dictionary decodes in the native engine, as in the
reference: through the ``_ztpy`` CPython extension (``native.get_ext``),
which writes the content straight into a ``bytes`` object, or, where the
extension cannot be built, through ctypes into a numpy array (the same
bytes; ``decompress`` returns ``bytes`` either way and copies only the
arrays).  A dictionary frame the engine's ``NativeDDict`` does not take
runs the Python block loop of ``FrameDecoder``.  ``decode_frame``
decodes one frame with an optional ``NativeDDict`` for the device
planner's host route.  The port has no pure-Python frame decoder for the
no-dictionary case: without the engine it raises.

``Decompressor.unwrap_many_device`` runs the device plane
(``decode.device_pipeline.decode_batch_device``), on the card unless the
caller names another device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .. import constants as C
from .. import native
from ..errors import ZstdError, ZstdErrorCode, check
from ..utils import trace
from ..utils.xxhash import content_checksum
from ..constants import BlockType
from .block import EntropyState, decode_block

_WINDOWLOG_MAX_DEFAULT = C.ZSTD_WINDOWLOG_LIMIT_DEFAULT


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
    # the descriptor bytes as Python ints: a numpy uint8 would keep the
    # window's shift in 8 bits, so 1 << (10 + exponent) would read 0
    fhd = int(src[4])
    dict_id_code = fhd & 3
    checksum_flag = (fhd >> 2) & 1
    check((fhd >> 3) & 1 == 0, ZstdErrorCode.frameParameter_unsupported, "reserved bit set")
    single_segment = (fhd >> 5) & 1
    fcs_code = fhd >> 6

    pos = 5
    if not single_segment:
        check(len(src) > pos, ZstdErrorCode.srcSize_wrong)
        wd = int(src[pos])
        exponent = wd >> 3
        mantissa = wd & 7
        window_log = 10 + exponent
        check(window_log <= C.ZSTD_WINDOWLOG_MAX, ZstdErrorCode.frameParameter_windowTooLarge)
        window_base = 1 << window_log
        window_size = window_base + (window_base >> 3) * mantissa
        pos += 1
    else:
        window_size = 0  # will be content size

    did_size = C.ZSTD_DID_FIELD_SIZE[dict_id_code]
    check(len(src) >= pos + did_size, ZstdErrorCode.srcSize_wrong)
    dict_id = int.from_bytes(src[pos : pos + did_size], "little") if did_size else 0
    pos += did_size

    fcs_size = C.ZSTD_FCS_FIELD_SIZE[fcs_code]
    if fcs_code == 0 and single_segment:
        fcs_size = 1
    check(len(src) >= pos + fcs_size, ZstdErrorCode.srcSize_wrong)
    if fcs_size == 0:
        fcs = -1
    else:
        fcs = int.from_bytes(src[pos : pos + fcs_size], "little")
        if fcs_size == 2:
            fcs += 256
    pos += fcs_size
    if single_segment:
        window_size = fcs
    return FrameHeader(pos, fcs, window_size, dict_id, bool(checksum_flag), bool(single_segment))


@dataclass
class FrameInfo:
    compressed_size: int
    decompressed_size: int  # -1 if unknown
    dict_id: int
    has_checksum: bool
    is_skippable: bool = False


def _scan_frame(src: bytes) -> FrameInfo:
    """Walk one frame's blocks to find its compressed size
    (ZSTD_findFrameSizeInfo:877)."""
    magic = int.from_bytes(src[0:4], "little")
    if (magic & C.ZSTD_MAGIC_SKIPPABLE_MASK) == C.ZSTD_MAGIC_SKIPPABLE_START:
        check(len(src) >= 8, ZstdErrorCode.srcSize_wrong)
        size = int.from_bytes(src[4:8], "little")
        check(len(src) >= 8 + size, ZstdErrorCode.srcSize_wrong)
        return FrameInfo(8 + size, 0, 0, False, is_skippable=True)
    hdr = parse_frame_header(src)
    pos = hdr.header_size
    while True:
        check(len(src) >= pos + C.ZSTD_BLOCKHEADERSIZE, ZstdErrorCode.srcSize_wrong)
        bh = int.from_bytes(src[pos : pos + 3], "little")
        last = bh & 1
        btype = BlockType((bh >> 1) & 3)
        bsize = bh >> 3
        pos += 3
        if btype == BlockType.RLE:
            pos += 1
        elif btype == BlockType.RAW or btype == BlockType.COMPRESSED:
            pos += bsize
        else:
            raise ZstdError(ZstdErrorCode.corruption_detected, "reserved block type")
        if last:
            break
    if hdr.has_checksum:
        pos += 4
    check(len(src) >= pos, ZstdErrorCode.srcSize_wrong)
    return FrameInfo(pos, hdr.frame_content_size, hdr.dict_id, hdr.has_checksum)


def frame_info(src: bytes) -> FrameInfo:
    """Public: info for the first frame in src."""
    return _scan_frame(bytes(src))


def find_frame_compressed_size(src: bytes) -> int:
    """ZSTD_findFrameCompressedSize:958 — bytes of the first frame
    (incl. header/blocks/checksum, or the whole skippable frame)."""
    buf = bytes(src)
    check(len(buf) >= 4, ZstdErrorCode.srcSize_wrong, "input too small")
    magic = int.from_bytes(buf[:4], "little")
    if (magic & C.ZSTD_MAGIC_SKIPPABLE_MASK) == C.ZSTD_MAGIC_SKIPPABLE_START:
        check(len(buf) >= 8, ZstdErrorCode.srcSize_wrong)
        return 8 + int.from_bytes(buf[4:8], "little")
    hdr = parse_frame_header(np.frombuffer(buf, np.uint8))
    pos = hdr.header_size
    while True:
        check(len(buf) >= pos + 3, ZstdErrorCode.srcSize_wrong)
        bh = int.from_bytes(buf[pos : pos + 3], "little")
        btype = (bh >> 1) & 3
        check(btype != 3, ZstdErrorCode.corruption_detected, "reserved block")
        pos += 3 + (1 if btype == 1 else bh >> 3)
        if bh & 1:
            break
    if hdr.has_checksum:
        pos += 4
    check(pos <= len(buf), ZstdErrorCode.srcSize_wrong)
    return pos


def decompress_bound(src: bytes) -> int:
    """Upper bound on decompressed size of all frames (ZSTD_decompressBound:971)."""
    src = bytes(src)
    pos = 0
    bound = 0
    while pos < len(src):
        info = _scan_frame(src[pos:])
        if info.is_skippable:
            pos += info.compressed_size
            continue
        if info.decompressed_size >= 0:
            bound += info.decompressed_size
        else:
            # Unknown size: bound by block count * blockSizeMax.
            hdr = parse_frame_header(src[pos:])
            n_blocks = 0
            p = pos + hdr.header_size
            while True:
                bh = int.from_bytes(src[p : p + 3], "little")
                btype = BlockType((bh >> 1) & 3)
                bsize = bh >> 3
                p += 3 + (1 if btype == BlockType.RLE else bsize)
                n_blocks += 1
                if bh & 1:
                    break
            bound += n_blocks * min(C.ZSTD_BLOCKSIZE_MAX,
                                    hdr.window_size or C.ZSTD_BLOCKSIZE_MAX)
        pos += info.compressed_size
    return bound


class FrameDecoder:
    """Decodes a single frame given its bytes (header already validated)."""

    def __init__(self, max_window_log: int = _WINDOWLOG_MAX_DEFAULT,
                 dict_content: np.ndarray | None = None,
                 dict_entropy: EntropyState | None = None,
                 dict_id: int = 0):
        self.max_window_log = max_window_log
        self.dict_content = dict_content
        self.dict_entropy = dict_entropy
        self.dict_id = dict_id

    def decode(self, src: bytes, verify_checksum: bool = True) -> tuple[np.ndarray, int]:
        """Returns (decoded bytes, total frame size consumed)."""
        hdr = parse_frame_header(src)
        if hdr.window_size and not hdr.single_segment:
            check(hdr.window_size <= (1 << self.max_window_log),
                  ZstdErrorCode.frameParameter_windowTooLarge,
                  f"window {hdr.window_size} > limit")
        if hdr.dict_id and self.dict_id and hdr.dict_id != self.dict_id:
            raise ZstdError(ZstdErrorCode.dictionary_wrong,
                            f"frame wants dict {hdr.dict_id}, have {self.dict_id}")
        if hdr.frame_content_size >= 0:
            # Structural sanity: a frame of B input bytes holds at most
            # ~B/3 blocks of <= 128KB each; a larger claimed FCS means a
            # corrupt header (and guards the output allocation).
            max_possible = (len(src) // 3 + 2) * C.ZSTD_BLOCKSIZE_MAX
            check(hdr.frame_content_size <= max_possible,
                  ZstdErrorCode.corruption_detected,
                  "content size impossible for frame size")

        if self.dict_entropy is None and self.dict_content is None:
            # Whole-frame native fast path.
            return _native_frame(src, hdr, None, verify_checksum)

        if self.dict_entropy is not None:
            entropy = EntropyState(
                huf=self.dict_entropy.huf, ll=self.dict_entropy.ll,
                ml=self.dict_entropy.ml, of=self.dict_entropy.of,
                rep=list(self.dict_entropy.rep))
        else:
            entropy = EntropyState()

        # Output buffer: exact if FCS known, else grow-on-demand.
        known = hdr.frame_content_size >= 0
        cap = hdr.frame_content_size if known else max(1 << 17, 2 * len(src))
        prefix = 0
        if self.dict_content is not None and len(self.dict_content):
            prefix = len(self.dict_content)
        out = np.empty(prefix + cap, dtype=np.uint8)
        if prefix:
            out[:prefix] = self.dict_content
        out_pos = prefix

        pos = hdr.header_size
        while True:
            check(len(src) >= pos + 3, ZstdErrorCode.srcSize_wrong)
            bh = int.from_bytes(src[pos : pos + 3], "little")
            last = bh & 1
            btype = BlockType((bh >> 1) & 3)
            bsize = bh >> 3
            pos += 3
            block_limit = min(C.ZSTD_BLOCKSIZE_MAX,
                              hdr.window_size if hdr.window_size > 0 else C.ZSTD_BLOCKSIZE_MAX)

            if not known and out_pos + C.ZSTD_BLOCKSIZE_MAX > len(out):
                out = np.concatenate([out, np.empty(max(len(out), C.ZSTD_BLOCKSIZE_MAX), np.uint8)])

            if btype == BlockType.RAW:
                check(len(src) >= pos + bsize, ZstdErrorCode.srcSize_wrong)
                check(out_pos + bsize <= len(out), ZstdErrorCode.dstSize_tooSmall)
                out[out_pos : out_pos + bsize] = np.frombuffer(src[pos : pos + bsize], np.uint8)
                out_pos += bsize
                pos += bsize
            elif btype == BlockType.RLE:
                check(len(src) >= pos + 1, ZstdErrorCode.srcSize_wrong)
                check(out_pos + bsize <= len(out), ZstdErrorCode.dstSize_tooSmall)
                out[out_pos : out_pos + bsize] = src[pos]
                out_pos += bsize
                pos += 1
            elif btype == BlockType.COMPRESSED:
                check(bsize <= block_limit, ZstdErrorCode.corruption_detected,
                      "block size exceeds maximum")
                check(len(src) >= pos + bsize, ZstdErrorCode.srcSize_wrong)
                out_pos = decode_block(src[pos : pos + bsize], entropy, out, out_pos,
                                       prefix_start=0)
                pos += bsize
            else:
                raise ZstdError(ZstdErrorCode.corruption_detected, "reserved block type")
            if last:
                break

        content = out[prefix:out_pos]
        if known:
            check(out_pos - prefix == hdr.frame_content_size,
                  ZstdErrorCode.corruption_detected, "content size mismatch")
        if hdr.has_checksum:
            check(len(src) >= pos + 4, ZstdErrorCode.srcSize_wrong)
            stored = int.from_bytes(src[pos : pos + 4], "little")
            pos += 4
            if verify_checksum:
                check(content_checksum(content) == stored,
                      ZstdErrorCode.checksum_wrong, "content checksum mismatch")
        return content, pos


def _native_frame(src, hdr: FrameHeader, ddict,
                  verify_checksum: bool) -> tuple[np.ndarray, int]:
    """The frame body of `src` (header `hdr`, already checked) through the
    native engine, with `ddict` (a ``native.NativeDDict``) when given;
    then the content size and checksum checks.  Returns (content, bytes
    of the frame consumed): content is ``bytes`` from the extension
    (no dictionary), else a uint8 array."""
    if hdr.frame_content_size >= 0:
        cap = hdr.frame_content_size
    else:
        # Exact bound: blocks x blockSizeMax (block walk is cheap).
        n_blocks = 0
        p = hdr.header_size
        while p + 3 <= len(src):
            bh = int.from_bytes(src[p:p + 3], "little")
            p += 3 + (1 if (bh >> 1) & 3 == BlockType.RLE else bh >> 3)
            n_blocks += 1
            if bh & 1:
                break
        cap = n_blocks * min(C.ZSTD_BLOCKSIZE_MAX,
                             hdr.window_size or C.ZSTD_BLOCKSIZE_MAX)
    ext = native.get_ext() if ddict is None else None
    if ext is not None:
        res = ext.decode_frame_body(src, hdr.header_size, cap)
    else:
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
        if verify_checksum:
            check(content_checksum(content) == stored,
                  ZstdErrorCode.checksum_wrong, "content checksum mismatch")
    return content, pos


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
    return _native_frame(src, hdr, ddict, True)


def decompress(src: bytes, max_output_size: int | None = None,
               max_window_log: int = _WINDOWLOG_MAX_DEFAULT,
               verify_checksum: bool = True, n_workers: int = 0) -> bytes:
    """Decompress all frames in src (ZSTD_decompressMultiFrame:1216).

    n_workers > 0 decodes independent frames in a thread pool (the native
    decoder releases the GIL, so multi-frame streams — e.g. from
    compress(n_workers=) — scale across host cores; frames are
    self-delimiting per RFC 8878 §3).
    """
    if n_workers > 0:
        return _decompress_parallel(bytes(src), max_output_size,
                                    max_window_log, verify_checksum,
                                    n_workers)
    if trace.enabled():
        with trace.span("decompress", src_size=len(src)) as sp:
            out = _decompress_impl(bytes(src), max_output_size, max_window_log,
                                   verify_checksum)
            sp.dst_size = len(out)
            return out
    return _decompress_impl(bytes(src), max_output_size, max_window_log,
                            verify_checksum)


def _decompress_parallel(src: bytes, max_output_size, max_window_log,
                         verify_checksum, n_workers: int) -> bytes:
    """Frame-parallel decode: split on frame boundaries
    (ZSTD_findFrameCompressedSize walk), decode concurrently, join in
    order."""
    from concurrent.futures import ThreadPoolExecutor

    spans = []
    pos = 0
    while pos < len(src):
        n = find_frame_compressed_size(src[pos:])
        spans.append((pos, n))
        pos += n

    def one(span):
        off, n = span
        magic = int.from_bytes(src[off : off + 4], "little")
        if (magic & C.ZSTD_MAGIC_SKIPPABLE_MASK) == C.ZSTD_MAGIC_SKIPPABLE_START:
            return b""
        return _decompress_impl(src[off : off + n], None, max_window_log,
                                verify_checksum)

    with ThreadPoolExecutor(max_workers=n_workers) as ex:
        outs = list(ex.map(one, spans))
    result = b"".join(outs)
    if max_output_size is not None:
        check(len(result) <= max_output_size, ZstdErrorCode.dstSize_tooSmall,
              "output exceeds max_output_size")
    return result


def _decompress_impl(src: bytes, max_output_size, max_window_log,
                     verify_checksum) -> bytes:
    check(len(src) >= 4, ZstdErrorCode.srcSize_wrong, "input too small")
    decoder = FrameDecoder(max_window_log=max_window_log)
    pos = 0
    outputs = []
    total = 0
    mv = memoryview(src)  # per-frame tails without copying the buffer
    while pos < len(src):
        check(len(src) - pos >= 4, ZstdErrorCode.srcSize_wrong)
        magic = int.from_bytes(src[pos : pos + 4], "little")
        if (magic & C.ZSTD_MAGIC_SKIPPABLE_MASK) == C.ZSTD_MAGIC_SKIPPABLE_START:
            check(len(src) - pos >= 8, ZstdErrorCode.srcSize_wrong)
            size = int.from_bytes(src[pos + 4 : pos + 8], "little")
            check(len(src) - pos >= 8 + size, ZstdErrorCode.srcSize_wrong)
            pos += 8 + size
            continue
        content, consumed = decoder.decode(mv[pos:], verify_checksum=verify_checksum)
        total += len(content)
        if max_output_size is not None:
            check(total <= max_output_size, ZstdErrorCode.dstSize_tooSmall,
                  "output exceeds max_output_size")
        outputs.append(content)
        pos += consumed
    return b"".join(
        o if isinstance(o, bytes) else o.tobytes() for o in outputs)


class Decompressor:
    """Mirror of the reference's safe Decompressor (Decompressor.cs:6)."""

    DEFAULT_MAX_OUTPUT = 1 << 31  # guard against zip bombs on unknown FCS

    def __init__(self, max_window_log: int = _WINDOWLOG_MAX_DEFAULT):
        self.max_window_log = max_window_log
        self._dict = None

    def load_dictionary(self, dict_data: bytes | None) -> None:
        from ..dictionary import ZstdCompressionDict

        self._dict = ZstdCompressionDict(dict_data) if dict_data is not None else None

    def load_dictionaries(self, dicts: list[bytes]) -> None:
        """Multiple-dictionary support: select by frame dictID at decode time
        (ZSTD_DDictHashSet role, ZstdDecompress.cs:11-192)."""
        from ..dictionary import ZstdCompressionDict

        self._dict_set = {}
        for d in dicts:
            zd = ZstdCompressionDict(d)
            check(zd.dict_id != 0, ZstdErrorCode.dictionary_wrong,
                  "dictionary without ID in multi-dict set")
            self._dict_set[zd.dict_id] = zd

    def set_parameter(self, name: str, value) -> None:
        """ZSTD_dParam_getBounds:2390 — validate at set time."""
        check(name in ("max_window_log",), ZstdErrorCode.parameter_unsupported, name)
        check(isinstance(value, int) and not isinstance(value, bool)
              and C.ZSTD_WINDOWLOG_MIN <= value <= C.ZSTD_WINDOWLOG_MAX,
              ZstdErrorCode.parameter_outOfBound,
              f"{name}={value} outside [{C.ZSTD_WINDOWLOG_MIN}, "
              f"{C.ZSTD_WINDOWLOG_MAX}]")
        setattr(self, name, value)

    def get_upper_bound(self, src: bytes) -> int:
        return decompress_bound(src)

    def unwrap(self, src: bytes, max_decompressed_size: int | None = None) -> bytes:
        dict_set = getattr(self, "_dict_set", None)
        if dict_set:
            hdr = parse_frame_header(bytes(src))
            d = dict_set.get(hdr.dict_id)
            check(d is not None, ZstdErrorCode.dictionary_wrong,
                  f"no dictionary with id {hdr.dict_id} loaded")
            return d.decompress_with(src, max_output_size=max_decompressed_size,
                                     max_window_log=self.max_window_log)
        if self._dict is not None:
            return self._dict.decompress_with(src, max_output_size=max_decompressed_size,
                                              max_window_log=self.max_window_log)
        return decompress(src, max_output_size=max_decompressed_size,
                          max_window_log=self.max_window_log)

    def unwrap_many(self, frames: list[bytes],
                    max_decompressed_size: int | None = None) -> list[bytes]:
        """Batch unwrap: one native call per batch (an empty-content
        context serves the no-dictionary case)."""
        if self._dict is not None:
            return self._dict.decompress_many(
                frames, max_output_size=max_decompressed_size)
        if frames:
            dd = getattr(self, "_empty_ddict", None)
            if dd is None:
                dd = self._empty_ddict = native.NativeDDict(b"", 0)
            if dd.valid:
                out = dd.decompress_many(
                    [bytes(f) for f in frames],
                    fallback=lambda f: self.unwrap(f, max_decompressed_size))
                if out is not None:
                    if max_decompressed_size is not None:
                        for o in out:
                            check(len(o) <= max_decompressed_size,
                                  ZstdErrorCode.dstSize_tooSmall)
                    return out
        return [self.unwrap(f, max_decompressed_size) for f in frames]

    def unwrap_many_device(self, frames: list[bytes], device="cuda"):
        """Batch unwrap on `device` (the card unless the caller names
        another; without a card the default raises): entropy kernels and
        LZ execution run there and the decoded rows stay in device memory.

        Returns (outputs, lengths, host_results): outputs is a list of
        uint8 [B, O] tensors on `device` whose rows follow the
        device-planned single-block frames in frame order, lengths the
        per-row content sizes, host_results a dict frame_idx -> bytes for
        host-routed frames (uint8 device tensors for multi-block frames).
        With a loaded dictionary every frame decodes against it: its
        content tail as the shared window, its tables and repcodes as the
        starting entropy (``decode_batch_device``'s ``ddict``)."""
        from .device_pipeline import decode_batch_device

        dd = self._dict._parsed if self._dict is not None else None
        return decode_batch_device(frames, device=device, ddict=dd)

    def try_unwrap(self, src: bytes, max_decompressed_size: int) -> tuple[bool, bytes]:
        """TryUnwrap:96 — returns (ok, data) instead of raising on size."""
        try:
            return True, self.unwrap(src, max_decompressed_size)
        except ZstdError as e:
            if e.code == ZstdErrorCode.dstSize_tooSmall:
                return False, b""
            raise

    decompress = unwrap


def read_skippable_frame(src: bytes) -> tuple[int, bytes]:
    """ZSTD_readSkippableFrame:714 — returns (magic_variant, content)."""
    src = bytes(src)
    check(len(src) >= 8, ZstdErrorCode.srcSize_wrong)
    magic = int.from_bytes(src[0:4], "little")
    check((magic & C.ZSTD_MAGIC_SKIPPABLE_MASK) == C.ZSTD_MAGIC_SKIPPABLE_START,
          ZstdErrorCode.prefix_unknown, "not a skippable frame")
    size = int.from_bytes(src[4:8], "little")
    check(len(src) >= 8 + size, ZstdErrorCode.srcSize_wrong)
    return magic - C.ZSTD_MAGIC_SKIPPABLE_START, src[8 : 8 + size]
