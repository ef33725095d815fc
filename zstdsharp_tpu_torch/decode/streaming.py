"""Streaming decompression state machine: the port's copy of
zstdsharp_tpu/decode/streaming.py.

Mirrors the zdss_loadHeader/read/load/flush stage machine
(ZSTD_decompressStream:2816, ZSTD_dStreamStage.cs:5): input may arrive at any
granularity, including split frame headers; output is produced per block.
Frames without a dictionary decode through the engine's ``NativeDStream``,
dictionary frames through the Python block decoder with the dictionary's
entropy.  The content checksum is computed once per frame over the
produced bytes (the reference's fallback without the ``xxhash`` module).
"""

from __future__ import annotations

import enum

import numpy as np

from .. import constants as C
from .. import native
from ..errors import ZstdError, ZstdErrorCode, check
from ..utils.xxhash import content_checksum
from .block import EntropyState, decode_block
from .frame import FrameHeader, parse_frame_header


class _Stage(enum.Enum):
    HEADER = 0
    SKIP_FRAME = 1
    BLOCK_HEADER = 2
    BLOCK_BODY = 3
    CHECKSUM = 4
    DONE = 5


class StreamingDecompressor:
    """feed(chunk) -> decompressed bytes; handles multi-frame streams.

    `finished` is True when positioned at a clean frame boundary (the
    premature-EOF signal used by DecompressionStream, mirroring
    DecompressionStream.cs:99).
    """

    def __init__(self, max_window_log: int = C.ZSTD_WINDOWLOG_LIMIT_DEFAULT,
                 dict_content: np.ndarray | None = None,
                 dict_entropy: EntropyState | None = None,
                 dict_id: int = 0, verify_checksum: bool = True,
                 single_frame: bool = False):
        self._in = bytearray()
        self._ino = 0  # consumed-prefix cursor into _in
        self._stage = _Stage.HEADER
        self.max_window_log = max_window_log
        self.verify_checksum = verify_checksum
        self.single_frame = single_frame
        self._dict_content = dict_content
        self._dict_entropy = dict_entropy
        self._dict_id = dict_id
        self._reset_frame_state()
        self._no_progress_count = 0

    def _reset_frame_state(self):
        self._hdr: FrameHeader | None = None
        self._entropy: EntropyState | None = None
        self._out = None  # frame-wide history buffer (window)
        self._out_pos = 0
        self._flushed = 0
        self._skip_left = 0
        self._block_size = 0
        self._block_last = False
        self._block_type = None
        self._content_produced = 0
        # checksum state: the frame's produced chunks, hashed at the end
        self._xxh_chunks = [] if self.verify_checksum else None

    @property
    def finished(self) -> bool:
        return (self._stage in (_Stage.HEADER, _Stage.DONE)
                and self._ino >= len(self._in))

    @property
    def at_frame_boundary(self) -> bool:
        return self._stage in (_Stage.HEADER, _Stage.DONE)

    @property
    def pending_input(self) -> int:
        """Bytes fed but not yet consumed by the stage machine."""
        return len(self._in) - self._ino

    def feed(self, chunk: bytes) -> bytes:
        # consumed prefix is tracked by cursor (deleting it per block is
        # quadratic); compact once it grows past a megabyte
        if self._ino > (1 << 20):
            del self._in[: self._ino]
            self._ino = 0
        self._in += chunk
        out: list[bytes] = []
        while True:
            produced = self._step(out)
            if not produced:
                break
        # Livelock guard (noForwardProgress, ZSTD_DCtx_s.cs:116 role): a
        # caller feeding without the stream advancing is aborted after 16
        # fruitless calls instead of spinning forever.
        if not out and not chunk and not self.finished:
            self._no_progress = getattr(self, "_no_progress", 0) + 1
            check(self._no_progress < 16,
                  ZstdErrorCode.noForwardProgress_inputEmpty,
                  "16 calls without input or output progress")
        else:
            self._no_progress = 0
        return b"".join(out)

    def feed_chunks(self, chunk: bytes) -> list:
        """Like feed() but returns the produced spans as a list of
        bytes-like objects (zero-copy views of the window buffer) so the
        caller can assemble output with a single copy."""
        if self._ino > (1 << 20):
            del self._in[: self._ino]
            self._ino = 0
        self._in += chunk
        out: list = []
        while True:
            if not self._step(out):
                break
        if not out and not chunk and not self.finished:
            self._no_progress = getattr(self, "_no_progress", 0) + 1
            check(self._no_progress < 16,
                  ZstdErrorCode.noForwardProgress_inputEmpty,
                  "16 calls without input or output progress")
        else:
            self._no_progress = 0
        return out

    def _ensure_out(self, need: int) -> None:
        if self._out is None:
            prefix = 0
            if self._dict_content is not None:
                prefix = len(self._dict_content)
            fcs = self._hdr.frame_content_size if self._hdr else -1
            if 0 <= fcs <= (1 << 31):
                # known content size: one exact allocation, no growth
                # copies for the whole frame
                cap = max(fcs, need, 1) + prefix
            else:
                cap = max(need, 1 << 18) + prefix
            self._out = np.empty(cap, dtype=np.uint8)
            if prefix:
                self._out[:prefix] = self._dict_content
            self._out_pos = prefix
            self._flushed = prefix
            self._window_base = prefix
        # O(window) discipline for unknown-size streams: once flushed
        # history exceeds the window, slide into a FRESH array (outstanding
        # zero-copy views of flushed spans keep the old buffer alive)
        window = self._hdr.window_size if self._hdr else 0
        if window:
            keep = window + C.ZSTD_BLOCKSIZE_MAX
            if (self._flushed == self._out_pos
                    and self._out_pos + need > len(self._out)
                    and self._out_pos > keep):
                base = self._out_pos - keep
                fresh_arr = np.empty(len(self._out), dtype=np.uint8)
                fresh_arr[:keep] = self._out[base : self._out_pos]
                self._out = fresh_arr
                self._out_pos = keep
                self._flushed = keep
        while self._out_pos + need > len(self._out):
            grown = np.empty(2 * len(self._out), dtype=np.uint8)
            grown[: self._out_pos] = self._out[: self._out_pos]
            self._out = grown

    def _step(self, out: list) -> bool:
        """Advance one stage if input allows; returns True if progress."""
        if self._stage == _Stage.DONE:
            if self.single_frame:
                return False
            self._stage = _Stage.HEADER
            self._reset_frame_state()
            return len(self._in) > self._ino

        if self._stage == _Stage.SKIP_FRAME:
            take = min(self._skip_left, len(self._in) - self._ino)
            self._ino += take
            self._skip_left -= take
            if self._skip_left == 0:
                self._stage = _Stage.HEADER
                return True
            return False

        if self._stage == _Stage.HEADER:
            o = self._ino
            avail = len(self._in) - o
            if avail < C.ZSTD_FRAMEHEADERSIZE_PREFIX:
                return False
            magic = int.from_bytes(self._in[o : o + 4], "little")
            if (magic & C.ZSTD_MAGIC_SKIPPABLE_MASK) == C.ZSTD_MAGIC_SKIPPABLE_START:
                if avail < 8:
                    return False
                self._skip_left = int.from_bytes(self._in[o + 4 : o + 8], "little")
                self._ino = o + 8
                self._stage = _Stage.SKIP_FRAME
                return True
            try:
                hdr = parse_frame_header(
                    bytes(self._in[o : o + C.ZSTD_FRAMEHEADERSIZE_MAX]))
            except ZstdError as e:
                if e.code == ZstdErrorCode.srcSize_wrong and avail < C.ZSTD_FRAMEHEADERSIZE_MAX:
                    return False  # header split across chunks; wait
                raise
            if hdr.window_size and not hdr.single_segment:
                check(hdr.window_size <= (1 << self.max_window_log),
                      ZstdErrorCode.frameParameter_windowTooLarge)
            if hdr.dict_id and self._dict_id and hdr.dict_id != self._dict_id:
                raise ZstdError(ZstdErrorCode.dictionary_wrong)
            self._hdr = hdr
            if self._dict_entropy is not None:
                self._entropy = EntropyState(
                    huf=self._dict_entropy.huf, ll=self._dict_entropy.ll,
                    ml=self._dict_entropy.ml, of=self._dict_entropy.of,
                    rep=list(self._dict_entropy.rep))
                self._nds = None
            else:
                self._entropy = EntropyState()
                # native per-block decode state (fresh per frame); dict
                # frames keep the Python tier (preloaded entropy)
                if getattr(self, "_nds", None) is not None:
                    self._nds.close()
                try:
                    self._nds = native.NativeDStream()
                except RuntimeError:
                    self._nds = None
            self._ino += hdr.header_size
            self._stage = _Stage.BLOCK_HEADER
            return True

        if self._stage == _Stage.BLOCK_HEADER and \
                getattr(self, "_nds", None) is not None:
            # native multi-block drain: consume every complete block in one
            # call; loop grows the window buffer when it was the limiter
            progress = False
            while True:
                if len(self._in) - self._ino < 3:
                    break
                self._ensure_out(C.ZSTD_BLOCKSIZE_MAX)
                r, consumed, saw_last = self._nds.drain(
                    memoryview(self._in)[self._ino :], self._out,
                    self._out_pos)
                check(r >= 0, ZstdErrorCode.corruption_detected,
                      "block decode failed")
                if consumed == 0 and not saw_last:
                    break  # partial tail: wait for more input
                self._ino += consumed
                self._out_pos = r
                progress = True
                # zero-copy span: the array is replaced (never moved) on
                # growth/slide, so views stay valid until consumed
                fresh = self._out[self._flushed : self._out_pos].data
                if self._xxh_chunks is not None:
                    self._xxh_chunks.append(bytes(fresh))
                out.append(fresh)
                self._content_produced += self._out_pos - self._flushed
                self._flushed = self._out_pos
                if saw_last:
                    if self._hdr.frame_content_size >= 0:
                        check(self._content_produced ==
                              self._hdr.frame_content_size,
                              ZstdErrorCode.corruption_detected,
                              "content size mismatch")
                    self._stage = (_Stage.CHECKSUM if self._hdr.has_checksum
                                   else _Stage.DONE)
                    break
            return progress

        if self._stage == _Stage.BLOCK_HEADER:
            if len(self._in) - self._ino < 3:
                return False
            bh = int.from_bytes(self._in[self._ino : self._ino + 3], "little")
            self._block_last = bool(bh & 1)
            self._block_type = C.BlockType((bh >> 1) & 3)
            check(self._block_type != C.BlockType.RESERVED,
                  ZstdErrorCode.corruption_detected, "reserved block type")
            self._block_size = bh >> 3
            self._ino += 3
            self._stage = _Stage.BLOCK_BODY
            return True

        if self._stage == _Stage.BLOCK_BODY:
            need = 1 if self._block_type == C.BlockType.RLE else self._block_size
            if len(self._in) - self._ino < need:
                return False
            body = bytes(self._in[self._ino : self._ino + need])
            self._ino += need
            if self._block_type == C.BlockType.RAW:
                self._ensure_out(self._block_size)
                self._out[self._out_pos : self._out_pos + self._block_size] = \
                    np.frombuffer(body, dtype=np.uint8)
                self._out_pos += self._block_size
            elif self._block_type == C.BlockType.RLE:
                self._ensure_out(self._block_size)
                self._out[self._out_pos : self._out_pos + self._block_size] = body[0]
                self._out_pos += self._block_size
            else:
                self._ensure_out(C.ZSTD_BLOCKSIZE_MAX)
                if getattr(self, "_nds", None) is not None:
                    r = self._nds.block(body, self._out, self._out_pos)
                    check(r >= 0, ZstdErrorCode.corruption_detected,
                          "block decode failed")
                    self._out_pos = r
                else:
                    self._out_pos = decode_block(body, self._entropy,
                                                 self._out, self._out_pos,
                                                 prefix_start=0)
            fresh = self._out[self._flushed : self._out_pos].data
            if self._xxh_chunks is not None:
                self._xxh_chunks.append(bytes(fresh))
            out.append(fresh)
            self._content_produced += self._out_pos - self._flushed
            self._flushed = self._out_pos
            if self._block_last:
                if self._hdr.frame_content_size >= 0:
                    check(self._content_produced == self._hdr.frame_content_size,
                          ZstdErrorCode.corruption_detected, "content size mismatch")
                self._stage = _Stage.CHECKSUM if self._hdr.has_checksum else _Stage.DONE
            else:
                self._stage = _Stage.BLOCK_HEADER
            return True

        if self._stage == _Stage.CHECKSUM:
            if len(self._in) - self._ino < 4:
                return False
            stored = int.from_bytes(self._in[self._ino : self._ino + 4], "little")
            self._ino += 4
            if self._xxh_chunks is not None:
                got = content_checksum(b"".join(self._xxh_chunks))
                check(got == stored, ZstdErrorCode.checksum_wrong)
            self._stage = _Stage.DONE
            return True

        return False
