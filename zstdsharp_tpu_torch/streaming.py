"""Stream classes mirroring the reference's L2 surface
(CompressionStream.cs:10, DecompressionStream.cs:10): standard io wrappers
over the incremental frame codecs; the port's copy of
zstdsharp_tpu/streaming.py.
"""

from __future__ import annotations

import io

import numpy as np

from . import constants as C
from .decode.streaming import StreamingDecompressor
from .encode.frame import FrameEncoder
from .encode.params import CCtxParams
from .errors import ZstdError, ZstdErrorCode, check

RECOMMENDED_IN_SIZE = C.ZSTD_BLOCKSIZE_MAX
RECOMMENDED_OUT_SIZE = C.ZSTD_BLOCKSIZE_MAX + 3 + 4


class CompressionStream(io.RawIOBase):
    """Write-only stream: plaintext writes in, one zstd frame out to
    `inner` (CompressionStream.cs semantics: Flush produces output, close
    ends the frame)."""

    def __init__(self, inner, level: int = C.ZSTD_DEFAULT_CLEVEL,
                 params: CCtxParams | None = None, checksum: bool = False,
                 dictionary: bytes | None = None):
        self._inner = inner
        self._params = params or CCtxParams(compression_level=level,
                                            checksum_flag=checksum)
        self._params.content_size_flag = False  # streaming: size unknown
        kwargs = {}
        if dictionary is not None:
            from .dictionary import ZstdCompressionDict

            d = ZstdCompressionDict(dictionary)
            p = d._parsed
            kwargs = dict(dict_content=p.content,
                          dict_entropy=p.enc_entropy,
                          dict_reps=(p.entropy.rep
                                     if p.entropy is not None else None),
                          dict_id=p.dict_id,
                          dict_raw=p.raw or bytes(dictionary))
        dict_size = len(kwargs.get("dict_content", ()))
        self._encoder = FrameEncoder(
            self._params.resolve(src_size_hint=-1, dict_size=dict_size),
            **kwargs)
        # only the ZSTD_isUpdateAuthorized:724 whitelist may change now
        self._params._stream_active = True
        self._closed = False

    def writable(self) -> bool:
        return True

    def write(self, data) -> int:
        check(not self._closed, ZstdErrorCode.stage_wrong, "stream closed")
        data = bytes(data)
        produced = self._encoder.feed(data)
        if produced:
            self._inner.write(produced)
        return len(data)

    def flush(self) -> None:
        """Mid-block flush (ZSTD_e_flush role): everything written so far
        becomes decodable by the receiver."""
        produced = self._encoder.flush()
        if produced:
            self._inner.write(produced)
        if hasattr(self._inner, "flush"):
            self._inner.flush()

    def close(self) -> None:
        if self._closed:
            return
        tail = self._encoder.finish()
        if tail:
            self._inner.write(tail)
        if hasattr(self._inner, "flush"):
            self._inner.flush()
        self._closed = True
        self._params._stream_active = False
        super().close()


class DecompressionStream(io.RawIOBase):
    """Read-only stream: zstd frames from `inner` in, plaintext out
    (DecompressionStream.cs: premature-EOF detection included)."""

    def __init__(self, inner, max_window_log: int = C.ZSTD_WINDOWLOG_LIMIT_DEFAULT,
                 read_chunk: int = RECOMMENDED_IN_SIZE, dictionary: bytes | None = None):
        self._inner = inner
        self._read_chunk = read_chunk
        kwargs = {}
        if dictionary is not None:
            from .dictionary import ZstdCompressionDict

            d = ZstdCompressionDict(dictionary)
            p = d._parsed
            kwargs = dict(dict_content=p.content, dict_entropy=p.entropy,
                          dict_id=p.dict_id)
        self._dec = StreamingDecompressor(max_window_log=max_window_log, **kwargs)
        self._chunks: list = []   # bytes-like spans, assembled on read
        self._pending_n = 0
        self._eof = False

    def readable(self) -> bool:
        return True

    def _fill(self) -> bool:
        """Pull one chunk from inner; returns False on EOF."""
        chunk = self._inner.read(self._read_chunk)
        if not chunk:
            if not self._dec.at_frame_boundary or self._dec.pending_input:
                raise EOFError("premature end of zstd stream")
            self._eof = True
            return False
        for c in self._dec.feed_chunks(chunk):
            self._chunks.append(c)
            self._pending_n += len(c)
        return True

    def read(self, size: int = -1) -> bytes:
        if size is None or size < 0:
            while not self._eof:
                self._fill()
            out = b"".join(self._chunks)
            self._chunks.clear()
            self._pending_n = 0
            return out
        while self._pending_n < size and not self._eof:
            if not self._fill():
                break
        # assemble exactly `size` bytes: whole spans plus one boundary slice
        take, got = [], 0
        while self._chunks and got < size:
            c = self._chunks[0]
            if got + len(c) <= size:
                take.append(self._chunks.pop(0))
                got += len(c)
            else:
                cut = size - got
                take.append(c[:cut])
                self._chunks[0] = c[cut:]
                got = size
        self._pending_n -= got
        return b"".join(take)

    def readall(self) -> bytes:
        return self.read(-1)
