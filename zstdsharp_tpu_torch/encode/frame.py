"""Frame-level encoding and the public compress API: the port's copy of
zstdsharp_tpu/encode/frame.py (reference: ZSTD_writeFrameHeader
(ZstdCompress.cs:4817), block loop ZSTD_compress_frameChunk (:4690),
epilogue ZSTD_writeEpilogue (:5598), bound ZSTD_compressBound).

``compress(data, level, checksum)`` takes the reference's routes through
the native engine, in its order:

1. ``exact``: the exact encoder (``native.compress_exact``), for levels
   >= 1 and -1 at the default parameter shape; it declines the lazy
   levels and some level / size pairs;
2. ``frame_body``: the whole-frame encoder at the resolved parameters
   (``native.compress_frame_body``), for inputs of 256 bytes and more;
3. ``estream``: ``FrameEncoder`` on the engine's streaming encoder
   (``native.NativeEStream``), for what is left.

``FrameEncoder`` keeps the reference's Python block tier
(``seqstore.compress_block`` + ``block.encode_block_body``) for a
dictionary given without its raw bytes; the reference also drops to it
without the engine, where the port raises (``native.get_lib``).  A frame
checksum over a stream is computed once at the end over the buffered
input (the reference's fallback when the ``xxhash`` module is missing).
``tests/test_torch_host.py`` pins which route each input takes.
"""

from __future__ import annotations

import numpy as np

from .. import constants as C
from .. import native
from ..errors import ZstdErrorCode, check
from ..utils import trace
from ..utils.xxhash import content_checksum
from .block import EncoderEntropy, encode_block_body
from .params import CCtxParams, ResolvedParams
from .seqstore import MatchState, compress_block


def compress_bound(src_size: int) -> int:
    """ZSTD_compressBound — worst-case compressed size."""
    margin = ((128 << 10) - src_size) >> 11 if src_size < (128 << 10) else 0
    return src_size + (src_size >> 8) + margin


def _write_frame_header(src_size: int, window_log: int, checksum: bool,
                        content_size_flag: bool, dict_id: int = 0) -> bytes:
    window_size = 1 << window_log
    single_segment = content_size_flag and src_size >= 0 and src_size <= window_size
    if content_size_flag and src_size >= 0:
        fcs_code = (src_size >= 256) + (src_size >= 65536 + 256) + (src_size > 0xFFFFFFFF)
    else:
        fcs_code = 0
    did_code = 0 if dict_id == 0 else (1 if dict_id < 256 else 2 if dict_id < 65536 else 3)
    fhd = (fcs_code << 6) | (int(single_segment) << 5) | (int(checksum) << 2) | did_code
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


class _BufferedXxh:
    """Streaming XXH64 over the buffered input, hashed once at the end
    through the engine (the reference's fallback without the ``xxhash``
    module)."""

    def __init__(self):
        self._chunks = []

    def update(self, data: bytes) -> None:
        self._chunks.append(bytes(data))

    def intdigest(self) -> int:
        return native.xxh64(b"".join(self._chunks))


class FrameEncoder:
    """Incremental frame encoder: the zcss_load/flush streaming core
    (ZSTD_compressStream_generic:6632) as feed()/finish() calls.

    One-shot compression is `FrameEncoder(params, src_size).feed(data, end=True)`.
    """

    def __init__(self, params: ResolvedParams, src_size: int = -1,
                 dict_id: int = 0, dict_content: np.ndarray | None = None,
                 dict_reps: list[int] | None = None,
                 dict_entropy: EncoderEntropy | None = None,
                 dict_raw: bytes | None = None):
        self.params = params
        cp = params.cparams
        self.block_size = min(C.ZSTD_BLOCKSIZE_MAX, 1 << cp.window_log)
        # MatchState allocates the full window-sized tables — built lazily
        # so the native-context path never pays for the Python tier's
        # gigabyte-class numpy allocations it will never use
        self._state = None
        self._pending_rep = None
        if dict_entropy is not None:
            self.entropy = EncoderEntropy(huf=dict_entropy.huf, ll=dict_entropy.ll,
                                          ml=dict_entropy.ml, of=dict_entropy.of)
        else:
            self.entropy = EncoderEntropy()
        self._xxh = _BufferedXxh() if params.fparams.checksum_flag else None
        # History buffer holds [dict_content | emitted frame bytes | pending].
        self._buf = np.empty(max(1 << 17, 2 * self.block_size), dtype=np.uint8)
        self._filled = 0
        self._emitted = 0  # bytes already compressed into blocks
        self._finished = False
        self._header = _write_frame_header(
            src_size, cp.window_log, params.fparams.checksum_flag,
            params.fparams.content_size_flag and src_size >= 0, dict_id)
        self._header_sent = False
        self._last_sent = False
        self._src_size = src_size
        # Native streaming context (zt_estream): block emission at engine
        # speed for every streaming shape — dictionary streams preload the
        # context (prefix history + table prefill + entropy seed), LDM and
        # targetCBlockSize run inside the engine.  The Python block
        # machinery below serves a dictionary given without its raw
        # bytes, or a context the engine cannot allocate.
        self._nstream = None
        self._ingested = 0
        want_dict = dict_content is not None and len(dict_content) > 0
        if not want_dict or dict_raw is not None:
            accel = (cp.target_length
                     if cp.strategy <= 2 and cp.target_length else 1)
            tcbs = int(params.target_cblock_size or 0)
            ldm = 1 if params.ldm else 0
            # bt levels size their chain table 2^(clog+1)*4 bytes; on a
            # constrained VM that allocation can fail — degrade the
            # chain log (ratio trade) before dropping a whole tier,
            # never fall to the Python block machinery silently.
            for clog in (cp.chain_log, min(cp.chain_log, 26),
                         min(cp.chain_log, 24)):
                try:
                    self._nstream = native.NativeEStream(
                        int(cp.strategy), cp.hash_log, clog,
                        cp.search_log, cp.window_log, cp.min_match,
                        accel=accel, tcbs=tcbs, ldm=ldm)
                    break
                except RuntimeError:
                    self._nstream = None
            if self._nstream is None and cp.strategy > 5:
                try:
                    # last resort: row-matcher tier at the same window
                    self._nstream = native.NativeEStream(
                        5, min(cp.hash_log, 20), min(cp.chain_log, 21),
                        cp.search_log, cp.window_log, cp.min_match,
                        accel=1, tcbs=tcbs, ldm=ldm)
                except RuntimeError:
                    self._nstream = None
            if self._nstream is not None and want_dict:
                try:
                    self._nstream.preload(dict_raw)
                except RuntimeError:
                    self._nstream = None
        if self._nstream is None and want_dict:
            self._append(dict_content)
            self._emitted = len(dict_content)
            st = self.state
            st.window_start = 0  # dict is valid history
            st._next_to_insert = 0
            from .seqstore import fill_hash_table

            fill_hash_table(st, self._buf[: self._filled], 0, self._filled)
        if dict_reps is not None:
            self._pending_rep = list(dict_reps)
            if self._nstream is None:
                self.state.rep = list(dict_reps)
        self._dict_len = self._emitted

    @property
    def state(self) -> MatchState:
        if self._state is None:
            self._state = MatchState(self.params.cparams)
            if self._pending_rep is not None:
                self._state.rep = list(self._pending_rep)
        return self._state

    def _append(self, data: np.ndarray) -> None:
        need = self._filled + len(data)
        if need > len(self._buf):
            cap = max(need, 2 * len(self._buf))
            nbuf = np.empty(cap, dtype=np.uint8)
            nbuf[: self._filled] = self._buf[: self._filled]
            self._buf = nbuf
        self._buf[self._filled : need] = data
        self._filled = need

    def _emit_block(self, out: bytearray, end: int, last: bool) -> None:
        pos = self._emitted
        block = self._buf[pos:end]
        bsize = end - pos
        if last:
            self._last_sent = True
        if bsize > 1 and (block == block[0]).all():
            out += _block_header(last, C.BlockType.RLE, bsize)
            out.append(int(block[0]))
            self.state._next_to_insert = end
        else:
            # Snapshot decoder-visible state: a raw fallback must not
            # advance repcodes/repeat tables (confirmRepcodes role).
            import copy as _copy

            rep_snap = list(self.state.rep)
            ent_snap = _copy.deepcopy(self.entropy)
            seqs = compress_block(self._buf, pos, end, self.state)
            body = encode_block_body(block, seqs, self.entropy)
            if body is None:
                self.state.rep = rep_snap
                self.entropy = ent_snap
                out += _block_header(last, C.BlockType.RAW, bsize)
                out += block.tobytes()
            else:
                out += _block_header(last, C.BlockType.COMPRESSED, len(body))
                out += body
        self._emitted = end

    def _maybe_trim(self) -> None:
        """Round-buffer discipline (ZSTD_window_correctOverflow:589 role):
        drop history beyond the match window so unbounded streams run in
        O(window) memory.  Hash positions are rebased; the chain table's
        pos&mask indexing stays valid because the trim amount is a multiple
        of the chain size."""
        window = 1 << self.params.cparams.window_log
        keep = window + self.block_size
        excess = self._emitted - keep
        unit = self.block_size
        if self.state.chain_table is not None:
            unit = max(unit, len(self.state.chain_table))
        if excess < unit:
            return
        delta = (excess // unit) * unit
        self._buf[: self._filled - delta] = self._buf[delta : self._filled]
        self._filled -= delta
        self._emitted -= delta
        self._dict_len = max(0, self._dict_len - delta)
        st = self.state
        st.window_start = max(0, st.window_start - delta)
        ht = st.hash_table
        np.subtract(ht, delta, out=ht, where=ht >= 0)
        ht[ht < 0] = -1
        if st.chain_table is not None:
            ct = st.chain_table
            np.subtract(ct, delta, out=ct, where=ct >= 0)
            ct[ct < 0] = -1
        if hasattr(st, "_next_to_insert"):
            st._next_to_insert = max(0, st._next_to_insert - delta)
        if hasattr(st, "dfast_long"):
            lt = st.dfast_long
            np.subtract(lt, delta, out=lt, where=lt >= 0)
            lt[lt < 0] = -1

    def feed(self, data: bytes | np.ndarray, end: bool = False) -> bytes:
        """Consume input, return any compressed bytes produced."""
        assert not self._finished, "frame already finished"
        arr = (data if isinstance(data, np.ndarray)
               else np.frombuffer(bytes(data), dtype=np.uint8))
        if self._xxh is not None and len(arr):
            self._xxh.update(arr.tobytes())
        if self._nstream is not None:
            return self._native_step(arr, 2 if end else 0)
        if len(arr):
            self._append(arr)
        out = bytearray()
        if not self._header_sent:
            out += self._header
            self._header_sent = True
        # Emit full blocks; hold the tail back unless ending.
        while self._filled - self._emitted >= self.block_size:
            is_tail = end and (self._filled - self._emitted == self.block_size)
            self._emit_block(out, self._emitted + self.block_size, is_tail)
        self._maybe_trim()
        if end:
            if self._filled > self._emitted:
                self._emit_block(out, self._filled, True)
            elif not self._last_sent:
                # Empty frame, or stream ended exactly on a block boundary:
                # close with an empty raw last block (ZSTD_writeEpilogue:5598).
                out += _block_header(True, C.BlockType.RAW, 0)
            if self._xxh is not None:
                out += (self._xxh.intdigest() & 0xFFFFFFFF).to_bytes(4, "little")
            self._finished = True
        return bytes(out)

    def _native_step(self, arr: np.ndarray, mode: int) -> bytes:
        out = bytearray()
        if not self._header_sent:
            out += self._header
            self._header_sent = True
        self._ingested += len(arr)
        try:
            out += self._nstream.feed(arr, mode)
        except RuntimeError:
            # native ctx failed mid-stream: no safe fallback (its pending
            # bytes are inside the ctx) — surface the error
            raise
        if mode == 2:
            if self._xxh is not None:
                out += (self._xxh.intdigest() & 0xFFFFFFFF).to_bytes(
                    4, "little")
            self._finished = True
            self._nstream.close()
        return bytes(out)

    def flush(self) -> bytes:
        """Mid-block flush (ZSTD_flushStream:7714 / ZSTD_e_flush role):
        force the buffered tail out as a (non-last) block so the receiver
        can decode every byte fed so far.  Matcher/entropy state persists,
        so flushing costs ratio only through the extra block header and a
        sub-full block's entropy tables.  No-op on a finished frame
        (io close paths flush after finishing)."""
        if self._finished:
            return b""
        if self._nstream is not None:
            return self._native_step(np.empty(0, dtype=np.uint8), 1)
        out = bytearray()
        if not self._header_sent:
            out += self._header
            self._header_sent = True
        while self._filled - self._emitted >= self.block_size:
            self._emit_block(out, self._emitted + self.block_size, False)
        if self._filled > self._emitted:
            self._emit_block(out, self._filled, False)
        return bytes(out)

    def finish(self) -> bytes:
        return self.feed(b"", end=True)

    @property
    def progression(self) -> dict:
        """ZSTD_getFrameProgression:2385 analog."""
        if self._nstream is not None:
            pend = self._nstream.pending
            consumed = self._ingested - pend
            return {
                "ingested": self._ingested,
                "consumed": consumed,
                "produced": consumed,
                "flushed": consumed,
                "current_job": 0,
                "n_active_workers": 0,
            }
        ingested = self._filled - self._dict_len
        consumed = self._emitted - self._dict_len
        return {
            "ingested": ingested,
            "consumed": consumed,
            "produced": consumed,  # block-granular: emitted == produced
            "flushed": consumed,
            "current_job": 0,
            "n_active_workers": 0,
        }

    def to_flush_now(self) -> int:
        """ZSTD_toFlushNow:2411 analog — pending bytes below a block."""
        if self._nstream is not None:
            return self._nstream.pending
        return self._filled - self._emitted


def compress_frame(data: bytes | np.ndarray, params: ResolvedParams,
                   dict_id: int = 0,
                   dict_content: np.ndarray | None = None,
                   dict_reps: list[int] | None = None,
                   dict_entropy: EncoderEntropy | None = None) -> bytes:
    src = (data if isinstance(data, np.ndarray)
           else np.frombuffer(bytes(data), dtype=np.uint8))
    if dict_content is None and len(src) >= 256:
        # Whole-frame native fast path (no dictionary state to thread).
        cp = params.cparams
        body = native.compress_frame_body(
            src, int(cp.strategy), cp.hash_log, cp.chain_log,
            cp.search_log, cp.window_log,
            accel=(cp.target_length
                   if cp.strategy <= 2 and cp.target_length else 1),
            use_ldm=params.ldm, min_match=cp.min_match,
            block_splitter=params.block_splitter,
            target_cblock=params.target_cblock_size)
        if body is not None:
            out = bytearray(_write_frame_header(
                len(src), cp.window_log, params.fparams.checksum_flag,
                params.fparams.content_size_flag, dict_id))
            out += body
            if params.fparams.checksum_flag:
                out += content_checksum(src).to_bytes(4, "little")
            return bytes(out)
    enc = FrameEncoder(params, src_size=len(src), dict_id=dict_id,
                       dict_content=dict_content, dict_reps=dict_reps,
                       dict_entropy=dict_entropy)
    return enc.feed(src, end=True)


def compress(data: bytes, level: int = 3, checksum: bool = False,
             params: CCtxParams | None = None) -> bytes:
    """One-shot compression (Compressor.Wrap / ZSTD_compress2 equivalent).

    With params.n_workers > 0 the input is split into jobs compressed as
    independent frames in a thread pool — the host analog of zstdmt (which
    the reference accepts but rejects at runtime, ZstdCompress.cs:1064); the
    multi-chip analog is parallel.pipeline.  Output stays a valid stream
    (frame concatenation, RFC 8878 §3).
    """
    if params is None:
        params = CCtxParams(compression_level=level, checksum_flag=checksum)
    with trace.span("compress", src_size=len(data), level=params.compression_level) as sp:
        out = None
        if params.n_workers > 0 and len(data) > C.ZSTD_BLOCKSIZE_MAX:
            out = _compress_multiframe(data, params)
        else:
            if _exact_eligible(params):
                # Byte-exact reference pipeline (matches libzstd output for
                # the fast/dfast strategies; returns None for levels/sizes it
                # does not cover, ZstdFast.cs:96 / ZstdDoubleFast.cs:51).
                out = native.compress_exact(bytes(data),
                                            params.compression_level,
                                            params.checksum_flag)
            if out is None:
                resolved = params.resolve(src_size_hint=len(data))
                out = compress_frame(data, resolved)
        sp.dst_size = len(out)
        return out


def _exact_eligible(params: CCtxParams) -> bool:
    """The exact encoder covers the reference's default parameter shape:
    positive level, no cParam overrides, auto/off LDM, auto splitter, no
    targetCBlockSize, content size written (negative levels differ from the
    current libzstd oracle and stay on the legacy pipeline).  An explicit
    block_splitter=False is honored on the legacy pipeline rather than
    silently ignored: the exact path always runs the trial-encode splitter
    at bt-optimal levels (ZSTD_resolveBlockSplitterMode:255 auto rule)."""
    return ((params.compression_level >= 1
             or params.compression_level == -1)
            and not (params.window_log or params.hash_log or params.chain_log
                     or params.search_log or params.min_match
                     or params.target_length or params.strategy)
            and params.ldm in (None, False)
            and params.block_splitter is None
            and params.target_cblock_size == 0
            and params.content_size_flag)


def _compress_multiframe(data: bytes, params: CCtxParams) -> bytes:
    from concurrent.futures import ThreadPoolExecutor

    n_jobs = params.n_workers
    job = max((len(data) + n_jobs - 1) // n_jobs, C.ZSTD_BLOCKSIZE_MAX)
    chunks = [data[i : i + job] for i in range(0, len(data), job)]

    def one(chunk: bytes) -> bytes:
        return compress_frame(chunk, params.resolve(src_size_hint=len(chunk)))

    with ThreadPoolExecutor(max_workers=n_jobs) as pool:
        return b"".join(pool.map(one, chunks))


def write_skippable_frame(content: bytes, magic_variant: int = 0) -> bytes:
    """ZSTD_writeSkippableFrame:4937."""
    check(0 <= magic_variant <= 15, ZstdErrorCode.parameter_outOfBound)
    return ((C.ZSTD_MAGIC_SKIPPABLE_START + magic_variant).to_bytes(4, "little")
            + len(content).to_bytes(4, "little") + content)


class Compressor:
    """Mirror of the reference's safe Compressor (Compressor.cs:6)."""

    def __init__(self, level: int = C.ZSTD_DEFAULT_CLEVEL):
        self.params = CCtxParams(compression_level=level)
        self._dict = None

    @property
    def level(self) -> int:
        return self.params.compression_level

    @level.setter
    def level(self, value: int) -> None:
        self.params.compression_level = value

    def set_parameter(self, name: str, value) -> None:
        """Bounds-validated at set time (ZSTD_CCtx_setParameter:784)."""
        self.params.set_parameter(name, value)

    def get_parameter(self, name: str):
        check(name in type(self.params).__dataclass_fields__,
              ZstdErrorCode.parameter_unsupported, name)
        return getattr(self.params, name)

    def load_dictionary(self, dict_data: bytes | None) -> None:
        from ..dictionary import ZstdCompressionDict

        self._dict = ZstdCompressionDict(dict_data) if dict_data is not None else None

    def get_compress_bound(self, size: int) -> int:
        return compress_bound(size)

    def wrap(self, data: bytes) -> bytes:
        if self._dict is not None:
            return self._dict.compress_with(data, self.params)
        return compress(data, params=self.params)

    def wrap_many(self, records: list[bytes]) -> list[bytes]:
        """Batch wrap: one native call per batch (ZSTD_compress_usingCDict
        over a record stream role; without a dictionary an empty-content
        context provides the same zero-setup per-record path)."""
        if self._dict is not None:
            return self._dict.compress_many(records, self.params)
        if records:
            hint = max(len(r) for r in records)
            resolved = self.params.resolve(src_size_hint=hint)
            cp = resolved.cparams
            if (int(cp.strategy) <= 5 and not resolved.ldm
                    and resolved.target_cblock_size == 0
                    and not resolved.fparams.checksum_flag
                    and all(len(r) > 0 for r in records)):
                key = (int(cp.strategy), cp.hash_log, cp.chain_log,
                       cp.search_log, cp.window_log, cp.min_match)
                cache = getattr(self, "_empty_cdicts", None)
                if cache is None:
                    cache = self._empty_cdicts = {}
                cd = cache.get(key)
                if cd is None:
                    cd = native.NativeCDict(
                        b"", int(cp.strategy), cp.hash_log, cp.chain_log,
                        cp.search_log, cp.window_log, cp.min_match)
                    cache[key] = cd
                if cd.valid:
                    out = cd.compress_many([bytes(r) for r in records], 0)
                    if out is not None:
                        return out
        return [self.wrap(r) for r in records]

    def try_wrap(self, data: bytes, dest_capacity: int) -> tuple[bool, bytes]:
        """TryWrap:118 — (False, b'') when the frame exceeds dest_capacity."""
        frame = self.wrap(data)
        if len(frame) > dest_capacity:
            return False, b""
        return True, frame

    compress = wrap
