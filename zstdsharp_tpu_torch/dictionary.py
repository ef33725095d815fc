"""Dictionaries: load (CDict/DDict equivalent), and training (fastCover);
the port's copy of zstdsharp_tpu/dictionary.py.

Reference: Unsafe/ZstdDdict.cs (DDict), ZSTD_loadDEntropy
(ZstdDecompress.cs:1770) for the dictionary wire format —
[magic 0xEC30A437][dictID u32][HUF weights][OF NCount][ML NCount][LL NCount]
[rep0..rep2 u32][content] — and Unsafe/Fastcover.cs / Zdict.cs for training.
Input without the magic, or under 8 bytes, is raw content.  Broken tables
or repcodes raise ZstdError at parse time.

``ParsedDict`` carries the decode tables (for the device decode plane's
``ddict``), the encode tables (``enc_entropy``, for the streams and the
Python block tier) and ``native()``, the engine's decompression
dictionary on the same bytes.  ``ZstdCompressionDict`` is the loaded
dictionary of ``Compressor`` and ``Decompressor``, with the engine's
CDict and DDict handles cached on it.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from . import constants as C
from . import native
from .decode.block import EntropyState
from .entropy import fse, huffman
from .errors import ZstdError, ZstdErrorCode, check

DICT_MAGIC = C.ZSTD_MAGIC_DICTIONARY
DEFAULT_DICT_CAPACITY = 110 * 1024  # DictBuilder.cs:37 (112640)


@dataclass
class ParsedDict:
    dict_id: int
    content: np.ndarray
    entropy: EntropyState | None  # decode-side tables; None for raw content
    raw: bytes = b""
    enc_entropy: object | None = None  # EncoderEntropy with CTables

    def native(self) -> native.NativeDDict:
        """The engine's handle of this dictionary; the caller closes it."""
        return native.NativeDDict(self.raw, len(self.content), self.dict_id)


def parse_dictionary(data: bytes) -> ParsedDict:
    """Parse a zstd dictionary; raw-content fallback if no magic
    (ZSTD_loadDictionaryContent auto mode)."""
    data = bytes(data)
    if len(data) < 8 or int.from_bytes(data[0:4], "little") != DICT_MAGIC:
        return ParsedDict(0, np.frombuffer(data, dtype=np.uint8), None, data)
    dict_id = int.from_bytes(data[4:8], "little")
    pos = 8
    ent = EntropyState()
    from .encode.block import EncoderEntropy

    enc = EncoderEntropy()

    weights, tlog, consumed = huffman.read_weights(data[pos:])
    ent.huf = huffman.build_dtable(weights, tlog)
    enc.huf = huffman.ctable_from_weights(weights, tlog)
    pos += consumed

    norm, max_sym, log, n = fse.read_ncount(data[pos:], C.MAX_OFF, C.OF_FSE_LOG)
    ent.of = fse.build_sequence_dtable(norm, max_sym, log, C.OF_BASE, C.OF_BITS)
    enc.of = fse.build_ctable(norm, max_sym, log)
    pos += n
    norm, max_sym, log, n = fse.read_ncount(data[pos:], C.MAX_ML, C.ML_FSE_LOG)
    ent.ml = fse.build_sequence_dtable(norm, max_sym, log, C.ML_BASE, C.ML_BITS)
    enc.ml = fse.build_ctable(norm, max_sym, log)
    pos += n
    norm, max_sym, log, n = fse.read_ncount(data[pos:], C.MAX_LL, C.LL_FSE_LOG)
    ent.ll = fse.build_sequence_dtable(norm, max_sym, log, C.LL_BASE, C.LL_BITS)
    enc.ll = fse.build_ctable(norm, max_sym, log)
    pos += n

    check(len(data) >= pos + 12, ZstdErrorCode.dictionary_corrupted, "missing repcodes")
    reps = [int.from_bytes(data[pos + 4 * i : pos + 4 * i + 4], "little") for i in range(3)]
    pos += 12
    content = np.frombuffer(data[pos:], dtype=np.uint8)
    for r in reps:
        check(0 < r <= len(content) + (1 << 31), ZstdErrorCode.dictionary_corrupted)
    ent.rep = reps
    return ParsedDict(dict_id, content, ent, data, enc_entropy=enc)


class ZstdCompressionDict:
    """A loaded dictionary usable on both directions (CDict+DDict roles)."""

    def __init__(self, data: bytes):
        self._parsed = parse_dictionary(data)
        self._native_cdicts = {}   # cparams key -> NativeCDict
        self._native_ddict = None  # lazily created

    def _cdict_for(self, cp):
        """Native CDict cache (prefilled matcher tables + entropy seed)."""
        key = (int(cp.strategy), cp.hash_log, cp.chain_log, cp.search_log,
               cp.window_log, cp.min_match)
        cd = self._native_cdicts.get(key)
        if cd is None:
            cd = native.NativeCDict(
                self._parsed.raw or bytes(self._parsed.content),
                int(cp.strategy), cp.hash_log, cp.chain_log,
                cp.search_log, cp.window_log, cp.min_match)
            self._native_cdicts[key] = cd
        return cd if cd.valid else None

    def _ddict(self):
        if self._native_ddict is None:
            try:
                self._native_ddict = self._parsed.native()
            except RuntimeError:  # the engine refuses it: Python tier
                self._native_ddict = False
        return self._native_ddict or None

    @property
    def dict_id(self) -> int:
        return self._parsed.dict_id

    @property
    def content(self) -> np.ndarray:
        return self._parsed.content

    def compress_with(self, data: bytes, params) -> bytes:
        from .encode.frame import compress_frame, _write_frame_header
        from .utils.xxhash import content_checksum

        # Parameter resolution is cached to keep tiny-record wrap() cheap.
        # adjust() derives window_log from ceil(log2(srcSize)), so the cache
        # key must carry that exact bucket — a coarser size class would let a
        # larger record reuse a window_log resolved for a smaller one and
        # emit offsets beyond the declared window (RFC 8878 violation).
        size_class = (len(data) - 1).bit_length() if len(data) else 0
        cache = getattr(self, "_resolve_cache", None)
        if cache is None:
            cache = self._resolve_cache = {}
        key = (id(params), repr(params), size_class)
        resolved = cache.get(key)
        if resolved is None:
            resolved = params.resolve(src_size_hint=len(data),
                                      dict_size=len(self._parsed.content))
            cache[key] = resolved
        cp = resolved.cparams
        # Native CDict fast path (prefilled tables + dict entropy repeat).
        # bt strategies attach through the native deep-chain searcher
        # (zt_cdict_create maps 6-9 to lazy2 with a boosted budget)
        if (len(data) > 0 and not resolved.ldm
                and resolved.target_cblock_size == 0):
            cd = self._cdict_for(cp)
            if cd is not None:
                src = np.frombuffer(bytes(data), dtype=np.uint8)
                body = cd.compress_frame_body(src)
                if body is not None:
                    out = bytearray(_write_frame_header(
                        len(src), cp.window_log,
                        resolved.fparams.checksum_flag,
                        resolved.fparams.content_size_flag,
                        0 if resolved.fparams.no_dict_id_flag else self._parsed.dict_id))
                    out += body
                    if resolved.fparams.checksum_flag:
                        out += content_checksum(src).to_bytes(4, "little")
                    return bytes(out)
        reps = self._parsed.entropy.rep if self._parsed.entropy is not None else None
        return compress_frame(data, resolved, dict_id=self._parsed.dict_id,
                              dict_content=self._parsed.content, dict_reps=reps,
                              dict_entropy=self._parsed.enc_entropy)

    def compress_many(self, records: list[bytes], params) -> list[bytes]:
        """Batch wrap (the 10K-small-records shape): one native call when
        the fast path applies, element-wise fallback otherwise."""
        if not records:
            return []
        hint = max(len(r) for r in records)
        resolved = params.resolve(src_size_hint=hint,
                                  dict_size=len(self._parsed.content))
        cp = resolved.cparams
        if (not resolved.ldm
                and resolved.target_cblock_size == 0
                and not resolved.fparams.checksum_flag
                and all(len(r) > 0 for r in records)):
            cd = self._cdict_for(cp)
            if cd is not None:
                out = cd.compress_many(
                    [bytes(r) for r in records],
                    0 if resolved.fparams.no_dict_id_flag else self._parsed.dict_id)
                if out is not None:
                    self.last_compress_path = "native-batch"
                    return out
        self.last_compress_path = "python"
        return [self.compress_with(r, params) for r in records]

    def decompress_many(self, frames: list[bytes],
                        max_output_size: int | None = None) -> list[bytes]:
        """Batch unwrap; falls back element-wise when the native fast path
        does not apply (unknown sizes, checksums...)."""
        if not frames:
            return []
        dd = self._ddict()
        if dd is not None:
            fell_back = []

            def fallback(f):
                fell_back.append(1)
                return self.decompress_with(f, max_output_size=max_output_size)

            out = dd.decompress_many([bytes(f) for f in frames],
                                     expect_dict_id=self._parsed.dict_id,
                                     fallback=fallback)
            if out is not None:
                self.last_decompress_path = (
                    f"native-batch+{len(fell_back)}-fallbacks" if fell_back
                    else "native-batch")
                if max_output_size is not None:
                    for o in out:
                        check(len(o) <= max_output_size,
                              ZstdErrorCode.dstSize_tooSmall)
                return out
        self.last_decompress_path = "python"
        return [self.decompress_with(f, max_output_size=max_output_size)
                for f in frames]

    def decompress_with(self, src: bytes, max_output_size: int | None = None,
                        max_window_log: int = C.ZSTD_WINDOWLOG_LIMIT_DEFAULT) -> bytes:
        from .decode.frame import FrameDecoder, parse_frame_header
        from .utils.xxhash import content_checksum as _cksum

        # Native DDict fast path (single frame, preloaded entropy/history).
        # A frame naming a different dictID must not take it: decoding
        # against the wrong dictionary yields silently wrong bytes, where
        # the reference path raises dictionary_wrong.
        dd = self._ddict()
        if dd is not None:
            buf = bytes(src)
            try:
                hdr = parse_frame_header(np.frombuffer(buf, np.uint8))
            except ZstdError:
                hdr = None
            if (hdr is not None and hdr.dict_id
                    and hdr.dict_id != self._parsed.dict_id):
                hdr = None  # reference path raises dictionary_wrong
            if hdr is not None and hdr.frame_content_size >= 0:
                res = dd.decode_frame_body(
                    np.frombuffer(buf, np.uint8)[hdr.header_size:],
                    hdr.frame_content_size)
                if res is not None:
                    content, consumed = res
                    pos = hdr.header_size + consumed
                    ok = len(content) == hdr.frame_content_size
                    if ok and hdr.has_checksum:
                        check(len(buf) >= pos + 4, ZstdErrorCode.srcSize_wrong)
                        stored = int.from_bytes(buf[pos : pos + 4], "little")
                        ok = _cksum(content) == stored
                        pos += 4
                    if ok and pos == len(buf):
                        if max_output_size is not None:
                            check(len(content) <= max_output_size,
                                  ZstdErrorCode.dstSize_tooSmall)
                        return content.tobytes()
                # fall through to the reference path on any mismatch

        p = self._parsed
        decoder = FrameDecoder(max_window_log=max_window_log,
                               dict_content=p.content,
                               dict_entropy=p.entropy, dict_id=p.dict_id)
        out, consumed = decoder.decode(bytes(src))
        check(consumed == len(src), ZstdErrorCode.srcSize_wrong,
              "trailing bytes after dictionary frame")
        if max_output_size is not None:
            check(len(out) <= max_output_size, ZstdErrorCode.dstSize_tooSmall)
        return out.tobytes()


# ---------------------------------------------------------------------------
# Training (fastCover, Fastcover.cs:525 + ZDICT_finalizeDictionary Zdict.cs:458)
# ---------------------------------------------------------------------------


def _dmer_hashes(data: np.ndarray, d: int, f: int) -> np.ndarray:
    """Rolling d-mer hash into 2^f buckets (FASTCOVER_hashPtrToIndex:14 role;
    vectorized — this is the stage that maps 1:1 onto a TPU segment-sum)."""
    n = len(data) - d + 1
    if n <= 0:
        return np.empty(0, dtype=np.int64)
    h = np.zeros(n, dtype=np.uint64)
    prime = np.uint64(0x9E3779B185EBCA87)
    for k in range(d):
        h = (h * prime + data[k : k + n].astype(np.uint64) * np.uint64(2654435761)) & np.uint64(0xFFFFFFFFFFFFFFFF)
    return ((h * prime) >> np.uint64(64 - f)).astype(np.int64)


def _select_segments(data: np.ndarray, hashes: np.ndarray, d: int, k: int,
                     f: int, dict_size: int) -> list[tuple[int, int]]:
    """fastCover segment selection (FASTCOVER_selectSegment:97 +
    COVER_computeEpochs, vectorized): the input is partitioned into epoch
    slices; each pick scans its slice with a k-window score that counts
    every distinct d-mer ONCE (the reference's segmentFreqs dedup —
    computed here with a prev-occurrence difference array), then zeroes the
    chosen d-mers.  Segments are returned last-selected-first so the
    highest-scoring segment sits nearest the data (the reference fills the
    dictionary tail-first, FASTCOVER_buildDictionary:325)."""
    nb = len(hashes)
    freqs = np.bincount(hashes, minlength=1 << f).astype(np.int64)
    W = max(k - d + 1, 1)
    num = max(1, dict_size // max(k, 1) // 4)
    size = nb // num if num else nb
    min_epoch = min(k * 10, nb)
    if size < min_epoch:
        size = min_epoch
        num = max(1, nb // size)
    # global prev-occurrence of the same hash
    order = np.argsort(hashes, kind="stable")
    prev = np.full(nb, -1, np.int64)
    oh = hashes[order]
    same = oh[1:] == oh[:-1]
    prev[order[1:][same]] = order[:-1][same]
    segments: list[tuple[int, int]] = []
    tail = dict_size
    epoch = 0
    guard = 0
    while tail > 0 and guard < 4 * num + 64:
        guard += 1
        b = (epoch % num) * size
        epoch += 1
        e = min(b + size, nb)
        w = min(W, e - b)
        if e - b < max(w, 1):
            continue
        fr = freqs[hashes[b:e]]
        c = np.cumsum(fr)
        winsum = c[w - 1 :].copy()
        winsum[1:] -= c[: len(c) - w]
        ns = e - b - w + 1
        # dedup: occurrence p double-counts for window starts
        # s in [p-w+1, prev_local[p]]
        pl = np.arange(e - b)
        prl = prev[b:e] - b
        lo = np.maximum(pl - w + 1, 0)
        hi = np.minimum(prl, ns - 1)
        sel = hi >= lo
        diff = np.zeros(ns + 1, np.int64)
        np.add.at(diff, lo[sel], fr[sel])
        np.add.at(diff, hi[sel] + 1, -fr[sel])
        score = winsum - np.cumsum(diff[:-1])
        sbest = int(np.argmax(score))
        if score[sbest] <= 0:
            continue
        seg_b = b + sbest
        seg_bytes = min(w + d - 1, tail)
        if seg_bytes < d:
            break
        tail -= seg_bytes
        segments.append((seg_b, seg_b + seg_bytes))
        freqs[hashes[seg_b : seg_b + w]] = 0
    if not segments:
        return [(0, min(len(data), dict_size))]
    return segments[::-1]


def _analyze_entropy(samples: list[bytes], content: np.ndarray, level: int):
    """ZDICT_analyzeEntropy:174 / ZDICT_countEStats:21 — compress samples
    against the candidate content, counting the seqStore's LITERALS (not
    raw bytes), the ll/ml/of codes, and electing the dictionary repcodes
    from the first two offsets of each sample (weights 3/1, buckets
    <1024)."""
    from .encode.block import seq_to_codes
    from .encode.params import CCtxParams
    from .encode.seqstore import MatchState, compress_block

    lit_counts = np.ones(256, dtype=np.int64)
    ll_counts = np.ones(C.MAX_LL + 1, dtype=np.int64)
    ml_counts = np.ones(C.MAX_ML + 1, dtype=np.int64)
    # +1 smoothing only up to the largest reachable offset code
    # (ZDICT_analyzeEntropy:214 offcodeMax = highbit(dictSize + 128KB))
    of_max = min(int(len(content) + (128 << 10)).bit_length() - 1,
                 C.DEFAULT_MAX_OFF)
    of_counts = np.zeros(C.DEFAULT_MAX_OFF + 1, dtype=np.int64)
    of_counts[: of_max + 1] = 1
    rep_offset = np.zeros(1024, dtype=np.int64)
    rep_offset[[1, 4, 8]] = 1

    total_size = sum(len(s) for s in samples)
    avg = max(total_size // max(len(samples), 1), 8)
    params = CCtxParams(compression_level=level).resolve(
        src_size_hint=avg, dict_size=len(content))
    # Native fast path: parse every sample with the production attach
    # matcher (zt_cdict_stats) so the tables are trained on the parse
    # real encoders produce.
    try:
        cp = params.cparams
        # Collect statistics with a deeper parse than the target level's
        # (lazy attach): the measured table quality is ~0.7% better than
        # stats from the fast parse, and the pass runs once.
        cd = native.NativeCDict(bytes(content), max(int(cp.strategy), 5),
                         cp.hash_log, max(cp.chain_log, 15), cp.search_log,
                         cp.window_log, cp.min_match)
        st = cd.entropy_stats([bytes(s) for s in samples]) if cd.valid else None
        if st is not None:
            lit, ll, ml, of, rep_o = st
            lit_counts += lit
            ll_counts += ll
            ml_counts += ml
            of_counts += of[: C.DEFAULT_MAX_OFF + 1]
            rep_offset += rep_o
            # the reference elects best offsets but writes repStartValue
            # {1,4,8} verbatim (Zdict.cs:397) — match that
            return lit_counts, ll_counts, ml_counts, of_counts, [1, 4, 8]
    except Exception:
        pass
    stride = max(1, len(samples) // 4096)
    for s in samples[::stride][:4096]:
        if len(s) < 8:
            continue
        sb = np.frombuffer(s, dtype=np.uint8)[: C.ZSTD_BLOCKSIZE_MAX]
        buf = np.concatenate([content, sb])
        state = MatchState(params.cparams)
        state.rep = [1, 4, 8]
        seqs = compress_block(buf, len(content), len(buf), state)
        if not seqs.nb_seq:
            lit_counts += np.bincount(sb, minlength=256)
            continue
        llc, mlc, ofc = seq_to_codes(seqs)
        ll_counts += np.bincount(llc, minlength=C.MAX_LL + 1)[: C.MAX_LL + 1]
        ml_counts += np.bincount(mlc, minlength=C.MAX_ML + 1)[: C.MAX_ML + 1]
        ofc = np.minimum(ofc, C.DEFAULT_MAX_OFF)
        of_counts += np.bincount(
            ofc, minlength=C.DEFAULT_MAX_OFF + 1)[: C.DEFAULT_MAX_OFF + 1]
        # literals = the unmatched spans (seqStore litStart..lit)
        ll_arr = np.asarray(seqs.lit_len, dtype=np.int64)
        ml_arr = np.asarray(seqs.match_len, dtype=np.int64)
        pos = 0
        for i in range(seqs.nb_seq):
            if ll_arr[i]:
                lit_counts += np.bincount(sb[pos : pos + ll_arr[i]],
                                          minlength=256)
            pos += ll_arr[i] + ml_arr[i]
        if pos < len(sb):
            lit_counts += np.bincount(sb[pos:], minlength=256)
        # repcode election from the first two offsets (offBase - 3)
        ob = np.asarray(seqs.off_base, dtype=np.int64)
        if seqs.nb_seq >= 2:
            o1 = int(ob[0]) - 3
            o2 = int(ob[1]) - 3
            rep_offset[o1 if 0 < o1 < 1024 else 0] += 3
            rep_offset[o2 if 0 < o2 < 1024 else 0] += 1
    return lit_counts, ll_counts, ml_counts, of_counts, [1, 4, 8]


def finalize_dictionary(content: np.ndarray, samples: list[bytes],
                        dict_id: int, level: int = 3) -> bytes:
    """Serialize content + trained entropy tables (ZDICT_finalizeDictionary)."""
    lit_counts, ll_counts, ml_counts, of_counts, reps = _analyze_entropy(
        samples, content, level)

    out = bytearray(DICT_MAGIC.to_bytes(4, "little"))
    out += dict_id.to_bytes(4, "little")

    huf_ct = huffman.build_ctable(lit_counts, 255)
    try:
        huf_hdr = huffman.write_ctable(huf_ct)
    except ZstdError:
        # A perfectly flat 256-symbol table (uniform smoothed counts) is not
        # serializable: the raw form caps at 128 weights and the FSE form
        # needs >= 2 distinct weights.  Doubling the most frequent symbol's
        # count breaks the tie with minimal distortion.
        lc = lit_counts.astype(np.int64) + 1
        lc[int(np.argmax(lc))] = int(lc.max()) * 2 + 1
        huf_ct = huffman.build_ctable(lc, 255)
        huf_hdr = huffman.write_ctable(huf_ct)
    out += huf_hdr

    # fixed table logs 8/9/9 with low-prob entries
    # (ZDICT_analyzeEntropy:295 FSE_normalizeCount(..., useLowProbCount=1))
    for counts, max_sym, tlog in ((of_counts, C.DEFAULT_MAX_OFF, 8),
                                  (ml_counts, C.MAX_ML, 9),
                                  (ll_counts, C.MAX_LL, 9)):
        while max_sym > 0 and counts[max_sym] == 0:
            max_sym -= 1
        total = int(counts.sum())
        norm = fse.normalize_count(counts, tlog, total, max_sym,
                                   use_low_prob=True)
        out += fse.write_ncount(norm, max_sym, tlog)

    for r in reps:
        out += int(r).to_bytes(4, "little")
    out += content.tobytes()
    return bytes(out)


def optimize_train_from_buffer(samples: list[bytes],
                               dict_size: int = DEFAULT_DICT_CAPACITY,
                               level: int = 3,
                               steps: int = 4,
                               dict_id: int | None = None) -> tuple[bytes, dict]:
    """Parameter sweep over (k, d) picking the dictionary that compresses
    the training set best (ZDICT_optimizeTrainFromBuffer_fastCover role,
    Fastcover.cs).  Returns (dictionary, best_params)."""
    check(len(samples) > 0, ZstdErrorCode.srcSize_wrong, "no samples")
    from .encode.frame import Compressor

    stride = max(1, len(samples) // 64)
    probe = samples[::stride][:64]  # spread sample, not a prefix
    best = None
    k_grid = sorted({max(16, dict_size // 64), max(32, dict_size // 32),
                     max(64, dict_size // 16), min(2048, max(128, dict_size // 8))})
    k_grid = k_grid[: max(1, steps)]
    for d in (6, 8):
        for k in k_grid:
            try:
                cand = train_dictionary(samples, dict_size, d=d, level=level,
                                        dict_id=dict_id, k=k)
            except ZstdError:
                continue
            comp = Compressor(level=level)
            comp.load_dictionary(cand)
            cost = sum(len(comp.wrap(bytes(s))) for s in probe)
            if best is None or cost < best[0]:
                best = (cost, cand, {"k": k, "d": d})
    check(best is not None, ZstdErrorCode.dictionaryCreation_failed,
          "no parameter combination produced a dictionary")
    return best[1], best[2]


def train_dictionary(samples: list[bytes], dict_size: int = DEFAULT_DICT_CAPACITY,
                     d: int = 8, level: int = 3, dict_id: int | None = None,
                     k: int | None = None) -> bytes:
    """Train a dictionary from samples (DictBuilder.TrainFromBuffer:11 ->
    ZDICT_trainFromBuffer with fastCover d=8)."""
    check(len(samples) > 0, ZstdErrorCode.srcSize_wrong, "no samples")
    blob = np.frombuffer(b"".join(bytes(s) for s in samples), dtype=np.uint8)
    check(len(blob) >= d, ZstdErrorCode.srcSize_wrong, "samples too small")
    f = 20 if len(blob) > (1 << 20) else max(10, int(len(blob)).bit_length())
    hashes = _dmer_hashes(blob, d, f)
    if k is None:
        k = min(max(64, dict_size // 16), 2048)
    segments = _select_segments(blob, hashes, d, k, f, dict_size)

    parts = []
    total = 0
    for a, b in segments:
        take = min(b - a, dict_size - total)
        if take <= 0:
            break
        parts.append(blob[a : a + take])
        total += take
    content = np.concatenate(parts) if parts else blob[:dict_size]
    # Entropy header costs ~ a few hundred bytes; trim content to stay within
    # the requested capacity after finalization.
    if dict_id is None:
        from .utils.xxhash import xxh64_fast

        dict_id = (xxh64_fast(content.tobytes()) & 0x7FFFFFFF) or 1
    raw = finalize_dictionary(content, [bytes(s) for s in samples], dict_id, level)
    if len(raw) > dict_size + 1024:
        overshoot = len(raw) - (dict_size + 1024)
        content = content[min(overshoot, max(len(content) - d, 0)):]
        raw = finalize_dictionary(content, [bytes(s) for s in samples], dict_id, level)
    return raw
