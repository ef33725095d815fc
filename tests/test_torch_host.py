"""The port's own host tier against the JAX package's, byte for byte.

The port keeps its own copy of the host code it reaches (constants, frame
parsing and writing, the native-routed ``compress`` and ``decompress``,
the FSE and Huffman table builders and writers, the block decoders the
device planner's host route uses, ``scan_eligibility``, the dictionary
parser).  Every case feeds the same inputs, made from numpy seeds, to the
port and to ``zstdsharp_tpu`` and asserts equal bytes, fields, arrays or
error codes.
"""

import dataclasses

import numpy as np
import pytest
import zstandard

from zstdsharp_tpu import constants as RC
from zstdsharp_tpu import dictionary as rdict
from zstdsharp_tpu.decode import block as rblock
from zstdsharp_tpu.decode import device_pipeline as rdp
from zstdsharp_tpu.decode import frame as rframe
from zstdsharp_tpu.encode import frame as renc
from zstdsharp_tpu.entropy import fse as rfse
from zstdsharp_tpu.entropy import huffman as rhuf
from zstdsharp_tpu.errors import ZstdError as RZstdError
from zstdsharp_tpu.utils.xxhash import content_checksum as r_checksum
from zstdsharp_tpu_torch import constants as C
from zstdsharp_tpu_torch import dictionary, native
from zstdsharp_tpu_torch.decode import block
from zstdsharp_tpu_torch.decode import device_pipeline as dp
from zstdsharp_tpu_torch.decode import frame
from zstdsharp_tpu_torch.encode import frame as enc
from zstdsharp_tpu_torch.entropy import fse, huffman
from zstdsharp_tpu_torch.errors import ZstdError
from zstdsharp_tpu_torch.utils.xxhash import content_checksum

LEVELS = (1, 3, 5, 9, 19)
SIZES = (0, 1, 255, 256, 4096, (128 << 10) + 1, 400_000)


def _data(n: int, seed: int = 3) -> bytes:
    """Seeded compressible bytes: words, with a stretch of noise."""
    r = np.random.default_rng(seed + n)
    words = [b"sequence", b"literal", b"offset", b"match", b"frame ",
             b"block", b"huffman", b"table", b"\n", b"0123"]
    out = b"".join(words[int(i)] for i in r.integers(0, len(words), n // 4 + 8))
    noise = r.integers(0, 256, n // 8, dtype=np.uint8).tobytes()
    return (out[:n // 2] + noise + out[n // 2:])[:n]


# ---------------------------------------------------------------------------
# constants
# ---------------------------------------------------------------------------

_CONSTANTS = sorted(k for k in vars(C) if k.isupper() and not k.startswith("_"))


@pytest.mark.parametrize("name", _CONSTANTS)
def test_constant_equals_reference(name):
    mine, ref = getattr(C, name), getattr(RC, name)
    if isinstance(mine, np.ndarray):
        assert mine.dtype == ref.dtype and np.array_equal(mine, ref)
    else:
        assert mine == ref


@pytest.mark.parametrize("name", ["BlockType", "LiteralsBlockType",
                                  "SymbolEncodingType", "Strategy"])
def test_enum_equals_reference(name):
    mine, ref = getattr(C, name), getattr(RC, name)
    assert [(e.name, int(e)) for e in mine] == [(e.name, int(e)) for e in ref]


# ---------------------------------------------------------------------------
# compress / decompress
# ---------------------------------------------------------------------------

_FRAMES: dict = {}


def _frame(level: int, size: int, checksum: bool = False) -> bytes:
    key = (level, size, checksum)
    if key not in _FRAMES:
        _FRAMES[key] = renc.compress(_data(size), level, checksum=checksum)
    return _FRAMES[key]


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("level", LEVELS)
def test_compress_equals_reference(level, size):
    assert enc.compress(_data(size), level) == _frame(level, size)


@pytest.mark.parametrize("level", (-5, -1, 0, 4, 12, 22))
@pytest.mark.parametrize("size", (100, 5000))
def test_compress_other_levels_and_checksum_equal_reference(level, size):
    data = _data(size, seed=11)
    assert enc.compress(data, level, checksum=True) == renc.compress(
        data, level, checksum=True)


def _expected_route(level: int, size: int) -> str:
    if level in (1, 3, 19):
        return "exact"
    return "frame_body" if size >= 256 else "estream"


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("level", LEVELS)
def test_compress_route_is_pinned(level, size, monkeypatch):
    """Which native route makes each frame: the exact encoder for the
    fast, dfast and bt levels, the whole-frame encoder for the lazy levels
    from 256 bytes up, the streaming encoder below 256 bytes."""
    calls = []
    for name in ("compress_exact", "compress_frame_body", "NativeEStream"):
        real = getattr(native, name)

        def spy(*a, _real=real, _name=name, **k):
            calls.append(_name)
            return _real(*a, **k)
        monkeypatch.setattr(native, name, spy)
    assert enc.compress(_data(size), level) == _frame(level, size)
    assert calls == {"exact": ["compress_exact"],
                     "frame_body": ["compress_exact", "compress_frame_body"],
                     "estream": ["compress_exact", "NativeEStream"]}[
                         _expected_route(level, size)]


def _special_frames():
    """(name, frame): raw, RLE, checksummed, multi-frame with a skippable
    frame, and libzstd frames without a content size."""
    noise = np.random.default_rng(5).integers(0, 256, 5000,
                                              dtype=np.uint8).tobytes()
    zc = zstandard.ZstdCompressor(level=3, write_content_size=False,
                                  write_checksum=True)
    skippable = (0x184D2A53).to_bytes(4, "little") + (5).to_bytes(
        4, "little") + b"skip!"
    return [
        ("raw", renc.compress(noise, 9)),
        ("rle", renc.compress(b"Q" * 30_000, 9)),
        ("checksum", renc.compress(_data(50_000), 5, checksum=True)),
        ("checksum_multiblock", renc.compress(_data(300_000), 3,
                                              checksum=True)),
        ("multiframe", renc.compress(b"abc" * 100, 1) + skippable
         + renc.compress(_data(9000), 19)),
        ("no_content_size", zc.compress(_data(200_000))),
    ]


_SPECIAL = _special_frames()


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("level", LEVELS)
def test_decompress_equals_reference(level, size):
    f = _frame(level, size)
    assert frame.decompress(f) == rframe.decompress(f) == _data(size)


@pytest.mark.parametrize("name,f", _SPECIAL, ids=[n for n, _ in _SPECIAL])
def test_decompress_special_frames_equal_reference(name, f):
    assert frame.decompress(f) == rframe.decompress(f)


def test_decompress_raises_on_bad_checksum_as_reference():
    f = bytearray(_SPECIAL[2][1])
    f[-1] ^= 1
    with pytest.raises(ZstdError) as mine:
        frame.decompress(bytes(f))
    with pytest.raises(Exception) as ref:
        rframe.decompress(bytes(f))
    assert int(mine.value.code) == int(ref.value.code)


def _header_cases():
    return ([(f"L{lv}-{n}", _frame(lv, n)) for lv in (1, 9) for n in SIZES]
            + _SPECIAL)


_HEADERS = _header_cases()


@pytest.mark.parametrize("name,f", _HEADERS, ids=[n for n, _ in _HEADERS])
def test_frame_header_and_size_equal_reference(name, f):
    # the reference's header from bytes: from a numpy array its window
    # shift stays in uint8 and a non-single-segment window reads 0, where
    # the port reads the header bytes as ints from either input
    want = dataclasses.asdict(rframe.parse_frame_header(f))
    assert dataclasses.asdict(frame.parse_frame_header(f)) == want
    buf = np.frombuffer(f, np.uint8)
    assert dataclasses.asdict(frame.parse_frame_header(buf)) == want
    assert (frame.find_frame_compressed_size(f)
            == rframe.find_frame_compressed_size(f))


@pytest.mark.parametrize("args", [
    (0, 10, False, True), (1, 17, True, True), (255, 14, False, True),
    (256, 17, True, True), (65791, 19, False, True), (65792, 19, True, True),
    (1 << 20, 17, False, True), (5 << 30, 22, True, True),
    (1000, 20, False, False), (-1, 21, True, True), (300, 10, False, True, 7),
    (300, 10, False, True, 70_000)])
def test_write_frame_header_equals_reference(args):
    assert enc._write_frame_header(*args) == renc._write_frame_header(*args)


@pytest.mark.parametrize("last", (False, True))
@pytest.mark.parametrize("btype", list(C.BlockType))
@pytest.mark.parametrize("size", (0, 1, 1000, (1 << 17)))
def test_block_header_equals_reference(last, btype, size):
    assert (enc._block_header(last, btype, size)
            == renc._block_header(last, RC.BlockType(int(btype)), size))


@pytest.mark.parametrize("size", (0, 1, 31, 32, 1000, 100_003))
def test_content_checksum_equals_reference(size):
    d = _data(size, seed=21)
    assert content_checksum(d) == r_checksum(d)
    assert content_checksum(np.frombuffer(d, np.uint8)) == r_checksum(d)


# ---------------------------------------------------------------------------
# the planner's header probe
# ---------------------------------------------------------------------------


def _mixed_batch():
    recs = [_data(6000, seed=s) for s in range(4)]
    frames = [renc.compress(r, lv) for r, lv in zip(recs, (1, 5, 9, 19))]
    frames += [f for _, f in _SPECIAL if _ != "multiframe"]
    frames.append(renc.compress(_data(600_000), 3))        # multi-block
    frames.append(_frame(9, 400_000)[:40])                 # truncated
    rng = np.random.default_rng(4)
    samples = [bytes(rng.integers(97, 100, 200, dtype=np.uint8))
               for _ in range(100)]
    d = zstandard.train_dictionary(2048, samples)
    frames.append(zstandard.ZstdCompressor(level=3, dict_data=d).compress(
        samples[0] * 4))                                   # dictionary
    return frames


@pytest.mark.parametrize("single_block_only", (False, True))
def test_scan_eligibility_equals_reference(single_block_only):
    frames = _mixed_batch()
    got = dp.scan_eligibility(frames, single_block_only=single_block_only)
    assert got == rdp.scan_eligibility(frames,
                                       single_block_only=single_block_only)
    assert got  # the batch holds host-routed frames


def test_lit_header_and_buckets_equal_reference():
    for f in [_frame(lv, 4096) for lv in LEVELS] + [f for _, f in _SPECIAL]:
        hdr = frame.parse_frame_header(np.frombuffer(f, np.uint8))
        p = hdr.header_size + 3
        assert dp._parse_lit_header(f[p:p + 5]) == rdp._parse_lit_header(
            f[p:p + 5])
    for name in ("EXEC_LANES", "MB_CONTENT_CAP", "MB_WINDOW_CAP",
                 "_O_BUCKETS", "_S_BUCKETS", "_MBC_BUCKETS", "_MBW_BUCKETS",
                 "_NATIVE_ROUTE"):
        assert getattr(dp, name) == getattr(rdp, name)
    for v in (1, 256, 257, 4096, 30_000, 1 << 22):
        assert dp._bucket(v, dp._MBW_BUCKETS) == rdp._bucket(
            v, rdp._MBW_BUCKETS)
    mb = [{"window": w, "content": c, "frame_idx": i}
          for i, (w, c) in enumerate([(1 << 15, 300_000), (1 << 17, 300_000),
                                      (1 << 15, 300_000)] * 7)]
    assert dp._mb_groups(mb) == rdp._mb_groups(mb)


# ---------------------------------------------------------------------------
# FSE and Huffman tables
# ---------------------------------------------------------------------------


def _counts(seed: int, n_sym: int, total: int) -> np.ndarray:
    r = np.random.default_rng(seed)
    p = r.dirichlet(np.full(n_sym, 0.3))
    c = r.multinomial(total, p).astype(np.int64)
    if (c > 0).sum() < 2:
        c[:2] += 1
    return c


_FSE_CASES = [(s, n, t, tl) for s, (n, t, tl) in enumerate(
    [(36, 500, 9), (53, 2000, 9), (29, 120, 8), (13, 40, 6), (256, 5000, 11),
     (5, 33, 5), (36, 100_000, 9), (53, 90, 7)])]


@pytest.mark.parametrize("seed,n_sym,total,tlog", _FSE_CASES)
def test_fse_tables_equal_reference(seed, n_sym, total, tlog):
    c = _counts(seed, n_sym, total)
    total = int(c.sum())
    max_sym = int(np.nonzero(c)[0][-1])
    tlog = max(tlog, fse.min_table_log(total, max_sym))
    tlog = min(tlog, 12)
    assert fse.optimal_table_log(tlog, total, max_sym) == \
        rfse.optimal_table_log(tlog, total, max_sym)
    for low in (False, True):
        norm = fse.normalize_count(c[:max_sym + 1], tlog, total, max_sym, low)
        rnorm = rfse.normalize_count(c[:max_sym + 1], tlog, total, max_sym,
                                     low)
        assert norm.dtype == rnorm.dtype and np.array_equal(norm, rnorm)
        hdr = fse.write_ncount(norm, max_sym, tlog)
        assert hdr == rfse.write_ncount(rnorm, max_sym, tlog)
        ct, rct = fse.build_ctable(norm, max_sym, tlog), rfse.build_ctable(
            rnorm, max_sym, tlog)
        for f in ("table_log", "max_symbol"):
            assert getattr(ct, f) == getattr(rct, f)
        for f in ("state_table", "delta_nb_bits", "delta_find_state", "norm"):
            assert np.array_equal(getattr(ct, f), getattr(rct, f))
        got = fse.read_ncount(hdr + b"\x00\x00", max_sym, tlog)
        want = rfse.read_ncount(hdr + b"\x00\x00", max_sym, tlog)
        assert np.array_equal(got[0], want[0]) and got[1:] == want[1:]
        dt = fse.build_dtable(got[0], got[1], got[2])
        rdt = rfse.build_dtable(want[0], want[1], want[2])
        for f in ("symbol", "nb_bits", "new_state"):
            assert np.array_equal(getattr(dt, f), getattr(rdt, f))


@pytest.mark.parametrize("seed,n_sym,total", [
    (1, 256, 20_000), (2, 40, 300), (3, 128, 1_000), (4, 200, 131_072),
    (5, 3, 10), (6, 256, 600), (7, 90, 50_000)])
def test_huffman_tables_equal_reference(seed, n_sym, total):
    c = _counts(seed + 100, n_sym, total)
    max_sym = int(np.nonzero(c)[0][-1])
    ct = huffman.build_ctable(c, max_sym, 11)
    rct = rhuf.build_ctable(c, max_sym, 11)
    assert (ct.table_log, ct.max_symbol) == (rct.table_log, rct.max_symbol)
    assert np.array_equal(ct.nb_bits, rct.nb_bits)
    assert np.array_equal(ct.code, rct.code)
    desc = huffman.write_ctable(ct)
    assert desc == rhuf.write_ctable(rct)
    w, tlog, n = huffman.read_weights(desc + b"\x00" * 8)
    rw, rtlog, rn = rhuf.read_weights(desc + b"\x00" * 8)
    assert np.array_equal(w, rw) and (tlog, n) == (rtlog, rn)
    dt, rdt = huffman.build_dtable(w, tlog), rhuf.build_dtable(rw, rtlog)
    assert np.array_equal(dt.symbol, rdt.symbol)
    assert np.array_equal(dt.nb_bits, rdt.nb_bits)


# ---------------------------------------------------------------------------
# block decoders on blocks taken from real frames
# ---------------------------------------------------------------------------


def _compressed_blocks(f: bytes):
    """Every compressed block body of a frame."""
    hdr = rframe.parse_frame_header(np.frombuffer(f, np.uint8))
    p, out = hdr.header_size, []
    while True:
        bh = int.from_bytes(f[p:p + 3], "little")
        btype, bsize = (bh >> 1) & 3, bh >> 3
        if btype == 2:
            out.append(f[p + 3:p + 3 + bsize])
        p += 3 + (1 if btype == 1 else bsize)
        if bh & 1:
            return out


_BLOCK_FRAMES = [(lv, n) for lv in LEVELS for n in (4096, 400_000)] + [
    (3, 1000), (19, 255)]


@pytest.mark.parametrize("level,size", _BLOCK_FRAMES)
def test_block_decoders_equal_reference(level, size):
    blocks = _compressed_blocks(_frame(level, size))
    assert blocks
    ent, rent = block.EntropyState(), rblock.EntropyState()
    for body in blocks:
        lits, n = block.decode_literals(body, ent)
        rlits, rn = rblock.decode_literals(body, rent)
        assert n == rn and np.array_equal(lits, rlits)
        got = block.decode_sequence_headers(body[n:], ent)
        want = rblock.decode_sequence_headers(body[rn:], rent)
        assert got[0] == want[0] and got[4] == want[4]
        if got[0] == 0:
            continue
        for dt, rdt in zip(got[1:4], want[1:4]):
            assert dt.table_log == rdt.table_log
            for f in ("symbol", "nb_bits", "new_state", "base_value",
                      "nb_add_bits"):
                assert np.array_equal(getattr(dt, f), getattr(rdt, f))
        seqs = block.decode_sequences(body[n + got[4]:], got[0], *got[1:4],
                                      ent.rep)
        rseqs = rblock.decode_sequences(body[rn + want[4]:], want[0],
                                        *want[1:4], rent.rep)
        assert all(np.array_equal(a, b) for a, b in zip(seqs, rseqs))
        assert list(ent.rep) == list(rent.rep)


def _few_matches(k: int, seed: int) -> bytes:
    """Seeded noise with one 12-byte segment repeated k times."""
    r = np.random.default_rng(seed)
    seg = r.integers(0, 256, 12, dtype=np.uint8).tobytes()
    return b"".join(r.integers(0, 256, 5, dtype=np.uint8).tobytes() + seg
                    for _ in range(k)) + b"tail"


@pytest.mark.parametrize("nb_seq", (1, 5, 8))
def test_short_sequence_sections_equal_reference(nb_seq):
    """Sections of <= 8 sequences take the pure-Python loop in both."""
    for level in (1, 9, 19):
        for k in range(1, 3 * nb_seq + 4):
            body = _compressed_blocks(renc.compress(_few_matches(k, k),
                                                    level))
            if not body:
                continue
            ent, rent = block.EntropyState(), rblock.EntropyState()
            _, n = block.decode_literals(body[0], ent)
            rblock.decode_literals(body[0], rent)
            got = block.decode_sequence_headers(body[0][n:], ent)
            want = rblock.decode_sequence_headers(body[0][n:], rent)
            if got[0] != nb_seq:
                continue
            a = block.decode_sequences(body[0][n + got[4]:], got[0],
                                       *got[1:4], ent.rep)
            b = rblock.decode_sequences(body[0][n + want[4]:], want[0],
                                        *want[1:4], rent.rep)
            assert all(np.array_equal(x, y) for x, y in zip(a, b))
            assert list(ent.rep) == list(rent.rep)
            return
    pytest.fail(f"no seeded block with {nb_seq} sequences")


# ---------------------------------------------------------------------------
# dictionaries
# ---------------------------------------------------------------------------


def _trained_dict() -> bytes:
    rng = np.random.default_rng(64)
    words = [b"unwrap ", b"many ", b"device ", b"dict ", b"frame "]
    samples = [b"".join(words[int(i)] for i in rng.integers(0, 5, 30))
               for _ in range(200)]
    return zstandard.train_dictionary(4096, samples).as_bytes()


_DICT = _trained_dict()


def _dict_sections(d: bytes) -> dict:
    """Where each section of a dictionary starts and ends, by the
    reference's readers: {name: (start, end)}."""
    pos, out = 8, {}
    n = rhuf.read_weights(d[pos:])[2]
    out["huffman"] = (pos, pos + n)
    pos += n
    for name, max_sym, max_log in (("of", RC.MAX_OFF, RC.OF_FSE_LOG),
                                   ("ml", RC.MAX_ML, RC.ML_FSE_LOG),
                                   ("ll", RC.MAX_LL, RC.LL_FSE_LOG)):
        n = rfse.read_ncount(d[pos:], max_sym, max_log)[3]
        out[name] = (pos, pos + n)
        pos += n
    out["repcodes"] = (pos, pos + 12)
    return out


@pytest.mark.parametrize("kind", ["trained", "raw_content", "short"])
def test_parse_dictionary_equals_reference(kind):
    data = {"trained": _DICT,
            "raw_content": _data(3000, seed=65),
            "short": b"\x37\xa4\x30\xec\x01"}[kind]
    got, want = dictionary.parse_dictionary(data), rdict.parse_dictionary(data)
    assert got.dict_id == want.dict_id
    assert got.raw == want.raw == data
    assert got.content.tobytes() == want.content.tobytes()
    if kind != "trained":
        assert got.dict_id == 0 and got.entropy is None is want.entropy
        return
    assert got.dict_id != 0
    assert list(got.entropy.rep) == list(want.entropy.rep)
    assert np.array_equal(got.entropy.huf.symbol, want.entropy.huf.symbol)
    assert np.array_equal(got.entropy.huf.nb_bits, want.entropy.huf.nb_bits)
    for t in ("of", "ml", "ll"):
        dt, rdt = getattr(got.entropy, t), getattr(want.entropy, t)
        assert dt.table_log == rdt.table_log
        for f in ("symbol", "nb_bits", "new_state", "base_value",
                  "nb_add_bits"):
            assert np.array_equal(getattr(dt, f), getattr(rdt, f)), (t, f)


def _broken_dicts():
    """(name, bytes): the trained dictionary cut one byte into and halfway
    through each section, and with a zero repcode."""
    out = []
    for name, (a, b) in _dict_sections(_DICT).items():
        out += [(f"{name}_cut_start", _DICT[:a + 1]),
                (f"{name}_cut_mid", _DICT[:(a + b) // 2])]
    rp = _dict_sections(_DICT)["repcodes"][0]
    out.append(("zero_repcode", _DICT[:rp + 4] + bytes(4) + _DICT[rp + 8:]))
    return out


_BROKEN = _broken_dicts()


@pytest.mark.parametrize("name,data", _BROKEN, ids=[n for n, _ in _BROKEN])
def test_load_dictionary_raises_as_reference(name, data):
    with pytest.raises(RZstdError) as ref:
        rframe.Decompressor().load_dictionary(data)
    dec = frame.Decompressor()
    with pytest.raises(ZstdError) as mine:
        dec.load_dictionary(data)
    assert mine.value.code.name == ref.value.code.name
    assert int(mine.value.code) == int(ref.value.code)
    assert dec._dict is None


def test_load_dictionary_keeps_parsed_and_none_drops():
    dec = frame.Decompressor()
    dec.load_dictionary(_DICT)
    assert isinstance(dec._dict, dictionary.ZstdCompressionDict)
    assert isinstance(dec._dict._parsed, dictionary.ParsedDict)
    assert dec._dict.dict_id == rdict.parse_dictionary(_DICT).dict_id
    dec.load_dictionary(None)
    assert dec._dict is None


# ---------------------------------------------------------------------------
# the host route with a dictionary
# ---------------------------------------------------------------------------


def _dict_records(n: int, seed: int) -> list[bytes]:
    """Records in the trained dictionary's vocabulary."""
    rng = np.random.default_rng(seed)
    words = [b"unwrap ", b"many ", b"device ", b"dict ", b"frame "]
    return [b"".join(words[int(i)] for i in rng.integers(0, 5, m))
            for m in rng.integers(5, 400, n)]


def _dict_frames():
    """(name, frame, record): the trained dictionary's frames at several
    levels, with a checksum, without a content size, without the ID, a
    plain frame, and a raw-content dictionary's frame."""
    zd = zstandard.ZstdCompressionDict(_DICT)
    recs = _dict_records(8, 66)
    out = [(f"level{lv}", zstandard.ZstdCompressor(
        level=lv, dict_data=zd).compress(r), r)
        for lv, r in zip((1, 3, 9, 19), recs)]
    for name, kw, r in (("checksum", dict(write_checksum=True), recs[4]),
                        ("no_size", dict(write_content_size=False), recs[5]),
                        ("no_id", dict(write_dict_id=False), recs[6])):
        out.append((name, zstandard.ZstdCompressor(
            level=3, dict_data=zd, **kw).compress(r), r))
    out.append(("plain", zstandard.ZstdCompressor(level=3).compress(recs[7]),
                recs[7]))
    return out


_DICT_FRAMES = _dict_frames()


def _reference_decode(f: bytes, data: bytes):
    pd = rdict.parse_dictionary(data)
    return rframe.FrameDecoder(dict_content=pd.content,
                               dict_entropy=pd.entropy,
                               dict_id=pd.dict_id).decode(f)


@pytest.mark.parametrize("name,f,rec", _DICT_FRAMES,
                         ids=[n for n, _, _ in _DICT_FRAMES])
def test_decode_frame_with_dictionary_equals_reference(name, f, rec):
    content, consumed = _reference_decode(f, _DICT)
    with dictionary.parse_dictionary(_DICT).native() as dd:
        got, n = frame.decode_frame(f, dd)
    assert got.tobytes() == content.tobytes() == rec
    assert n == consumed == len(f)


def test_decode_frame_with_raw_content_dictionary_equals_reference():
    content = _data(20_000, seed=67)
    rec = content[5_000:9_000] + content[:2_000]
    f = zstandard.ZstdCompressor(level=3, dict_data=zstandard.ZstdCompressionDict(
        content, dict_type=zstandard.DICT_TYPE_RAWCONTENT)).compress(rec)
    want, _ = _reference_decode(f, content)
    with dictionary.parse_dictionary(content).native() as dd:
        assert dd.dict_id == 0 and dd.content_len == len(content)
        assert frame.decode_frame(f, dd)[0].tobytes() == want.tobytes() == rec


def _other_dict_frame() -> bytes:
    rng = np.random.default_rng(68)
    other = zstandard.train_dictionary(2048, [bytes(rng.integers(
        97, 104, 50, dtype=np.uint8)) for _ in range(200)])
    assert other.dict_id() != dictionary.parse_dictionary(_DICT).dict_id
    return zstandard.ZstdCompressor(level=3, dict_data=other).compress(
        b"abcdefg" * 40)


def _flipped_checksum() -> bytes:
    f = bytearray(dict(((n, f) for n, f, _ in _DICT_FRAMES))["checksum"])
    f[-1] ^= 0x01
    return bytes(f)


@pytest.mark.parametrize("case", ["wrong_dictionary", "bad_checksum"])
def test_decode_frame_with_dictionary_raises_as_reference(case):
    f = {"wrong_dictionary": _other_dict_frame,
         "bad_checksum": _flipped_checksum}[case]()
    with pytest.raises(RZstdError) as want:
        _reference_decode(f, _DICT)
    with dictionary.parse_dictionary(_DICT).native() as dd:
        with pytest.raises(ZstdError) as got:
            frame.decode_frame(f, dd)
    assert got.value.code.name == want.value.code.name
    assert int(got.value.code) == int(want.value.code)


def test_native_ddict_decompress_many():
    """One native call for the batch; a frame it cannot serve (no content
    size, another dictionary's ID, a bad checksum) makes it None."""
    frames = [f for n, f, _ in _DICT_FRAMES if n != "no_size"]
    recs = [r for n, _, r in _DICT_FRAMES if n != "no_size"]
    odd = [f for n, f, _ in _DICT_FRAMES if n == "no_size"][0]
    with dictionary.parse_dictionary(_DICT).native() as dd:
        assert dd.decompress_many(frames) == recs
        assert dd.decompress_many([]) == []
        for bad in (odd, _other_dict_frame(), _flipped_checksum()):
            assert dd.decompress_many(frames[:3] + [bad]) is None
        assert dd.decompress_many(frames[3:]) == recs[3:]


def test_native_ddict_closes():
    dd = dictionary.parse_dictionary(_DICT).native()
    body = np.frombuffer(_DICT_FRAMES[0][1], np.uint8)
    with dd:
        pass
    dd.close()  # a second close is harmless
    with pytest.raises(ValueError, match="closed"):
        dd.decode_frame_body(body, 100)
    with pytest.raises(ValueError, match="closed"):
        dd.decompress_many([_DICT_FRAMES[0][1]])


def test_native_ddict_is_safe_across_threads():
    """The handle's entropy scratch is shared: 12 threads decoding frames
    against one NativeDDict, with a short switch interval, must each get
    their records (the lock serialises the native calls).  The 30 KB
    records carry tables of their own, which a frame decoding beside them
    would lose to the scratch's restore without the lock."""
    import sys
    import threading

    zd = zstandard.ZstdCompressionDict(_DICT)
    recs = [_data(30_000, seed=s) for s in range(6)]
    jobs = [(zstandard.ZstdCompressor(level=lv, dict_data=zd).compress(r), r)
            for r, lv in zip(recs, (1, 3, 19, 1, 3, 19))]
    jobs = (jobs + [(f, r) for _, f, r in _DICT_FRAMES]) * 8
    with dictionary.parse_dictionary(_DICT).native() as dd:
        bad, old = [], sys.getswitchinterval()
        sys.setswitchinterval(1e-6)

        def work(k):
            for f, r in jobs[k::12]:
                try:
                    ok = frame.decode_frame(f, dd)[0].tobytes() == r
                except ZstdError:
                    ok = False
                if not ok:
                    bad.append(k)

        try:
            threads = [threading.Thread(target=work, args=(k,))
                       for k in range(12)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
        finally:
            sys.setswitchinterval(old)
        assert not any(t.is_alive() for t in threads)
        assert not bad


def _dict_scan_batch():
    d = rdict.parse_dictionary(_DICT)
    frames = [f for _, f, _ in _DICT_FRAMES] + [_other_dict_frame()]
    frames += [f for _, f in _SPECIAL if _ != "multiframe"]
    frames.append(zstandard.ZstdCompressor(
        level=1, dict_data=zstandard.ZstdCompressionDict(_DICT)).compress(
        _data(300_000)))                                    # multi-block
    assert d.entropy is not None
    return frames


@pytest.mark.parametrize("single_block_only", (False, True))
def test_scan_eligibility_with_dictionary_equals_reference(single_block_only):
    """With the trained dictionary its frames pass; with a raw-content one
    (ID 0, no tables) they route as without a dictionary."""
    frames = _dict_scan_batch()
    plain = dp.scan_eligibility(frames, single_block_only=single_block_only)
    for data in (_DICT, _data(3000, seed=69)):
        got = dp.scan_eligibility(frames, dictionary.parse_dictionary(data),
                                  single_block_only=single_block_only)
        assert got == rdp.scan_eligibility(
            frames, rdict.parse_dictionary(data),
            single_block_only=single_block_only)
        assert (got != plain) == (data is _DICT)


# ---------------------------------------------------------------------------
# the _ztpy extension: built into build/host, never under native/
# ---------------------------------------------------------------------------


def _native_listing():
    return sorted((p.name, p.stat().st_size, p.stat().st_mtime_ns)
                  for p in native.SRC.parent.iterdir())


def _fresh_ext_state(monkeypatch, tmp_path):
    """get_ext as on first use, building into tmp_path."""
    native.get_lib()
    monkeypatch.setattr(native, "_ext", None)
    monkeypatch.setattr(native, "_ext_tried", False)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "host")


def test_extension_builds_into_build_dir(monkeypatch, tmp_path):
    """A first get_ext compiles native/ztpy.cpp against this host's Python
    headers into BUILD_DIR (build/host by default), linked to the engine
    file the ctypes binding loaded; native/ is left as it was.  The
    extension decodes and encodes as the ctypes route does."""
    assert native.BUILD_DIR == native.SRC.parent.parent / "build" / "host"
    before = _native_listing()
    _fresh_ext_state(monkeypatch, tmp_path)
    ext = native.get_ext()
    assert ext is not None and native.host_route() == "ztpy"
    built = native.ext_path(native._lib_file.resolve())
    assert built.parent == tmp_path / "host" and built.exists()
    assert built.name.startswith("_ztpy.") and built.name.endswith(
        __import__("sysconfig").get_config_var("EXT_SUFFIX"))
    assert ext.__file__ == str(built)
    assert _native_listing() == before
    data = _data(50_000)
    f = enc.compress(data, 3)
    assert ext.compress_exact(data, 3, False) == f
    hdr = frame.parse_frame_header(f)
    got, used = ext.decode_frame_body(f, hdr.header_size, len(data))
    assert got == data and hdr.header_size + used == len(f)
    want, _ = native.decode_frame_body(
        np.frombuffer(f, np.uint8)[hdr.header_size:], len(data))
    assert want.tobytes() == got


@pytest.mark.parametrize("case", ["no_ext_env", "no_headers", "build_fails"])
def test_extension_off_falls_back_to_ctypes(case, monkeypatch, tmp_path):
    """ZSTDTPU_NO_EXT, missing Python headers or a failed build: get_ext
    returns None, the route is ctypes and the codec's bytes are the
    reference's."""
    _fresh_ext_state(monkeypatch, tmp_path)
    if case == "no_ext_env":
        monkeypatch.setenv("ZSTDTPU_NO_EXT", "1")
    elif case == "no_headers":
        monkeypatch.setattr(native.sysconfig, "get_paths",
                            lambda: {"include": str(tmp_path)})
    else:
        bad = tmp_path / "ztpy.cpp"
        bad.write_text("this is not C++\n")
        monkeypatch.setattr(native, "EXT_SRC", bad)
    assert native.get_ext() is None and native.host_route() == "ctypes"
    assert not list((tmp_path / "host").glob("_ztpy.*"))
    f = _frame(9, 4096)
    assert frame.decompress(f) == rframe.decompress(f) == _data(4096)
    assert enc.compress(_data(4096), 3) == _frame(3, 4096)
