"""The port's streams against the JAX package's, byte for byte.

``FrameEncoder`` and ``CompressionStream`` must write the reference's bytes
for one fixed schedule of writes and flushes, with and without a
dictionary (on the engine and on the Python block tier), long-distance
matching and a target block size; ``StreamingDecompressor`` and
``DecompressionStream`` must give the reference's output at feeds of 1, 7
and 65,536 bytes, raise ``EOFError`` on a truncated stream and handle a
skippable frame in mid-stream the same way.  Inputs are made from numpy
seeds.
"""

import io

import numpy as np
import pytest
import zstandard

import zstdsharp_tpu as R
import zstdsharp_tpu_torch as Z
from zstdsharp_tpu.decode import streaming as rstreaming
from zstdsharp_tpu.dictionary import ZstdCompressionDict as RDict
from zstdsharp_tpu.encode import frame as renc
from zstdsharp_tpu.encode import params as rparams
from zstdsharp_tpu.errors import ZstdError as RZstdError
from zstdsharp_tpu_torch.decode import streaming
from zstdsharp_tpu_torch.dictionary import ZstdCompressionDict
from zstdsharp_tpu_torch.encode import frame as enc
from zstdsharp_tpu_torch.encode import params
from zstdsharp_tpu_torch.errors import ZstdError


def _text(n: int, seed: int = 0) -> bytes:
    r = np.random.default_rng(seed)
    words = [b"the quick ", b"brown fox ", b"jumps over ", b"lazy dogs ",
             b"entropy ", b"\n"]
    out = b"".join(words[int(i)] for i in r.integers(0, len(words), n // 6))
    noise = r.integers(0, 256, n // 20, dtype=np.uint8).tobytes()
    return (out[:n // 3] + noise + out[n // 3:] + b"y" * n)[:n]


_SAMPLES = [_text(300, seed=s) for s in range(200)]
_DICT = zstandard.train_dictionary(4096, _SAMPLES).as_bytes()
_DATA = _text(400_000, seed=11)

# (chunk sizes in turn, flush after every this many writes)
_SCHEDULE = ([1, 7, 4096, 65_536, 333], 9)

_CONFIGS = {
    "level3": ({"compression_level": 3}, None),
    "checksum": ({"compression_level": 1, "checksum_flag": True}, None),
    "level19": ({"compression_level": 19}, None),
    "negative": ({"compression_level": -4}, None),
    "dictionary": ({"compression_level": 3}, _DICT),
    "dictionary_checksum": ({"compression_level": 7, "checksum_flag": True},
                            _DICT),
    "ldm": ({"compression_level": 5, "ldm": True, "window_log": 20}, None),
    "target_block": ({"compression_level": 5, "target_cblock_size": 1400},
                     None),
    "no_dict_id": ({"compression_level": 3, "dict_id_flag": False}, _DICT),
}


def _write_schedule(stream, data):
    sizes, every = _SCHEDULE
    pos = k = 0
    while pos < len(data):
        n = sizes[k % len(sizes)]
        stream.write(data[pos:pos + n])
        pos += n
        k += 1
        if k % every == 0:
            stream.flush()


def _stream_bytes(mod, pmod, config):
    kw, d = _CONFIGS[config]
    sink = io.BytesIO()
    cs = mod.CompressionStream(sink, params=pmod.CCtxParams(**kw),
                               dictionary=d)
    _write_schedule(cs, _DATA)
    cs.close()
    return sink.getvalue()


@pytest.mark.parametrize("config", sorted(_CONFIGS))
def test_compression_stream_equals_reference(config):
    got = _stream_bytes(Z, params, config)
    assert got == _stream_bytes(R, rparams, config)
    d = _CONFIGS[config][1]
    dz = zstandard.ZstdDecompressor(
        dict_data=zstandard.ZstdCompressionDict(d) if d else None)
    assert dz.decompress(got, max_output_size=len(_DATA)) == _DATA
    if d is None:
        assert Z.decompress(got) == _DATA


def _encoder_pieces(fmod, pmod, dmod, config, python_tier):
    """FrameEncoder fed and flushed in turn: every piece it returns, its
    progression and pending count.  `python_tier` gives the dictionary
    without its raw bytes, which keeps the Python block tier."""
    kw, d = _CONFIGS[config]
    dict_kw = {}
    if d is not None:
        p = dmod(d)._parsed
        dict_kw = dict(dict_id=p.dict_id, dict_content=p.content,
                       dict_reps=p.entropy.rep, dict_entropy=p.enc_entropy,
                       dict_raw=None if python_tier else p.raw)
    e = fmod.FrameEncoder(pmod.CCtxParams(**kw).resolve(
        -1, len(dict_kw.get("dict_content", ()))), **dict_kw)
    assert (e._nstream is None) == python_tier
    data = _DATA[:150_000]
    pieces, sizes = [], _SCHEDULE[0]
    pos = k = 0
    while pos < len(data):
        n = sizes[k % len(sizes)] * 3
        pieces.append(e.feed(data[pos:pos + n]))
        pos += n
        k += 1
        if k % 4 == 0:
            pieces.append(e.flush())
            pieces.append((e.progression, e.to_flush_now()))
    pieces.append(e.finish())
    pieces.append(e.flush())   # a finished frame flushes nothing
    return pieces


@pytest.mark.parametrize("config,python_tier", [
    ("level3", False), ("checksum", False), ("dictionary", False),
    ("dictionary", True), ("dictionary_checksum", True), ("level19", False)])
def test_frame_encoder_equals_reference(config, python_tier):
    got = _encoder_pieces(enc, params, ZstdCompressionDict, config,
                          python_tier)
    want = _encoder_pieces(renc, rparams, RDict, config, python_tier)
    assert got == want
    frame = b"".join(p for p in got if isinstance(p, bytes))
    dz = zstandard.ZstdDecompressor(dict_data=zstandard.ZstdCompressionDict(
        _DICT) if _CONFIGS[config][1] else None)
    assert dz.decompress(frame, max_output_size=1 << 20) == _DATA[:150_000]


def test_stream_parameter_whitelist_equals_reference():
    """Mid-frame, only the ZSTD_isUpdateAuthorized:724 names may change."""
    outcomes = []
    for mod, pmod, err in ((Z, params, ZstdError), (R, rparams, RZstdError)):
        p = pmod.CCtxParams(compression_level=1)
        cs = mod.CompressionStream(io.BytesIO(), params=p)
        cs.write(b"some data")
        got = []
        for name, value in (("compression_level", 3), ("target_length", 64),
                            ("window_log", 20), ("checksum_flag", 1),
                            ("strategy", 2)):
            try:
                p.set_parameter(name, value)
                got.append(None)
            except err as e:
                got.append(e.code.name)
        cs.close()
        p.set_parameter("window_log", 20)
        with pytest.raises(err):
            cs.write(b"after close")
        outcomes.append(got)
    assert outcomes[0] == outcomes[1] == [None, None, "stage_wrong",
                                          "stage_wrong", None]


# ---------------------------------------------------------------------------
# decompression
# ---------------------------------------------------------------------------


def _decode_streams():
    plain = R.compress(_DATA[:200_000], 3)
    cks = R.compress(_DATA[:100_000], 9, checksum=True)
    sizeless = zstandard.ZstdCompressor(
        level=1, write_content_size=False, write_checksum=True).compress(
            _DATA[:300_000])
    skip = renc.write_skippable_frame(b"meta" * 10, 2)
    zd = zstandard.ZstdCompressionDict(_DICT)
    dframe = zstandard.ZstdCompressor(level=3, dict_data=zd).compress(
        _DATA[:50_000])
    return {
        "plain": (plain, None), "checksum": (cks, None),
        "sizeless": (sizeless, None),
        "multi_skippable": (plain + skip + cks + skip, None),
        "skippable_first": (skip + cks, None),
        "dictionary": (dframe + dframe, _DICT),
    }


_STREAMS = _decode_streams()


def _feed_all(mod, kind, src, d, chunk):
    kw = {}
    if d is not None:
        p = (ZstdCompressionDict if mod is streaming else RDict)(d)._parsed
        kw = dict(dict_content=p.content, dict_entropy=p.entropy,
                  dict_id=p.dict_id)
    dec = mod.StreamingDecompressor(**kw)
    out = []
    for i in range(0, len(src), chunk):
        out.append(bytes(dec.feed(src[i:i + chunk])))
    return b"".join(out), dec.finished, dec.pending_input


@pytest.mark.parametrize("chunk", [1, 7, 65_536])
@pytest.mark.parametrize("kind", sorted(_STREAMS))
def test_streaming_decompressor_equals_reference(kind, chunk):
    src, d = _STREAMS[kind]
    if chunk == 1 and len(src) > 60_000:
        src = src[:60_000]   # a prefix: feeds of one byte are slow
    got = _feed_all(streaming, kind, src, d, chunk)
    assert got == _feed_all(rstreaming, kind, src, d, chunk)
    if len(src) == len(_STREAMS[kind][0]) and d is None:
        assert got[0] == R.decompress(src)


def _read_stream(mod, src, d, sizes):
    s = mod.DecompressionStream(io.BytesIO(src), dictionary=d,
                                read_chunk=sizes[0])
    out, k = [], 0
    while True:
        b = s.read(sizes[k % len(sizes)])
        k += 1
        if not b:
            break
        out.append(b)
    return b"".join(out)


@pytest.mark.parametrize("sizes", [(7, 65_536), (65_536,), (1, 7)],
                         ids=str)
@pytest.mark.parametrize("kind", sorted(_STREAMS))
def test_decompression_stream_equals_reference(kind, sizes):
    src, d = _STREAMS[kind]
    if sizes[0] == 1:
        src = src[:30_000] if d is None else src
    try:
        want = _read_stream(R, src, d, sizes)
    except EOFError:
        with pytest.raises(EOFError):
            _read_stream(Z, src, d, sizes)
        return
    assert _read_stream(Z, src, d, sizes) == want
    assert (Z.DecompressionStream(io.BytesIO(src), dictionary=d).readall()
            == want)


@pytest.mark.parametrize("cut", [1, 4, 5, 13, 1000, -4, -1])
def test_truncated_stream_raises_eof_as_reference(cut):
    src = _STREAMS["checksum"][0]
    src = src[:cut] if cut > 0 else src[:cut]
    for mod in (R, Z):
        with pytest.raises(EOFError):
            mod.DecompressionStream(io.BytesIO(src)).read(-1)


@pytest.mark.parametrize("case", ["bad_checksum", "wrong_dictionary",
                                  "window", "reserved_block"])
def test_stream_errors_equal_reference(case):
    src, d = _STREAMS["checksum"][0], None
    kw = {}
    if case == "bad_checksum":
        src = src[:-1] + bytes([src[-1] ^ 1])
    elif case == "wrong_dictionary":
        other = zstandard.train_dictionary(
            2048, [_text(200, seed=s + 500) for s in range(100)])
        src = zstandard.ZstdCompressor(level=3, dict_data=other).compress(
            _DATA[:5000])
        d = _DICT
    elif case == "window":
        src = zstandard.ZstdCompressor(
            level=19, write_content_size=False).compress(_DATA)
        kw = {"max_window_log": 10}
    else:   # an empty frame whose last block has the reserved type
        src = R.compress(b"", 1)[:-3] + bytes([0x07, 0, 0])
    codes = []
    for mod, err in ((R, RZstdError), (Z, ZstdError)):
        with pytest.raises(err) as e:
            mod.DecompressionStream(io.BytesIO(src), dictionary=d,
                                    **kw).read(-1)
        codes.append((e.value.code.name, int(e.value.code)))
    assert codes[0] == codes[1]


def test_no_forward_progress_guard_as_reference():
    for mod, err in ((rstreaming, RZstdError), (streaming, ZstdError)):
        d = mod.StreamingDecompressor()
        d.feed(b"\x28\xb5\x2f\xfd")
        with pytest.raises(err) as e:
            for _ in range(20):
                d.feed(b"")
        assert e.value.code.name == "noForwardProgress_inputEmpty"
