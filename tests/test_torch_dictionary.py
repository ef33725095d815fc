"""The port's dictionary trainer and loaded dictionaries against the JAX
package's, byte for byte.

``train_dictionary``, ``finalize_dictionary`` and
``optimize_train_from_buffer`` must give the reference's bytes, the
committed set 1 recipe included (tests/torch_data/dict_sets.py: the
dictionary and the 5,000 frames of ``dict_json.npz``);
``ZstdCompressionDict``'s four methods must give its output and raise its
codes; the encode tables a dictionary loads must equal its; and a
dictionary trained and framed by the port must decode on the port's device
plane (on the CPU) into the rows the reference's ``decode_batch_device``
gives.  Inputs are made from numpy seeds.
"""

import sys
from pathlib import Path

import jax  # noqa: F401  (the reference's device plane runs on the CPU)
import numpy as np
import pytest
import torch
import zstandard

import zstdsharp_tpu as R
import zstdsharp_tpu_torch as Z
from zstdsharp_tpu import dictionary as rdict
from zstdsharp_tpu.decode import device_pipeline as rdp
from zstdsharp_tpu.encode import params as rparams
from zstdsharp_tpu.errors import ZstdError as RZstdError
from zstdsharp_tpu_torch import dictionary
from zstdsharp_tpu_torch.encode import params
from zstdsharp_tpu_torch.errors import ZstdError

sys.path.insert(0, str(Path(__file__).resolve().parent / "torch_data"))
import dict_sets  # noqa: E402


def _json(n: int, seed: int) -> list[bytes]:
    r = np.random.default_rng(seed)
    keys = [b"user", b"score", b"tags", b"city", b"active"]
    return [b"{" + b", ".join(
        b'"%s": %d' % (keys[int(k)], int(v))
        for k, v in zip(r.integers(0, 5, 4), r.integers(0, 5000, 4)))
        + b"}" for _ in range(n)]


def _text(n: int, seed: int) -> list[bytes]:
    r = np.random.default_rng(seed)
    words = [b"alpha ", b"bravo ", b"charlie ", b"delta ", b"echo ",
             b"foxtrot "]
    return [b"".join(words[int(i)] for i in r.integers(0, 6, m))
            for m in r.integers(20, 400, n)]


_SETS = {"json": _json(800, 1), "text": _text(400, 2),
         "tiny": [b"ab", b"cd", b"abcd"] * 4,
         "bytes": [np.random.default_rng(3).integers(
             0, 256, 64, dtype=np.uint8).tobytes() for _ in range(100)]}


def _same(port_call, ref_call):
    try:
        want = ref_call()
    except RZstdError as e:
        with pytest.raises(ZstdError) as got:
            port_call()
        assert got.value.code.name == e.code.name
        return None
    got = port_call()
    assert got == want
    return got


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    {"dict_size": 4096}, {"dict_size": 1024, "d": 6},
    {"dict_size": 8192, "level": 9, "dict_id": 77},
    {"dict_size": 2048, "k": 64}, {"dict_size": 512, "level": 1}], ids=str)
@pytest.mark.parametrize("name", sorted(_SETS))
def test_train_dictionary_equals_reference(name, kw):
    samples = _SETS[name]
    _same(lambda: Z.train_dictionary(samples, **kw),
          lambda: R.train_dictionary(samples, **kw))


def test_train_dictionary_errors_equal_reference():
    for samples in ([], [b"abc"], [b""] * 5):
        _same(lambda: Z.train_dictionary(samples, 1024),
              lambda: R.train_dictionary(samples, 1024))


def test_committed_set_one_recipe():
    """The port trains the committed json dictionary and frames the 5,000
    records into the committed frames, as the reference does."""
    d, frames, recs = dict_sets.load("json")
    got = Z.train_dictionary(recs[:1000], dict_sets.JSON_DICT_SIZE)
    assert got == d == R.train_dictionary(recs[:1000],
                                          dict_sets.JSON_DICT_SIZE)
    c = Z.Compressor(level=dict_sets.JSON_LEVEL)
    c.load_dictionary(got)
    assert c.wrap_many(recs) == frames
    dec = Z.Decompressor()
    dec.load_dictionary(got)
    assert dec.unwrap_many(frames) == recs


@pytest.mark.parametrize("level", [1, 3, 19])
@pytest.mark.parametrize("name", ["json", "text"])
def test_finalize_dictionary_equals_reference(name, level):
    samples = _SETS[name]
    content = np.frombuffer(b"".join(samples[:30]), np.uint8)
    got = dictionary.finalize_dictionary(content, samples, 1234, level)
    assert got == rdict.finalize_dictionary(content, samples, 1234, level)
    assert dictionary.parse_dictionary(got).dict_id == 1234


def test_optimize_train_from_buffer_equals_reference():
    samples = _SETS["json"][:300]
    got = dictionary.optimize_train_from_buffer(samples, 2048, steps=2)
    assert got == rdict.optimize_train_from_buffer(samples, 2048, steps=2)
    _same(lambda: dictionary.optimize_train_from_buffer([], 2048),
          lambda: rdict.optimize_train_from_buffer([], 2048))


# ---------------------------------------------------------------------------
# loaded dictionaries
# ---------------------------------------------------------------------------


_TRAINED = R.train_dictionary(_SETS["json"][:400], 4096)
_ZSTD = zstandard.train_dictionary(4096, _SETS["text"]).as_bytes()
_LOADED = {"trained": _TRAINED, "zstandard": _ZSTD,
           "raw": b"".join(_SETS["text"][:20])}


def _ctables(ent):
    if ent is None:
        return None
    out = [ent.huf.table_log, ent.huf.max_symbol, ent.huf.nb_bits.tolist(),
           ent.huf.code.tolist()]
    for t in (ent.ll, ent.of, ent.ml):
        out += [t.table_log, t.max_symbol, t.state_table.tolist(),
                t.delta_nb_bits.tolist(), t.delta_find_state.tolist(),
                t.norm.tolist()]
    return out


@pytest.mark.parametrize("name", sorted(_LOADED))
def test_encoder_tables_equal_reference(name):
    got = dictionary.parse_dictionary(_LOADED[name])
    want = rdict.parse_dictionary(_LOADED[name])
    assert _ctables(got.enc_entropy) == _ctables(want.enc_entropy)
    assert got.dict_id == want.dict_id and got.raw == want.raw


@pytest.mark.parametrize("kw", [
    {}, {"compression_level": 19}, {"compression_level": 1,
                                    "checksum_flag": True},
    {"dict_id_flag": False}, {"compression_level": 5, "ldm": True},
    {"compression_level": 5, "target_cblock_size": 900},
    {"compression_level": -2}, {"content_size_flag": False}], ids=str)
@pytest.mark.parametrize("name", sorted(_LOADED))
def test_compression_dict_methods_equal_reference(name, kw):
    d, rd = (dictionary.ZstdCompressionDict(_LOADED[name]),
             rdict.ZstdCompressionDict(_LOADED[name]))
    assert d.dict_id == rd.dict_id
    assert np.array_equal(d.content, rd.content)
    p, rp = params.CCtxParams(**kw), rparams.CCtxParams(**kw)
    recs = _SETS["json"][400:460] + [b"", _SETS["text"][0] * 40]
    frames = [d.compress_with(r, p) for r in recs]
    assert frames == [rd.compress_with(r, rp) for r in recs]
    many = d.compress_many(recs[:-1], p)
    assert many == rd.compress_many(recs[:-1], rp)
    assert d.last_compress_path == rd.last_compress_path
    assert d.decompress_many(frames) == rd.decompress_many(frames) == recs
    assert d.last_decompress_path == rd.last_decompress_path
    assert [d.decompress_with(f) for f in frames] == recs
    assert d.compress_many([], p) == d.decompress_many([]) == []
    _same(lambda: d.decompress_with(frames[0], max_output_size=3),
          lambda: rd.decompress_with(frames[0], max_output_size=3))
    _same(lambda: d.decompress_many(frames, max_output_size=50),
          lambda: rd.decompress_many(frames, max_output_size=50))
    _same(lambda: d.decompress_with(frames[1] + b"\0"),
          lambda: rd.decompress_with(frames[1] + b"\0"))


@pytest.mark.parametrize("name", ["trained", "zstandard"])
def test_wrong_dictionary_raises_as_reference(name):
    """A frame of one dictionary given to another raises the reference's
    code, one frame at a time and in a batch."""
    other = "zstandard" if name == "trained" else "trained"
    rd_other = rdict.ZstdCompressionDict(_LOADED[other])
    frames = [rd_other.compress_with(r, rparams.CCtxParams())
              for r in _SETS["json"][:5]]
    d, rd = (dictionary.ZstdCompressionDict(_LOADED[name]),
             rdict.ZstdCompressionDict(_LOADED[name]))
    for f in frames[:2]:
        _same(lambda: d.decompress_with(f), lambda: rd.decompress_with(f))
    _same(lambda: d.decompress_many(frames), lambda: rd.decompress_many(frames))
    dec, rdec = Z.Decompressor(), R.Decompressor()
    dec.load_dictionary(_LOADED[name])
    rdec.load_dictionary(_LOADED[name])
    _same(lambda: dec.unwrap(frames[0]), lambda: rdec.unwrap(frames[0]))
    plain = R.compress(_SETS["json"][0] * 30, 3)
    _same(lambda: d.decompress_with(plain), lambda: rd.decompress_with(plain))


def test_shared_dictionary_is_safe_across_threads():
    """One loaded dictionary shared by 12 threads, with a short switch
    interval: its cached CDict and DDict handles keep per-call scratch in
    the engine, so each thread's frames and contents must equal the serial
    ones (every native call holds the handle's lock)."""
    import threading

    d = dictionary.ZstdCompressionDict(_TRAINED)
    p = params.CCtxParams(compression_level=3)
    recs = _SETS["json"][:120] + [r * 20 for r in _SETS["text"][:24]]
    want = [d.compress_with(r, p) for r in recs]
    want_many = [d.compress_many(recs[k::12], p) for k in range(12)]
    bad, old = [], sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def work(k):
        mine = list(range(k, len(recs), 12))
        got = [d.compress_with(recs[i], p) for i in mine]
        batch = d.compress_many([recs[i] for i in mine], p)
        back = d.decompress_many(got)
        if (got != [want[i] for i in mine] or batch != want_many[k]
                or back != [recs[i] for i in mine]):
            bad.append(k)

    try:
        threads = [threading.Thread(target=work, args=(k,))
                   for k in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not bad


def test_native_handles_close():
    """NativeCDict and NativeDStream free their engine handle on close or
    at the end of a ``with`` block; a closed handle raises."""
    from zstdsharp_tpu_torch import native

    body = np.frombuffer(b"abc" * 100, np.uint8)
    cd = native.NativeCDict(_TRAINED, 1, 14, 14, 1, 17, 5)
    assert cd.valid and cd.compress_frame_body(body) is not None
    with cd:
        pass
    cd.close()   # a second close is harmless
    assert not cd.valid
    with pytest.raises(ValueError, match="closed"):
        cd.compress_frame_body(body)
    with pytest.raises(ValueError, match="closed"):
        cd.compress_many([b"abc"], 0)
    with native.NativeDStream() as ds:
        assert ds.valid
    with pytest.raises(ValueError, match="closed"):
        ds.drain(b"", np.zeros(16, np.uint8), 0)


def test_port_trained_dictionary_decodes_on_the_device_plane():
    """Trained and framed by the port, decoded by the port's device plane
    on the CPU: the rows, lengths and host results equal the reference's
    ``decode_batch_device`` on the same frames and dictionary."""
    recs = _SETS["json"][:96] + [_SETS["text"][1] * 30]
    d = Z.train_dictionary(_SETS["json"][100:500], 4096)
    c = Z.Compressor(level=3)
    c.load_dictionary(d)
    frames = c.wrap_many(recs)
    dec = Z.Decompressor()
    dec.load_dictionary(d)
    outs, lens, host = dec.unwrap_many_device(frames, "cpu")
    r_outs, r_lens, r_host = rdp.decode_batch_device(
        frames, ddict=rdict.parse_dictionary(d))
    assert np.array_equal(lens, r_lens) and len(outs) == len(r_outs)
    for o, r in zip(outs, r_outs):
        assert o.device == torch.device("cpu")
        assert np.array_equal(o.numpy(), np.asarray(r))
    assert set(host) == set(r_host)
    rows = iter(r[:n].tobytes() for r, n in zip(
        (r for o in outs for r in o.numpy()), lens))
    assert [(host[k] if isinstance(host[k], bytes)
             else host[k].numpy().tobytes()) if k in host else next(rows)
            for k in range(len(frames))] == recs
