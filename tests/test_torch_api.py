"""The port's public API against the JAX package's, byte for byte.

``import zstdsharp_tpu_torch as z`` in place of ``zstdsharp_tpu`` must give
the same bytes and raise the same ``ZstdErrorCode``s: one-shot compress at
every level class and parameter override, ``n_workers``, every method of
``Compressor`` and ``Decompressor``, the set-time parameter bounds, frame
introspection and skippable frames, the trace hooks and the external
sequence API.  Every input is made from a numpy seed.  The four device
entry points of the port run on the card by default and raise without
one.
"""

import dataclasses

import numpy as np
import pytest
import zstandard

import zstdsharp_tpu as R
import zstdsharp_tpu_torch as Z
from zstdsharp_tpu.decode import frame as rframe
from zstdsharp_tpu.encode import frame as renc
from zstdsharp_tpu.encode import params as rparams
from zstdsharp_tpu.encode import sequences_api as rseq
from zstdsharp_tpu.errors import ZstdError as RZstdError
from zstdsharp_tpu.utils import trace as rtrace
from zstdsharp_tpu_torch.decode import frame
from zstdsharp_tpu_torch.encode import frame as enc
from zstdsharp_tpu_torch.encode import params
from zstdsharp_tpu_torch.encode import sequences_api as seq
from zstdsharp_tpu_torch.errors import ZstdError
from zstdsharp_tpu_torch.utils import trace


def _text(n: int, seed: int = 0) -> bytes:
    """Seeded compressible text with a stretch of noise."""
    r = np.random.default_rng(seed)
    words = [b"the ", b"quick ", b"brown ", b"fox ", b"entropy ", b"frame ",
             b"block ", b"stream ", b"zstd ", b"\n"]
    out = b"".join(words[int(i)] for i in r.integers(0, len(words), n // 4))
    noise = r.integers(0, 256, n // 16, dtype=np.uint8).tobytes()
    return (out[:n // 2] + noise + out[n // 2:] + b"x" * n)[:n]


def _same(port_call, ref_call):
    """Both calls return equal values, or both raise ZstdError with the
    same code.  Returns the value (None when both raised)."""
    try:
        want = ref_call()
    except RZstdError as e:
        with pytest.raises(ZstdError) as got:
            port_call()
        assert got.value.code.name == e.code.name
        assert int(got.value.code) == int(e.code)
        return None
    got = port_call()
    assert got == want
    return got


# ---------------------------------------------------------------------------
# the package surface
# ---------------------------------------------------------------------------


def test_package_surface_equals_reference():
    assert Z.__all__ == R.__all__
    assert Z.__version__ == R.__version__
    for name in Z.__all__ + ["frame_info", "decompress_bound"]:
        assert callable(getattr(Z, name)) or name == "__version__", name
    with pytest.raises(AttributeError):
        Z.no_such_name  # noqa: B018
    data = _text(5000)
    assert Z.compress(data, level=5) == R.compress(data, level=5)
    assert Z.compress_bound(1000) == R.compress_bound(1000)


# ---------------------------------------------------------------------------
# one-shot compress and decompress
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("size", [0, 100, 5000, 200_000])
@pytest.mark.parametrize("level", [-5, 1, 3, 9, 19])
def test_compress_levels_equal_reference(level, size):
    data = _text(size, seed=size)
    for checksum in (False, True):
        f = _same(lambda: Z.compress(data, level, checksum),
                  lambda: R.compress(data, level, checksum))
        assert Z.decompress(f) == R.decompress(f) == data


_OVERRIDES = [
    {"window_log": 17}, {"hash_log": 12}, {"chain_log": 12},
    {"search_log": 2}, {"min_match": 6}, {"target_length": 64},
    {"strategy": 1}, {"strategy": 2}, {"strategy": 4}, {"strategy": 5},
    {"strategy": 7}, {"strategy": 9},
    {"compression_level": 5, "ldm": True, "window_log": 20},
    {"compression_level": 19, "ldm": False},
    {"block_splitter": False}, {"compression_level": 19,
                                "block_splitter": False},
    {"block_splitter": True}, {"target_cblock_size": 1400},
    {"checksum_flag": True}, {"content_size_flag": False},
    {"compression_level": -3, "checksum_flag": True},
    {"n_workers": 3}, {"compression_level": 9, "n_workers": 2,
                       "checksum_flag": True},
]


@pytest.mark.parametrize("kw", _OVERRIDES,
                         ids=["-".join(f"{k}={v}" for k, v in kw.items())
                              for kw in _OVERRIDES])
def test_compress_params_equal_reference(kw):
    data = _text(300_000, seed=1)
    kw = {"compression_level": 3, **kw}
    f = _same(lambda: Z.compress(data, params=params.CCtxParams(**kw)),
              lambda: R.compress(data, params=rparams.CCtxParams(**kw)))
    assert Z.decompress(f) == data
    parts, pos = [], 0
    while pos < len(f):   # libzstd, frame by frame
        n = frame.find_frame_compressed_size(f[pos:])
        parts.append(zstandard.ZstdDecompressor().decompress(
            f[pos:pos + n], max_output_size=len(data)))
        pos += n
    assert b"".join(parts) == data


def _frames_for_decode():
    data = _text(300_000, seed=2)
    plain = R.compress(data, 3)
    cks = R.compress(data, 5, checksum=True)
    bad = bytearray(cks)
    bad[-1] ^= 1
    wide = zstandard.ZstdCompressor(
        level=3, write_content_size=False).compress(data)
    multi = (R.compress(data[:1000], 1) + renc.write_skippable_frame(b"m", 3)
             + cks)
    return data, {"plain": plain, "checksum": cks, "bad_checksum": bytes(bad),
                  "no_size": wide, "multi": multi,
                  "truncated": plain[:-5], "empty": b"", "tiny": b"\x28\xb5"}


_DATA, _DFRAMES = _frames_for_decode()


@pytest.mark.parametrize("opts", [
    {}, {"max_output_size": 1000}, {"max_output_size": 400_000},
    {"max_window_log": 10}, {"verify_checksum": False}, {"n_workers": 3},
    {"n_workers": 2, "max_output_size": 1000}], ids=str)
@pytest.mark.parametrize("name", sorted(_DFRAMES))
def test_decompress_options_equal_reference(name, opts):
    f = _DFRAMES[name]
    _same(lambda: Z.decompress(f, **opts), lambda: R.decompress(f, **opts))


def test_multiframe_workers_round_trip():
    """compress(n_workers=) splits into frames that decompress(n_workers=)
    decodes in parallel, as the reference's."""
    data = _text(700_000, seed=3)
    p, rp = (params.CCtxParams(compression_level=3, n_workers=4),
             rparams.CCtxParams(compression_level=3, n_workers=4))
    f = _same(lambda: Z.compress(data, params=p),
              lambda: R.compress(data, params=rp))
    assert Z.decompress(f, n_workers=4) == data
    n = frame.find_frame_compressed_size(f)
    assert 0 < n < len(f)


# ---------------------------------------------------------------------------
# the host codec's two routes: the _ztpy extension and ctypes
# ---------------------------------------------------------------------------


def _use_route(monkeypatch, route):
    """Run the test through `route`: "ztpy" needs the extension built here
    (this host has Python's headers); "ctypes" forces it off."""
    from zstdsharp_tpu_torch import native

    if route == "ctypes":
        monkeypatch.setattr(native, "get_ext", lambda: None)
    assert native.host_route() == route


def _corrupt_frames():
    """Truncated and bit-flipped bodies of _DFRAMES' frames (seeded)."""
    r = np.random.default_rng(12)
    out = {}
    for name in ("plain", "checksum"):
        f = _DFRAMES[name]
        out[f"{name}_cut_header"] = f[:8]
        out[f"{name}_cut_half"] = f[:len(f) // 2]
        for k, pos in enumerate(r.integers(10, len(f) - 5, 6)):
            g = bytearray(f)
            g[int(pos)] ^= 1 << int(r.integers(0, 8))
            out[f"{name}_flip{k}"] = bytes(g)
    return out


_ROUTE_FRAMES = {**_DFRAMES, **_corrupt_frames()}


@pytest.mark.parametrize("route", ["ztpy", "ctypes"])
@pytest.mark.parametrize("name", sorted(_ROUTE_FRAMES))
def test_decompress_routes_equal_reference(route, name, monkeypatch):
    """decompress through either route: the reference's bytes (as bytes)
    or its ZstdErrorCode, on valid, truncated and corrupt frames."""
    _use_route(monkeypatch, route)
    f = _ROUTE_FRAMES[name]
    got = _same(lambda: Z.decompress(f), lambda: R.decompress(f))
    assert got is None or type(got) is bytes


@pytest.mark.parametrize("route", ["ztpy", "ctypes"])
@pytest.mark.parametrize("level", [-5, 1, 3, 9, 19])
def test_compress_routes_equal_reference(route, level, monkeypatch):
    """compress through either route (the exact encoder's levels 1, 3 and
    19 reach compress_exact) gives the reference's frames."""
    _use_route(monkeypatch, route)
    for size in (0, 100, 5000, 200_000):
        data = _text(size, seed=size)
        for checksum in (False, True):
            f = _same(lambda: Z.compress(data, level, checksum),
                      lambda: R.compress(data, level, checksum))
            assert type(f) is bytes and Z.decompress(f) == data


# ---------------------------------------------------------------------------
# Compressor and Decompressor
# ---------------------------------------------------------------------------


def _dict_samples(seed=5):
    r = np.random.default_rng(seed)
    return [b'{"id": %d, "tag": "%s", "v": %d}' % (
        i, b"abcdefgh"[int(r.integers(0, 8)):][:1] * 3,
        int(r.integers(0, 999)))
        for i in range(600)]


_SAMPLES = _dict_samples()
_TRAINED = R.train_dictionary(_SAMPLES[:300], 2048)
_DICTS = {None: None, "trained": _TRAINED, "raw": b"".join(_SAMPLES[:40])}


@pytest.mark.parametrize("which", list(_DICTS), ids=str)
def test_compressor_methods_equal_reference(which):
    d = _DICTS[which]
    c, rc = Z.Compressor(level=5), R.Compressor(level=5)
    assert c.level == rc.level == 5
    c.level = rc.level = 3
    if d is not None:
        c.load_dictionary(d)
        rc.load_dictionary(d)
    recs = _SAMPLES[300:400] + [_text(20_000, seed=4), b"", b"z"]
    assert c.get_compress_bound(5000) == rc.get_compress_bound(5000)
    assert [c.wrap(r) for r in recs] == [rc.wrap(r) for r in recs]
    assert c.compress(recs[0]) == rc.compress(recs[0])
    assert c.wrap_many(recs[:99]) == rc.wrap_many(recs[:99])
    assert c.wrap_many(recs) == rc.wrap_many(recs)   # the empty record
    assert c.wrap_many([]) == rc.wrap_many([]) == []
    for cap in (5, 1 << 20):
        assert c.try_wrap(recs[0], cap) == rc.try_wrap(recs[0], cap)
    for name, value in (("checksum_flag", True), ("compression_level", 9),
                        ("dict_id_flag", False), ("content_size_flag", False),
                        ("window_log", 18), ("target_cblock_size", 512)):
        c.set_parameter(name, value)
        rc.set_parameter(name, value)
        assert c.get_parameter(name) == rc.get_parameter(name)
        assert c.wrap_many(recs[:20]) == rc.wrap_many(recs[:20])
    _same(lambda: c.get_parameter("nonsense"),
          lambda: rc.get_parameter("nonsense"))
    c.load_dictionary(None)
    rc.load_dictionary(None)
    assert c.wrap(recs[1]) == rc.wrap(recs[1])


@pytest.mark.parametrize("which", list(_DICTS), ids=str)
def test_decompressor_methods_equal_reference(which):
    d = _DICTS[which]
    rc = R.Compressor(level=3)
    if d is not None:
        rc.load_dictionary(d)
    recs = _SAMPLES[400:500] + [_text(200_000, seed=6)]
    frames = rc.wrap_many(recs)
    rc.set_parameter("checksum_flag", True)
    frames.append(rc.wrap(recs[0]))
    dec, rdec = Z.Decompressor(), R.Decompressor()
    if d is not None:
        dec.load_dictionary(d)
        rdec.load_dictionary(d)
    assert dec.unwrap_many(frames) == rdec.unwrap_many(frames) == (
        recs + recs[:1])
    assert [dec.unwrap(f) for f in frames[:5]] == recs[:5]
    assert dec.decompress(frames[0]) == rdec.decompress(frames[0])
    assert dec.get_upper_bound(frames[-2]) == rdec.get_upper_bound(
        frames[-2])
    assert dec.unwrap_many([]) == []
    for cap in (10, 300_000):
        _same(lambda: dec.try_unwrap(frames[-2], cap),
              lambda: rdec.try_unwrap(frames[-2], cap))
        _same(lambda: dec.unwrap_many(frames, cap),
              lambda: rdec.unwrap_many(frames, cap))
    bad = bytearray(frames[-1])
    bad[-1] ^= 1
    _same(lambda: dec.unwrap(bytes(bad)), lambda: rdec.unwrap(bytes(bad)))
    _same(lambda: dec.unwrap_many(frames[:3] + [bytes(bad)]),
          lambda: rdec.unwrap_many(frames[:3] + [bytes(bad)]))
    for value in (27, 10):
        dec.set_parameter("max_window_log", value)
        rdec.set_parameter("max_window_log", value)
        _same(lambda: dec.unwrap(frames[-2]), lambda: rdec.unwrap(frames[-2]))


def test_load_dictionaries_picks_by_id_as_reference():
    d1 = zstandard.train_dictionary(2048, _SAMPLES[:200]).as_bytes()
    d2 = _TRAINED
    f1 = zstandard.ZstdCompressor(
        dict_data=zstandard.ZstdCompressionDict(d1)).compress(_SAMPLES[500])
    c = R.Compressor(level=3)
    c.load_dictionary(d2)
    f2 = c.wrap(_SAMPLES[501])
    f0 = R.compress(_SAMPLES[502], 3)
    dec, rdec = Z.Decompressor(), R.Decompressor()
    dec.load_dictionaries([d1, d2])
    rdec.load_dictionaries([d1, d2])
    assert dec.unwrap(f1) == rdec.unwrap(f1) == _SAMPLES[500]
    assert dec.unwrap(f2) == rdec.unwrap(f2) == _SAMPLES[501]
    _same(lambda: dec.unwrap(f0), lambda: rdec.unwrap(f0))
    raw = b"raw content dictionary without an id" * 4
    _same(lambda: Z.Decompressor().load_dictionaries([d1, raw]),
          lambda: R.Decompressor().load_dictionaries([d1, raw]))


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


def _bound_values(name):
    lo, hi = rparams.PARAM_BOUNDS[name]
    return [lo - 1, lo, hi, hi + 1, hi + 1000, lo - 1000, 0, True, 2.5, None]


@pytest.mark.parametrize("name", sorted(rparams.PARAM_BOUNDS)
                         + ["checksum_flag", "content_size_flag",
                            "dict_id_flag", "ldm", "block_splitter",
                            "no_such_param"])
def test_set_parameter_bounds_equal_reference(name):
    assert params.PARAM_BOUNDS == rparams.PARAM_BOUNDS
    _same(lambda: params.get_parameter_bounds(name),
          lambda: rparams.get_parameter_bounds(name))
    values = (_bound_values(name) if name in rparams.PARAM_BOUNDS
              else [0, 1, 2, True, False, None, -1])
    for v in values:
        c, rc = Z.Compressor(), R.Compressor()
        _same(lambda: c.set_parameter(name, v),
              lambda: rc.set_parameter(name, v))
        assert dataclasses.asdict(c.params) == dataclasses.asdict(rc.params)


@pytest.mark.parametrize("level,hint,dict_size", [
    (3, -1, 0), (3, 1000, 0), (1, 300_000, 0), (19, 1 << 24, 0),
    (19, -1, 4096), (-7, 50_000, 0), (22, 100, 110_000), (0, 0, 0)])
def test_resolve_and_estimates_equal_reference(level, hint, dict_size):
    for kw in ({}, {"window_log": 27}, {"strategy": 8, "hash_log": 16}):
        got = params.CCtxParams(compression_level=level, **kw).resolve(
            hint, dict_size)
        want = rparams.CCtxParams(compression_level=level, **kw).resolve(
            hint, dict_size)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    if level:
        assert (params.estimate_cctx_size(level, hint)
                == rparams.estimate_cctx_size(level, hint))
    assert params.estimate_dctx_size() == rparams.estimate_dctx_size()


@pytest.mark.parametrize("name,value", [
    ("max_window_log", 27), ("max_window_log", 10), ("max_window_log", 9),
    ("max_window_log", 32), ("max_window_log", True),
    ("max_window_log", "27"), ("nonsense", 1)])
def test_decompressor_set_parameter_equal_reference(name, value):
    dec, rdec = Z.Decompressor(), R.Decompressor()
    _same(lambda: dec.set_parameter(name, value),
          lambda: rdec.set_parameter(name, value))
    assert dec.max_window_log == rdec.max_window_log


# ---------------------------------------------------------------------------
# frame introspection and skippable frames
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(_DFRAMES))
def test_frame_info_and_bound_equal_reference(name):
    f = _DFRAMES[name]
    info = _same(lambda: dataclasses.asdict(Z.frame_info(f)),
                 lambda: dataclasses.asdict(R.frame_info(f)))
    if info is not None:
        _same(lambda: Z.decompress_bound(f), lambda: R.decompress_bound(f))


@pytest.mark.parametrize("variant,content", [
    (0, b""), (3, b"meta"), (15, b"x" * 1000), (16, b"no"), (-1, b"no")])
def test_skippable_frames_equal_reference(variant, content):
    f = _same(lambda: enc.write_skippable_frame(content, variant),
              lambda: renc.write_skippable_frame(content, variant))
    if f is not None:
        assert (frame.read_skippable_frame(f)
                == rframe.read_skippable_frame(f) == (variant, content))
        for cut in (f[:7], f[:-1] if content else f[:5]):
            _same(lambda: frame.read_skippable_frame(cut),
                  lambda: rframe.read_skippable_frame(cut))
    plain = R.compress(b"abc", 1)
    _same(lambda: frame.read_skippable_frame(plain),
          lambda: rframe.read_skippable_frame(plain))


# ---------------------------------------------------------------------------
# trace hooks
# ---------------------------------------------------------------------------


def _events(mod, tr):
    got = []
    tr.register(got.append)
    try:
        data = _text(5000, seed=8)
        f = mod.compress(data, 3)
        mod.decompress(f)
        mod.compress(data, params=(
            params if mod is Z else rparams).CCtxParams(
                compression_level=5, n_workers=2))
        mod.decompress(f, n_workers=2)   # not traced
    finally:
        tr.unregister(got.append)
    assert not tr.enabled()
    return [(e.kind, e.src_size, e.dst_size, e.level, e.strategy, e.extra)
            for e in got], [e.duration_s for e in got]


def test_trace_events_equal_reference():
    got, durations = _events(Z, trace)
    want, _ = _events(R, rtrace)
    assert got == want
    assert [k for k, *_ in got] == ["compress_begin", "compress_end",
                                    "decompress_begin", "decompress_end",
                                    "compress_begin", "compress_end"]
    assert all(d >= 0 for d in durations)


# ---------------------------------------------------------------------------
# the external sequence API
# ---------------------------------------------------------------------------


def _seq_tuples(seqs):
    return [dataclasses.astuple(s) for s in seqs]


@pytest.mark.parametrize("level", [1, 3, 7])
def test_sequence_api_equal_reference(level):
    data = _text(150_000, seed=level)
    got = seq.generate_sequences(data, level=level)
    want = rseq.generate_sequences(data, level=level)
    assert _seq_tuples(got) == _seq_tuples(want)
    assert (_seq_tuples(seq.merge_block_delimiters(got))
            == _seq_tuples(rseq.merge_block_delimiters(want)))
    for checksum in (False, True):
        f = seq.compress_sequences(got, data, checksum=checksum)
        assert f == rseq.compress_sequences(want, data, checksum=checksum)
        assert Z.decompress(f) == data


@pytest.mark.parametrize("case", ["handcrafted", "bad_offset", "bad_bytes",
                                  "no_delimiter", "short_match", "overrun",
                                  "short_cover"])
def test_compress_sequences_checks_equal_reference(case):
    data = b"abcdabcdabcdabcd" + b"xyz"
    rows = {"handcrafted": [(4, 4, 12), (0, 3, 0)],
            "bad_offset": [(99, 4, 12), (0, 3, 0)],
            "bad_bytes": [(3, 4, 12), (0, 3, 0)],
            "no_delimiter": [(4, 4, 12)],
            "short_match": [(4, 4, 2), (0, 13, 0)],
            "overrun": [(4, 4, 12), (0, 30, 0)],
            "short_cover": [(4, 4, 12), (0, 1, 0)]}[case]
    f = _same(lambda: seq.compress_sequences(
                  [seq.Sequence(*r) for r in rows], data),
              lambda: rseq.compress_sequences(
                  [rseq.Sequence(*r) for r in rows], data))
    if f is not None:
        assert Z.decompress(f) == data


# ---------------------------------------------------------------------------
# the device entry points: on the card by default
# ---------------------------------------------------------------------------


def _entry_points():
    from zstdsharp_tpu_torch import graft_entry
    from zstdsharp_tpu_torch.decode.device_pipeline import decode_batch_device
    from zstdsharp_tpu_torch.encode.device_pipeline import (
        compress_batch_device)

    frames = [R.compress(_text(3000), 3)]
    return {
        "unwrap_many_device": lambda: Z.Decompressor().unwrap_many_device(
            frames),
        "decode_batch_device": lambda: decode_batch_device(frames),
        "compress_batch_device": lambda: compress_batch_device([b"abc" * 99]),
        "entry": lambda: graft_entry.entry(),
    }


@pytest.mark.parametrize("name", ["unwrap_many_device", "decode_batch_device",
                                  "compress_batch_device", "entry"])
def test_entry_point_default_needs_a_card(name, monkeypatch):
    """Called with no device and no card, each entry point raises; it
    does not hand back CPU results (the other tests pass "cpu")."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    call = _entry_points()[name]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()
