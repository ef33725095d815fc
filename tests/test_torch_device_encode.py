"""Device encode plane of the torch port against the JAX package.

On the CPU the port runs its plain torch versions (``histogram_u8`` takes
``histogram_plain``).  Its frames must be byte-for-byte the reference's
(``zstdsharp_tpu.encode.device_pipeline.compress_batch_device``, traced
with x64 off as the reference traces it), decode with libzstd and with the
port's own decode plane, and every intermediate -- FSE state chains,
table builders, frame rows and lengths -- must equal the reference's
exactly.  Shapes stay in the 4 KB bucket, with one 16 KB case.
"""

import linecache
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import zstandard

from zstdsharp_tpu.decode.frame import decompress
from zstdsharp_tpu.encode import device_pipeline as ref_pipe
from zstdsharp_tpu.ops import device_encode as ref
from zstdsharp_tpu_torch.decode.device_pipeline import decode_batch_device
from zstdsharp_tpu_torch.encode.device_pipeline import compress_batch_device
from zstdsharp_tpu_torch.entropy import fse, huffman
from zstdsharp_tpu_torch.ops import device_encode as de


def _records(n, size, seed=7):
    """tests/test_device_encode.py's word records."""
    r = np.random.default_rng(seed)
    words = [b"alpha", b"bravo", b"charlie", b"delta", b"echo", b"foxtrot",
             b"golf", b"hotel", b"india", b"juliet"]
    out = []
    for _ in range(n):
        rec = b" ".join(words[int(i)]
                        for i in r.integers(0, len(words), size // 6 + 2))
        out.append(rec[:size])
    return out


def _mix_4k():
    """The reference test's record mix, cut to the 4 KB bucket."""
    return _records(10, 3_000) + [
        np.random.default_rng(3).integers(
            0, 256, 3000, dtype=np.uint8).tobytes(),  # raw fallback
        b"ab" * 1500,                                  # match-heavy
        b"", b"z", b"short literal only"]


def _decodes(frames, recs):
    d = zstandard.ZstdDecompressor()
    for rec, frame in zip(recs, frames):
        assert d.decompress(frame, max_output_size=max(2 * len(rec), 64)) == rec
        assert decompress(frame) == rec


# ---------------------------------------------------------------------------
# host half: copied builders give the reference's tables
# ---------------------------------------------------------------------------


def test_predefined_tables_equal_reference():
    a, b = de._tables(), ref._tables()
    for k in ("ll_lut", "ml_lut", "ll_bits", "ml_bits"):
        assert np.array_equal(a[k], b[k]), k
    for name in ("ll", "of", "ml"):
        assert a[name]["tlog"] == b[name]["tlog"]
        for k in ("dnb", "dfs", "st", "maps", "nbs", "init"):
            assert np.array_equal(a[name][k], b[name][k]), (name, k)
    assert (de.DESC_MAX, de.TBL_MAX) == (ref.DESC_MAX, ref.TBL_MAX)
    for n in (4096, 16384, 65536, 131072):
        assert de.seq_budget(n) == ref.seq_budget(n)
        assert de.word_budget(de.seq_budget(n)) == ref.word_budget(
            ref.seq_budget(n))


def _synthetic_codes(seed):
    """Per-lane ll/of/ml code rows and counts: uniform, single-symbol (RLE),
    skewed and short lanes, with histograms over each lane's real codes."""
    rng = np.random.default_rng(seed)
    S, B = 200, 8
    nseq = np.array([200, 33, 64, 65, 1, 2, 0, 150], np.int32)
    codes = {}
    for name, top in (("ll", 35), ("of", 28), ("ml", 52)):
        c = rng.integers(0, top + 1, (B, S))
        c[1] = 3                                    # RLE lane
        c[2] = np.minimum(rng.geometric(0.5, S), top)  # skewed
        c[7] = rng.integers(0, 4, S)                # few symbols
        codes[name] = c.astype(np.int32)
    real = np.arange(S)[None, :] < nseq[:, None]
    hists = tuple(
        np.stack([np.bincount(codes[name][b][real[b]], minlength=n)[:n]
                  for b in range(B)]).astype(np.int32)
        for name, n in (("ll", 36), ("of", 32), ("ml", 53)))
    return codes, nseq, hists


def test_table_builders_equal_reference():
    codes, nseq, hists = _synthetic_codes(1)
    got = de._build_seq_tables(hists, nseq, de._tables())
    want = ref._build_seq_tables(hists, nseq, ref._tables())
    for name in ("ll", "of", "ml"):
        for g, w in zip(got[0][name], want[0][name]):
            assert np.array_equal(g, w), name
    for g, w in zip(got[1:], want[1:]):
        assert np.array_equal(g, w)
    assert set(np.unique(got[1])) > {0}  # fresh/RLE modes were chosen
    rng = np.random.default_rng(2)
    lit_hist = np.stack([np.bincount(rng.integers(0, k, 3000), minlength=256)
                         for k in (2, 20, 200, 256, 1)]).astype(np.int32)
    lit_count = np.array([3000, 3000, 3000, 40, 3000], np.int32)
    for g, w in zip(de._build_lit_tables(lit_hist, lit_count),
                    ref._build_lit_tables(lit_hist, lit_count)):
        assert np.array_equal(g, w)


# ---------------------------------------------------------------------------
# native table builders (csrc/host_tables.cpp) against the plain ones
# ---------------------------------------------------------------------------

_SEQ_BINS = (36, 32, 53)


def _lines_reached(fn, *args):
    """fn(*args) and the stripped source lines it ran in the port's
    entropy modules and ``device_encode``."""
    files = {huffman.__file__, fse.__file__, de.__file__}
    seen = set()

    def local(frame, event, arg):
        if event == "line":
            seen.add(linecache.getline(frame.f_code.co_filename,
                                       frame.f_lineno).strip())
        return local

    def calls(frame, event, arg):
        return local if frame.f_code.co_filename in files else None

    sys.settrace(calls)
    try:
        out = fn(*args)
    finally:
        sys.settrace(None)
    return out, seen


def _byte_hists(recs):
    """Byte histograms of records and of their 1 KiB and 4 KiB prefixes."""
    rows = [r[:k] for r in recs for k in (1024, 4096, len(r))]
    return (np.stack([np.bincount(np.frombuffer(r, np.uint8), minlength=256)
                      for r in rows]).astype(np.int32),
            np.array([len(r) for r in rows], np.int32))


def _lit_rows(rows, counts=None):
    h = np.zeros((len(rows), 256), np.int64)
    for b, row in enumerate(rows):
        h[b, :len(row)] = row
    n = h.sum(1) if counts is None else np.asarray(counts)
    return h.astype(np.int32), n.astype(np.int32)


def _from_draws(draws, top=256):
    return np.bincount(np.minimum(draws, top - 1), minlength=256)


def _fib(k):
    f = [1, 1]
    while len(f) < k:
        f.append(f[-1] + f[-2])
    return f[:k]


def _code_hists(rng, nseq):
    """Per-lane ll/of/ml code histograms over nseq[b] codes each: uniform,
    geometric, Zipf and few-symbol lanes in turn."""
    out = []
    for bins in _SEQ_BINS:
        top = 16 if bins == 32 else bins
        rows = []
        for b, n in enumerate(nseq):
            kind = b % 4
            if kind == 0:
                c = rng.integers(0, top, n)
            elif kind == 1:
                c = np.minimum(rng.geometric(0.3, n) - 1, top - 1)
            elif kind == 2:
                c = np.minimum(rng.zipf(1.6, n) - 1, top - 1)
            else:
                c = rng.integers(0, 3, n)
            rows.append(np.bincount(c, minlength=bins)[:bins])
        out.append(np.stack(rows).astype(np.int32))
    return out


def _case(lit, seq=None, patch=None, reaches=(), seed=0):
    """A table-builder case: the literal inputs, the sequence inputs
    (default: mixed code histograms over 40..3000 sequences), module
    constants to patch in both packages, and lines of the plain builders'
    call tree the case must run."""
    if seq is None:
        rng = np.random.default_rng(seed)
        nseq = rng.integers(40, 3000, 8).astype(np.int32)
        seq = (_code_hists(rng, nseq), nseq)
    return {"lit": lit, "seq": seq, "patch": patch or {},
            "reaches": reaches}


def _payload_case(name, lengths, seed):
    """Byte histograms of records of one of the benchmark's payloads."""
    import importlib

    module = importlib.import_module(f"benchmark.payloads.{name}")
    rng = np.random.default_rng(seed)
    return _case(_byte_hists(module.make(lengths, rng)), seed=seed)


def _drawn(seed, draw, params, **kw):
    """A literal case of byte histograms of draw(rng, p) for each p."""
    rng = np.random.default_rng(seed)
    return _case(_lit_rows([_from_draws(draw(rng, p)) for p in params]),
                 seed=seed, **kw)


def _seq_only(hists, nseq, **kw):
    """A sequence case whose literal side is a few plain lanes."""
    return _case(_lit_rows([[5, 9, 200, 1, 3], [70] * 40]), (hists, nseq),
                 **kw)


def _rle_case():
    rng = np.random.default_rng(11)
    nseq = np.array([100, 100, 100, 2000, 33, 500], np.int32)
    hists = _code_hists(rng, nseq)
    for ci, bins in enumerate(_SEQ_BINS):
        for b, sym in ((0, 3), (1, 0), (2, bins - 1 if bins != 32 else 15)):
            if ci <= b:  # lane 0: ll alone RLE; lane 2: all three
                hists[ci][b] = 0
                hists[ci][b, sym] = nseq[b]
    hists[1][4] = 0
    hists[1][4, 7] = 33
    hists[1][5] = 0  # no codes at all: the channel stays predefined
    return _seq_only(hists, nseq, reaches=("ok_modes[ci] = 1",))


def _short_seq_case():
    rng = np.random.default_rng(12)
    nseq = np.array([0, 1, 16, 31, 32, 33], np.int32)
    return _seq_only(_code_hists(rng, nseq), nseq)


def _tbl_past_max_case():
    rng = np.random.default_rng(13)
    nseq = np.array([40, 60, 63, 200, 1000, 50], np.int32)
    hists = _code_hists(rng, nseq)
    for b in (0, 1, 2):  # many symbols at few sequences: long NCounts
        for ci, bins in enumerate(_SEQ_BINS):
            top = 16 if bins == 32 else bins
            hists[ci][b] = np.bincount(rng.integers(0, top, nseq[b]),
                                       minlength=bins)
    # lane 2's area is 60 B: the cap keeps it and refuses lane 1's 61 B
    return _seq_only(hists, nseq, patch={"TBL_MAX": 60},
                     reaches=("for name, ci, _mc in chans:",
                              "mode[b] = ok_modes"))


def _m2_case():
    """An ml histogram of 49 sequences whose normalisation takes
    FSE_normalizeM2, in a lane that keeps its fresh tables."""
    ml = np.zeros(53, np.int64)
    for s, c in ((0, 2), (2, 1), (3, 3), (7, 3), (8, 2), (10, 2), (12, 3),
                 (17, 3), (30, 3), (31, 3), (32, 2), (35, 2), (41, 1),
                 (42, 3), (43, 3), (44, 2), (45, 3), (48, 3), (49, 3),
                 (51, 2)):
        ml[s] = c
    nseq = np.array([49, 49], np.int32)
    ll = np.zeros((2, 36), np.int32)
    ll[:, 0], ll[:, 1] = 30, 19
    of = np.zeros((2, 32), np.int32)
    of[:, 2], of[:, 5] = 40, 9
    hists = [ll, of, np.stack([ml, ml]).astype(np.int32)]
    hists[2][1, 0] += 5  # a lane with counts past nseq
    return _seq_only(hists, nseq, reaches=("NOT_YET = -2",))


def _rle_input_case():
    """Counts that disagree with nseq: one symbol holds all of them, so
    FSE_normalizeCount refuses the channel."""
    nseq = np.array([35, 92, 35], np.int32)
    ll = np.zeros((3, 36), np.int32)
    ll[[0, 2], 25], ll[[0, 2], 10], ll[[0, 2], 7] = 35, 29, 11
    ll[1, 0], ll[1, 13], ll[1, 25] = 75, 175, 23  # norms past the table
    of = np.zeros((3, 32), np.int32)
    of[:, 1], of[:, 3] = 20, 15
    of[1, 1] += 57
    ml = np.zeros((3, 53), np.int32)
    ml[:2, 4], ml[:2, 9] = 30, 5
    ml[1, 4] += 57
    ml[2, 4], ml[2, 9] = 35, 1  # the rest of the channel would fit
    return _seq_only([ll, of, ml], nseq,
                     reaches=('raise ZstdError(ZstdErrorCode.generic, '
                              '"RLE input to normalize")',))


def _boundary_case():
    """Two lanes on the plain builders' edges: 13 near-equal counts whose
    FSE weight payload is exactly half the largest symbol (6 bytes at 12:
    raw nibbles win), and Fibonacci counts whose height limit shortens one
    of two equally frequent symbols (the first wins)."""
    half = [56, 49, 51, 37, 46, 61, 42, 50, 58, 58, 57, 60, 56]
    tie = np.zeros(256, np.int64)
    for s, c in ((0, 2), (6, 13), (18, 9227465), (21, 21), (24, 3), (29, 1),
                 (30, 1597), (34, 610), (36, 377), (37, 17711), (40, 987),
                 (44, 6765), (46, 1346269), (60, 17711), (64, 2178309),
                 (65, 196418), (66, 233), (77, 8), (78, 89), (81, 317811),
                 (82, 121393), (87, 3524578), (89, 55), (90, 75025),
                 (92, 28657), (93, 10946), (94, 144), (95, 2584),
                 (97, 514229), (100, 5702887), (108, 832040), (109, 4181),
                 (115, 46368), (117, 17711), (120, 5)):
        tie[s] = c
    return _case(_lit_rows([half, tie]), seed=10,
                 reaches=("lengths[best] -= 1",))


def _max_symbol_case(top):
    rng = np.random.default_rng(top)
    rows = [_from_draws(rng.integers(0, top + 1, 3000)),
            _from_draws(np.minimum(rng.geometric(0.05, 5000), top)),
            _from_draws(np.minimum(rng.zipf(1.3, 8000), top))]
    for row in rows:
        row[top] = max(row[top], 1)
    rows.append(np.eye(256, dtype=np.int64)[top] * 70 + 50 * (
        np.arange(256) < 3))  # four symbols, the largest at top
    rows.append(100 * (np.arange(256) <= top))  # flat: equal weights
    # FSE weights where the largest symbol is 128 or more; raw nibbles
    # where it is 127 and the weights are all equal; at 255 equal weights
    # can take neither, and the lane stays raw
    last = {127: "return bytes([128 + ct.max_symbol - 1]) + "
                 "pairs.astype(np.uint8).tobytes()",
            128: "return bytes([len(payload)]) + payload",
            255: 'check(ct.max_symbol < 128, ZstdErrorCode.generic, '
                 '"raw weights need maxSymbol<128")'}[top]
    return _case(_lit_rows(rows), seed=top, reaches=(
        "return bytes([len(payload)]) + payload", last))


_TABLE_CASES = {
    "kafka_json": lambda: _payload_case(
        "kafka_json_events", [45_000, 52_000, 61_440], 4419000332),
    "silesia_mix": lambda: _payload_case(
        "silesia_mix", [131_072] * 4, 4419000322),
    "zipf": lambda: _drawn(1, lambda r, a: r.zipf(a, 20_000) - 1,
                           (1.1, 1.3, 2.0, 3.5)),
    "geometric": lambda: _drawn(2, lambda r, p: r.geometric(p, 20_000) - 1,
                                (0.01, 0.05, 0.3, 0.7)),
    "flat": lambda: _case(_lit_rows(
        [[100] * k for k in (2, 16, 100, 256)]
        + [_from_draws(np.random.default_rng(3).integers(0, 256, 4000))]),
        seed=3),
    "two_symbols": lambda: _case(_lit_rows(
        [[40, 60], [1, 99], [0] * 200 + [64, 64], [1000, 1]]), seed=4),
    "one_symbol": lambda: _case(_lit_rows(
        [[0, 500], [0] * 255 + [64], [3000]]), seed=5),
    "short": lambda: _case(_lit_rows(
        [[10, 20, 33], [1] * 63, [1] * 64, list(range(11))]), seed=6),
    "max_at_least_n": lambda: _case(_lit_rows(
        [[300, 5, 5], [64, 1], [100, 100, 100]], counts=[300, 64, 150]),
        seed=7),
    "max_symbol_127": lambda: _max_symbol_case(127),
    "max_symbol_128": lambda: _max_symbol_case(128),
    "max_symbol_255": lambda: _max_symbol_case(255),
    "fibonacci": lambda: _case(_lit_rows(
        [[0] * (256 - k) + _fib(k) for k in (14, 16, 24, 30)] + [_fib(20)]),
        seed=8, reaches=("lengths[best] += 1", "lengths[best] -= 1")),
    # lane 3's descriptor is 28 B: the cap keeps it and refuses lane 4's
    "desc_past_max": lambda: _case(_lit_rows(
        [[100] * k for k in (8, 40, 100, 200)]
        + [_from_draws(np.random.default_rng(9).zipf(1.3, 20_000) - 1)]),
        patch={"DESC_MAX": 28}, seed=9),
    "boundaries": _boundary_case,
    "rle_channels": _rle_case,
    "nseq_below_32": _short_seq_case,
    "tbl_past_max": _tbl_past_max_case,
    "normalize_m2": _m2_case,
    "seq_counts_past_nseq": _rle_input_case,
}


def _assert_arrays_equal(got, want, what):
    assert len(got) == len(want), what
    for k, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype and g.shape == w.shape, (what, k)
        assert np.array_equal(g, w), (what, k)


@pytest.mark.parametrize("case", list(_TABLE_CASES))
def test_native_table_builders_equal_plain_and_reference(case, monkeypatch):
    """The native builders give the plain builders' and the reference's
    arrays byte for byte: all five literal arrays, every sequence array."""
    c = _TABLE_CASES[case]()
    lit_hist, lit_count = c["lit"]
    hists, nseq = c["seq"]
    if c["patch"]:  # the cap must refuse some lane the plain builder took
        ok = de._build_lit_tables_plain(lit_hist, lit_count)[4]
        tbl_len = de._build_seq_tables_plain(hists, nseq, de._tables())[3]
    for name, value in c["patch"].items():
        monkeypatch.setattr(de, name, value)
        monkeypatch.setattr(ref, name, value)
    got_lit = de._build_lit_tables(lit_hist, lit_count)
    plain, seen_lit = _lines_reached(de._build_lit_tables_plain, lit_hist,
                                     lit_count)
    _assert_arrays_equal(got_lit, plain, "lit plain")
    _assert_arrays_equal(got_lit, ref._build_lit_tables(lit_hist, lit_count),
                         "lit reference")
    got = de._build_seq_tables(hists, nseq, de._tables())
    plain, seen_seq = _lines_reached(de._build_seq_tables_plain, hists, nseq,
                                     de._tables())
    want = ref._build_seq_tables(hists, nseq, ref._tables())
    for name in ("ll", "of", "ml"):
        _assert_arrays_equal(got[0][name], plain[0][name], name)
        _assert_arrays_equal(got[0][name], want[0][name], name)
    _assert_arrays_equal(got[1:], plain[1:], "seq plain")
    _assert_arrays_equal(got[1:], want[1:], "seq reference")
    for line in c["reaches"]:
        assert line in seen_lit | seen_seq, line
    if "DESC_MAX" in c["patch"]:
        assert (ok & ~got_lit[4]).any() and got_lit[4].any()
    if "TBL_MAX" in c["patch"]:
        assert ((tbl_len > 0) & (got[3] == 0)).any() and got[3].any()


# ---------------------------------------------------------------------------
# FSE state chains
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["ll", "of", "ml"])
@pytest.mark.parametrize("tables", ["predefined", "per_lane"])
def test_fse_stream_states_equal_reference(name, tables):
    codes, nseq, hists = _synthetic_codes(3)
    seq_t = ref._build_seq_tables(hists, nseq, ref._tables())[0][name]
    c = torch.from_numpy(codes[name])
    ns = torch.from_numpy(nseq)
    if tables == "predefined":
        got = de._fse_stream_states(c, ns, de._tables()[name])
    else:
        got = de._fse_stream_states(
            c, ns, de._tables()[name],
            tuple(torch.from_numpy(a) for a in seq_t[:3]))
    with jax.enable_x64(False):
        for b in range(len(nseq)):
            tb = (None if tables == "predefined"
                  else tuple(jnp.asarray(a[b]) for a in seq_t[:3]))
            want = ref._fse_stream_states(jnp.asarray(codes[name][b]),
                                          jnp.int32(nseq[b]),
                                          ref._tables()[name], tb)
            for g, w in zip(got, want):
                assert np.array_equal(g[b].numpy(), np.asarray(w)), b


def test_fse_states_span_many_chunks():
    """S well past one 64-step chunk, so the suffix composition over chunk
    composites decides every state."""
    rng = np.random.default_rng(9)
    S = 700
    codes = rng.integers(0, 36, (3, S)).astype(np.int32)
    nseq = np.array([700, 129, 64], np.int32)
    got = de._fse_stream_states(torch.from_numpy(codes),
                                torch.from_numpy(nseq), de._tables()["ll"])
    with jax.enable_x64(False):
        for b in range(3):
            want = ref._fse_stream_states(jnp.asarray(codes[b]),
                                          jnp.int32(nseq[b]),
                                          ref._tables()["ll"])
            for g, w in zip(got, want):
                assert np.array_equal(g[b].numpy(), np.asarray(w))


# ---------------------------------------------------------------------------
# frames
# ---------------------------------------------------------------------------


def _padded(recs, n):
    blocks = np.zeros((ref_pipe.LANES, n), np.uint8)
    nv = np.zeros(ref_pipe.LANES, np.int32)
    for k, r in enumerate(recs):
        blocks[k, :len(r)] = np.frombuffer(r, np.uint8)
        nv[k] = len(r)
    return blocks, nv


@pytest.mark.parametrize("huf_literals", [True, False])
def test_encode_frames_rows_and_lens_equal_reference(huf_literals,
                                                     monkeypatch):
    recs = _mix_4k()
    blocks, nv = _padded(recs, 4096)
    S = de.seq_budget(4096)
    W = de.word_budget(S)
    timings = {}
    built, lit = [], de._build_lit_tables
    monkeypatch.setattr(de, "_build_lit_tables",
                        lambda *a: built.append(lit(*a)) or built[-1])
    rows, lens = de.encode_frames_device(
        torch.from_numpy(blocks), torch.from_numpy(nv), S, W, 15,
        huf_literals, timings=timings)
    w_rows, w_lens = ref.encode_frames_device(
        jnp.asarray(blocks), jnp.asarray(nv), S, W, 15, huf_literals)
    assert rows.dtype == torch.uint8 and lens.dtype == torch.int32
    assert np.array_equal(lens.numpy(), np.asarray(w_lens))
    assert np.array_equal(rows.numpy(), np.asarray(w_rows))
    assert set(timings) == {"parse", "tables", "tables.lit", "tables.seq",
                            "tables.upload", "assembly", "n.table_lanes",
                            "n.huf_lanes"}
    assert timings["n.table_lanes"] == len(blocks)
    assert timings["n.huf_lanes"] == sum(int(o[4].sum()) for o in built)
    assert len(built) == huf_literals and (not built or built[0][4].any())
    _decodes([rows[k, :lens[k]].numpy().tobytes() for k in range(len(recs))],
             recs)


def test_batch_frames_equal_reference_and_decode():
    recs = _mix_4k()
    frames, stats = compress_batch_device(recs, device="cpu", materialize=True)
    want, want_stats = ref_pipe.compress_batch_device(recs, materialize=True)
    assert stats == want_stats == {"device_frames": len(recs),
                                   "host_frames": 0}
    assert frames == want
    _decodes(frames, recs)
    results, _ = decode_batch_device(frames, device="cpu", materialize=True)
    assert results == recs
    # Huffman literals and fresh tables were exercised
    assert any(f[12] & 3 == 2 for f in frames if len(f) > 12)


def test_compress_takes_the_reference_arguments():
    """The reference's positional call, compress_batch_device(records,
    True, 15), with the device as a keyword gives the reference's frames
    and stats (the signatures: tests/test_torch_device_pipeline.py)."""
    recs = _mix_4k()
    frames, stats = compress_batch_device(recs, True, 15, device="cpu")
    want, want_stats = ref_pipe.compress_batch_device(recs, True, 15)
    assert frames == want and stats == want_stats


def test_16k_bucket_frames_equal_reference():
    recs = _records(3, 15_000, seed=5) + [
        np.random.default_rng(4).integers(0, 256, 9000,
                                          dtype=np.uint8).tobytes(),
        b"ab" * 7000]
    frames, stats = compress_batch_device(recs, device="cpu", materialize=True)
    want, _ = ref_pipe.compress_batch_device(recs, materialize=True)
    assert stats["device_frames"] == len(recs)
    assert frames == want
    _decodes(frames, recs)


def test_frames_feed_the_ports_decode_plane():
    recs = _records(6, 3_500, seed=11) + [b"ab" * 1800]
    frames, _ = compress_batch_device(recs, device="cpu", materialize=True)
    results, stats = decode_batch_device(frames, device="cpu",
                                         materialize=True)
    assert stats == {"device_frames": len(recs), "host_frames": 0}
    assert results == recs


def test_oversized_records_route_to_host():
    big = _records(1, 200_000, seed=13)[0]
    small = _records(1, 3_000, seed=14)[0]
    frames, stats = compress_batch_device([big, small], device="cpu",
                                          materialize=True)
    assert stats == {"device_frames": 1, "host_frames": 1}
    want, _ = ref_pipe.compress_batch_device([big, small], materialize=True)
    assert frames == want
    assert decompress(frames[0]) == big and decompress(frames[1]) == small


def test_rows_stay_on_the_device():
    recs = _records(3, 3_000, seed=15)
    chunks, host = compress_batch_device(recs, device=torch.device("cpu"))
    assert not host
    (part, rows, lens), = chunks
    assert part == [0, 1, 2]
    assert isinstance(rows, torch.Tensor) and rows.device.type == "cpu"
    assert tuple(rows.shape) == (ref_pipe.LANES, 4096 + 16)
    for k, rec in enumerate(recs):
        assert decompress(rows[k, :int(lens[k])].numpy().tobytes()) == rec
