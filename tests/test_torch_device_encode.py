"""Device encode plane of the torch port against the JAX package.

On the CPU the port runs its plain torch versions (``histogram_u8`` takes
``histogram_plain``).  Its frames must be byte-for-byte the reference's
(``zstdsharp_tpu.encode.device_pipeline.compress_batch_device``, traced
with x64 off as the reference traces it), decode with libzstd and with the
port's own decode plane, and every intermediate -- FSE state chains,
table builders, frame rows and lengths -- must equal the reference's
exactly.  Shapes stay in the 4 KB bucket, with one 16 KB case.
"""

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
def test_encode_frames_rows_and_lens_equal_reference(huf_literals):
    recs = _mix_4k()
    blocks, nv = _padded(recs, 4096)
    S = de.seq_budget(4096)
    W = de.word_budget(S)
    timings = {}
    rows, lens = de.encode_frames_device(
        torch.from_numpy(blocks), torch.from_numpy(nv), S, W, 15,
        huf_literals, timings=timings)
    w_rows, w_lens = ref.encode_frames_device(
        jnp.asarray(blocks), jnp.asarray(nv), S, W, 15, huf_literals)
    assert rows.dtype == torch.uint8 and lens.dtype == torch.int32
    assert np.array_equal(lens.numpy(), np.asarray(w_lens))
    assert np.array_equal(rows.numpy(), np.asarray(w_rows))
    assert set(timings) == {"parse", "tables", "assembly"}
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
