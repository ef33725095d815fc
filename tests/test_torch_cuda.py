"""The port's CUDA kernels on the card: each kernel against its plain torch
version, and the decode and encode planes, the candidate stage and the
data-parallel compressor on the card against their CPU runs.  With two
cards or more, the kernels launched from a worker thread on the second
card and the stream codec over a mesh of cards.

These tests need an NVIDIA GPU and skip elsewhere.  They import only the
port (and the repository's data generator ``bench.make_corpus``): neither
JAX, nor the JAX package, nor zstandard, so they also run on a machine that
has none of them:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from zstdsharp_tpu_torch.decode import device_pipeline as dp
from zstdsharp_tpu_torch.decode.frame import Decompressor, decompress
from zstdsharp_tpu_torch.encode.device_pipeline import compress_batch_device
from zstdsharp_tpu_torch.encode.frame import compress
from zstdsharp_tpu_torch.ops import device_fse as df
from zstdsharp_tpu_torch.ops import device_huf as dh
from zstdsharp_tpu_torch.ops import histogram as hg
from zstdsharp_tpu_torch.ops.matcher import candidate_stage
from zstdsharp_tpu_torch.parallel.pipeline import (compress_data_parallel,
                                                   compress_records_device,
                                                   decompress_data_parallel,
                                                   make_mesh)

pytestmark = pytest.mark.cuda

# A valid 1453-byte frame (our encoder, level 3) whose only block has 129
# sequences, the last of which reads no bits: the stream is exhausted one
# sequence early.  The JAX package's Pallas kernel checks "every lane's
# pos <= 0" at each 64-sequence chunk and zero-fills, so its device plane
# drops that last sequence and returns wrong bytes without an error; the
# port stops each lane after its own n_seq instead.
EARLY_END_FRAME = bytes.fromhex(
    "28b52ffd60ad04c50800c402626574612065707320616c706864656c67616d6d"
    "6165706261626262636261626163626161636261626261628081a8d04b619903"
    "3002620c63771b1140148720632517c84cadd1be0120402e36c6f0788b05066c"
    "b979b48085e2b270c79f87221674f759a78bb3a51cd6025bd0c55a54f48c19fa"
    "973da866783987ff6a543a9cc8cd2021771f38b5b6c880ceb2bea7be02089bf8"
    "a19984234a698ab357f0265d83c01d86c0e8b1938b1dcd4c2dd11d4778666b43"
    "a989d482348a08df9c2b2b44671622020414c4ccc465d873297e6e1aa4a73c68"
    "0d598fd9be76fcd2b97bbe07e64afc8c05262e7a1d5b18c8410786731d25ec5c"
    "9dbac8e84f8ba219cb0dd191cfce8e5b12a3acf5a7396ef15195855444442fc1"
    "951d")


def _records(n, size, seed):
    r = np.random.default_rng(seed)
    words = [b"alpha ", b"bravo ", b"charlie ", b"delta ", b"echo ",
             b"foxtrot ", b"golf ", b"hotel "]
    return [b"".join(words[int(i)] for i in r.integers(0, len(words),
                                                       size // 5))[:size]
            for _ in range(n)]


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def planned(cuda):
    frames = [compress(x, lvl) for x, lvl in zip(
        _records(12, 20_000, 3), (1, 3, 5, 9, 19, 9) * 2)]
    plan = dp.plan_batch(frames)
    ops = (dp.ops_to_device(plan.nb.huf_ops(0), cuda),
           dp.ops_to_device(plan.nb.fse_ops(0), cuda))
    dp._release_ops(plan.nb, None)
    return ops


def test_huf_kernel_equals_plain(planned):
    ops = planned[0]
    before = dh.decode_lanemajor.launches
    got = dh.decode_lanemajor(ops)
    torch.cuda.synchronize()
    assert dh.decode_lanemajor.launches == before + 1
    want = dh.decode_plain(*(ops[k] for k in dh._OPERANDS), got.shape[1])
    assert torch.equal(got, want)


def test_fse_kernel_equals_plain(planned):
    ops = planned[1]
    before = df.decode_lanemajor.launches
    got = df.decode_lanemajor(ops)
    torch.cuda.synchronize()
    assert df.decode_lanemajor.launches == before + 1
    want = df.decode_plain(*(ops[k] for k in df._OPERANDS), got[0].shape[1])
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _corpus(n: int) -> bytes:
    """The repository's data generator, bench.make_corpus."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    from bench import make_corpus

    return make_corpus(n)


def _window(frames, cuda, which="fse"):
    """The planner's first `which` ("fse" or "huf") operand window."""
    plan = dp.plan_batch(frames)
    ops = dp.ops_to_device(getattr(plan.nb, f"{which}_ops")(0), cuda)
    dp._release_ops(plan.nb, None)
    return ops


def _fse_equal_plain(ops):
    """Launch the FSE kernel once on `ops`, synchronise, hold it against
    the plain version; the rows are zero past each lane's count."""
    before = df.decode_lanemajor.launches
    got = df.decode_lanemajor(ops)
    torch.cuda.synchronize()
    assert df.decode_lanemajor.launches == before + 1
    t_len = got[0].shape[1]
    want = df.decode_plain(*(ops[k] for k in df._OPERANDS), t_len)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    n = ops["nseq"].long().clamp(0, t_len)
    dead = torch.arange(t_len, device=n.device)[None, :] >= n[:, None]
    assert all(bool((g.masked_select(dead) == 0).all()) for g in got)
    return got


@pytest.mark.parametrize("wb,rec_kb", [(1024, 24), (2048, 48)])
def test_fse_kernel_planner_windows(cuda, wb, rec_kb):
    """The planner's window of bench-corpus records at level 9: 24 KB
    records make the main path's Wb 1024 bucket, 48 KB ones Wb 2048."""
    n = rec_kb << 10
    data = _corpus(48 * n)
    ops = _window([compress(data[i:i + n], 9)
                       for i in range(0, len(data), n)], cuda)
    assert ops["words"].shape[1] == wb
    assert int(ops["nseq"].max()) > 1000
    _fse_equal_plain(ops)


def test_fse_kernel_idle_and_padding_lanes(cuda):
    """Padding lanes (the window rounds 37 lanes up) and lanes set to
    nseq = 0 decode nothing and are all zeros."""
    frames = [compress(x, 9) for x in _records(37, 6_000, 17)]
    ops = _window(frames, cuda)
    assert ops["words"].shape[0] > 37 and int(ops["nseq"][37:].max()) == 0
    ops["nseq"][::5] = 0
    got = _fse_equal_plain(ops)
    assert not any(bool(g[::5].any()) for g in got)


def test_fse_kernel_early_end_frame(cuda):
    ops = _window([EARLY_END_FRAME], cuda)
    assert int(ops["nseq"][0]) == 129
    _fse_equal_plain(ops)


@pytest.mark.parametrize("nl,wb,seed", [(1, 64, 1), (33, 1536, 2),
                                        (300, 2048, 3), (1024, 256, 4),
                                        (5, 10400, 5)])
def test_fse_kernel_random_window(cuda, nl, wb, seed):
    """Random tables, states and words from a seed: the plain version's
    values, and no illegal address (the synchronise would raise).  Wb
    10400 puts one lane's block just under 48 KB of dynamic shared memory,
    over it with the static part: the launch must opt in."""
    rng = np.random.default_rng(seed)

    def rand(*shape, lo=-2**31, hi=2**31):
        return torch.from_numpy(rng.integers(lo, hi, shape, dtype=np.int64)
                                .astype(np.int32)).to(cuda)

    st = rand(nl, 8)
    # half the lanes start inside their words, the rest anywhere
    st[::2, 0] = rand((nl + 1) // 2, lo=-64, hi=32 * wb + 64)
    st[1::4, 4:7] = rand(len(range(1, nl, 4)), 3, lo=-5, hi=600)
    ops = {"words": rand(nl, wb), "ll": rand(nl, df.NSTATES),
           "of": rand(nl, df.NSTATES_OF), "ml": rand(nl, df.NSTATES),
           "st": st, "nseq": rand(nl, lo=-3, hi=400), "t_max": 400}
    _fse_equal_plain(ops)


def _huf_equal_plain(ops):
    """Launch the Huffman kernel once on `ops`, synchronise, hold it
    against the plain version; the rows are zero past each lane's count."""
    before = dh.decode_lanemajor.launches
    got = dh.decode_lanemajor(ops)
    torch.cuda.synchronize()
    assert dh.decode_lanemajor.launches == before + 1
    t_len = got.shape[1]
    assert torch.equal(got, dh.decode_plain(
        *(ops[k] for k in dh._OPERANDS), t_len))
    n = ops["nsym"].long().clamp(0, t_len)
    dead = torch.arange(t_len, device=n.device)[None, :] >= n[:, None]
    assert bool((got.masked_select(dead) == 0).all())
    return got


@pytest.mark.parametrize("wb,t_len,rec_kb", [(256, 1024, 24), (768, 4096, 48)])
def test_huf_kernel_planner_windows(cuda, wb, t_len, rec_kb):
    """The planner's window of 256 bench-corpus records at level 9: 24 KB
    records make the main path's [1024, Wb 256, T 1024] window, 48 KB ones
    a larger Wb and T bucket."""
    n = rec_kb << 10
    data = _corpus(256 * n)
    ops = _window([compress(data[i:i + n], 9)
                   for i in range(0, len(data), n)], cuda, "huf")
    assert ops["words"].shape == (1024, wb)
    assert int(ops["nsym"].max()) > 500
    assert _huf_equal_plain(ops).shape[1] == t_len


def test_huf_kernel_idle_and_padding_lanes(cuda):
    """Padding lanes (the window rounds 68 streams up to 128 lanes) and
    lanes set to nsym = 0 decode nothing and are all zeros."""
    data = _corpus(37 * 6000)
    frames = [compress(data[i:i + 6000], 9) for i in range(0, len(data), 6000)]
    plan = dp.plan_batch(frames)
    real = plan.nb.n_huf
    ops = dp.ops_to_device(plan.nb.huf_ops(0), cuda)
    dp._release_ops(plan.nb, None)
    assert ops["words"].shape[0] > real and int(ops["nsym"][real:].max()) == 0
    ops["nsym"][::5] = 0
    got = _huf_equal_plain(ops)
    assert not bool(got[::5].any())


# At Wb 10956 a lane's block takes just under 48 KB of dynamic shared
# memory in csrc/huf_decode.cu (layout(10956).total = 49,136 B), over it
# with the static part: the launch must opt in.
@pytest.mark.parametrize("nl,wb,seed", [(1, 64, 1), (33, 512, 2),
                                        (300, 2048, 3), (1024, 256, 4),
                                        (5, 10956, 5)])
def test_huf_kernel_random_window(cuda, nl, wb, seed):
    """Random operands from a seed: the plain version's symbols, and no
    illegal address (the synchronise would raise)."""
    _huf_equal_plain(_huf_random_ops(np.random.default_rng(seed), nl, wb,
                                     cuda))


def _huf_random_ops(rng, nl, wb, cuda, word_offset=0):
    """Random Huffman operands.  Even lanes look like a planner's (sorted
    11-bit limits, shifts in [0, 10], a start inside their words or up to
    two words past them); odd lanes take random int32 everywhere, so their
    consumed counts 11 - shift are arbitrary and pos moves both ways.  The
    words start `word_offset` int32 into their buffer."""

    def rand(*shape, lo=-2**31, hi=2**31):
        return torch.from_numpy(rng.integers(lo, hi, shape, dtype=np.int64)
                                .astype(np.int32)).to(cuda)

    ops = {k: rand(nl, m) for k, m in (("limits", 16), ("bases", 16),
                                       ("offs", 16), ("shifts", 16),
                                       ("planes", 64))}
    ops["words"] = rand(nl * wb + word_offset)[word_offset:].view(nl, wb)
    ops["pos"], ops["nsym"], ops["t_max"] = rand(nl), rand(nl, lo=-3,
                                                          hi=400), 400
    ev = len(range(0, nl, 2))
    ops["limits"][::2] = rand(ev, 16, lo=0, hi=2049).sort(dim=1).values
    ops["bases"][::2] = rand(ev, 16, lo=0, hi=256)
    ops["offs"][::2] = rand(ev, 16, lo=0, hi=2048)
    ops["shifts"][::2] = rand(ev, 16, lo=0, hi=11)
    ops["pos"][::2] = rand(ev, lo=-64, hi=32 * wb + 64)
    return ops


# The kernel stages a lane's words in 16-byte copies only when every row
# starts 16-byte aligned (Wb a multiple of 4, the words' pointer aligned);
# else in 4-byte copies with the zero pads right after the live words.
@pytest.mark.parametrize("wb,word_offset", [(37, 0), (256, 1), (130, 3)],
                         ids=["wb37", "misaligned", "wb130-misaligned"])
def test_huf_kernel_word_staging(cuda, wb, word_offset):
    ops = _huf_random_ops(np.random.default_rng(wb), 64, wb, cuda,
                          word_offset)
    aligned = ops["words"].data_ptr() % 16 == 0 and wb % 4 == 0
    assert not aligned and ops["words"].is_contiguous()
    _huf_equal_plain(ops)


def test_corrupt_operands_do_not_fault(planned, cuda):
    """Operands no planner would produce (random words, tables, states)
    give wrong values on both versions alike, and no illegal address."""
    rng = np.random.default_rng(9)
    huf = {k: (v if k == "t_max" else torch.from_numpy(rng.integers(
        -2**31, 2**31, tuple(v.shape), dtype=np.int64).astype(np.int32)).to(cuda))
        for k, v in planned[0].items()}
    huf["nsym"] = huf["nsym"].abs() % 700
    huf["t_max"] = 700
    fse = {k: (v if k == "t_max" else torch.from_numpy(rng.integers(
        -2**31, 2**31, tuple(v.shape), dtype=np.int64).astype(np.int32)).to(cuda))
        for k, v in planned[1].items()}
    fse["nseq"] = fse["nseq"].abs() % 500
    fse["t_max"] = 500
    got = dh.decode_lanemajor(huf)
    torch.cuda.synchronize()
    assert torch.equal(got, dh.decode_plain(
        *(huf[k] for k in dh._OPERANDS), got.shape[1]))
    got = df.decode_lanemajor(fse)
    torch.cuda.synchronize()
    want = df.decode_plain(*(fse[k] for k in df._OPERANDS), got[0].shape[1])
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_pipeline_on_card_equals_cpu(cuda):
    recs = _records(8, 24_000, 51)
    big = _records(1, 300_000, 52)[0]
    frames = [compress(x, 9) for x in recs] + [compress(big, 3)]
    outs, lens, host = Decompressor().unwrap_many_device(frames, cuda)
    c_outs, c_lens, c_host = dp.decode_batch_device(frames, "cpu")
    assert np.array_equal(lens, c_lens)
    for o, c in zip(outs, c_outs):
        assert o.device.type == "cuda" and torch.equal(o.cpu(), c)
    assert torch.equal(host[8].cpu(), c_host[8])
    assert host[8].cpu().numpy().tobytes() == big
    results, stats = dp.decode_batch_device(frames, cuda, materialize=True)
    assert results == recs + [big]
    assert stats == {"device_frames": 9, "host_frames": 0}


def test_last_sequence_reading_no_bits_on_card(cuda):
    results, stats = dp.decode_batch_device([EARLY_END_FRAME], cuda,
                                            materialize=True)
    assert results == [decompress(EARLY_END_FRAME)]
    assert stats == {"device_frames": 1, "host_frames": 0}


# case -> (shape, bytes, mask, data offset, mask offset): each tensor is
# contiguous and starts `offset` bytes into its buffer.  "text" bytes put
# 90 % of hits on 13 values; masks are prefix, random, or "none_kept" (rows
# 0 and 2 fully masked).
HIST_CASES = {
    "rows32x16384-masked": ((32, 16384), "text", "prefix", 0, 0),
    "rows32x16384": ((32, 16384), "text", None, 0, 0),
    "vector1000003": ((1_000_003,), "text", None, 0, 0),
    "rows3x5-masked": ((3, 5), "text", "prefix", 0, 0),
    **{f"rows4x{n}-{m}": ((4, n), "text", m, 0, 0)
       for n in (1, 17, 9000, 16383) for m in ("prefix", "random")},
    "view-vector": ((9001,), "text", None, 1, 0),
    "view-vector-masked": ((9001,), "text", "random", 1, 0),
    "view-rows-masked": ((6, 9000), "text", "prefix", 3, 3),
    "view-rows-mask-elsewhere": ((6, 9000), "text", "random", 5, 0),
    "one-byte-rows": ((32, 16384), "one", None, 0, 0),
    "ab-rows": ((32, 16384), "ab", None, 0, 0),
    **{f"bucket{kb}k-masked": ((32, kb << 10), "text", "prefix", 0, 0)
       for kb in (4, 16, 64, 128)},
    "rows70000x64": ((70_000, 64), "text", "random", 0, 0),
    "vector4MB+1": (((4 << 20) + 1,), "text", None, 0, 0),
    "fully-masked-rows": ((4, 9000), "text", "none_kept", 0, 0),
}


def _at_offset(a: np.ndarray, cuda, offset: int) -> torch.Tensor:
    """`a` as a contiguous tensor on the card that starts `offset` bytes
    into its buffer (a view, like ``buf[1:]`` of an [N + 1] buffer)."""
    flat = torch.from_numpy(np.ascontiguousarray(a).reshape(-1))
    buf = torch.empty(flat.numel() + offset, dtype=flat.dtype, device=cuda)
    buf[offset:] = flat.to(cuda)
    out = buf[offset:].view(a.shape)
    assert out.is_contiguous() and out.storage_offset() == offset
    return out


def _hist_operands(case: str, cuda):
    shape, kind, mask_kind, d_off, m_off = HIST_CASES[case]
    rng = np.random.default_rng(sum(shape) + len(case))
    text = np.frombuffer(b"etaoin shrdlu", np.uint8)
    if kind == "text":
        data = np.where(rng.random(shape) < 0.9, rng.choice(text, shape),
                        rng.integers(0, 256, shape)).astype(np.uint8)
    elif kind == "one":
        data = np.full(shape, 0x20, np.uint8)
    else:
        data = np.resize(np.frombuffer(b"ab", np.uint8), shape)
    mask = None
    if mask_kind == "prefix":
        count = rng.integers(0, shape[-1] + 1, shape[:-1])
        mask = np.arange(shape[-1]) < count[..., None]
    elif mask_kind == "random":
        mask = rng.random(shape) < 0.5
    elif mask_kind == "none_kept":
        mask = np.zeros(shape, bool)
        mask[1] = rng.random(shape[1]) < 0.7
    return (_at_offset(data, cuda, d_off),
            None if mask is None else _at_offset(mask, cuda, m_off))


@pytest.mark.parametrize("case", list(HIST_CASES))
def test_histogram_kernel_equals_plain(cuda, case):
    d, m = _hist_operands(case, cuda)
    b, n = (1, d.shape[0]) if d.dim() == 1 else tuple(d.shape)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    _, cpr = hg.plan(b, n, sms, m is not None)
    before = hg.histogram_u8.launches
    got = hg.histogram_u8(d, m)
    torch.cuda.synchronize()
    # one launch, and the reducing kernel's when a row takes several
    # clusters
    assert hg.histogram_u8.launches == before + (2 if cpr > 1 else 1)
    assert got.shape == (*d.shape[:-1], 256) and got.dtype == torch.int32
    assert torch.equal(got, hg.histogram_plain(d, m))
    if HIST_CASES[case][2] == "none_kept":
        assert not bool(got[0].any()) and not bool(got[2].any())


@pytest.mark.parametrize("cs,cpr", [(1, 1), (3, 1), (8, 1), (5, 2), (2, 3),
                                    (8, 5)])
def test_histogram_launcher_configs(cuda, cs, cpr):
    """Cluster sizes up to the portable 8, one cluster a row or several
    with the reducing kernel, on rows that start at odd offsets and a mask
    of another alignment."""
    from zstdsharp_tpu_torch import _build
    from zstdsharp_tpu_torch.kernel_bench import hist_launcher

    d, m = _hist_operands("view-rows-mask-elsewhere", cuda)
    run, out, used = hist_launcher(_build.load(), d, m, (cs, cpr))
    assert used == (cs, cpr)
    run()
    torch.cuda.synchronize()
    assert torch.equal(out, hg.histogram_plain(d, m))


@pytest.mark.parametrize("cs,cpr", [(9, 1), (16, 1), (0, 1), (2, 0)])
def test_histogram_launcher_refuses_bad_shapes(cuda, cs, cpr):
    """A cluster past the portable 8 blocks, an empty one or no cluster a
    row is refused with cudaErrorInvalidValue (1) before anything
    launches, and the next call is unharmed."""
    from zstdsharp_tpu_torch import _build

    d, m = _hist_operands("rows4x9000-random", cuda)
    out = torch.empty(4, 256, dtype=torch.int32, device=cuda)
    scratch = torch.empty(4, 16, 256, dtype=torch.int32, device=cuda)
    rc = _build.load().zt_histogram(
        d.data_ptr(), m.data_ptr(), 4, d.shape[1], out.data_ptr(),
        scratch.data_ptr(), cs, cpr,
        torch.cuda.current_stream(cuda).cuda_stream)
    assert rc == 1
    assert torch.equal(hg.histogram_u8(d, m), hg.histogram_plain(d, m))


def test_histogram_writes_every_bin(cuda):
    """The output comes from torch.empty: fill the caching allocator's
    block of that size with 0xFF first, and every bin must still be
    right, zeros included."""
    d, m = _hist_operands("rows4x9000-prefix", cuda)
    junk = torch.empty(4, 256, dtype=torch.int32, device=cuda)
    junk.fill_(-1)
    ptr = junk.data_ptr()
    del junk
    got = hg.histogram_u8(d, m)
    torch.cuda.synchronize()
    assert got.data_ptr() == ptr
    assert torch.equal(got, hg.histogram_plain(d, m))
    assert bool((got == 0).any())


def test_histogram_is_deterministic(cuda):
    d, m = _hist_operands("vector4MB+1", cuda)
    a = hg.histogram_u8(d, m)
    b = hg.histogram_u8(d, m)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


def test_encode_on_card_equals_cpu(cuda):
    recs = _records(40, 3_000, 61) + _records(3, 15_000, 62) + [
        np.random.default_rng(63).integers(0, 256, 9000,
                                           dtype=np.uint8).tobytes(),
        b"ab" * 9000, b"", _records(1, 131_072, 64)[0],
        _records(1, 200_000, 65)[0]]
    before = hg.histogram_u8.launches
    chunks, host = compress_batch_device(recs, cuda)
    torch.cuda.synchronize()
    assert hg.histogram_u8.launches > before
    assert list(host) == [len(recs) - 1]
    assert all(r.device.type == "cuda" for _, r, _ in chunks)
    frames, stats = compress_batch_device(recs, cuda, materialize=True)
    c_frames, c_stats = compress_batch_device(recs, "cpu", materialize=True)
    assert stats == c_stats == {"device_frames": len(recs) - 1,
                                "host_frames": 1}
    assert frames == c_frames
    assert [decompress(f) for f in frames] == recs
    results, _ = dp.decode_batch_device(frames[:43], cuda, materialize=True)
    assert results == recs[:43]


@pytest.mark.parametrize("n", [1 << 16, 1 << 17])
def test_candidate_stage_on_card_equals_cpu(cuda, n):
    rows = np.stack([np.frombuffer(b"".join(_records(1, n, n + k))[:n],
                                   np.uint8) for k in range(3)])
    rows[1, n // 2:] = np.random.default_rng(n).integers(0, 256, n - n // 2)
    ps, cand = candidate_stage(torch.from_numpy(rows).to(cuda), 16)
    c_ps, c_cand = candidate_stage(torch.from_numpy(rows), 16)
    assert ps.device.type == "cuda"
    assert torch.equal(ps.cpu(), c_ps) and torch.equal(cand.cpu(), c_cand)


def test_compress_data_parallel_on_card_equals_cpu_mesh(cuda):
    data = b"".join(_records(3, 400_000, 71))
    mesh = make_mesh()
    assert mesh[0].type == "cuda"
    tel = {}
    frame = compress_data_parallel(data, mesh[:1], level=1, telemetry=tel)
    assert frame == compress_data_parallel(data, ["cpu"], level=1)
    assert decompress(frame) == data
    assert tel["blocks"] == -(-len(data) // (1 << 17))


@pytest.fixture(scope="module")
def two_cards(cuda):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA GPUs: the mesh spans cards")
    return [torch.device("cuda", 0), torch.device("cuda", 1)]


def test_kernels_from_a_worker_thread_on_the_second_card(planned, two_cards):
    """A worker thread whose current device is cuda:0 launches each kernel
    on the card its operands are on."""
    dev = two_cards[1]
    huf, fse = ({k: (v if k == "t_max" else v.to(dev)) for k, v in o.items()}
                for o in planned)
    data = torch.from_numpy(np.frombuffer(b"etaoin shrdlu" * 999, np.uint8)
                            .copy()).to(dev)

    def run():
        torch.cuda.set_device(0)
        return (dh.decode_lanemajor(huf), df.decode_lanemajor(fse),
                hg.histogram_u8(data))

    with ThreadPoolExecutor(max_workers=1) as pool:
        h, f, g = pool.submit(run).result()
    torch.cuda.synchronize(dev)
    assert h.device == f[0].device == g.device == dev
    assert torch.equal(h, dh.decode_plain(*(huf[k] for k in dh._OPERANDS),
                                          h.shape[1]))
    for a, b in zip(f, df.decode_plain(*(fse[k] for k in df._OPERANDS),
                                       f[0].shape[1])):
        assert torch.equal(a, b)
    assert torch.equal(g, hg.histogram_plain(data))


def test_stream_codec_on_two_cards(two_cards):
    recs = _records(12, 20_000, 81)
    frames = [compress(r, 9) for r in recs]
    tel = {}
    out = decompress_data_parallel(b"".join(frames), two_cards, telemetry=tel)
    assert out == b"".join(recs)
    assert tel["device_frames"] == len(recs)
    assert [s["device"] for s in tel["device_shards"]] == ["cuda:0", "cuda:1"]
    before = hg.histogram_u8.launches
    got = compress_records_device(recs, two_cards)
    assert hg.histogram_u8.launches > before
    assert got == compress_records_device(recs, ["cpu"] * 2)
    data = b"".join(_records(3, 400_000, 82))
    assert compress_data_parallel(data, two_cards, level=1) \
        == compress_data_parallel(data, ["cpu"] * 2, level=1)


def test_dryrun_multichip_on_every_card(two_cards, capsys):
    from zstdsharp_tpu_torch.graft_entry import dryrun_multichip

    n = torch.cuda.device_count()
    dryrun_multichip(n)
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 6
    assert f"decode 16 frames over {n} shards" in lines[3]
    assert f"encode 16 frames over {n} shards" in lines[4]
