"""The port's CUDA kernels on the card: each kernel against its plain torch
version, and the decode and encode planes, the candidate stage and the
data-parallel compressor on the card against their CPU runs.  With two
cards or more, the kernels launched from a worker thread on the second
card and the stream codec over a mesh of cards.

These tests need an NVIDIA GPU and skip elsewhere.  They import only the
port (and the repository's data generator ``bench.make_corpus`` and the
benchmark's silesia_mix payload, through tests/torch_data): neither
JAX, nor the JAX package, nor zstandard, so they also run on a machine that
has none of them:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

from zstdsharp_tpu_torch.decode import device_pipeline as dp
from zstdsharp_tpu_torch.decode.frame import Decompressor, decompress
from zstdsharp_tpu_torch.encode.device_pipeline import compress_batch_device
from zstdsharp_tpu_torch.encode.frame import compress
from zstdsharp_tpu_torch.graft_entry import entry
from zstdsharp_tpu_torch.kernel_bench import (ASSEMBLE_ARGS, ASSEMBLE_PASSES,
                                             assemble_lane, assemble_passes,
                                             capture_assemble, capture_exec,
                                             capture_parse, lz_corrupt_lanes,
                                             run_assemble, run_lanes,
                                             run_parse)
from zstdsharp_tpu_torch.ops import assemble as asm
from zstdsharp_tpu_torch.ops import device_fse as df
from zstdsharp_tpu_torch.ops import device_huf as dh
from zstdsharp_tpu_torch.ops import execseq as ex
from zstdsharp_tpu_torch.ops import device_encode as de
from zstdsharp_tpu_torch.ops import histogram as hg
from zstdsharp_tpu_torch.ops import lz_parse as lp
from zstdsharp_tpu_torch.ops.matcher import candidate_stage
from zstdsharp_tpu_torch.parallel.pipeline import (compress_data_parallel,
                                                   compress_records_device,
                                                   decompress_data_parallel,
                                                   make_mesh)

from torch_parse_cases import DIAGONAL_CASES, diagonal_rows, parse_rows
from torch_assemble_cases import (CHAIN_NSEQ, assemble_call,
                                  assemble_records, chain_case_call,
                                  pad_records, roll_back)

sys.path.insert(0, str(Path(__file__).resolve().parent / "torch_data"))
from wide_frames import silesia_records  # noqa: E402

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


@pytest.fixture(scope="module")
def silesia_frames():
    """Level-3 frames of 128 KiB records of the benchmark's silesia_mix
    payload (the zfs128k cells' content), each with its FSE lane's word
    count (0 without one)."""
    out = []
    for f in (compress(r, 3) for r in silesia_records(64, 4419000302)):
        plan = dp.plan_batch([f])
        ops = plan.nb.fse_ops(0) if plan.nb.n_fse else None
        dp._release_ops(plan.nb, None)
        assert not plan.host_seqs
        out.append((f, 0 if ops is None else ops["words"].shape[1]))
    return out


@pytest.mark.parametrize("wb", [3072, 4096, 6144, 8192])
def test_fse_kernel_planner_wide_windows(cuda, silesia_frames, wb):
    """The planner's window of 128 KiB silesia_mix records at level 3
    whose widest lane takes each bucket past the reference's 2,048 words,
    with narrower lanes beside them: up to 12,800 sequences a lane."""
    frames = [f for f, w in silesia_frames if w == wb]
    assert frames, wb
    frames += [f for f, w in silesia_frames if 0 < w < wb][:32]
    ops = _window(frames, cuda)
    assert ops["words"].shape[1] == wb
    _fse_equal_plain(ops)


def _fse_smem(g: int, wb: int) -> int:
    """csrc/fse_decode.cu smem_bytes: a block's dynamic shared memory."""
    return 4 * (g * (2 * df.NSTATES + df.NSTATES_OF + wb + 8)
                + 5 * 3 * 32 * (g | 1))


FSE_SMEM_MAX = 232448 - 1024  # csrc/fse_decode.cu kSmemMax


@pytest.mark.parametrize("nl,wb,t_max,seed", [
    (256, 3072, 4096, 6), (256, 4096, 4096, 7), (256, 6144, 4096, 8),
    (256, 8192, 4096, 9), (800, 7794, 1 << 14, 10)])
def test_fse_kernel_wide_random_window(cuda, nl, wb, t_max, seed):
    """Random tables, states and words at the buckets past 2,048 words,
    lane 0 of t_max sequences: the plain version's values.  At Wb 7,794
    and 800 lanes the launcher lowers G from ceil(800 / SMs) >= 7 to 6
    lanes a block, whose shared memory is 16 B under the most a block may
    take, and lane 0 has 16,384 sequences, the top S bucket (the plain
    version's step loop makes that case about a minute on an H100)."""
    if nl == 800:
        sms = torch.cuda.get_device_properties(cuda).multi_processor_count
        assert -(-nl // sms) >= 7
        assert _fse_smem(6, wb) <= FSE_SMEM_MAX < _fse_smem(7, wb)
        assert FSE_SMEM_MAX - _fse_smem(6, wb) == 16
    rng = np.random.default_rng(seed)

    def rand(*shape, lo=-2**31, hi=2**31):
        return torch.from_numpy(rng.integers(lo, hi, shape, dtype=np.int64)
                                .astype(np.int32)).to(cuda)

    st = rand(nl, 8)
    st[:, 0] = rand(nl, lo=-64, hi=32 * wb + 64)
    st[1::4, 4:7] = rand(len(range(1, nl, 4)), 3, lo=-5, hi=600)
    nseq = rand(nl, lo=-3, hi=t_max)
    nseq[0] = t_max
    ops = {"words": rand(nl, wb), "ll": rand(nl, df.NSTATES),
           "of": rand(nl, df.NSTATES_OF), "ml": rand(nl, df.NSTATES),
           "st": st, "nseq": nseq, "t_max": t_max}
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
    c_outs, c_lens, c_host = dp.decode_batch_device(frames, device="cpu")
    assert np.array_equal(lens, c_lens)
    for o, c in zip(outs, c_outs):
        assert o.device.type == "cuda" and torch.equal(o.cpu(), c)
    assert torch.equal(host[8].cpu(), c_host[8])
    assert host[8].cpu().numpy().tobytes() == big
    results, stats = dp.decode_batch_device(frames, device=cuda,
                                            materialize=True)
    assert results == recs + [big]
    assert stats == {"device_frames": 9, "host_frames": 0}


def _dict_sets():
    """tests/torch_data/dict_sets.py, the committed dictionary frames."""
    import dict_sets

    return dict_sets


def _bytes_of(n, outs, lens, host):
    """Each frame's bytes from unwrap_many_device's return: rows follow the
    frames that host_results does not hold."""
    rows = [r for o in outs for r in o.cpu().numpy()]
    got, k = [], 0
    for fi in range(n):
        v = host.get(fi)
        if v is None:
            got.append(rows[k][:lens[k]].tobytes())
            k += 1
        else:
            got.append(v if isinstance(v, bytes) else v.cpu().numpy().tobytes())
    return got


@pytest.mark.parametrize("name", ["json", "corpus"])
def test_dictionary_set_on_card_equals_cpu(cuda, name):
    """A committed dictionary set through load_dictionary and
    unwrap_many_device on the card: every frame on the card, rows equal to
    the records and to the port's CPU run.  Set 1's literal sections are
    all raw, so it launches the FSE kernel only; set 2 launches both (with
    the dictionary's Huffman weights on its treeless sections)."""
    d, frames, recs = _dict_sets().load(name)
    dec = Decompressor()
    dec.load_dictionary(d)
    huf0, fse0 = dh.decode_lanemajor.launches, df.decode_lanemajor.launches
    outs, lens, host = dec.unwrap_many_device(frames, cuda)
    torch.cuda.synchronize()
    assert df.decode_lanemajor.launches > fse0
    assert (dh.decode_lanemajor.launches > huf0) == (name == "corpus")
    assert not any(isinstance(v, bytes) for v in host.values())
    assert all(o.device.type == "cuda" for o in outs)
    assert all(v.device.type == "cuda" for v in host.values())
    assert _bytes_of(len(frames), outs, lens, host) == recs
    c_outs, c_lens, c_host = dp.decode_batch_device(
        frames, device="cpu", ddict=dec._dict._parsed)
    assert np.array_equal(lens, c_lens) and len(outs) == len(c_outs)
    for o, c in zip(outs, c_outs):
        assert torch.equal(o.cpu(), c)
    assert set(host) == set(c_host)
    assert all(torch.equal(v.cpu(), c_host[k]) for k, v in host.items())


def test_public_api_default_device_and_trainer_on_card(cuda):
    """The port's public names on the card host: its trainer and
    ``wrap_many`` reproduce the committed json set, and
    ``unwrap_many_device`` with no device decodes it on the card."""
    import zstdsharp_tpu_torch as z

    sets = _dict_sets()
    d, frames, recs = sets.load("json")
    got = z.train_dictionary(recs[:1000], sets.JSON_DICT_SIZE)
    assert got == d
    c = z.Compressor(level=sets.JSON_LEVEL)
    c.load_dictionary(got)
    assert c.wrap_many(recs) == frames
    dec = z.Decompressor()
    dec.load_dictionary(got)
    outs, lens, host = dec.unwrap_many_device(frames)
    torch.cuda.synchronize()
    assert outs and all(o.device == torch.device("cuda", 0) for o in outs)
    assert all(not isinstance(v, bytes) and v.device.type == "cuda"
               for v in host.values())
    assert _bytes_of(len(frames), outs, lens, host) == recs
    assert dec.unwrap_many(frames) == recs


def test_dictionary_kernels_equal_plain(cuda):
    """Each decode kernel against its plain version on a dictionary
    batch's operands: the Huffman window of set 2 (fresh trees and the
    dictionary's weights) and the FSE window of set 1 (the dictionary's
    tables and repcodes in the lane states)."""
    from zstdsharp_tpu_torch.dictionary import parse_dictionary

    sets = _dict_sets()
    for name, which in (("corpus", "huf"), ("json", "fse")):
        d, frames, _ = sets.load(name)
        plan = dp.plan_batch(frames, parse_dictionary(d))
        ops = dp.ops_to_device(getattr(plan.nb, f"{which}_ops")(0), cuda)
        dp._release_ops(plan.nb, None)
        if which == "huf":
            assert int(ops["nsym"].max()) > 0
            _huf_equal_plain(ops)
        else:
            assert int(ops["nseq"].max()) > 0
            _fse_equal_plain(ops)


def _lanes_equal_plain(call):
    """Launch the fused lane decode once on a ``capture_exec`` record
    (an in-place output on a copy), synchronise (a fault raises here),
    hold its rows (or the whole updated output) byte for byte and its
    flags against ``lanes_plain`` on the card.  Returns the flags."""
    before = ex.execute_lanes.launches
    got, bad = run_lanes(call)
    torch.cuda.synchronize()
    assert ex.execute_lanes.launches == before + 1
    want, want_bad = run_lanes(call, ex.lanes_plain)
    assert got.shape == want.shape and torch.equal(got, want)
    assert bad.dtype == torch.int32 and torch.equal(bad, want_bad)
    return bad


def test_lz_exec_decode_cell_chunks(cuda):
    """The bench's decode batch (256 records of 24 KB at level 9): its 4
    chunks of 64 lanes [O 24576] in one launch of the fused kernel."""
    n = 24 << 10
    data = _corpus(6 << 20)
    frames = [compress(data[i:i + n], 9) for i in range(0, 6 << 20, n)]
    before = ex.execute_lanes.launches
    calls = capture_exec(lambda: dp.decode_batch_device(frames, device=cuda))
    assert ex.execute_lanes.launches == before + 1
    assert len(calls) == 1 and calls[0]["O"] == n
    assert tuple(calls[0]["meta"].shape) == (256, 12)
    assert int(calls[0]["meta"][:, 8].max()) > 1000
    assert not _lanes_equal_plain(calls[0]).any()


def test_lz_exec_multi_block_rounds(cuda):
    """Two 400 KB level-3 frames: the dependent rounds, each one launch
    that reads its lanes' windows (the 1 MB of content before the block)
    out of the accumulator and writes [2, 131072] rows into it in place."""
    data = _corpus(1 << 20)
    frames = [compress(data[:400_000], 3), compress(data[400_000:800_000], 3)]
    calls = capture_exec(lambda: dp.decode_batch_device(frames, device=cuda))
    assert len(calls) >= 3 and {c["O"] for c in calls} == {1 << 17}
    for call in calls:
        assert call["out"] is not None and call["window"] is call["out"]
        assert call["W"] == 1 << 20 and call["win_start"] is not None
        assert not _lanes_equal_plain(call).any()


def test_lz_exec_dictionary_window_row(cuda):
    """Dictionary set 2: the 112,640-byte dictionary's tail as one 128 KB
    window row broadcast to the lanes (stride 0), and its multi-block
    frames' windows of content plus dictionary read in place."""
    from zstdsharp_tpu_torch.dictionary import parse_dictionary

    d, frames, _ = _dict_sets().load("corpus")
    pd = parse_dictionary(d)
    calls = capture_exec(lambda: dp.decode_batch_device(frames, device=cuda,
                                                        ddict=pd))
    assert any(c["window"].shape[1] == 1 << 17
               and c["window"].stride(0) == 0 for c in calls)
    assert any(c["out"] is not None for c in calls)
    for call in calls:
        assert not _lanes_equal_plain(call).any()


def test_lz_exec_dictionary_set_one_launch(cuda):
    """Dictionary set 1 (5,000 JSON frames): every lane in one launch,
    where the chunked executor took 79."""
    from zstdsharp_tpu_torch.dictionary import parse_dictionary

    d, frames, _ = _dict_sets().load("json")
    pd = parse_dictionary(d)
    calls = capture_exec(lambda: dp.decode_batch_device(frames, device=cuda,
                                                        ddict=pd))
    assert len(calls) == 1 and calls[0]["meta"].shape[0] == 5056
    assert not _lanes_equal_plain(calls[0]).any()


@pytest.mark.parametrize("N,S,O,W,sources,broadcast,seed", [
    (64, 256, 4096, 8, "all", False, 11),
    (200, 1024, 24576, 1 << 15, "all", False, 12),
    (5, 4096, 1 << 17, 1 << 17, "all", False, 13),
    (33, 100, 3000, 0, "raw", False, 14),
    (130, 4096, 24576, 8, "all", False, 15),
    (64, 256, 4096, 8, "all", False, 1),
    (16, 1024, 24576, 1 << 15, "all", True, 2),
    (4, 4096, 1 << 17, 1 << 17, "all", False, 3),
    (33, 100, 3000, 0, "all", False, 4),
    (64, 4096, 24576, 8, "all", False, 5)])
def test_lz_decode_random_corrupt_meta(cuda, N, S, O, W, sources, broadcast,
                                       seed):
    """Meta rows that index past every source, seg 0 and below, n_seq past
    S, negative sequence values, windows a lane or one row broadcast to
    every lane (stride 0): the plain version's bytes (chains, pool
    references below index 0, positions past O, cycles) and flags, and no
    illegal address."""
    call = lz_corrupt_lanes(np.random.default_rng(seed), N, S, O, W, cuda,
                            sources, broadcast)
    assert not broadcast or call["window"].stride(0) == 0
    assert _lanes_equal_plain(call).any()


def test_lz_decode_many_lanes_one_launch(cuda):
    """One launch serves any number of lanes: 300 lanes (more than the 64
    of a chunk and than the card's SMs) and 65,600 lanes at O = 4096 (past
    a 2-D grid's 65,535 in one dimension), each a copy of a decoded
    record's lane."""
    n = 4096
    data = _corpus(1 << 20)
    frames = [compress(data[i:i + n], 9) for i in range(0, 20 * n, n)]
    calls = capture_exec(lambda: dp.decode_batch_device(frames, device=cuda))
    call = calls[0]
    assert call["O"] == n
    for lanes in (300, 65_600):
        idx = torch.arange(lanes, device=cuda) % 20
        big = dict(call, meta=call["meta"][idx].contiguous(),
                   window=call["window"][:1].expand(lanes, -1))
        before = ex.execute_lanes.launches
        rows, bad = run_lanes(big)
        torch.cuda.synchronize()
        assert ex.execute_lanes.launches == before + 1
        assert not bad.any()
        for k in (0, 7, lanes - 1):
            assert rows[k].cpu().numpy().tobytes() == \
                data[(k % 20) * n:(k % 20 + 1) * n]


def test_lz_decode_in_place_round_equals_gather_scatter(cuda):
    """A multi-block round in place (window read from the accumulator, rows
    written into it) equals the same lanes' windows gathered, decoded into
    new rows and scattered back, clamped starts included."""
    data = _corpus(1 << 20)
    frames = [compress(data[:400_000], 3), compress(data[400_000:800_000], 3)]
    calls = capture_exec(lambda: dp.decode_batch_device(frames, device=cuda))
    for call in calls[:3]:
        for shift in (0, -(1 << 21), 1 << 24):  # in range, clamped low/high
            c = dict(call, win_start=call["win_start"] + shift,
                     out_start=call["out_start"] + shift)
            got, bad = run_lanes(c)
            acc = c["out"].clone()
            A, W, O = acc.shape[1], c["W"], c["O"]
            ws = c["win_start"].clamp(0, A - W)[:, None] + \
                torch.arange(W, device=cuda)
            rows, want_bad = ex.execute_lanes(
                c["meta"], c["src"], c["S"], O, torch.gather(acc, 1, ws))
            os_ = c["out_start"].clamp(0, A - O)[:, None] + \
                torch.arange(O, device=cuda)
            acc.scatter_(1, os_, rows)
            assert torch.equal(got, acc) and torch.equal(bad, want_bad)


def test_lz_exec_largest_shapes(cuda):
    """O = 128 KB (the top output bucket) with the largest window, 4 MB a
    lane, raw pool literals and host sequence rows (seq_kind 2) of valid
    sequences: overlapping matches, matches back into the output and deep
    into the window.  No lane is flagged."""
    B, S, O, W = 4, 8192, 1 << 17, 1 << 22
    rng = np.random.default_rng(6)
    ll = np.zeros((B, S), np.int32)
    ml = np.zeros((B, S), np.int32)
    off = np.ones((B, S), np.int32)
    meta = np.zeros((B, 12), np.int64)
    for b in range(B):
        pos, k = 0, 0
        while k < S:
            lk, mk = int(rng.integers(0, 20)), int(rng.integers(3, 60))
            if pos + lk + mk > O - 64:
                break
            kind = int(rng.integers(0, 3))
            ok = (int(rng.integers(1, mk + 1)) if kind == 0 else
                  int(rng.integers(1, pos + lk + 1)) if kind == 1 and pos
                  else int(rng.integers(pos + lk + 1, pos + lk + W + 1)))
            ll[b, k], ml[b, k], off[b, k] = lk, mk, ok
            pos, k = pos + lk + mk, k + 1
        regen = int(ll[b].sum()) + 40
        # raw literals at b * O, host row b, out_len the lane's total, the
        # whole window real bytes before it
        meta[b] = (0, b * O, regen, 0, 0, 2, -1, b, k, regen, pos + 40, W)
    t = torch.from_numpy
    src = ex.LaneSources(
        t(rng.integers(0, 256, B * O + 1, dtype=np.uint8)).to(cuda),
        host=tuple(t(a).to(cuda) for a in (ll, ml, off)))
    call = {"meta": t(meta).to(cuda), "src": src, "S": S, "O": O,
            "window": t(rng.integers(0, 256, (B, W), dtype=np.uint8)).to(
                cuda),
            "win_start": None, "W": None, "out": None, "out_start": None}
    assert int(meta[:, 8].min()) > 1000
    assert not _lanes_equal_plain(call).any()


def test_lz_exec_flags_on_mutated_batch(cuda):
    """Frames libzstd would reject, made on this host: 8 records of 6,000 B
    of make_corpus at level 9 (the port's compress, no checksum), 300
    trials from random.Random(7) each flipping 1-4 bits of one frame.  On
    every operand set the decode plane gives the executor, the kernel's
    flags equal the plain version's; decode_batch_device(materialize=True)
    raises wherever the host decompress raises, and otherwise returns the
    host's bytes."""
    import random

    from zstdsharp_tpu_torch.errors import ZstdError

    data = _corpus(1 << 20)
    recs = [data[i * 6000:(i + 1) * 6000] for i in range(8)]
    frames = [compress(r, 9) for r in recs]
    rng = random.Random(7)
    flagged = rejected = 0
    for _ in range(300):
        fi = rng.randrange(8)
        f = bytearray(frames[fi])
        for _ in range(rng.randint(1, 4)):
            f[rng.randrange(len(f))] ^= 1 << rng.randrange(8)
        batch = frames[:fi] + [bytes(f)] + frames[fi + 1:]
        try:
            want = decompress(bytes(f))
        except ZstdError:
            want = None
        try:
            calls = capture_exec(lambda: dp.decode_batch_device(batch,
                                                                device=cuda))
        except ZstdError:  # a host-routed frame the host rejects
            assert want is None
            calls = []
        for call in calls:
            flagged += int(_lanes_equal_plain(call).any())
        if want is None:
            rejected += 1
            with pytest.raises(ZstdError):
                dp.decode_batch_device(batch, device=cuda, materialize=True)
        else:
            got, _ = dp.decode_batch_device(batch, device=cuda,
                                            materialize=True)
            assert got[fi] == want
    assert rejected > 0 and flagged > 0


@pytest.mark.parametrize("rate_log", [4, 7, 12])
def test_ldm_anchor_mask_on_card_equals_cpu(cuda, rate_log):
    from zstdsharp_tpu_torch.ops.ldm import ldm_anchor_mask

    src = torch.from_numpy(np.frombuffer(_corpus((1 << 20) + 3), np.uint8)
                           .copy())
    got = ldm_anchor_mask(src.to(cuda), rate_log)
    assert got.device.type == "cuda" and got.dtype == torch.uint8
    assert torch.equal(got.cpu(), ldm_anchor_mask(src, rate_log))


def test_last_sequence_reading_no_bits_on_card(cuda):
    results, stats = dp.decode_batch_device([EARLY_END_FRAME], device=cuda,
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
    chunks, host = compress_batch_device(recs, device=cuda)
    torch.cuda.synchronize()
    assert hg.histogram_u8.launches > before
    assert list(host) == [len(recs) - 1]
    assert all(r.device.type == "cuda" for _, r, _ in chunks)
    frames, stats = compress_batch_device(recs, device=cuda, materialize=True)
    c_frames, c_stats = compress_batch_device(recs, device="cpu",
                                              materialize=True)
    assert stats == c_stats == {"device_frames": len(recs) - 1,
                                "host_frames": 1}
    assert frames == c_frames
    assert [decompress(f) for f in frames] == recs
    results, _ = dp.decode_batch_device(frames[:43], device=cuda,
                                        materialize=True)
    assert results == recs[:43]


def test_native_table_builders_on_card_equal_plain(cuda, monkeypatch):
    """One 32-lane chunk of Kafka records sections (45-60 KiB of JSON
    events, the 64 KiB bucket) encoded on the card: the frames built with
    the native table builders equal those built with the plain Python
    builders, byte for byte, and decode with the port's decoder and with
    the benchmark's plain RFC 8878 decoder (zstandard is not installed
    beside the card)."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from benchmark.payloads import kafka_json_events
    from benchmark.reference.zstd_plain import decode_frame

    lengths = 46_080 + 480 * np.arange(32)
    recs = kafka_json_events.make(lengths, np.random.default_rng(4419000332))
    timings = {}
    frames, stats = compress_batch_device(recs, True, device=cuda,
                                          timings=timings)
    assert stats == {"device_frames": 32, "host_frames": 0}
    assert timings["n.table_lanes"] == 32
    assert timings["n.huf_lanes"] == 32  # every JSON lane takes Huffman
    monkeypatch.setattr(de, "_build_lit_tables", de._build_lit_tables_plain)
    monkeypatch.setattr(de, "_build_seq_tables", de._build_seq_tables_plain)
    plain, _ = compress_batch_device(recs, True, device=cuda)
    assert frames == plain
    assert [decompress(f) for f in frames] == recs
    assert [decode_frame(f) for f in frames] == recs


def _parse_equal(blocks, nv, S, hash_log, rounds, compact):
    """parse_lanes (one launch) against parse_plain on the same CUDA
    tensors: every output, exactly.  Returns the kernel's outputs."""
    before = lp.parse_lanes.launches
    got = lp.parse_lanes(blocks, nv, S, hash_log, *rounds, compact=compact)
    torch.cuda.synchronize()
    assert lp.parse_lanes.launches == before + 1
    want = lp.parse_plain(blocks, nv, S, hash_log, *rounds, compact=compact)
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        assert torch.equal(got[k], w), k
    return got


def _parse_operands(n, seed, cuda):
    """parse_rows' 15 cases and 17 rows of the corpus: one 32-lane chunk."""
    blocks, nv = parse_rows(seed, n)
    corpus = np.frombuffer(_corpus(17 * n), np.uint8).reshape(17, n)
    blocks = np.concatenate([blocks, corpus])
    nv = np.concatenate([nv, np.full(17, n, np.int32)])
    return torch.from_numpy(blocks).to(cuda), torch.from_numpy(nv).to(cuda)


@pytest.mark.parametrize("n", [1 << 12, 1 << 14, 1 << 16, 1 << 17])
def test_lz_parse_buckets_equal_plain(cuda, n):
    blocks, nv = _parse_operands(n, n, cuda)
    got = _parse_equal(blocks, nv, de.seq_budget(n), 15, (8, 8), True)
    assert int(got["nseq"].max()) > 100
    assert bool((got["mls"] == 640).any())  # capped, chained sequences


@pytest.mark.parametrize("hash_log,rounds,compact", [
    (15, (16, 24), False), (16, (16, 24), False), (16, (8, 8), True),
    (10, (8, 8), True), (1, (8, 8), True), (15, (2, 0), True)],
    ids=["15_16_24", "16_16_24", "16_compact", "collisions", "one_bit",
         "no_stride"])
def test_lz_parse_tables_and_rounds_equal_plain(cuda, hash_log, rounds,
                                               compact):
    n = 1 << 15
    blocks, nv = _parse_operands(n, hash_log, cuda)
    _parse_equal(blocks, nv, n // 8, hash_log, rounds, compact)


@pytest.mark.parametrize("S", [1, 16, 200])
def test_lz_parse_sequence_cap_equals_plain(cuda, S):
    blocks, nv = _parse_operands(1 << 14, S, cuda)
    got = _parse_equal(blocks, nv, S, 15, (8, 8), True)
    assert int(got["nseq"].max()) == S


def test_lz_parse_odd_width_and_n_valid_equal_plain(cuda):
    blocks, _ = parse_rows(5, 1000)
    nv = np.array([1000, 1050, -3, 517, 4, 0] + [999] * 9, np.int32)
    _parse_equal(torch.from_numpy(blocks).to(cuda),
                 torch.from_numpy(nv).to(cuda), 300, 13, (8, 8), True)


def test_lz_parse_is_deterministic(cuda):
    """20 launches in a row give the same outputs: the table walk behind
    the hash groups' producers, the runs' scan and the segments' walks do
    not depend on which warp runs first."""
    blocks, nv = _parse_operands(1 << 14, 3, cuda)
    a = lp.parse_lanes(blocks, nv, 3276, 15, 8, 8, compact=True)
    again = [lp.parse_lanes(blocks, nv, 3276, 15, 8, 8, compact=True)
             for _ in range(20)]
    torch.cuda.synchronize()
    assert all(torch.equal(a[k], b[k]) for b in again for k in a)


@pytest.mark.parametrize("B", [1, 3, 32, 256])
def test_lz_parse_lane_counts_equal_plain(cuda, B):
    """One launch of 1, 3, 32 and 256 lanes of 16 KB (the chunk's rows
    repeated), each lane as in the chunk."""
    blocks, nv = _parse_operands(1 << 14, 12, cuda)
    idx = torch.arange(B, device=cuda) % blocks.shape[0]
    got = _parse_equal(blocks[idx].contiguous(), nv[idx].contiguous(),
                       3276, 15, (8, 8), True)
    one = _parse_equal(blocks, nv, 3276, 15, (8, 8), True)
    for k in got:
        assert torch.equal(got[k], one[k][idx]), k


@pytest.mark.parametrize("rounds", [(8, 8), (16, 24)])
@pytest.mark.parametrize("n", [1 << 12, 1 << 17])
@pytest.mark.parametrize("case", DIAGONAL_CASES)
def test_lz_parse_diagonal_cases_equal_plain(cuda, case, n, rounds):
    """Runs of one byte and of periods 2-7 past the rounds' reach, runs
    cut by n_valid or running into N, diagonals restarting after a
    mismatch; the maps in shared memory (4 KB) and in device memory (128
    KB)."""
    blocks, nv = diagonal_rows(case, n, 2)
    _parse_equal(torch.from_numpy(blocks).to(cuda),
                 torch.from_numpy(nv).to(cuda), n // 8, 15, rounds,
                 rounds == (8, 8))


def test_lz_parse_stamps_each_pass(cuda):
    """parse_lanes(stamps=) writes each row's SM clock at the start and
    after each pass (the clears, v32 with the hash groups and the table
    walk, the diagonal lengths, the selection, the outputs), in order, and
    changes no output."""
    blocks, nv = _parse_operands(1 << 14, 6, cuda)
    stamps = torch.zeros(blocks.shape[0], 6, dtype=torch.int64, device=cuda)
    a = lp.parse_lanes(blocks, nv, 3276, 15, 8, 8, compact=True,
                       stamps=stamps)
    b = lp.parse_lanes(blocks, nv, 3276, 15, 8, 8, compact=True)
    torch.cuda.synchronize()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert bool((stamps[:, 1:] >= stamps[:, :-1]).all())
    assert bool((stamps[:, 5] > stamps[:, 0]).all())
    assert bool((stamps[:, 4] > stamps[:, 3]).all())  # the selection ran


def test_lz_parse_raises_off_the_card_and_on_bad_shapes(cuda):
    blocks, nv = _parse_operands(1 << 12, 4, cuda)
    with pytest.raises(ValueError, match="no CUDA kernel"):
        lp.parse_lanes(blocks.cpu(), nv.cpu(), 64, 15, 8, 8, compact=True)
    big = torch.zeros(2, lp.MAX_N + 1, dtype=torch.uint8, device=cuda)
    for args in ((big, nv[:2], 64, 15), (blocks[0], nv, 64, 15),
                 (blocks, nv[:3], 64, 15), (blocks, nv, 0, 15),
                 (blocks, nv, 64, lp.MAX_HASH_LOG + 1),
                 (blocks[:, ::2], nv, 64, 15)):
        with pytest.raises(ValueError):
            lp.parse_lanes(*args, 8, 8, compact=True)
    with pytest.raises(TypeError):
        lp.parse_lanes(blocks.to(torch.int32), nv, 64, 15, 8, 8,
                       compact=True)


def test_encode_and_entry_parse_through_the_kernel(cuda):
    """The encode plane and parse_block_stats launch the kernel, one
    launch a chunk, and each captured call equals the plain version."""
    recs = _records(40, 3_000, 81) + [b"ab" * 9000]
    calls = capture_parse(lambda: compress_batch_device(recs, device=cuda))
    assert [c["blocks"].shape for c in calls] == [(32, 4096), (32, 4096),
                                                  (32, 65536)]
    fn, args = entry(cuda)
    calls += capture_parse(lambda: fn(*args))
    assert calls[-1]["hash_log"] == 15 and not calls[-1]["compact"]
    for c in calls:
        got = run_parse(c)
        want = run_parse(c, lp.parse_plain)
        assert all(torch.equal(got[k], want[k]) for k in want)
    c_fn, c_args = entry("cpu")
    got, want = fn(*args), c_fn(*c_args)
    assert all(torch.equal(got[k].cpu(), want[k]) for k in want)


def _assemble_equal(call):
    """assemble_lanes (one launch) against assemble_plain on the same CUDA
    tensors: rows and out_len byte for byte.  Returns the kernel's."""
    before = asm.assemble_lanes.launches
    rows, lens = run_assemble(call)
    torch.cuda.synchronize()
    assert asm.assemble_lanes.launches == before + 1
    want_rows, want_lens = run_assemble(call, asm.assemble_plain)
    assert rows.dtype == torch.uint8 and lens.dtype == torch.int32
    assert rows.shape == want_rows.shape and lens.shape == want_lens.shape
    assert torch.equal(lens, want_lens)
    assert torch.equal(rows, want_rows)
    return rows, lens


@pytest.mark.parametrize("n", [1 << 12, 1 << 14, 1 << 16, 1 << 17])
def test_assemble_buckets_equal_plain(cuda, n):
    """A 32-lane chunk of each bucket from parse_rows and the corpus,
    through the real parse and tables (the 128 KB chunk runs from device
    memory, the others from shared memory)."""
    blocks, nv = _parse_operands(n, n + 1, cuda)
    call = assemble_call(blocks, nv)
    _, lens = _assemble_equal(call)
    assert int(call["parsed"]["nseq"].max()) > 100
    assert bool((lens < nv.to(torch.int32) + 12).any())  # compressed lanes


@pytest.mark.parametrize("huf_literals", [True, False])
@pytest.mark.parametrize("n", [1 << 12, 1 << 14])
def test_assemble_edge_lanes_equal_plain(cuda, n, huf_literals):
    """nseq 0, 1, 2 and the cap, literals under 64, raw blocks with and
    without sequences, empty / 1-byte / n-byte records, fresh, RLE and a
    rolled-back lane, with Huffman literals on and off."""
    blocks, nv = pad_records(assemble_records(n, n + huf_literals), n)
    call = assemble_call(torch.from_numpy(blocks).to(cuda),
                         torch.from_numpy(nv).to(cuda), huf_literals)
    ns, mode = call["parsed"]["nseq"], call["seq"]["mode"]
    roll_back(call, int(torch.nonzero((ns >= 32) & (mode > 0))[-1]))
    assert int(ns.max()) == call["parsed"]["starts"].shape[1]
    _assemble_equal(call)


@pytest.mark.parametrize("n", [1 << 12, 1 << 14, 1 << 16, 1 << 17])
def test_assemble_chain_lengths_equal_plain(cuda, n):
    """The lane at the bucket's sequence cap kept at every chain length of
    CHAIN_NSEQ up to S (and S - 1), a lane each: the segment cuts' edges,
    the cut's changes of segment count, ns = S; then 20 more launches give
    the same bytes."""
    blocks, nv = pad_records(assemble_records(n, n + 7), n)
    call = assemble_call(torch.from_numpy(blocks).to(cuda),
                         torch.from_numpy(nv).to(cuda))
    S = call["parsed"]["starts"].shape[1]
    ns = call["parsed"]["nseq"]
    lane = int(ns.argmax())
    assert int(ns[lane]) == S
    nseqs = sorted({min(x, S) for x in CHAIN_NSEQ} | {S - 1})
    cases = chain_case_call(call, lane, nseqs)
    rows, lens = _assemble_equal(cases)
    for _ in range(20):
        again, again_lens = run_assemble(cases)
        assert torch.equal(again, rows) and torch.equal(again_lens, lens)


@pytest.mark.parametrize("W,WQ", [(3, 2000), (400, 5), (1, 1)])
def test_assemble_cut_streams_equal_plain(cuda, W, WQ):
    """Capacities below the streams' lengths: halves past them dropped,
    the bytes past them repeating the last kept byte."""
    blocks, nv = pad_records(assemble_records(1 << 12, 5), 1 << 12)
    call = assemble_call(torch.from_numpy(blocks).to(cuda),
                         torch.from_numpy(nv).to(cuda))
    _assemble_equal(dict(call, W=W, WQ=WQ))


def test_assemble_one_lane_and_determinism(cuda):
    """The lane with most sequences alone (the serial floor's operands)
    gives its row in the chunk; two launches give the same bytes."""
    blocks, nv = _parse_operands(1 << 14, 9, cuda)
    call = assemble_call(blocks, nv)
    rows, lens = _assemble_equal(call)
    lane = int(call["parsed"]["nseq"].argmax())
    one, one_lens = _assemble_equal(assemble_lane(call, lane))
    assert torch.equal(one[0], rows[lane]) and one_lens[0] == lens[lane]
    again, _ = run_assemble(call)
    torch.cuda.synchronize()
    assert torch.equal(again, rows)


def test_assemble_stamps_time_every_pass(cuda):
    """assemble_lanes(stamps=) leaves the rows as they are and gives each
    lane's SM clock at the start and after each pass, increasing, with
    time in the chains pass; a stamps tensor of another shape raises."""
    blocks, nv = _parse_operands(1 << 14, 9, cuda)
    call = assemble_call(blocks, nv)
    rows, lens = _assemble_equal(call)
    stamps = torch.zeros(32, asm.STAMPS, dtype=torch.int64, device=cuda)
    got = asm.assemble_lanes(*(call[k] for k in ASSEMBLE_ARGS),
                             stamps=stamps)
    torch.cuda.synchronize()
    assert torch.equal(got[0], rows) and torch.equal(got[1], lens)
    d = stamps[:, 1:] - stamps[:, :-1]
    assert bool((d > 0).all())
    passes = assemble_passes(call)
    most = passes["most_sequences_cycles"]
    assert list(most) == list(ASSEMBLE_PASSES) and most["chains"] > 0
    with pytest.raises(ValueError):
        asm.assemble_lanes(*(call[k] for k in ASSEMBLE_ARGS),
                           stamps=stamps[:, :4].contiguous())


def test_entry_points_keyword_device_on_card(cuda):
    """The reference's positional call with the device as a keyword: the
    frames equal the CPU run's and decode on the card to the records."""
    recs = _records(20, 5_000, 93) + [b"ab" * 3000]
    frames, stats = compress_batch_device(recs, True, 15, device=cuda)
    assert frames == compress_batch_device(recs, True, 15, device="cpu")[0]
    assert stats["device_frames"] == len(recs)
    results, stats = dp.decode_batch_device(frames, True, None, device=cuda)
    assert results == recs and stats["device_frames"] == len(recs)
    with pytest.raises(TypeError, match="device="):
        dp.decode_batch_device(frames, cuda)


def test_assemble_raises_off_the_card_and_on_bad_operands(cuda):
    blocks, nv = _parse_operands(1 << 12, 4, cuda)
    call = assemble_call(blocks, nv)
    args = [call[k] for k in ASSEMBLE_ARGS]
    cpu = assemble_call(blocks.cpu(), nv.cpu())
    with pytest.raises(ValueError, match="no CUDA kernel"):
        asm.assemble_lanes(*(cpu[k] for k in ASSEMBLE_ARGS))
    for i, bad in ((0, args[0][:, ::2]), (0, args[0][0]), (1, args[1][:3]),
                   (3, args[3][:, :100].contiguous()),
                   (0, torch.zeros(32, 4000, dtype=torch.uint8,
                                   device=cuda))):
        with pytest.raises(ValueError):
            asm.assemble_lanes(*args[:i], bad, *args[i + 1:])
    with pytest.raises(TypeError):
        asm.assemble_lanes(args[0].to(torch.int32), *args[1:])
    with pytest.raises(ValueError):
        asm.assemble_lanes(*args[:7], 0, args[8])
    maps = call["seq"]["ll"][0]
    seq = dict(call["seq"], ll=(maps.cpu(), *call["seq"]["ll"][1:]))
    with pytest.raises(ValueError):
        asm.assemble_lanes(*args[:6], seq, *args[7:])


def test_encode_plane_assembles_through_the_kernel(cuda):
    """compress_batch_device launches the kernel once a chunk, and each
    captured call equals the plain version."""
    recs = _records(40, 3_000, 91) + [b"ab" * 9000, b""]
    before = asm.assemble_lanes.launches
    calls = capture_assemble(lambda: compress_batch_device(recs, device=cuda))
    torch.cuda.synchronize()
    assert asm.assemble_lanes.launches == before + len(calls) == before + 3
    for c in calls:
        _assemble_equal(c)


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
