"""FSE sequence decode of the torch port against the JAX package.

Operands come from the native planner on small frame batches and from
seeded numpy streams through ``ops_from_batch``.  The port's plain torch
version must equal the JAX package's ``decode_lanemajor`` (Pallas, in
interpret mode on the CPU) and its numpy mirror ``decode_reference``,
exactly, over each lane's first n_seq sequences (the values are integers).
"""

import jax  # noqa: F401  (the reference runs on the CPU in this process)
import numpy as np
import pytest
import torch
import zstandard

from zstdsharp_tpu.decode.block import (EntropyState, decode_literals,
                                        decode_sequence_headers,
                                        decode_sequences)
from zstdsharp_tpu.decode.device_glue import _CodedDT
from zstdsharp_tpu.decode.frame import decompress, parse_frame_header
from zstdsharp_tpu.encode.frame import compress
from zstdsharp_tpu.ops import device_fse as ref
from zstdsharp_tpu_torch.decode.device_pipeline import (_release_ops,
                                                        decode_batch_device,
                                                        ops_to_device,
                                                        plan_batch)
from zstdsharp_tpu_torch.ops import device_fse as df
from test_torch_cuda import EARLY_END_FRAME  # JAX-free module


def _text(rng, n):
    words = [b"red ", b"green ", b"blue ", b"cyan ", b"magenta ", b"yellow ",
             b"black ", b"white "]
    return b"".join(words[int(i)] for i in rng.integers(0, len(words), n))[:n]


def _frames(seed=17):
    rng = np.random.default_rng(seed)
    return [compress(_text(rng, int(n)), lvl)
            for n, lvl in ((3000, 1), (5000, 3), (4000, 9), (6000, 19),
                           (2500, 5), (7000, 9))]


@pytest.fixture(scope="module")
def planned():
    """Numpy FSE operands the native planner packs for a small batch
    (copied out of the pooled buffers before the ctx goes back)."""
    plan = plan_batch(_frames())
    ops = {k: (v if k == "t_max" else np.array(v))
           for k, v in plan.nb.fse_ops(0).items()}
    _release_ops(plan.nb, None)
    assert int((ops["nseq"] > 0).sum()) == 6
    return ops


def _masked(rows, n):
    rows = np.asarray(rows)
    keep = np.arange(rows.shape[1])[None, :] < np.asarray(n)[:, None]
    return np.where(keep, rows, 0)


def test_plain_equals_jax_kernel_on_planned_sections(planned):
    got = df.decode_lanemajor(ops_to_device(planned, "cpu"))
    want = [np.asarray(x) for x in ref.decode_lanemajor(planned)]
    n = planned["nseq"]
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and tuple(g.shape) == w.shape
        assert np.array_equal(_masked(g.numpy(), n), _masked(w, n))
        assert np.array_equal(g.numpy(), _masked(g.numpy(), n))


def _sections_of(frame):
    """(payload, coded tables, nseq, rep, host-decoded (ll, ml, of)) of
    every sequence section of a frame."""
    out = []
    hdr = parse_frame_header(np.frombuffer(frame, np.uint8))
    p = hdr.header_size
    ent = EntropyState()
    while True:
        bh = int.from_bytes(frame[p:p + 3], "little")
        last, btype, bsize = bh & 1, (bh >> 1) & 3, bh >> 3
        if btype == 2:
            payload = bytes(frame[p + 3:p + 3 + bsize])
            _, n = decode_literals(payload, ent)
            rest = payload[n:]
            nbseq, ll, of, ml, used = decode_sequence_headers(rest, ent)
            if nbseq:
                rep = list(ent.rep)
                seqs = decode_sequences(rest[used:], nbseq, ll, of, ml,
                                        ent.rep)
                out.append((rest[used:], (_CodedDT(ll, "ll"),
                                          _CodedDT(of, "of"),
                                          _CodedDT(ml, "ml")),
                            nbseq, rep, seqs))
        p += 3 + (1 if btype == 1 else bsize)
        if last:
            break
    return out


def _sections():
    """(payload, coded tables, nseq, rep) of every sequence section."""
    return [s[:4] for f in _frames(23) for s in _sections_of(f)]


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_plain_equals_reference_mirror_on_synthetic_streams(seed):
    """Real tables, seeded random bitstreams, repcodes and counts: the
    decode is garbage but must be the same garbage."""
    rng = np.random.default_rng(seed)
    secs = _sections()
    payloads, tables, nseqs, reps = [], [], [], []
    for _ in range(int(rng.integers(16, 48))):
        _, tabs, _, _ = secs[int(rng.integers(0, len(secs)))]
        p = bytearray(rng.integers(0, 256, int(rng.integers(1, 900)),
                                   dtype=np.uint8).tobytes())
        p[-1] = int(rng.integers(1, 256))
        payloads.append(bytes(p))
        tables.append(tabs)
        nseqs.append(int(rng.integers(1, 300)))
        reps.append([int(x) for x in rng.integers(1, 5000, 3)])
    batch = ref.prepare_batch(payloads, tables, nseqs, reps)
    got = df.decode_lanemajor(df.ops_from_batch(batch, "cpu"))
    want = ref.decode_reference(batch)
    n = batch.n_seq.reshape(-1)
    t = batch.t_max
    for g, w in zip(got, want):
        w32 = w.T.astype(np.int64).astype(np.int32)   # the kernel's int32
        assert np.array_equal(_masked(g.numpy()[:, :t], n), _masked(w32, n))


def test_ops_from_batch_states_match_reference():
    secs = _sections()
    batch = ref.prepare_batch(*(list(x) for x in zip(*secs)))
    ops = df.ops_from_batch(batch, "cpu")
    st = ref.initial_states(batch).reshape(7, ref.LANES).T
    assert np.array_equal(ops["st"][:, :7].numpy(), st)
    assert not ops["st"][:, 7].any()
    got = df.decode_lanemajor(ops)
    for i, (_, _, nb, _) in enumerate(secs):
        assert int(ops["nseq"][i]) == nb
    # real sections: equal to the numpy mirror over their n_seq rows
    want = ref.decode_reference(batch)
    for g, w in zip(got, want):
        for i, (_, _, nb, _) in enumerate(secs):
            assert np.array_equal(g[i, :nb].numpy(), w[:nb, i])


def test_pack_table_and_constants_match_reference():
    ll, of, ml = _sections()[0][1]
    for dt in (ll, of, ml):
        assert np.array_equal(df.pack_table(dt), ref.pack_table(dt))
    for name in ("LL_BASE", "LL_BITS", "ML_BASE", "ML_BITS"):
        assert np.array_equal(getattr(df, name), getattr(ref, name))
    for t in (0, 1, 256, 257, 5000, 32768):
        assert df.bucket_t(t) == ref.bucket_t(t)
        assert df.bucket_w(min(t, 2048)) == ref.bucket_w(min(t, 2048))


@pytest.mark.parametrize("w,wb", [(2048, 2048), (2049, 3072), (3073, 4096),
                                  (4097, 6144), (6145, 8192), (8192, 8192)])
def test_word_buckets_past_the_reference_window(w, wb):
    """Up to the reference's window the buckets are its own (above); past
    it the port's run to MAX_W, 32 KiB of words."""
    assert df.REF_MAX_W == ref.MAX_W < df.MAX_W == 8192
    assert df.bucket_w(w) == wb


def test_window_takes_its_widest_lane_bucket():
    """A window uploads [lanes, the bucket of its widest lane] words, not
    the pooled rows' MAX_W."""
    plan = plan_batch(_frames())
    nb = plan.nb
    w = int(nb._fse["fse_wlen"][:nb.n_fse].max())
    words = nb.fse_ops(0)["words"]
    rows = nb._fse["fse_words"].shape[1]
    _release_ops(nb, None)
    assert words.shape[1] == df.bucket_w(w) < rows == df.MAX_W


@pytest.mark.parametrize("fault", ["dtype", "shape", "layout", "device",
                                   "no_kernel_device"])
def test_wrapper_rejects_what_the_kernel_does_not_take(planned, fault):
    ops = ops_to_device(planned, "cpu")
    if fault == "dtype":
        ops["ll"] = ops["ll"].to(torch.int16)
    elif fault == "shape":
        ops["of"] = torch.zeros(ops["of"].shape[0], 512, dtype=torch.int32)
    elif fault == "layout":
        ops["st"] = ops["st"].t().contiguous().t()
    elif fault == "device":
        ops["nseq"] = ops["nseq"].to("meta")
    else:
        ops = {k: (v if k == "t_max" else v.to("meta")) for k, v in ops.items()}
    before = df.decode_lanemajor.launches
    with pytest.raises((TypeError, ValueError)):
        df.decode_lanemajor(ops)
    assert df.decode_lanemajor.launches == before


def test_cpu_tensors_take_the_plain_version(planned):
    before = df.decode_lanemajor.launches
    df.decode_lanemajor(ops_to_device(planned, "cpu"))
    assert df.decode_lanemajor.launches == before



def test_last_sequence_reading_no_bits_is_decoded():

    want = zstandard.ZstdDecompressor().decompress(EARLY_END_FRAME)
    assert decompress(EARLY_END_FRAME) == want
    plan = plan_batch([EARLY_END_FRAME])
    ops = {k: (v if k == "t_max" else np.array(v))
           for k, v in plan.nb.fse_ops(0).items()}
    _release_ops(plan.nb, None)
    assert int(ops["nseq"][0]) == 129
    ll, ml, of = df.decode_lanemajor(ops_to_device(ops, "cpu"))
    (_, _, nb, _, host), = _sections_of(EARLY_END_FRAME)
    assert nb == 129
    for got, exp in zip((ll, ml, of), host):
        assert np.array_equal(got[0, :129].numpy(), exp.astype(np.int32))
    results, _ = decode_batch_device([EARLY_END_FRAME], device="cpu",
                                     materialize=True)
    assert results == [want]
