"""The port's data-parallel stream codec (parallel/pipeline.py), its matcher
pieces (candidate_stage, parse_block, parse_block_stats) and its entry
points (graft_entry.py) against the JAX package, on the CPU.

The JAX side runs as its own tests run it: on the 8 virtual CPU devices of
tests/conftest.py, with x64 on as ``zstdsharp_tpu.ops`` sets it.  The port
runs on an explicit mesh of CPU shards (``["cpu"] * 8``).  Every comparison
is exact: equal integer arrays, equal bytes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zstdsharp_tpu.decode.frame import decompress
from zstdsharp_tpu.encode.frame import compress
from zstdsharp_tpu.ops import matcher as ref
from zstdsharp_tpu.parallel import pipeline as rp
from zstdsharp_tpu_torch.ops import matcher as tm
from zstdsharp_tpu_torch.parallel import pipeline as tp

CPU8 = ["cpu"] * 8
PARSE_KEYS = ("starts", "mls", "offs", "nseq", "covered")


def _rows(seed, n):
    """Four rows: word text, noise, text then zeros, and a short period."""
    rng = np.random.default_rng(seed)
    words = [b"alpha ", b"beta ", b"gamma ", b"delta ", b"epsilon "]
    text = b"".join(words[i] for i in rng.integers(0, 5, n // 3))[:n]
    rows = np.zeros((4, n), np.uint8)
    rows[0] = np.frombuffer(text, np.uint8)
    rows[1] = rng.integers(0, 256, n, dtype=np.uint8)
    rows[2, :n // 2] = rows[0, n // 3:n // 3 + n // 2]
    rows[3] = np.frombuffer((b"abcdXabcdYabcdZ" * (n // 15 + 1))[:n], np.uint8)
    return rows


def _np(d):
    return {k: np.asarray(v) for k, v in d.items()}


@pytest.mark.parametrize("n,hash_log,u64", [
    (1 << 16, 16, False),   # the level >= 3 probe: u32 keys
    (1 << 17, 16, True),    # 128 KiB blocks: u64 keys
    (4096, 12, False),
])
def test_candidate_stage_equals_reference(n, hash_log, u64):
    assert (hash_log + max((n - 1).bit_length(), 1) > 32) == u64
    rows = _rows(n, n)
    ps, cand = jax.vmap(lambda b: ref.candidate_stage(b, hash_log))(
        jnp.asarray(rows))
    got_ps, got_cand = tm.candidate_stage(torch.from_numpy(rows), hash_log)
    assert got_ps.dtype == got_cand.dtype == torch.int32
    assert np.array_equal(got_ps.numpy(), np.asarray(ps))
    assert np.array_equal(got_cand.numpy(), np.asarray(cand))
    assert (got_cand >= 0).float().mean() > 0.3


def test_candidates_are_most_recent_match():
    data = np.frombuffer(b"abcdXabcdYabcdZ" * 40, dtype=np.uint8).copy()
    ps, cand = tm.candidate_stage(torch.from_numpy(data)[None], 12)
    by_pos = np.empty(len(data), np.int32)
    by_pos[ps[0].numpy()] = cand[0].numpy()
    assert (by_pos >= 0).sum() > len(data) // 2
    for p in range(len(data) - 4):
        c = by_pos[p]
        if c >= 0:
            assert c < p
            assert bytes(data[c:c + 4]) == bytes(data[p:p + 4])
            # most recent: no later position before p shares the 4 bytes
            assert all(bytes(data[q:q + 4]) != bytes(data[p:p + 4])
                       for q in range(c + 1, p))


@pytest.mark.parametrize("n,hash_log,max_seq", [
    (4096, 12, None),
    (4096, 12, 64),        # nseq capped on the text rows
    (2048, 10, 100),
])
def test_parse_block_equals_reference(n, hash_log, max_seq):
    rows = _rows(n + 1, n)
    nv = np.array([n, n - 5, n // 2, 1000], np.int32)
    want = _np(jax.vmap(lambda b, v: ref.parse_block(b, v, hash_log, max_seq))(
        jnp.asarray(rows), jnp.asarray(nv)))
    got = tm.parse_block(torch.from_numpy(rows), torch.from_numpy(nv),
                         hash_log, max_seq)
    for k in PARSE_KEYS:
        assert got[k].numpy().dtype == want[k].dtype, k
        assert np.array_equal(got[k].numpy(), want[k]), k
    # the text row's nseq reaches its cap (n // 8 by default)
    assert int(want["nseq"][0]) == (max_seq or n // 8)


def test_parse_block_roundtrip_semantics():
    data = (b"the quick brown fox " * 100)[:1600]
    block = np.zeros((1, 2048), np.uint8)
    block[0, :len(data)] = np.frombuffer(data, np.uint8)
    r = tm.parse_block(torch.from_numpy(block),
                       torch.tensor([len(data)], dtype=torch.int32), 12, 256)
    assert int(r["nseq"][0]) > 0
    for k in range(int(r["nseq"][0])):
        s, m, o = (int(r["starts"][0, k]), int(r["mls"][0, k]),
                   int(r["offs"][0, k]))
        assert o > 0 and s - o >= 0
        assert data[s:s + m] == data[s - o:s - o + m]


def test_parse_block_stats_equals_reference():
    n = 8192
    rows = _rows(5, n)
    nv = np.array([n, 7000, n // 2, 3000], np.int32)
    want = _np(jax.vmap(lambda b, v: ref.parse_block_stats(b, v, 13))(
        jnp.asarray(rows), jnp.asarray(nv)))
    got = tm.parse_block_stats(torch.from_numpy(rows), torch.from_numpy(nv),
                               13)
    assert set(got) == set(want)
    for k in want:
        assert got[k].numpy().dtype == want[k].dtype, k
        assert np.array_equal(got[k].numpy(), want[k]), k
    assert int(want["of_hist"].sum()) == int(want["nseq"].sum())
    assert int(want["lit_hist"].sum()) > 0


def test_sharded_parse_equals_reference(text_corpus):
    data = text_corpus[:300_000]
    blocks, nv, n_blocks = tp.shard_blocks(data, 8, 1 << 15)
    r_blocks, r_nv, r_n = rp.shard_blocks(data, 8, 1 << 15)
    assert (n_blocks, blocks.shape) == (r_n, (16, 1 << 15))
    assert np.array_equal(blocks, r_blocks) and np.array_equal(nv, r_nv)
    want = rp.make_sharded_parse(rp.make_mesh(), block_size=1 << 15)(
        jnp.asarray(blocks), jnp.asarray(nv))
    got = tp.make_sharded_parse(tp.make_mesh(CPU8), block_size=1 << 15)(
        blocks, nv)
    assert len(got["ps"]) == len(got["cand"]) == 8
    for k in ("ps", "cand"):
        assert all(t.shape == (2, 1 << 15) for t in got[k])
        assert np.array_equal(torch.cat(got[k]).numpy(), np.asarray(want[k]))
    assert int(got["global_candidates"]) == int(want["global_candidates"])


def test_sharded_parse_rejects_bad_shapes():
    parse = tp.make_sharded_parse(CPU8, block_size=4096)
    with pytest.raises(ValueError):
        parse(np.zeros((8, 2048), np.uint8), np.zeros(8, np.int32))
    with pytest.raises(ValueError):
        parse(np.zeros((12, 4096), np.uint8), np.zeros(12, np.int32))


def test_make_mesh_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        tp.make_mesh()
    assert tp.make_mesh(["cpu"] * 3) == [torch.device("cpu")] * 3


def _rep_carry_input():
    r = np.random.default_rng(3)
    block0 = b"hello world pattern " * 100 + bytes(
        r.integers(0, 256, 2096, dtype=np.uint8))
    block1 = b"Z" * 2000 + bytes(r.integers(0, 256, 2096, dtype=np.uint8))
    return (block0 + block1)[:8192]


def _noise_head_text():
    r = np.random.default_rng(7)
    noise = bytes(r.integers(0, 256, 1 << 16, dtype=np.uint8))
    words = [b"sequence", b"entropy", b"window", b"the", b"of", b"stream"]
    text = b" ".join(words[i] for i in r.choice(len(words), size=150_000))
    return noise + text[:700_000]


@pytest.mark.parametrize("case", ["level1", "checksum", "rep_carry", "empty",
                                  "level3_framewise"])
def test_compress_data_parallel_equals_reference(case, text_corpus):
    kw = {"block_size": 1 << 14}
    data = text_corpus[:200_000]
    if case == "checksum":
        kw["checksum"] = True
    elif case == "rep_carry":
        data, kw = _rep_carry_input(), {"block_size": 4096}
    elif case == "empty":
        data = b""
    elif case == "level3_framewise":
        data, kw = _noise_head_text(), {"level": 3}
    r_tel, tel = {}, {}
    want = rp.compress_data_parallel(data, rp.make_mesh(), telemetry=r_tel,
                                     **kw)
    got = tp.compress_data_parallel(data, tp.make_mesh(CPU8), telemetry=tel,
                                    **kw)
    assert got == want
    if case != "level3_framewise":
        assert decompress(got) == data
    assert set(tel) == set(r_tel)
    if tel:
        assert (tel["bytes"], tel["blocks"]) == (r_tel["bytes"],
                                                 r_tel["blocks"])
    if case == "level3_framewise":
        # one frame per job; the noise head does not raw-gate the text
        import io

        import zstandard

        rd = zstandard.ZstdDecompressor().stream_reader(
            io.BytesIO(got), read_across_frames=True)
        assert rd.read() == data
        assert len(got) <= len(compress(data, 3)) * 1.02


def test_framewise_raw_gate_on_noise():
    """A job of incompressible bytes becomes a raw frame (probe density
    below 0.02), as in the reference."""
    noise = bytes(np.random.default_rng(8).integers(0, 256, 300_000,
                                                    dtype=np.uint8))
    got = tp._compress_framewise_parallel(noise, ["cpu"] * 2, 5, True)
    assert got == rp._compress_framewise_parallel(
        noise, rp.make_mesh(jax.devices()[:2]), 5, True)
    assert len(got) > len(noise)  # raw frames: headers on top of the bytes
    assert decompress(got) == noise


def _frames(text_corpus, n, size, level=3):
    chunks = [text_corpus[i * size:(i + 1) * size] for i in range(n)]
    return chunks, [compress(c, level) for c in chunks]


def test_decompress_data_parallel_device_frames(text_corpus):
    chunks, frames = _frames(text_corpus, 8, 1500)
    tel = {}
    out = tp.decompress_data_parallel(b"".join(frames), tp.make_mesh(CPU8),
                                      telemetry=tel)
    assert out == b"".join(chunks)
    assert tel["device_frames"] == 8 and tel["host_frames"] == 0
    assert len(tel["device_shards"]) == 8
    assert tel["bytes"] == len(out)
    assert set(tel) == {"frames", "device_frames", "host_frames", "scan_ms",
                        "plan_ms", "device_ms", "gather_ms", "host_ms",
                        "bytes", "device_shards"}


def test_decompress_data_parallel_mixed_and_single(text_corpus):
    """Multi-block frames go to the host engine beside device frames; a
    one-frame stream without telemetry takes the host shortcut."""
    chunks, frames = _frames(text_corpus, 5, 2000, level=1)
    big = text_corpus[:300_000]
    stream = frames[0] + compress(big, 3) + b"".join(frames[1:])
    tel = {}
    out = tp.decompress_data_parallel(stream, ["cpu"] * 3, telemetry=tel)
    assert out == chunks[0] + big + b"".join(chunks[1:])
    assert (tel["device_frames"], tel["host_frames"]) == (5, 1)
    assert tp.decompress_data_parallel(compress(big, 3), CPU8) == big


def test_compress_records_device_equals_reference():
    r = np.random.default_rng(21)
    words = [b"record ", b"field ", b"value ", b"zstd ", b"key "]
    recs = [b"".join(words[i] for i in r.integers(0, 5, k))
            for k in (100, 300, 700)]
    recs += [b"zstd " * 400, b"", bytes(r.integers(0, 256, 140_000,
                                                   dtype=np.uint8))]
    r_tel, tel = {}, {}
    want = rp.compress_records_device(recs, rp.make_mesh(jax.devices()[:2]),
                                      telemetry=r_tel)
    got = tp.compress_records_device(recs, ["cpu"] * 2, telemetry=tel)
    assert got == want
    assert [decompress(f) for f in got] == recs
    assert {k: tel[k] for k in ("device_frames", "host_frames", "shards")} \
        == {k: r_tel[k] for k in ("device_frames", "host_frames", "shards")}
    assert (tel["device_frames"], tel["host_frames"]) == (5, 1)


def test_entry_equals_reference():
    import __graft_entry__ as rg

    from zstdsharp_tpu_torch import graft_entry as g

    fn, args = g.entry("cpu")
    assert all(a.device.type == "cpu" for a in args)
    got = fn(*args)
    r_fn, r_args = rg.entry()
    want = _np(jax.jit(r_fn)(*r_args))
    assert np.array_equal(args[0].numpy(), np.asarray(r_args[0]))
    assert set(got) == set(want)
    for k in want:
        assert got[k].numpy().dtype == want[k].dtype, k
        assert np.array_equal(got[k].numpy(), want[k]), k
    assert got["nseq"].shape == (4,)


def test_dryrun_multichip_cpu(capsys):
    from zstdsharp_tpu_torch import graft_entry as g

    g.dryrun_multichip(8, device="cpu")
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 6
    assert all(ln.startswith("dryrun_multichip(8)") for ln in lines)
    assert "device-plane decode 16 frames over 8 shards" in lines[3]
    assert "device-plane encode 16 frames over 8 shards" in lines[4]


def test_dryrun_multichip_needs_the_cards(monkeypatch):
    from zstdsharp_tpu_torch import graft_entry as g

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError):
        g.dryrun_multichip(1)
    with pytest.raises(ValueError):
        g.dryrun_multichip(1, device="tpu")
