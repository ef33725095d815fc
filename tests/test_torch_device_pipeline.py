"""The torch port's record-batch decode plane end to end, on the CPU (the
kernel wrappers take their plain torch versions there).  The cases mirror
tests/test_device_pipeline.py; decoded bytes must equal the inputs, and the
device-resident rows and lengths must equal the JAX package's exactly.
"""

import jax  # noqa: F401  (the reference runs on the CPU in this process)
import numpy as np
import pytest
import torch
import zstandard

from zstdsharp_tpu.decode import device_pipeline as ref
from zstdsharp_tpu.decode.frame import parse_frame_header
from zstdsharp_tpu.encode.frame import compress
from zstdsharp_tpu_torch.decode import device_pipeline as dp
from zstdsharp_tpu_torch.decode.frame import Decompressor
from zstdsharp_tpu_torch.errors import ZstdError, ZstdErrorCode

CPU = torch.device("cpu")


def _records(n, size, seed=7):
    r = np.random.default_rng(seed)
    words = [b"alpha", b"bravo", b"charlie", b"delta", b"echo", b"foxtrot",
             b"golf", b"hotel", b"india", b"juliet"]
    return [b" ".join(words[int(i)] for i in r.integers(0, len(words),
                                                        size // 6 + 2))[:size]
            for _ in range(n)]


def _decode(frames):
    return dp.decode_batch_device(frames, CPU, materialize=True)


def test_record_batch_bit_exact():
    recs = _records(12, 6_000)
    results, stats = _decode([compress(x, 5) for x in recs])
    assert stats == {"device_frames": 12, "host_frames": 0}
    assert results == recs


def test_device_resident_rows_equal_reference():
    recs = _records(5, 5_000, seed=9) + [b"Q" * 3000]
    big = _records(1, 150_000, seed=10)[0]
    frames = [compress(x, 3) for x in recs] + [
        zstandard.ZstdCompressor(level=3).compress(big)]
    outs, lens, host = dp.decode_batch_device(frames, CPU)
    r_outs, r_lens, r_host = ref.decode_batch_device(frames)
    assert np.array_equal(lens, r_lens)
    assert len(outs) == len(r_outs)
    for o, r in zip(outs, r_outs):
        assert o.device == CPU and o.dtype == torch.uint8
        assert np.array_equal(o.numpy(), np.asarray(r))
    assert set(host) == set(r_host) == {6}
    assert np.array_equal(host[6].numpy(), np.asarray(r_host[6]))
    assert host[6].numpy().tobytes() == big
    for k, rec in enumerate(recs):
        assert outs[0][k, :lens[k]].numpy().tobytes() == rec


def test_mixed_block_types():
    r = np.random.default_rng(3)
    payloads = [r.integers(0, 256, 5_000, dtype=np.uint8).tobytes(),
                b"Q" * 30_000, _records(1, 8_000)[0], b"z" * 17,
                r.integers(0, 256, 100, dtype=np.uint8).tobytes()]
    results, stats = _decode([compress(x, 6) for x in payloads])
    assert results == payloads
    assert stats["host_frames"] == 0


@pytest.mark.parametrize("level", [1, 3, 9, 19])
def test_oracle_frames(level):
    recs = _records(3, 7_000, seed=21 + level)
    zc = zstandard.ZstdCompressor(level=level, write_content_size=True)
    results, stats = _decode([zc.compress(x) for x in recs])
    assert stats == {"device_frames": 3, "host_frames": 0}
    assert results == recs


def test_single_stream_huffman_on_device():
    rng = np.random.default_rng(61)
    words = [b"alpha ", b"bravo ", b"charlie ", b"delta ", b"echo "]
    small = [b"".join(words[int(i)] for i in rng.integers(0, 5, 60))[:300]
             for _ in range(6)]
    frames = [zstandard.ZstdCompressor(level=19).compress(x) for x in small]
    plan = dp.plan_batch(frames)
    dp._release_ops(plan.nb, None)
    assert not plan.host_routed
    assert any(b.lit_kind == 1 and b.huf_seg == b.lit_regen
               for b in plan.blocks)
    results, stats = _decode(frames)
    assert results == small and stats["host_frames"] == 0


def test_multiblock_frames_run_as_dependent_rounds():
    big = _records(1, 300_000)[0]
    c = zstandard.ZstdCompressor(level=5, write_checksum=True)
    mid = _records(1, 140_000, seed=8)[0]
    frames = [compress(big, 3), compress(b"tiny", 1), c.compress(mid)]
    plan = dp.plan_batch(frames)
    dp._release_ops(plan.nb, None)
    assert not plan.host_routed and len(plan.mb_frames) == 2
    results, stats = _decode(frames)
    assert results == [big, b"tiny", mid]
    assert stats == {"device_frames": 3, "host_frames": 0}


def test_oversized_sections_take_the_python_planner():
    """Streams beyond the kernels' 8 KB envelope: the native planner hands
    the frame to the Python planner, which host-decodes Huffman literals
    into the raw pool and sequences into host rows."""
    r = np.random.default_rng(1)
    lits = bytes(r.integers(48, 88, 60_000, dtype=np.uint8))
    mix = bytearray(_records(1, 40_000, seed=2)[0])
    for k in range(0, len(mix), 7):
        mix[k] = int(r.integers(48, 90))
    frames = [compress(lits, 1), compress(bytes(mix), 1)]
    plan = dp.plan_batch(frames)
    dp._release_ops(plan.nb, None)
    assert not plan.host_routed
    assert (plan.blocks[0].lit_kind, plan.blocks[0].seq_kind) == (0, 0)
    assert plan.blocks[1].seq_kind == 2 and plan.host_seqs
    results, stats = _decode(frames)
    assert results == [lits, bytes(mix)]
    assert stats == {"device_frames": 2, "host_frames": 0}


def test_checksum_mismatch_raises():
    rec = _records(1, 8_000, seed=13)[0]
    frame = bytearray(compress(rec, 5, checksum=True))
    frame[-1] ^= 0x40
    with pytest.raises(ZstdError) as ei:
        _decode([bytes(frame)])
    assert ei.value.code == ZstdErrorCode.checksum_wrong


def test_multiblock_checksum_mismatch_raises():
    rec = _records(1, 140_000, seed=83)[0]
    frame = bytearray(zstandard.ZstdCompressor(
        level=5, write_checksum=True).compress(rec))
    frame[-1] ^= 0x10
    with pytest.raises(ZstdError) as ei:
        _decode([bytes(frame)])
    assert ei.value.code == ZstdErrorCode.checksum_wrong


def test_checksum_verified_ok():
    rec = _records(1, 8_000, seed=17)[0]
    results, stats = _decode([compress(rec, 5, checksum=True)])
    assert results == [rec] and stats["device_frames"] == 1


def test_corrupt_raw_block_size_routes_to_host():
    data = np.random.default_rng(3).integers(0, 256, 5000,
                                             dtype=np.uint8).tobytes()
    frame = bytearray(compress(data, 1))
    hsz = parse_frame_header(np.frombuffer(bytes(frame), np.uint8)).header_size
    bh = int.from_bytes(frame[hsz:hsz + 3], "little")
    assert (bh >> 1) & 3 == 0  # raw block
    frame[hsz:hsz + 3] = ((bh & 7) | ((bh >> 3) - 1 << 3)).to_bytes(3, "little")
    plan = dp.plan_batch([bytes(frame)])
    dp._release_ops(plan.nb, None)
    assert "corrupt" in plan.host_routed.get(0, "")


def test_truncated_frame_routes_to_host():
    frame = compress(_records(1, 8_000, seed=11)[0], 5)
    plan = dp.plan_batch([frame[:len(frame) - 3]])
    dp._release_ops(plan.nb, None)
    assert 0 in plan.host_routed


def test_frame_without_content_size_is_host_decoded():
    rec = _records(1, 9_000, seed=4)[0]
    frame = zstandard.ZstdCompressor(
        level=3, write_content_size=False).compress(rec)
    good = _records(1, 3_000, seed=5)[0]
    results, stats = _decode([frame, compress(good, 3)])
    assert results == [rec, good]
    assert stats == {"device_frames": 1, "host_frames": 1}
    outs, lens, host = dp.decode_batch_device([frame], CPU)
    assert outs == [] and host == {0: rec}


def _tlog12_frame():
    """A valid frame whose Huffman tree has tableLog 12 (the kernel peeks
    11 bits, so it must be host-routed)."""
    from zstdsharp_tpu import constants as C
    from zstdsharp_tpu.encode.block import _literals_header
    from zstdsharp_tpu.encode.frame import _block_header, _write_frame_header
    from zstdsharp_tpu.entropy import huffman

    weights = np.array([1, 1] + list(range(2, 13)), np.uint8)
    ct = huffman.ctable_from_weights(weights, 12)
    p = 2.0 ** (weights.astype(np.float64) - 1)
    syms = np.random.default_rng(5).choice(
        np.arange(len(weights), dtype=np.uint8), size=1200, p=p / p.sum())
    body = huffman.write_ctable(ct) + huffman.encode_4x(syms, ct)
    block = _literals_header(C.LiteralsBlockType.COMPRESSED, 2, len(syms),
                             len(body)) + body + b"\x00"
    frame = (_write_frame_header(len(syms), 19, False, True, 0)
             + _block_header(True, C.BlockType.COMPRESSED, len(block)) + block)
    return frame, syms.tobytes()


def test_tablelog12_frame_routes_to_host():
    frame, content = _tlog12_frame()
    plan = dp.plan_batch([frame])
    dp._release_ops(plan.nb, None)
    assert 0 in plan.host_routed
    results, stats = _decode([frame])
    assert results == [content] and stats["host_frames"] == 1


def test_dictionary_raises_not_implemented():
    rng = np.random.default_rng(64)
    words = [b"unwrap ", b"many ", b"device ", b"dict "]
    samples = [b"".join(words[int(i)] for i in rng.integers(0, 4, 30))
               for _ in range(200)]
    d = zstandard.train_dictionary(4096, samples)
    frames = [zstandard.ZstdCompressor(level=3, dict_data=d).compress(
        samples[0] * 3)]
    dec = Decompressor()
    dec.load_dictionary(d.as_bytes())
    with pytest.raises(NotImplementedError):
        dec.unwrap_many_device(frames, CPU)
    with pytest.raises(NotImplementedError):
        dp.decode_batch_device(frames, CPU, ddict=dec._dict)


def test_unwrap_many_device_entry_point():
    recs = _records(4, 4_000, seed=31)
    frames = [compress(x, 9) for x in recs]
    outs, lens, host = Decompressor().unwrap_many_device(frames, "cpu")
    assert not host and list(lens) == [len(x) for x in recs]
    rows = outs[0].numpy()
    assert [rows[k, :lens[k]].tobytes() for k in range(4)] == recs


def test_missing_native_planner_raises(monkeypatch, tmp_path):
    # an engine that can be neither loaded nor built
    monkeypatch.setattr(dp.native, "_lib", None)
    monkeypatch.setattr(dp.native, "SRC", tmp_path / "missing.cpp")
    monkeypatch.setattr(dp.native, "TRACKED_LIB", tmp_path / "missing.so")
    monkeypatch.setattr(dp.native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="native host engine"):
        dp.decode_batch_device([compress(b"abc" * 100, 3)], CPU)


def test_stage_timings_are_recorded():
    frames = [compress(x, 5) for x in _records(3, 4_000, seed=41)]
    timings = {}
    dp.decode_batch_device(frames, CPU, timings=timings)
    assert {"plan", "huf", "fse", "exec"} <= set(timings)
    assert all(v >= 0 for v in timings.values())

