"""The torch port's record-batch decode plane end to end, on the CPU (the
kernel wrappers take their plain torch versions there).  The cases mirror
tests/test_device_pipeline.py; decoded bytes must equal the inputs, and the
device-resident rows and lengths must equal the JAX package's exactly, with
and without a dictionary.
"""

import sys
from pathlib import Path

import jax  # noqa: F401  (the reference runs on the CPU in this process)
import numpy as np
import pytest
import torch
import zstandard

from zstdsharp_tpu.decode import device_pipeline as ref
from zstdsharp_tpu.decode.frame import parse_frame_header
from zstdsharp_tpu.dictionary import parse_dictionary as r_parse_dictionary
from zstdsharp_tpu.encode.frame import compress
from zstdsharp_tpu.errors import ZstdError as RZstdError
from zstdsharp_tpu_torch.decode import device_pipeline as dp
from zstdsharp_tpu_torch.decode.frame import Decompressor
from zstdsharp_tpu_torch.dictionary import parse_dictionary
from zstdsharp_tpu_torch.errors import ZstdError, ZstdErrorCode
from zstdsharp_tpu_torch.ops import device_fse as df

sys.path.insert(0, str(Path(__file__).resolve().parent / "torch_data"))
import dict_sets  # noqa: E402
from wide_frames import silesia_records, wide_sequence_frame  # noqa: E402

CPU = torch.device("cpu")


def _records(n, size, seed=7):
    r = np.random.default_rng(seed)
    words = [b"alpha", b"bravo", b"charlie", b"delta", b"echo", b"foxtrot",
             b"golf", b"hotel", b"india", b"juliet"]
    return [b" ".join(words[int(i)] for i in r.integers(0, len(words),
                                                        size // 6 + 2))[:size]
            for _ in range(n)]


def _decode(frames):
    return dp.decode_batch_device(frames, device=CPU, materialize=True)


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
    outs, lens, host = dp.decode_batch_device(frames, device=CPU)
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


def test_entry_points_take_the_reference_arguments():
    """Both device entry points take the reference's positional parameters
    in its order (the device only as a keyword) and raise TypeError,
    naming device=, on a device passed in materialize's place; the decode
    entry gives the reference's bytes on the reference's positional call
    (the encode entry's: tests/test_torch_device_encode.py)."""
    import inspect

    from zstdsharp_tpu.encode import device_pipeline as ref_enc
    from zstdsharp_tpu_torch.encode import device_pipeline as enc

    for port, reference in ((dp.decode_batch_device, ref.decode_batch_device),
                            (enc.compress_batch_device,
                             ref_enc.compress_batch_device)):
        ref_params = list(inspect.signature(reference).parameters)
        params = inspect.signature(port).parameters
        assert list(params)[:len(ref_params)] == ref_params
        for name in ("device", "timings"):
            assert params[name].kind is inspect.Parameter.KEYWORD_ONLY
        assert params["device"].default == "cuda"
    recs = _records(5, 5_000, seed=9) + [b"Q" * 3000]
    frames = [compress(x, 3) for x in recs]
    results, stats = dp.decode_batch_device(frames, True, None, device="cpu")
    want, want_stats = ref.decode_batch_device(frames, True, None)
    assert results == want == recs and stats == want_stats
    for bad in ("cpu", CPU):
        for call in (lambda: dp.decode_batch_device(frames, bad),
                     lambda: enc.compress_batch_device(recs, bad)):
            with pytest.raises(TypeError, match="device="):
                call()


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
    """Streams beyond the kernels' windows (Huffman 8 KB, FSE 32 KB): the
    native planner hands the frame to the Python planner, which
    host-decodes Huffman literals into the raw pool and sequences into
    host rows."""
    r = np.random.default_rng(1)
    lits = bytes(r.integers(48, 88, 60_000, dtype=np.uint8))
    wide, wide_frame = wide_sequence_frame(2)
    frames = [compress(lits, 1), wide_frame]
    plan = dp.plan_batch(frames)
    dp._release_ops(plan.nb, None)
    assert not plan.host_routed
    assert (plan.blocks[0].lit_kind, plan.blocks[0].seq_kind) == (0, 0)
    assert plan.blocks[1].seq_kind == 2 and plan.host_seqs
    results, stats = _decode(frames)
    assert results == [lits, wide]
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
    outs, lens, host = dp.decode_batch_device([frame], device=CPU)
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
    """Dictionary frames once raised NotImplementedError; they now decode
    on the device through both entry points (the reference's
    test_unwrap_many_device_with_dict)."""
    rng = np.random.default_rng(64)
    words = [b"unwrap ", b"many ", b"device ", b"dict "]
    samples = [b"".join(words[int(i)] for i in rng.integers(0, 4, 30))
               for _ in range(200)]
    d = zstandard.train_dictionary(4096, samples)
    recs = [b"".join(words[int(i)] for i in rng.integers(0, 4, 150))
            for _ in range(5)] + [samples[0] * 3]
    frames = [zstandard.ZstdCompressor(level=3, dict_data=d).compress(r)
              for r in recs]
    dec = Decompressor()
    dec.load_dictionary(d.as_bytes())
    outs, lens, host = dec.unwrap_many_device(frames, CPU)
    assert not host and outs[0].device == CPU
    assert _bytes_of(len(frames), outs, lens, host) == recs
    results, stats = dp.decode_batch_device(frames, device=CPU,
                                            materialize=True,
                                            ddict=dec._dict._parsed)
    assert results == recs
    assert stats == {"device_frames": len(recs), "host_frames": 0}


# ---------------------------------------------------------------------------
# dictionary frames against the reference
# ---------------------------------------------------------------------------


def _bytes_of(n, outs, lens, host):
    """Each frame's bytes from decode_batch_device's device-resident
    return: rows follow the frames host_results does not hold."""
    rows = [r for o in outs for r in o.numpy()]
    got, k = [], 0
    for fi in range(n):
        if fi in host:
            v = host[fi]
            got.append(v if isinstance(v, bytes) else v.numpy().tobytes())
        else:
            got.append(rows[k][:lens[k]].tobytes())
            k += 1
    return got


def _equal_reference(frames, dict_bytes, ref_wrong=frozenset()):
    """The port and the reference on one dictionary batch: equal rows,
    lengths and host_results, except the multi-block rows of the frames in
    `ref_wrong`, which the reference gets wrong (ROADMAP Queue 3) and which
    must then differ.  Returns the port's."""
    outs, lens, host = dp.decode_batch_device(
        frames, device=CPU, ddict=parse_dictionary(dict_bytes))
    r_outs, r_lens, r_host = ref.decode_batch_device(
        frames, ddict=r_parse_dictionary(dict_bytes))
    assert np.array_equal(lens, r_lens)
    assert len(outs) == len(r_outs)
    for o, r in zip(outs, r_outs):
        assert o.dtype == torch.uint8 and np.array_equal(o.numpy(),
                                                         np.asarray(r))
    assert set(host) == set(r_host)
    for fi, v in host.items():
        if isinstance(v, bytes):
            assert v == r_host[fi]
        else:
            same = np.array_equal(v.numpy(), np.asarray(r_host[fi]))
            assert same != (fi in ref_wrong), fi
    return outs, lens, host


def _plan(frames, dict_bytes):
    plan = dp.plan_batch(frames, parse_dictionary(dict_bytes))
    dp._release_ops(plan.nb, None)
    return plan


def _lit_type(frame: bytes):
    """The literal-section type of a frame's first block, from its header
    (None for a raw or RLE block)."""
    p = parse_frame_header(np.frombuffer(frame, np.uint8)).header_size
    bh = int.from_bytes(frame[p:p + 3], "little")
    return frame[p + 3] & 3 if (bh >> 1) & 3 == 2 else None


def _dict_case():
    """tests/test_device_pipeline.py's dictionary case: a dictionary
    trained on 300 samples of 40 words, 8 records repeating a sample and 4
    of 800 words.  Returns (dictionary, records)."""
    rng = np.random.default_rng(62)
    words = [b"alpha ", b"bravo ", b"charlie ", b"delta ", b"echo "]

    def rec(n):
        return b"".join(words[int(i)] for i in rng.integers(0, 5, n))

    samples = [rec(40) for _ in range(300)]
    d = zstandard.train_dictionary(8192, samples)
    return d, [samples[i] * 3 for i in range(8)] + [rec(800)
                                                    for _ in range(4)]


@pytest.mark.parametrize("level", [1, 3, 19])
def test_dictionary_frames_equal_reference(level):
    """The reference's dictionary records at its three levels, plus a
    frame written without its dictionary ID and a plain frame in the same
    batch: all on the device, rows equal to the reference's, bytes to the
    records."""
    d, recs = _dict_case()
    frames = [zstandard.ZstdCompressor(level=level, dict_data=d).compress(r)
              for r in recs]
    frames.append(zstandard.ZstdCompressor(
        level=level, dict_data=d, write_dict_id=False).compress(recs[9]))
    frames.append(zstandard.ZstdCompressor(level=level).compress(recs[10]))
    want = recs + [recs[9], recs[10]]
    hdrs = [parse_frame_header(np.frombuffer(f, np.uint8)) for f in frames]
    assert hdrs[-3].dict_id == d.dict_id() and hdrs[-2].dict_id == 0 == \
        hdrs[-1].dict_id
    assert not _plan(frames, d.as_bytes()).host_routed
    outs, lens, host = _equal_reference(frames, d.as_bytes())
    assert not host
    assert _bytes_of(len(frames), outs, lens, host) == want


def test_dictionary_batch_packs_wide_fse_lanes(monkeypatch):
    """The Python planner (every frame of a dictionary batch) packs a
    128 KiB record's sequence bitstream of 2,049-8,192 words, past the
    reference's window and inside the port's, as an FSE kernel lane
    through ``pack_fse``, for a frame written with the dictionary and a
    plain one; both decode byte-exact on the CPU."""
    d, _ = _dict_case()
    record = silesia_records(16, 1)[0]
    frames = [zstandard.ZstdCompressor(level=3, dict_data=d).compress(record),
              compress(record, 3)]
    packed = []
    pack_fse = dp._NativeOps.pack_fse

    def spy(self, payload, *args):
        packed.append(len(payload))
        return pack_fse(self, payload, *args)

    monkeypatch.setattr(dp._NativeOps, "pack_fse", spy)
    ddict = parse_dictionary(d.as_bytes())
    timings = {}
    plan = dp.plan_batch(frames, ddict, timings)
    wlen = plan.nb._fse["fse_wlen"][:plan.nb.n_fse].tolist()
    dp._release_ops(plan.nb, None)
    assert "plan.native" not in timings and "plan.host_seqs" not in timings
    assert not plan.host_routed and not plan.host_seqs
    assert [b.seq_kind for b in plan.blocks] == [1, 1]
    assert len(packed) == 2 and all(
        df.REF_MAX_W * 4 < n <= df.MAX_W * 4 for n in packed)
    assert all(df.REF_MAX_W < w <= df.MAX_W for w in wlen)
    timings = {}
    results, stats = dp.decode_batch_device(frames, True, ddict,
                                            device=CPU, timings=timings)
    assert results == [record, record]
    assert stats == {"device_frames": 2, "host_frames": 0}
    assert timings["n.fse_wide_lanes"] == 2
    assert timings["n.host_seq_lanes"] == 0


def test_treeless_literals_decode_on_device():
    """Level-1 dictionary frames whose literal section is treeless (type 3,
    from its header) run as Huffman device lanes with the dictionary's
    weights."""
    d, recs = _dict_case()
    frames = [zstandard.ZstdCompressor(level=1, dict_data=d).compress(r)
              for r in recs]
    treeless = [fi for fi, f in enumerate(frames) if _lit_type(f) == 3]
    assert treeless
    plan = _plan(frames, d.as_bytes())
    assert not plan.host_routed and not plan.mb_frames
    by_frame = {b.frame_idx: b for b in plan.blocks}
    assert all(by_frame[fi].lit_kind == 1 for fi in treeless)
    assert dp.scan_eligibility(frames, parse_dictionary(d.as_bytes())) == {}
    assert set(dp.scan_eligibility(frames)) >= set(treeless)
    results, stats = dp.decode_batch_device(
        frames, device=CPU, materialize=True,
        ddict=parse_dictionary(d.as_bytes()))
    assert results == recs and stats["host_frames"] == 0


def test_dictionary_multiblock_equals_reference():
    """The reference's multi-block dictionary case: contents over 128 KB
    run as dependent rounds whose accumulators start with the dictionary's
    tail."""
    rng = np.random.default_rng(84)
    words = [b"multi ", b"block ", b"frame ", b"round ", b"window "]

    def rec(n):
        return b"".join(words[int(i)] for i in rng.integers(0, 5, n))

    d = zstandard.train_dictionary(8192, [rec(40) for _ in range(200)])
    recs = [rec(40_000), rec(90_000)]
    frames = [zstandard.ZstdCompressor(level=3, dict_data=d).compress(r)
              for r in recs]
    assert all(len(r) > (128 << 10) for r in recs)
    plan = _plan(frames, d.as_bytes())
    assert not plan.host_routed and len(plan.mb_frames) == 2
    outs, lens, host = _equal_reference(frames, d.as_bytes())
    assert outs == [] and set(host) == {0, 1}
    assert _bytes_of(2, outs, lens, host) == recs


def test_raw_content_dictionary_equals_reference():
    """A dictionary without the magic is raw content: no entropy, its
    bytes the window (a 32 KB row) that the records' matches reach into."""
    content = b"".join(_records(4, 5_000, seed=91))
    zd = zstandard.ZstdCompressionDict(
        content, dict_type=zstandard.DICT_TYPE_RAWCONTENT)
    recs = [content[i:i + 3_000] + r for i, r in
            zip((0, 7_000, 13_000), _records(3, 2_000, seed=92))]
    frames = [zstandard.ZstdCompressor(level=3, dict_data=zd).compress(r)
              for r in recs]
    pd = parse_dictionary(content)
    assert pd.entropy is None and pd.dict_id == 0
    assert dp._window_rows(content, 4, CPU).shape == (4, 1 << 15)
    assert not _plan(frames, content).host_routed
    outs, lens, host = _equal_reference(frames, content)
    assert _bytes_of(3, outs, lens, host) == recs
    assert sum(len(f) for f in frames) < sum(map(len, recs)) // 2


def test_dictionary_over_128kb_goes_to_the_host():
    content = b"".join(_records(30, 5_000, seed=93))
    assert len(content) > (1 << 17)
    zd = zstandard.ZstdCompressionDict(
        content, dict_type=zstandard.DICT_TYPE_RAWCONTENT)
    recs = [content[-9_000:-3_000], _records(1, 4_000, seed=94)[0]]
    frames = [zstandard.ZstdCompressor(level=3, dict_data=zd).compress(r)
              for r in recs]
    plan = _plan(frames, content)
    assert plan.host_routed == {0: "dict > 128KB window envelope",
                                1: "dict > 128KB window envelope"}
    outs, lens, host = _equal_reference(frames, content)
    assert outs == [] and host == {0: recs[0], 1: recs[1]}


def _two_dictionaries():
    d, recs = _dict_case()
    rng = np.random.default_rng(95)
    other = zstandard.train_dictionary(4096, [bytes(rng.integers(
        97, 105, 60, dtype=np.uint8)) for _ in range(300)])
    assert other.dict_id() != d.dict_id()
    return d, other, recs


def test_wrong_dictionary_raises_as_reference():
    """A frame that names another dictionary's ID in a dictionary batch is
    routed to the host, which raises dictionary_wrong (32), as the
    reference does."""
    d, other, recs = _two_dictionaries()
    frames = [zstandard.ZstdCompressor(level=3, dict_data=d).compress(recs[0]),
              zstandard.ZstdCompressor(level=3, dict_data=other).compress(
                  recs[1])]
    assert _plan(frames, d.as_bytes()).host_routed == {
        1: "dictionary required"}
    with pytest.raises(RZstdError) as want:
        ref.decode_batch_device(frames, ddict=r_parse_dictionary(d.as_bytes()))
    with pytest.raises(ZstdError) as got:
        dp.decode_batch_device(frames, device=CPU,
                               ddict=parse_dictionary(d.as_bytes()))
    assert int(got.value.code) == int(want.value.code) == 32
    assert got.value.code == ZstdErrorCode.dictionary_wrong


def test_dictionary_frame_without_dictionary_raises_as_reference():
    """Without a dictionary a dictionary frame goes to the host engine,
    whose body decode fails: corruption_detected (20), as the reference."""
    d, recs = _dict_case()
    frames = [zstandard.ZstdCompressor(level=3, dict_data=d).compress(recs[9])]
    assert dp.scan_eligibility(frames) == {0: "dictionary required"}
    with pytest.raises(RZstdError) as want:
        ref.decode_batch_device(frames)
    with pytest.raises(ZstdError) as got:
        dp.decode_batch_device(frames, device=CPU)
    assert int(got.value.code) == int(want.value.code) == 20


@pytest.mark.parametrize("name,part", [("json", slice(0, 160)),
                                       ("corpus", slice(88, 91))])
def test_committed_dictionary_sets(name, part):
    """The card's dictionary data (tests/torch_data): every frame decodes
    with zstandard to its record, and a part of each set (set 2's part
    holds treeless, fresh-tree and raw literal sections and a multi-block
    frame) gives the reference's rows through the port.

    The multi-block frame (set 2's frame 89) is single-segment: its window
    is its 24,576-byte content, yet its blocks reach 112,493 bytes of
    dictionary behind it, as libzstd allows.  The reference sizes the
    dependent rounds' window from the frame's window, cuts the dictionary
    and returns wrong bytes without an error; the port's window holds the
    dictionary and the content (ROADMAP Queue 3)."""
    d, frames, recs = dict_sets.load(name)
    assert len(frames) == len(recs) == {"json": 5000, "corpus": 130}[name]
    assert len(d) == {"json": 4202, "corpus": 112_640}[name]
    zd = zstandard.ZstdDecompressor(dict_data=zstandard.ZstdCompressionDict(d))
    assert [zd.decompress(f) for f in frames] == recs
    frames, recs = frames[part], recs[part]
    plan = _plan(frames, d)
    assert not plan.host_routed
    ref_wrong = set()
    if name == "corpus":
        assert {0, 2, 3} <= set(map(_lit_type, frames))
        (mb,) = plan.mb_frames
        hdr = parse_frame_header(np.frombuffer(frames[mb["frame_idx"]],
                                               np.uint8))
        assert hdr.single_segment and hdr.window_size == 24_576
        assert mb["window"] == 24_576 + len(parse_dictionary(d).content)
        ref_wrong = {mb["frame_idx"]}
    outs, lens, host = _equal_reference(frames, d, ref_wrong)
    assert _bytes_of(len(frames), outs, lens, host) == recs


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
        dp.decode_batch_device([compress(b"abc" * 100, 3)], device=CPU)


def test_stage_timings_are_recorded():
    frames = [compress(x, 5) for x in _records(3, 4_000, seed=41)]
    timings = {}
    dp.decode_batch_device(frames, device=CPU, timings=timings)
    assert {"plan", "huf", "fse", "exec"} <= set(timings)
    assert all(v >= 0 for v in timings.values())



# ---------------------------------------------------------------------------
# corrupt frames: the executor's flags make the device plane reject what
# libzstd rejects (ROADMAP Queue 3)

MUT_TRIALS, MUT_PARTS = 300, 4


@pytest.fixture(scope="module")
def mutation_case():
    """8 level-9 frames of 6,000 B of bench.make_corpus, without a
    checksum (so only the flags can catch a corrupt body), and 300 trials
    from random.Random(7): each flips 1-4 bits of one frame and records
    libzstd's verdict, the decoded bytes or None."""
    import random

    from bench import make_corpus

    data = make_corpus(1 << 20)
    recs = [data[i * 6000:(i + 1) * 6000] for i in range(8)]
    cctx = zstandard.ZstdCompressor(level=9, write_checksum=False)
    frames = [cctx.compress(r) for r in recs]
    dctx = zstandard.ZstdDecompressor()
    rng = random.Random(7)
    trials = []
    for _ in range(MUT_TRIALS):
        fi = rng.randrange(8)
        f = bytearray(frames[fi])
        for _ in range(rng.randint(1, 4)):
            f[rng.randrange(len(f))] ^= 1 << rng.randrange(8)
        try:
            want = dctx.decompress(bytes(f), max_output_size=1 << 20)
        except zstandard.ZstdError:
            want = None
        trials.append((fi, bytes(f), want))
    return recs, frames, trials


def test_mutation_case_frames_equal_reference(mutation_case):
    """The unmutated batch: the port's rows equal the reference's and the
    records, and nothing is flagged."""
    recs, frames, _ = mutation_case
    outs, lens, host = dp.decode_batch_device(frames, device=CPU)
    r_outs, r_lens, r_host = ref.decode_batch_device(frames)
    assert not host and not r_host and np.array_equal(lens, r_lens)
    assert len(outs) == len(r_outs) == 1
    assert np.array_equal(outs[0].numpy(), np.asarray(r_outs[0]))
    assert _decode(frames) == (recs, {"device_frames": 8, "host_frames": 0})


@pytest.mark.parametrize("part", range(MUT_PARTS))
def test_mutated_frames_rejected_as_libzstd(mutation_case, part):
    """Each trial decodes the batch with the mutated frame in its place:
    where libzstd rejects the frame the port raises ZstdError (the host
    route's error, or corruption_detected for a flagged lane), and where
    libzstd accepts it the port returns libzstd's bytes for it and the records
    for the others."""
    recs, frames, trials = mutation_case
    n = MUT_TRIALS // MUT_PARTS
    rejected = 0
    for fi, mutated, want in trials[part * n:(part + 1) * n]:
        batch = list(frames)
        batch[fi] = mutated
        if want is None:
            rejected += 1
            with pytest.raises(ZstdError):
                _decode(batch)
        else:
            results, _ = _decode(batch)
            assert results[fi] == want
            assert results[:fi] + results[fi + 1:] == recs[:fi] + recs[fi + 1:]
    assert rejected > 0


def test_flagged_frame_names_its_checks(mutation_case):
    """A frame that the planner takes and libzstd rejects is flagged: the
    error names the frame and the failed checks, and the device-resident
    return (not checked, as in the reference) still gives rows."""
    recs, frames, trials = mutation_case
    for fi, mutated, want in trials:
        batch = list(frames)
        batch[fi] = mutated
        plan = dp.plan_batch(batch)
        dp._release_ops(plan.nb, None)
        if want is None and not plan.host_routed:
            break
    else:
        pytest.fail("no trial reaches the device and is rejected")
    with pytest.raises(ZstdError) as ei:
        _decode(batch)
    assert ei.value.code == ZstdErrorCode.corruption_detected
    assert str(ei.value).startswith(f"frame {fi}: ")
    assert any(why in str(ei.value) for _, why in dp._FLAG_REASONS)
    outs, lens, host = dp.decode_batch_device(batch, device=CPU)
    assert not host and len(lens) == 8


def test_decompress_data_parallel_raises_as_decompress(mutation_case):
    """The stream decoder decodes every single-block frame through
    decode_batch_device(materialize=True), so a stream that decompress
    rejects raises there too, where the parent returned wrong bytes."""
    from zstdsharp_tpu_torch.decode.frame import decompress
    from zstdsharp_tpu_torch.parallel.pipeline import (
        decompress_data_parallel)

    recs, frames, trials = mutation_case
    assert decompress_data_parallel(b"".join(frames), ["cpu"]) == \
        b"".join(recs)
    caught = 0
    for fi, mutated, want in trials[:60]:
        if want is not None or dp.scan_eligibility([mutated]):
            continue
        stream = b"".join(frames[:fi] + [mutated] + frames[fi + 1:])
        with pytest.raises(ZstdError):
            decompress(stream)
        with pytest.raises(ZstdError):
            decompress_data_parallel(stream, ["cpu"])
        caught += 1
    assert caught > 0


def _flags_of(run):
    """Every lane flag the decode plane computes in run(), from the
    executor's operands (``lane_flags``; the rows are not executed)."""
    from zstdsharp_tpu_torch.ops import execseq as ex

    seen = []

    def spy(lit, window, ll, ml, off, n_seq, last_lit, out_len, win_len):
        seen.append(ex.lane_flags(ll, ml, off, n_seq, last_lit, out_len,
                                  win_len))
        return torch.zeros_like(lit), seen[-1]

    real = ex.execute_plain
    ex.execute_plain = spy
    try:
        run()
    finally:
        ex.execute_plain = real
    assert seen
    return torch.cat(seen)


@pytest.mark.parametrize("name", ["json", "corpus", "bench", "multiblock"])
def test_valid_frames_flag_nothing(name):
    """Every frame of both committed dictionary sets (set 2 holds 8
    multi-block frames whose blocks reach the dictionary), the bench's
    decode batch (256 x 24 KB of make_corpus at level 9) and multi-block
    frames without a dictionary (their window the frame's): no lane is
    flagged."""
    ddict = None
    if name in ("json", "corpus"):
        d, frames, _ = dict_sets.load(name)
        ddict = parse_dictionary(d)
    elif name == "bench":
        from bench import make_corpus

        data = make_corpus(6 << 20)
        frames = [zstandard.ZstdCompressor(level=9).compress(
            data[i:i + (24 << 10)]) for i in range(0, 6 << 20, 24 << 10)]
    else:
        recs = [_records(1, n, seed=s)[0] for n, s in
                ((300_000, 61), (140_000, 62), (600_000, 63))]
        frames = [compress(recs[0], 3),
                  zstandard.ZstdCompressor(level=5).compress(recs[1]),
                  zstandard.ZstdCompressor(level=19).compress(recs[2])]
    plan = dp.plan_batch(frames, ddict)
    dp._release_ops(plan.nb, None)
    assert not plan.host_routed
    assert (len(plan.mb_frames) > 0) == (name in ("corpus", "multiblock"))
    bad = _flags_of(lambda: dp.decode_batch_device(frames, device=CPU,
                                                   ddict=ddict))
    assert not bad.any()
