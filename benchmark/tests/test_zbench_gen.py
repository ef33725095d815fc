"""The traffic generator and the payloads repeat per seed, and every seed
gets the same set of lengths."""

import json

import numpy as np
import pytest

from benchmark import gen
from zbench_util import ROOT

CONFIGS = {p.stem: json.loads(p.read_text())
           for p in (ROOT / "benchmark" / "configs").glob("*.json")}
MIXES = {p.stem: json.loads(p.read_text())
         for p in (ROOT / "benchmark" / "traffic").glob("*.json")}


def small(mix: dict, cfg: dict) -> dict:
    m = dict(mix, records=8, pool_batches=2)
    cut = max(1, m["len_hi"] // 4096)
    m.update(len_lo=m["len_lo"] // cut, len_hi=m["len_hi"] // cut)
    return m


CASES = [(c, m) for m in MIXES for c in CONFIGS
         if MIXES[m]["len_hi"] <= CONFIGS[c]["max_record_bytes"]]


@pytest.mark.parametrize("cfg,mix", CASES)
def test_same_seed_same_bytes(cfg, mix):
    c, m = CONFIGS[cfg], small(MIXES[mix], CONFIGS[cfg])
    a = gen.make_batches(c, m, 2**31 + 12345)
    b = gen.make_batches(c, m, 2**31 + 12345)
    other = gen.make_batches(c, m, 2**31 + 12346)
    assert a == b
    assert a != other
    assert len(a) == 2 and all(len(batch) == 8 for batch in a)
    lens = sorted(len(r) for batch in a for r in batch)
    assert lens == sorted(len(r) for batch in other for r in batch)
    assert all(m["len_lo"] <= n <= m["len_hi"] for n in lens)


def test_lengths_a_fixed_set():
    mix = {"len_lo": 12288, "len_hi": 16384}
    x = gen.record_lengths(mix, 4096, np.random.default_rng(1))
    y = gen.record_lengths(mix, 4096, np.random.default_rng(2))
    assert not np.array_equal(x, y)
    assert np.array_equal(np.sort(x), np.sort(y))
    assert x.min() >= 12288 and x.max() <= 16384
    assert abs(x.mean() - 14336) < 1


def test_records_beyond_the_configuration_refused():
    cfg = dict(CONFIGS["kafka_zstd_batch16k"])
    mix = dict(MIXES["decode_256x128k"], records=2, pool_batches=1)
    with pytest.raises(ValueError):
        gen.make_batches(cfg, mix, 1)


def _varint(buf, p):
    shift = z = 0
    while True:
        b = buf[p]
        p += 1
        z |= (b & 0x7F) << shift
        shift += 7
        if b < 0x80:
            return (z >> 1) ^ -(z & 1), p


def test_kafka_records_parse():
    """Each record batch's bytes are Kafka v2 records up to the cut: length,
    attributes, timestamp and offset deltas, key, JSON value, no headers."""
    cfg = CONFIGS["kafka_zstd_batch16k"]
    batch = gen.make_batches(cfg, dict(MIXES["decode_1024x45k-60k"], records=4,
                                       pool_batches=1), 7)[0]
    for rec in batch:
        p, k = 0, 0
        while True:
            n, q = _varint(rec, p)
            if q + n > len(rec):
                break  # the cut record
            body = rec[q:q + n]
            assert body[0] == 0
            _, r = _varint(body, 1)
            off, r = _varint(body, r)
            assert off == k
            klen, r = _varint(body, r)
            assert body[r:r + klen].startswith(b"user-")
            vlen, r = _varint(body, r + klen)
            event = json.loads(body[r:r + vlen])
            assert {"event_id", "ts", "type", "ok"} <= set(event)
            assert body[r + vlen:] == b"\x00"
            p, k = q + n, k + 1
        assert k > 20


def test_silesia_mix_kinds():
    """Whole cycles of bench.make_corpus's kinds: runs, ramps, text,
    records and high-entropy stretches all appear."""
    cfg = CONFIGS["openzfs_zstd_rec128k"]
    batch = gen.make_batches(cfg, dict(MIXES["decode_256x128k"], records=24,
                                       pool_batches=1), 3)[0]
    data = b"".join(batch)
    assert b"compression" in data and b'"status": "ok"' in data
    assert bytes([0, 1, 2, 3, 4, 5]) in data or bytes(range(10, 20)) in data
    assert max(len(set(r)) for r in batch) == 256
    # an 80,000-byte run of one byte lies across at most two records
    arr = np.frombuffer(data, np.uint8)
    edges = np.flatnonzero(np.diff(arr)) + 1
    runs = np.diff(np.concatenate([[0], edges, [len(arr)]]))
    assert runs.max() >= 80_000


@pytest.mark.parametrize("mix", ["decode_1024x45k-60k", "encode_1024x45k-60k"])
def test_kafka_frames_fill_batch_size(mix):
    """The Kafka mixes' records sections, as level-3 frames, are 12-16 KiB
    compressed: batches that Kafka closed when its estimate of the
    compressed size reached batch.size."""
    from benchmark.engine import Engine

    cfg = CONFIGS["kafka_zstd_batch16k"]
    batch = gen.make_batches(cfg, dict(MIXES[mix], records=12,
                                       pool_batches=1), 2**31 + 5)[0]
    eng = Engine()
    sizes = [len(eng.frame(r, cfg["level"], cfg["checksum"])) for r in batch]
    assert min(sizes) >= 0.95 * 12288
    assert max(sizes) <= cfg["source_settings"]["batch.size"]
