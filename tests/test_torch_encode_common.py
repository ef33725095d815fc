"""Encode primitives of the torch port (ops/common.py) against the JAX
package's, on seeded numpy inputs.

The JAX functions run under ``jax.enable_x64(False)``, as the device
encoder traces them; the u64 view, which the encoder does not use, runs in
the package's default x64 mode.  Every output is an integer array and must
be exactly equal (u32 results are compared as values, the u64 view as its
bit pattern).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zstdsharp_tpu.entropy.bitstream import pack_bits
from zstdsharp_tpu.ops import common as ref
from zstdsharp_tpu_torch.ops import common as tc


def _x32(fn, *args, **kw):
    with jax.enable_x64(False):
        return np.asarray(fn(*args, **kw))


def _text_rows(rng, b, n, alphabet=4):
    """Rows with long repeats: random runs over a small alphabet, each row
    re-using its own earlier bytes."""
    rows = rng.integers(0, alphabet, (b, n), dtype=np.uint8)
    for r in rows:
        for _ in range(6):
            src = int(rng.integers(0, n // 2))
            dst = int(rng.integers(src + 1, n))
            ln = int(rng.integers(1, n - dst + 1))
            r[dst:dst + ln] = r[src:src + ln].copy()
    return rows


@pytest.mark.parametrize("n", [3, 4, 5, 257])  # the reference needs n >= 3
def test_u32_at_every_byte(n):
    rows = np.random.default_rng(n).integers(0, 256, (3, n), dtype=np.uint8)
    got = tc.u32_at_every_byte(torch.from_numpy(rows)).numpy()
    for r, g in zip(rows, got):
        want = _x32(ref.u32_at_every_byte, jnp.asarray(r)).astype(np.int64)
        assert np.array_equal(g, want)


@pytest.mark.parametrize("n", [4, 9, 200])
def test_u64_at_every_byte_bit_pattern(n):
    rows = np.random.default_rng(n).integers(0, 256, (2, n), dtype=np.uint8)
    rows[0, : min(n, 16)] = 0xFF  # top bit set: negative as int64
    got = tc.u64_at_every_byte(torch.from_numpy(rows)).numpy()
    for r, g in zip(rows, got):
        want = np.asarray(ref.u64_at_every_byte(jnp.asarray(r)))
        assert want.dtype == np.uint64
        assert np.array_equal(g.view(np.uint64), want)


@pytest.mark.parametrize("hash_log", [8, 12, 15, 16, 20])
def test_hash4(hash_log):
    rng = np.random.default_rng(hash_log)
    v = rng.integers(0, 1 << 32, 4000, dtype=np.uint64).astype(np.uint32)
    v[:3] = [0xFFFFFFFF, 0, 0x80000000]  # all-0xFF word and the extremes
    got = tc.hash4(torch.from_numpy(v.astype(np.int64)), hash_log)
    want = _x32(ref.hash4, jnp.asarray(v), hash_log)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("masked", [False, True])
def test_previous_occurrence(masked):
    rng = np.random.default_rng(21)
    h = rng.integers(0, 40, (4, 500)).astype(np.int32)  # many ties
    valid = rng.random((4, 500)) < 0.7
    got = tc.previous_occurrence(torch.from_numpy(h),
                                 torch.from_numpy(valid) if masked else None)
    assert got.dtype == torch.int32
    for b in range(4):
        want = _x32(ref.previous_occurrence, jnp.asarray(h[b]),
                    jnp.asarray(valid[b]) if masked else None)
        assert np.array_equal(got[b].numpy(), want)


def test_ctz32_and_highbit_are_exact():
    rng = np.random.default_rng(2)
    x = np.concatenate([np.array([0, 1, 2, 3, 0x80000000, 0xFFFFFFFF],
                                 np.uint64),
                        np.uint64(1) << np.arange(32, dtype=np.uint64),
                        rng.integers(0, 1 << 32, 3000, dtype=np.uint64)]
                       ).astype(np.uint32)
    got = tc.ctz32(torch.from_numpy(x.astype(np.int64))).numpy()
    want = _x32(ref._ctz32, jnp.asarray(x))
    assert np.array_equal(got, want)
    v = rng.integers(-5, 1 << 31, 3000).astype(np.int32)
    v[:4] = [0, 1, 2**31 - 1, -1]
    hb = tc.highbit(torch.from_numpy(v)).numpy()
    assert np.array_equal(hb, np.floor(np.log2(np.maximum(
        v.astype(np.float64), 1))).astype(np.int64))


@pytest.mark.parametrize("rounds", [(16, 24), (8, 8), (2, 0), (1, 1)])
def test_match_lengths(rounds):
    rng = np.random.default_rng(sum(rounds))
    rows = _text_rows(rng, 3, 1500)
    rows[2] = 7  # one long run: stride rounds and the refinement
    cand = np.stack([
        np.where(rng.random(1500) < 0.8,
                 rng.integers(-1, 1500, 1500), -1).astype(np.int32)
        for _ in range(3)])
    cand = np.minimum(cand, np.arange(1500) - 1)  # candidates precede i
    got = tc.match_lengths(torch.from_numpy(rows), torch.from_numpy(cand),
                           *rounds)
    assert got.dtype == torch.int32
    for b in range(3):
        want = _x32(ref.match_lengths, jnp.asarray(rows[b]),
                    jnp.asarray(cand[b]), *rounds)
        assert np.array_equal(got[b].numpy(), want)


@pytest.mark.parametrize("case", ["mixed", "widths_0_and_31", "overflow",
                                  "empty"])
def test_pack_bits_device(case):
    rng = np.random.default_rng(5)
    f = 0 if case == "empty" else 300
    nbits = rng.integers(0, 32, (3, f)).astype(np.uint32)
    if case == "widths_0_and_31":
        nbits = np.where(rng.random((3, f)) < 0.5, 0, 31).astype(np.uint32)
    values = rng.integers(0, 1 << 32, (3, f), dtype=np.uint64).astype(
        np.uint32)  # unmasked: the packer masks to nbits
    out_words = 40 if case == "overflow" else (31 * f + 32) // 32 + 2
    words, total = tc.pack_bits_device(
        torch.from_numpy(values.astype(np.int64)),
        torch.from_numpy(nbits.astype(np.int64)), out_words)
    assert tuple(words.shape) == (3, out_words)
    for b in range(3):
        with jax.enable_x64(False):
            w, t = ref.pack_bits_device(jnp.asarray(values[b]),
                                        jnp.asarray(nbits[b]), out_words)
        assert np.array_equal(words[b].numpy(),
                              np.asarray(w).astype(np.int64))
        assert int(total[b]) == int(t)
    if case == "mixed":  # and the host packer's bytes
        for b in range(3):
            v = values[b].astype(np.uint64) & (
                (np.uint64(1) << nbits[b].astype(np.uint64)) - np.uint64(1))
            host = pack_bits(v, nbits[b].astype(np.uint64))
            dev = words[b].numpy().astype(np.uint32).view(np.uint8)
            assert dev[:(int(total[b]) + 7) // 8].tobytes() == host
