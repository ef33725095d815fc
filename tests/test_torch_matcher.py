"""Greedy parse of the torch port (ops/matcher.py) against the JAX
package's ``parse_blocks_ptrjump``, on seeded rows of text, runs and noise.

The reference runs under ``jax.enable_x64(False)``, as the device encoder
calls it.  All five outputs are integer or bool arrays and must be exactly
equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zstdsharp_tpu.ops import matcher as ref
from zstdsharp_tpu_torch.ops import matcher as tm

KEYS = ("starts", "mls", "offs", "nseq", "covered")


def _rows(seed, b, n):
    rng = np.random.default_rng(seed)
    words = [b"alpha ", b"beta ", b"gamma ", b"delta ", b"epsilon ", b"zeta "]
    blocks = np.zeros((b, n), np.uint8)
    nv = np.zeros(b, np.int32)
    for k in range(b):
        kind = k % 4
        m = int(rng.integers(1, n + 1))
        if kind == 0:
            r = b"".join(words[i] for i in rng.integers(0, 6, n // 4))
        elif kind == 1:
            r = bytes(rng.integers(0, 256, n, dtype=np.uint8))
        elif kind == 2:
            r = b"ab" * n  # one long match: chained capped sequences
        else:
            r = bytes(rng.integers(97, 100, n, dtype=np.uint8))
        r = r[:m]
        blocks[k, :len(r)] = np.frombuffer(r, np.uint8)
        nv[k] = len(r)
    nv[0] = n
    if b > 5:
        nv[5] = 0  # an empty row
    return blocks, nv


def _reference(blocks, nv, hash_log, S, rounds):
    with jax.enable_x64(False):
        out = ref.parse_blocks_ptrjump(jnp.asarray(blocks), jnp.asarray(nv),
                                       hash_log, S, *rounds)
        return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("seed,n,hash_log,rounds", [
    (1, 4096, 15, (8, 8)),      # the encoder's 4 KB bucket parse
    (2, 4096, 12, (16, 24)),    # parse_block's extension budget
    (3, 1024, 10, (2, 0)),      # short extension, heavy hash collisions
])
def test_parse_equals_reference(seed, n, hash_log, rounds):
    blocks, nv = _rows(seed, 6, n)
    S = max(16, n // 5)
    got = tm.parse_blocks_ptrjump(torch.from_numpy(blocks),
                                  torch.from_numpy(nv), hash_log, S, *rounds)
    want = _reference(blocks, nv, hash_log, S, rounds)
    for k in KEYS:
        g = got[k].numpy()
        assert g.shape == want[k].shape, k
        assert g.dtype == want[k].dtype, k
        assert np.array_equal(g, want[k]), k
    assert int(want["nseq"].max()) > 50  # the rows do parse into matches


def test_parse_caps_sequences_at_max_seq():
    blocks, nv = _rows(4, 4, 2048)
    S = 16  # far below what the text rows parse into
    got = tm.parse_blocks_ptrjump(torch.from_numpy(blocks),
                                  torch.from_numpy(nv), 15, S, 8, 8)
    want = _reference(blocks, nv, 15, S, (8, 8))
    assert int(want["nseq"].max()) == S
    for k in KEYS:
        assert np.array_equal(got[k].numpy(), want[k]), k
