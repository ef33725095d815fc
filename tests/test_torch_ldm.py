"""The torch port's LDM anchor scan (ops/ldm.py) against the JAX package's
``ldm_anchor_mask`` and its serial gear feed, bit for bit, on the inputs of
tests/test_device.py (50,000 seeded random bytes) and their prefixes,
positions i < rate_log - 1 included."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zstdsharp_tpu.ops import ldm as rldm
from zstdsharp_tpu_torch.ops import ldm

SRC = np.random.default_rng(5).integers(0, 256, 50_000, dtype=np.uint8)


@pytest.mark.parametrize("n", [0, 1, 5, 3001])
@pytest.mark.parametrize("rate_log", [1, 2, 4, 7, 9, 12])
def test_ldm_anchor_mask_equals_reference(rate_log, n):
    src = SRC[:n]
    got = ldm.ldm_anchor_mask(torch.from_numpy(src.copy()), rate_log)
    assert got.dtype == torch.uint8 and got.shape == (n,)
    assert got.device.type == "cpu"
    mask = got.numpy()
    assert np.array_equal(mask, rldm.ldm_anchor_mask_reference(src, rate_log))
    if n >= rate_log - 1:
        want = np.asarray(rldm.ldm_anchor_mask(jnp.asarray(src), rate_log))
        assert np.array_equal(mask, want)
    elif rate_log > 2:
        # the reference's zero-padded slices do not line up below r - 1
        # bytes; the port pads by position and returns the serial mask
        with pytest.raises(TypeError):
            rldm.ldm_anchor_mask(jnp.asarray(src), rate_log)


def test_ldm_density_and_serial_copy():
    """tests/test_device.py's case: all 50,000 bytes at rate_log 7 equal
    both references, and anchors come at about 2^-7.  The port's serial
    reference is the JAX package's."""
    mask = ldm.ldm_anchor_mask(torch.from_numpy(SRC.copy())).numpy()
    assert np.array_equal(mask, rldm.ldm_anchor_mask_reference(SRC, 7))
    assert np.array_equal(mask, np.asarray(rldm.ldm_anchor_mask(
        jnp.asarray(SRC), 7)))
    assert 0.5 / 128 < mask[6:].mean() < 2.5 / 128
    assert ldm.DEFAULT_RATE_LOG == rldm.DEFAULT_RATE_LOG
    assert (ldm.GEAR_MULT, ldm.GEAR_SHIFT) == (rldm.GEAR_MULT,
                                               rldm.GEAR_SHIFT)
    assert np.array_equal(ldm.ldm_anchor_mask_reference(SRC[:4000], 9),
                          rldm.ldm_anchor_mask_reference(SRC[:4000], 9))


def test_ldm_anchor_mask_takes_rows_as_one_vector():
    """A tensor of any shape is scanned as its flat byte vector."""
    flat = torch.from_numpy(SRC[:6000].copy())
    assert torch.equal(ldm.ldm_anchor_mask(flat.view(6, 1000)),
                       ldm.ldm_anchor_mask(flat))
