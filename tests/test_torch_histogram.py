"""Byte histogram of the torch port against the JAX package.

``histogram_plain`` (what ``histogram_u8`` runs on CPU tensors) must equal
the reference's XLA ``histogram_u8`` (masked and not) and its Pallas
kernel ``histogram_u8_pallas`` in interpret mode, exactly: the counts are
integers.  The CUDA kernel itself is held against ``histogram_plain`` on
the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zstdsharp_tpu.ops import histogram as ref
from zstdsharp_tpu_torch.ops import histogram as th


def _skewed(rng, shape):
    """Text-like bytes: most hits on a few bins, some on all 256."""
    common = rng.choice(np.frombuffer(b"etaoin shrdlu", np.uint8), shape)
    rare = rng.integers(0, 256, shape, dtype=np.uint8)
    return np.where(rng.random(shape) < 0.9, common, rare).astype(np.uint8)


@pytest.mark.parametrize("n", [1, 255, 4096, 70001, 17, 9000, 16383])
def test_plain_equals_pallas_kernel_unmasked(n):
    data = _skewed(np.random.default_rng(n), n)
    got = th.histogram_u8(torch.from_numpy(data))
    with jax.enable_x64(False):
        want = np.asarray(ref.histogram_u8_pallas(jnp.asarray(data),
                                                  interpret=True))
    assert got.dtype == torch.int32 and tuple(got.shape) == (256,)
    assert np.array_equal(got.numpy(), want)
    assert int(got.sum()) == n


@pytest.mark.parametrize("masked", [False, True])
def test_plain_equals_xla_histogram_rows(masked):
    """The encoder's call: [B, N] literal rows, each with its prefix mask."""
    rng = np.random.default_rng(4 + masked)
    rows = _skewed(rng, (6, 4096))
    count = rng.integers(0, 4097, 6)
    count[:2] = (0, 4096)
    mask = np.arange(4096)[None, :] < count[:, None]
    got = th.histogram_u8(torch.from_numpy(rows),
                          torch.from_numpy(mask) if masked else None)
    assert tuple(got.shape) == (6, 256)
    with jax.enable_x64(False):
        for b in range(6):
            want = np.asarray(ref.histogram_u8(
                jnp.asarray(rows[b]), jnp.asarray(mask[b]) if masked else None))
            assert np.array_equal(got[b].numpy(), want)


@pytest.mark.parametrize("n", [17, 9000, 16383])
@pytest.mark.parametrize("mask_kind", ["random", "prefix", "none_kept"])
def test_plain_equals_xla_histogram_masked(n, mask_kind):
    """Row widths that are not a multiple of 16 (the kernel's scalar head
    and tail), under random masks, prefix masks and a fully masked row,
    which must count nothing."""
    rng = np.random.default_rng(n + len(mask_kind))
    rows = _skewed(rng, (3, n))
    if mask_kind == "random":
        mask = rng.random((3, n)) < 0.5
    elif mask_kind == "prefix":
        mask = np.arange(n)[None, :] < rng.integers(0, n + 1, 3)[:, None]
    else:
        mask = np.zeros((3, n), bool)
        mask[1] = rng.random(n) < 0.7
    got = th.histogram_u8(torch.from_numpy(rows), torch.from_numpy(mask))
    with jax.enable_x64(False):
        for b in range(3):
            want = np.asarray(ref.histogram_u8(jnp.asarray(rows[b]),
                                               jnp.asarray(mask[b])))
            assert np.array_equal(got[b].numpy(), want)
    assert int(got.sum()) == int(mask.sum())
    if mask_kind == "none_kept":
        assert int(got[0].abs().sum()) == int(got[2].abs().sum()) == 0


@pytest.mark.parametrize("b,n,masked,want", [
    (32, 16384, True, (1, 1)), (32, 16384, False, (4, 1)),
    (32, 4096, True, (1, 1)), (32, 4096, False, (1, 1)),
    (32, 65536, True, (4, 1)), (32, 131072, True, (8, 1)),
    (32, 131072, False, (8, 1)), (70000, 64, True, (1, 1)),
    (256, 16384, True, (1, 1)), (1, (4 << 20) + 1, False, (8, 33)),
    (1, 1_000_003, False, (8, 16)), (2, 1 << 20, True, (8, 16)),
    (1, 1, False, (1, 1)), (16, 1 << 20, True, (8, 1)),
    (4, 1 << 16, True, (4, 1))])
def test_plan(b, n, masked, want):
    """The launch plan on a card of 132 SMs: clusters of at most 8
    blocks, a block's share of a row about MASKED_SHARE or UNMASKED_SHARE
    bytes with one cluster a row, the rows split over several clusters
    only when they cannot fill half the SMs, and a grid the 1-D launch
    takes."""
    sms = 132
    cs, cpr = th.plan(b, n, sms, masked)
    assert (cs, cpr) == want
    assert 1 <= cs <= th.MAX_PORTABLE_CLUSTER and cpr >= 1
    assert b * cs * cpr <= max(b, sms * th.BLOCKS_PER_SM + 8)
    assert cpr == 1 or 2 * b * cs <= sms


def test_empty_rows():
    assert int(th.histogram_u8(torch.zeros(0, dtype=torch.uint8)).sum()) == 0
    got = th.histogram_u8(torch.zeros(3, 0, dtype=torch.uint8))
    assert tuple(got.shape) == (3, 256) and int(got.abs().sum()) == 0


@pytest.mark.parametrize("fault", ["dtype", "mask_dtype", "mask_shape",
                                   "rank", "layout", "device",
                                   "no_kernel_device", "too_many_rows"])
def test_wrapper_rejects_what_the_kernel_does_not_take(fault):
    data = torch.from_numpy(_skewed(np.random.default_rng(1), (4, 300)))
    mask = torch.ones(4, 300, dtype=torch.bool)
    if fault == "dtype":
        data = data.to(torch.int32)
    elif fault == "mask_dtype":
        mask = mask.to(torch.uint8)
    elif fault == "mask_shape":
        mask = mask[:, :200]
    elif fault == "rank":
        data, mask = data[None], mask[None]
    elif fault == "layout":
        data, mask = data.t().contiguous().t(), mask.t().contiguous().t()
    elif fault == "device":
        mask = mask.to("meta")
    elif fault == "too_many_rows":
        # the launcher takes the row count as a C int (its 1-D grid too)
        data = torch.empty(th.MAX_ROWS + 1, 1, dtype=torch.uint8,
                           device="meta")
        mask = None
    else:
        data, mask = data.to("meta"), mask.to("meta")
    before = th.histogram_u8.launches
    with pytest.raises((TypeError, ValueError),
                       match="rows" if fault == "too_many_rows" else None):
        th.histogram_u8(data, mask)
    assert th.histogram_u8.launches == before


def test_cpu_tensors_take_the_plain_version():
    data = torch.from_numpy(_skewed(np.random.default_rng(2), (2, 1000)))
    before = th.histogram_u8.launches
    assert torch.equal(th.histogram_u8(data), th.histogram_plain(data))
    assert th.histogram_u8.launches == before
