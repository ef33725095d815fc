"""The one traffic generator.  A traffic mix (``traffic/<name>.json``) gives
the plane, how many records a call carries, their lengths and the size of
the pool of distinct batches; a configuration (``configs/<name>.json``)
names its payload, found as ``payloads/<payload>.py`` (a ``make(lengths,
rng)`` that returns one bytes record a length).

Every seed gets the same set of lengths and the same mix of content kinds,
in another order and with other draws inside each kind, so the seed changes
the bytes and not the work.
"""

from __future__ import annotations

import importlib

import numpy as np


def record_lengths(mix: dict, n: int, rng: np.random.Generator) -> np.ndarray:
    """n lengths spread evenly over [len_lo, len_hi] (the midpoints of n
    equal steps), in an order drawn from the seed."""
    lo, hi = int(mix["len_lo"]), int(mix["len_hi"])
    steps = lo + ((np.arange(n) + 0.5) * (hi - lo) / n).astype(np.int64)
    return rng.permutation(steps)


def make_batches(cfg: dict, mix: dict, seed: int) -> list:
    """The pool: ``mix["pool_batches"]`` batches of ``mix["records"]``
    records (lists of bytes), made from the seed."""
    if int(mix["len_hi"]) > int(cfg["max_record_bytes"]):
        raise ValueError(f"the mix's records exceed the configuration's "
                         f"{cfg['max_record_bytes']} bytes")
    rng = np.random.default_rng(seed)
    n_b, n_r = int(mix["pool_batches"]), int(mix["records"])
    lengths = record_lengths(mix, n_b * n_r, rng)
    payload = importlib.import_module(f"benchmark.payloads.{cfg['payload']}")
    recs = payload.make(lengths, rng)
    return [recs[b * n_r:(b + 1) * n_r] for b in range(n_b)]
