"""128 KiB records for the torch port's tests of the FSE kernel's word
window (``zstdsharp_tpu_torch.ops.device_fse.MAX_W``, 8,192 words):

* ``silesia_records``: the benchmark's silesia_mix payload (the zfs128k
  cells' content), whose level-3 frames' sequence bitstreams fall past
  the reference's 2,048-word window and inside the port's;
* ``wide_sequence_frame``: a record whose sequence bitstream is wider than
  the port's window, so its sequences are decoded on the host.

Imports only the port and the benchmark's payload, so the card tests use
it on a machine without JAX.
"""

import sys
from pathlib import Path

import numpy as np

from zstdsharp_tpu_torch.encode.frame import compress

ROOT = Path(__file__).resolve().parent.parent.parent
RECORD = 1 << 17


def silesia_records(n: int, seed: int) -> list:
    """n records of 128 KiB of the benchmark's silesia_mix payload, drawn
    from ``np.random.default_rng(seed)`` as the benchmark draws them."""
    sys.path.insert(0, str(ROOT))
    try:
        from benchmark.payloads import silesia_mix
    finally:
        sys.path.remove(str(ROOT))
    return silesia_mix.make([RECORD] * n, np.random.default_rng(seed))


def wide_sequence_frame(seed: int = 6) -> tuple:
    """(record, its level-5 frame): 128 KiB whose one block's sequence
    bitstream is wider than the FSE kernel's 32 KiB window, with fewer
    sequences than the top S bucket (16,384), so the window alone sends
    its sequences to the host: 48 KiB of random bytes, then pieces of 4-6
    bytes copied from random far positions in them (about 16,000
    sequences of about 19 bits)."""
    r = np.random.default_rng(seed)
    head = r.integers(0, 256, 48 << 10, dtype=np.uint8).tobytes()
    out = bytearray(head)
    while len(out) < RECORD:
        k = int(r.integers(4, 7))
        p = int(r.integers(0, len(head) - k))
        out += head[p:p + k]
    record = bytes(out[:RECORD])
    return record, compress(record, 5)
