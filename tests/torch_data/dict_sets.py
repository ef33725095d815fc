"""Dictionary frames for the torch port's card tests and chip_smoke.py.

The GPU host has neither ``zstandard`` nor the JAX package, so the
dictionaries and frames were made once and committed beside this file;
the records are regenerated from their recipe wherever they are needed.
The port now reproduces set ``json`` on the GPU host by itself
(``zstdsharp_tpu_torch.train_dictionary`` and ``Compressor.wrap_many``
give the committed bytes, checked there by chip_smoke.py); set ``corpus``
needs ``zstandard``'s trainer and encoder.

* ``json`` -- the bench's dictionary-batch configuration (bench.py, "dict
  batch"): 5,000 JSON records, a 4,096-byte dictionary trained on the
  first 1,000 by the JAX package's trainer, and each record framed by its
  ``Compressor(level=3).wrap_many``.
* ``corpus`` -- 128 records of 24 KB of ``bench.make_corpus`` starting at
  byte ``REC_START``, a 112,640-byte dictionary (zstd's default dictionary
  size) trained by ``zstandard`` (fastCover, k=1024, d=8) on the 2 KB
  samples of the 6 MB before the records, each record compressed with it
  at level 19; then two multi-block frames of the 300 KB slices after the
  records at level 3 with the same dictionary.

Regenerate with ``python tests/torch_data/make_dict_sets.py`` (needs
``zstandard`` and the JAX package's host tier; writes ``dict_<name>.npz``
beside this file).

Load: ``load(name)`` -> (dictionary bytes, frames, records).  This module
needs only numpy and, for ``corpus``, ``bench.make_corpus``.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent.parent
NAMES = ("json", "corpus")

JSON_RECORDS = 5000
JSON_DICT_SIZE = 4096
JSON_LEVEL = 3

REC_SIZE = 24 << 10
N_RECORDS = 128
REC_START = 19_341_312
SAMPLE_SIZE = 2048
SAMPLE_BYTES = 6 << 20
CORPUS_DICT_SIZE = 112_640
CORPUS_LEVEL = 19
MB_SIZE = 300_000
MB_LEVEL = 3
CORPUS_BYTES = REC_START + N_RECORDS * REC_SIZE + 2 * MB_SIZE


def json_records() -> list[bytes]:
    return [b'{"id": %d, "name": "user%d", "score": %d}' % (i, i, i * 7 % 997)
            for i in range(JSON_RECORDS)]


def corpus_records(corpus: bytes | None = None) -> list[bytes]:
    """The 128 records, then the two multi-block frames' contents.
    `corpus` may pass a ``make_corpus`` output at least CORPUS_BYTES long
    (its prefix is the same whatever its length)."""
    if corpus is None:
        sys.path.insert(0, str(ROOT))
        from bench import make_corpus

        corpus = make_corpus(CORPUS_BYTES)
    if len(corpus) < CORPUS_BYTES:
        raise ValueError(f"corpus of {len(corpus)} B, need {CORPUS_BYTES}")
    recs = [corpus[REC_START + i * REC_SIZE:REC_START + (i + 1) * REC_SIZE]
            for i in range(N_RECORDS)]
    mb = REC_START + N_RECORDS * REC_SIZE
    return recs + [corpus[mb:mb + MB_SIZE], corpus[mb + MB_SIZE:mb + 2 * MB_SIZE]]


def load(name: str, corpus: bytes | None = None):
    """(dictionary bytes, frames, records) of set `name`."""
    with np.load(HERE / f"dict_{name}.npz") as z:
        dictionary = z["dictionary"].tobytes()
        blob, lens = z["frames"].tobytes(), z["lens"]
    offs = np.concatenate([[0], np.cumsum(lens)])
    frames = [blob[a:b] for a, b in zip(offs[:-1], offs[1:])]
    records = (json_records() if name == "json"
               else corpus_records(corpus))
    return dictionary, frames, records
