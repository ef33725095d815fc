"""Make the committed dictionary sets of tests/torch_data (the recipe is
in dict_sets.py): trains each set's dictionary, compresses its records and
writes ``dict_<name>.npz`` beside this file.  Needs ``zstandard`` and the
JAX package's host tier (its trainer and ``Compressor``), which the GPU
host lacks; that is why the output is committed.

    python tests/torch_data/make_dict_sets.py
"""

from __future__ import annotations

import sys

import numpy as np

from dict_sets import (CORPUS_BYTES, CORPUS_DICT_SIZE, CORPUS_LEVEL, HERE,
                       JSON_DICT_SIZE, JSON_LEVEL, MB_LEVEL, N_RECORDS, NAMES,
                       REC_START, ROOT, SAMPLE_BYTES, SAMPLE_SIZE,
                       corpus_records, json_records)


def _make(name: str):
    """(dictionary, frames) of set `name`, made from the recipe."""
    sys.path.insert(0, str(ROOT))
    if name == "json":
        from zstdsharp_tpu.dictionary import train_dictionary
        from zstdsharp_tpu.encode.frame import Compressor

        recs = json_records()
        dictionary = train_dictionary(recs[:1000], JSON_DICT_SIZE)
        comp = Compressor(level=JSON_LEVEL)
        comp.load_dictionary(dictionary)
        return dictionary, comp.wrap_many(recs)
    import zstandard
    from bench import make_corpus

    corpus = make_corpus(CORPUS_BYTES)
    s0 = REC_START - SAMPLE_BYTES
    samples = [corpus[s0 + i:s0 + i + SAMPLE_SIZE]
               for i in range(0, SAMPLE_BYTES, SAMPLE_SIZE)]
    zd = zstandard.train_dictionary(CORPUS_DICT_SIZE, samples, k=1024, d=8)
    recs = corpus_records(corpus)
    frames = [zstandard.ZstdCompressor(level=CORPUS_LEVEL, dict_data=zd)
              .compress(r) for r in recs[:N_RECORDS]]
    frames += [zstandard.ZstdCompressor(level=MB_LEVEL, dict_data=zd)
               .compress(r) for r in recs[N_RECORDS:]]
    return zd.as_bytes(), frames


def main() -> None:
    for name in NAMES:
        dictionary, frames = _make(name)
        np.savez_compressed(
            HERE / f"dict_{name}.npz",
            dictionary=np.frombuffer(dictionary, np.uint8),
            frames=np.frombuffer(b"".join(frames), np.uint8),
            lens=np.array([len(f) for f in frames], np.int64))
        print(f"{name}: dictionary {len(dictionary)} B, {len(frames)} frames "
              f"{sum(map(len, frames))} B")


if __name__ == "__main__":
    main()
