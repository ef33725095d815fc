"""The Silesia-like mix of bench.make_corpus, seeded (configuration key
``"payload": "silesia_mix"``)."""

import numpy as np


_WORDS = (b"the", b"of", b"and", b"a", b"to", b"in", b"he", b"was", b"that",
          b"it", b"his", b"her", b"with", b"as", b"had", b"for", b"dickens",
          b"compression", b"entropy", b"probability", b"wonderful")
# the word frequencies are fixed (bench.make_corpus's draw): the seed
# changes which words come, not how compressible the text is
_WORD_P = np.random.default_rng(20260816).dirichlet(np.ones(len(_WORDS)) * 0.5)
# one cycle: bench.make_corpus's kinds in its proportions (5 text, 2
# structured records, 1 binary ramp, 1 run, 1 high-entropy stretch), each
# part cut to a fixed size (about 1.1 times its typical size there) so that
# a cycle is exactly 2 MiB: a 32 MiB batch is 16 whole cycles, and every
# batch of every seed holds the same bytes of each kind
_CYCLE = (0, 0, 0, 0, 0, 1, 1, 2, 3, 4)
_SIZE = (236_000, 264_000, 132_000, 88_000, 169_152)
CYCLE_BYTES = sum(_SIZE[k] for k in _CYCLE)  # 2 MiB


def _text(rng, size: int) -> bytes:
    w = max(map(len, _WORDS)) + 1
    table = np.zeros((len(_WORDS), w), np.uint8)
    lens = np.zeros(len(_WORDS), np.int64)
    for i, word in enumerate(_WORDS):
        table[i, :len(word)] = np.frombuffer(word, np.uint8)
        table[i, len(word)] = ord(" ")
        lens[i] = len(word) + 1
    out = b""
    while len(out) < size:  # about 1.2 times the words the size needs
        idx = rng.choice(len(_WORDS), int(1.2 * size / (lens @ _WORD_P)),
                         p=_WORD_P)
        keep = np.arange(w)[None, :] < lens[idx][:, None]
        out += table[idx][keep].tobytes()
    return out[:size]


def _part(kind: int, rng) -> bytes:
    size = _SIZE[kind]
    if kind == 0:  # text
        return _text(rng, size)
    if kind == 1:  # structured records, ids of 6 digits
        i0 = int(rng.integers(100_000, 800_000))
        return b",".join(b'{"id": %d, "status": "ok", "score": %d}'
                         % (i, i * 7 % 997)
                         for i in range(i0, i0 + 7000))[:size]
    if kind == 2:  # binary ramps
        return ((np.arange(size) + int(rng.integers(0, 251))) % 251
                ).astype(np.uint8).tobytes()
    if kind == 3:  # runs
        return bytes([int(rng.integers(0, 256))]) * size
    return rng.integers(0, 256, size, dtype=np.uint8).tobytes()


def make(lengths, rng) -> list:
    """Records cut in order from one stream of bench.make_corpus's parts
    (text, structured records, binary ramps, runs, high entropy), in whole
    cycles, each cycle's order drawn from the seed: consecutive records of
    one file, as a filesystem stores them."""
    total = int(np.sum(lengths))
    parts = []
    for _ in range(-(-total // CYCLE_BYTES)):
        parts += [_part(int(k), rng) for k in rng.permutation(_CYCLE)]
    data = b"".join(parts)
    ends = np.cumsum(lengths)
    return [data[e - n:e] for e, n in zip(ends, lengths)]
