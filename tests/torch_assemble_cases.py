"""The assembly kernel's test cases, shared by tests/test_torch_assemble.py
(the CPU, against the JAX package) and tests/test_torch_cuda.py (the card,
against the plain version): seeded records that give the assembly its
edge lanes, the one ``assemble`` call the encode plane makes for a chunk
of them (``kernel_bench.capture_assemble``), a lane rolled back to the
predefined tables, and a call whose lanes are one lane at chosen sequence
counts (the state chains' edge lengths)."""

import numpy as np
import torch

from zstdsharp_tpu_torch.kernel_bench import capture_assemble
from zstdsharp_tpu_torch.ops import assemble as asm
from zstdsharp_tpu_torch.ops import device_encode as de


def assemble_call(blocks: torch.Tensor, n_valid: torch.Tensor,
                  huf_literals: bool = True) -> dict:
    """The one ``assemble`` call that ``device_encode.encode_frames_device``
    makes for a chunk (its parse and its host tables, on the rows'
    device), as a ``capture_assemble`` record."""
    S = de.seq_budget(blocks.shape[1])
    calls = capture_assemble(lambda: de.encode_frames_device(
        blocks, n_valid, S, de.word_budget(S), 15, huf_literals))
    assert len(calls) == 1
    return calls[0]


# the 128 KB bucket's S, and chain lengths (nseq) at the edges of the
# kernel's cut of a chain into segments (csrc/assemble.cu chain_cut): none,
# one and two sequences, 3 / 4 / 5 steps (a step short of, at and past one
# 4-step segment), 32 segments of 4 steps and one step more, the changes
# from 32 to 64 and from 64 to 128 segments, and S
CHAIN_S = de.seq_budget(1 << 17)
CHAIN_NSEQ = (0, 1, 2, 3, 4, 5, 6, 129, 130, 4097, 4098, 16385, 16386,
              CHAIN_S)


def pad_records(recs, n: int) -> tuple[np.ndarray, np.ndarray]:
    """Records as zero-padded uint8 rows [len(recs), n] and their lengths
    (int32)."""
    blocks = np.zeros((len(recs), n), np.uint8)
    nv = np.zeros(len(recs), np.int32)
    for k, r in enumerate(recs):
        blocks[k, :len(r)] = np.frombuffer(r, np.uint8)
        nv[k] = len(r)
    return blocks, nv


def assemble_records(n: int, seed: int, lanes: int = 32) -> list:
    """Seeded records for one chunk at width n that give the assembly its
    edge lanes: empty, 1 byte, noise (no sequence), one and two matches,
    literals under 64, noise with one 4-byte match (a raw block with a
    sequence), the sequence cap (4-byte pieces of 512 random bytes, a match
    every 4 bytes), 256 units of a separator and a 4-byte word (1 literal
    and a 4-byte match at offset 5 each, every offset after the first
    rep0: a single-symbol ml channel, RLE), exactly n bytes of text, then
    text and half-text half-noise records up to `lanes`."""
    rng = np.random.default_rng(seed)
    words = [b"alpha ", b"bravo ", b"charlie ", b"delta ", b"echo ",
             b"foxtrot ", b"golf ", b"hotel ", b"india ", b"juliet "]

    def text(k):
        return b"".join(words[i] for i in rng.integers(0, 10, k // 4 + 2))[:k]

    def noise(k):
        return rng.integers(0, 256, k, dtype=np.uint8).tobytes()

    x, y, z, w = noise(200), noise(512), noise(n * 3 // 4), noise(4)
    pieces = b"".join(y[a:a + 4] for a in rng.integers(0, 508, n // 4))
    recs = [b"", b"z", noise(n * 3 // 4), x[:100] + x[:20],
            x + x[:20] + noise(30) + x[50:80], x[:40] + x[:30], z + z[:4],
            (y + pieces)[:n],
            w + b"".join(bytes([s]) + w for s in rng.permutation(256)),
            text(n)]
    for k in range(lanes - len(recs)):
        size = int(rng.integers(64, n + 1))
        recs.append(text(size // 2) + noise(size // 2) if k % 4 == 3
                    else text(size))
    return recs


def roll_back(call, lane: int) -> None:
    """Give lane `lane` of a ``capture_assemble`` record the tables the
    host builder leaves on a rolled-back lane (predefined, mode 0, an
    empty table area; its nseq stays), in place."""
    t = de._tables()
    for name in asm.STREAMS:
        maps, nbs, init, flush = call["seq"][name]
        for dst, src in ((maps, "maps"), (nbs, "nbs"), (init, "init")):
            dst[lane] = torch.from_numpy(t[name][src]).to(dst.device)
        flush[lane] = t[name]["tlog"]
    for k in ("mode", "tbl", "tbl_len"):
        call["seq"][k][lane] = 0


def chain_case_call(call, lane: int, nseqs) -> dict:
    """A ``capture_assemble`` record whose lanes are copies of lane `lane`
    of `call`, lane k keeping the first nseqs[k] of its sequences (each at
    most the lane's own count): the same tables, literals and record, so
    every lane is a valid operand and its chains have the chosen
    lengths."""
    idx = torch.full((len(nseqs),), lane, dtype=torch.long,
                     device=call["blocks"].device)

    def take(t):
        return t[idx].contiguous()

    have = int(call["parsed"]["nseq"][lane])
    assert max(nseqs) <= have, (max(nseqs), have)
    c = dict(call)
    for k in ("blocks", "n_valid", "lit_sorted", "lit_count"):
        c[k] = take(call[k])
    c["parsed"] = {k: take(v) for k, v in call["parsed"].items()}
    c["parsed"]["nseq"] = torch.tensor(nseqs, dtype=torch.int32,
                                       device=idx.device)
    c["huf"] = tuple(take(t) for t in call["huf"])
    c["seq"] = {k: (tuple(take(t) for t in v) if isinstance(v, tuple)
                    else take(v)) for k, v in call["seq"].items()}
    return c
