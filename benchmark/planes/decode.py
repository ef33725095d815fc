"""The record-batch decode plane: one call is
``Decompressor().unwrap_many_device(frames, device)`` on one batch; the rows
stay on the card.  A traced run's timed half calls
``decode_batch_device(frames, device=, timings=)``, which that method calls
with no dictionary, so its stage walls can be read.

Inputs: each record of the pool made into one zstd frame at set-up by the
repository's C++ engine (``engine.py``), at the configuration's level and
checksum flag.  The reference is the content itself: a lossless decode
gives it back byte for byte, host-routed frames included.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.engine import Engine
from benchmark.gen import make_batches


class State:
    def __init__(self, cfg, mix, seed, device):
        from zstdsharp_tpu_torch.decode.device_pipeline import \
            decode_batch_device
        from zstdsharp_tpu_torch.decode.frame import Decompressor

        self.device = torch.device(device)
        self.contents = make_batches(cfg, mix, seed)
        eng = Engine()
        self.frames = [[eng.frame(r, int(cfg["level"]), bool(cfg["checksum"]))
                        for r in batch] for batch in self.contents]
        self.n_batches = len(self.frames)
        self.content_bytes = [sum(map(len, b)) for b in self.contents]
        self.frame_bytes = [sum(map(len, b)) for b in self.frames]
        self.dec = Decompressor()
        self.decode_batch_device = decode_batch_device


def prepare(cfg, mix, seed, device) -> State:
    return State(cfg, mix, seed, device)


def call(st: State, k: int, timings: dict | None = None):
    if timings is None:
        return st.dec.unwrap_many_device(st.frames[k], st.device)
    return st.decode_batch_device(st.frames[k], device=st.device,
                                  timings=timings)


def account(st: State, k: int, res) -> dict:
    return {"items": len(st.frames[k]), "content_bytes": st.content_bytes[k],
            "frame_bytes": st.frame_bytes[k], "host_routed": len(res[2])}


def frames_wrong(contents: list, res) -> int:
    """How many of a batch's frames the result does not give back exactly:
    device rows (in frame order, the host-routed frames left out) cut at
    their lengths, and host-routed frames as bytes or device tensors."""
    outputs, lengths, host = res
    n = len(contents)
    dev = [i for i in range(n) if i not in host]
    wrong = sum(1 for i in host if not 0 <= i < n)
    rows = (torch.cat([o.reshape(o.shape[0], -1) for o in outputs])
            .cpu().numpy() if len(outputs) else np.zeros((0, 0), np.uint8))
    lengths = np.asarray(lengths)
    if len(lengths) != len(dev) or rows.shape[0] < len(dev):
        wrong += len(dev)
    else:
        for j, i in enumerate(dev):
            c = contents[i]
            if int(lengths[j]) != len(c) or rows[j, :len(c)].tobytes() != c:
                wrong += 1
    for i, v in host.items():
        if 0 <= i < n:
            data = (v.cpu().numpy().tobytes() if isinstance(v, torch.Tensor)
                    else bytes(v))
            wrong += data != contents[i]
    return wrong


def check(st: State, mix: dict, kept: list, rng) -> dict:
    """Every frame of every kept call against its content."""
    wrong = checked = 0
    for k, res in kept:
        wrong += frames_wrong(st.contents[k], res)
        checked += len(st.contents[k])
    return {"frames_wrong": {"value": wrong, "at_most": 0},
            "frames_checked": {"value": checked, "at_least": 1}}


def control(st: State, k: int, rng):
    """The reference in the program's place with its guarantee broken: the
    rows of the content itself, in the program's layout, with one bit
    flipped at a seeded place in every frame (a lossy decode)."""
    contents = st.contents[k]
    width = max(map(len, contents))
    rows = np.zeros((len(contents), width), np.uint8)
    for i, c in enumerate(contents):
        rows[i, :len(c)] = np.frombuffer(c, np.uint8)
        if len(c):
            bit = 1 << int(rng.integers(0, 8))
            rows[i, int(rng.integers(0, len(c)))] ^= bit
    lengths = np.array([len(c) for c in contents], np.int64)
    return [torch.from_numpy(rows).to(st.device)], lengths, {}
