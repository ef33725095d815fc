"""The record-batch encode plane: one call is
``compress_batch_device(records, True, hash_log, device=)`` on one batch,
so the frames come back as bytes, as a producer or a writer needs them.  A
traced run's timed half passes ``timings=`` as well.

The reference is ``reference/zstd_plain.py``, a zstd decoder written from
RFC 8878: a sample of the frames drawn from the seed, the longest record
among them, must decode to their records.  Every frame of a kept call must
also keep the configuration's guarantees: the record's length as the
content size in the header, no checksum, no dictionary.
"""

from __future__ import annotations

import torch

from benchmark.gen import make_batches
from benchmark.reference.zstd_plain import FrameError, decode_frame, \
    frame_header


class State:
    def __init__(self, cfg, mix, seed, device):
        from zstdsharp_tpu_torch.encode.device_pipeline import \
            compress_batch_device

        self.device = torch.device(device)
        self.records = make_batches(cfg, mix, seed)
        self.n_batches = len(self.records)
        self.content_bytes = [sum(map(len, b)) for b in self.records]
        self.hash_log = int(cfg["hash_log"])
        self.checksum = bool(cfg["checksum"])
        self.compress = compress_batch_device


def prepare(cfg, mix, seed, device) -> State:
    return State(cfg, mix, seed, device)


def call(st: State, k: int, timings: dict | None = None):
    return st.compress(st.records[k], True, st.hash_log, device=st.device,
                       timings=timings)


def account(st: State, k: int, res) -> dict:
    frames, stats = res
    return {"items": len(st.records[k]), "content_bytes": st.content_bytes[k],
            "frame_bytes": sum(map(len, frames)),
            "host_routed": int(stats.get("host_frames", 0))}


def off_config(frame: bytes, record: bytes, checksum: bool) -> bool:
    """Whether a frame breaks the configuration's stated frame format."""
    try:
        h = frame_header(bytes(frame))
    except (FrameError, IndexError):
        return True
    return (h["content_size"] != len(record) or h["has_checksum"] != checksum
            or h["dict_id"] != 0)


def decodes_to(frame: bytes, record: bytes) -> bool:
    try:
        return decode_frame(frame) == record
    except Exception:  # any fault of the frame is a wrong frame
        return False


def check(st: State, mix: dict, kept: list, rng) -> dict:
    missing = off = wrong = 0
    pairs = []
    for j, (k, (frames, _stats)) in enumerate(kept):
        recs = st.records[k]
        if len(frames) != len(recs):
            missing += len(recs)
            continue
        off += sum(off_config(f, r, st.checksum) for f, r in zip(frames, recs))
        pairs += [(j, i) for i in range(len(recs))]
    sample = []
    if pairs:
        n = min(int(mix["check_records"]), len(pairs))
        sample = [pairs[p] for p in rng.choice(len(pairs), n, replace=False)]
        longest = max(pairs,
                      key=lambda p: len(st.records[kept[p[0]][0]][p[1]]))
        if longest not in sample:
            sample.append(longest)
    for j, i in sample:
        k, (frames, _stats) = kept[j]
        wrong += not decodes_to(frames[i], st.records[k][i])
    return {"frames_missing": {"value": missing, "at_most": 0},
            "frames_off_config": {"value": off, "at_most": 0},
            "frames_wrong": {"value": wrong, "at_most": 0},
            "frames_checked": {"value": len(sample), "at_least": 1}}


def raw_frame(record: bytes) -> bytes:
    """A zstd frame holding `record` as one raw block (single segment, a
    4-byte content size, no checksum)."""
    n = len(record)
    return (b"\x28\xb5\x2f\xfd\xa0" + n.to_bytes(4, "little")
            + ((n << 3) | 1).to_bytes(3, "little") + record)


def control(st: State, k: int, rng):
    """The reference encoder (raw blocks) in the program's place with its
    guarantee broken: one bit flipped at a seeded place in every record
    before it is framed (a lossy encode)."""
    frames = []
    for r in st.records[k]:
        b = bytearray(r)
        if b:
            b[int(rng.integers(0, len(b)))] ^= 1 << int(rng.integers(0, 8))
        frames.append(raw_frame(bytes(b)))
    return frames, {"device_frames": 0, "host_frames": 0}
