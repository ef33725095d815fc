"""Entry points of the port (counterpart of the repository's
``__graft_entry__.py``, which stays the JAX reference).

entry(device="cuda"): (forward, example_args): the forward step of the
                      device pipeline, batched block parse plus code
                      statistics (``parse_block_stats``), on 4 blocks of
                      32 KiB at hash_log 15, with its arguments on `device`
                      (the card unless the caller names another; without
                      a card the default raises).
dryrun_multichip(n):  the data-parallel codec over an n-entry mesh: levels
                      1/5/19 over >= 8 MB round-tripped through the sharded
                      and the host decoder, the device-plane decode and
                      encode of 16 records, and the parse stage timed on 1
                      vs n mesh entries.  device="cuda" takes the first n
                      cards (and raises if there are fewer); "cpu" makes n
                      CPU shards.
"""

from __future__ import annotations

import time

import numpy as np
import torch


def _example_blocks(n_blocks: int,
                    block_size: int) -> tuple[np.ndarray, np.ndarray]:
    r = np.random.default_rng(0)
    words = [b"the", b"quick", b"brown", b"fox", b"zstandard", b"entropy"]
    data = b" ".join(words[i] for i in r.choice(len(words), 64_000))
    blocks = np.zeros((n_blocks, block_size), dtype=np.uint8)
    n_valid = np.full(n_blocks, block_size, dtype=np.int32)
    flat = np.frombuffer(data, dtype=np.uint8)
    for b in range(n_blocks):
        chunk = flat[(b * block_size) % (len(flat) - block_size):][:block_size]
        blocks[b, :len(chunk)] = chunk
    return blocks, n_valid


def entry(device="cuda"):
    """(forward, example_args): the parse-and-statistics forward step, its
    outputs summarised as the reference's, arguments on `device`."""
    from .ops._launch import resolve_device
    from .ops.matcher import parse_block_stats

    device = resolve_device(device)
    block_size = 1 << 15
    hash_log = 15

    def forward(blocks, n_valid):
        stats = parse_block_stats(blocks, n_valid, hash_log)
        return {
            "nseq": stats["nseq"],
            "match_bytes": stats["match_bytes"],
            "lit_hist": stats["lit_hist"].sum(dim=0),
            "of_hist": stats["of_hist"].sum(dim=0),
        }

    blocks, n_valid = _example_blocks(4, block_size)
    return forward, (torch.from_numpy(blocks).to(device),
                     torch.from_numpy(n_valid).to(device))


def _mesh_devices(n_devices: int, device: str) -> list:
    if device == "cpu":
        return ["cpu"] * n_devices
    if device != "cuda":
        raise ValueError(f"device: {device!r}, expected 'cuda' or 'cpu'")
    have = torch.cuda.device_count()
    if have < n_devices:
        raise RuntimeError(f"need {n_devices} CUDA devices, have {have}")
    return [torch.device("cuda", i) for i in range(n_devices)]


def _sync(mesh) -> None:
    for dev in mesh:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def dryrun_multichip(n_devices: int, device: str = "cuda") -> None:
    """Run the data-parallel codec over an n-entry mesh and print one line
    per step; every round trip is checked byte for byte."""
    from .decode.frame import decompress
    from .encode.frame import compress
    from .parallel.pipeline import (compress_data_parallel,
                                    compress_records_device,
                                    decompress_data_parallel, make_mesh,
                                    make_sharded_parse, shard_blocks)

    mesh = make_mesh(_mesh_devices(n_devices, device))

    r = np.random.default_rng(7)
    words = [b"shard", b"mesh", b"pjit", b"collective", b"zstd", b"frame"]
    data = b" ".join(words[i] for i in r.choice(len(words), 1_200_000))
    data += r.integers(0, 256, 1 << 20, dtype=np.uint8).tobytes()
    if len(data) < (8 << 20):
        raise RuntimeError("dryrun input is under 8 MB")

    for level in (1, 5, 19):
        tel = {}
        t0 = time.perf_counter()
        frame = compress_data_parallel(data, mesh, level=level, telemetry=tel)
        t_c = time.perf_counter() - t0
        t0 = time.perf_counter()
        out = decompress_data_parallel(frame, mesh)
        t_d = time.perf_counter() - t0
        if out != data:
            raise RuntimeError(f"L{level} sharded decode mismatch")
        if decompress(frame) != data:
            raise RuntimeError(f"L{level} host decode mismatch")
        stage = (f", parse {tel['parse_ms']}ms + native body "
                 f"{tel['body_ms']}ms "
                 f"({len(data) / max(tel['body_ms'], 0.001) / 1e3:.0f} MB/s)"
                 if tel else "")
        print(f"dryrun_multichip({n_devices}) L{level}: "
              f"{len(data)} -> {len(frame)} bytes, roundtrip bit-exact "
              f"(compress {t_c:.2f}s, sharded decode {t_d:.2f}s{stage})")

    # device-plane sharded decode of a record stream (every frame inside
    # the device envelope), with per-stage telemetry
    recs = [bytes(r.integers(97, 105, 600, dtype=np.uint8))
            for _ in range(16)]
    stream = b"".join(compress(x, 3) for x in recs)
    tel = {}
    out = decompress_data_parallel(stream, mesh, telemetry=tel)
    if out != b"".join(recs) or tel["device_frames"] != len(recs):
        raise RuntimeError("device-plane sharded decode mismatch")
    print(f"dryrun_multichip({n_devices}): device-plane decode "
          f"{tel['device_frames']} frames over "
          f"{len(tel['device_shards'])} shards "
          f"(scan {tel['scan_ms']}ms, plan {tel['plan_ms']}ms, "
          f"device {tel['device_ms']}ms, host {tel['host_ms']}ms)")

    # device-plane sharded encode: frames composed on each mesh entry,
    # decoded back byte-exact by the host engine
    enc_recs = [bytes(r.integers(97, 105, 500, dtype=np.uint8))
                for _ in range(8)] + [b"zstd " * 400] * 8
    tel = {}
    eframes = compress_records_device(enc_recs, mesh, telemetry=tel)
    if [decompress(f) for f in eframes] != enc_recs:
        raise RuntimeError("device-plane encode mismatch")
    print(f"dryrun_multichip({n_devices}): device-plane encode "
          f"{tel['device_frames']} frames over {tel['shards']} shards "
          f"({tel['ms']}ms), all frames host-decoded bit-exact")

    # parse-stage scaling: the sharded candidate stage on 1 vs n entries
    block_size = 1 << 15
    blocks, n_valid, _ = shard_blocks(data[:4 << 20], n_devices, block_size)

    def time_parse(mesh_n, reps=3):
        parse = make_sharded_parse(mesh_n, block_size=block_size)
        parse(blocks, n_valid)
        _sync(mesh_n)
        t0 = time.perf_counter()
        for _ in range(reps):
            parse(blocks, n_valid)
        _sync(mesh_n)
        return (time.perf_counter() - t0) / reps

    t_n = time_parse(mesh)
    t_1 = time_parse(mesh[:1])
    note = ("CPU shards share the host's cores" if mesh[0].type == "cpu"
            else "includes the host-to-device copy of the blocks")
    print(f"dryrun_multichip({n_devices}): parse stage {t_1 * 1e3:.0f}ms on 1 "
          f"device -> {t_n * 1e3:.0f}ms on {n_devices} "
          f"({t_1 / t_n:.1f}x; {note})")


if __name__ == "__main__":
    fn, args = entry("cuda")
    print("entry():", {k: tuple(v.shape) for k, v in fn(*args).items()})
    dryrun_multichip(torch.cuda.device_count())
