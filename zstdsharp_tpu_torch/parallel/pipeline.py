"""Data-parallel stream codec over a mesh of torch devices (counterpart of
zstdsharp_tpu/parallel/pipeline.py).

A mesh is a list of ``torch.device``s, the reference's 1-D ("data",) mesh:
independent blocks are split over it by rows, each device runs the batched
candidate stage on its rows, and the candidate count is summed over the
mesh (and over a ``torch.distributed`` process group when one is given),
as the reference's ``psum``.  Compressed frames are standard zstd, byte for
byte the reference's on the same mesh size.

Levels <= 2 make one frame: the device candidates are unsorted on each
device, copied to the host once, and the native ``dp_frame_body`` selects
matches and entropy-codes every block.  Levels >= 3 compress one host job
per mesh entry, after a device probe of match density routes incompressible
jobs to raw frames.  Stream decode runs frames of the device envelope on
the mesh (``decode_batch_device``, the Huffman and FSE kernels on a GPU)
and the others on the host engine; record compression runs
``compress_batch_device`` per mesh entry.

``make_mesh()`` takes every CUDA device and raises when there is none;
tests pass an explicit mesh such as ``["cpu"] * 8``.
"""

from __future__ import annotations

import contextlib
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.distributed as dist

from .. import constants as C
from .. import native
from ..decode.device_pipeline import decode_batch_device, scan_eligibility
from ..decode.frame import (decompress, find_frame_compressed_size,
                            parse_frame_header)
from ..encode.device_pipeline import compress_batch_device
from ..encode.frame import _block_header, _write_frame_header
from ..encode.frame import compress as host_compress
from ..ops.matcher import candidate_stage
from ..utils.xxhash import content_checksum

BLOCK = C.ZSTD_BLOCKSIZE_MAX  # 128 KiB
# Positions per candidate_stage call: its int64 intermediates then take
# about 1.5 GB of device memory however long the input is.
_STEP_POSITIONS = 1 << 24


def make_mesh(devices=None) -> list:
    """The mesh: `devices` as torch devices, or every CUDA device.  Raises
    when no device is given and there is no CUDA device."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device; pass the devices "
                               "explicitly, e.g. make_mesh(['cpu'] * 8)")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    mesh = [torch.device(d) for d in devices]
    if not mesh:
        raise ValueError("make_mesh: no devices")
    return mesh


def _on(dev):
    """`dev` as the current CUDA device of the calling thread (the
    reference's ``jax.default_device``); nothing for a CPU shard.  Each
    dispatcher thread starts on cuda:0, so a shard on another card needs
    it."""
    dev = torch.device(dev)
    return (torch.cuda.device(dev) if dev.type == "cuda"
            else contextlib.nullcontext())


def shard_blocks(data, n_devices: int,
                 block_size: int = BLOCK) -> tuple[np.ndarray, np.ndarray, int]:
    """Split a buffer into fixed blocks padded to a multiple of n_devices.

    Returns (blocks [B, block_size] u8, n_valid [B] i32, real_block_count).
    """
    src = (data if isinstance(data, np.ndarray)
           else np.frombuffer(bytes(data), dtype=np.uint8))
    n = len(src)
    n_blocks = max(-(-n // block_size), 1)
    padded_blocks = -(-n_blocks // n_devices) * n_devices
    blocks = np.zeros((padded_blocks, block_size), dtype=np.uint8)
    blocks.reshape(-1)[:n] = src
    n_valid = np.clip(n - np.arange(padded_blocks, dtype=np.int64)
                      * block_size, 0, block_size).astype(np.int32)
    return blocks, n_valid, n_blocks


def _device_step(blocks: torch.Tensor, hash_log: int):
    """One shard's step: candidate_stage over its rows, at most
    _STEP_POSITIONS positions per call.  Returns (ps, cand, count of valid
    candidates), all on the shard's device."""
    step = max(1, _STEP_POSITIONS // blocks.shape[1])
    parts = [candidate_stage(blocks[i:i + step], hash_log)
             for i in range(0, blocks.shape[0], step)]
    cand = torch.cat([c for _, c in parts])
    return torch.cat([p for p, _ in parts]), cand, (cand >= 0).sum()


def make_sharded_parse(mesh, hash_log: int = 16, block_size: int = BLOCK,
                       group=None):
    """The sharded candidate stage: a callable on (blocks uint8 [B,
    block_size], n_valid [B]), numpy arrays or CPU tensors, with B a
    multiple of the mesh size.  Rows are split contiguously over the mesh
    (the reference's P("data") on dim 0) and each shard runs on its device.

    Returns {"ps": [...], "cand": [...], "global_candidates": int64 []}:
    ps and cand list each shard's int32 [B / len(mesh), block_size] result
    on its device, in row order; global_candidates, on the mesh's first
    device, counts the valid candidates of every shard, and of every
    process of `group` (a torch.distributed process group) when one is
    given.  n_valid is taken for the reference's signature: the stage
    reads every byte of each row."""
    def parse(blocks, n_valid):
        blocks = torch.as_tensor(blocks)
        if blocks.dim() != 2 or blocks.shape[1] != block_size \
                or blocks.shape[0] % len(mesh):
            raise ValueError(f"blocks: shape {tuple(blocks.shape)}, expected "
                             f"[a multiple of {len(mesh)}, {block_size}]")
        rows = blocks.shape[0] // len(mesh)
        outs = [_device_step(blocks[d * rows:(d + 1) * rows].to(dev),
                             hash_log) for d, dev in enumerate(mesh)]
        total = sum(n.to(mesh[0]) for _, _, n in outs)
        if group is not None:
            dist.all_reduce(total, group=group)
        return {"ps": [p for p, _, _ in outs], "cand": [c for _, c, _ in outs],
                "global_candidates": total}
    return parse


def compress_data_parallel(data: bytes, mesh=None, level: int = 1,
                           checksum: bool = False, block_size: int = BLOCK,
                           telemetry: dict | None = None) -> bytes:
    """Data-parallel compression over the mesh, the reference's frame byte
    for byte.

    Level <= 2: one frame of window-independent blocks; the sharded
    candidate stage runs on the mesh, each shard unsorts its candidates to
    positional order on its device, and one copy per shard brings them to
    the host, where the native ``dp_frame_body`` selects matches and
    entropy-codes every block.  Level >= 3: one frame per mesh entry
    (``_compress_framewise_parallel``).

    `telemetry`, if given, gets bytes, blocks, parse_ms (blocking, the
    device stage, the unsort and the copies) and body_ms (the native body).
    Without the native library the host tier's ``compress`` makes the
    frame instead.
    """
    mesh = mesh if mesh is not None else make_mesh()
    if level >= 3:
        return _compress_framewise_parallel(data, mesh, level, checksum)
    t0 = time.perf_counter()
    blocks, n_valid, n_blocks = shard_blocks(data, len(mesh), block_size)
    shards = make_sharded_parse(mesh, block_size=block_size)(blocks, n_valid)
    cand_by_pos = np.empty(blocks.shape, np.int32)
    rows = len(blocks) // len(mesh)
    for d, (ps, cand) in enumerate(zip(shards["ps"], shards["cand"])):
        by_pos = torch.empty_like(cand).scatter_(1, ps.to(torch.int64), cand)
        cand_by_pos[d * rows:(d + 1) * rows] = by_pos.cpu().numpy()
    t_parse = time.perf_counter() - t0

    src = np.frombuffer(bytes(data), dtype=np.uint8)
    out = bytearray(_write_frame_header(len(src), C.ZSTD_BLOCKSIZELOG_MAX,
                                        checksum, True))
    if len(src) == 0:
        out += _block_header(True, C.BlockType.RAW, 0)
        if checksum:
            out += content_checksum(src).to_bytes(4, "little")
        return bytes(out)

    t0 = time.perf_counter()
    body = native.dp_frame_body(src, cand_by_pos[:n_blocks].reshape(-1),
                                block_size)
    if telemetry is not None:
        telemetry.update({
            "bytes": len(src),
            "blocks": n_blocks,
            "parse_ms": round(t_parse * 1e3, 1),
            "body_ms": round((time.perf_counter() - t0) * 1e3, 1),
        })
    if body is None:
        # no native engine: the host tier's exact encoder makes the frame
        return host_compress(bytes(data), level, checksum=checksum)
    out += body
    if checksum:
        out += content_checksum(src).to_bytes(4, "little")
    return bytes(out)


def _raw_frame(chunk: bytes, checksum: bool) -> bytes:
    out = bytearray(_write_frame_header(len(chunk), C.ZSTD_BLOCKSIZELOG_MAX,
                                        checksum, True))
    for off in range(0, len(chunk), BLOCK):
        piece = chunk[off:off + BLOCK]
        out += _block_header(off + BLOCK >= len(chunk), C.BlockType.RAW,
                             len(piece))
        out += piece
    if checksum:
        out += content_checksum(
            np.frombuffer(chunk, np.uint8)).to_bytes(4, "little")
    return bytes(out)


def _compress_framewise_parallel(data: bytes, mesh, level: int,
                                 checksum: bool) -> bytes:
    """Levels >= 3: one job of ceil(n / len(mesh)) bytes (at least 64 KiB)
    per mesh entry, each compressed by the host engine at `level` in a
    thread pool.  A device probe of each job (head, middle and tail, 64 KiB
    at most) measures its candidate density; a job of 64 KiB or more whose
    density is below 0.02 becomes a raw frame without a search."""
    ndev = len(mesh)
    n = len(data)
    if n == 0:
        return host_compress(data, level, checksum=checksum)
    job = max(-(-n // ndev), 1 << 16)
    chunks = [data[i:i + job] for i in range(0, n, job)]

    probe = min(job, 1 << 16)
    blocks = np.zeros((max(-(-len(chunks) // ndev) * ndev, ndev), probe),
                      np.uint8)
    n_valid = np.zeros(len(blocks), np.int32)
    for i, c in enumerate(chunks):
        if len(c) <= probe:
            p = np.frombuffer(c, np.uint8)
        else:
            third = probe // 3
            mid = (len(c) - third) // 2
            p = np.frombuffer(
                c[:third] + c[mid:mid + third]
                + c[len(c) - (probe - 2 * third):], np.uint8)
        blocks[i, :len(p)] = p
        n_valid[i] = len(p)
    shards = make_sharded_parse(mesh, block_size=probe)(blocks, n_valid)
    cand = np.concatenate([c.cpu().numpy() for c in shards["cand"]])
    density = (cand[:len(chunks)] >= 0).mean(axis=1)

    def one(i: int) -> bytes:
        if density[i] < 0.02 and len(chunks[i]) >= (1 << 16):
            return _raw_frame(chunks[i], checksum)
        return host_compress(chunks[i], level, checksum=checksum)

    with ThreadPoolExecutor(max_workers=min(ndev, 16)) as pool:
        return b"".join(pool.map(one, range(len(chunks))))


def _gather_payloads(local: list, mesh, group, width: int) -> np.ndarray:
    """All-gather of the shards' decoded payloads (uint8 rows padded to
    `width`; `local` holds this process's rows in mesh order).  Without a
    group, every shard's row is copied to every mesh device and each
    device's copy is read back; with one, the rows of every process are
    gathered by ``all_gather_into_tensor`` on the mesh's first device.
    Returns the gathered rows [shards, width] as the host sees them."""
    def row(b, dev):
        r = torch.zeros(width, dtype=torch.uint8, device=dev)
        r[:len(b)] = torch.from_numpy(np.frombuffer(b, np.uint8).copy())
        return r

    if group is None:
        rows = [row(b, dev) for b, dev in zip(local, mesh)]
        copies = [torch.stack([r.to(dev) for r in rows]).cpu().numpy()
                  for dev in mesh]
        if any(not np.array_equal(c, copies[0]) for c in copies[1:]):
            raise RuntimeError("payload all-gather: device copies differ")
        return copies[0]
    mine = torch.stack([row(b, mesh[0]) for b in local])
    out = torch.empty(dist.get_world_size(group) * len(local), width,
                      dtype=torch.uint8, device=mesh[0])
    dist.all_gather_into_tensor(out, mine, group=group)
    return out.cpu().numpy()


def decompress_data_parallel(stream: bytes, mesh=None,
                             telemetry: dict | None = None,
                             group=None) -> bytes:
    """Sharded stream decode with a device plane.

    The stream is split on frame boundaries.  Frames of the device envelope
    (single-block, content size known, <= 128 KB; ``scan_eligibility``)
    are dealt round-robin over the mesh's devices and decoded there by
    ``decode_batch_device``, one dispatcher thread per device; the others
    go to the host engine in a thread pool.  When there is more than one
    shard, the decoded payloads are all-gathered and checked byte for byte
    against the host-order join.

    With `group` (a torch.distributed process group), the shards are the
    mesh entries of every process in rank order: each process decodes its
    own, the all-gather brings every shard's payload to every process, and
    each returns the whole stream.

    `telemetry`, if given, gets frames, device_frames, host_frames, the
    stage times scan_ms, plan_ms, device_ms, gather_ms and host_ms, bytes,
    and device_shards (this process's shards: device, frames, bytes, ms).
    """
    mesh = mesh if mesh is not None else make_mesh()
    ndev = len(mesh)
    rank, world = ((0, 1) if group is None else
                   (dist.get_rank(group), dist.get_world_size(group)))
    t0 = time.perf_counter()
    frames = []
    pos = 0
    buf = bytes(stream)
    while pos < len(buf):
        size = find_frame_compressed_size(buf[pos:])
        frames.append(buf[pos:pos + size])
        pos += size
    t_scan = time.perf_counter() - t0
    if len(frames) <= 1 and telemetry is None:
        return decompress(buf)

    # header-only partition; multi-block frames go to the host engine, whose
    # serial window chain decodes them at engine speed
    t0 = time.perf_counter()
    host_idx = set(scan_eligibility(frames, single_block_only=True))
    dev_idx = [i for i in range(len(frames)) if i not in host_idx]
    t_plan = time.perf_counter() - t0

    results: list = [None] * len(frames)
    shard_stats = []
    t_gather = 0.0
    t0 = time.perf_counter()
    if dev_idx:
        n_shards = ndev * world
        shards = [dev_idx[g::n_shards] for g in range(n_shards)]
        mine = shards[rank * ndev:(rank + 1) * ndev]

        def run_shard(d: int):
            if not mine[d]:
                return [], 0.0
            ts = time.perf_counter()
            with _on(mesh[d]):
                outs, _ = decode_batch_device([frames[i] for i in mine[d]],
                                              device=mesh[d], materialize=True)
            return outs, time.perf_counter() - ts

        with ThreadPoolExecutor(max_workers=ndev) as pool:
            for d, (outs, dt) in enumerate(pool.map(run_shard, range(ndev))):
                for i, r in zip(mine[d], outs):
                    results[i] = r
                if mine[d]:
                    shard_stats.append({
                        "device": str(mesh[d]),
                        "frames": len(mine[d]),
                        "bytes": sum(len(r) for r in outs),
                        "ms": round(dt * 1e3, 1),
                    })

        if n_shards > 1:
            tg = time.perf_counter()
            sizes = [[parse_frame_header(np.frombuffer(
                frames[i], np.uint8)).frame_content_size for i in s]
                for s in shards]
            local = [b"".join(results[i] for i in s) for s in mine]
            flat = _gather_payloads(local, mesh, group,
                                    max(max(map(sum, sizes)), 1))
            for g, s in enumerate(shards):
                row = flat[g].tobytes()
                if rank * ndev <= g < (rank + 1) * ndev:
                    if row[:sum(sizes[g])] != local[g - rank * ndev]:
                        raise RuntimeError(f"payload all-gather: shard {g} "
                                           "differs from its decoded bytes")
                    continue
                off = 0
                for i, k in zip(s, sizes[g]):
                    results[i] = row[off:off + k]
                    off += k
            t_gather = time.perf_counter() - tg
    t_dev = time.perf_counter() - t0

    t0 = time.perf_counter()
    if host_idx:
        order = sorted(host_idx)
        with ThreadPoolExecutor(max_workers=min(ndev, 16)) as pool:
            for i, r in zip(order, pool.map(lambda i: decompress(frames[i]),
                                            order)):
                results[i] = r
    t_host = time.perf_counter() - t0

    if telemetry is not None:
        telemetry.update({
            "frames": len(frames),
            "device_frames": len(dev_idx),
            "host_frames": len(host_idx),
            "scan_ms": round(t_scan * 1e3, 1),
            "plan_ms": round(t_plan * 1e3, 1),
            "device_ms": round(t_dev * 1e3, 1),
            "gather_ms": round(t_gather * 1e3, 1),
            "host_ms": round(t_host * 1e3, 1),
            "bytes": sum(len(r) for r in results),
            "device_shards": shard_stats,
        })
    return b"".join(results)


def compress_records_device(records, mesh=None,
                            telemetry: dict | None = None) -> list:
    """Record-batch compression on the device plane, sharded over the
    mesh: records are dealt round-robin over the mesh's devices and each
    shard runs ``compress_batch_device`` there (the histogram kernel on a
    GPU), one dispatcher thread per device.  Returns each record's frame
    bytes in order; records outside the device envelope are compressed by
    the host tier.  `telemetry`, if given, gets ms, device_frames,
    host_frames and shards."""
    mesh = mesh if mesh is not None else make_mesh()
    ndev = len(mesh)
    results: list = [None] * len(records)
    shards = [list(range(d, len(records), ndev)) for d in range(ndev)]
    t0 = time.perf_counter()
    stats_all = []

    def run_shard(d: int):
        if not shards[d]:
            return [], None
        with _on(mesh[d]):
            return compress_batch_device([records[i] for i in shards[d]],
                                         device=mesh[d], materialize=True)

    with ThreadPoolExecutor(max_workers=ndev) as pool:
        for d, (frames, stats) in enumerate(pool.map(run_shard, range(ndev))):
            for i, f in zip(shards[d], frames):
                results[i] = f
            if stats:
                stats_all.append(stats)
    if telemetry is not None:
        telemetry["ms"] = round((time.perf_counter() - t0) * 1e3, 1)
        telemetry["device_frames"] = sum(s["device_frames"]
                                         for s in stats_all)
        telemetry["host_frames"] = sum(s["host_frames"] for s in stats_all)
        telemetry["shards"] = ndev
    return results
