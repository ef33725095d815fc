"""Two-process torch.distributed run of the port's data-parallel pipeline
(the counterpart of test_multihost.py).

Two worker processes (this file run as a script) join one gloo process
group over localhost.  Each holds a mesh of 4 CPU shards, so the global
mesh has 8.  Each runs the sharded candidate stage on its half of the
blocks, with the candidate count summed over the group by ``all_reduce``;
the candidates are all-gathered and rank 0 composes the level-1 frame.
Both ranks also decode a record stream with the group, each decoding its
own shards, the payloads all-gathered.  The parent test checks that the
ranks agree on the count and that the frame and the decoded stream equal
the single-process port's on the same input.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
LOCAL_SHARDS = 4
TIMEOUT_S = 120


def _data():
    import numpy as np

    rng = np.random.default_rng(11)
    words = [b"alpha ", b"beta ", b"gamma ", b"delta "]
    return b"".join(words[i] for i in rng.integers(0, 4, 60000))


def _records():
    return [(b"record %d " % i) * (40 + 13 * i) for i in range(8)]


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _worker(port: int, rank: int, out_path: str) -> None:
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch
    import torch.distributed as dist

    from zstdsharp_tpu import constants as C
    from zstdsharp_tpu import native
    from zstdsharp_tpu.encode.frame import _write_frame_header, compress
    from zstdsharp_tpu_torch.parallel.pipeline import (
        decompress_data_parallel, make_mesh, make_sharded_parse,
        shard_blocks)

    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=2, rank=rank)
    try:
        data = _data()
        mesh = make_mesh(["cpu"] * LOCAL_SHARDS)
        blocks, n_valid, n_blocks = shard_blocks(data, 2 * LOCAL_SHARDS)
        half = len(blocks) // 2
        mine = slice(rank * half, (rank + 1) * half)
        out = make_sharded_parse(mesh, group=dist.group.WORLD)(
            blocks[mine], n_valid[mine])
        result = {"global_candidates": int(out["global_candidates"])}

        # gather every process's candidates, unsort, compose on rank 0
        local = [torch.cat(out["ps"]), torch.cat(out["cand"])]
        gathered = []
        for t in local:
            parts = [torch.empty_like(t) for _ in range(2)]
            dist.all_gather(parts, t)
            gathered.append(torch.cat(parts))
        if rank == 0:
            ps, cand = gathered
            by_pos = torch.empty_like(cand).scatter_(1, ps.long(), cand)
            src = np.frombuffer(data, np.uint8)
            body = native.dp_frame_body(
                src, by_pos[:n_blocks].numpy().reshape(-1), C.ZSTD_BLOCKSIZE_MAX)
            frame = _write_frame_header(len(src), C.ZSTD_BLOCKSIZELOG_MAX,
                                        False, True) + body
            result["frame_hex"] = frame.hex()

        stream = b"".join(compress(r, 3) for r in _records())
        tel = {}
        decoded = decompress_data_parallel(stream, make_mesh(["cpu"] * 2),
                                           telemetry=tel,
                                           group=dist.group.WORLD)
        result["decoded_ok"] = decoded == b"".join(_records())
        result["device_frames"] = tel["device_frames"]
        result["local_frames"] = sum(s["frames"] for s in tel["device_shards"])
        with open(out_path, "w") as f:
            json.dump(result, f)
    finally:
        dist.destroy_process_group()


def test_two_process_group(tmp_path):
    port = _free_port()
    outs = [tmp_path / "w0.json", tmp_path / "w1.json"]
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_"))}
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(port), str(rank), str(outs[rank])],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for rank in (0, 1)]
    results = []
    try:
        for p in procs:
            results.append(p.communicate(timeout=TIMEOUT_S))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (_, err) in zip(procs, results):
        assert p.returncode == 0, err[-3000:]

    w0 = json.loads(outs[0].read_text())
    w1 = json.loads(outs[1].read_text())
    # the count crossed the process boundary: both ranks hold the total
    assert w0["global_candidates"] == w1["global_candidates"]

    from zstdsharp_tpu_torch.parallel.pipeline import (
        compress_data_parallel, make_sharded_parse, shard_blocks)

    data = _data()
    blocks, n_valid, _ = shard_blocks(data, 2 * LOCAL_SHARDS)
    single = make_sharded_parse(["cpu"] * (2 * LOCAL_SHARDS))(blocks, n_valid)
    assert w0["global_candidates"] == int(single["global_candidates"]) > 0
    assert bytes.fromhex(w0["frame_hex"]) == compress_data_parallel(
        data, ["cpu"] * (2 * LOCAL_SHARDS))

    # each rank decoded its own shards and returned the whole stream
    for w in (w0, w1):
        assert w["decoded_ok"] and w["device_frames"] == len(_records())
    assert w0["local_frames"] + w1["local_frames"] == len(_records())
    assert 0 < w0["local_frames"] < len(_records())


def test_single_process_port_equals_reference():
    """The single-process port that the two-process run is held against
    equals the JAX package on the same input (8 shards on both sides):
    the candidates, their global count and the level-1 frame."""
    import jax.numpy as jnp
    import numpy as np
    import torch

    from zstdsharp_tpu.parallel import pipeline as rp
    from zstdsharp_tpu_torch.parallel import pipeline as tp

    data = _data()
    mesh = ["cpu"] * (2 * LOCAL_SHARDS)
    blocks, n_valid, _ = tp.shard_blocks(data, len(mesh))
    got = tp.make_sharded_parse(mesh)(blocks, n_valid)
    r_mesh = rp.make_mesh()
    assert len(r_mesh.devices.flat) == len(mesh)
    want = rp.make_sharded_parse(r_mesh)(jnp.asarray(blocks),
                                         jnp.asarray(n_valid))
    for k in ("ps", "cand"):
        assert np.array_equal(torch.cat(got[k]).numpy(), np.asarray(want[k]))
    assert int(got["global_candidates"]) == int(want["global_candidates"]) > 0
    assert tp.compress_data_parallel(data, mesh) == rp.compress_data_parallel(
        data, r_mesh)


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
