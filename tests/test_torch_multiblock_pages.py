"""The port's multi-block record decode on Parquet data pages: three 1 MiB
PLAIN pages of TPC-H ``lineitem`` (the benchmark's payload), each one
level-1 frame as Arrow's writer makes it (a 512 KiB window, not single
segment, 8-9 blocks), decoded on the CPU through the normal record path
and held against the content and the benchmark's plain RFC 8878 decoder;
the multi-block planner's spans and counters against the frames' block
headers; and the frame header's window read from numpy input as from
bytes."""

import numpy as np
import pytest

from benchmark.engine import Engine
from benchmark.payloads import tpch_lineitem_plain as lineitem
from benchmark.reference import zstd_plain
from zstdsharp_tpu_torch.decode import device_pipeline as dp
from zstdsharp_tpu_torch.decode.frame import (Decompressor, FrameDecoder,
                                              parse_frame_header)
from zstdsharp_tpu_torch.encode.frame import compress
from zstdsharp_tpu_torch.errors import ZstdError, ZstdErrorCode

COLUMNS = ("l_orderkey", "l_comment", "l_extendedprice")
# one page of exactly 1 MiB (8 blocks) and two past it (9 blocks), so the
# executor takes two groups: content buckets of 1 MiB and 4 MiB
LENGTHS = (1 << 20, (1 << 20) + 20_000, (1 << 20) + 4_000)
WINDOW = 1 << 19
MB_KEYS = ("n.mb_frames", "n.mb_blocks", "n.mb_groups", "n.mb_rounds",
           "n.mb_lit_bytes", "n.mb_host_lit_bytes", "n.mb_treeless_host",
           "n.mb_native_frames", "n.mb_python_frames", "plan.multiblock",
           "mb_exec.upload")


@pytest.fixture(scope="module")
def pages():
    """One row group of the payload; these columns' first pages."""
    idx = [lineitem.PLAN.index(c) for c in COLUMNS]
    lengths = np.full(len(lineitem.PLAN), 1 << 20)
    lengths[idx] = LENGTHS
    group = lineitem.make(lengths, np.random.default_rng(2**31 + 21))
    contents = [group[i] for i in idx]
    eng = Engine()
    return contents, [eng.frame(c, 1, False) for c in contents]


def _blocks(frame: bytes) -> list:
    """(block type, literal section type, regenerated literal bytes) of
    each block, read from the block and literal section headers."""
    p = zstd_plain.frame_header(frame)["header_size"]
    out = []
    while True:
        bh = int.from_bytes(frame[p:p + 3], "little")
        last, btype, size = bh & 1, (bh >> 1) & 3, bh >> 3
        p += 3
        if btype == 2:
            b0 = frame[p]
            lt, sf = b0 & 3, (b0 >> 2) & 3
            if lt < 2:
                n = (1, 2, 1, 3)[sf]
                v = int.from_bytes(frame[p:p + n], "little")
                regen = v >> 3 if n == 1 else v >> 4
            else:
                n, bits = ((3, 10), (3, 10), (4, 14), (5, 18))[sf]
                v = int.from_bytes(frame[p:p + n], "little")
                regen = (v >> 4) & ((1 << bits) - 1)
            out.append((btype, lt, regen))
        else:
            out.append((btype, None, 0))
        p += 1 if btype == 1 else size
        if last:
            return out


def test_pages_are_multiblock_frames_with_a_window(pages):
    contents, frames = pages
    assert [len(c) for c in contents] == list(LENGTHS)
    kinds = []
    for c, f in zip(contents, frames):
        hdr = zstd_plain.frame_header(f)
        assert not hdr["single_segment"] and hdr["window_size"] == WINDOW
        assert hdr["content_size"] == len(c) and not hdr["has_checksum"]
        blocks = _blocks(f)
        assert len(blocks) == -(-len(c) // (1 << 17))
        assert 8 <= len(blocks) <= 9
        kinds += [lt for _, lt, _ in blocks]
    assert 3 in kinds  # treeless literal sections, as level 1 writes them


@pytest.mark.parametrize("src", ["bytes", "numpy"])
def test_window_of_a_non_single_segment_frame(pages, src):
    f = pages[1][0]
    hdr = parse_frame_header(np.frombuffer(f, np.uint8) if src == "numpy"
                             else f)
    assert hdr.window_size == WINDOW and type(hdr.window_size) is int
    assert not hdr.single_segment


@pytest.mark.parametrize("src", ["bytes", "numpy"])
def test_window_beyond_the_limit_raises(pages, src):
    f = pages[1][0]
    data = np.frombuffer(f, np.uint8) if src == "numpy" else f
    with pytest.raises(ZstdError) as e:
        FrameDecoder(max_window_log=18).decode(data)
    assert e.value.code == ZstdErrorCode.frameParameter_windowTooLarge
    out, n = FrameDecoder(max_window_log=19).decode(data)
    assert n == len(f) and bytes(out) == pages[0][0]


def test_planner_takes_every_frame_with_its_window(pages):
    plan = dp.plan_batch(pages[1])
    assert not plan.host_routed and not plan.blocks
    assert [m["frame_idx"] for m in plan.mb_frames] == [0, 1, 2]
    assert [m["window"] for m in plan.mb_frames] == [WINDOW] * 3
    assert not dp.scan_eligibility(pages[1])


@pytest.fixture(scope="module")
def unwrapped(pages):
    return Decompressor().unwrap_many_device(pages[1], "cpu")


@pytest.fixture(scope="module")
def materialized(pages):
    timings = {}
    res = dp.decode_batch_device(pages[1], materialize=True, device="cpu",
                                 timings=timings)
    return res, timings


@pytest.mark.parametrize("i", range(len(COLUMNS)), ids=COLUMNS)
def test_unwrap_many_device_equals_content_and_reference(pages, unwrapped,
                                                         i):
    contents, frames = pages
    outs, lens, host = unwrapped
    assert outs == [] and len(lens) == 0 and sorted(host) == [0, 1, 2]
    got = host[i].numpy().tobytes()
    assert got == contents[i] == zstd_plain.decode_frame(frames[i])


@pytest.mark.parametrize("i", range(len(COLUMNS)), ids=COLUMNS)
def test_materialized_equals_content_and_reference(pages, materialized, i):
    contents, frames = pages
    (results, stats), _ = materialized
    assert stats == {"device_frames": 3, "host_frames": 0}
    assert results[i] == contents[i] == zstd_plain.decode_frame(frames[i])


def test_multiblock_counters_match_the_block_headers(pages, materialized):
    contents, frames = pages
    _, t = materialized
    blocks = [_blocks(f) for f in frames]
    assert t["n.mb_frames"] == 3
    assert t["n.mb_blocks"] == t["n.lanes"] == sum(map(len, blocks))
    assert 0 < t["n.host_seq_lanes"] <= t["n.mb_blocks"]
    # one group a content bucket: 1 MiB and 4 MiB, each as many rounds as
    # its longest frame has blocks
    groups = {}
    for c, b in zip(contents, blocks):
        key = len(c) <= 1 << 20
        groups[key] = max(groups.get(key, 0), len(b))
    assert t["n.mb_groups"] == len(groups) == 2
    assert t["n.mb_rounds"] == sum(groups.values()) == 17
    lit = sum(r for b in blocks for bt, _, r in b if bt == 2)
    assert t["n.mb_lit_bytes"] == lit
    assert 0 < t["n.mb_host_lit_bytes"] <= lit
    # no treeless section takes a device lane
    assert t["n.mb_treeless_host"] == sum(
        lt == 3 for b in blocks for _, lt, _ in b) > 0
    # the native block walk: its span inside the native planner's
    assert t["n.mb_native_frames"] == 3 and "plan.python" not in t
    assert 0 < t["plan.multiblock"] <= t["plan.native"] <= t["plan"]
    assert 0 < t["mb_exec.upload"] <= t["mb_exec"]


def test_comment_page_decodes_literals_on_the_host(pages):
    t = {}
    dp.plan_batch([pages[1][1]], timings=t)
    assert t["n.mb_host_lit_bytes"] > 0 and t["n.mb_treeless_host"] > 0
    assert t["n.mb_host_lit_bytes"] <= t["n.mb_lit_bytes"]
    assert "n.mb_frames" not in t  # the entry counts frames and rounds


def test_no_multiblock_keys_without_multiblock_frames():
    recs = [bytes(range(256)) * 16 + b"%d" % i for i in range(4)]
    t = {}
    outs, lens, host = dp.decode_batch_device(
        [compress(r, 3) for r in recs], device="cpu", timings=t)
    assert not host and list(lens) == [len(r) for r in recs]
    assert t["n.lanes"] == 4
    assert not set(MB_KEYS) & set(t) and "mb_exec" not in t
