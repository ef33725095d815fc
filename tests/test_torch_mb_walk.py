"""The native block walk of multi-block frames (``csrc/mb_plan.cpp``,
``device_pipeline._walk_multiblock``) held to the Python walk
(``_plan_multiblock``): the same plan -- pool bytes, Huffman and FSE
lanes, block rows, ``mb_frames``, host sequence rows, routes and the
planner's counters -- on Parquet pages of every TPC-H lineitem column,
on the engine's frames at levels 1, 3 and 19 (raw and RLE blocks, raw,
tree, treeless, 1-stream and wide-stream literal sections), on a frame
whose tree has tableLog 12, on corrupt frames (each routed with the Python
walk's reason, leaving nothing behind) and when the walk's buffers run
out; and its counters and spans.  Imports only the port and the
benchmark's payload."""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest

from benchmark.engine import Engine
from benchmark.payloads import tpch_lineitem_plain as lineitem
from zstdsharp_tpu_torch import constants as C
from zstdsharp_tpu_torch.decode import device_pipeline as dp
from zstdsharp_tpu_torch.decode.frame import parse_frame_header
from zstdsharp_tpu_torch.encode.block import _literals_header
from zstdsharp_tpu_torch.encode.frame import (_block_header,
                                              _write_frame_header, compress)
from zstdsharp_tpu_torch.entropy import huffman
from zstdsharp_tpu_torch.ops import device_huf as dh

sys.path.insert(0, str(Path(__file__).resolve().parent / "torch_data"))
from wide_frames import wide_sequence_frame  # noqa: E402

COLUMNS = tuple(dict.fromkeys(lineitem.PLAN))
PAGE = 300_000


@pytest.fixture(scope="module")
def pages():
    """The first page of each column of a row group, 300,000 bytes (3
    blocks), as the benchmark's configuration writes them (level 1, a
    window, no checksum)."""
    lengths = np.zeros(len(lineitem.PLAN), np.int64)
    first = [lineitem.PLAN.index(c) for c in COLUMNS]
    lengths[first] = PAGE
    group = lineitem.make(lengths, np.random.default_rng(2**31 + 24))
    eng = Engine()
    return [eng.frame(group[i], 1, False) for i in first]


def _content(seed=5) -> bytes:
    """870,000 bytes: random bytes (raw blocks and sections), a run of one
    byte (an RLE block), words (Huffman sections with trees and treeless
    ones), a 1 KB chunk repeated with a byte changed each time (small
    literal sections: 1 stream) and skewed letters with no matches (wide
    Huffman streams)."""
    r = np.random.default_rng(seed)
    parts = [r.integers(0, 256, 130_000, dtype=np.uint8).tobytes(),
             b"A" * 140_000]
    vocab = [bytes(r.integers(97, 123, int(r.integers(2, 9)),
                              dtype=np.uint8)) + b" " for _ in range(300)]
    parts.append(b"".join(vocab[int(i)]
                          for i in r.integers(0, 300, 60_000))[:260_000])
    chunk = bytearray(r.integers(0, 256, 1000, dtype=np.uint8).tobytes())
    rep = bytearray()
    for _ in range(200):
        chunk[int(r.integers(0, 1000))] = int(r.integers(0, 256))
        rep += chunk
    parts.append(bytes(rep))
    p = np.array([30, 20, 10, 10, 8, 7, 5, 4, 3, 3], np.float64)
    parts.append(bytes(r.choice(np.frombuffer(b"etaoinshrd", np.uint8),
                                140_000, p=p / p.sum())))
    return b"".join(parts)


@pytest.fixture(scope="module")
def engine_frames():
    content = _content()
    return content, {lv: compress(content, lv) for lv in (1, 3, 19)}


def _blocks(frame: bytes):
    """(start, block type, size, last) of each block."""
    p = parse_frame_header(np.frombuffer(frame, np.uint8)).header_size
    out = []
    while True:
        bh = int.from_bytes(frame[p:p + 3], "little")
        out.append((p, (bh >> 1) & 3, bh >> 3, bh & 1))
        p += 3 + (1 if (bh >> 1) & 3 == 1 else bh >> 3)
        if bh & 1:
            return out


def _kinds(frame: bytes) -> set:
    """The kinds of block and literal section a frame holds."""
    out = set()
    for p, bt, size, _ in _blocks(frame):
        if bt != 2:
            out.add(("raw_block", "rle_block")[bt])
            continue
        pay = frame[p + 3:p + 3 + size]
        lt, sf, regen, comp, lh = dp._parse_lit_header(pay)
        if lt < 2:
            out.add(("raw_lits", "rle_lits")[lt])
            continue
        out.add(("tree", "treeless")[lt - 2])
        body = pay[lh:lh + comp]
        whdr = huffman.read_weights(body)[2] if lt == 2 else 0
        st = body[whdr:]
        if sf == 0:
            out.add("1stream")
            continue
        s = [int.from_bytes(st[i:i + 2], "little") for i in (0, 2, 4)]
        if max(s + [len(st) - 6 - sum(s)]) > dh.MAX_W * 4:
            out.add("wide")
    return out


def _tlog12_frame():
    """A multi-block frame whose first block's Huffman tree has tableLog 12
    (the kernel peeks 11 bits, so its literals decode on the host), then a
    raw block.  Returns (frame, content)."""
    weights = np.array([1, 1] + list(range(2, 13)), np.uint8)
    ct = huffman.ctable_from_weights(weights, 12)
    p = 2.0 ** (weights.astype(np.float64) - 1)
    syms = np.random.default_rng(5).choice(
        np.arange(len(weights), dtype=np.uint8), size=1200, p=p / p.sum())
    assert huffman.read_weights(huffman.write_ctable(ct))[1] == 12
    body = huffman.write_ctable(ct) + huffman.encode_4x(syms, ct)
    block = _literals_header(C.LiteralsBlockType.COMPRESSED, 2, len(syms),
                             len(body)) + body + b"\x00"
    tail = bytes(range(200))
    content = syms.tobytes() + tail
    frame = (_write_frame_header(len(content), 10, False, True)
             + _block_header(False, C.BlockType.COMPRESSED, len(block))
             + block + _block_header(True, C.BlockType.RAW, len(tail)) + tail)
    return frame, content


# ---------------------------------------------------------------------------
# the comparison
# ---------------------------------------------------------------------------


def _python_walk(plan, run, frames, buf, offs, timings=None):
    """The Python walk alone: each multi-block frame through
    ``_plan_or_route``."""
    for fi, _ in run:
        dp._plan_or_route(plan, fi, frames[fi], timings=timings)


def _lanes(rows, n):
    """A lane buffer's first n rows, each lane's words cut at its length
    (the pooled rows past it are stale)."""
    prefix = "huf" if "huf_words" in rows else "fse"
    wlen = rows[f"{prefix}_wlen"][:n]
    out = {k: v[:n].copy() for k, v in rows.items()
           if k != f"{prefix}_words"}
    out["words"] = [rows[f"{prefix}_words"][i, :w].tobytes()
                    for i, w in enumerate(wlen)]
    return out


def _state(plan, timings) -> dict:
    nb = plan.nb
    return dict(
        pool=nb.pool_bytes(), huf=_lanes(nb._huf, nb.n_huf),
        fse=_lanes(nb._fse, nb.n_fse),
        blocks=[dataclasses.astuple(b) for b in plan.blocks],
        mb=[{**f, "blocks": [dataclasses.astuple(b) for b in f["blocks"]]}
            for f in plan.mb_frames],
        host_seqs=[tuple(np.asarray(a, np.uint32).tobytes() for a in r)
                   for r in plan.host_seqs],
        routed=dict(plan.host_routed), max_seq=plan.max_seq,
        max_out=plan.max_out,
        counters={k: v for k, v in timings.items() if k.startswith("n.")
                  and k not in ("n.mb_native_frames",
                                "n.mb_python_frames")})


def _plan(frames):
    t = {}
    plan = dp.plan_batch(frames, timings=t)
    try:
        return _state(plan, t), t
    finally:
        dp._release_ops(plan.nb, None)


def _assert_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if k in ("huf", "fse"):
            assert a[k].keys() == b[k].keys()
            for kk in a[k]:
                assert np.array_equal(a[k][kk], b[k][kk]), (k, kk)
        else:
            assert a[k] == b[k], k


def _both(frames, monkeypatch):
    """The plans of the native walk and of the Python walk, held equal;
    returns the native walk's state and timings."""
    got, t = _plan(frames)
    with monkeypatch.context() as m:
        m.setattr(dp, "_walk_multiblock", _python_walk)
        want, t_py = _plan(frames)
    _assert_equal(got, want)
    assert "n.mb_native_frames" not in t_py
    return got, t


# ---------------------------------------------------------------------------
# valid frames
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("col", COLUMNS)
def test_native_walk_equals_python_walk_on_a_page(pages, monkeypatch, col):
    frame = pages[COLUMNS.index(col)]
    got, t = _both([frame], monkeypatch)
    assert not got["routed"] and len(got["mb"]) == 1
    assert len(got["mb"][0]["blocks"]) == 3
    assert t["n.mb_native_frames"] == 1 and "plan.python" not in t


def test_native_walk_equals_python_walk_on_a_row_of_pages(pages,
                                                          monkeypatch):
    got, t = _both(pages, monkeypatch)
    assert [f["frame_idx"] for f in got["mb"]] == list(range(len(pages)))
    assert t["n.mb_native_frames"] == len(pages)
    assert len(got["huf"]["huf_pos"]) > 0 and got["host_seqs"]
    assert t["n.mb_treeless_host"] > 0


def test_engine_frames_hold_every_section_kind(engine_frames):
    _, frames = engine_frames
    kinds = set().union(*map(_kinds, frames.values()))
    assert kinds >= {"raw_block", "rle_block", "raw_lits", "tree",
                     "treeless", "1stream", "wide"}


@pytest.mark.parametrize("level", [1, 3, 19])
def test_native_walk_equals_python_walk_on_engine_frames(
        engine_frames, monkeypatch, level):
    content, frames = engine_frames
    got, t = _both([frames[level]], monkeypatch)
    assert not got["routed"] and t["n.mb_native_frames"] == 1
    assert got["mb"][0]["content"] == len(content)


def test_tablelog12_tree_decodes_on_the_host(monkeypatch):
    frame, content = _tlog12_frame()
    got, t = _both([frame], monkeypatch)
    assert not got["routed"] and not got["huf"]["huf_pos"].size
    assert t["n.mb_native_frames"] == 1
    assert t["n.mb_host_lit_bytes"] == t["n.mb_lit_bytes"] == 1200
    res, stats = dp.decode_batch_device([frame], True, device="cpu")
    assert res == [content] and stats["device_frames"] == 1


def test_mixed_batch_keeps_frame_order(engine_frames, pages, monkeypatch):
    """Single-block frames of the native planner and of the Python planner
    between multi-block ones: every lane and pool span in frame order."""
    content, frames = engine_frames
    wide = wide_sequence_frame()[1]
    small = compress(content[200_000:230_000], 3)
    batch = [small, frames[1], wide, pages[0], _tlog12_frame()[0], small,
             frames[19]]
    got, t = _both(batch, monkeypatch)
    assert [f["frame_idx"] for f in got["mb"]] == [1, 3, 4, 6]
    assert t["n.mb_native_frames"] == 4 and t["plan.python"] > 0


# ---------------------------------------------------------------------------
# corrupt frames
# ---------------------------------------------------------------------------


def _set_fcs(frame: bytes, content: int) -> bytes:
    """The frame with another content size (same field width)."""
    hdr = parse_frame_header(np.frombuffer(frame, np.uint8))
    fhd = frame[4]
    fs = (0, 2, 4, 8)[fhd >> 6]
    end = hdr.header_size
    return (frame[:end - fs] + (content - (256 if fs == 2 else 0))
            .to_bytes(fs, "little") + frame[end:])


def _many_sequences(frame: bytes) -> bytes:
    """The frame with its first block's sequence count raised past the
    top S bucket (32,768), the count written in 3 bytes."""
    p, bt, size, _ = _blocks(frame)[0]
    assert bt == 2
    pay = frame[p + 3:p + 3 + size]
    lt, sf, regen, comp, lh = dp._parse_lit_header(pay)
    lit_end = lh + (regen if lt == 0 else 1 if lt == 1 else comp)
    b0 = pay[lit_end]
    n = 1 if b0 < 128 else 2 if b0 < 255 else 3
    count = (40_000 - 0x7F00).to_bytes(2, "little")
    new = pay[:lit_end] + b"\xff" + count + pay[lit_end + n:]
    bh = int.from_bytes(frame[p:p + 3], "little") & 7 | len(new) << 3
    return (frame[:p] + bh.to_bytes(3, "little") + new
            + frame[p + 3 + size:])


def _corrupt(frame: bytes, kind: str) -> bytes:
    blocks = _blocks(frame)
    p1 = blocks[1][0]
    content = parse_frame_header(
        np.frombuffer(frame, np.uint8)).frame_content_size
    if kind == "truncated block header":
        return frame[:p1 + 2]
    if kind == "truncated block":
        return frame[:p1 + 3 + blocks[1][2] // 2]
    if kind == "reserved block type":
        bh = int.from_bytes(frame[p1:p1 + 3], "little") | 6
        return frame[:p1] + bh.to_bytes(3, "little") + frame[p1 + 3:]
    if kind == "content overflow":
        return _set_fcs(frame, content - 1000)
    if kind == "content size mismatch":
        return _set_fcs(frame, content + 1000)
    if kind == "missing checksum":
        return frame[:4] + bytes([frame[4] | 4]) + frame[5:]
    assert kind == "sequence count beyond device bucket"
    return _many_sequences(frame)


CORRUPT = {"truncated block header": "corrupt: truncated block header",
           "truncated block": "corrupt: truncated block",
           "reserved block type": "corrupt: reserved block type",
           "content overflow": "corrupt: content overflow",
           "content size mismatch": "corrupt: content size mismatch",
           "missing checksum": "corrupt: missing checksum",
           "sequence count beyond device bucket":
               "sequence count beyond device bucket"}


@pytest.mark.parametrize("kind", CORRUPT)
def test_corrupt_frame_routes_as_the_python_walk(pages, monkeypatch, kind):
    """A corrupt page between two good ones: the Python walk's route, and
    nothing of it in the pool, the lanes or the host rows."""
    bad = _corrupt(pages[1], kind)
    got, t = _both([pages[0], bad, pages[2]], monkeypatch)
    assert got["routed"] == {1: CORRUPT[kind]}
    assert t["n.mb_native_frames"] == 2 and "n.mb_python_frames" not in t
    clean, _ = _plan([pages[0], pages[2]])
    assert got["pool"] == clean["pool"]
    assert got["huf"]["words"] == clean["huf"]["words"]
    assert got["host_seqs"] == clean["host_seqs"]


# ---------------------------------------------------------------------------
# buffers that run out
# ---------------------------------------------------------------------------


def test_walk_grows_each_buffer_and_goes_on(pages, monkeypatch):
    """The pool, the Huffman lanes, the block rows and the sequence rows
    each run out in turn: the walk stops, the buffer grows and the walk
    goes on from that frame, to the Python walk's plan."""
    calls = []
    walk = dp._NativeOps.walk_multiblock

    def tight(self, buf, offs, idx, blk_cap, seq_cap):
        n = len(calls)
        c = self.ctx
        cap = (c.pool_cap, c.huf_cap)
        if n == 0:
            c.pool_cap = c.pool_off + 1000
        elif n == 1:
            c.huf_cap = c.n_huf + 5
        elif n == 3:  # the pooled rows: 1,000 left
            self._seqs = np.empty((3, self.seq_off + 1000), np.uint32)
        res = walk(self, buf, offs, idx, 4 if n == 2 else blk_cap,
                   min(seq_cap, 1000) if n == 3 else seq_cap)
        if n < 2:
            c.pool_cap, c.huf_cap = max(c.pool_cap, cap[0]), max(c.huf_cap,
                                                                  cap[1])
        calls.append((res[0], res[1].stop, res[1].room))
        return res

    monkeypatch.setattr(dp._NativeOps, "walk_multiblock", tight)
    frames = pages[:6]
    got, t = _both(frames, monkeypatch)
    rooms = [room for _, stop, room in calls if stop == dp._MB_ROOM]
    assert rooms[:4] == [dp._R_POOL, dp._R_HUF, dp._R_BLOCKS, dp._R_SEQS]
    assert sum(k for k, _, _ in calls) == len(frames)
    assert not got["routed"] and t["n.mb_native_frames"] == len(frames)


# ---------------------------------------------------------------------------
# counters and spans
# ---------------------------------------------------------------------------


def test_native_walk_counts_every_page_and_nests_its_spans(pages):
    t = {}
    res, stats = dp.decode_batch_device(pages[:4], True, device="cpu",
                                        timings=t)
    assert stats == {"device_frames": 4, "host_frames": 0}
    assert t["n.mb_native_frames"] == t["n.mb_frames"] == 4
    assert "n.mb_python_frames" not in t and "plan.python" not in t
    assert 0 < t["plan.host_seqs"] <= t["plan.multiblock"]
    assert t["plan.multiblock"] <= t["plan.native"] <= t["plan"]


def test_dictionary_batch_takes_the_python_walk():
    import zstandard

    from zstdsharp_tpu_torch.dictionary import parse_dictionary

    rng = np.random.default_rng(62)
    words = [b"alpha ", b"bravo ", b"charlie ", b"delta ", b"echo "]

    def rec(n):
        return b"".join(words[int(i)] for i in rng.integers(0, 5, n))

    d = zstandard.train_dictionary(8192, [rec(40) for _ in range(300)])
    recs = [rec(30_000) for _ in range(3)]
    frames = [zstandard.ZstdCompressor(level=3, dict_data=d).compress(r)
              for r in recs]
    t = {}
    res, stats = dp.decode_batch_device(
        frames, True, parse_dictionary(d.as_bytes()), device="cpu",
        timings=t)
    assert res == recs and stats["device_frames"] == 3
    assert t["n.mb_python_frames"] == t["n.mb_frames"] == 3
    assert t.get("n.mb_native_frames", 0) == 0
