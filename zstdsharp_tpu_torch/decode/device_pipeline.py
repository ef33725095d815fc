"""End-to-end frame decode on a torch device (counterpart of
zstdsharp_tpu/decode/device_pipeline.py).

``decode_batch_device(frames, device=device)`` decodes a batch of zstd
frames on `device`: Huffman literal sections through ``ops.device_huf``,
sequence sections through ``ops.device_fse`` (hand-written CUDA kernels on
a GPU, their plain torch versions on the CPU), then the literal assembly
and the LZ execution of every lane in one launch of
``ops.execseq.execute_lanes`` (``csrc/lz_exec.cu``) on a GPU, through its
plain version ``lanes_plain`` on the CPU.  Decoded rows stay on the
device.

Corrupt input.  Besides the rows, the executor flags each lane whose
sequences libzstd would reject (literal lengths past the literal section,
an output of another length than the frame's content size, an offset
reaching before the bytes the block may read: ``execseq.lane_flags``).
``decode_batch_device(materialize=True)`` -- and so
``parallel.pipeline.decompress_data_parallel`` -- raises
``corruption_detected`` for a flagged frame before it checks checksums,
so a frame libzstd rejects never comes back as bytes.  The device-resident
return (``materialize=False``) is not checked, as in the reference, which
assumes trusted input on its device path: a caller that needs the check
materializes.

The host half is the port's own copy of the reference's: the native
planner (``zt_dplane_*`` in native/zstdtpu_core.cpp, bound by the port's
``native``) packs lane-major operands into pooled numpy buffers
(``_NativeOps``), and the plan records (``_BlockPlan``, ``DevicePlan``),
the header probe ``scan_eligibility``, the shape buckets and the caps
mirror the reference's, but for the FSE kernel's word window
(``ops.device_fse.MAX_W``, 32 KiB where the reference's is 8 KiB), which
holds a 128 KB block's sequence bitstream.  The reference's JAX upload
fence is a ``torch.cuda.Event``.  The blocks of multi-block frames are
walked by the port's own C++ (``csrc/mb_plan.cpp``, ``_walk_multiblock``),
one call a batch, with the reference's Python walk (``_plan_multiblock``)
as its plain version.

Coverage is the reference's envelope: single-block frames up to 128 KB and
multi-block frames up to 4 MB (as dependent execution rounds) run on the
device; frames without a content size, corrupt frames and frames beyond
the caps are decoded by the host engine and reported in ``host_frames``.
With a parsed dictionary (``ddict``) every frame is planned in Python, as
in the reference (the native planner has no dictionary input), its lanes
packed into the same native buffers: the dictionary's content tail (up to
128 KB) is the executor's shared window row, right-aligned and broadcast
to every lane, and seeds each multi-block accumulator; its tables and
repcodes seed each frame's entropy, and treeless literal sections decode
with its Huffman weights.  Host-routed frames then decode against the
engine's ``NativeDDict``.  Unlike the reference, a missing native engine
raises instead of falling back to the list-based ``prepare_batch`` route.
"""

from __future__ import annotations

import ctypes
import threading
from dataclasses import dataclass, field
from itertools import chain
from operator import attrgetter

import numpy as np
import torch

from .. import native
from ..entropy import huffman
from ..errors import ZstdError, ZstdErrorCode
from ..ops import device_fse as df
from ..ops import device_huf as dh
from ..ops._launch import check_flag, resolve_device
from ..ops.execseq import LaneSources, execute_lanes
from ..utils import trace
from ..utils.xxhash import content_checksum
from .block import (EntropyState, decode_literals, decode_sequence_headers,
                    decode_sequences)
from .frame import decode_frame, decompress, parse_frame_header

# exec batching: lanes per exec call x output bucket
EXEC_LANES = 64
_O_BUCKETS = (1 << 12, 24576, 1 << 15, 1 << 17)
_S_BUCKETS = (256, 1024, 4096, 8192, 16384, 32768)
# multi-block envelope: total content / window the dependent-round
# executor supports (accumulator memory: F x (W + content))
MB_CONTENT_CAP = 1 << 22
MB_WINDOW_CAP = 1 << 22
_MBC_BUCKETS = (1 << 18, 1 << 20, 1 << 22)
_MBW_BUCKETS = (1 << 15, 1 << 17, 1 << 20, 1 << 22)


def _bucket(v, buckets):
    for x in buckets:
        if v <= x:
            return x
    raise ValueError(f"{v} exceeds device envelope {buckets[-1]}")


@dataclass
class _BlockPlan:
    frame_idx: int
    out_len: int
    lit_regen: int
    # stored xxh64 content checksum (low 32 bits), or -1 if absent
    checksum: int = -1
    # literals: kind 0 = raw pool span, 1 = Huffman device lanes
    lit_kind: int = 0
    pool_base: int = 0
    pool_len: int = 0
    huf_lane0: int = -1
    huf_seg: int = 0
    # sequences: kind 0 = none, 1 = device FSE lane, 2 = host arrays row
    seq_kind: int = 0
    fse_lane: int = -1
    host_row: int = -1
    n_seq: int = 0
    out_off: int = 0   # multi-block: output offset within the frame


@dataclass
class DevicePlan:
    """A batch's plan.  Every lane and the raw pool live in the native
    operand buffers ``nb`` (a ``_NativeOps``)."""

    nb: "_NativeOps"
    n_frames: int = 0
    blocks: list = field(default_factory=list)
    # (ll, ml, of) np arrays; the native block walk's are views of the
    # ctx's pooled rows (``_NativeOps.walk_multiblock``)
    host_seqs: list = field(default_factory=list)
    host_routed: dict = field(default_factory=dict)  # frame_idx -> reason
    max_out: int = 0
    max_seq: int = 0
    # the dictionary's content tail, shared by every lane as its window
    window: bytes = b""
    # multi-block frames: dicts {frame_idx, content, checksum, window,
    # blocks: [_BlockPlan with out_len / out_off per block]}
    mb_frames: list = field(default_factory=list)

    def pool_add(self, b) -> int:
        return self.nb.pool_add(bytes(b))

    def add_huf_lane(self, payload, weights, n_out) -> int:
        lane = self.nb.pack_huf(bytes(payload), weights, n_out)
        if lane < 0:
            raise ValueError("corrupt stream: zero last byte")
        return lane

    def add_fse_lane(self, payload, dts, nseq, rep) -> int:
        lane = self.nb.pack_fse(bytes(payload), dts, rep, nseq)
        if lane < 0:
            raise ValueError("corrupt stream: zero last byte")
        self.max_seq = max(self.max_seq, nseq)
        return lane


# Host-route reasons by native planner code (zt_dplane_batch).
_NATIVE_ROUTE = {
    1: "no content size",
    2: "dictionary required",
    3: "content/window beyond device caps",
    4: "corrupt: truncated block",
    5: "corrupt: block size",
    6: "corrupt: literal section bounds",
    7: "treeless literals, no dict table",
    8: "corrupt: reserved block type",
    9: "corrupt: huffman weights",
    10: "corrupt: sequence headers",
}


def _parse_lit_header(payload: bytes):
    """(lit_type, size_format, regen, comp, header_bytes)."""
    b0 = payload[0]
    lt, sf = b0 & 3, (b0 >> 2) & 3
    if lt in (0, 1):
        if sf in (0, 2):
            return lt, sf, b0 >> 3, 0, 1
        if sf == 1:
            v = int.from_bytes(payload[0:2], "little")
            return lt, sf, v >> 4, 0, 2
        v = int.from_bytes(payload[0:3], "little")
        return lt, sf, v >> 4, 0, 3
    if sf in (0, 1):
        v = int.from_bytes(payload[0:3], "little")
        return lt, sf, (v >> 4) & 0x3FF, (v >> 14) & 0x3FF, 3
    if sf == 2:
        v = int.from_bytes(payload[0:4], "little")
        return lt, sf, (v >> 4) & 0x3FFF, (v >> 18) & 0x3FFF, 4
    v = int.from_bytes(payload[0:5], "little")
    return lt, sf, (v >> 4) & 0x3FFFF, (v >> 22) & 0x3FFFF, 5


def scan_eligibility(frames, ddict=None,
                     single_block_only: bool = False) -> dict:
    """Cheap header-only partition probe: frame_idx -> host-route reason
    for frames outside the device envelope, without running ``plan_batch``
    (which host-decodes fallback sections).  Examines only the frame
    header, the first block header and the literal-section type byte, and
    mirrors the routing conditions of ``plan_batch``: with a dictionary
    (`ddict`), frames naming its ID pass, and treeless literals pass when
    it has entropy tables.  single_block_only also routes multi-block
    frames to the host."""
    routed = {}
    d_id = ddict.dict_id if ddict is not None else 0
    has_dict_huf = ddict is not None and ddict.entropy is not None
    for fi, frame in enumerate(frames):
        try:
            hdr = parse_frame_header(np.frombuffer(frame, np.uint8))
            if hdr.frame_content_size is None or hdr.frame_content_size < 0:
                routed[fi] = "no content size"
                continue
            if hdr.dict_id and hdr.dict_id != d_id:
                routed[fi] = "dictionary required"
                continue
            content = int(hdr.frame_content_size)
            if content > MB_CONTENT_CAP or (
                    content > (1 << 17)
                    and hdr.window_size > MB_WINDOW_CAP):
                routed[fi] = "content/window beyond device caps"
                continue
            if single_block_only and content > (1 << 17):
                routed[fi] = "multi-block (host preferred)"
                continue
            p = hdr.header_size
            bh = int.from_bytes(frame[p:p + 3], "little")
            last, btype, bsize = bh & 1, (bh >> 1) & 3, bh >> 3
            if not last:
                if single_block_only:
                    routed[fi] = "multi-block (host preferred)"
                continue  # multi-block: device-planned (dependent rounds)
            body_len = bsize if btype != 1 else 1
            tail = 4 if hdr.has_checksum else 0
            if p + 3 + body_len + tail > len(frame):
                routed[fi] = "corrupt: truncated block"
                continue
            if btype in (0, 1):
                if bsize != content:
                    routed[fi] = "corrupt: block size"
                continue
            payload = bytes(frame[p + 3:p + 3 + min(bsize, 5)])
            lt, sf, regen, comp, lh = _parse_lit_header(payload)
            if lt == 3 and not has_dict_huf:
                routed[fi] = "treeless literals, no dict table"
            elif regen > content or lh + (comp if lt >= 2 else 0) > bsize:
                routed[fi] = "corrupt: literal section bounds"
        except Exception as e:  # defensive routing, as in the reference
            routed[fi] = f"plan error: {e}"
    return routed


class _NativeOps:
    """Packed device operands, filled by the native planner (ZtDPlaneCtx).

    Buffers are numpy arrays in LANE-MAJOR layout (one contiguous row per
    lane) so the C planner packs with sequential memcpys; ``huf_ops`` /
    ``fse_ops`` slice lane windows for ops.device_huf.decode_lanemajor /
    ops.device_fse.decode_lanemajor.  ``fence`` is a ``torch.cuda.Event``
    recorded after the batch's uploads (None on the CPU): once it has
    completed, the buffers may be rewritten (pool recycling).  The native
    block walk's sequence rows (``walk_multiblock``) live in a pooled
    buffer too, rewritten once the ctx plans another batch."""

    LANES = 1024
    HUF_MAXW = dh.MAX_W
    FSE_MAXW = df.MAX_W
    S_CAP = _S_BUCKETS[-1]

    def __init__(self, lib, n_frames: int, total_in: int):
        self.lib = lib
        self.ctx = native.DPlaneCtx()
        self.fence = None
        huf_cap, fse_cap, pool_cap = self._needs(n_frames, total_in)
        self._alloc_huf(huf_cap)
        self._alloc_fse(fse_cap)
        self._alloc_pool(pool_cap)
        self.ctx.s_cap = self.S_CAP
        self.ctx.huf_maxw = self.HUF_MAXW
        self.ctx.fse_maxw = self.FSE_MAXW
        self._seqs = np.empty((3, 0), np.uint32)
        self.seq_off = 0

    def _needs(self, n_frames: int, total_in: int):
        """(Huffman lanes, FSE lanes, pool bytes) a batch may need."""
        return (-(-max(4 * n_frames, 4) // self.LANES) * self.LANES,
                -(-max(n_frames, 1) // self.LANES) * self.LANES,
                total_in + (1 << 17) + 64)

    def reset(self, n_frames: int, total_in: int):
        """Rearm a pooled ctx for a new batch.  Stale row contents are
        harmless (padding lanes are zeroed at ops-build time; table tails
        beyond 2^log are never state-selected; pool spans are fully
        overwritten), so no buffer is cleared: that saves the first-touch
        page faults of fresh buffers on every batch."""
        c = self.ctx
        for k in ("pool_off", "n_huf", "n_fse", "huf_wmax", "fse_wmax",
                  "max_seq", "max_out"):
            setattr(c, k, 0)
        self.fence = None
        self.seq_off = 0
        huf_need, fse_need, pool_need = self._needs(n_frames, total_in)
        if huf_need > c.huf_cap:
            self._alloc_huf(huf_need)
        if fse_need > c.fse_cap:
            self._alloc_fse(fse_need)
        if pool_need > c.pool_cap:
            self._alloc_pool(pool_need)

    # -- allocation and growth (the pointers live in the ctx struct) --

    @staticmethod
    def _i32p(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))

    def _alloc_rows(self, prefix: str, cap: int, shapes: dict, old):
        arrs = {k: np.zeros((cap, *s), np.int32) for k, s in shapes.items()}
        if old is not None:
            oc = old[f"{prefix}_words"].shape[0]
            for k, a in arrs.items():
                a[:oc] = old[k]
        setattr(self.ctx, f"{prefix}_cap", cap)
        setattr(self.ctx, f"{prefix}_words", arrs[f"{prefix}_words"].ctypes
                .data_as(ctypes.POINTER(ctypes.c_uint32)))
        for k, a in arrs.items():
            if k != f"{prefix}_words":
                setattr(self.ctx, k, self._i32p(a))
        return arrs

    def _alloc_huf(self, cap, old=None):
        self._huf = self._alloc_rows("huf", cap, dict(
            huf_words=(self.HUF_MAXW,), huf_limits=(16,), huf_bases=(16,),
            huf_offs=(16,), huf_shifts=(16,), huf_planes=(64,), huf_pos=(),
            huf_nsym=(), huf_wlen=()), old)

    def _alloc_fse(self, cap, old=None):
        # rows of MAX_W words, 32 MiB for 1,024 lanes: np.zeros maps them
        # lazily, so a batch pays only for the pages its lanes write; a
        # window uploads its widest lane's bucket (``fse_ops``), gathered
        # from the rows when that is narrower than they are (on a card into
        # pinned memory, ``ops_to_device``)
        self._fse = self._alloc_rows("fse", cap, dict(
            fse_words=(self.FSE_MAXW,), fse_ll=(df.NSTATES,),
            fse_of=(df.NSTATES_OF,), fse_ml=(df.NSTATES,), fse_logs=(3,),
            fse_pos=(), fse_rep=(3,), fse_nseq=(), fse_wlen=(),
            fse_st=(8,)), old)

    def _alloc_pool(self, cap, old=None):
        pool = np.zeros(cap, np.uint8)
        if old is not None:
            pool[:len(old)] = old
        self._pool = pool
        self.ctx.pool_cap = cap
        self.ctx.raw_pool = pool.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))

    def _ensure(self, pool_need=1 << 17, huf_need=4, fse_need=1):
        c = self.ctx
        if c.pool_off + pool_need + 8 > c.pool_cap:
            self._alloc_pool(max(c.pool_cap * 2, c.pool_off + pool_need + 64),
                             old=self._pool[:c.pool_off])
        if c.n_huf + huf_need > c.huf_cap:
            self._alloc_huf(-(-max(c.huf_cap * 2, c.n_huf + huf_need)
                              // self.LANES) * self.LANES, old=self._huf)
        if c.n_fse + fse_need > c.fse_cap:
            self._alloc_fse(-(-max(c.fse_cap * 2, c.n_fse + fse_need)
                              // self.LANES) * self.LANES, old=self._fse)

    # -- entry points --

    @staticmethod
    def _u8p(b: bytes):
        v = np.frombuffer(b, np.uint8)
        return v.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), v

    def plan_all(self, buf: np.ndarray, offs: np.ndarray):
        """Plan every frame of the batch `buf` (uint8, the frames joined;
        frame i spans [offs[i], offs[i + 1])) in one native call.  Returns
        (rcs [N] int32, metas [N, 12] int32)."""
        n = len(offs) - 1
        self._ensure(pool_need=len(buf), huf_need=4 * n, fse_need=n)
        metas = np.zeros((n, 12), np.int32)
        rcs = np.zeros(n, np.int32)
        self.lib.zt_dplane_batch(
            ctypes.byref(self.ctx),
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            n, self._i32p(metas), self._i32p(rcs))
        return rcs, metas

    def walk_multiblock(self, buf, offs, idx, blk_cap: int, seq_cap: int):
        """Walk the multi-block frames idx (int64, in order) of the batch
        `buf` in one call of ``csrc/mb_plan.cpp``'s ``zt_mb_plan``, into
        this ctx's pool and Huffman lanes, its sequences into at least
        seq_cap pooled rows past the batch's earlier ones.  Returns (frames
        planned, the ``native.MbOut``, frame rows, block rows, sequence
        rows [3, n]: ll, ml, of)."""
        frows = np.empty((len(idx), _MB_FCOLS), np.int64)
        brows = np.empty((blk_cap, _MB_BCOLS), np.int64)
        if self._seqs.shape[1] - self.seq_off < seq_cap:
            # rows the batch already holds keep the old buffer alive
            self._seqs = np.empty((3, max(seq_cap, 2 * self._seqs.shape[1])),
                                  np.uint32)
            self.seq_off = 0
        seqs = self._seqs[:, self.seq_off:]
        out = native.MbOut(
            maxlog=dh.MAXLOG, content_cap=MB_CONTENT_CAP,
            window_cap=MB_WINDOW_CAP, frames=frows.ctypes.data,
            blocks=brows.ctypes.data, ll=seqs[0].ctypes.data,
            ml=seqs[1].ctypes.data, of=seqs[2].ctypes.data,
            blk_cap=blk_cap, seq_cap=seqs.shape[1])
        k = native.get_mb_lib().zt_mb_plan(
            ctypes.byref(self.ctx), buf.ctypes.data, offs.ctypes.data,
            idx.ctypes.data, len(idx), ctypes.byref(out))
        self.seq_off += out.n_seqs
        return int(k), out, frows, brows, seqs

    def mark(self) -> tuple:
        """The counters a frame's planning moves (``restore`` takes them
        back)."""
        c = self.ctx
        return (c.pool_off, c.n_huf, c.n_fse, c.huf_wmax, c.fse_wmax,
                c.max_seq)

    def restore(self, mark: tuple) -> None:
        c = self.ctx
        (c.pool_off, c.n_huf, c.n_fse, c.huf_wmax, c.fse_wmax,
         c.max_seq) = mark

    def pack_huf(self, payload: bytes, weights, n_out: int) -> int:
        self._ensure(pool_need=0, huf_need=1, fse_need=0)
        w = np.ascontiguousarray(np.asarray(weights, np.uint8))
        total = int(((np.uint64(1) << w[w > 0].astype(np.uint64)).sum())
                    >> np.uint64(1))
        tlog = max(int(total).bit_length() - 1 if total else 1, 1)
        p, ref = self._u8p(payload)
        return int(self.lib.zt_dplane_pack_huf(
            ctypes.byref(self.ctx), p, len(ref),
            w.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(w), tlog,
            n_out))

    def pack_fse(self, payload: bytes, dts, rep, nseq: int) -> int:
        self._ensure(pool_need=0, huf_need=0, fse_need=1)
        ll_dt, of_dt, ml_dt = dts
        ll = np.ascontiguousarray(df.pack_table(ll_dt).astype(np.int32))
        of = np.ascontiguousarray(
            df.pack_table(of_dt)[:df.NSTATES_OF].astype(np.int32))
        ml = np.ascontiguousarray(df.pack_table(ml_dt).astype(np.int32))
        r3 = np.asarray(list(rep), np.int32)
        p, ref = self._u8p(payload)
        return int(self.lib.zt_dplane_pack_fse(
            ctypes.byref(self.ctx), p, len(ref),
            self._i32p(ll), self._i32p(of), self._i32p(ml),
            int(ll_dt.table_log), int(of_dt.table_log),
            int(ml_dt.table_log), self._i32p(r3), nseq))

    def pool_add(self, b: bytes) -> int:
        self._ensure(pool_need=len(b), huf_need=0, fse_need=0)
        base = int(self.ctx.pool_off)
        self._pool[base:base + len(b)] = np.frombuffer(b, np.uint8)
        self.ctx.pool_off = base + len(b)
        return base

    @property
    def n_huf(self):
        return int(self.ctx.n_huf)

    @property
    def n_fse(self):
        return int(self.ctx.n_fse)

    @property
    def n_fse_wide(self) -> int:
        """FSE lanes whose words pass the reference's window
        (``ops.device_fse.REF_MAX_W``)."""
        return int((self._fse["fse_wlen"][:self.n_fse] > df.REF_MAX_W).sum())

    def pool_bytes(self) -> bytes:
        return self._pool[:int(self.ctx.pool_off)].tobytes()

    def huf_ops(self, i: int) -> dict:
        """Lane-major numpy operand window [i, i+NL) for
        ops.device_huf.decode_lanemajor; NL rounds the window's real lane
        count up to a kernel width.  Padding lanes get pos = nsym = 0
        (pooled rows are stale), so they decode nothing."""
        a = self._huf
        n = min(self.n_huf - i, self.LANES)
        nl = dh.round_lanes(n)
        s = slice(i, i + nl)
        a["huf_pos"][i + n:i + nl] = 0
        a["huf_nsym"][i + n:i + nl] = 0
        wb = dh.bucket_w(int(a["huf_wlen"][i:i + n].max()))
        return dict(
            words=a["huf_words"][s, :wb], limits=a["huf_limits"][s],
            bases=a["huf_bases"][s], offs=a["huf_offs"][s],
            shifts=a["huf_shifts"][s], planes=a["huf_planes"][s],
            pos=a["huf_pos"][s], nsym=a["huf_nsym"][s],
            t_max=int(a["huf_nsym"][i:i + n].max()))

    def fse_ops(self, i: int) -> dict:
        """Lane-major numpy operand window for
        ops.device_fse.decode_lanemajor; padding lanes get st[:, 0] = 0
        and nseq = 0."""
        a = self._fse
        n = min(self.n_fse - i, self.LANES)
        nl = dh.round_lanes(n)
        s = slice(i, i + nl)
        a["fse_st"][i + n:i + nl, 0] = 0
        a["fse_nseq"][i + n:i + nl] = 0
        wb = df.bucket_w(int(a["fse_wlen"][i:i + n].max()))
        return dict(
            words=a["fse_words"][s, :wb], ll=a["fse_ll"][s],
            of=a["fse_of"][s], ml=a["fse_ml"][s], st=a["fse_st"][s],
            nseq=a["fse_nseq"][s], t_max=int(a["fse_nseq"][i:i + n].max()))


_CTX_POOL: list = []
_CTX_LOCK = threading.Lock()


def _native_ops_for(frames) -> _NativeOps:
    """A _NativeOps for this batch, recycled from the pool when one is
    free.  A pooled ctx is rearmed only after its fence (recorded after the
    previous batch's uploads from its buffers) has completed.  Raises
    when the native engine can be neither loaded nor built."""
    lib = native.get_lib()
    total = sum(len(f) for f in frames)
    with _CTX_LOCK:
        nb = _CTX_POOL.pop() if _CTX_POOL else None
    if nb is None:
        return _NativeOps(lib, len(frames), total)
    if nb.fence is not None:
        nb.fence.synchronize()
    nb.reset(len(frames), total)
    return nb


def _release_ops(nb, fence) -> None:
    """Return a ctx to the pool; `fence` (a torch.cuda.Event or None)
    completes once every upload from its buffers has."""
    nb.fence = fence
    with _CTX_LOCK:
        if len(_CTX_POOL) < 4:
            _CTX_POOL.append(nb)


def _start_entropy(ddict) -> EntropyState:
    """A frame's starting entropy: a fresh copy of the dictionary's tables
    and repcodes, or the format's initial state without one."""
    if ddict is None or ddict.entropy is None:
        return EntropyState()
    de = ddict.entropy
    return EntropyState(huf=de.huf, ll=de.ll, ml=de.ml, of=de.of,
                        rep=list(de.rep))


def _plan_multiblock(plan, fi, frame, hdr, ddict=None, timings=None):
    """Walk every block of a multi-block frame (reference
    _plan_multiblock): literal sections become device lanes or pool spans,
    sequence sections are host-decoded so the repcode and repeat-table
    chains resolve at plan time, starting from the dictionary's entropy
    when there is one, and each block records its output offset for the
    dependent-round executor.  Returns an error string to host-route, or
    None on success.  The Python walk: it plans the frames of a dictionary
    batch and those the native walk (``_walk_multiblock``) refuses, whose
    plan it is the plain version of.

    A planned frame adds to the counters (``utils.trace.count``)
    "n.mb_lit_bytes" (its compressed blocks' regenerated literal bytes),
    "n.mb_host_lit_bytes" (those of Huffman sections decoded here on the
    host, whatever the reason), "n.mb_treeless_host" (its treeless
    sections decoded here) and "n.mb_python_frames" (1); a host-routed
    frame adds nothing."""
    content = int(hdr.frame_content_size)
    ent = _start_entropy(ddict)
    blocks = []
    lit_bytes = host_lit_bytes = treeless_host = 0
    p = hdr.header_size
    out_off = 0
    while True:
        if p + 3 > len(frame):
            return "corrupt: truncated block header"
        bh = int.from_bytes(frame[p:p + 3], "little")
        last, btype, bsize = bh & 1, (bh >> 1) & 3, bh >> 3
        p += 3
        body_len = bsize if btype != 1 else 1
        if p + body_len > len(frame):
            return "corrupt: truncated block"
        b = _BlockPlan(frame_idx=fi, out_len=0, lit_regen=0)
        b.out_off = out_off
        if btype == 0:
            b.pool_base = plan.pool_add(frame[p:p + bsize])
            b.pool_len = bsize
            b.lit_regen = bsize
            b.out_len = bsize
        elif btype == 1:
            b.pool_base = plan.pool_add(frame[p:p + 1])
            b.pool_len = 1
            b.lit_regen = bsize
            b.out_len = bsize
        elif btype == 2:
            payload = bytes(frame[p:p + bsize])
            lt, sf, regen, comp, lh = _parse_lit_header(payload)
            if lh + (comp if lt >= 2 else 0) > len(payload):
                return "corrupt: literal section bounds"
            b.lit_regen = regen
            lit_bytes += regen
            if lt == 0:
                b.pool_base = plan.pool_add(payload[lh:lh + regen])
                b.pool_len = regen
                lit_end = lh + regen
            elif lt == 1:
                b.pool_base = plan.pool_add(payload[lh:lh + 1])
                b.pool_len = 1
                lit_end = lh + 1
            else:
                body = payload[lh:lh + comp]
                if lt == 2:
                    weights, tlog, whdr = huffman.read_weights(body)
                    ent.huf = huffman.build_dtable(weights, tlog)
                    # the kernel peeks MAXLOG=11 bits: a (valid)
                    # tableLog-12 tree host-decodes
                    if tlog > dh.MAXLOG:
                        weights = None
                elif ent.huf is not None:
                    weights, whdr = None, 0
                else:
                    return "treeless literals, no table"
                if not _add_huf_lanes(plan, b, weights, sf,
                                      body[whdr:], regen):
                    lits, _ = decode_literals(payload, ent)
                    b.pool_base = plan.pool_add(lits.tobytes())
                    b.pool_len = regen
                    host_lit_bytes += regen
                    treeless_host += lt == 3
                lit_end = lh + comp
            # sequence section: host decode (chains ent + reps)
            rest = payload[lit_end:]
            nbseq, ll_dt, of_dt, ml_dt, consumed = \
                decode_sequence_headers(rest, ent)
            b.n_seq = nbseq
            if nbseq > 0:
                if nbseq > _S_BUCKETS[-1]:
                    return "sequence count beyond device bucket"
                with trace.stage("plan.host_seqs", timings, plane="decode"):
                    lls, mls, ofs = decode_sequences(
                        rest[consumed:], nbseq, ll_dt, of_dt, ml_dt, ent.rep)
                b.seq_kind = 2
                b.host_row = len(plan.host_seqs)
                plan.host_seqs.append((lls, mls, ofs))
                plan.max_seq = max(plan.max_seq, nbseq)
                b.out_len = int(np.sum(mls)) + b.lit_regen
            else:
                b.out_len = b.lit_regen
        else:
            return "corrupt: reserved block type"
        out_off += b.out_len
        if out_off > content:
            return "corrupt: content overflow"
        blocks.append(b)
        p += body_len
        if last:
            break
    if out_off != content:
        return "corrupt: content size mismatch"
    cks = -1
    if hdr.has_checksum:
        if p + 4 > len(frame):
            return "corrupt: missing checksum"
        cks = int.from_bytes(frame[p:p + 4], "little")
    if plan.window:
        # libzstd lets a block reach the whole dictionary and all the
        # frame's output before it, whatever the frame's window (a
        # single-segment frame declares only its content); the
        # reference's window of the frame's size loses the dictionary's
        # head (ROADMAP Queue 3)
        wsize = content + len(plan.window)
        if wsize > MB_WINDOW_CAP:
            return "content/window beyond device caps"
    else:
        wsize = min(int(hdr.window_size or content), MB_WINDOW_CAP)
    plan.mb_frames.append({"frame_idx": fi, "content": content,
                           "checksum": cks, "window": wsize,
                           "blocks": blocks})
    trace.count("mb_lit_bytes", lit_bytes, timings)
    trace.count("mb_host_lit_bytes", host_lit_bytes, timings)
    trace.count("mb_treeless_host", treeless_host, timings)
    trace.count("mb_python_frames", 1, timings)
    return None


# csrc/mb_plan.cpp: a call's stop reasons, the buffers an MB_ROOM stop
# names, and the widths of its frame and block rows
_MB_REFUSED, _MB_ROOM = 1, 2
_R_POOL, _R_HUF, _R_BLOCKS, _R_SEQS = 1, 2, 4, 8
_MB_FCOLS, _MB_BCOLS = 8, 11


def _multiblock_content(frame):
    """The content size of a frame the native planner handed on (``rc <
    0``: it has read the frame header and the first block header) whose
    first block is not its last; None for a single-block frame."""
    fhd = int(frame[4])
    single = (fhd >> 5) & 1
    p = 6 - single + (0, 1, 2, 4)[fhd & 3]
    fs = (single, 2, 4, 8)[fhd >> 6]
    if int(frame[p + fs]) & 1:
        return None
    return (int.from_bytes(bytes(frame[p:p + fs]), "little")
            + (256 if fs == 2 else 0))


def _walk_multiblock(plan, run, frames, buf, offs, timings=None) -> None:
    """Plan the multi-block frames `run` ([(frame_idx, content size)], in
    frame order) of a batch without a dictionary by the native walk
    (``csrc/mb_plan.cpp``): one call walks every block of every frame, with
    the rules of the Python walk ``_plan_multiblock``, and fills the same
    plan.  A frame it refuses is planned in place by the Python walk, which
    gives its route, so the pool and the lanes keep frame order; where a
    buffer runs out, it is grown and the walk called again from that
    frame.

    timings: "plan.multiblock" inside "plan.native" (each call and the
    rows it gives), "plan.host_seqs" (its sequence decodes, timed by the
    call's own clock), the Python walk's counters summed over the frames
    it planned, and "n.mb_native_frames" (those frames)."""
    nb = plan.nb
    idx = np.array([fi for fi, _ in run], np.int64)
    content = sum(c for _, c in run)
    blocks = sum(c >> 16 for _, c in run) + 2 * len(run) + 16
    blk_cap, seq_cap = blocks, content // 8 + 2 * nb.S_CAP
    nb._ensure(pool_need=int(offs[idx + 1].sum() - offs[idx].sum())
               + content // 8, huf_need=4 * blocks, fse_need=0)
    i = 0
    while i < len(idx):
        with trace.stage("plan.native", timings, plane="decode"):
            with trace.stage("plan.multiblock", timings, plane="decode"):
                k, out, frows, brows, seqs = nb.walk_multiblock(
                    buf, offs, idx[i:], blk_cap, seq_cap)
                _take_native_rows(plan, idx[i:i + k], frows, brows, seqs,
                                  timings)
        trace.add("plan.host_seqs", out.seq_ns * 1e-9, timings)
        i += k
        if out.stop == _MB_REFUSED:
            fi = int(idx[i])
            _plan_or_route(plan, fi, frames[fi], timings=timings)
            i += 1
        elif out.stop == _MB_ROOM:
            if out.room & _R_POOL:
                nb._ensure(pool_need=out.want_pool + (1 << 21), huf_need=0,
                           fse_need=0)
            if out.room & _R_HUF:
                nb._ensure(pool_need=0, huf_need=out.want_huf + 4,
                           fse_need=0)
            if out.room & _R_BLOCKS:
                blk_cap = max(2 * blk_cap, 2 * out.want_blocks + 2)
            if out.room & _R_SEQS:
                seq_cap = max(2 * seq_cap, out.want_seqs + nb.S_CAP)


def _take_native_rows(plan, idx, frows, brows, seqs, timings) -> None:
    """The plan of the frames idx that one native walk planned: their
    ``mb_frames`` entries with a ``_BlockPlan`` a block, and their host
    sequence rows (views of `seqs`)."""
    k = len(idx)
    if not k:
        return
    fr = frows[:k].tolist()
    br = brows[:fr[-1][0] + fr[-1][1]].tolist()
    ll, ml, of = seqs
    host = plan.host_seqs
    sums = [0, 0, 0]
    for fi, (b0, nblk, content, cks, window, *counts) in zip(idx.tolist(),
                                                             fr):
        blocks = []
        for (out_len, out_off, regen, lit_kind, pool_base, pool_len, lane0,
             seg, seq_kind, n_seq, s0) in br[b0:b0 + nblk]:
            b = _BlockPlan(frame_idx=fi, out_len=out_len, lit_regen=regen,
                           lit_kind=lit_kind, pool_base=pool_base,
                           pool_len=pool_len, huf_lane0=lane0, huf_seg=seg,
                           seq_kind=seq_kind, n_seq=n_seq, out_off=out_off)
            if seq_kind == 2:
                b.host_row = len(host)
                host.append((ll[s0:s0 + n_seq], ml[s0:s0 + n_seq],
                             of[s0:s0 + n_seq]))
                plan.max_seq = max(plan.max_seq, n_seq)
            blocks.append(b)
        plan.mb_frames.append({"frame_idx": fi, "content": content,
                               "checksum": cks, "window": window,
                               "blocks": blocks})
        sums = [a + c for a, c in zip(sums, counts)]
    for name, v in zip(("mb_lit_bytes", "mb_host_lit_bytes",
                        "mb_treeless_host"), sums):
        trace.count(name, v, timings)
    trace.count("mb_native_frames", k, timings)


def _add_huf_lanes(plan, b, weights, sf, streams, regen) -> bool:
    """Pack a Huffman literal section as device lanes when it fits the
    kernel (4 streams, or 1 stream of <= 4096 symbols); False leaves it to
    a host decode into the pool."""
    if weights is None:
        return False
    if sf != 0 and len(streams) >= 10:
        s1 = int.from_bytes(streams[0:2], "little")
        s2 = int.from_bytes(streams[2:4], "little")
        s3 = int.from_bytes(streams[4:6], "little")
        sizes = [s1, s2, s3, len(streams) - 6 - s1 - s2 - s3]
        seg = (regen + 3) // 4
        outs = [seg, seg, seg, regen - 3 * seg]
        if min(sizes) <= 0 or min(outs) <= 0 or max(sizes) > dh.MAX_W * 4:
            return False
        b.lit_kind = 1
        b.huf_seg = seg
        off = 6
        for si in range(4):
            lane = plan.add_huf_lane(streams[off:off + sizes[si]], weights,
                                     outs[si])
            if si == 0:
                b.huf_lane0 = lane
            off += sizes[si]
        return True
    if sf == 0 and 0 < len(streams) <= dh.MAX_W * 4 and 0 < regen <= 4096:
        # single-stream section: one kernel lane; huf_seg = regen makes
        # the 4-way stitch read quarter 0 only
        b.lit_kind = 1
        b.huf_seg = regen
        b.huf_lane0 = plan.add_huf_lane(streams, weights, regen)
        return True
    return False


def plan_batch(frames, ddict=None, timings=None) -> DevicePlan:
    """Host header pass: split each frame into device work or a host route
    (reference plan_batch).  Without a dictionary the native planner plans
    single-block frames in one call, and the native block walk
    (``_walk_multiblock``) the multi-block frames it hands on, one call for
    each run of them; the other frames outside its scope take the Python
    planner (``_plan_python``), whose lanes pack into the same native
    buffers.

    ddict: a parsed dictionary (``dictionary.ParsedDict``).  The native
    planner has no dictionary input, so, as in the reference, every frame
    takes the Python planner: ``plan.window`` is the last 128 KB of the
    dictionary's content, its tables and repcodes seed each frame's
    entropy and treeless literal sections take its Huffman weights.  A
    dictionary over 128 KB sends every frame to the host.

    timings: the stage sink (``utils.trace``): "plan.native" (the native
    planner's calls, the block walk's with their rows included),
    "plan.python" (each frame the Python planner takes), "plan.multiblock"
    (the block walks: the native walk's inside "plan.native", a frame of
    the Python walk inside "plan.python") and "plan.host_seqs" (the host
    sequence decodes); the multi-block frames' counters "n.mb_lit_bytes",
    "n.mb_host_lit_bytes", "n.mb_treeless_host" (``_plan_multiblock``),
    "n.mb_native_frames" and "n.mb_python_frames" (the frames each walk
    planned)."""
    plan = DevicePlan(nb=_native_ops_for(frames), n_frames=len(frames))
    if ddict is not None:
        plan.window = np.asarray(ddict.content)[-(1 << 17):].tobytes()
        d_huf = None
        if ddict.entropy is not None and len(ddict.raw) >= 8:
            d_huf = huffman.read_weights(ddict.raw[8:])[:2]
        for fi, frame in enumerate(frames):
            _plan_or_route(plan, fi, frame, ddict, d_huf, timings)
        return plan
    n = len(frames)
    buf = np.frombuffer(b"".join(map(bytes, frames)), np.uint8)
    offs = np.zeros(n + 1, np.int64)
    np.cumsum(np.fromiter(map(len, frames), np.int64, n), out=offs[1:])
    with trace.stage("plan.native", timings, plane="decode"):
        rcs, metas = plan.nb.plan_all(buf, offs)
    run = []  # multi-block frames for the native walk, in frame order
    for fi, frame in enumerate(frames):
        rc, m = int(rcs[fi]), metas[fi]
        if rc == 0:
            # meta[7] carries the has-checksum flag
            raw_cks = int(m[11])
            plan.blocks.append(_BlockPlan(
                frame_idx=fi, out_len=int(m[10]), lit_regen=int(m[9]),
                checksum=(raw_cks & 0xFFFFFFFF) if int(m[7]) else -1,
                lit_kind=int(m[0]), pool_base=int(m[1]),
                pool_len=int(m[2]), huf_lane0=int(m[3]),
                huf_seg=int(m[4]), seq_kind=int(m[5]),
                fse_lane=int(m[6]), host_row=-1, n_seq=int(m[8])))
            plan.max_out = max(plan.max_out, int(m[10]))
            if int(m[5]) == 1:
                plan.max_seq = max(plan.max_seq, int(m[8]))
            continue
        if rc > 0:
            plan.host_routed[fi] = _NATIVE_ROUTE.get(rc, f"native route {rc}")
            continue
        # rc < 0: outside the native planner's scope
        content = _multiblock_content(frame)
        if content is not None:
            run.append((fi, content))
            continue
        if run:
            _walk_multiblock(plan, run, frames, buf, offs, timings)
            run = []
        _plan_or_route(plan, fi, frame, timings=timings)
    if run:
        _walk_multiblock(plan, run, frames, buf, offs, timings)
    return plan


def _plan_or_route(plan, fi, frame, ddict=None, d_huf=None,
                   timings=None) -> None:
    """Plan one frame in Python, or route it to the host with the reason;
    a routed frame leaves no pool bytes, lanes or host rows behind."""
    mark = plan.nb.mark(), len(plan.host_seqs), plan.max_seq
    with trace.stage("plan.python", timings, plane="decode"):
        try:
            err = _plan_python(plan, fi, frame, ddict, d_huf, timings)
        except Exception as e:  # defensive routing, as in the reference
            err = f"plan error: {e}"
    if err:
        plan.host_routed[fi] = err
        plan.nb.restore(mark[0])
        del plan.host_seqs[mark[1]:]
        plan.max_seq = mark[2]


def _plan_python(plan, fi, frame, ddict=None, d_huf=None, timings=None):
    """Plan one frame in Python: a frame of a dictionary batch, a
    multi-block frame, or a single-block frame outside the native
    planner's envelope.  A sequence section takes an FSE kernel lane when
    its bitstream fits the kernel's window (``ops.device_fse.MAX_W``
    words, 32 KiB: every 128 KB block's at usual ratios), its OF table
    log is 8 or less and it has at most the top S bucket's sequences;
    else it is decoded here on the host ("plan.host_seqs").  A Huffman
    stream over ``ops.device_huf.MAX_W`` words (8 KiB) is decoded here
    into the pool.  `d_huf` is the dictionary's Huffman (weights,
    tableLog) for treeless sections.  Returns a host-route reason or
    None."""
    hdr = parse_frame_header(np.frombuffer(frame, np.uint8))
    if hdr.frame_content_size is None or hdr.frame_content_size < 0:
        return "no content size"
    if hdr.dict_id and hdr.dict_id != (ddict.dict_id if ddict is not None
                                       else 0):
        return "dictionary required"
    if ddict is not None and len(ddict.content) > (1 << 17):
        return "dict > 128KB window envelope"
    content = int(hdr.frame_content_size)
    if content > MB_CONTENT_CAP or (
            content > (1 << 17) and hdr.window_size > MB_WINDOW_CAP):
        return "content/window beyond device caps"
    p = hdr.header_size
    bh = int.from_bytes(frame[p:p + 3], "little")
    last, btype, bsize = bh & 1, (bh >> 1) & 3, bh >> 3
    if not last:
        with trace.stage("plan.multiblock", timings, plane="decode"):
            return _plan_multiblock(plan, fi, frame, hdr, ddict, timings)
    body_len = bsize if btype != 1 else 1
    tail = 4 if hdr.has_checksum else 0
    if p + 3 + body_len + tail > len(frame):
        return "corrupt: truncated block"
    b = _BlockPlan(frame_idx=fi, out_len=content, lit_regen=0)
    if hdr.has_checksum:
        b.checksum = int.from_bytes(
            frame[p + 3 + body_len:p + 3 + body_len + 4], "little")
    if btype in (0, 1):  # raw / RLE block
        if bsize != content:
            return f"corrupt: {('raw', 'RLE')[btype]} block size"
        b.pool_base = plan.pool_add(frame[p + 3:p + 3 + (bsize, 1)[btype]])
        b.pool_len = (bsize, 1)[btype]
        b.lit_regen = content
        plan.blocks.append(b)
        plan.max_out = max(plan.max_out, content)
        return None
    payload = bytes(frame[p + 3:p + 3 + bsize])
    lt, sf, regen, comp, lh = _parse_lit_header(payload)
    if regen > content or lh + (comp if lt >= 2 else 0) > len(payload):
        return "corrupt: literal section bounds"
    b.lit_regen = regen
    ent = _start_entropy(ddict)
    if lt == 0:
        b.pool_base = plan.pool_add(payload[lh:lh + regen])
        b.pool_len = regen
        lit_end = lh + regen
    elif lt == 1:
        b.pool_base = plan.pool_add(payload[lh:lh + 1])
        b.pool_len = 1
        lit_end = lh + 1
    else:
        body = payload[lh:lh + comp]
        if lt == 2:
            weights, tlog, whdr = huffman.read_weights(body)
        elif d_huf is not None:
            (weights, tlog), whdr = d_huf, 0
        else:
            return "treeless literals, no dict table"
        # the kernel peeks MAXLOG=11 bits: a (valid) tableLog-12 tree,
        # the frame's or the dictionary's, host-decodes
        if tlog > dh.MAXLOG:
            return "huffman tableLog beyond device"
        if not _add_huf_lanes(plan, b, weights, sf, body[whdr:], regen):
            lits, _ = decode_literals(payload, ent)
            b.pool_base = plan.pool_add(lits.tobytes())
            b.pool_len = regen
        lit_end = lh + comp
    rest = payload[lit_end:]
    nbseq, ll_dt, of_dt, ml_dt, consumed = decode_sequence_headers(rest, ent)
    b.n_seq = nbseq
    if nbseq > 0:
        seq_payload = rest[consumed:]
        if (len(seq_payload) <= df.MAX_W * 4 and of_dt.table_log <= 8
                and nbseq <= _S_BUCKETS[-1]):
            b.seq_kind = 1
            b.fse_lane = plan.add_fse_lane(
                seq_payload, (ll_dt, of_dt, ml_dt), nbseq, ent.rep)
        else:
            with trace.stage("plan.host_seqs", timings, plane="decode"):
                lls, mls, ofs = decode_sequences(
                    seq_payload, nbseq, ll_dt, of_dt, ml_dt, list(ent.rep))
            b.seq_kind = 2
            b.host_row = len(plan.host_seqs)
            plan.host_seqs.append((lls, mls, ofs))
        plan.max_seq = max(plan.max_seq, nbseq)
    plan.blocks.append(b)
    plan.max_out = max(plan.max_out, content)
    return None


def ops_to_device(ops: dict, device) -> dict:
    """Copy a numpy operand window (``_NativeOps.huf_ops``/``fse_ops``) to
    int32 tensors on `device`.  The copy never aliases the pooled numpy
    buffers, so they may be rewritten as soon as it returns.  A contiguous
    operand is copied as it is.  On a card a strided one (a window's words
    when their bucket is narrower than the pooled rows) is gathered into
    pinned host memory and copied without a wait, since a pageable copy
    would gather it into a fresh array first: torch's pinned-memory cache
    hands that block out again only once the copy has completed."""
    pinned = torch.device(device).type == "cuda"
    out = {}
    for k, v in ops.items():
        if k == "t_max":
            out[k] = v
        elif v.flags.c_contiguous or not pinned:
            out[k] = torch.from_numpy(np.ascontiguousarray(v, np.int32)).to(
                device, copy=True)
        else:
            stage = torch.empty(v.shape, dtype=torch.int32, pin_memory=True)
            np.copyto(stage.numpy(), v, casting="unsafe")
            out[k] = stage.to(device, non_blocking=True)
    return out


def _fused_decode(meta, src, S, O, window, **at):
    """Decode lanes (meta int64 [N, 12], sources ``execseq.LaneSources``;
    `at`: ``execute_lanes``' window and output starts) through
    ``execute_lanes``: one launch over every lane on a card, its plain
    version ``lanes_plain`` on the CPU.  Returns (rows or the updated
    output, the lanes' flags int32 [N])."""
    return execute_lanes(meta, src, S, O, window, **at)


# the executor's flag bits (ops.execseq.lane_flags), as the error says them
_FLAG_REASONS = ((0, "literal lengths overrun the literal section"),
                 (1, "sequences do not fill the block's content size"),
                 (2, "an offset reaches before the decoded output"))


_META_FIELDS = attrgetter("lit_kind", "pool_base", "pool_len", "huf_lane0",
                          "huf_seg", "seq_kind", "fse_lane", "host_row",
                          "n_seq", "lit_regen", "out_len")


def _meta_array(blocks, win_len, rows: int | None = None) -> np.ndarray:
    """The lanes' meta rows, int64 [rows (default len(blocks)), 12]: each
    block's fields, then `win_len` (a scalar or one a block), the real
    bytes before its first output byte that a match may reach (the flags'
    offset limit); rows past the blocks are zero (padding lanes: a zero
    row, zero flags)."""
    n = len(blocks)
    meta = np.zeros((n if rows is None else rows, 12), np.int64)
    if n:
        meta[:n, :11] = np.fromiter(
            chain.from_iterable(map(_META_FIELDS, blocks)), np.int64,
            11 * n).reshape(n, 11)
        meta[:n, 11] = win_len
    return meta


def _mb_groups(mb_frames, max_group: int = 16):
    """Group multi-block frames so each dependent-round batch shares one
    window / content bucket and bounded memory."""
    by_key: dict = {}
    for f in mb_frames:
        key = (_bucket(f["window"], _MBW_BUCKETS),
               _bucket(f["content"], _MBC_BUCKETS))
        by_key.setdefault(key, []).append(f)
    return [fs[i:i + max_group] for fs in by_key.values()
            for i in range(0, len(fs), max_group)]


def _host_decode(frames, routed, ddict) -> dict:
    """frame_idx -> bytes of each host-routed frame: ``decompress``
    without a dictionary; with one, ``decode_frame`` against the engine's
    dictionary (the reference runs its Python FrameDecoder with the
    dictionary's content, tables and ID), so a frame naming another
    dictionary raises dictionary_wrong."""
    if ddict is None:
        return {fi: decompress(bytes(frames[fi])) for fi in routed}
    if not routed:
        return {}
    with ddict.native() as dd:
        return {fi: decode_frame(bytes(frames[fi]), dd)[0].tobytes()
                for fi in routed}


def _window_rows(tail: bytes, B: int, device) -> torch.Tensor:
    """The executor's [B, W] window: the dictionary's content tail
    right-aligned in the smallest of 4 KB, 32 KB and 128 KB that holds it,
    one row broadcast to all B lanes; 8 zero bytes without a dictionary."""
    if not tail:
        return torch.zeros(1, 8, dtype=torch.uint8,
                           device=device).expand(B, 8)
    W = next(w for w in (1 << 12, 1 << 15, 1 << 17) if len(tail) <= w)
    row = torch.zeros(W, dtype=torch.uint8)
    row[W - len(tail):] = torch.frombuffer(bytearray(tail), dtype=torch.uint8)
    return row.to(device).expand(B, W)


def decode_batch_device(frames, materialize: bool = False, ddict=None, *,
                        device="cuda", timings: dict | None = None):
    """Decode a batch of frames on `device` (a torch device or its name;
    the card unless the caller names another, and without a card the
    default raises).  The positional parameters are the reference's, in
    its order; `device` and `timings` are keywords only, and a device
    passed in `materialize`'s place raises TypeError.

    Returns (outputs, lengths, host_results): outputs is a list of
    per-exec-chunk uint8 tensors [EXEC_LANES, O] on `device` whose rows map
    to the device-planned single-block frames in frame order, lengths the
    per-row content size (numpy int64), and host_results maps frame_idx to
    bytes for host-routed frames and to a uint8 device tensor [content] for
    multi-block frames.  These rows are not checked: a corrupt frame the
    planner took decodes to wrong bytes, as in the reference.  With
    materialize=True, returns (results, stats): every frame's bytes in
    order, after every device-decoded frame is checked -- a frame the
    executor flagged raises corruption_detected, then a stored xxh64
    checksum that differs raises checksum_wrong -- and stats counting
    device and host frames.

    ddict: a parsed dictionary (``dictionary.ParsedDict``) every frame
    decodes against (``plan_batch``).

    timings: when a dict is given, each stage's wall seconds are added
    under its key, the device synchronised at the stage's end: "plan" (the
    planner, ``plan_batch``; inside it "plan.native", "plan.python" and
    "plan.multiblock" and "plan.host_seqs"), "host" (host-routed frames),
    "huf" and "fse" (the entropy kernels; inside each, "huf.upload" /
    "fse.upload", their operands' copies), "exec" (the single-block lanes
    in one launch, after the lanes' sources: inside it "exec.upload", the
    host sequence rows, the pool, the meta rows and the window rows),
    "mb_exec" (the multi-block frames' rounds; inside it "mb_exec.upload",
    each round's meta and start rows) and "materialize"
    (``materialize=True``'s copies and checks); counters "n.lanes" (the
    lanes the executor takes: single-block frames and every block of the
    multi-block ones) and "n.host_seq_lanes" (those whose sequences the
    planner decoded on the host); with FSE kernel lanes,
    "n.fse_wide_lanes" (those whose bitstream passes the reference's
    2,048-word window, ``ops.device_fse.REF_MAX_W``); with multi-block
    frames, "n.mb_frames", "n.mb_blocks", "n.mb_groups" and "n.mb_rounds"
    (the executor's dependent batches and their rounds), and the
    planner's literal counters "n.mb_lit_bytes", "n.mb_host_lit_bytes"
    and "n.mb_treeless_host" (``plan_batch``).  Keys a batch does not
    reach are absent.  Under a running
    torch.profiler the planner's spans are also recorded as "decode.plan",
    "decode.plan.native", ... (``utils.trace``).
    """
    check_flag("materialize", materialize)
    device = resolve_device(device)
    with trace.stage("plan", timings, device, "decode"):
        plan = plan_batch(frames, ddict, timings)
    trace.count("lanes", len(plan.blocks) + sum(
        len(f["blocks"]) for f in plan.mb_frames), timings)
    trace.count("host_seq_lanes", len(plan.host_seqs), timings)
    if plan.mb_frames:
        trace.count("mb_frames", len(plan.mb_frames), timings)
        trace.count("mb_blocks", sum(len(f["blocks"])
                                     for f in plan.mb_frames), timings)
    nb = plan.nb
    with trace.stage("host", timings if plan.host_routed else None, device):
        host_results = _host_decode(frames, plan.host_routed, ddict)
    if not plan.blocks and not plan.mb_frames:
        _release_ops(nb, None)  # nothing was uploaded from the ctx
        if materialize:
            return [host_results[i] for i in range(plan.n_frames)], {
                "device_frames": 0, "host_frames": len(host_results)}
        return [], np.zeros(0, np.int64), host_results

    # ---- stage 1: entropy kernels ----
    huf_flat, huf_T = None, 0
    if nb.n_huf:
        with trace.stage("huf", timings, device):
            outs = []
            for i in range(0, nb.n_huf, dh.LANES):
                with trace.stage("huf.upload", timings):
                    ops = ops_to_device(nb.huf_ops(i), device)
                outs.append(dh.decode_lanemajor(ops))
            huf_T = max(o.shape[1] for o in outs)
            huf_flat = torch.cat([torch.nn.functional.pad(
                o, (0, huf_T - o.shape[1])) for o in outs]).reshape(-1)

    fse_rows, fse_T = None, 0
    if nb.n_fse:
        trace.count("fse_wide_lanes", nb.n_fse_wide, timings)
        with trace.stage("fse", timings, device):
            parts = []
            for i in range(0, nb.n_fse, df.LANES):
                with trace.stage("fse.upload", timings):
                    ops = ops_to_device(nb.fse_ops(i), device)
                parts.append(df.decode_lanemajor(ops))
            fse_T = max(p[0].shape[1] for p in parts)
            fse_rows = tuple(torch.cat([torch.nn.functional.pad(
                p[k], (0, fse_T - p[k].shape[1])) for p in parts])
                for k in range(3))

    # ---- stage 2: every lane in one call (one launch on a card) ----
    S = _bucket(max(plan.max_seq, fse_T, 1), _S_BUCKETS)
    O = _bucket(max(plan.max_out, 1), _O_BUCKETS)
    B = EXEC_LANES
    outputs, flags = [], []
    lengths = np.array([b.out_len for b in plan.blocks], np.int64)
    with trace.stage("exec", timings, device):
        # the lanes' sources: host-decoded sequence rows (fallback lanes
        # and multi-block blocks) and the raw pool
        with trace.stage("exec.upload", timings):
            with trace.stage("exec.upload", None, plane="decode"):
                h = None
                if plan.host_seqs:
                    h = np.zeros((3, len(plan.host_seqs), S), np.int32)
                    for r, seqs in enumerate(plan.host_seqs):
                        for k in range(3):
                            h[k, r, :len(seqs[k])] = seqs[k]
                pool = np.frombuffer(nb.pool_bytes() + b"\x00",
                                     np.uint8).copy()
            h_rows = None if h is None else tuple(
                torch.from_numpy(h[k]).to(device) for k in range(3))
            raw_flat = torch.from_numpy(pool).to(device)
        fence = None
        if device.type == "cuda":
            fence = torch.cuda.Event()
            fence.record(torch.cuda.current_stream(device))
        _release_ops(nb, fence)
        src = LaneSources(raw_flat, huf_flat, huf_T, fse_rows, h_rows)
        if plan.blocks:
            n = -(-len(plan.blocks) // B) * B  # padding lanes: zero meta rows
            with trace.stage("exec.upload", timings):
                meta = torch.from_numpy(
                    _meta_array(plan.blocks, len(plan.window), n)).to(device)
                window = _window_rows(plan.window, n, device)
            rows, bad = _fused_decode(meta, src, S, O, window)
            outputs = list(rows.split(B))
            flags.append(bad)

    # ---- multi-block frames: dependent execution rounds ----
    mb_device = {}
    with trace.stage("mb_exec", timings if plan.mb_frames else None, device):
        for group in _mb_groups(plan.mb_frames):
            F = len(group)
            trace.count("mb_groups", 1, timings)
            Wb = _bucket(max(f["window"] for f in group), _MBW_BUCKETS)
            Cb = _bucket(max(f["content"] for f in group), _MBC_BUCKETS)
            n_rounds = max(len(f["blocks"]) for f in group)
            O_max = _bucket(max(b.out_len for f in group for b in f["blocks"]),
                            _O_BUCKETS)
            acc = torch.zeros(F, Wb + Cb + O_max, dtype=torch.uint8,
                              device=device)
            if plan.window:  # the dictionary's tail ends each frame's window
                acc[:, Wb - len(plan.window):Wb] = torch.frombuffer(
                    bytearray(plan.window), dtype=torch.uint8).to(device)
            group_bad = torch.zeros(F, dtype=torch.int32, device=device)
            trace.count("mb_rounds", n_rounds, timings)
            for r in range(n_rounds):
                # one upload a round: the meta rows, then each lane's window
                # start and output start.  Lane k's window is the Wb bytes
                # before its block's output in row k of acc, its output the
                # O_max bytes from there (starts clamped into the row, as
                # jax.lax.dynamic_slice / dynamic_update_slice); an inactive
                # lane starts at Cb and writes zeros past its content (padding)
                buf = np.zeros(F * 14, np.int64)
                meta, starts = buf[:F * 12].reshape(F, 12), buf[F * 12:]
                starts[:F] = Cb
                ks = [k for k, f in enumerate(group) if r < len(f["blocks"])]
                blocks = [group[k]["blocks"][r] for k in ks]
                out_off = np.array([b.out_off for b in blocks], np.int64)
                # a match may reach the frame's output before the block and the
                # dictionary, as far as the Wb-byte window holds
                meta[ks] = _meta_array(
                    blocks, np.minimum(out_off + len(plan.window), Wb))
                starts[ks] = out_off
                starts[F:] = Wb + starts[:F]
                with trace.stage("mb_exec.upload", timings):
                    t = torch.from_numpy(buf).to(device)
                _, bad = _fused_decode(
                    t[:F * 12].view(F, 12), src, S, O_max, acc,
                    win_start=t[F * 12:F * 13], W=Wb, out=acc,
                    out_start=t[F * 13:])
                group_bad |= bad  # inactive lanes flag nothing
            for k, f in enumerate(group):
                mb_device[f["frame_idx"]] = (
                    acc[k, Wb:Wb + f["content"]], f["content"], f["checksum"])
            flags.append(group_bad)

    if not materialize:
        for fi, (row, _n, _cks) in mb_device.items():
            host_results[fi] = row  # device-resident uint8 [content]
        return outputs, lengths, host_results
    with trace.stage("materialize", timings, device):
        return _materialize(plan, outputs, flags, mb_device, host_results,
                            device)


def _materialize(plan, outputs, flags, mb_device, host_results, device):
    """``materialize=True``'s tail: every frame's bytes in order, after the
    executor's flags and the stored checksums are checked."""
    B = EXEC_LANES
    # every device frame's flags: chunk lanes in plan.blocks order (padding
    # lanes flag nothing), then each multi-block group's frames.  They are
    # copied without a wait, into pinned memory on a card, ahead of the
    # rows on the same stream, so the rows' copies bring them back too
    lane_frames = [b.frame_idx for b in plan.blocks]
    lane_frames += [None] * (len(outputs) * B - len(lane_frames))
    lane_frames += [fi for fi in mb_device]
    flags = torch.cat(flags)
    bad = torch.empty(flags.shape, dtype=flags.dtype,
                      pin_memory=device.type == "cuda")
    bad.copy_(flags, non_blocking=True)

    results = [None] * plan.n_frames
    for fi, data in host_results.items():
        results[fi] = data
    device_rows = [(fi, row.cpu().numpy().tobytes(), cks)
                   for fi, (row, _n, cks) in mb_device.items()]
    for ci, out in enumerate(outputs):
        host = out.cpu().numpy()
        for k, b in enumerate(plan.blocks[ci * B:(ci + 1) * B]):
            device_rows.append(
                (b.frame_idx, host[k, :b.out_len].tobytes(), b.checksum))
    with trace.stage("materialize", None, plane="decode"):
        flagged = [(fi, int(v)) for fi, v in zip(lane_frames, bad.numpy())
                   if v]
        if flagged:
            fi, v = min(flagged)
            raise ZstdError(ZstdErrorCode.corruption_detected,
                            f"frame {fi}: " + "; ".join(
                                why for bit, why in _FLAG_REASONS
                                if v >> bit & 1))
        for fi, data, cks in device_rows:
            if cks >= 0 and content_checksum(data) != cks:
                raise ZstdError(ZstdErrorCode.checksum_wrong,
                                f"frame {fi}: content checksum mismatch on "
                                "device-decoded output")
            results[fi] = data
    stats = {"device_frames": len(plan.blocks) + len(plan.mb_frames),
             "host_frames": len(host_results)}
    return results, stats
