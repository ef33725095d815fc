"""The encode plane's frame assembly: CUDA kernel and plain torch version
(counterpart of zstdsharp_tpu/ops/device_encode.py ``_assembly_phase``,
the vmapped ``_encode_lane``).

``assemble_lanes(blocks, n_valid, parsed, lit_sorted, lit_count, huf, seq,
W, WQ)`` writes the zstd frame row of every record of a chunk in one launch
of ``csrc/assemble.cu``'s ``zt_assemble`` (one block a lane; its source
note says what bounds it and how the design answers).  It takes CUDA
tensors only and raises on any other device, dtype, shape or layout;
``assemble``, which ``device_encode.encode_frames_device`` calls, takes
``assemble_plain`` on CPU tensors.  ``assemble_plain`` is the torch
composition of the reference's program, the same integers on any device:
every FSE encoder state at once by composing the per-symbol permutation
maps (``device_encode._fse_stream_states``), the sequence and 4-stream Huffman
bitstreams through the prefix-scan packer, and a byte-position classifier
that writes the row.

The operands are those ``device_encode.encode_frames_device`` uploads:

  blocks      uint8 [B, N]  the padded records (N a multiple of 16)
  n_valid     int32 [B]     their lengths, 0 to N
  parsed      the parse's dict: starts, mls, offs int32 [B, S] and nseq
              int32 [B], at most S (other keys are not read)
  lit_sorted  uint8 [B, N], lit_count int32 [B]: the literals first
  huf         (codes int64 [B, 256], nbits int64 [B, 256], desc uint8
              [B, DESC_MAX], desc_len int32 [B], ok bool [B]): each lane's
              Huffman literal table (``device_encode._build_lit_tables``)
  seq         {"ll", "of", "ml": (maps int32 [B, nsym, TS], nbs uint8
              [B, nsym, TS], init int32 [B, nsym], flush int32 [B]),
              "mode": int32 [B], "tbl": uint8 [B, TBL_MAX], "tbl_len":
              int32 [B]}: each lane's FSE tables
              (``device_encode._build_seq_tables``)
  W, WQ       the u32 capacity of the sequence bitstream and of each
              Huffman quarter

and both return (rows uint8 [B, N + 16], out_len int32 [B]).
"""

from __future__ import annotations

import torch

from .. import _build
from ._launch import check_cuda, check_operand, launch
from .common import U32, pack_bits_device

MAX_N = 1 << 17      # the plane's largest bucket
MAX_TS = 64          # a state fits the kernel's byte: table logs <= 6
MAX_NSYM = 64
STREAMS = ("ll", "of", "ml")  # the kernel's stream order
STAMPS = 9  # the kernel's clock stamps a lane: the start, then each pass


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------


def _le_bytes(words, k):
    """[..., M] values -> [..., M*k] little-endian bytes (int64)."""
    sh = 8 * torch.arange(k, device=words.device)
    return ((words[..., None] >> sh) & 0xFF).reshape(*words.shape[:-1], -1)


def assemble_plain(blocks, n_valid, parsed, lit_sorted, lit_count, huf,
                   seq, W: int, WQ: int):
    """Plain torch version of the kernel, on whatever device the operands
    are on: one frame row per record (reference ``_encode_lane``, vmapped
    by ``_assembly_phase``).  Returns (rows uint8 [B, N+16], out_len
    int32 [B]).  Issues no host synchronisation."""
    from . import device_encode as de

    B, N = blocks.shape
    dev = blocks.device
    i64 = torch.int64
    lut = de._dev_consts(dev)
    t = de._tables()
    ns = parsed["nseq"].to(i64)
    nv = n_valid.to(i64)
    h_codes, h_nbits, h_desc, h_dlen, h_ok = huf

    real, ll, mlv, ofb = de._seq_values(parsed["starts"], parsed["mls"],
                                        parsed["offs"], parsed["nseq"])
    ll_code, ml_code, of_code = de._codes_from_values(ll, mlv, ofb, lut)

    # FSE state chains (per-row fresh/RLE/predefined tables)
    of_val, of_nb, of_fin = de._fse_stream_states(of_code, ns, t["of"],
                                                  seq["of"][:3])
    ml_val, ml_nb, ml_fin = de._fse_stream_states(ml_code, ns, t["ml"],
                                                  seq["ml"][:3])
    ll_val, ll_nb, ll_fin = de._fse_stream_states(ll_code, ns, t["ll"],
                                                  seq["ll"][:3])

    # extras (value masked by the packer to nbits)
    ext_ll_nb = torch.where(real, lut["ll_bits"][ll_code.clamp(0, 35)], 0)
    ext_ml_nb = torch.where(real, lut["ml_bits"][ml_code.clamp(0, 52)], 0)
    ext_of_nb = torch.where(real, of_code, 0)

    # field layout: per sequence i (emitted from i=S-1 down to 0):
    #   [of_state, ml_state, ll_state, ll_extra, ml_extra, of_extra]
    # then [ml_flush, of_flush, ll_flush].  Zero-width pads keep offsets
    # exact (encode/block.py:encode_sequences_bitstream order).
    vals6 = torch.stack([of_val, ml_val, ll_val, ll, mlv, ofb], 2
                        ).flip(1).reshape(B, -1)
    nbs6 = torch.stack([of_nb, ml_nb, ll_nb, ext_ll_nb, ext_ml_nb, ext_of_nb],
                       2).flip(1).reshape(B, -1)
    values = torch.cat([vals6, torch.stack([ml_fin, of_fin, ll_fin], 1)], 1)
    tail_nbs = torch.stack([seq["ml"][3], seq["of"][3], seq["ll"][3]], 1)
    nbits = torch.cat([nbs6, tail_nbs.to(i64)], 1) & U32
    nbits = torch.where(ns[:, None] > 0, nbits, 0)
    words, total_bits = pack_bits_device(values & U32, nbits, W)
    bits_len = (total_bits + 7) >> 3
    bits_bytes = _le_bytes(words, 4)                              # [B, 4W]

    # ---- Huffman literal section (4-stream, device-packed) ----
    L = lit_count.to(i64)
    seg = ((L + 3) >> 2).clamp(min=1)[:, None, None]
    SEGMAX = N // 4 + 1
    tq = torch.arange(SEGMAX, device=dev)[None, None, :]
    q = torch.arange(4, device=dev)[None, :, None]
    seglen = torch.where(q < 3, seg, L[:, None, None] - 3 * seg)  # [B, 4, 1]
    # symbols consumed back-to-front per quarter (encode_1x order)
    srcpos = (q * seg + (seglen - 1 - tq)).clamp(0, N - 1)        # [B, 4, SEGMAX]
    sym = torch.gather(lit_sorted.to(i64), 1, srcpos.reshape(B, -1))
    hv = torch.gather(h_codes, 1, sym).reshape(B, 4, SEGMAX)
    hb = torch.where(tq < seglen,
                     torch.gather(h_nbits, 1, sym).reshape(B, 4, SEGMAX), 0)
    hwords, htotal = pack_bits_device(hv, hb, WQ)                 # [B, 4, WQ]
    sl = (htotal + 7) >> 3                                        # [B, 4]
    hbytes = _le_bytes(hwords, 4)                                 # [B, 4, 4WQ]
    comp_lit = h_dlen.to(i64) + 6 + sl.sum(1)
    use_huf = h_ok & (5 + comp_lit < 3 + L) & (ns > 0)
    lit_sec = torch.where(use_huf, 5 + comp_lit, 3 + L)

    # section sizes
    tbl_len = seq["tbl_len"].to(i64)
    body = lit_sec + 2 + 1 + tbl_len + bits_len  # lits+nbseq+modes+tbls+fse
    comp_total = 12 + body                       # frame hdr 9 + block hdr 3
    raw_total = 12 + nv
    use_raw = (ns == 0) | (comp_total >= raw_total)
    out_len = torch.where(use_raw, raw_total, comp_total)

    # frame header: magic | FHD 0xA0 (single-segment, 4-byte FCS) | FCS32
    hdr9 = torch.cat([lut["magic"].expand(B, 5), _le_bytes((nv & U32)[:, None], 4)],
                     1)
    bsize = torch.where(use_raw, nv, body)
    btype = torch.where(use_raw, 0, 2)
    bh3 = _le_bytes((1 | (btype << 1) | (bsize << 3))[:, None], 3)
    # raw-literal header (type 0, size_format 3)
    lh3 = _le_bytes(((3 << 2) | (L << 4))[:, None], 3)
    # compressed-literal header (type 2, size_format 3: 18+18-bit sizes);
    # the 40-bit field  2 | 3<<2 | L<<4 | comp_lit<<22  emitted bytewise
    Lu, cu = L & U32, comp_lit & U32
    hh5 = torch.stack([
        (2 | (3 << 2)) | ((Lu & 0xF) << 4),
        (Lu >> 4) & 0xFF,
        ((Lu >> 12) & 0x3F) | ((cu & 0x3) << 6),
        (cu >> 2) & 0xFF,
        (cu >> 10) & 0xFF,
    ], 1)

    # byte-position classifier: position j of the row reads every section
    # at its clamped offset, then selects
    OUT = N + 16
    j = torch.arange(OUT, device=dev)[None, :]
    jb = j - 12

    def take(tbl, pos):
        pos = pos.clamp(0, tbl.shape[-1] - 1).expand(B, OUT)
        return torch.gather(tbl.to(i64), 1, pos)

    col = lambda v: v[:, None]  # noqa: E731  ([B] -> [B, 1])
    head = torch.where(j < 9, take(hdr9, j), take(bh3, j - 9))
    raw_byte = take(blocks, jb)
    lit_byte = take(lit_sorted, jb - 3)
    raw_sec = torch.where(jb < 3, take(lh3, jb), lit_byte)
    # huffman section byte: hdr5 | desc | jump | 4 streams
    c_desc = 5
    c_jump = c_desc + col(h_dlen.to(i64))
    c_s0 = c_jump + 6
    c_s1 = c_s0 + sl[:, 0:1]
    c_s2 = c_s1 + sl[:, 1:2]
    c_s3 = c_s2 + sl[:, 2:3]
    jump6 = torch.stack([sl[:, 0] & 0xFF, sl[:, 0] >> 8, sl[:, 1] & 0xFF,
                         sl[:, 1] >> 8, sl[:, 2] & 0xFF, sl[:, 2] >> 8], 1)
    huf_sec = torch.where(
        jb < c_desc, take(hh5, jb),
        torch.where(jb < c_jump, take(h_desc, jb - c_desc),
        torch.where(jb < c_s0, take(jump6, jb - c_jump),
        torch.where(jb < c_s1, take(hbytes[:, 0], jb - c_s0),
        torch.where(jb < c_s2, take(hbytes[:, 1], jb - c_s1),
        torch.where(jb < c_s3, take(hbytes[:, 2], jb - c_s2),
                    take(hbytes[:, 3], jb - c_s3)))))))
    lit_sec_byte = torch.where(col(use_huf), huf_sec, raw_sec)

    ls = col(lit_sec)
    tl = col(tbl_len)
    bits_byte = take(bits_bytes, jb - 3 - tl - ls)
    tbl_byte = take(seq["tbl"], jb - 3 - ls)
    nbseq_b = torch.where(jb == ls, 128 + col(ns >> 8), col(ns & 0xFF))
    compressed = torch.where(
        jb < ls, lit_sec_byte,
        torch.where(jb < ls + 2, nbseq_b,
            torch.where(jb == ls + 2, col(seq["mode"].to(i64)),
                torch.where(jb < ls + 3 + tl, tbl_byte, bits_byte))))
    tail = torch.where(col(use_raw), raw_byte, compressed)
    row = torch.where(j < 12, head, tail) & 0xFF
    row = torch.where(j < col(out_len), row, 0).to(torch.uint8)
    return row, out_len.to(torch.int32)


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------

_LUT_CACHE: dict = {}


def _lut(dev: torch.device) -> torch.Tensor:
    """int32 [281] on `dev`: the ll code LUT (64), the ml code LUT (128),
    the ll extra-bit widths (36) and the ml ones (53) of
    ``device_encode._tables()``, uploaded once per device."""
    key = str(dev)
    if key not in _LUT_CACHE:
        import numpy as np

        from . import device_encode as de

        t = de._tables()
        _LUT_CACHE[key] = torch.from_numpy(np.concatenate(
            [t[k] for k in ("ll_lut", "ml_lut", "ll_bits", "ml_bits")]
        ).astype(np.int32)).to(dev)
    return _LUT_CACHE[key]


def _check_operands(blocks, n_valid, parsed, lit_sorted, lit_count, huf,
                    seq, W, WQ):
    """Raise unless the operands are what the kernel takes (module
    docstring); returns (B, N, S)."""
    if not isinstance(blocks, torch.Tensor) or blocks.dim() != 2:
        raise ValueError("blocks: expected a uint8 tensor [B, N]")
    B, N = blocks.shape
    dev = blocks.device
    u8, i32 = torch.uint8, torch.int32
    check_operand("blocks", blocks, (B, N), dev, u8)
    if not 16 <= N <= MAX_N or N % 16:
        raise ValueError(f"N {N}: the kernel takes a multiple of 16 from 16 "
                         f"to {MAX_N}")
    if blocks.data_ptr() % 4:
        raise ValueError("blocks: must be 4-byte aligned")
    starts = parsed["starts"]
    if not isinstance(starts, torch.Tensor) or starts.dim() != 2:
        raise ValueError("parsed['starts']: expected an int32 tensor [B, S]")
    S = starts.shape[1]
    for k in ("starts", "mls", "offs"):
        check_operand(f"parsed[{k!r}]", parsed[k], (B, None), dev, i32)
        if parsed[k].shape[1] != S:
            raise ValueError(f"parsed[{k!r}]: expected [{B}, {S}]")
    for name, t in (("n_valid", n_valid), ("parsed['nseq']", parsed["nseq"]),
                    ("lit_count", lit_count), ("desc_len", huf[3]),
                    ("mode", seq["mode"]), ("tbl_len", seq["tbl_len"])):
        check_operand(name, t, (B,), dev, i32)
    check_operand("lit_sorted", lit_sorted, (B, N), dev, u8)
    codes, nbits, desc, _, ok = huf
    check_operand("huf codes", codes, (B, 256), dev, torch.int64)
    check_operand("huf nbits", nbits, (B, 256), dev, torch.int64)
    check_operand("huf desc", desc, (B, None), dev, u8)
    check_operand("huf ok", ok, (B,), dev, torch.bool)
    check_operand("tbl", seq["tbl"], (B, None), dev, u8)
    for name in STREAMS:
        maps, nbs, init, flush = seq[name]
        check_operand(f"{name} maps", maps, (B, None, None), dev, i32)
        _, nsym, ts = maps.shape
        if nsym > MAX_NSYM or ts > MAX_TS:
            raise ValueError(f"{name} maps: [{nsym}, {ts}] a lane, the "
                             f"kernel takes at most [{MAX_NSYM}, {MAX_TS}]")
        check_operand(f"{name} nbs", nbs, (B, nsym, ts), dev, u8)
        check_operand(f"{name} init", init, (B, nsym), dev, i32)
        check_operand(f"{name} flush", flush, (B,), dev, i32)
    if W < 1 or WQ < 1:
        raise ValueError(f"W {W}, WQ {WQ}: expected >= 1")
    return B, N, S


def assemble_lanes(blocks, n_valid, parsed, lit_sorted, lit_count, huf, seq,
                   W: int, WQ: int, stamps: torch.Tensor | None = None):
    """The frame row of every lane in one launch of the kernel, on the
    current stream; the operands as the module docstring says, contiguous,
    on one CUDA device.  Raises on any other device, dtype, shape or
    layout.  `stamps` (int64 [B, STAMPS] on the same device), when given,
    receives each lane's SM clock at the start and after each of the
    kernel's passes.  Counts its launches in ``assemble_lanes.launches``."""
    B, N, S = _check_operands(blocks, n_valid, parsed, lit_sorted, lit_count,
                              huf, seq, W, WQ)
    dev = blocks.device
    if stamps is not None:
        check_operand("stamps", stamps, (B, STAMPS), dev, torch.int64)
    check_cuda(dev)
    out, args, _keep = launch_args(blocks, n_valid, parsed, lit_sorted,
                                   lit_count, huf, seq, W, WQ, stamps)
    if B:
        launch("assemble", dev, _build.load().zt_assemble, *args)
        assemble_lanes.launches += 1
    return out


_SCRATCH_CACHE: dict = {}


def _scratch_per_lane(lib, N: int, S: int, shapes: tuple) -> int:
    """``zt_assemble_scratch`` (the device-memory scratch bytes a lane
    needs: 0 where its row and sequence arrays fit in shared memory) for
    (N, S, the three streams' [nsym, TS]), asked of the library once."""
    key = (N, S, shapes)
    if key not in _SCRATCH_CACHE:
        _SCRATCH_CACHE[key] = lib.zt_assemble_scratch(N, S, *shapes)
    return _SCRATCH_CACHE[key]


def launch_args(blocks, n_valid, parsed, lit_sorted, lit_count, huf, seq,
                W: int, WQ: int, stamps=None, lib=None):
    """The outputs of one ``zt_assemble`` call on checked operands (rows,
    out_len, allocated), its arguments but the stream, and the scratch
    tensor those point into, which must outlive the launch.  `lib`, when
    given, is another build of the kernel whose scratch size is asked
    (kernel_bench's A/B)."""
    B, N = blocks.shape
    S = parsed["starts"].shape[1]
    dev = blocks.device
    rows = torch.empty(B, N + 16, dtype=torch.uint8, device=dev)
    out_len = torch.empty(B, dtype=torch.int32, device=dev)
    shapes = tuple(d for name in STREAMS for d in seq[name][0].shape[1:])
    if not B:
        per_lane = 0
    elif lib is None:
        per_lane = _scratch_per_lane(_build.load(), N, S, shapes)
    else:
        per_lane = lib.zt_assemble_scratch(N, S, *shapes)
    scratch = (torch.empty(B * per_lane, dtype=torch.uint8, device=dev)
               if per_lane else None)
    codes, nbits, desc, dlen, ok = huf
    tensors = (blocks, n_valid, parsed["starts"], parsed["mls"],
               parsed["offs"], parsed["nseq"], lit_sorted, lit_count, codes,
               nbits, desc, dlen, ok,
               *(t for name in STREAMS for t in seq[name]), seq["mode"],
               seq["tbl"], seq["tbl_len"], _lut(dev), rows, out_len)
    args = (*(t.data_ptr() for t in tensors),
            None if scratch is None else scratch.data_ptr(), B, N, S, W, WQ,
            desc.shape[1], seq["tbl"].shape[1], *shapes,
            None if stamps is None else stamps.data_ptr())
    return (rows, out_len), args, scratch


assemble_lanes.launches = 0


def assemble(blocks, n_valid, parsed, lit_sorted, lit_count, huf, seq,
             W: int, WQ: int):
    """The frame rows where the operands are: ``assemble_plain`` on CPU
    tensors, ``assemble_lanes`` (the kernel, or a raise) on any other."""
    fn = assemble_plain if blocks.device.type == "cpu" else assemble_lanes
    return fn(blocks, n_valid, parsed, lit_sorted, lit_count, huf, seq, W,
              WQ)
