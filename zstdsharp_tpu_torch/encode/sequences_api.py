"""External sequence API, the port's copy of
zstdsharp_tpu/encode/sequences_api.py (reference: ZSTD_generateSequences:3614,
ZSTD_mergeBlockDelimiters:3646, ZSTD_compressSequences:7656).

Lets tooling extract the sequences a compression level would produce, and
inject externally-produced sequences back through the entropy stage — the
hook used to isolate entropy-stage issues from match-finder issues (and to
feed device-generated parses through the host encoder).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .. import constants as C
from ..errors import ZstdError, ZstdErrorCode, check
from .block import EncoderEntropy, encode_block_body
from .frame import _block_header, _write_frame_header
from .params import CCtxParams
from .seqstore import MatchState, SeqStore, compress_block


@dataclass
class Sequence:
    """One LZ sequence (ZSTD_Sequence): offset 0 marks a block delimiter
    (litLength = trailing literals of the block, matchLength = 0)."""

    offset: int  # actual distance (0 = block delimiter)
    lit_length: int
    match_length: int
    rep: int = 0  # informational: repcode value used (0 = plain offset)


def generate_sequences(data: bytes, level: int = C.ZSTD_DEFAULT_CLEVEL) -> list[Sequence]:
    """Run the match-finder and return sequences incl. block delimiters."""
    src = np.frombuffer(bytes(data), dtype=np.uint8)
    params = CCtxParams(compression_level=level).resolve(src_size_hint=len(src))
    cp = params.cparams
    state = MatchState(cp)
    block_size = min(C.ZSTD_BLOCKSIZE_MAX, 1 << cp.window_log)
    out: list[Sequence] = []
    pos = 0
    rep_hist = [1, 4, 8]
    while pos < len(src):
        end = min(pos + block_size, len(src))
        seqs = compress_block(src, pos, end, state)
        # Resolve off_base -> actual distances for the public view.
        for k in range(seqs.nb_seq):
            ob = int(seqs.off_base[k])
            ll = int(seqs.lit_len[k])
            if ob > 3:
                dist = ob - 3
                rep_hist[2] = rep_hist[1]
                rep_hist[1] = rep_hist[0]
                rep_hist[0] = dist
                rep = 0
            else:
                ll0 = ll == 0
                idx = ob - 1 + (1 if ll0 else 0)
                if ob == 1 and not ll0:
                    dist = rep_hist[0]
                elif ob == 1 and ll0:
                    dist = rep_hist[1]
                    rep_hist[0], rep_hist[1] = rep_hist[1], rep_hist[0]
                else:
                    dist = rep_hist[0] - 1 if idx == 3 else rep_hist[idx]
                    if idx != 1:
                        rep_hist[2] = rep_hist[1]
                    rep_hist[1] = rep_hist[0]
                    rep_hist[0] = dist
                rep = ob
            out.append(Sequence(dist, ll, int(seqs.match_len[k]), rep))
        out.append(Sequence(0, seqs.last_literals, 0))
        pos = end
    return out


def merge_block_delimiters(seqs: list[Sequence]) -> list[Sequence]:
    """ZSTD_mergeBlockDelimiters:3646 — fold delimiter literals into the
    following sequence, dropping empty delimiters."""
    out: list[Sequence] = []
    carry = 0
    for s in seqs:
        if s.offset == 0 and s.match_length == 0:
            carry += s.lit_length
            continue
        out.append(Sequence(s.offset, s.lit_length + carry, s.match_length, s.rep))
        carry = 0
    if carry:
        out.append(Sequence(0, carry, 0))
    return out


def compress_sequences(seqs: list[Sequence], data: bytes,
                       checksum: bool = False,
                       window_log: int | None = None) -> bytes:
    """ZSTD_compressSequences:7656 — entropy-encode externally supplied
    sequences over `data`, with validation, producing a complete frame.

    Sequences must use explicit block delimiters (offset==0 rows).
    """
    src = np.frombuffer(bytes(data), dtype=np.uint8)
    n = len(src)
    wlog = window_log or min(max((n - 1).bit_length(), C.ZSTD_WINDOWLOG_ABSOLUTEMIN),
                             C.ZSTD_WINDOWLOG_LIMIT_DEFAULT)
    out = bytearray(_write_frame_header(n, wlog, checksum, True))
    entropy = EncoderEntropy()

    # Split into blocks at delimiters, enforcing block-size bounds.
    block: list[Sequence] = []
    blocks: list[tuple[list[Sequence], int]] = []
    span = 0
    for s in seqs:
        if s.offset == 0 and s.match_length == 0:
            blocks.append((block, span + s.lit_length))
            block, span = [], 0
        else:
            check(s.match_length >= C.MINMATCH, ZstdErrorCode.parameter_outOfBound,
                  "matchLength < 3")
            block.append(s)
            span += s.lit_length + s.match_length
    check(not block, ZstdErrorCode.parameter_outOfBound,
          "sequences must end with a block delimiter")

    pos = 0
    rep_hist = [1, 4, 8]
    for bi, (bseqs, bspan) in enumerate(blocks):
        last = bi == len(blocks) - 1
        check(bspan <= C.ZSTD_BLOCKSIZE_MAX, ZstdErrorCode.parameter_outOfBound,
              "block exceeds 128 KiB")
        check(pos + bspan <= n, ZstdErrorCode.srcSize_wrong, "sequences overrun input")
        # Validate matches + rebuild offBase encoding (plain offsets).
        lls = np.empty(len(bseqs), np.uint32)
        mls = np.empty(len(bseqs), np.uint32)
        obs = np.empty(len(bseqs), np.uint32)
        cur = pos
        for k, s in enumerate(bseqs):
            cur += s.lit_length
            check(0 < s.offset <= cur, ZstdErrorCode.corruption_detected,
                  f"invalid offset {s.offset} at {cur}")
            check(bytes(src[cur : cur + s.match_length])
                  == bytes(src[cur - s.offset : cur - s.offset + s.match_length]),
                  ZstdErrorCode.corruption_detected, "sequence bytes do not match")
            ll0 = s.lit_length == 0
            if not ll0 and s.offset == rep_hist[0]:
                value = 1
            elif not ll0 and s.offset == rep_hist[1]:
                value = 2
            elif not ll0 and s.offset == rep_hist[2]:
                value = 3
            elif ll0 and s.offset == rep_hist[1]:
                value = 1
            elif ll0 and s.offset == rep_hist[2]:
                value = 2
            elif ll0 and rep_hist[0] > 1 and s.offset == rep_hist[0] - 1:
                value = 3
            else:
                value = s.offset + 3
            # decoder-exact rep update
            if value > 3:
                rep_hist[2], rep_hist[1], rep_hist[0] = rep_hist[1], rep_hist[0], s.offset
            elif value == 1:
                if ll0:
                    rep_hist[0], rep_hist[1] = rep_hist[1], rep_hist[0]
            else:
                idx = value - 1 + (1 if ll0 else 0)
                if idx != 1:
                    rep_hist[2] = rep_hist[1]
                rep_hist[1] = rep_hist[0]
                rep_hist[0] = s.offset
            lls[k], mls[k], obs[k] = s.lit_length, s.match_length, value
            cur += s.match_length
        last_lit = bspan - (int(lls.sum()) + int(mls.sum()))
        check(last_lit >= 0, ZstdErrorCode.parameter_outOfBound)
        store = SeqStore(lls, mls, obs, last_lit)
        body = encode_block_body(src[pos : pos + bspan], store, entropy) \
            if bspan else None
        if body is None:
            out += _block_header(last, C.BlockType.RAW, bspan)
            out += src[pos : pos + bspan].tobytes()
        else:
            out += _block_header(last, C.BlockType.COMPRESSED, len(body))
            out += body
        pos += bspan
    check(pos == n, ZstdErrorCode.srcSize_wrong, "sequences do not cover input")
    if checksum:
        from ..utils.xxhash import content_checksum

        out += content_checksum(src).to_bytes(4, "little")
    return bytes(out)
