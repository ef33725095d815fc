"""zstd bitstreams: the port's copy of the BitReader, BitWriter and
``pack_bits`` of zstdsharp_tpu/entropy/bitstream.py (reference:
Unsafe/Bitstream.cs).

zstd entropy payloads are *backward* bitstreams: the encoder appends fields
at increasing little-endian bit positions (BIT_addBits) and closes with a
single 1 end-mark bit (BIT_closeCStream); the decoder starts from the end
mark and reads fields in reverse append order (BIT_initDStream /
BIT_readBits).
"""

from __future__ import annotations

import numpy as np

from ..errors import ZstdError, ZstdErrorCode

_U64_MASK = (1 << 64) - 1


class BitReader:
    """Backward bit reader over a complete entropy payload.

    Reads below position 0 return zero bits in the low positions, matching
    the container-shift semantics of BIT_lookBits (Bitstream.cs:296) where
    exhausted low bits shift in as zeros.
    """

    __slots__ = ("_buf", "pos", "nbits_total")

    # Front padding (bytes) so overshooting reads land on zeros; supports
    # fields up to 57 bits with reads down to pos = -64.
    _PAD = 16

    def __init__(self, buf: bytes | np.ndarray):
        buf = bytes(buf)
        if len(buf) == 0:
            raise ZstdError(ZstdErrorCode.srcSize_wrong, "empty bitstream")
        last = buf[-1]
        if last == 0:
            raise ZstdError(ZstdErrorCode.corruption_detected, "missing end mark")
        self._buf = b"\x00" * self._PAD + buf
        self.nbits_total = (len(buf) - 1) * 8 + last.bit_length() - 1
        self.pos = self.nbits_total  # end-mark stripped

    def _field(self, p: int, nbits: int) -> int:
        """Bits [p, p+nbits) of the stream; bits below 0 read as zero."""
        p += self._PAD * 8
        if p < 0:  # deep overshoot: entirely zeros
            return 0
        byte = p >> 3
        window = int.from_bytes(self._buf[byte : byte + 8], "little")
        return (window >> (p & 7)) & ((1 << nbits) - 1)

    def read(self, nbits: int) -> int:
        """Read ``nbits`` (may drive pos negative; low bits then read as 0)."""
        self.pos -= nbits
        return self._field(self.pos, nbits)

    @property
    def finished(self) -> bool:
        """True when the stream was consumed exactly (BIT_endOfDStream)."""
        return self.pos == 0


class BitWriter:
    """Forward bit appender producing a backward-readable stream."""

    __slots__ = ("_acc", "_nbits", "_out")

    def __init__(self):
        self._acc = 0
        self._nbits = 0
        self._out = bytearray()

    def add(self, value: int, nbits: int) -> None:
        self._acc |= (value & ((1 << nbits) - 1)) << self._nbits
        self._nbits += nbits
        while self._nbits >= 8:
            self._out.append(self._acc & 0xFF)
            self._acc >>= 8
            self._nbits -= 8

    def close(self) -> bytes:
        """Append the end mark and flush; returns the payload bytes."""
        self.add(1, 1)
        if self._nbits:
            self._out.append(self._acc & ((1 << self._nbits) - 1))
            self._acc = 0
            self._nbits = 0
        return bytes(self._out)


def pack_bits(values: np.ndarray, nbits: np.ndarray) -> bytes:
    """Vectorized backward-bitstream packer (the TPU reformulation).

    Equivalent to ``BitWriter().add(v_i, n_i) for i in order; close()`` but
    computed as: exclusive prefix-scan of nbits -> per-field word scatter.
    Fields must satisfy nbits <= 56.
    """
    values = np.ascontiguousarray(values, dtype=np.uint64)
    nbits = np.ascontiguousarray(nbits, dtype=np.uint64)
    assert values.shape == nbits.shape
    if values.size == 0:
        return b"\x01"
    end = np.cumsum(nbits)
    offsets = end - nbits  # exclusive scan
    total = int(end[-1]) + 1  # + end mark
    nwords = (total + 63) // 64 + 1

    mask = (np.uint64(1) << nbits) - np.uint64(1)
    vals = values & mask
    widx = (offsets >> np.uint64(6)).astype(np.int64)
    bidx = offsets & np.uint64(63)

    words = np.zeros(nwords, dtype=np.uint64)
    lo = (vals << bidx) & np.uint64(_U64_MASK)
    np.bitwise_or.at(words, widx, lo)
    # Spill into the next word where bidx + nbits > 64.
    spill = bidx + nbits > 64
    if spill.any():
        hi_shift = (np.uint64(64) - bidx[spill]) & np.uint64(63)
        hi = vals[spill] >> hi_shift
        np.bitwise_or.at(words, widx[spill] + 1, hi)
    # End mark.
    words[(total - 1) // 64] |= np.uint64(1) << np.uint64((total - 1) & 63)
    out = words.view(np.uint8)[: (total + 7) // 8]
    return out.tobytes()
