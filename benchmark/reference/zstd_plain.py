"""A plain zstd frame decoder in Python and NumPy, written from RFC 8878.

The reference that the encode cells' frames are judged by: it imports
nothing of the program and shares no code with it.  It decodes frames
without a dictionary: raw, RLE and compressed blocks; raw, RLE, Huffman
and treeless literal sections (one or four streams); predefined, RLE,
FSE and repeat sequence tables; repeat offsets.  It checks what RFC 8878
makes a decoder check (reserved bits, sizes, offsets inside the output,
bitstreams read to their exact end) and raises ``FrameError`` on any
breach.  It does not verify a content checksum; ``frame_header`` reports
whether a frame carries one.
"""

from __future__ import annotations

MAGIC = 0xFD2FB528
BLOCK_MAX = 1 << 17


class FrameError(ValueError):
    pass


def _need(cond, what):
    if not cond:
        raise FrameError(what)


# ---- frame header ----

def frame_header(frame: bytes) -> dict:
    """The fields of a frame's header: header_size, content_size (None if
    absent), window_size, has_checksum, dict_id, single_segment."""
    _need(len(frame) >= 6, "frame shorter than a header")
    _need(int.from_bytes(frame[:4], "little") == MAGIC, "bad magic number")
    fhd = frame[4]
    fcs_flag, single = fhd >> 6, fhd >> 5 & 1
    cks, did_flag = fhd >> 2 & 1, fhd & 3
    _need(fhd & 8 == 0, "reserved bit set in the frame header")
    p = 5
    window = None
    if not single:
        wd = frame[p]
        p += 1
        exp, mant = wd >> 3, wd & 7
        base = 1 << (10 + exp)
        window = base + (base >> 3) * mant
    did_size = (0, 1, 2, 4)[did_flag]
    dict_id = int.from_bytes(frame[p:p + did_size], "little")
    p += did_size
    fcs_size = (1 if single else 0, 2, 4, 8)[fcs_flag]
    content = None
    if fcs_size:
        content = int.from_bytes(frame[p:p + fcs_size], "little")
        if fcs_size == 2:
            content += 256
        p += fcs_size
    _need(p <= len(frame), "truncated frame header")
    if window is None:
        window = content
    return {"header_size": p, "content_size": content, "window_size": window,
            "has_checksum": bool(cks), "dict_id": dict_id,
            "single_segment": bool(single)}


# ---- bitstreams ----

class _Fwd:
    """Little-endian bits read from the start (FSE table descriptions)."""

    def __init__(self, data: bytes):
        self.data, self.pos = data, 0

    def bits(self, n: int) -> int:
        b = self.pos >> 3
        v = int.from_bytes(self.data[b:b + 8], "little") >> (self.pos & 7)
        self.pos += n
        _need(self.pos <= 8 * len(self.data), "table description overrun")
        return v & ((1 << n) - 1)


class _Back:
    """Bits read backwards from the end, after the padding marker (the
    highest set bit of the last byte); past the start they read as 0."""

    def __init__(self, data: bytes):
        _need(len(data) > 0 and data[-1] != 0, "bitstream without its marker")
        self.data = data
        self.pos = 8 * (len(data) - 1) + data[-1].bit_length() - 1

    def bits(self, n: int) -> int:
        if n == 0:
            return 0
        self.pos -= n
        p = self.pos
        if p >= 0:
            b = p >> 3
            v = int.from_bytes(self.data[b:b + 8], "little") >> (p & 7)
        else:
            v = int.from_bytes(self.data[:8], "little") << -p
        return v & ((1 << n) - 1)

    def peek(self, n: int) -> int:
        p = self.pos - n
        if p >= 0:
            b = p >> 3
            v = int.from_bytes(self.data[b:b + 8], "little") >> (p & 7)
        else:
            v = int.from_bytes(self.data[:8], "little") << -p
        return v & ((1 << n) - 1)


# ---- FSE ----

def read_ncount(data: bytes, max_log: int, max_sym: int):
    """A normalized distribution from its description: (counts, accuracy
    log, bytes read)."""
    br = _Fwd(data)
    log = br.bits(4) + 5
    _need(log <= max_log, "FSE accuracy log too large")
    remaining = (1 << log) + 1
    threshold = 1 << log
    nbits = log + 1
    counts = []
    while remaining > 1:
        _need(len(counts) <= max_sym, "FSE distribution has too many symbols")
        low = br.bits(nbits - 1)
        mx = (2 * threshold - 1) - remaining
        if low < mx:
            value = low
        else:
            br.pos -= nbits - 1
            value = br.bits(nbits)
            if value >= threshold:
                value -= mx
        c = value - 1
        counts.append(c)
        remaining -= -c if c < 0 else c
        if c == 0:
            while True:
                rep = br.bits(2)
                counts.extend([0] * rep)
                if rep != 3:
                    break
        while remaining < threshold:
            nbits -= 1
            threshold >>= 1
    _need(remaining == 1, "FSE distribution does not sum to its table size")
    _need(len(counts) <= max_sym + 1, "FSE distribution has too many symbols")
    return counts, log, (br.pos + 7) >> 3


def fse_table(counts, log):
    """Decoding table: a list of (symbol, bits, base) a state."""
    size = 1 << log
    sym = [0] * size
    high = size - 1
    nxt = []
    for s, c in enumerate(counts):
        if c == -1:
            sym[high] = s
            high -= 1
            nxt.append(1)
        else:
            nxt.append(c)
    step = (size >> 1) + (size >> 3) + 3
    pos = 0
    for s, c in enumerate(counts):
        for _ in range(max(c, 0)):
            sym[pos] = s
            pos = (pos + step) & (size - 1)
            while pos > high:
                pos = (pos + step) & (size - 1)
    _need(pos == 0, "FSE spread did not return to 0")
    table = []
    for u in range(size):
        s = sym[u]
        x = nxt[s]
        nxt[s] += 1
        nb = log - (x.bit_length() - 1)
        table.append((s, nb, (x << nb) - size))
    return table, log


def _rle_table(symbol):
    return [(symbol, 0, 0)], 0


# ---- Huffman ----

def _huffman_weights(data: bytes):
    """(weights of every symbol, bytes read) from a tree description."""
    _need(len(data) >= 1, "empty Huffman description")
    hb = data[0]
    if hb < 128:
        _need(1 + hb <= len(data) and hb > 0, "truncated Huffman description")
        body = data[1:1 + hb]
        counts, log, used = read_ncount(body, 6, 255)
        table, _ = fse_table(counts, log)
        br = _Back(body[used:])
        s1, s2 = br.bits(log), br.bits(log)
        w = []
        while True:
            _need(len(w) < 255, "too many Huffman weights")
            sy, nb, base = table[s1]
            w.append(sy)
            s1 = base + br.bits(nb)
            if br.pos < 0:
                w.append(table[s2][0])
                break
            _need(len(w) < 255, "too many Huffman weights")
            sy, nb, base = table[s2]
            w.append(sy)
            s2 = base + br.bits(nb)
            if br.pos < 0:
                w.append(table[s1][0])
                break
        return w, 1 + hb
    n = hb - 127
    nbytes = (n + 1) // 2
    _need(1 + nbytes <= len(data), "truncated Huffman description")
    w = []
    for i in range(n):
        b = data[1 + i // 2]
        w.append(b >> 4 if i % 2 == 0 else b & 15)
    return w, 1 + nbytes


def huffman_table(weights):
    """(table of (symbol, bits) indexed by max_bits peeked bits, max_bits),
    the last symbol's weight implied."""
    _need(all(0 <= x <= 11 for x in weights), "Huffman weight above 11")
    total = sum(1 << (x - 1) for x in weights if x)
    _need(total > 0, "no Huffman weight")
    max_bits = total.bit_length()
    rest = (1 << max_bits) - total
    _need(rest & (rest - 1) == 0 and rest > 0,
          "Huffman weights do not complete")
    weights = list(weights) + [rest.bit_length()]
    _need(max_bits <= 11, "Huffman table log above 11")
    _need(len(weights) <= 256, "too many Huffman symbols")
    size = 1 << max_bits
    table = [None] * size
    pos = 0
    for w in range(1, max_bits + 1):
        for s, x in enumerate(weights):
            if x == w:
                span = 1 << (w - 1)
                entry = (s, max_bits + 1 - w)
                for i in range(pos, pos + span):
                    table[i] = entry
                pos += span
    _need(pos == size, "Huffman table not filled")
    return table, max_bits


def _huffman_stream(data: bytes, n: int, table, max_bits: int) -> bytearray:
    br = _Back(data)
    out = bytearray(n)
    for i in range(n):
        s, nb = table[br.peek(max_bits)]
        out[i] = s
        br.pos -= nb
    _need(br.pos == 0, "Huffman stream not read to its end")
    return out


# ---- sequences ----

LL_BASE = list(range(16)) + [16, 18, 20, 22, 24, 28, 32, 40, 48, 64, 128, 256,
                             512, 1024, 2048, 4096, 8192, 16384, 32768, 65536]
LL_BITS = [0] * 16 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13,
                      14, 15, 16]
ML_BASE = list(range(3, 35)) + [35, 37, 39, 41, 43, 47, 51, 59, 67, 83, 99,
                                131, 259, 515, 1027, 2051, 4099, 8195, 16387,
                                32771, 65539]
ML_BITS = [0] * 32 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12,
                      13, 14, 15, 16]
LL_DEFAULT = ([4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2, 2, 2, 2,
               2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1], 6)
ML_DEFAULT = ([1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
               1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
               1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1], 6)
OF_DEFAULT = ([1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
               1, 1, 1, -1, -1, -1, -1, -1], 5)
# (default distribution, largest accuracy log, largest symbol)
_KINDS = {"ll": (LL_DEFAULT, 9, 35), "of": (OF_DEFAULT, 8, 31),
          "ml": (ML_DEFAULT, 9, 52)}


class _State:
    """What a frame's blocks hand to the next: tables and repeat offsets."""

    def __init__(self):
        self.huf = None
        self.seq = {"ll": None, "of": None, "ml": None}
        self.rep = [1, 4, 8]


def _literals(block: bytes, st: _State):
    """(literal bytes, bytes of the section)."""
    b0 = block[0]
    kind, sf = b0 & 3, b0 >> 2 & 3
    if kind < 2:
        if sf in (0, 2):
            regen, hsize = b0 >> 3, 1
        elif sf == 1:
            _need(len(block) >= 2, "truncated literals header")
            regen, hsize = (b0 >> 4) + (block[1] << 4), 2
        else:
            _need(len(block) >= 3, "truncated literals header")
            regen, hsize = (b0 >> 4) + (block[1] << 4) + (block[2] << 12), 3
        _need(regen <= BLOCK_MAX, "literals exceed the block size")
        if kind == 0:
            _need(hsize + regen <= len(block), "truncated raw literals")
            return bytes(block[hsize:hsize + regen]), hsize + regen
        _need(hsize + 1 <= len(block), "truncated RLE literals")
        return bytes([block[hsize]]) * regen, hsize + 1
    hsize, bits = ((3, 10), (3, 10), (4, 14), (5, 18))[sf]
    _need(len(block) >= hsize, "truncated literals header")
    h = int.from_bytes(block[:hsize], "little") >> 4
    mask = (1 << bits) - 1
    regen, comp = h & mask, h >> bits & mask
    _need(regen <= BLOCK_MAX, "literals exceed the block size")
    _need(hsize + comp <= len(block), "truncated compressed literals")
    body = block[hsize:hsize + comp]
    if kind == 2:
        weights, used = _huffman_weights(body)
        st.huf = huffman_table(weights)
        body = body[used:]
    _need(st.huf is not None, "treeless literals without a previous table")
    table, max_bits = st.huf
    if sf == 0:
        lits = _huffman_stream(body, regen, table, max_bits)
    else:
        _need(len(body) >= 6, "truncated jump table")
        s1, s2, s3 = (int.from_bytes(body[i:i + 2], "little")
                      for i in (0, 2, 4))
        s4 = len(body) - 6 - s1 - s2 - s3
        _need(s4 > 0, "bad jump table")
        q = (regen + 3) // 4
        _need(3 * q <= regen, "four streams of too few literals")
        lits = bytearray()
        p = 6
        for i, sz in enumerate((s1, s2, s3, s4)):
            n = q if i < 3 else regen - 3 * q
            lits += _huffman_stream(body[p:p + sz], n, table, max_bits)
            p += sz
    return bytes(lits), hsize + comp


def _seq_table(kind: str, mode: int, data: bytes, p: int, st: _State):
    (default, max_log, max_sym) = _KINDS[kind]
    if mode == 0:
        t = fse_table(*default)
    elif mode == 1:
        _need(p < len(data), "truncated RLE table")
        _need(data[p] <= max_sym, "RLE symbol out of range")
        t = _rle_table(data[p])
        p += 1
    elif mode == 2:
        counts, log, used = read_ncount(data[p:], max_log, max_sym)
        t = fse_table(counts, log)
        p += used
    else:
        _need(st.seq[kind] is not None, "repeat table without a previous one")
        t = st.seq[kind]
    st.seq[kind] = t
    return t, p


def _sequences(data: bytes, st: _State):
    """Every sequence (ll, ml, offset) of a section."""
    _need(len(data) >= 1, "missing sequences header")
    b0 = data[0]
    if b0 == 0:
        _need(len(data) == 1, "bytes after an empty sequences section")
        return []
    if b0 < 128:
        nseq, p = b0, 1
    elif b0 < 255:
        _need(len(data) >= 2, "truncated sequences header")
        nseq, p = ((b0 - 128) << 8) + data[1], 2
    else:
        _need(len(data) >= 3, "truncated sequences header")
        nseq, p = data[1] + (data[2] << 8) + 0x7F00, 3
    _need(p < len(data), "missing table modes")
    modes = data[p]
    p += 1
    _need(modes & 3 == 0, "reserved bits set in the table modes")
    (llt, lll), p = _seq_table("ll", modes >> 6, data, p, st)
    (oft, ofl), p = _seq_table("of", modes >> 4 & 3, data, p, st)
    (mlt, mll), p = _seq_table("ml", modes >> 2 & 3, data, p, st)
    br = _Back(data[p:])
    sll, sof, sml = br.bits(lll), br.bits(ofl), br.bits(mll)
    rep = st.rep
    seqs = []
    for i in range(nseq):
        llc, llnb, llb = llt[sll]
        ofc, ofnb, ofb = oft[sof]
        mlc, mlnb, mlb = mlt[sml]
        _need(ofc <= 31, "offset code out of range")
        ofv = (1 << ofc) + br.bits(ofc)
        ml = ML_BASE[mlc] + br.bits(ML_BITS[mlc])
        ll = LL_BASE[llc] + br.bits(LL_BITS[llc])
        if ofv > 3:
            off = ofv - 3
            rep[2], rep[1], rep[0] = rep[1], rep[0], off
        else:
            idx = ofv - 1 + (ll == 0)
            if idx == 0:
                off = rep[0]
            else:
                off = rep[idx] if idx < 3 else rep[0] - 1
                _need(off > 0, "repeat offset of 0")
                if idx != 1:
                    rep[2] = rep[1]
                rep[1], rep[0] = rep[0], off
        seqs.append((ll, ml, off))
        if i + 1 < nseq:
            sll = llb + br.bits(llnb)
            sml = mlb + br.bits(mlnb)
            sof = ofb + br.bits(ofnb)
    _need(br.pos == 0, "sequence bitstream not read to its end")
    return seqs


def _compressed_block(block: bytes, out: bytearray, st: _State) -> None:
    lits, used = _literals(block, st)
    seqs = _sequences(block[used:], st)
    lp = 0
    for ll, ml, off in seqs:
        _need(lp + ll <= len(lits), "literal lengths exceed the literals")
        out += lits[lp:lp + ll]
        lp += ll
        _need(off <= len(out), "offset before the start of the output")
        start = len(out) - off
        if off >= ml:
            out += out[start:start + ml]
        else:
            for k in range(ml):
                out.append(out[start + k])
    out += lits[lp:]


def decode_frame(frame: bytes) -> bytes:
    """The content of one frame that fills `frame` exactly."""
    frame = bytes(frame)
    hdr = frame_header(frame)
    _need(hdr["dict_id"] == 0, "frame needs a dictionary")
    p = hdr["header_size"]
    block_max = min(BLOCK_MAX, hdr["window_size"] or BLOCK_MAX)
    out = bytearray()
    st = _State()
    while True:
        _need(p + 3 <= len(frame), "truncated block header")
        bh = int.from_bytes(frame[p:p + 3], "little")
        p += 3
        last, btype, size = bh & 1, bh >> 1 & 3, bh >> 3
        _need(btype != 3, "reserved block type")
        before = len(out)
        if btype == 0:
            _need(p + size <= len(frame), "truncated raw block")
            out += frame[p:p + size]
            p += size
        elif btype == 1:
            _need(p + 1 <= len(frame), "truncated RLE block")
            out += frame[p:p + 1] * size
            p += 1
        else:
            _need(size <= block_max and p + size <= len(frame),
                  "compressed block too large or truncated")
            _compressed_block(frame[p:p + size], out, st)
            p += size
        _need(len(out) - before <= block_max, "block decodes past its size")
        if last:
            break
    p += 4 if hdr["has_checksum"] else 0
    _need(p == len(frame), "bytes after the frame's end")
    if hdr["content_size"] is not None:
        _need(len(out) == hdr["content_size"], "content size mismatch")
    return bytes(out)
