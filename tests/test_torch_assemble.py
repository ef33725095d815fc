"""The encode plane's frame assembly (ops/assemble.py) against the JAX
package.

``assemble_model`` is a numpy copy of ``csrc/assemble.cu``'s algorithm:
the three FSE state chains by segment map composition (``_chain``: the
steps cut as the kernel's ``chain_cut`` cuts them, each segment's map
composed over every entry state, the composites crossed from the last
sequence's init state, each segment walked from its entry state; the
emission at i is the incoming state and its width), every field's width
before any byte (prefix sums over the
sequences in emission order and over each Huffman quarter's symbols), the
sizes and sections from those, and every field ORed into the row's u32
words at its final bit offset after the fixed-form bytes.  It and the
port's plain version (``assemble_plain``) are held to the JAX package's
``_assembly_phase`` (traced with x64 off, as the device encoder traces
it): rows and lengths exactly equal.  The operands are the plane's own:
``torch_assemble_cases.assemble_call`` records the call that
``device_encode.encode_frames_device`` makes on the CPU (its parse and its
host table builders) for ``torch_assemble_cases.assemble_records``' edge
lanes, at the 4 KB bucket and in one 16 KB case, one lane of each rolled
back to the predefined tables (``torch_assemble_cases.roll_back``).
"""

import jax
import numpy as np
import pytest
import torch

from zstdsharp_tpu.ops import device_encode as ref
from zstdsharp_tpu_torch.kernel_bench import (ASSEMBLE_ARGS, assemble_lane,
                                             run_assemble)
from zstdsharp_tpu_torch.ops import assemble as asm
from zstdsharp_tpu_torch.ops import device_encode as de

from torch_assemble_cases import (CHAIN_NSEQ, CHAIN_S, assemble_call,
                                  assemble_records, pad_records, roll_back)

M32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# the kernel's algorithm in numpy
# ---------------------------------------------------------------------------

def _highbit(v):
    v = np.maximum(np.asarray(v, np.int64), 1)
    return np.floor(np.log2(v.astype(np.float64))).astype(np.int64)


def _or_fields(words, base, pos, v, nb, wlim):
    """The kernel's put_field, vectorised: each value masked to its width
    at stream bit pos (u32) of a stream starting at row bit `base`, a half
    whose stream word is at or past `wlim` dropped, ORed into `words`
    (uint64 holding u32 row words)."""
    pos = np.asarray(pos, np.uint64) & np.uint64(M32)
    v = np.asarray(v, np.uint64) & np.uint64(M32)
    nb = np.asarray(nb, np.uint64) & np.uint64(M32)
    mask = np.where(nb >= 32, np.uint64(M32),
                    (np.uint64(1) << np.minimum(nb, 31)) - np.uint64(1))
    v = v & mask
    widx = (pos >> np.uint64(5)).astype(np.int64)
    keep = (v != 0) & (widx < wlim)
    f = v << (pos & np.uint64(31))
    f = np.where(widx + 1 >= wlim, f & np.uint64(M32), f)
    r0 = base + 32 * widx
    r = (r0 & 31).astype(np.uint64)
    w0 = r0 >> 5
    lo, hi = f & np.uint64(M32), f >> np.uint64(32)
    x0 = (lo << r) & np.uint64(M32)
    x1 = np.where(r > 0, (lo >> (np.uint64(32) - r)) | (hi << r), hi) \
        & np.uint64(M32)
    x2 = np.where(r > 0, hi >> (np.uint64(32) - r), np.uint64(0))
    for k, x in enumerate((x0, x1, x2)):
        at = keep & (x != 0) & (w0 + k < len(words))
        np.bitwise_or.at(words, w0[at] + k, x[at])


def _walk(codes, ns, maps, nbs, init):
    """One stream's state chain as the kernel's thread walks it: from
    init[c[ns-1]], i = ns-2 down to 0, emit (incoming state, its width)
    and step.  Returns (state [ns], width [ns], flush)."""
    nsym, ts = maps.shape
    top = nsym - 1
    state = np.zeros(ns, np.int64)
    width = np.zeros(ns, np.int64)
    if ns < 1:
        return state, width, 0
    u = int(np.clip(init[min(int(codes[ns - 1]), top)], 0, ts - 1))
    for i in range(ns - 2, -1, -1):
        c = min(int(codes[i]), top)
        state[i], width[i] = u, nbs[c, u]
        u = int(np.clip(maps[c, u], 0, ts - 1))
    return state, width, u


def chain_cut(n):
    """The kernel's chain_cut: (segments G, steps a segment L, segments
    holding a step) for a chain of n steps."""
    g = 32 if n <= 4096 else (64 if n <= 16384 else 128)
    length = (-(-n // g) + 3) & ~3
    return g, length, (-(-n // length) if length else 0)


def _chain(codes, ns, maps, nbs, init):
    """One stream's state chain as the kernel computes it: the steps i =
    ns-2 ... 0 cut into segments (``chain_cut``), (a) each segment's map
    composed over every entry state (all segments at once), (b) the
    composites crossed from init[c[ns-1]], the last segment first, (c)
    each segment walked from its entry state.  Returns (state [ns], width
    [ns], flush), as ``_walk``."""
    nsym, ts = maps.shape
    c = np.minimum(np.asarray(codes[:max(ns, 0)], np.int64), nsym - 1)
    nxt = np.clip(maps, 0, ts - 1).astype(np.int64)
    state = np.zeros(max(ns, 0), np.int64)
    width = np.zeros(max(ns, 0), np.int64)
    if ns < 1:
        return state, width, 0
    n = ns - 1
    _, length, used = chain_cut(n)
    lo = np.arange(used) * length
    hi = np.minimum(lo + length, n)
    # (a) compose: f[j][x] = the state leaving segment j entered at x
    f = np.tile(np.arange(ts), (used, 1))
    for t in range(length):
        i = hi - 1 - t
        on = i >= lo
        f[on] = nxt[c[i[on]][:, None], f[on]]
    # (b) cross, the last segment first
    u = int(np.clip(init[c[ns - 1]], 0, ts - 1))
    entry = np.zeros(used, np.int64)
    for j in range(used - 1, -1, -1):
        entry[j] = u
        u = int(f[j, u])
    # (c) walk each segment from its entry state
    v = entry.copy()
    for t in range(length):
        i = hi - 1 - t
        on = i >= lo
        ci = c[i[on]]
        state[i[on]] = v[on]
        width[i[on]] = nbs[ci, v[on]]
        v[on] = nxt[ci, v[on]]
    return state, width, u


def _lane_model(c, b, t):
    """Lane b's row and out_len, as the kernel builds them."""
    blocks = c["blocks"]
    N = blocks.shape[1]
    OUT = N + 16
    S = c["parsed"]["starts"].shape[1]
    W, WQ = c["W"], c["WQ"]
    nv = int(c["n_valid"][b])
    ns_raw = int(c["parsed"]["nseq"][b])
    ns = min(max(ns_raw, 0), S)
    lc = int(c["lit_count"][b])
    codes_h, nbits_h, desc, dlen, ok = (a[b] for a in c["huf"])
    dlen, hok = int(dlen), bool(ok)
    tl, mode = int(c["seq"]["tbl_len"][b]), int(c["seq"]["mode"][b])
    lit = c["lit_sorted"][b]

    # values and codes of the live sequences
    st, ml, of = (c["parsed"][k][b, :ns].astype(np.int64)
                  for k in ("starts", "mls", "offs"))
    i = np.arange(ns)
    prev_end = np.concatenate([[0], (st + ml)[:-1]])[:ns]
    prev_off = np.concatenate([[0], of[:-1]])[:ns]
    ll = st - prev_end
    mlv = ml - 3
    ofb = np.where((i > 0) & (of == prev_off) & (ll > 0), 1, of + 3)
    llc = np.where(ll > 63, _highbit(ll) + 19, t["ll_lut"][np.clip(ll, 0, 63)])
    mlc = np.where(mlv > 127, _highbit(mlv) + 36,
                   t["ml_lut"][np.clip(mlv, 0, 127)])
    ofc = _highbit(ofb)
    code = {"ll": llc, "of": ofc, "ml": mlc}

    # the three chains by segment map composition
    chain = {}
    for name in asm.STREAMS:
        maps, nbs, init, _ = (a[b] for a in c["seq"][name])
        chain[name] = _chain(code[name], ns, maps, nbs, init)
    fl = {name: (int(c["seq"][name][3][b]) & M32) if ns_raw > 0 else 0
          for name in asm.STREAMS}

    # the sequence fields in emission order, widths first
    live = i <= ns - 2
    ts = {name: c["seq"][name][0].shape[2] for name in asm.STREAMS}
    cols_v = [ts[n] + chain[n][0] for n in ("of", "ml", "ll")] + [ll, mlv, ofb]
    cols_w = [np.where(live, chain[n][1], 0) for n in ("of", "ml", "ll")] + [
        t["ll_bits"][np.minimum(llc, 35)], t["ml_bits"][np.minimum(mlc, 52)],
        ofc]
    sv = np.stack(cols_v, 1)[::-1].reshape(-1)
    sw = np.stack(cols_w, 1)[::-1].reshape(-1).astype(np.int64)
    tail_v = [chain[n][2] for n in ("ml", "of", "ll")]
    tail_w = [fl[n] for n in ("ml", "of", "ll")]
    fv = np.concatenate([sv, tail_v]).astype(np.int64)
    fw = np.concatenate([sw, tail_w]).astype(np.int64)
    fpos = (np.cumsum(fw) - fw) & M32
    seq_bits = (int(fw.sum()) + 1) & M32
    bits_len = (seq_bits + 7) >> 3

    # the Huffman quarters, widths first
    seg = max((lc + 3) >> 2, 1)
    segmax = N // 4 + 1
    quarters = []
    for q in range(4):
        seglen = seg if q < 3 else lc - 3 * seg
        n_q = min(max(seglen, 0), segmax)
        src = np.clip(q * seg + seglen - 1 - np.arange(n_q), 0, N - 1)
        sym = lit[src].astype(np.int64)
        hw = (nbits_h[sym].astype(np.int64) & M32) if hok and ns_raw > 0 \
            else np.zeros(n_q, np.int64)
        quarters.append((sym, hw))
    htot = [(int(hw.sum()) + 1) & M32 for _, hw in quarters]
    sl = [(h + 7) >> 3 for h in htot]

    # the sizes
    comp_lit = dlen + 6 + sum(sl)
    use_huf = hok and 5 + comp_lit < 3 + lc and ns_raw > 0
    lit_sec = 5 + comp_lit if use_huf else 3 + lc
    body = lit_sec + 3 + tl + bits_len
    comp_total, raw_total = 12 + body, 12 + nv
    use_raw = ns_raw == 0 or comp_total >= raw_total
    out_len = raw_total if use_raw else comp_total
    seq_at = 12 + lit_sec + 3 + tl
    s0_at = 12 + 5 + dlen + 6

    # the fixed-form bytes
    row = np.zeros(OUT, np.uint8)

    def put(pos, v):
        if 0 <= pos < OUT:
            row[pos] = v & 0xFF

    for j, m in enumerate((0x28, 0xB5, 0x2F, 0xFD, 0xA0)):
        put(j, m)
    for j in range(4):
        put(5 + j, (nv & M32) >> (8 * j))
    bh = 1 | ((0 if use_raw else 2) << 1) | ((nv if use_raw else body) << 3)
    for j in range(3):
        put(9 + j, bh >> (8 * j))
    if use_raw:
        n_copy = min(max(nv, 0), N)
        row[12:12 + n_copy] = blocks[b, :n_copy]
    else:
        if use_huf:
            lu, cu = lc & M32, comp_lit & M32
            for j, v in enumerate(((2 | (3 << 2)) | ((lu & 0xF) << 4),
                                   lu >> 4,
                                   ((lu >> 12) & 0x3F) | ((cu & 3) << 6),
                                   cu >> 2, cu >> 10)):
                put(12 + j, v)
            for k in range(dlen):
                put(17 + k, int(desc[min(k, desc.shape[0] - 1)]))
            for q in range(3):
                put(s0_at - 6 + 2 * q, sl[q])
                put(s0_at - 5 + 2 * q, sl[q] >> 8)
        else:
            lh = (3 << 2) | (lc << 4)
            for j in range(3):
                put(12 + j, lh >> (8 * j))
            for k in range(lc):
                put(15 + k, int(lit[min(k, N - 1)]))
        put(12 + lit_sec, 128 + (ns_raw >> 8))
        put(13 + lit_sec, ns_raw)
        put(14 + lit_sec, mode)
        tbl = c["seq"]["tbl"][b]
        for k in range(tl):
            put(15 + lit_sec + k, int(tbl[min(k, tbl.shape[0] - 1)]))

        # the bitstreams at their final bit offsets
        words = row.view("<u4").astype(np.uint64)
        _or_fields(words, 8 * seq_at, fpos, fv, fw, W)
        _or_fields(words, 8 * seq_at, [seq_bits - 1], [1], [1], W)
        if use_huf:
            at = s0_at
            for q, (sym, hw) in enumerate(quarters):
                hpos = (np.cumsum(hw) - hw) & M32
                _or_fields(words, 8 * at, hpos,
                           codes_h[sym].astype(np.int64) & M32, hw, WQ)
                _or_fields(words, 8 * at, [htot[q] - 1], [1], [1], WQ)
                at += sl[q]
        row = words.astype("<u4").view(np.uint8).copy()

        # a stream cut at its capacity repeats its last kept byte
        if bits_len > 4 * W:
            last = row[min(seq_at + 4 * W - 1, OUT - 1)]
            for k in range(4 * W, bits_len):
                put(seq_at + k, int(last))
        if use_huf:
            at = s0_at
            for q in range(4):
                if sl[q] > 4 * WQ:
                    last = row[min(at + 4 * WQ - 1, OUT - 1)]
                    for k in range(4 * WQ, sl[q]):
                        put(at + k, int(last))
                at += sl[q]
    row[min(max(out_len, 0), OUT):] = 0
    return row, out_len


def assemble_model(call):
    """The kernel's rows and out_len for a ``capture_assemble`` record,
    numpy in and out."""
    c = _numpy(call)
    t = de._tables()
    B = c["blocks"].shape[0]
    out = [_lane_model(c, b, t) for b in range(B)]
    return (np.stack([r for r, _ in out]),
            np.array([n for _, n in out], np.int32))


# ---------------------------------------------------------------------------
# operands: the plane's own call, and the JAX program on them
# ---------------------------------------------------------------------------

def _numpy(call):
    def conv(v):
        if isinstance(v, torch.Tensor):
            return v.numpy()
        if isinstance(v, tuple):
            return tuple(conv(x) for x in v)
        if isinstance(v, dict):
            return {k: conv(x) for k, x in v.items()}
        return v

    return conv(call)


def _reference(call):
    """The JAX ``_assembly_phase`` on the call's operands (as the
    reference's ``encode_frames_device`` passes them: u32 Huffman codes and
    widths)."""
    c = _numpy(call)
    p, (hc, hn, hd, hl, hk), sq = c["parsed"], c["huf"], c["seq"]
    tables = [a for name in ("ll", "of", "ml") for a in sq[name]]
    with jax.enable_x64(False):
        rows, lens = ref._assembly_phase(
            c["blocks"], c["n_valid"], p["starts"], p["mls"], p["offs"],
            p["nseq"], c["lit_sorted"], c["lit_count"], hc.astype(np.uint32),
            hn.astype(np.uint32), hd, hl, hk, *tables, sq["mode"], sq["tbl"],
            sq["tbl_len"], p["starts"].shape[1], c["W"], c["WQ"])
        return np.asarray(rows), np.asarray(lens)


def _capture(recs, n, huf_literals=True):
    """The plane's one assemble call on the records padded to n."""
    blocks, nv = pad_records(recs, n)
    return assemble_call(torch.from_numpy(blocks), torch.from_numpy(nv),
                         huf_literals)


@pytest.fixture(scope="module")
def calls():
    out = {"4k": _capture(assemble_records(4096, 1), 4096),
           "4k_raw_literals": _capture(assemble_records(4096, 2), 4096, False),
           "16k": _capture([r for k, r in enumerate(assemble_records(16384, 3))
                            if k in (0, 2, 6, 7, 8, 9, 10, 13)], 16384)}
    for c in out.values():
        ns, mode = c["parsed"]["nseq"].numpy(), c["seq"]["mode"].numpy()
        roll_back(c, int(np.flatnonzero((ns >= 32) & (mode > 0))[-1]))
    return out


CASES = ["4k", "4k_raw_literals", "16k"]


@pytest.fixture(scope="module")
def references(calls):
    return {k: _reference(c) for k, c in calls.items()}


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------

def test_edge_lanes_are_present(calls):
    """The chunks hold every lane kind the kernel must get right."""
    c = calls["4k"]
    S = c["parsed"]["starts"].shape[1]
    ns = c["parsed"]["nseq"].numpy()
    nv = c["n_valid"].numpy()
    lc = c["lit_count"].numpy()
    mode = c["seq"]["mode"].numpy()
    _, lens = run_assemble(c, asm.assemble_plain)
    raw = lens.numpy() == 12 + nv
    assert {0, 1, 2, S} <= set(ns.tolist())
    assert {0, 1, 4096} <= set(nv.tolist())
    assert ((lc < 64) & (ns > 0) & ~raw).any()
    assert (raw & (ns > 0)).any() and (raw & (ns == 0)).any()
    fields = np.stack([(mode >> s) & 3 for s in (6, 4, 2)])
    assert (fields == 1).any() and (fields == 2).any()  # RLE and fresh
    assert ((ns >= 32) & (mode == 0)).any()          # rolled back
    assert c["huf"][4].any() and not calls["4k_raw_literals"]["huf"][4].any()
    assert int(calls["16k"]["parsed"]["nseq"].max()) == de.seq_budget(16384)


@pytest.mark.parametrize("case", CASES)
def test_model_equals_reference(calls, references, case):
    rows, lens = assemble_model(calls[case])
    want_rows, want_lens = references[case]
    assert np.array_equal(lens, want_lens)
    assert np.array_equal(rows, want_rows)


@pytest.mark.parametrize("case", CASES)
def test_plain_equals_reference(calls, references, case):
    rows, lens = run_assemble(calls[case], asm.assemble_plain)
    want_rows, want_lens = references[case]
    assert rows.dtype == torch.uint8 and lens.dtype == torch.int32
    assert np.array_equal(lens.numpy(), want_lens)
    assert np.array_equal(rows.numpy(), want_rows)


@pytest.mark.parametrize("W,WQ", [(3, 2000), (400, 5), (1, 1)])
def test_model_equals_plain_when_streams_are_cut(calls, W, WQ):
    """Capacities below the streams' lengths: halves past them dropped and
    the bytes past them repeating the last kept byte, in both."""
    c = dict(calls["4k"], W=W, WQ=WQ)
    rows, lens = assemble_model(c)
    want_rows, want_lens = run_assemble(c, asm.assemble_plain)
    assert np.array_equal(lens, want_lens.numpy())
    assert np.array_equal(rows, want_rows.numpy())


def test_model_equals_plain_on_one_lane(calls):
    """assemble_lane (the serial-floor operands) keeps the lane's row."""
    c = calls["16k"]
    lane = int(c["parsed"]["nseq"].argmax())
    one = assemble_lane(c, lane)
    rows, lens = run_assemble(one, asm.assemble_plain)
    all_rows, all_lens = run_assemble(c, asm.assemble_plain)
    assert torch.equal(rows[0], all_rows[lane]) and lens[0] == all_lens[lane]
    m_rows, m_lens = assemble_model(one)
    assert np.array_equal(m_rows, rows.numpy())
    assert np.array_equal(m_lens, lens.numpy())


@pytest.mark.parametrize("name", asm.STREAMS)
def test_serial_walk_equals_map_composition(name):
    """The chain walked back to front gives _fse_stream_states's emissions
    and flush, including nseq 0, 1 and 2 and nseq = S."""
    rng = np.random.default_rng(4)
    st = de._tables()[name]
    nsym, ts = st["maps"].shape
    S = 300
    codes = rng.integers(0, nsym, (6, S)).astype(np.int32)
    nseq = np.array([0, 1, 2, 3, 150, S], np.int32)
    val, nb, fin = de._fse_stream_states(torch.from_numpy(codes),
                                         torch.from_numpy(nseq), st)
    for b, ns in enumerate(nseq):
        state, width, flush = _walk(codes[b], int(ns), st["maps"], st["nbs"],
                                    st["init"])
        live = np.arange(S) <= ns - 2
        assert np.array_equal(nb[b].numpy(), np.where(live, np.pad(
            width, (0, S - ns)), 0))
        assert np.array_equal(val[b].numpy()[live], ts + state[live[:ns]])
        assert int(fin[b]) == flush


def test_chain_cases_cross_the_cut_edges():
    """CHAIN_NSEQ hits what it names in chain_cut."""
    cuts = {ns: chain_cut(max(ns - 1, 0)) for ns in CHAIN_NSEQ}
    assert [cuts[ns] for ns in (4, 5, 6)] == [(32, 4, 1)] * 2 + [(32, 4, 2)]
    assert cuts[129] == (32, 4, 32) and cuts[130] == (32, 8, 17)
    assert cuts[4097][0] == 32 and cuts[4098][0] == 64
    assert cuts[16385][0] == 64 and cuts[16386][0] == 128
    assert cuts[CHAIN_S][2] <= 128


@pytest.mark.parametrize("ns", CHAIN_NSEQ)
@pytest.mark.parametrize("name", asm.STREAMS)
def test_chain_model_equals_walk_and_composition(name, ns):
    """The kernel's chain (``_chain``) gives the serial walk's states,
    widths and flush, and ``_fse_stream_states``'s emissions and flush,
    over a 128 KB-sized S with a fifth of the codes past the table's
    symbols (clamped to the last)."""
    st = de._tables()[name]
    nsym, ts = st["maps"].shape
    rng = np.random.default_rng(7 * ns + nsym)
    codes = rng.integers(0, nsym, CHAIN_S)
    hit = rng.random(CHAIN_S) < 0.2
    codes[hit] = rng.integers(nsym, 256, int(hit.sum()))
    got = _chain(codes, ns, st["maps"], st["nbs"], st["init"])
    want = _walk(codes, ns, st["maps"], st["nbs"], st["init"])
    assert all(np.array_equal(g, w) for g, w in zip(got, want))
    state, width, flush = got
    val, nb, fin = de._fse_stream_states(
        torch.from_numpy(codes[None].astype(np.int32)),
        torch.tensor([ns], dtype=torch.int32), st)
    live = np.arange(CHAIN_S) <= ns - 2
    assert np.array_equal(nb[0].numpy(), np.where(live, np.pad(
        width, (0, CHAIN_S - ns)), 0))
    assert np.array_equal(val[0].numpy()[live], ts + state[live[:ns]])
    assert int(fin[0]) == flush


def test_assemble_dispatches_plain_on_cpu(calls):
    c = calls["4k"]
    before = asm.assemble_lanes.launches
    rows, lens = asm.assemble(*(c[k] for k in ASSEMBLE_ARGS))
    want_rows, want_lens = run_assemble(c, asm.assemble_plain)
    assert torch.equal(rows, want_rows) and torch.equal(lens, want_lens)
    assert asm.assemble_lanes.launches == before


def test_assemble_lanes_raises_off_the_card(calls):
    """The kernel wrapper takes CUDA tensors only: CPU tensors raise (the
    plane routes them to assemble_plain), and so do bad operands."""
    c = calls["4k"]
    args = [c[k] for k in ASSEMBLE_ARGS]
    with pytest.raises(ValueError, match="no CUDA kernel"):
        asm.assemble_lanes(*args)
    bad = list(args)
    bad[0] = args[0][0]
    with pytest.raises(ValueError):
        asm.assemble_lanes(*bad)
    bad = list(args)
    bad[0] = args[0].to(torch.int32)
    with pytest.raises(TypeError):
        asm.assemble_lanes(*bad)
    bad = list(args)
    bad[1] = args[1][:3]
    with pytest.raises(ValueError):
        asm.assemble_lanes(*bad)
    bad = list(args)
    bad[0] = torch.zeros(args[0].shape[0], 4000, dtype=torch.uint8)
    with pytest.raises(ValueError):
        asm.assemble_lanes(*bad)
    bad = list(args)
    bad[5] = (*args[5][:4], args[5][4].to(torch.uint8))
    with pytest.raises(TypeError):
        asm.assemble_lanes(*bad)
    with pytest.raises(ValueError):
        asm.assemble_lanes(*args[:7], 0, args[8])
