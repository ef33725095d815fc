"""The encode plane's parse (ops/lz_parse.py) against the JAX package.

``parse_model`` is a numpy copy of ``csrc/lz_parse.cu``'s algorithm: the
hash table of last positions walked 32 positions a step (a lane's
candidate is the highest lower lane of its equal-hash group, else the
table; the group's highest lane writes the table), the match lengths
along diagonals (32-position tiles walked backward, extending only at a
diagonal's last position, each warp's run joined to the next by a
reverse scan), the greedy walk by jump bytes over the valid-position
bitmask and its one-bit-a-word summary, cut into 32 segments walked at
once and stitched by the true walk up to where it meets each, and the
compaction through the literal words' prefix sums.  It and the port's
plain version (``_parse_phase`` / ``parse_blocks_ptrjump`` on CPU tensors)
are held to the JAX package's ``_parse_phase`` and ``parse_blocks_ptrjump``
(traced with x64 off, as the device encoder traces them): every output is
an integer or bool array and must be exactly equal.  The derived lengths
are also held to the reference's rounds (``_match_lengths``) at every
position.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zstdsharp_tpu.ops import device_encode as ref_de
from zstdsharp_tpu.ops import matcher as ref_m
from zstdsharp_tpu_torch.ops import device_encode as de
from zstdsharp_tpu_torch.ops import lz_parse as lp
from zstdsharp_tpu_torch.ops import matcher as tm
from torch_parse_cases import DIAGONAL_CASES, diagonal_rows, parse_rows

PRIME = 2654435761
FULL = 0xFFFFFFFF
WARPS = 32               # csrc/lz_parse.cu kWarps
PARSE_KEYS = lp.PARSE_KEYS


# ---------------------------------------------------------------------------
# the kernel's algorithm in numpy
# ---------------------------------------------------------------------------

def _ctz(x: np.ndarray) -> np.ndarray:
    """Trailing zeros of u32 values (32 for 0)."""
    x = x.astype(np.uint64)
    low = x & (np.uint64(0) - x) & np.uint64(FULL)
    out = np.full(x.shape, 32, np.int64)
    nz = low != 0
    out[nz] = np.log2(low[nz].astype(np.float64)).astype(np.int64)
    return out


def _match_lengths(v32, i, j, cap, u64_rounds, stride_rounds):
    """Each position's rounds, as one thread of pass 2 runs them (an
    inactive position's rounds change nothing, so they stop)."""
    ln = np.zeros(len(i), np.int64)
    act = np.ones(len(i), bool)

    def at(p):
        return v32[np.minimum(p, cap)]

    def u64_phase(rounds):
        nonlocal ln, act
        for _ in range(rounds):
            if not act.any():
                break
            x0 = at(i + ln) ^ at(j + ln)
            x1 = at(i + ln + 4) ^ at(j + ln + 4)
            step = np.where(x0 != 0, _ctz(x0) >> 3,
                            4 + np.minimum(_ctz(x1) >> 3, 4))
            ln = np.where(act, ln + step, ln)
            act = act & (x0 == 0) & (x1 == 0)

    u64_phase(u64_rounds)
    if stride_rounds:
        for _ in range(stride_rounds):
            if not act.any():
                break
            eq = act.copy()
            for k in range(0, 64, 4):
                eq &= at(i + ln + k) == at(j + ln + k)
            ln = np.where(eq, ln + 64, ln)
            act = eq
        act = np.ones(len(i), bool)
        u64_phase(8)
    return ln


def _highbit(v: int) -> int:
    return max(v, 1).bit_length() - 1


def _reach(u64_rounds, stride_rounds, n):
    """The rounds' cap (8 u64 + 64 stride + 64 with strides), at most n."""
    reach = 8 * u64_rounds + (64 * stride_rounds + 64 if stride_rounds
                              else 0)
    return min(reach, n)


def _common_length(row, i, c, lim):
    """min(L, lim): L the common length of the row at i and at c < i."""
    diff = np.nonzero(row[i:i + lim] != row[c:c + lim])[0]
    return int(diff[0]) if len(diff) else lim


def _compose(a, b, cap):
    """A run's length as a function of the length x after it: a >= 0 the
    constant a, a < 0 min(x - 1 - a, cap); a's positions before b's."""
    if a >= 0:
        return a
    if b >= 0:
        return min(b - 1 - a, cap)
    return a + b + 1


def _v32(row):
    b = np.concatenate([row, np.zeros(3, np.uint8)]).astype(np.uint32)
    N = len(row)
    return (b[:N] | (b[1:N + 1] << 8) | (b[2:N + 2] << 16)
            | (b[3:N + 3] << 24)).astype(np.uint32)


def _table_walk(v32, cnt, hash_log):
    """Pass 1: the table walk, 32 positions a step."""
    N = len(v32)
    h = ((v32.astype(np.uint64) * PRIME) & FULL) >> (32 - hash_log)
    table = np.full(1 << hash_log, -1, np.int64)
    cand = np.full(N, -1, np.int64)
    for base in range(0, cnt, 32):
        hs = h[base:min(base + 32, cnt)].astype(np.int64)
        n = len(hs)
        eq = hs[:, None] == hs[None, :]
        lower = np.tril(eq, -1)
        highest_lower = n - 1 - np.argmax(lower[:, ::-1], 1)
        cand[base:base + n] = np.where(lower.any(1), base + highest_lower,
                                       table[hs])
        leader = ~np.triu(eq, 1).any(1)
        table[hs[leader]] = base + np.nonzero(leader)[0]
    return cand


def _derived_lengths(row, cand, cnt, cap):
    """Pass 2's lengths min(L, cap) at every walked position with a
    candidate (-1 elsewhere): each position's function of the length
    after it (a diagonal's last position extends, the others step a byte),
    composed backward over each warp's run of 32-position tiles, and the
    runs joined by the reverse scan of their functions."""
    N = len(row)
    f = np.full(N, -1, np.int64)
    for i in range(cnt):
        c = int(cand[i])
        cn = int(cand[i + 1]) if i + 1 < cnt else -1
        if c < 0:
            f[i] = 0
        elif cn != c + 1:
            f[i] = _common_length(row, i, c, min(cap, N - i))
        else:
            f[i] = 0 if row[i] != row[c] else -2
    ntile = -(-cnt // 32)
    tpw = -(-ntile // WARPS)
    runs = []
    F = np.full(N, -1, np.int64)
    for w in range(WARPS):
        lo, hi = min(w * tpw, ntile) * 32, min(w * tpw + tpw, ntile) * 32
        suf = -1
        for i in range(min(hi, cnt) - 1, lo - 1, -1):
            suf = _compose(int(f[i]), suf, cap)
            F[i] = suf
        runs.append((lo, min(hi, cnt), suf))
    out = np.full(N, -1, np.int64)
    after = -1
    for lo, hi, total in reversed(runs):
        x_end = after if after >= 0 else min(-1 - after, cap)
        g = F[lo:hi]
        out[lo:hi] = np.where(g >= 0, g, np.minimum(x_end - 1 - g, cap))
        after = _compose(total, after, cap)
    out[:cnt][cand[:cnt] < 0] = -1
    return out


def _model_lane(row, nv, S, hash_log, u64_rounds, stride_rounds, luts,
                compact):
    N = len(row)
    nw = (N + 31) // 32
    # pass 0: v32 with zeros past N
    v32 = _v32(row)
    cnt = max(0, min(N, nv - 3))
    # pass 1: the table walk, 32 positions a step
    cand = _table_walk(v32, cnt, hash_log)

    # pass 2: lengths along diagonals, validity, the bitmask
    ln = _derived_lengths(row, cand, cnt, _reach(u64_rounds, stride_rounds,
                                                 N))
    i = np.arange(cnt)
    c = cand[:cnt]
    ml = np.zeros(N, np.int64)
    ml[:cnt] = np.minimum(ln[:cnt], nv - i)
    valid = np.zeros(nw * 32, bool)
    # a length of 4 or more holds the first 4 bytes equal: v32 agrees
    valid[:cnt] = (c >= 0) & (ml[:cnt] >= 4)
    vmask = [int(w) for w in np.packbits(
        valid.reshape(nw, 32)[:, ::-1], axis=1).view(">u4")[:, 0]]
    # and its summary (bit x of summary[g]: word 32 g + x has a valid
    # position)
    ng = (nw + 31) // 32
    summary = [sum(1 << x for x in range(32)
                   if 32 * g + x < nw and vmask[32 * g + x])
               for g in range(ng)]

    def first_bit(x):
        return (x & -x).bit_length() - 1

    def next_valid(pos):
        if pos >= N:
            return N
        w = pos >> 5
        word = vmask[w] & ((FULL << (pos & 31)) & FULL)
        if word:
            return (w << 5) + first_bit(word)
        q = w + 1
        g = q >> 5
        sw = summary[g] & ((FULL << (q & 31)) & FULL) if q < nw else 0
        while sw == 0 and g + 1 < ng:
            g += 1
            sw = summary[g]
        if sw == 0:
            return N
        w = (g << 5) + first_bit(sw)
        return (w << 5) + first_bit(vmask[w])

    # pass 3: the jump bytes (the next valid position at or past min(j +
    # ml, N) in that word or the next, 255 where it is not there or too
    # far), then 32 segments walked as if a cursor entered each at its
    # start, and the true walk across them until it meets each segment's
    jump = {}
    for j in map(int, np.nonzero(valid)[0]):
        t = min(j + int(ml[j]), N)
        nx = None
        if t >= N:
            nx = N
        else:
            w = t >> 5
            word = vmask[w] & ((FULL << (t & 31)) & FULL)
            if word:
                nx = (w << 5) + first_bit(word)
            elif w + 1 >= nw:
                nx = N
            elif vmask[w + 1]:
                nx = ((w + 1) << 5) + first_bit(vmask[w + 1])
        jump[j] = 255 if nx is None else min(nx - j - 4, 255)

    def next_match(j):
        d = jump[j]
        return j + 4 + d if d < 255 else next_valid(min(j + int(ml[j]), N))

    seg = 32 * -(-nw // 32)
    spec, exits = set(), []
    for k in range(32):
        s, e = min(k * seg, N), min(k * seg + seg, N)
        j = next_valid(s)
        while j < e:
            spec.add(j)
            j = next_match(j)
        exits.append(j)
    true, conv = set(), []
    j = next_valid(0)
    for k in range(32):
        e = min(k * seg + seg, N)
        conv.append(e)
        while j < e:
            if j in spec:
                conv[k] = j
                j = exits[k]
                break
            true.add(j)
            j = next_match(j)
    sel = np.zeros(N + 1, bool)
    sel[[j for j in spec if j >= conv[j // seg]]] = True
    sel[list(true)] = True
    starts = [int(j) for j in np.nonzero(sel[:N])[0][:S]]
    mls = [int(ml[j]) for j in starts]
    nseq = len(starts)
    out = {"nseq": nseq, "lit_count": nv - sum(mls)}
    pad = S - nseq
    offs = [j - int(cand[j]) for j in starts]
    out["starts"] = np.array(starts + [N] * pad, np.int32)
    out["mls"] = np.array(mls + [0] * pad, np.int32)
    out["offs"] = np.array(offs + [0] * pad, np.int32)

    # pass 4: covered bits, codes, the literal permutation
    cov = np.zeros(nw * 32, bool)
    for j, mj in zip(starts, mls):
        cov[j:min(j + mj, N)] = True
    out["covered"] = cov[:N].copy()
    if not compact:
        return out
    ll_lut, ml_lut = luts
    hist = {"ll_hist": np.zeros(36, np.int32),
            "of_hist": np.zeros(32, np.int32),
            "ml_hist": np.zeros(53, np.int32)}
    for k in range(nseq):
        prev_end = starts[k - 1] + mls[k - 1] if k else 0
        prev_off = offs[k - 1] if k else 0
        ll, mlv = starts[k] - prev_end, mls[k] - 3
        ofb = 1 if (k and offs[k] == prev_off and ll > 0) else offs[k] + 3
        llc = _highbit(ll) + 19 if ll > 63 else int(ll_lut[min(max(ll, 0),
                                                               63)])
        mlc = _highbit(mlv) + 36 if mlv > 127 else int(
            ml_lut[min(max(mlv, 0), 127)])
        for name, code in (("ll_hist", llc), ("of_hist", _highbit(ofb)),
                           ("ml_hist", mlc)):
            if 0 <= code < len(hist[name]):
                hist[name][code] += 1
    out.update(hist)
    lim = max(0, min(nv, N))
    lit = (~cov) & (np.arange(nw * 32) < lim)
    words = lit.reshape(nw, 32).sum(1)
    wpre = np.concatenate([[0], np.cumsum(words)[:-1]])
    total = int(words.sum())
    lit_sorted = np.zeros(N, np.uint8)
    for p in range(N):
        w, bit = p >> 5, p & 31
        before = int(wpre[w]) + int(lit[w * 32:w * 32 + bit].sum())
        lit_sorted[before if lit[p] else total + p - before] = row[p]
    out["lit_sorted"] = lit_sorted
    return out


def parse_model(blocks, n_valid, S, hash_log, u64_rounds, stride_rounds,
                compact=True):
    """The kernel's outputs for every row, as numpy arrays."""
    t = de._tables()
    lanes = [_model_lane(blocks[b], int(n_valid[b]), S, hash_log, u64_rounds,
                         stride_rounds, (t["ll_lut"], t["ml_lut"]), compact)
             for b in range(blocks.shape[0])]
    out = {k: np.stack([ln[k] for ln in lanes])
           for k in ("starts", "mls", "offs", "covered")}
    out["nseq"] = np.array([ln["nseq"] for ln in lanes], np.int32)
    if compact:
        out["lit_count"] = np.array([ln["lit_count"] for ln in lanes],
                                    np.int32)
        for k in ("lit_sorted", "ll_hist", "of_hist", "ml_hist"):
            out[k] = np.stack([ln[k] for ln in lanes])
    return out


# ---------------------------------------------------------------------------
# holding model and plain version to the reference
# ---------------------------------------------------------------------------

def _ref_phase(blocks, nv, S, hash_log):
    with jax.enable_x64(False):
        parsed, lit_sorted, lit_count, lit_hist, hists = ref_de._parse_phase(
            jnp.asarray(blocks), jnp.asarray(nv), S, hash_log)
        out = {k: np.asarray(v) for k, v in parsed.items()}
        out.update(lit_sorted=np.asarray(lit_sorted),
                   lit_count=np.asarray(lit_count),
                   lit_hist=np.asarray(lit_hist))
        for (name, _), hh in zip(lp.HIST_BINS, hists):
            out[name] = np.asarray(hh)
    return out


def _port_phase(blocks, nv, S, hash_log):
    parsed, lit_sorted, lit_count, lit_hist, hists = de._parse_phase(
        torch.from_numpy(blocks), torch.from_numpy(nv), S, hash_log)
    out = {k: v.numpy() for k, v in parsed.items()}
    out.update(lit_sorted=lit_sorted.numpy(), lit_count=lit_count.numpy(),
               lit_hist=lit_hist.numpy())
    for (name, _), hh in zip(lp.HIST_BINS, hists):
        out[name] = hh.numpy()
    return out


def _assert_equal(got, want, keys, what):
    for k in keys:
        g = np.asarray(got[k])
        assert g.shape == want[k].shape, (what, k, g.shape, want[k].shape)
        assert np.array_equal(g.astype(want[k].dtype), want[k]), (what, k)


PHASE_KEYS = PARSE_KEYS + ("lit_sorted", "lit_count", "ll_hist", "of_hist",
                           "ml_hist")


@pytest.mark.parametrize("n,hash_log,S", [
    (4096, 15, None),     # the encoder's 4 KB bucket
    (16384, 15, None),    # the encode cell's 16 KB bucket
    (4096, 10, None),     # heavy hash collisions
    (4096, 15, 16),       # S far below the parse: the max_seq cap
], ids=["4k", "16k", "hash_log10", "cap16"])
def test_parse_phase_equals_reference(n, hash_log, S):
    blocks, nv = parse_rows(n + hash_log, n)
    S = de.seq_budget(n) if S is None else S
    want = _ref_phase(blocks, nv, S, hash_log)
    port = _port_phase(blocks, nv, S, hash_log)
    _assert_equal(port, want, PHASE_KEYS + ("lit_hist",), "plain")
    for k in PHASE_KEYS + ("lit_hist",):
        assert port[k].dtype == want[k].dtype, k
    model = parse_model(blocks, nv, S, hash_log, 8, 8)
    _assert_equal(model, want, PHASE_KEYS, "model")
    # the rows reach what the cases are about
    if S == 16:
        assert int(want["nseq"].max()) == S
    else:
        assert int(want["nseq"].max()) > 100
    assert (want["mls"] == 640).any()           # capped, chained sequences
    assert (want["mls"] >= 259).any()           # past the ml byte row
    assert want["of_hist"][:, 0].sum() > 0      # rep0
    assert want["covered"][:, -1].any()         # a match runs into n


@pytest.mark.parametrize("n,hash_log,rounds", [
    (4096, 15, (16, 24)),   # parse_block's extension budget
    (4096, 16, (16, 24)),   # parse_block_stats's default table
    (2048, 12, (2, 0)),     # no stride phase
], ids=["4k_16_24", "hash_log16", "no_stride"])
def test_parse_blocks_equals_reference(n, hash_log, rounds):
    blocks, nv = parse_rows(n + 7 * hash_log, n)
    S = n // 8
    with jax.enable_x64(False):
        want = {k: np.asarray(v) for k, v in ref_m.parse_blocks_ptrjump(
            jnp.asarray(blocks), jnp.asarray(nv), hash_log, S,
            *rounds).items()}
    got = tm.parse_blocks_ptrjump(torch.from_numpy(blocks),
                                  torch.from_numpy(nv), hash_log, S, *rounds)
    _assert_equal({k: v.numpy() for k, v in got.items()}, want, PARSE_KEYS,
                  "plain")
    model = parse_model(blocks, nv, S, hash_log, *rounds, compact=False)
    _assert_equal(model, want, PARSE_KEYS, "model")
    assert int(want["nseq"].max()) > 50


def test_model_equals_plain_on_odd_widths():
    """Widths that are not a multiple of 32 (a partial last bitmask word),
    n_valid past the width and below 0, against the plain version."""
    blocks = parse_rows(11, 1000)[0][[0, 3, 9, 14]]
    nv = np.array([1000, 1050, -3, 517], np.int32)
    got = lp.parse_plain(torch.from_numpy(blocks), torch.from_numpy(nv), 200,
                         13, 8, 8, compact=True)
    model = parse_model(blocks, nv, 200, 13, 8, 8)
    _assert_equal({k: v.numpy() for k, v in got.items()}, model,
                  PHASE_KEYS, "model vs plain")


def test_parse_lanes_raises_off_the_card():
    """The kernel wrapper takes CUDA tensors only: a CPU tensor raises (the
    callers route CPU rows to parse_plain), and so does a bad operand."""
    blocks = torch.zeros(2, 64, dtype=torch.uint8)
    nv = torch.full((2,), 64, dtype=torch.int32)
    with pytest.raises(ValueError, match="no CUDA kernel"):
        lp.parse_lanes(blocks, nv, 16, 15, 8, 8, compact=True)
    with pytest.raises(ValueError):
        lp.parse_lanes(blocks[0], nv, 16, 15, 8, 8, compact=True)
    with pytest.raises(TypeError):
        lp.parse_lanes(blocks.to(torch.int32), nv, 16, 15, 8, 8,
                       compact=False)
    with pytest.raises(ValueError):
        lp.parse_lanes(blocks, nv[:1], 16, 15, 8, 8, compact=False)
    with pytest.raises(ValueError):
        lp.parse_lanes(blocks, nv, 16, 25, 8, 8, compact=False)


def test_compose_is_associative():
    """The reverse scan may bracket the runs' functions any way."""
    cap = 9
    vals = list(range(-12, cap + 1))
    for a in vals:
        for b in vals:
            for c in vals:
                assert (_compose(_compose(a, b, cap), c, cap)
                        == _compose(a, _compose(b, c, cap), cap))


def _rows_for_lengths(n):
    rows = [parse_rows(29, n)]
    rows += [diagonal_rows(case, n, 3) for case in DIAGONAL_CASES]
    return (np.concatenate([r for r, _ in rows]),
            np.concatenate([v for _, v in rows]))


@pytest.mark.parametrize("rounds,hash_log", [
    ((8, 8), 15), ((16, 24), 15), ((2, 0), 12), ((0, 3), 15),
    ((8, 8), 6)], ids=["8_8", "16_24", "no_stride", "no_u64", "collisions"])
def test_derived_lengths_equal_rounds(rounds, hash_log):
    """The lengths along diagonals equal the reference's rounds clipped to
    N - i at every walked position with a candidate, on parse_rows and the
    diagonal cases, the N - 1 read clamp included."""
    blocks, nv = _rows_for_lengths(4096)
    N = blocks.shape[1]
    for row, v in zip(blocks, nv):
        cnt = max(0, min(N, int(v) - 3))
        v32 = _v32(row)
        cand = _table_walk(v32, cnt, hash_log)
        got = _derived_lengths(row, cand, cnt, _reach(*rounds, N))
        i = np.nonzero(cand[:cnt] >= 0)[0]
        want = np.minimum(_match_lengths(v32, i, cand[i], N - 1, *rounds),
                          N - i)
        assert np.array_equal(got[i], want)


@pytest.mark.parametrize("case", DIAGONAL_CASES)
@pytest.mark.parametrize("what", ["phase", "blocks", "blocks_collisions"])
def test_diagonal_cases_equal_reference(case, what):
    """The rows where the diagonal lengths and the segmented walk have
    their edges: the encode plane's (8, 8) phase, and (16, 24) through
    parse_blocks_ptrjump at hash_log 15 and 8."""
    n = 4096
    blocks, nv = diagonal_rows(case, n, 1)
    if what == "phase":
        S = de.seq_budget(n)
        want = _ref_phase(blocks, nv, S, 15)
        _assert_equal(_port_phase(blocks, nv, S, 15), want, PHASE_KEYS,
                      "plain")
        _assert_equal(parse_model(blocks, nv, S, 15, 8, 8), want,
                      PHASE_KEYS, "model")
        return
    hash_log = 15 if what == "blocks" else 8
    S = n // 8
    with jax.enable_x64(False):
        want = {k: np.asarray(v) for k, v in ref_m.parse_blocks_ptrjump(
            jnp.asarray(blocks), jnp.asarray(nv), hash_log, S, 16,
            24).items()}
    got = tm.parse_blocks_ptrjump(torch.from_numpy(blocks),
                                  torch.from_numpy(nv), hash_log, S, 16, 24)
    _assert_equal({k: v.numpy() for k, v in got.items()}, want, PARSE_KEYS,
                  "plain")
    _assert_equal(parse_model(blocks, nv, S, hash_log, 16, 24,
                              compact=False), want, PARSE_KEYS, "model")
    if case in ("one_byte", "periods"):
        assert (want["mls"] == 1728).any()      # capped, chained sequences
