"""LZ executor of the torch port against the JAX package's
``make_executor``: seeded random sequences with overlapping matches,
window references, offsets past the window, offsets that reinterpret as
negative int32, and out_len zeroing.  Outputs are bytes and must be equal.

``execute_plain`` (the plain executor on assembled operands, which
``lanes_plain``, the CPU path of the decode plane's entry
``execute_lanes``, runs on each chunk; that entry is tested in
tests/test_torch_lz_decode.py) is held against the reference and against
``walk``, a numpy walker written here that follows csrc/lz_exec.cu's
algorithm, so the kernel's algorithm is checked on the CPU although the
CUDA cannot run here.  Its per-lane flags (``lane_flags``: libzstd's
literal-overrun, content-size and offset checks) are held against
``flags``, a numpy loop over each lane's sequences written here, on
hand-made operands for each bit and on every case above:

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_execseq.py -q
"""

import jax  # noqa: F401  (the reference runs on the CPU in this process)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zstdsharp_tpu.ops.execseq import get_executor
from zstdsharp_tpu_torch.ops.execseq import (execute_plain, lane_flags,
                                             make_executor)

B, S, L, W, O = 6, 48, 1024, 64, 2048


def _case(seed, offsets, W=W, n_seq_all=None, L=L):
    rng = np.random.default_rng(seed)
    lit = rng.integers(0, 256, (B, L), dtype=np.uint8)
    window = rng.integers(0, 256, (B, W), dtype=np.uint8)
    ll = np.zeros((B, S), np.uint32)
    ml = np.zeros((B, S), np.uint32)
    off = np.zeros((B, S), np.uint32)
    n_seq = np.zeros(B, np.int32)
    last_lit = np.zeros(B, np.int32)
    out_len = np.zeros(B, np.int32)
    for b in range(B):
        n = int(rng.integers(0, S + 1)) if n_seq_all is None else n_seq_all
        pos = 0
        for s in range(n):
            ll[b, s] = rng.integers(0, 12)
            ml[b, s] = rng.integers(3, 40)
            pos += int(ll[b, s])
            kind = rng.choice(offsets)
            if kind == "overlap":      # offset < match length: periodic run
                off[b, s] = rng.integers(1, max(int(ml[b, s]), 2))
            elif kind == "back":       # inside the output so far
                off[b, s] = rng.integers(1, max(pos, 1) + 1)
            elif kind == "window":     # reaches into the window rows
                off[b, s] = rng.integers(pos + 1, pos + W + 1)
            elif kind == "past":       # beyond window: reads literal region
                off[b, s] = rng.integers(pos + W + 1, pos + W + L + 4000)
            else:                      # >= 2^31: int32-negative offsets
                off[b, s] = rng.integers(1 << 31, 1 << 32, dtype=np.uint64)
            pos += int(ml[b, s])
        n_seq[b] = n
        last_lit[b] = rng.integers(0, 30)
        total = pos + int(last_lit[b])
        out_len[b] = min(total, O) if rng.random() < 0.6 else \
            rng.integers(0, min(total, O) + 1)
    return lit, window, ll, ml, off, n_seq, last_lit, out_len


def _both(args):
    lit, window, ll, ml, off, n_seq, last_lit, out_len = args
    want = np.asarray(get_executor(B, S, L, W, O)(
        jnp.asarray(lit), jnp.asarray(window), jnp.asarray(ll),
        jnp.asarray(ml), jnp.asarray(off), jnp.asarray(n_seq),
        jnp.asarray(last_lit), jnp.asarray(out_len)))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    got = make_executor(B, S, L, W, O)(
        t(lit), t(window), t(ll.astype(np.int64)), t(ml.astype(np.int64)),
        t(off.astype(np.int64)), t(n_seq), t(last_lit), t(out_len))
    assert got.dtype == torch.uint8 and tuple(got.shape) == (B, O)
    return got.numpy(), want


@pytest.mark.parametrize("seed,offsets", [
    (1, ["overlap"]),
    (2, ["back"]),
    (3, ["window"]),
    (4, ["overlap", "back", "window"]),
    (5, ["past", "back"]),
    (6, ["negative", "overlap"]),
    (7, ["overlap", "back", "window", "past", "negative"]),
])
def test_executor_equals_reference(seed, offsets):
    got, want = _both(_case(seed, offsets))
    assert np.array_equal(got, want)


def test_bytes_past_out_len_are_zero():
    args = _case(8, ["overlap", "back"])
    got, _ = _both(args)
    out_len = args[-1]
    for b in range(B):
        assert not got[b, int(out_len[b]):].any()


def test_literals_only_rows_copy_literals():
    lit, window, ll, ml, off, n_seq, last_lit, out_len = _case(9, ["back"])
    n_seq[:] = 0
    last_lit[:] = 100
    out_len[:] = 100
    got, want = _both((lit, window, ll, ml, off, n_seq, last_lit, out_len))
    assert np.array_equal(got, want)
    assert np.array_equal(got[:, :100], lit[:, :100])


def test_shape_mismatch_raises():
    args = [torch.from_numpy(np.ascontiguousarray(a).astype(np.int64))
            for a in _case(10, ["back"])]
    args[0] = args[0].to(torch.uint8)[:, :L - 1]
    with pytest.raises(ValueError):
        make_executor(B, S, L, W, O)(*args)


# ---------------------------------------------------------------------------
# execute_plain against the reference and the kernel's algorithm

TILE = 8  # the kernel's tile is 128 sequences; 8 makes small cases span tiles


def _ext(k, n, S, ll, ml, off, last):
    """The plain version's extended sequence k in [0, S]: (ll, ml, off)."""
    real = k < n and k < S
    lk = last if k == n else (int(ll[k]) if real else 0)
    return lk, int(ml[k]) if real else 0, max(int(off[k]), 1) if real else 1


def walk(lit, window, ll, ml, off, n_seq, last_lit, out_len, O,
         cycles=None):
    """csrc/lz_exec.cu's algorithm in numpy, one lane after another.  A
    lane whose live ll and ml and tail last_lit are >= 0 walks its
    sequences in tiles: the tile's literal bytes, then its matches in
    order, with a barrier only where a match's sources reach past the
    frontier F (the kernel's warp-0 barrier points).  Between two barriers
    the kernel copies a group's match bytes all at once, so here each
    reads a snapshot of the row taken at the group's barrier: what the
    block's threads may see.  Any other lane, or a walked lane that reads
    a position not yet final, takes the exact path: the plain version's
    binary search, first sources as int32 codes, pointer jumping in place.
    The row starts as a poison pattern, so a stale read shows.  A lane
    with a position still unresolved after the rounds (a cycle) is
    appended to `cycles` when a list is given."""
    Bn, Ln = lit.shape
    Wn, Sn = window.shape[1], ll.shape[1]
    P = Ln + Wn
    out = np.zeros((Bn, O), np.uint8)
    search = int(np.ceil(np.log2(Sn + 2))) + 1
    jumps = int(np.ceil(np.log2(max(O, 2)))) + 2

    for b in range(Bn):
        def pool(q):
            q = min(max(int(q), 0), P - 1)
            return lit[b, q] if q < Ln else window[b, q - Ln]

        n, ol = int(n_seq[b]), int(out_len[b])
        last = int(np.int64(last_lit[b]).astype(np.int32))
        oe = min(max(ol, 0), O)
        K = 0 if n < 0 else min(n, Sn)
        lli, mli, offi = (a[b].astype(np.int32).astype(np.int64)
                          for a in (ll, ml, off))
        exact = bool((lli[:K] < 0).any() or (mli[:K] < 0).any()
                     or (0 <= n <= Sn and last < 0))
        row = np.full(O, 0xA5, np.uint8)
        rs_c = lb_c = 0
        for k0 in range(0, K + 1, TILE):
            if exact or rs_c >= oe:
                break
            ks = range(k0, min(k0 + TILE, K + 1))
            e = [_ext(k, n, Sn, lli, mli, offi, last) for k in ks]
            rs, lb = [], []
            for lk, mk, _ in e:
                rs.append(rs_c)
                lb.append(lb_c)
                rs_c += lk + mk
                lb_c += lk
            for i, (lk, _, _) in enumerate(e):
                for p in range(rs[i], min(rs[i] + lk, oe)):
                    row[p] = pool(lb[i] + p - rs[i])
            snap = row.copy()
            F = rs[0] + e[0][0]
            for i, (lk, mk, ok) in enumerate(e):
                ms = rs[i] + lk
                me = oe if ks[i] == K else min(ms + mk, oe)
                if ms >= me:
                    continue
                if ms - ok + min(me - ms, ok) > F:
                    snap, F = row.copy(), ms
                for p in range(ms, me):
                    d = p - ms
                    j = p - ok if d < ok else ms - ok + d % ok
                    t = -(P + j) - 1
                    if j >= 0:
                        row[p] = snap[j]
                    elif P + j >= 0:
                        row[p] = pool(P + j)
                    elif t >= O:
                        row[p] = pool(P - 1)
                    elif t < F:
                        row[p] = snap[t]
                    else:
                        exact = True
        if exact:
            ex = [_ext(k, n, Sn, lli, mli, offi, last) for k in range(Sn + 1)]
            size = np.array([lk + mk for lk, mk, _ in ex], np.int64)
            lls = np.array([lk for lk, _, _ in ex], np.int64)
            rsa, lba = np.cumsum(size) - size, np.cumsum(lls) - lls

            def code(p):
                lo, hi = 0, Sn
                for _ in range(search):
                    mid = (lo + hi + 1) >> 1
                    dead = rsa[mid] if mid <= n else 1 << 30
                    lo, hi = (mid, hi) if dead <= p else (lo, mid - 1)
                lk, _, ok = ex[lo]
                ms = rsa[lo] + lk
                if p < ms or p >= ol:
                    v = -(1 + lba[lo] + (p - rsa[lo]))
                else:
                    j = p - ok
                    if j >= ms:
                        j = ms - ok + (p - ms) % ok
                    v = j if j >= 0 else -(1 + P + j)
                if v >= O:
                    return -P
                return -(1 + min(max(-v - 1, 0), P - 1)) if v < 0 else v

            c = [code(p) for p in range(O)]
            for _ in range(jumps):
                left = False
                for p in range(O):
                    if c[p] >= 0:
                        c[p] = c[c[p]]
                        left |= c[p] >= 0
                if not left:
                    break
            if cycles is not None and max(c) >= 0:
                cycles.append(b)
            for p in range(oe):
                row[p] = pool(-c[p] - 1 if c[p] < 0 else 0)
        out[b, :oe] = row[:oe]
    return out


def _main_path(args):
    """A _case as the main path passes it: ll/ml/off int32 (the u32 bits),
    n_seq/last_lit/out_len int64."""
    lit, window, ll, ml, off, n_seq, last_lit, out_len = args
    bits = [np.ascontiguousarray(a.astype(np.uint32).view(np.int32))
            for a in (ll, ml, off)]
    return (lit, window, *bits, *(np.asarray(a, np.int64)
                                  for a in (n_seq, last_lit, out_len)))


def _exec_case(name):
    """(operands in the main path's dtypes and widths: literal rows as wide
    as the output, O; broadcast window?)."""
    kinds = ["overlap", "back", "window"]
    if name.startswith("seed"):
        seed, offsets = EXISTING[int(name[4:]) - 1]
        return _main_path(_case(seed, offsets, L=O)), False
    if name.startswith("window"):
        w = {"window_4k": 4096, "window_128k": 131072}[name]
        args = list(_main_path(_case(11 if w == 4096 else 12,
                                     ["window", "overlap", "back"], W=w,
                                     L=O)))
        args[1] = np.ascontiguousarray(args[1][:1])  # one row for all lanes
        return tuple(args), True
    if name == "n_seq_full":
        return _main_path(_case(13, kinds, n_seq_all=S, L=O)), False
    args = list(_main_path(_case({"n_seq_zero": 14, "negative_last_lit": 15,
                                  "out_len_short": 16,
                                  "out_len_long": 17}[name], kinds, L=O)))
    if name == "n_seq_zero":
        args[5][:] = 0
    elif name == "negative_last_lit":
        args[6][::2] = (-1, -7, -40)
        args[7][::2] = (30, 500, 2048)
    else:
        total = (np.where(np.arange(S)[None, :] < args[5][:, None],
                          args[2].astype(np.int64) + args[3], 0).sum(1)
                 + args[6])
        args[7][:] = (total // 2 if name == "out_len_short"
                      else np.minimum(total + 300, O + 100))
    return tuple(args), False


EXISTING = [(1, ["overlap"]), (2, ["back"]), (3, ["window"]),
            (4, ["overlap", "back", "window"]), (5, ["past", "back"]),
            (6, ["negative", "overlap"]),
            (7, ["overlap", "back", "window", "past", "negative"])]
EXEC_CASES = ([f"seed{i}" for i in range(1, 8)]
              + ["window_4k", "window_128k", "n_seq_zero", "n_seq_full",
                 "negative_last_lit", "out_len_short", "out_len_long"])


def _torch_args(args, broadcast, win_len=None):
    """`args` as execute_plain's operands, win_len (default 0 a lane)
    last."""
    if win_len is None:
        win_len = np.zeros(args[0].shape[0], np.int64)
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in (*args, win_len)]
    if broadcast:
        t[1] = t[1].expand(args[0].shape[0], -1)
        assert t[1].stride(0) == 0
    return t


def flags(ll, ml, off, n_seq, last_lit, out_len, win_len):
    """libzstd's checks, lane by lane over its live sequences: bit 0 the
    literal lengths overrun the section (last_lit < 0), bit 1 the output
    is not out_len long, bit 2 an offset is 0 or reaches past the bytes
    produced before its match plus win_len.  ll/ml/off as u32."""
    B, Sn = ll.shape
    out = np.zeros(B, np.int32)
    for b in range(B):
        u = [a[b].astype(np.int64) & 0xFFFFFFFF for a in (ll, ml, off)]
        pos, reach = 0, False
        for k in range(min(max(int(n_seq[b]), 0), Sn)):
            ms = pos + int(u[0][k])
            o = int(u[2][k])
            reach |= o == 0 or o > ms + int(win_len[b])
            pos = ms + int(u[1][k])
        out[b] = (int(last_lit[b] < 0)
                  | int(pos + int(last_lit[b]) != int(out_len[b])) << 1
                  | int(reach) << 2)
    return out


@pytest.mark.parametrize("name", EXEC_CASES)
def test_execute_equals_reference_and_walker(name):
    """Every lane against the walker; against the reference every lane
    without a cycle (the reference's while loop never ends on one, ROADMAP
    Queue 3): lanes are independent, so a cyclic lane runs there with
    n_seq 0 and is left out of that comparison."""
    args, broadcast = _exec_case(name)
    lit, window = args[0], args[1]
    if broadcast:
        window = np.broadcast_to(window, (lit.shape[0], window.shape[1]))
    dense = (lit, window, *args[2:])
    win_len = np.arange(B, dtype=np.int64) * 40
    got, bad = execute_plain(*_torch_args(args, broadcast, win_len))
    assert got.dtype == torch.uint8 and tuple(got.shape) == (B, O)
    assert bad.dtype == torch.int32 and tuple(bad.shape) == (B,)
    assert np.array_equal(bad.numpy(), flags(*args[2:], win_len))
    got = got.numpy()
    cycles = []
    assert np.array_equal(walk(*dense, O, cycles), got)
    n_seq = args[5].copy()
    n_seq[cycles] = 0
    ref = (lit, window, *(a.view(np.uint32) for a in args[2:5]), n_seq,
           *args[6:])
    want = np.asarray(get_executor(B, S, O, window.shape[1], O)(
        *(jnp.asarray(a) for a in ref)))
    kept = np.setdiff1d(np.arange(B), cycles)
    assert len(kept) >= B - 1
    assert np.array_equal(got[kept], want[kept])


def _corrupt(seed, regular):
    """Random operands: int32 ll/ml/off anywhere (regular: ll and ml small
    and >= 0, offsets anywhere), n_seq, last_lit and out_len around their
    ranges; small shapes, so chains, forward pool references, positions
    past O and cycles all occur."""
    rng = np.random.default_rng(seed)
    Bc, Sc = 4, int(rng.integers(1, 40))
    Wc, Oc = int(rng.integers(0, 64)), int(rng.integers(1, 400))

    def i32(*shape):
        return rng.integers(-2**31, 2**31, shape).astype(np.int32)

    ll, ml, off = i32(Bc, Sc), i32(Bc, Sc), i32(Bc, Sc)
    small = rng.random((3, Bc, Sc)) < 0.5
    ll = np.where(small[0], ll % 20, ll).astype(np.int32)
    ml = np.where(small[1], ml % 30, ml).astype(np.int32)
    off = np.where(small[2], off % 200, off).astype(np.int32)
    if regular:
        ll, ml = np.abs(ll) % 20, np.abs(ml) % 30
    return ((rng.integers(0, 256, (Bc, Oc), dtype=np.uint8),
             rng.integers(0, 256, (Bc, Wc), dtype=np.uint8),
             ll.astype(np.int32), ml.astype(np.int32), off,
             rng.integers(-3, Sc + 4, Bc).astype(np.int64),
             rng.integers(-40, 40, Bc).astype(np.int64),
             rng.integers(-5, Oc + 20, Bc).astype(np.int64)), Oc)


@pytest.mark.parametrize("seed,regular", [(s, s % 2 == 0)
                                          for s in range(20, 32)])
def test_walker_equals_plain_on_corrupt_operands(seed, regular):
    """The reference loops for ever on a cycle and sums ll + ml in int32,
    so on these operands the plain version is the definition."""
    args, o = _corrupt(seed, regular)
    win_len = np.random.default_rng(seed).integers(-5, 300, 4)
    got, bad = execute_plain(*_torch_args(args, False, win_len))
    assert np.array_equal(walk(*args, o), got.numpy())
    assert np.array_equal(bad.numpy(), flags(*args[2:], win_len))


# ---------------------------------------------------------------------------
# the flags on hand-made operands: one lane a case, the others valid


def _valid_lanes():
    """Operands of B valid lanes (every flag clear with win_len 0): 5
    literals, then matches reaching only bytes already produced, out_len
    their exact total."""
    rng = np.random.default_rng(50)
    lit = rng.integers(0, 256, (B, O), dtype=np.uint8)
    window = rng.integers(0, 256, (B, 64), dtype=np.uint8)
    ll = np.zeros((B, S), np.int32)
    ml = np.zeros((B, S), np.int32)
    off = np.ones((B, S), np.int32)
    n_seq = np.full(B, 6, np.int64)
    for b in range(B):
        pos = 0
        for k in range(6):
            ll[b, k] = 5 if k == 0 else k % 3
            pos += int(ll[b, k])
            off[b, k] = 1 + (b + k) % pos
            ml[b, k] = 3 + k
            pos += int(ml[b, k])
    last_lit = np.full(B, 4, np.int64)
    lit_total = ll.astype(np.int64).sum(1) + last_lit
    out_len = lit_total + ml.astype(np.int64).sum(1)
    return [lit, window, ll, ml, off, n_seq, last_lit, out_len]


@pytest.mark.parametrize("case,bits", [
    ("valid", 0), ("negative_last_lit", 0b011), ("long_output", 0b010),
    ("short_output", 0b010), ("offset_past_output", 0b100),
    ("offset_zero", 0b100), ("offset_u32", 0b100),
    ("offset_into_window", 0), ("offset_past_window", 0b100),
    ("dead_sequence", 0), ("n_seq_past_S", 0b100)])
def test_flags_on_hand_made_operands(case, bits):
    """Lane 2 is changed so that exactly `bits` are set; every other lane
    stays valid and flags nothing.  The bytes stay the executor's: equal
    to the reference's get_executor on the same operands."""
    args = _valid_lanes()
    win_len = np.zeros(B, np.int64)
    ll, ml, off, n_seq, last_lit, out_len = args[2:]
    b = 2
    if case == "negative_last_lit":      # literals past the section
        last_lit[b] = -3
    elif case == "long_output":          # the content size says more
        out_len[b] += 1
    elif case == "short_output":
        out_len[b] -= 2
    elif case == "offset_past_output":   # one byte further than produced
        off[b, 3] = int(ll[b, :3].sum() + ml[b, :3].sum() + ll[b, 3]) + 1
    elif case == "offset_zero":          # libzstd's offset -1
        off[b, 1] = 0
    elif case == "offset_u32":           # 2^31 + 7: negative as int32
        off[b, 4] = np.int32(-(2 ** 31) + 7)
    elif case in ("offset_into_window", "offset_past_window"):
        win_len[b] = 64                  # 64 real bytes before the lane
        reach = int(ll[b, :3].sum() + ml[b, :3].sum() + ll[b, 3])
        off[b, 3] = reach + (64 if case == "offset_into_window" else 65)
    elif case == "dead_sequence":        # past n_seq: never checked
        off[b, 6], ml[b, 6] = 0, 9
    elif case == "n_seq_past_S":         # every row live, the last included
        n_seq[b] = S + 5
        off[b, S - 1] = 0
    want = np.zeros(B, np.int32)
    want[b] = bits
    assert np.array_equal(flags(*args[2:], win_len), want)
    t = _torch_args(args, False, win_len)
    got, bad = execute_plain(*t)
    assert np.array_equal(bad.numpy(), want)
    assert torch.equal(lane_flags(*t[2:]), bad)
    ref = (args[0], args[1], *(a.view(np.uint32) for a in args[2:5]),
           *args[5:])
    ref_out = np.asarray(get_executor(B, S, O, 64, O)(
        *(jnp.asarray(a) for a in ref)))
    assert np.array_equal(got.numpy(), ref_out)
