"""The decode plane's lane decode, ``ops.execseq.execute_lanes``, on the
CPU (its plain version, ``lanes_plain``: the torch literal assembly, then
``make_executor``'s run and ``lane_flags``), against the JAX package's
``zstdsharp_tpu.decode.device_pipeline._fused_decode``, the one jitted
program a chunk that it replaces, run under JAX on the CPU.  The same
numpy inputs from ``np.random.default_rng(seed)`` go to both; rows must be
byte-equal (tolerance 0) and the flags must equal ``lane_flags`` of the
operands.

``lane_model`` is a numpy model of csrc/lz_exec.cu's lane setup (the
literal function and the sequence-row selection, with the kernel's
clamps, written from the kernel's code), so the CUDA kernel's formulas
are held against the torch assembly on the CPU although the CUDA cannot
run here:

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_lz_decode.py -q
"""

import jax  # noqa: F401  (the reference runs on the CPU in this process)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zstdsharp_tpu.decode.device_pipeline import _fused_decode as ref_fused
from zstdsharp_tpu_torch.kernel_bench import (exec_args, lz_corrupt_lanes,
                                             lz_work, run_lanes)
from zstdsharp_tpu_torch.ops.execseq import (LaneSources, assemble,
                                             execute_lanes, execute_plain,
                                             lane_flags)

CPU = torch.device("cpu")
O, S, HUF_T, FSE_T = 1024, 64, 160, 48
N_RAW, N_HUF_ROWS, N_FSE, N_HOST = 3000, 16, 4, 3


def _sources(rng, W):
    """Literal pool, Huffman rows (symbols < 256, as the kernel leaves
    them), and FSE and host sequence rows whose sequences stay within the
    output and a W-byte window (so no chain leaves the row)."""
    raw = rng.integers(0, 256, N_RAW, dtype=np.uint8)
    huf = rng.integers(0, 256, N_HUF_ROWS * HUF_T).astype(np.int32)

    def seq_rows(n, T):
        ll = rng.integers(0, 12, (n, T)).astype(np.int32)
        ml = rng.integers(3, 20, (n, T)).astype(np.int32)
        off = np.zeros((n, T), np.int32)
        for r in range(n):
            pos = 0
            for k in range(T):
                pos += int(ll[r, k])
                off[r, k] = rng.integers(1, pos + W + 1)
                pos += int(ml[r, k])
        return ll, ml, off

    return raw, huf, seq_rows(N_FSE, FSE_T), seq_rows(N_HOST, S)


def _lanes(rng, kinds, raw, huf, fse, host):
    """Meta rows [B, 12] (win_len last, set by the caller): each lane's
    literal kind from `kinds` ("raw", "rle", "huf4", "huf1") and a
    sequence source cycling none / FSE row / host row, n_seq up to the
    row's width, lit_regen and out_len consistent with its sequences."""
    meta = np.zeros((len(kinds), 12), np.int64)
    for b, kind in enumerate(kinds):
        seq_kind = b % 3
        rows, r = ((None, 0), (fse, b % N_FSE), (host, b % N_HOST))[seq_kind]
        n = 0 if rows is None else int(rng.integers(1, rows[0].shape[1] + 1))
        sum_ll = 0 if rows is None else int(rows[0][r, :n].sum())
        sum_ml = 0 if rows is None else int(rows[1][r, :n].sum())
        regen = sum_ll + int(rng.integers(0, 40))
        m = meta[b]
        m[5], m[8], m[9], m[10] = seq_kind, n, regen, regen + sum_ml
        m[6] = r if seq_kind == 1 else -1
        m[7] = r if seq_kind == 2 else -1
        m[1] = rng.integers(0, N_RAW - regen) if kind != "rle" else \
            rng.integers(0, N_RAW)
        m[2] = 1 if kind == "rle" else regen
        if kind == "huf4":
            m[0], m[3], m[4] = 1, 4 * int(rng.integers(0, 4)), -(-regen // 4)
        elif kind == "huf1":
            m[0], m[3], m[4] = 1, int(rng.integers(0, N_HUF_ROWS)), regen
    return meta


def _port_sources(raw, huf, fse, host):
    t = torch.from_numpy
    return LaneSources(
        t(np.concatenate([raw, [0]]).astype(np.uint8)),
        None if huf is None else t(huf), HUF_T,
        None if fse is None else tuple(t(a) for a in fse),
        None if host is None else tuple(t(a) for a in host))


def _reference(meta, raw, huf, fse, host, W, win_row):
    """The JAX package's _fused_decode on the same inputs (meta int32
    without win_len; win_row None, a 1-D row or a 2-D row a lane)."""
    B = meta.shape[0]
    fn = ref_fused(HUF_T, FSE_T, S, O, B, O, W)
    j = jnp.asarray
    return np.asarray(fn(
        j(meta[:, :11].astype(np.int32)), None if huf is None else j(huf),
        None if fse is None else tuple(j(a) for a in fse),
        None if host is None else tuple(j(a) for a in host),
        j(np.concatenate([raw, [0]]).astype(np.uint8)),
        None if win_row is None else j(win_row)))


def lane_model(meta, src: LaneSources, S_: int, O_: int):
    """The kernel's lane setup in numpy, written from csrc/lz_exec.cu's
    ``setup``, ``lit_at`` and ``ll_at``/``ml_at``/``off_at``: (lit [B, O]
    uint8, ll/ml/off [B, S] int32, last_lit [B] int64)."""
    meta = meta.numpy()
    raw = src.raw.numpy()
    n_raw = len(raw)
    B = meta.shape[0]
    lit = np.zeros((B, O_), np.uint8)
    seqs = np.zeros((3, B, S_), np.int32)
    last = np.zeros(B, np.int64)
    for b in range(B):
        kind, base, plen, lane0, seg, skind, fl, hr, n_seq, regen = \
            (int(v) for v in meta[b, :10])
        lst = min(max(base, 0), n_raw + 8)
        for q in range(O_):
            if kind == 1 and src.huf is not None:
                T, sg = src.huf_T, max(seg, 1)
                st = min(max(max(lane0, 0) * T, 0), src.huf.numel() + 8)
                s = 0 if q < sg else 1 if q - sg < sg else \
                    2 if q - 2 * sg < sg else 3
                i = st + min(max(s * T + q - s * sg, 0), 4 * T - 1)
                v = int(src.huf[i]) & 255 if i < src.huf.numel() else 0
            elif plen == 1:
                v = raw[lst] if lst < n_raw else 0
            else:
                v = raw[lst + q] if lst + q < n_raw else 0
            lit[b, q] = v
        rows, r = None, 0
        if skind == 1 and src.fse is not None:
            rows, r = src.fse, min(max(fl, 0), src.fse[0].shape[0] - 1)
        elif skind == 2 and src.host is not None:
            rows, r = src.host, min(max(hr, 0), src.host[0].shape[0] - 1)
        for c in range(3):
            if rows is None:
                seqs[c, b] = 1 if c == 2 else 0
            else:
                T = rows[c].shape[1]
                seqs[c, b, :min(T, S_)] = rows[c][r, :S_].numpy()
        live = min(max(n_seq, 0), S_)
        last[b] = regen - int(seqs[0, b, :live].astype(np.int64).sum())
    return lit, seqs[0], seqs[1], seqs[2], last


def _check_model(meta_t, src):
    """The numpy model of the kernel's lane setup equals the torch
    assembly on these meta rows."""
    lit, ll, ml, off, n_seq, last_lit, out_len, win_len = assemble(
        meta_t, src, S, O)
    m_lit, m_ll, m_ml, m_off, m_last = lane_model(meta_t, src, S, O)
    assert np.array_equal(lit.numpy(), m_lit)
    for got, want in ((ll, m_ll), (ml, m_ml), (off, m_off)):
        assert np.array_equal(got.numpy(), want)
    assert np.array_equal(last_lit.numpy(), m_last)


LIT_CASES = {"raw": ["raw"] * 6, "rle": ["rle"] * 6,
             "huf4": ["huf4"] * 6, "huf1": ["huf1"] * 6,
             "mixed": ["raw", "rle", "huf4", "huf1"] * 3}


@pytest.mark.parametrize("lits", sorted(LIT_CASES))
@pytest.mark.parametrize("window", ["none", "dictionary"])
def test_lanes_equal_reference(lits, window):
    """Raw, RLE and Huffman (4 streams and 1) literal lanes, each with no
    sequences, FSE rows or host rows, without a dictionary (8 zero bytes a
    lane) and with a dictionary's window row broadcast with stride 0."""
    rng = np.random.default_rng(len(lits) * 7 + len(window))
    W = 8 if window == "none" else 512
    raw, huf, fse, host = _sources(rng, W)
    meta = _lanes(rng, LIT_CASES[lits], raw, huf, fse, host)
    meta[:, 11] = W  # matches may reach the whole window
    win_row = None
    if window == "none":
        win = torch.zeros(1, W, dtype=torch.uint8).expand(len(meta), W)
    else:
        win_row = rng.integers(0, 256, W, dtype=np.uint8)
        win = torch.from_numpy(win_row)[None, :].expand(len(meta), W)
        assert win.stride(0) == 0
    src = _port_sources(raw, huf, fse, host)
    meta_t = torch.from_numpy(meta)
    rows, bad = execute_lanes(meta_t, src, S, O, win)
    want = _reference(meta, raw, huf, fse, host, W, win_row)
    assert rows.dtype == torch.uint8 and tuple(rows.shape) == (len(meta), O)
    assert np.array_equal(rows.numpy(), want)
    _check_model(meta_t, src)
    lit, ll, ml, off, last = lane_model(meta_t, src, S, O)
    t = torch.from_numpy
    assert torch.equal(bad, lane_flags(t(ll), t(ml), t(off), meta_t[:, 8],
                                       t(last), meta_t[:, 10],
                                       meta_t[:, 11]))
    assert not bad.any()


@pytest.mark.parametrize("dictionary", [False, True])
def test_multi_block_round_in_place_equals_reference(dictionary):
    """Two rounds of a multi-block batch: each lane's window read out of
    its row of the accumulator at its start and its row written back into
    it in place, against the reference's dynamic_slice, _fused_decode and
    dynamic_update_slice; one lane inactive in round 2 (start Cb, zeros
    into the padding tail), starts clamped as the reference's."""
    rng = np.random.default_rng(41 + dictionary)
    Wb, Cb, F = 2048, 4096, 4
    raw, huf, fse, host = _sources(rng, Wb)
    src = _port_sources(raw, huf, fse, host)
    acc = np.zeros((F, Wb + Cb + O), np.uint8)
    if dictionary:
        acc[:, Wb - 300:Wb] = rng.integers(0, 256, 300, dtype=np.uint8)
    acc_t = torch.from_numpy(acc.copy())
    ref_acc = jnp.asarray(acc)
    fn = ref_fused(HUF_T, FSE_T, S, O, F, O, Wb)
    pos = np.zeros(F, np.int64)
    for r in range(2):
        meta = _lanes(rng, ["raw", "huf4", "rle", "huf1"], raw, huf, fse,
                      host)
        starts = pos.copy()
        if r == 1:
            meta[3] = 0
            starts[3] = Cb
        meta[:, 11] = Wb  # the sequences' offsets reach the whole row
        meta[3, 11] = 0 if r == 1 else Wb
        _, bad = execute_lanes(
            torch.from_numpy(meta), src, S, O, acc_t,
            win_start=torch.from_numpy(starts), W=Wb, out=acc_t,
            out_start=torch.from_numpy(Wb + starts))
        st = jnp.asarray(starts.astype(np.int32))
        windows = jax.vmap(lambda a, s: jax.lax.dynamic_slice(
            a, (s,), (Wb,)))(ref_acc, st)
        outs = fn(jnp.asarray(meta[:, :11].astype(np.int32)),
                  jnp.asarray(huf), tuple(jnp.asarray(a) for a in fse),
                  tuple(jnp.asarray(a) for a in host),
                  jnp.asarray(np.concatenate([raw, [0]]).astype(np.uint8)),
                  windows)
        ref_acc = jax.vmap(lambda a, o, s: jax.lax.dynamic_update_slice(
            a, o, (s,)))(ref_acc, outs, Wb + st)
        assert np.array_equal(acc_t.numpy(), np.asarray(ref_acc))
        assert not bad.any()
        pos += meta[:, 10]


def _corrupt_case(name):
    """Hand-made corrupt meta over valid sources: (meta, sources, whether
    the reference is defined on it)."""
    rng = np.random.default_rng(100 + CORRUPT.index(name))
    raw, huf, fse, host = _sources(rng, 8)
    meta = _lanes(rng, ["raw", "rle", "huf4", "huf1"] * 2, raw, huf, fse,
                  host)
    if name == "pool_base_past_end":
        meta[:, 1] = N_RAW + np.arange(8) * 3 - 10
    elif name == "lane0_past_end":
        meta[:, 3] = N_HUF_ROWS + np.arange(8) - 4
    elif name == "n_seq_past_S":
        meta[:, 8] = S + np.arange(8)
    elif name == "seg_zero":
        meta[:, 4] = np.arange(8) % 3 - 1
    elif name == "fse_lane_past_rows":
        meta[:, 5] = 1
        meta[:, 6] = N_FSE + np.arange(8)
    elif name == "negative_ll":
        host[0][:, ::5] = -3
        meta[:, 5] = 2
        meta[:, 7] = np.arange(8) % N_HOST
    # the reference's jnp.take fills a row index past its rows with
    # INT32_MIN where the port clamps it like every other index; its
    # executor sums negative lengths in int32 and never ends on a cycle
    defined = name not in ("fse_lane_past_rows", "negative_ll")
    return meta, (raw, huf, fse, host), defined


CORRUPT = ["pool_base_past_end", "lane0_past_end", "n_seq_past_S",
           "seg_zero", "fse_lane_past_rows", "negative_ll"]


@pytest.mark.parametrize("name", CORRUPT)
def test_corrupt_meta(name):
    """Corrupt meta rows: where the reference is defined on them the rows
    equal its rows; on every case they equal make_executor's run and the
    flags lane_flags, both on the operands of the numpy model of the
    kernel's lane setup (ROADMAP Queue 3: the reference's int32 layout
    sums and its fill for a row index past the rows differ from the
    port's int64 sums and clamp, so there the executor is the
    definition)."""
    meta, (raw, huf, fse, host), defined = _corrupt_case(name)
    src = _port_sources(raw, huf, fse, host)
    meta_t = torch.from_numpy(meta)
    win = torch.zeros(1, 8, dtype=torch.uint8).expand(len(meta), 8)
    rows, bad = execute_lanes(meta_t, src, S, O, win)
    _check_model(meta_t, src)
    lit, ll, ml, off, last = lane_model(meta_t, src, S, O)
    t = torch.from_numpy
    want, want_bad = execute_plain(t(lit), win, t(ll), t(ml), t(off),
                                   meta_t[:, 8], t(last), meta_t[:, 10],
                                   meta_t[:, 11])
    assert torch.equal(rows, want) and torch.equal(bad, want_bad)
    if defined:
        assert np.array_equal(rows.numpy(), _reference(
            meta, raw, huf, fse, host, 8, None))


@pytest.mark.parametrize("seed", range(6))
def test_model_equals_assembly_on_random_meta(seed):
    """The numpy model of the kernel's lane setup equals the torch
    assembly on random meta that indexes past every source (the meta the
    card tests give the kernel), and the plain execute_lanes equals
    execute_plain on the assembled operands."""
    rng = np.random.default_rng(seed)
    call = lz_corrupt_lanes(rng, 12, 40, 300, 16, CPU,
                            "raw" if seed == 5 else "all")
    _check_model_sized(call)
    rows, bad = run_lanes(call)
    want, want_bad = execute_plain(*exec_args(call))
    assert torch.equal(rows, want) and torch.equal(bad, want_bad)
    assert bad.any()


def _check_model_sized(call):
    lit, ll, ml, off, _, last_lit, _, _ = assemble(
        call["meta"], call["src"], call["S"], call["O"])
    m = lane_model(call["meta"], call["src"], call["S"], call["O"])
    for got, want in zip((lit, ll, ml, off, last_lit), m):
        assert np.array_equal(got.numpy(), want)


def test_padding_lanes_give_zero_rows_and_flags():
    rng = np.random.default_rng(3)
    raw, huf, fse, host = _sources(rng, 8)
    meta = np.zeros((5, 12), np.int64)
    rows, bad = execute_lanes(torch.from_numpy(meta),
                              _port_sources(raw, huf, fse, host), S, O,
                              torch.zeros(1, 8, dtype=torch.uint8).expand(
                                  5, 8))
    assert not rows.any() and not bad.any()


@pytest.mark.parametrize("case", ["meta_dtype", "meta_cols", "raw_dtype",
                                  "huf_T", "fse_rows", "window_rows",
                                  "W_past_row", "out_narrow",
                                  "out_start_alone", "start_dtype",
                                  "meta_rank", "meta_strided",
                                  "window_dtype", "window_row_stride",
                                  "window_cols_strided", "window_device",
                                  "raw_device", "host_rows", "fse_dtype",
                                  "W_negative", "win_start_shape",
                                  "out_dtype", "out_device", "meta_device"])
def test_execute_lanes_raises(case):
    rng = np.random.default_rng(5)
    raw, huf, fse, host = _sources(rng, 8)
    meta = torch.from_numpy(_lanes(rng, ["raw"] * 4, raw, huf, fse, host))
    src = _port_sources(raw, huf, fse, host)
    win = torch.zeros(4, 8, dtype=torch.uint8)
    kw = {}
    err = ValueError
    if case == "meta_dtype":
        meta, err = meta.int(), TypeError
    elif case == "meta_cols":
        meta = meta[:, :11].contiguous()
    elif case == "raw_dtype":
        src, err = src._replace(raw=src.raw.int()), TypeError
    elif case == "huf_T":
        src = src._replace(huf_T=0)
    elif case == "fse_rows":
        src = src._replace(fse=src.fse[:2])
    elif case == "window_rows":
        win = win[:3]
    elif case == "W_past_row":
        kw = {"W": 9}
    elif case == "out_narrow":
        kw = {"out": torch.zeros(4, O - 1, dtype=torch.uint8)}
    elif case == "out_start_alone":
        kw = {"out_start": torch.zeros(4, dtype=torch.int64)}
    elif case == "start_dtype":
        kw, err = {"win_start": torch.zeros(4, dtype=torch.int32)}, TypeError
    elif case == "meta_rank":
        meta = meta.reshape(-1)
    elif case == "meta_strided":
        meta = torch.cat([meta, meta], 1)[:, ::2]
    elif case == "window_dtype":
        win, err = win.int(), TypeError
    elif case == "window_row_stride":    # neither 0 nor A = 8 bytes apart
        win = torch.zeros(4, 16, dtype=torch.uint8)[:, :8]
    elif case == "window_cols_strided":
        win = torch.zeros(4, 16, dtype=torch.uint8)[:, ::2]
    elif case == "window_device":
        win = win.to("meta")
    elif case == "raw_device":
        src = src._replace(raw=src.raw.to("meta"))
    elif case == "host_rows":            # two channels, not (ll, ml, off)
        src = src._replace(host=src.host[:2])
    elif case == "fse_dtype":
        src, err = src._replace(fse=tuple(r.long() for r in src.fse)), \
            TypeError
    elif case == "W_negative":
        kw = {"W": -1}
    elif case == "win_start_shape":
        kw = {"win_start": torch.zeros(4, 1, dtype=torch.int64)}
    elif case == "out_dtype":
        kw, err = {"out": torch.zeros(4, O, dtype=torch.int32)}, TypeError
    elif case == "out_device":
        kw = {"out": torch.zeros(4, O, dtype=torch.uint8, device="meta")}
    else:                                # a device with no kernel and no
        meta, win = meta.to("meta"), win.to("meta")  # plain version
        src = LaneSources(*(
            t.to("meta") if isinstance(t, torch.Tensor) else
            tuple(r.to("meta") for r in t) if isinstance(t, tuple) else t
            for t in src))
    with pytest.raises(err):
        execute_lanes(meta, src, S, O, win, **kw)


def test_lanes_work_counts_a_hand_made_lane():
    """lz_work on lanes whose bytes are known: a Huffman lane of 10
    literals (4 bytes a symbol read) with 2 FSE sequences whose matches
    read only the output, a raw lane of 10 literals, an RLE lane of 10
    (one byte read) and a padding lane; each lane's 96 bytes of meta, its
    O output bytes and 4 flag bytes."""
    On = 64
    fse = tuple(torch.tensor([[a, b, 0]], dtype=torch.int32) for a, b in
                ((4, 3), (5, 6), (2, 4)))  # ll, ml, off of 2 sequences
    src = LaneSources(torch.arange(100, dtype=torch.uint8),
                      torch.arange(64, dtype=torch.int32), 16, fse, None)
    # Huffman: ll 4 + 3 and 3 last literals = 10 literals, out 10 + 11
    meta = torch.tensor([[1, 0, 0, 0, 3, 1, 0, -1, 2, 10, 21, 0],
                         [0, 5, 10, 0, 0, 0, -1, -1, 0, 10, 10, 0],
                         [0, 5, 1, 0, 0, 0, -1, -1, 0, 10, 10, 0],
                         [0] * 12], dtype=torch.int64)
    call = {"meta": meta, "src": src, "S": 4, "O": On,
            "window": torch.zeros(1, 8, dtype=torch.uint8).expand(4, 8),
            "win_start": None, "W": None, "out": None, "out_start": None}
    rows, bad = run_lanes(call)
    assert not bad.any()
    n_bytes, n_ops = lz_work(call)
    assert n_bytes == (4 * 10 + 12 * 2) + 10 + 1 + 4 * (96 + On + 4)
    assert n_ops == 4 * (21 + 10 + 10) + 24 * 2


def test_decode_cell_rows_equal_reference():
    """The whole path at the decode cell's shape, cut to one chunk: 64
    records of 24 KB of ``bench.make_corpus`` at level 9 (O = 24,576,
    Huffman literals, FSE sequences): decode_batch_device on the CPU
    gives the reference's rows and lengths."""
    from bench import make_corpus
    from zstdsharp_tpu.decode import device_pipeline as ref
    from zstdsharp_tpu_torch.decode import device_pipeline as dp
    from zstdsharp_tpu_torch.encode.frame import compress

    n = 24 << 10
    data = make_corpus(64 * n)
    frames = [compress(data[i:i + n], 9) for i in range(0, 64 * n, n)]
    outs, lens, host = dp.decode_batch_device(frames, device=CPU)
    r_outs, r_lens, r_host = ref.decode_batch_device(frames)
    assert not host and not r_host and np.array_equal(lens, r_lens)
    assert len(outs) == len(r_outs) == 1
    assert np.array_equal(outs[0].numpy(), np.asarray(r_outs[0]))
    assert b"".join(outs[0][k, :lens[k]].numpy().tobytes()
                    for k in range(64)) == data
