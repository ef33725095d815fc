"""Rows for the parse: ``parse_rows``' seeded edge rows and the rows where
the parse kernel's diagonal lengths and doubling selection have their
edges, shared by ``test_torch_lz_parse.py`` (against the JAX package) and
``test_torch_cuda.py`` (the kernel against its plain version).  Imports
neither JAX nor torch."""

import numpy as np

DIAGONAL_CASES = ("one_byte", "periods", "n_valid_cut", "restart")


def parse_rows(seed: int, n: int) -> tuple[np.ndarray, np.ndarray]:
    """Seeded rows of width n for the parse and their n_valid: text,
    noise, a byte run and ``b"ab"`` runs, the n_valid edges 0, 3, n - 1
    and n, repeats of 639, 640, 641 and 700 bytes (the (8, 8) rounds
    extend at most 640), a match that runs into n, one clipped by n_valid
    with the match going on past it, and one offset repeated with and
    without literals between (rep0)."""
    rng = np.random.default_rng(seed)
    words = [b"alpha ", b"bravo ", b"charlie ", b"delta ", b"echo ",
             b"foxtrot ", b"golf ", b"hotel "]
    rows, nvs = [], []

    def text(k):
        return b"".join(words[i] for i in rng.integers(0, 8, k // 5 + 2))[:k]

    def noise(k):
        return bytes(rng.integers(0, 256, k, dtype=np.uint8))

    def add(data, nv=None, fill=b""):
        r = np.zeros(n, np.uint8)
        body = (data + fill)[:n]
        r[:len(body)] = np.frombuffer(body, np.uint8)
        rows.append(r)
        nvs.append(min(len(data), n) if nv is None else nv)

    add(text(n))
    add(noise(n))
    add(b"Q" * (n // 2) + text(n // 2))
    add(b"ab" * n)
    for nv in (0, 3, n - 1, n):
        add(text(n), nv)
    for run in (639, 640, 641, 700):
        x = noise(run)
        add(noise(17) + x + x + text(n))
    x = noise(n // 2 - 5)
    add(noise(10) + x + x)                         # the match reaches n
    x = noise(300)
    add(noise(20) + x + x[:150], None, x[150:] + noise(n))  # clipped by nv
    x = bytearray(noise(900))
    y = bytearray(x)
    for k in range(40, 900, 60):
        y[k] ^= 0x5A                               # one literal, same offset
    add(noise(5) + bytes(x) + bytes(y) + bytes(x) * 3)
    return np.stack(rows), np.array(nvs, np.int32)


def diagonal_rows(case: str, n: int, seed: int = 0):
    """Four rows of width n (n >= 4096) for `case` and their n_valid:

    one_byte     a row of one repeated byte (every position on one
                 diagonal, at the extension cap almost everywhere), the
                 zero byte too (equal to the zeros past N), one of them cut
                 by n_valid;
    periods      runs of period 2 to 7, each longer than 1,728 bytes (the
                 (16, 24) rounds' reach);
    n_valid_cut  a run cut by n_valid with the run going on past it, a run
                 into N, a repeat cut 3 bytes before N, and n_valid past N;
    restart      runs with single bytes changed inside them, so that a
                 diagonal ends at a mismatch and starts again on the same
                 offset, and a repeat with a byte changed every 37 bytes.
    """
    rng = np.random.default_rng(seed)

    def noise(k):
        return bytes(rng.integers(0, 256, k, dtype=np.uint8))

    def period(p, k):
        unit = noise(p)
        return (unit * (k // p + 1))[:k]

    rows, nvs = [], []

    def add(data, nv=None):
        r = np.zeros(n, np.uint8)
        body = data[:n]
        r[:len(body)] = np.frombuffer(body, np.uint8)
        rows.append(r)
        nvs.append(min(len(data), n) if nv is None else nv)

    if case == "one_byte":
        add(b"Z" * n)
        add(b"\x00" * n)
        add(b"\xff" * n, n - 5)
        add(noise(9) + b"Q" * n)
    elif case == "periods":
        for p0 in (2, 4, 6):
            add(noise(11) + period(p0, 1800) + noise(40) +
                period(p0 + 1, 1900) + noise(n))
        add(period(5, n))
    elif case == "n_valid_cut":
        add(noise(100) + b"R" * n, n - 700)
        add(noise(100) + period(3, n))
        x = noise(n // 2 - 10)
        add(noise(7) + x + x[:-3] + noise(20), n - 3)
        add(noise(50) + period(7, n), n + 9)
    elif case == "restart":
        for p0, step in ((1, 97), (2, 61), (3, 23)):
            r = bytearray(noise(13) + period(p0, n))
            for k in range(200, n, step):
                r[k] ^= 0x41
            add(bytes(r))
        x = bytearray(noise(1500))
        y = bytearray(x)
        for k in range(30, 1500, 37):
            y[k] ^= 0x11
        add(noise(5) + bytes(x) + bytes(y) + bytes(x) + noise(n))
    else:
        raise ValueError(f"unknown case {case!r}")
    return np.stack(rows), np.array(nvs, np.int32)
