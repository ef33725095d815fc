"""TPC-H ``lineitem`` as Parquet PLAIN data page bodies (configuration key
``"payload": "tpch_lineitem_plain"``).

A record is the body of one data page of one column, as Arrow's Parquet
writer hands it to its ZSTD codec with dictionaries off: REQUIRED columns
(no definition levels), INT64 keys, INT32 line numbers and dates (days
since 1970-01-01), DOUBLE decimals, and BYTE_ARRAY strings (a 4-byte
little-endian length, then the bytes).  Records come in a fixed cycle of
``len(PLAN)`` pages, one row group's column chunks in file order, each
column given pages in proportion to its PLAIN bytes a row; the pages of a
column continue its values from one page to the next, and each page is cut
at exactly its drawn length, so its last value may be cut.

Values follow the TPC-H specification's section 4.2.3 at scale factor 100:
sparse increasing order keys with 1-7 lines an order, uniform part keys,
the supplier key by the specification's formula, quantity 1-50, the
extended price from the part's retail price, discount 0.00-0.10, tax
0.00-0.08, ship, commit and receipt dates from the order date, the return
flag and line status against CURRENTDATE, the instruction and mode lists,
and comments of 10-43 characters cut at random offsets from a text pool
built by the specification's grammar (section 4.2.2.14).  The grammar's
word lists are below; their weights approximate dbgen's ``dists.dss``.

The seed changes the values, the text pool and the first order, never
the page plan.
"""

from __future__ import annotations

import numpy as np

# one row group's pages, column by column: (column, pages)
COLUMNS = (("l_orderkey", 8), ("l_partkey", 8), ("l_suppkey", 8),
           ("l_linenumber", 4), ("l_quantity", 8), ("l_extendedprice", 8),
           ("l_discount", 8), ("l_tax", 8), ("l_returnflag", 5),
           ("l_linestatus", 5), ("l_shipdate", 4), ("l_commitdate", 4),
           ("l_receiptdate", 4), ("l_shipinstruct", 16), ("l_shipmode", 8),
           ("l_comment", 30))
PLAN = tuple(c for c, n in COLUMNS for _ in range(n))  # 136 pages

SCALE = 100
ORDERS = SCALE * 1_500_000
PARTS = SCALE * 200_000
SUPPLIERS = SCALE * 10_000
# days since 1970-01-01: 1992-01-01, 1995-06-17 and 1998-12-31
STARTDATE, CURRENTDATE, ENDDATE = 8035, 9298, 10591
INSTRUCTIONS = (b"DELIVER IN PERSON", b"COLLECT COD", b"NONE",
                b"TAKE BACK RETURN")
MODES = (b"REG AIR", b"AIR", b"RAIL", b"SHIP", b"TRUCK", b"MAIL", b"FOB")
POOL_BYTES = 16 << 20  # the comment text pool (dbgen's is 300 MB)

# ---- the comment grammar (section 4.2.2.14): word lists with weights ----
_NOUNS = {"foxes": 20, "ideas": 20, "theodolites": 20, "pinto beans": 20,
          "instructions": 20, "dependencies": 10, "excuses": 10,
          "platelets": 10, "asymptotes": 10, "courts": 5, "dolphins": 5,
          "multipliers": 1, "sauternes": 1, "warthogs": 1, "frets": 1,
          "dinos": 1, "attainments": 1, "somas": 1, "Tiresias": 1,
          "patterns": 1, "forges": 1, "braids": 1, "hockey players": 1,
          "frays": 1, "warhorses": 1, "dugouts": 1, "notornis": 1,
          "epitaphs": 1, "pearls": 1, "tithes": 1, "waters": 1, "orbits": 1,
          "gifts": 1, "sheaves": 1, "depths": 1, "sentiments": 1,
          "decoys": 1, "realms": 1, "pains": 1, "grouches": 1,
          "escapades": 1, "packages": 40, "requests": 40, "accounts": 40,
          "deposits": 40}
_VERBS = {"sleep": 20, "wake": 20, "are": 20, "cajole": 20, "haggle": 20,
          "nag": 10, "use": 10, "boost": 10, "affix": 5, "detect": 5,
          "integrate": 5, "maintain": 1, "nod": 1, "was": 1, "lose": 1,
          "sublate": 1, "solve": 1, "thrash": 1, "promise": 1, "engage": 1,
          "hinder": 1, "print": 1, "x-ray": 1, "breach": 1, "eat": 1,
          "grow": 1, "impress": 1, "mold": 1, "poach": 1, "serve": 1,
          "run": 1, "dazzle": 1, "snooze": 1, "doze": 1, "unwind": 1,
          "kindle": 1, "play": 1, "hang": 1, "believe": 1, "doubt": 1}
_ADJECTIVES = {"furious": 1, "sly": 1, "careful": 1, "blithe": 1,
               "quick": 1, "fluffy": 1, "slow": 1, "quiet": 1,
               "ruthless": 1, "thin": 1, "close": 1, "dogged": 1,
               "daring": 1, "brave": 1, "stealthy": 1, "permanent": 1,
               "enticing": 1, "idle": 1, "busy": 1, "regular": 50,
               "final": 40, "ironic": 40, "even": 30, "bold": 20,
               "silent": 10, "express": 10, "pending": 10, "special": 10,
               "unusual": 10}
_ADVERBS = {"sometimes": 1, "always": 1, "never": 1, "furiously": 50,
            "slyly": 50, "carefully": 50, "blithely": 40, "quickly": 30,
            "fluffily": 20, "slowly": 1, "quietly": 1, "ruthlessly": 1,
            "thinly": 1, "closely": 1, "doggedly": 1, "daringly": 1,
            "bravely": 1, "stealthily": 1, "permanently": 1,
            "enticingly": 1, "idly": 1, "busily": 1, "regularly": 1,
            "finally": 1, "ironically": 1, "evenly": 1, "boldly": 1,
            "silently": 1}
_PREPOSITIONS = {"about": 50, "above": 50, "according to": 50, "across": 50,
                 "after": 50, "against": 40, "along": 40,
                 "alongside of": 30, "among": 30, "around": 20, "at": 10,
                 "atop": 1, "before": 1, "behind": 1, "beneath": 1,
                 "beside": 1, "besides": 1, "between": 1, "beyond": 1,
                 "by": 1, "despite": 1, "during": 1, "except": 1, "for": 1,
                 "from": 1, "in place of": 1, "inside": 1, "instead of": 1,
                 "into": 1, "near": 1, "of": 1, "on": 1, "outside": 1,
                 "over": 1, "past": 1, "since": 1, "through": 1,
                 "throughout": 1, "to": 1, "toward": 1, "under": 1,
                 "until": 1, "up": 1, "upon": 1, "without": 1, "with": 1,
                 "within": 1}
_AUXILIARIES = {"do": 1, "may": 1, "might": 1, "shall": 1, "will": 1,
                "would": 1, "can": 1, "could": 1, "should": 1,
                "ought to": 1, "must": 1, "will have to": 1,
                "shall have to": 1, "could have to": 1,
                "should have to": 1, "must have to": 1, "need to": 1,
                "try to": 1}
_TERMINATORS = {".": 50, ";": 1, ":": 1, "?": 1, "!": 1, "--": 1}
# noun phrase: N | J N | J, J N | D J N; verb phrase: V | X V | V D | X V D
_NP_W = (10, 20, 10, 50)
_VP_W = (30, 1, 40, 1)
# sentence: NP VP T | NP VP PP T | NP VP NP T | NP PP VP NP T | NP PP VP PP T
_SENTENCE_W = (3, 3, 3, 1, 1)


def _weighted(weights, base: int = 0) -> np.ndarray:
    """Ids base, base + 1, ..., each repeated its (integer) weight's times."""
    w = np.fromiter(weights, np.int64)
    return np.repeat(np.arange(base, base + len(w)), w)


def _draw(rng, ids: np.ndarray, n: int) -> np.ndarray:
    return ids[rng.integers(0, len(ids), n)]


class _Vocab:
    """Every word and mark of the grammar as a token; a word's bytes are
    followed by a space unless a mark comes next (marks carry their own)."""

    def __init__(self):
        lists = (_NOUNS, _VERBS, _ADJECTIVES, _ADVERBS, _PREPOSITIONS,
                 _AUXILIARIES)
        words = [w for d in lists for w in d] + ["the"]
        marks = [", "] + [t + " " for t in _TERMINATORS]
        self.n_words = len(words)
        toks = [w.encode() for w in words] + [m.encode() for m in marks]
        width = max(map(len, toks)) + 1
        # variant 0: as followed by a word; variant 1: before a mark
        self.table = np.zeros((2 * len(toks), width), np.uint8)
        self.lens = np.zeros(2 * len(toks), np.int64)
        for i, t in enumerate(toks):
            for v in (0, 1):
                b = t + (b" " if i < self.n_words and v == 0 else b"")
                self.table[2 * i + v, :len(b)] = np.frombuffer(b, np.uint8)
                self.lens[2 * i + v] = len(b)
        # each list's token ids, every id repeated its weight's times, so a
        # uniform draw over the row is a weighted draw of a word
        base, self.draw = 0, []
        for d in lists:
            self.draw.append(_weighted(d.values(), base))
            base += len(d)
        self.the = self.n_words - 1
        self.comma = self.n_words
        self.terms = _weighted(_TERMINATORS.values(), self.n_words + 1)


_VOCAB = _Vocab()
NOUN, VERB, ADJ, ADV, PREP, AUX = range(6)


def _pick(rng, kind: int, n: int) -> np.ndarray:
    return _draw(rng, _VOCAB.draw[kind], n)


def _choice(rng, weights, n: int) -> np.ndarray:
    return _draw(rng, _weighted(weights), n)


def _noun_phrases(rng, n: int) -> np.ndarray:
    """[n, 4] token ids (-1: none) of n noun phrases."""
    form = _choice(rng, _NP_W, n)
    out = np.full((n, 4), -1, np.int64)
    j1, j2, d = _pick(rng, ADJ, n), _pick(rng, ADJ, n), _pick(rng, ADV, n)
    out[:, 3] = _pick(rng, NOUN, n)
    out[:, 2] = np.where(form >= 1, np.where(form == 2, j2, j1), -1)
    out[:, 1] = np.where(form == 2, _VOCAB.comma,
                         np.where(form == 3, d, -1))
    out[:, 0] = np.where(form == 2, j1, -1)
    return out


def _verb_phrases(rng, n: int) -> np.ndarray:
    form = _choice(rng, _VP_W, n)
    out = np.full((n, 3), -1, np.int64)
    out[:, 0] = np.where(form % 2 == 1, _pick(rng, AUX, n), -1)
    out[:, 1] = _pick(rng, VERB, n)
    out[:, 2] = np.where(form >= 2, _pick(rng, ADV, n), -1)
    return out


def _prep_phrases(rng, n: int) -> np.ndarray:
    out = np.empty((n, 6), np.int64)
    out[:, 0] = _pick(rng, PREP, n)
    out[:, 1] = _VOCAB.the
    out[:, 2:] = _noun_phrases(rng, n)
    return out


def text_pool(rng, size: int = POOL_BYTES) -> bytes:
    """`size` bytes of sentences of the comment grammar."""
    v = _VOCAB
    n = size // 40 + 1024  # a sentence is about 50 bytes
    out = b""
    while len(out) < size:
        g = _choice(rng, _SENTENCE_W, n)
        none6 = np.full((n, 6), -1, np.int64)
        np2 = np.concatenate([_noun_phrases(rng, n), none6[:, :2]], 1)
        pp_mid = np.where((g >= 3)[:, None], _prep_phrases(rng, n), none6)
        tail = np.where(((g == 1) | (g == 4))[:, None], _prep_phrases(rng, n),
                        np.where(((g == 2) | (g == 3))[:, None], np2, none6))
        term = _draw(rng, v.terms, n)[:, None]
        toks = np.concatenate([_noun_phrases(rng, n), pp_mid,
                               _verb_phrases(rng, n), tail, term], 1).ravel()
        toks = toks[toks >= 0]
        before_mark = np.append(toks[1:] >= v.n_words, False)
        var = 2 * toks + (before_mark & (toks < v.n_words))
        keep = np.arange(v.table.shape[1])[None, :] < v.lens[var][:, None]
        out += v.table[var][keep].tobytes()
    return out[:size]


def _order_keys(i: np.ndarray) -> np.ndarray:
    """dbgen's sparse keys: of every 32 keys the first 8 are used."""
    return ((i >> 3) << 5) | (i & 7)


def _rows(rng, first_order: int, n_orders: int) -> dict:
    """Every line of orders first_order .. first_order + n_orders - 1
    (1-based order indices), column by column."""
    lines = rng.integers(1, 8, n_orders)
    n = int(lines.sum())
    order = np.repeat(np.arange(first_order, first_order + n_orders), lines)
    starts = np.cumsum(lines) - lines
    linenumber = np.arange(n) - np.repeat(starts, lines) + 1
    orderdate = np.repeat(rng.integers(STARTDATE, ENDDATE - 151 + 1,
                                       n_orders), lines)
    partkey = rng.integers(1, PARTS + 1, n)
    supp_i = rng.integers(0, 4, n)
    suppkey = (partkey + supp_i * (SUPPLIERS // 4 + (partkey - 1)
                                   // SUPPLIERS)) % SUPPLIERS + 1
    quantity = rng.integers(1, 51, n)
    retail_cents = (90000 + (partkey // 10) % 20001 + 100 * (partkey % 1000))
    shipdate = orderdate + rng.integers(1, 122, n)
    commitdate = orderdate + rng.integers(30, 91, n)
    receiptdate = shipdate + rng.integers(1, 31, n)
    returned = receiptdate <= CURRENTDATE
    returnflag = np.where(returned, rng.integers(0, 2, n), 2)  # R, A / N
    linestatus = (shipdate <= CURRENTDATE).astype(np.int64)    # O / F
    return {
        "l_orderkey": _order_keys(order), "l_partkey": partkey,
        "l_suppkey": suppkey, "l_linenumber": linenumber,
        "l_quantity": quantity.astype(np.float64),
        "l_extendedprice": (quantity * retail_cents) / 100.0,
        "l_discount": rng.integers(0, 11, n) / 100.0,
        "l_tax": rng.integers(0, 9, n) / 100.0,
        "l_returnflag": returnflag, "l_linestatus": linestatus,
        "l_shipdate": shipdate, "l_commitdate": commitdate,
        "l_receiptdate": receiptdate,
        "l_shipinstruct": rng.integers(0, len(INSTRUCTIONS), n),
        "l_shipmode": rng.integers(0, len(MODES), n),
        "l_comment": (rng.integers(0, POOL_BYTES - 43, n),
                      rng.integers(10, 44, n)),
    }


def _strings(words, idx: np.ndarray) -> bytes:
    """PLAIN BYTE_ARRAY values of `words[idx]`."""
    ent = [len(w).to_bytes(4, "little") + w for w in words]
    table = np.zeros((len(ent), max(map(len, ent))), np.uint8)
    lens = np.array([len(e) for e in ent], np.int64)
    for i, e in enumerate(ent):
        table[i, :len(e)] = np.frombuffer(e, np.uint8)
    keep = np.arange(table.shape[1])[None, :] < lens[idx][:, None]
    return table[idx][keep].tobytes()


def _comments(pool: np.ndarray, offs: np.ndarray, lens: np.ndarray) -> bytes:
    n = len(offs)
    rows = np.empty((n, 4 + 43), np.uint8)
    rows[:, :4] = lens.astype("<u4").view(np.uint8).reshape(n, 4)
    rows[:, 4:] = np.lib.stride_tricks.sliding_window_view(pool, 43)[offs]
    keep = np.arange(4 + 43)[None, :] < (lens + 4)[:, None]
    return rows[keep].tobytes()


def plain(column: str, values, pool: np.ndarray) -> bytes:
    """A column's values in Parquet's PLAIN encoding."""
    if column == "l_comment":
        return _comments(pool, *values)
    if column == "l_returnflag":
        return _strings((b"R", b"A", b"N"), values)
    if column == "l_linestatus":
        return _strings((b"O", b"F"), values)
    if column == "l_shipinstruct":
        return _strings(INSTRUCTIONS, values)
    if column == "l_shipmode":
        return _strings(MODES, values)
    if values.dtype == np.float64:
        return values.astype("<f8").tobytes()
    if column in ("l_orderkey", "l_partkey", "l_suppkey"):
        return values.astype("<i8").tobytes()
    return values.astype("<i4").tobytes()  # line numbers and dates


# PLAIN bytes a row on average (8 where absent), to size the orders drawn
_ROW_BYTES = {"l_linenumber": 4, "l_returnflag": 5, "l_linestatus": 5,
              "l_shipdate": 4, "l_commitdate": 4, "l_receiptdate": 4,
              "l_shipinstruct": 16, "l_shipmode": 8.3, "l_comment": 30.5}


def make(lengths, rng) -> list:
    """One page body a length: record i is a page of column
    ``PLAN[i % len(PLAN)]``; each run of ``len(PLAN)`` records is one row
    group, whose columns' pages continue one another's values."""
    lengths = np.asarray(lengths, np.int64)
    pool = np.frombuffer(text_pool(rng), np.uint8)
    first = int(rng.integers(1, ORDERS // 2))
    out = []
    for g0 in range(0, len(lengths), len(PLAN)):
        group = list(zip(PLAN, lengths[g0:g0 + len(PLAN)]))
        need = {}
        for c, n in group:
            need[c] = need.get(c, 0) + int(n)
        streams = dict.fromkeys(need, b"")
        while True:
            short = max((need[c] - len(streams[c])) / _ROW_BYTES.get(c, 8)
                        for c in need)
            if short <= 0:
                break
            n_orders = int(short / 4 * 1.02) + 256  # 4 lines an order
            rows = _rows(rng, first, n_orders)
            first += n_orders
            for c in need:
                if len(streams[c]) < need[c]:
                    streams[c] += plain(c, rows[c], pool)
        at = dict.fromkeys(need, 0)
        for c, n in group:
            out.append(streams[c][at[c]:at[c] + int(n)])
            at[c] += int(n)
    return out
