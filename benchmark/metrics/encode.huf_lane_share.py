"""Lanes given a Huffman literal table, of every lane the encode plane's
table builders took (``timings['n.huf_lanes'] / ['n.table_lanes']``)."""

UNIT = "%"
LAYER = "host tables"
MOVES = "encode_GBps"


def read(ctx):
    s = ctx["stages"]
    if ctx["plane"] != "encode" or not s:
        return None
    t = s["timings"]
    if not t.get("n.table_lanes") or "n.huf_lanes" not in t:
        return None
    return 100.0 * t["n.huf_lanes"] / t["n.table_lanes"]
