"""The multi-block frames' literal bytes that the planner decoded on the
host, of every literal byte their compressed blocks regenerate
(``timings['n.mb_host_lit_bytes'] / ['n.mb_lit_bytes']``: Huffman
sections that are treeless, of a 12-bit table or wider than the kernel's
window)."""

UNIT = "%"
LAYER = "decode planner (host)"
MOVES = "decode_GBps"


def read(ctx):
    s = ctx["stages"]
    if ctx["plane"] != "decode" or not s:
        return None
    t = s["timings"]
    if not t.get("n.mb_lit_bytes") or "n.mb_host_lit_bytes" not in t:
        return None
    return 100.0 * t["n.mb_host_lit_bytes"] / t["n.mb_lit_bytes"]
