"""Lanes whose sequences the planner decoded on the host, of every lane
the executor took (``timings['n.host_seq_lanes'] / ['n.lanes']``)."""

UNIT = "%"
LAYER = "decode planner (host)"
MOVES = "decode_GBps"


def read(ctx):
    s = ctx["stages"]
    if ctx["plane"] != "decode" or not s:
        return None
    t = s["timings"]
    if not t.get("n.lanes") or "n.host_seq_lanes" not in t:
        return None
    return 100.0 * t["n.host_seq_lanes"] / t["n.lanes"]
