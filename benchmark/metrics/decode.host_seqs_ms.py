"""The planner's host sequence decodes, wall ms a call
(``timings['plan.host_seqs']``: lanes whose sequence bitstream is wider
than the FSE kernel's window, inside ``plan.python``; 0 where none)."""

UNIT = "ms"
LAYER = "decode planner (host)"
MOVES = "decode_GBps"


KEYS = ('plan.host_seqs',)


def read(ctx):
    s = ctx["stages"]
    if ctx["plane"] != "decode" or not s or not s["calls"]:
        return None
    t = s["timings"]
    if "n.lanes" not in t:  # a program without these spans
        return None
    return 1e3 * sum(t.get(k, 0.0) for k in KEYS) / s["calls"]
