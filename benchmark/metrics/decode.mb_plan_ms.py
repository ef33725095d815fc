"""The multi-block frames' block walks in the planner, wall ms a call
(``timings['plan.multiblock']``, one span a frame inside ``plan.python``;
its host sequence decodes included)."""

UNIT = "ms"
LAYER = "decode planner (host)"
MOVES = "decode_GBps"


KEYS = ('plan.multiblock',)


def read(ctx):
    s = ctx["stages"]
    if ctx["plane"] != "decode" or not s or not s["calls"]:
        return None
    t = s["timings"]
    if "n.mb_frames" not in t:  # no multi-block frame, or no such span
        return None
    return 1e3 * sum(t.get(k, 0.0) for k in KEYS) / s["calls"]
