"""The Python planner's frames, wall ms a call
(``timings['plan.python']``: every frame outside the native planner's
envelope; 0 where no frame took it)."""

UNIT = "ms"
LAYER = "decode planner (host)"
MOVES = "decode_GBps"


KEYS = ('plan.python',)


def read(ctx):
    s = ctx["stages"]
    if ctx["plane"] != "decode" or not s or not s["calls"]:
        return None
    t = s["timings"]
    if "n.lanes" not in t:  # a program without these spans
        return None
    return 1e3 * sum(t.get(k, 0.0) for k in KEYS) / s["calls"]
