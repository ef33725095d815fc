"""The planner's own time, wall ms a call: ``timings['plan']`` less its
children ``plan.native`` and ``plan.python``, which leaves the loop over
the native planner's rows."""

UNIT = "ms"
LAYER = "decode planner (host)"
MOVES = "decode_GBps"


def read(ctx):
    s = ctx["stages"]
    if ctx["plane"] != "decode" or not s or not s["calls"]:
        return None
    t = s["timings"]
    if "n.lanes" not in t or "plan" not in t:  # a program without the spans
        return None
    own = t["plan"] - t.get("plan.native", 0.0) - t.get("plan.python", 0.0)
    return 1e3 * own / s["calls"]
