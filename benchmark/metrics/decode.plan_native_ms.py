"""The native planner's call, wall ms a call (``timings['plan.native']``
of ``decode_batch_device``, summed over the calls of the traced run's
timed half)."""

UNIT = "ms"
LAYER = "decode planner (host)"
MOVES = "decode_GBps"


KEYS = ('plan.native',)


def read(ctx):
    s = ctx["stages"]
    if ctx["plane"] != "decode" or not s or not s["calls"]:
        return None
    t = s["timings"]
    if "n.lanes" not in t:  # a program without these spans
        return None
    return 1e3 * sum(t.get(k, 0.0) for k in KEYS) / s["calls"]
