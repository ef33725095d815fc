"""The planner's wall ms a call (``timings['plan']`` of
``decode_batch_device``, the window's total over its calls)."""

UNIT = "ms"
LAYER = "decode planner (host)"
MOVES = "decode_GBps"


KEYS = ('plan',)


def read(ctx):
    s = ctx["stages"]
    if ctx["plane"] != "decode" or not s or not s["calls"]:
        return None
    got = [s["timings"][k] for k in KEYS if k in s["timings"]]
    return 1e3 * sum(got) / s["calls"] if got else None
