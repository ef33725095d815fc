"""The records packed into each bucket's arrays and uploaded, wall ms a
call (``timings['pack']``, its child ``pack.upload`` included)."""

UNIT = "ms"
LAYER = "encode entry"
MOVES = "encode_GBps"


KEYS = ('pack',)


def read(ctx):
    s = ctx["stages"]
    if ctx["plane"] != "encode" or not s or not s["calls"]:
        return None
    got = [s["timings"][k] for k in KEYS if k in s["timings"]]
    return 1e3 * sum(got) / s["calls"] if got else None
