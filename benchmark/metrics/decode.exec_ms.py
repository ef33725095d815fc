"""The lane decode stage's wall ms a call (``timings['exec']``)."""

UNIT = "ms"
LAYER = "lane decode kernel"
MOVES = "decode_GBps"


KEYS = ('exec',)


def read(ctx):
    s = ctx["stages"]
    if ctx["plane"] != "decode" or not s or not s["calls"]:
        return None
    got = [s["timings"][k] for k in KEYS if k in s["timings"]]
    return 1e3 * sum(got) / s["calls"] if got else None
