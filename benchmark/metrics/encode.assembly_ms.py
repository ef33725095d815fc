"""The assembly stage's wall ms a call (``timings['assembly']``)."""

UNIT = "ms"
LAYER = "assembly kernel"
MOVES = "encode_GBps"


KEYS = ('assembly',)


def read(ctx):
    s = ctx["stages"]
    if ctx["plane"] != "encode" or not s or not s["calls"]:
        return None
    got = [s["timings"][k] for k in KEYS if k in s["timings"]]
    return 1e3 * sum(got) / s["calls"] if got else None
