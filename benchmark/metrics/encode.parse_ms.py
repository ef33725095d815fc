"""The parse stage's wall ms a call, its counts' copy to the host
included (``timings['parse']``)."""

UNIT = "ms"
LAYER = "parse kernel with the histograms"
MOVES = "encode_GBps"


KEYS = ('parse',)


def read(ctx):
    s = ctx["stages"]
    if ctx["plane"] != "encode" or not s or not s["calls"]:
        return None
    got = [s["timings"][k] for k in KEYS if k in s["timings"]]
    return 1e3 * sum(got) / s["calls"] if got else None
