"""The frames brought back as bytes, wall ms a call
(``timings['materialize']``: each chunk's rows and lengths copied to
the host, then each record's frame cut from its row)."""

UNIT = "ms"
LAYER = "encode entry"
MOVES = "encode_GBps"


KEYS = ('materialize',)


def read(ctx):
    s = ctx["stages"]
    if ctx["plane"] != "encode" or not s or not s["calls"]:
        return None
    got = [s["timings"][k] for k in KEYS if k in s["timings"]]
    return 1e3 * sum(got) / s["calls"] if got else None
