"""The host literal (Huffman) table builders, wall ms a call
(``timings['tables.lit']`` of ``encode_frames_device``, summed over
chunks)."""

UNIT = "ms"
LAYER = "host tables"
MOVES = "encode_GBps"


KEYS = ('tables.lit',)


def read(ctx):
    s = ctx["stages"]
    if ctx["plane"] != "encode" or not s or not s["calls"]:
        return None
    got = [s["timings"][k] for k in KEYS if k in s["timings"]]
    return 1e3 * sum(got) / s["calls"] if got else None
