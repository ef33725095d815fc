"""The decode's operand uploads, wall ms a call (``timings['huf.upload']
+ ['fse.upload'] + ['exec.upload']``: the entropy kernels' operands, the
host sequence rows, the pool, the meta and window rows)."""

UNIT = "ms"
LAYER = "Huffman and FSE decode kernels with their uploads"
MOVES = "decode_GBps"


KEYS = ('huf.upload', 'fse.upload', 'exec.upload')


def read(ctx):
    s = ctx["stages"]
    if ctx["plane"] != "decode" or not s or not s["calls"]:
        return None
    t = s["timings"]
    if "n.lanes" not in t:  # a program without these spans
        return None
    return 1e3 * sum(t.get(k, 0.0) for k in KEYS) / s["calls"]
