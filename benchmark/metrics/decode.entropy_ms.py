"""The Huffman and FSE stages' wall ms a call, their operand uploads
included (``timings['huf'] + timings['fse']``)."""

UNIT = "ms"
LAYER = "Huffman and FSE decode kernels with their uploads"
MOVES = "decode_GBps"


KEYS = ('huf', 'fse')


def read(ctx):
    s = ctx["stages"]
    if ctx["plane"] != "decode" or not s or not s["calls"]:
        return None
    got = [s["timings"][k] for k in KEYS if k in s["timings"]]
    return 1e3 * sum(got) / s["calls"] if got else None
