"""The multi-block frames' dependent rounds, wall ms a call
(``timings['mb_exec']``: each group's accumulator, its rounds' uploads
and one lane decode launch a round, the card synchronised at the end)."""

UNIT = "ms"
LAYER = "multi-block dependent rounds"
MOVES = "decode_GBps"


KEYS = ('mb_exec',)


def read(ctx):
    s = ctx["stages"]
    if ctx["plane"] != "decode" or not s or not s["calls"]:
        return None
    t = s["timings"]
    if "n.mb_frames" not in t:  # no multi-block frame, or no such counter
        return None
    return 1e3 * sum(t.get(k, 0.0) for k in KEYS) / s["calls"]
