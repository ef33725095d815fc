"""The dependent rounds' uploads of their meta and start rows, wall ms a
call (``timings['mb_exec.upload']``, inside ``mb_exec``; a pageable copy
also waits for the round before it on the stream)."""

UNIT = "ms"
LAYER = "multi-block dependent rounds"
MOVES = "decode_GBps"


KEYS = ('mb_exec.upload',)


def read(ctx):
    s = ctx["stages"]
    if ctx["plane"] != "decode" or not s or not s["calls"]:
        return None
    t = s["timings"]
    if "n.mb_frames" not in t:  # no multi-block frame, or no such span
        return None
    return 1e3 * sum(t.get(k, 0.0) for k in KEYS) / s["calls"]
