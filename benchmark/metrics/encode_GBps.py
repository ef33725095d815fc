"""The input bytes encoded over the window's every call, divided by the
window's seconds (the first call's start to the last call's end)."""

UNIT = "GB/s"
LAYER = "end to end"
MOVES = None


def read(ctx):
    w = ctx["window"]
    if ctx["plane"] != "encode" or not w or w["seconds"] <= 0:
        return None
    return w["content_bytes"] / w["seconds"] / 1e9
