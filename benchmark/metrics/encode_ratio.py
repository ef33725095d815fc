"""Input bytes over frame bytes, over every call of the window."""

UNIT = "x"
LAYER = "end to end"
MOVES = None


def read(ctx):
    w = ctx["window"]
    if ctx["plane"] != "encode" or not w or w["frame_bytes"] <= 0:
        return None
    return w["content_bytes"] / w["frame_bytes"]
