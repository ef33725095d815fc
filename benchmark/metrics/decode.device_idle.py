"""The share of the profiled half in which no operation ran on the card:
1 - the union of the device's operations over the window."""

UNIT = "%"
LAYER = "device (H100)"
MOVES = "decode_GBps"


def read(ctx):
    p = ctx["profile"]
    if (not ctx["on_card"] or ctx["plane"] != "decode" or not p
            or not p.get("window_s")):
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
