"""Frames the planner sent to the host engine, of all frames of the
traced run's timed half (``host_results`` of each call)."""

UNIT = "%"
LAYER = "decode planner (host)"
MOVES = "decode_GBps"


def read(ctx):
    s = ctx["stages"]
    if ctx["plane"] != "decode" or not s or not s["items"]:
        return None
    return 100.0 * s["host_routed"] / s["items"]
