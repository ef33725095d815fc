"""The encode plane's kernels' share of their roofline: the plane's
input bytes read once and frame bytes written once, at the card's published
3.35 TB/s, over every kernel's device time in the profiled half (a
kernel whose wrapper counted more launches than the profiler recorded
scaled by counted / recorded)."""

from benchmark.devtrace import kernel_seconds


UNIT = "%"
LAYER = "encode kernels"
MOVES = "encode_GBps"


def read(ctx):
    p = ctx["profile"]
    if (not ctx["on_card"] or ctx["plane"] != "encode" or not p
            or not p.get("kernel_s")):
        return None
    t = kernel_seconds(p, ctx["counter_specs"])
    if t <= 0:
        return None
    work = p["content_bytes"] + p["frame_bytes"]
    return 100.0 * work / ctx["peak_bytes_per_s"] / t
