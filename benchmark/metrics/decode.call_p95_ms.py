"""The 95th percentile of the calls' latencies in the traced run's timed
half (host clock, each call ending in its synchronisation); at least 20
calls, their count printed on standard error."""

import numpy as np


UNIT = "ms"
LAYER = "decode entry"
MOVES = "decode_GBps"


def read(ctx):
    s = ctx["stages"]
    if ctx["plane"] != "decode" or not s or len(s["latencies"]) < 20:
        return None
    return 1e3 * float(np.percentile(s["latencies"], 95))
