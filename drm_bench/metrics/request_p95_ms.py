"""95th percentile of the latency of every request of the window, from the
yield of its line to the write of its reply (a failed request counts at
its latency too)."""

import numpy as np


def read(ctx):
    lat = [r["replied"] - r["sent"] for r in ctx.replies]
    return float(np.percentile(lat, 95)) * 1e3 if lat else None
