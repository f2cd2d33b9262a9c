"""The median request's t_post span (FASTA re-parse, post-processing, SAM
lines), in ms."""

import numpy as np


def read(ctx):
    t = [r["t_post"] for r in ctx.replies if r["ok"]]
    return float(np.median(t)) * 1e3 if t else None
