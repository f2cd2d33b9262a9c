"""Reads answered over the window: every read of every request completed
in it, over the window's host-clock length (the cells whose requests write
npy files only)."""

from drm_bench.metrics import _spans


def read(ctx):
    return _spans.reads(ctx) / ctx.window_s
