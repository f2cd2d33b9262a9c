"""Reads answered over the window, as reads_per_s, in the cells whose
requests write SAM lines: host work that spreads more from run to run, so
a metric and a bound of its own."""

from drm_bench.metrics import _spans


def read(ctx):
    return _spans.reads(ctx) / ctx.window_s
