"""The card's time in the search's window-minima selection (smallest_k,
gather and merge after each chunk's scan: CUDA events the program attaches
to search.scan as select_device_ms) in ms a 1,000 reads."""

from drm_bench.metrics import _program


def read(ctx):
    return _program.attr_ms_per_kread(ctx, "search.scan", "select_device_ms")
