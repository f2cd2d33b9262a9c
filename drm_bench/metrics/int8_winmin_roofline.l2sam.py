"""int8_winmin's share of its roofline: the least time of the window's work for
it (roofline/int8_winmin.py) over the seconds the device trace shows it ran."""

from drm_bench.metrics import _work


def read(ctx):
    return _work.roofline(ctx, "int8_winmin")
