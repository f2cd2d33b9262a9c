"""The whole mapping step's share of the card's peak: the least time of the
window's work (every read through the encoder at the TF32 peak, its scan
at the int8 peak, its Smith-Waterman cells at the DPX rate) over the
traced window's length.  The bound does not name a kernel, so it still
holds a gain after a kernel is fused away."""

from drm_bench.metrics import _work


def read(ctx):
    if ctx.trace is None:
        return None
    return 100.0 * sum(_work.least_s(ctx).values()) / ctx.trace.window_s
