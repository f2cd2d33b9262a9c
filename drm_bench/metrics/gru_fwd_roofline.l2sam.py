"""gru_fwd's share of its roofline: the least time of the window's work for
it (roofline/gru_fwd.py: the reads, and each window the L2 rerank
re-embeds as one more read) over the seconds the device trace shows it
ran."""

from drm_bench.metrics import _work


def read(ctx):
    return _work.roofline(ctx, "gru_fwd")
