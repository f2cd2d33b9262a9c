"""run_pipeline's t_post span in ms a 1,000 reads (_spans.ms_per_kread)."""

from drm_bench.metrics import _spans


def read(ctx):
    return _spans.ms_per_kread(ctx, "t_post")
