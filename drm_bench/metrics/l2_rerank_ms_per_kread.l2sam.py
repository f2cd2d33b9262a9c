"""The program's post.l2 spans (past stride 1: the expansion and dedup, the
host window rows, the re-embed through #1, the sqrt-L2 rerank and its
download) in ms a 1,000 reads."""

from drm_bench.metrics import _program


def read(ctx):
    return _program.ms_per_kread(ctx, "post.l2")
