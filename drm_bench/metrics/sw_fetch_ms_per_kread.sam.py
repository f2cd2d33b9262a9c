"""The program's post.sw.fetch spans (candidate expansion, the host window
fetch and the pair layout of the SW rerank) in ms a 1,000 reads."""

from drm_bench.metrics import _program


def read(ctx):
    return _program.ms_per_kread(ctx, "post.sw.fetch")
