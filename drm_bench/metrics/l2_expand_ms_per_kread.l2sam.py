"""The program's post.l2.expand spans (each sparse hit expanded to its
2 stride - 1 dense windows, then the request's unique windows found) in ms a
1,000 reads; None on a program without them."""

from drm_bench.metrics import _program


def read(ctx):
    return _program.ms_per_kread(ctx, "post.l2.expand")
