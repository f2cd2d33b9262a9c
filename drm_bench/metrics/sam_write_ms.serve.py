"""The median request's post.sam span (SAM lines formatted and written), in
ms."""

from drm_bench.metrics import _program


def read(ctx):
    return _program.median_ms(ctx, "post.sam")
