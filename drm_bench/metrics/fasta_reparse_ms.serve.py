"""The median request's post.fasta span (the reference FASTA parsed again
for the request), in ms."""

from drm_bench.metrics import _program


def read(ctx):
    return _program.median_ms(ctx, "post.fasta")
