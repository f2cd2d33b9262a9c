"""The program's post.l2.pack spans (the rows the host builds from the
genome for the re-embed's upload, from the ids' translation to the wire
rows) in ms a 1,000 reads; None on a program without them."""

from drm_bench.metrics import _program


def read(ctx):
    return _program.ms_per_kread(ctx, "post.l2.pack")
