"""The program's embed.parse spans (FASTQ parse and read strings) in ms a
1,000 reads (_program.ms_per_kread)."""

from drm_bench.metrics import _program


def read(ctx):
    return _program.ms_per_kread(ctx, "embed.parse")
