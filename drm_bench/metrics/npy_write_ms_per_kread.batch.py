"""The program's write.npy spans (indices.npy and distances.npy written) in
ms a 1,000 reads (_program.ms_per_kread)."""

from drm_bench.metrics import _program


def read(ctx):
    return _program.ms_per_kread(ctx, "write.npy")
