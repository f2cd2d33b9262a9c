"""Work of the Smith-Waterman rerank (kernel #3, sw_score): every cell of
every pair's DP (window length x wrapped read length), at 2.75 DPX
instructions a cell (two cells a register in 16-bit halves: the match, its
add-max, the add-max of diagonal and up, the relu add-max of left, the
add-max that keeps H - 1 and half a three-way max, 5.5 for two cells),
at the measured DPX rate."""

from drm_bench.roofline import peaks

OPS_PER_CELL = 5.5 / 2
KERNEL = "sw_score"


def least_s(pairs: int, window_len: int, read_len: int) -> float:
    cells = pairs * window_len * read_len
    return peaks.least_s(OPS_PER_CELL * cells, peaks.DPX_OPS_S,
                         pairs * (window_len + read_len))
