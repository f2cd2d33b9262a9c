"""Work of the INT8FLAT scan (kernel #2, int8_winmin): one 128-wide int8
dot product for every (read, index row) pair, 2 operations a multiply-add,
at the int8 tensor-core peak; each code byte read once."""

from drm_bench.roofline import peaks

DIM = 128
KERNEL = "int8_winmin"


def least_s(reads: int, rows: int) -> float:
    return peaks.least_s(2.0 * DIM * reads * rows, peaks.INT8_OPS_S,
                         rows * DIM + reads * DIM)


def scan_least_s(reads: int, rows: int, cfg: dict) -> float:
    """least_s for a configuration whose scan_kernel names this file."""
    return least_s(reads, rows)
