"""Work of the PQFLAT scan (kernel #4, pq_winmin): the exact distance of a
read to a row's int8 reconstruction is one 128-wide int8 dot product (the
cheapest exact form: a table-lookup form needs m adds a pair at the much
lower integer rate), at the int8 tensor-core peak; each code byte (m a row)
and the codebook read once."""

from drm_bench.roofline import peaks

DIM = 128
KERNEL = "pq_winmin"


def least_s(reads: int, rows: int, m: int, ksub: int = 256) -> float:
    return peaks.least_s(2.0 * DIM * reads * rows, peaks.INT8_OPS_S,
                         rows * m + ksub * DIM + reads * DIM)


def scan_least_s(reads: int, rows: int, cfg: dict) -> float:
    """least_s for a configuration whose scan_kernel names this file."""
    return least_s(reads, rows, int(cfg["m_pq"]), 1 << int(cfg["nbits"]))
