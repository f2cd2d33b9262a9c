"""The card's peak rates that every roofline share and the step's mfu are
held to.  Published rates are NVIDIA's H100 SXM data sheet (dense, no
sparsity, at the 700 W limit); the DPX rate has no published figure and is
the one the port's chip_smoke.py phase 3 measured on an H100 80GB HBM3 at
700 W (sw_dpx_rate, 16-bit halves), frozen here."""

HBM_BYTES_S = 3.35e12       # HBM3 bandwidth
TF32_FLOPS_S = 495e12       # TF32 tensor cores
INT8_OPS_S = 1979e12        # int8 tensor cores (an multiply-add is 2)
DPX_OPS_S = 16.70e12        # DPX add-max instructions, measured


def least_s(ops: float, ops_s: float, nbytes: float) -> float:
    """The least time: the larger of the operations over their peak and the
    bytes, each counted once, over the memory rate."""
    return max(ops / ops_s, nbytes / HBM_BYTES_S)
