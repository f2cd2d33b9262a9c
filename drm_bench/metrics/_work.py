"""The least time of the window's work by kernel (roofline/), and the
kernel seconds the trace holds for each.  The scan's work is the one of
the file the configuration's scan_kernel names, roofline/<scan_kernel>.py;
the rerank's is the one its own file counts, reference/rerank_<rerank>.py
(the request's rerank, "l2" where it names none), added to the kernel it
runs on."""

import importlib

from drm_bench.reference import judge
from drm_bench.roofline import gru_fwd


def least_s(ctx) -> dict:
    reads = sum(r["reads"] for r in ctx.replies if r["ok"])
    scan = importlib.import_module("drm_bench.roofline." + ctx.config["scan_kernel"])
    out = {gru_fwd.KERNEL: gru_fwd.least_s(reads),
           scan.KERNEL: scan.scan_least_s(reads, ctx.ntotal, ctx.config)}
    for kernel, s in judge.rerank_kind(ctx.traffic["request"]).least_s(ctx, reads).items():
        out[kernel] = out.get(kernel, 0.0) + s
    return out


def roofline(ctx, kernel: str):
    """Least time over the kernel's traced seconds, in %; None when the
    trace holds no run of it."""
    if ctx.trace is None:
        return None
    ran = sum(s for name, s in ctx.trace.kernel_s.items() if kernel in name)
    bound = least_s(ctx).get(kernel)
    if ran <= 0 or bound is None:
        return None
    return 100.0 * bound / ran
