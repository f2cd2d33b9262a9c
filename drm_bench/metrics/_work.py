"""The least time of the window's work by kernel (roofline/), and the
kernel seconds the trace holds for each.  The scan's work is the one of
the file the configuration's scan_kernel names, roofline/<scan_kernel>.py;
the rerank's is the one of the traffic's rerank."""

import importlib

from drm_bench.roofline import gru_fwd, sw_score

RERANK = {"sw": sw_score}


def least_s(ctx) -> dict:
    reads = sum(r["reads"] for r in ctx.replies if r["ok"])
    req = ctx.traffic["request"]
    scan = importlib.import_module("drm_bench.roofline." + ctx.config["scan_kernel"])
    out = {gru_fwd.KERNEL: gru_fwd.least_s(reads),
           scan.KERNEL: scan.scan_least_s(reads, ctx.ntotal, ctx.config)}
    rerank = req.get("rerank")
    if rerank is not None:
        if rerank not in RERANK:
            raise ValueError(f"no roofline for rerank {rerank!r}")
        out[RERANK[rerank].KERNEL] = RERANK[rerank].least_s(
            reads * int(req["k"]), int(ctx.config["ref_len"]), int(ctx.traffic["read_len"]) + 2)
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
