"""Where a benchmark cell's device-idle time goes, by the program's own spans.

Runs cells of BENCHMARK.json in this process through the benchmark's
harness (``drm_bench.harness.run_cell``, on the card), in one of three
modes a run:

  * ``off``: no trace, as the end-to-end metrics are measured;
  * ``on``: the traced window (``--trace 1``): the profiler's CUDA
    activity and the program's spans;
  * ``prof``: the traced window with the program's span recording held
    off, so ``on`` against ``prof`` is what recording costs and ``prof``
    against ``off`` what the profiler costs.

For each run it prints one JSON line: the cell's end-to-end and per-layer
metrics (read by the benchmark's own metric files from the run's context)
with the median request's t_embed / t_search / t_post, and, for a
traced run, the window's device-idle seconds by the deepest
program span then open (``drm_bench/metrics/_program.idle_breakdown``: a
leaf's name, ``serve.request (self)``, ``<parent> (self)``, ``between
requests``), the share not under a leaf or the root's self time, the share
of each pipeline span its children cover, and the harness's own
reconstruction of the idle gaps beside it.  ``--no-check`` skips the
reference's check after the window: the judge then reports no number
within its limit, and the line's ``correct`` is null.

    python scripts/span_breakdown.py --cells ecoli_int8flat.npy8k \\
        --modes on off prof --seeds 11 12 [--seconds 30] [--no-check]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
import types
from unittest import mock

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run(cell: str, mode: str, seed: int, seconds: float, check: bool) -> dict:
    from deepreadmapper_tpu_torch.utils import trace as ptrace
    from drm_bench import harness
    from drm_bench.metrics import _program
    from drm_bench.reference import judge

    kept = {}

    class Kept(harness.Context):
        def __init__(self, **kw):
            super().__init__(**kw)
            kept["ctx"] = self

    patches = [mock.patch.object(harness, "Context", Kept)]
    if mode == "prof":
        patches.append(mock.patch.object(
            ptrace, "_profiler", types.SimpleNamespace(_is_profiler_enabled=False)))
    if not check:
        patches.append(mock.patch.object(judge, "judge", lambda view, *a, **k: (
            {name: float("nan") for name in view["config"]["limits"]}, {})))
    if hasattr(ptrace, "clear"):
        ptrace.clear()
    t0 = time.monotonic()
    for p in patches:
        p.start()
    try:
        result, info = harness.run_cell(cell, seed, seconds, mode != "off", "cuda", t0)
    finally:
        for p in patches:
            p.stop()
    ctx = kept["ctx"]
    bench = harness.load_bench()
    out = {"cell": cell, "mode": mode, "seed": seed, "correct": result["correct"] if check
           else None, "device": result["device"]["kind"], "attempted": result["attempted"]}
    out["metrics"] = {}
    for m in harness.metrics_of(bench, cell, False) + harness.metrics_of(bench, cell, True):
        value = harness.load_metric(m["name"]).read(ctx)
        if value is not None:
            out["metrics"][m["name"]] = value
    ok = [r for r in ctx.replies if r["ok"]]
    out["reply_medians_ms"] = {k: 1e3 * float(np.median([r[k] for r in ok])) if ok else None
                               for k in ("t_embed", "t_search", "t_post")}
    recorded = getattr(ptrace, "recorded", None)  # a checkout without the tracer
    spans = recorded() if recorded else []
    out["spans"], out["spans_dropped"] = len(spans), ptrace.dropped() if recorded else 0
    if mode == "on" and spans:
        bd = _program.idle_breakdown(spans, ctx.trace.prof)
        out["idle"] = {k: (v / 1e9 if k.endswith("_ns") else v) for k, v in bd.items()}
        out["child_cover"] = _program.child_cover(spans)
        out["harness_idle_gaps"] = result.get("breakdown", {}).get("idle_gaps")
        out["harness_busy_window_s"] = [ctx.trace.busy_s, ctx.trace.window_s]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python scripts/span_breakdown.py")
    ap.add_argument("--cells", nargs="+", required=True)
    ap.add_argument("--modes", nargs="+", choices=("off", "on", "prof"), default=["on"])
    ap.add_argument("--seeds", type=int, nargs="+", default=[11],
                    help="one round of every cell and mode a seed; the modes of a "
                         "round share its seed")
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--no-check", action="store_true")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("span_breakdown: no CUDA device is visible", file=sys.stderr)
        return 2
    for seed in args.seeds:
        for cell in args.cells:
            for mode in args.modes:
                with contextlib.redirect_stdout(sys.stderr):
                    out = run(cell, mode, seed, args.seconds, not args.no_check)
                print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
