"""Time the GRU forward kernel (csrc/gru_fwd.cu) on the card.

Builds the kernel from a checkout (this one unless --root names another)
and times it with the shipped encoder weights on uniform(-1, 1) inputs at
T = 123, fp32: the encoder batch at B = 8192 (4 calls: layer 1 forward and
reverse over all steps at din 64, layer 2 forward and reverse to the last
step at din 128, as chip_smoke.py phase 3 times it), and one launch at the
training batch B = 512 for each layer (gru_proj_seq at din 64,
gru_proj_last at din 128).  Each rep is the CUDA-event mean over 10
batches or 20 launches after a warm-up.  It also holds each of the four
calls of the batch against the plain version (fp32, max abs error), and
reads the max and mean abs error on the random fp32 weights and inputs of
tests/test_torch_gpu_kernels.py's fp32 sums case (T = 123, B = 1001, din
64 and 128, both walks, hs and h_last).  To compare two checkouts on one
card, time them in one session in the order parent, change, change,
parent:

    python scripts/time_gru_fwd.py [--root DIR] [--reps 5]

Prints one JSON object: {"root", "card" (nvidia-smi name, power limit),
"ptxas": [the register lines of the build], "max_abs_err": the largest over
the batch's four calls, "abs_err_random": {"din64": {"max": x, "mean": x},
"din128": {...}} over the test case's four calls, "ms": {"batch_8192":
[rep, ...], "b512_din64": [...], "b512_din128": [...]}}.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

T = 123


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    from deepreadmapper_tpu_torch import kernels
    from deepreadmapper_tpu_torch.models import gru
    from deepreadmapper_tpu_torch.models.encoder import load_params

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version in fp32
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    layers = load_params()["layers"]
    params = [[torch.from_numpy(lp[k][d]).cuda() for k in ("w", "bzr", "r", "rbh")]
              for lp in layers for d in (0, 1)]  # layer 1 fwd, rev; layer 2 fwd, rev
    rng = np.random.default_rng(7)

    def inputs(b, din):
        return torch.from_numpy(rng.uniform(-1, 1, (T, b, din)).astype(np.float32)).cuda()

    def random_args(din, b=1001, seed=0):  # the test's _gru_args, fp32
        r = np.random.default_rng(seed)
        arrs = [r.uniform(-1, 1, (T, b, din)), r.standard_normal((din, gru.G)) * 0.2,
                r.standard_normal(gru.G) * 0.1, r.standard_normal((gru.H, gru.G)) * 0.2,
                r.standard_normal(gru.H) * 0.1]
        return [torch.tensor(a, dtype=torch.float32).cuda() for a in arrs]

    x1, x2 = inputs(8192, 64), inputs(8192, 128)
    y1, y2 = inputs(512, 64), inputs(512, 128)

    calls = [(x1, 0, True, False), (x1, 1, True, True), (x2, 2, False, False),
             (x2, 3, False, True)]  # (input, params, all steps, reverse)

    def encoder_batch():
        for x, i, seq, rev in calls:
            (gru.gru_proj_seq if seq else gru.gru_proj_last)(x, *params[i], rev)

    cases = {
        "batch_8192": (encoder_batch, 10),
        "b512_din64": (lambda: gru.gru_proj_seq(y1, *params[0], False), 20),
        "b512_din128": (lambda: gru.gru_proj_last(y2, *params[2], False), 20),
    }
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    out = {}
    with torch.no_grad():
        err = max(float(((gru.gru_proj_seq if seq else gru.gru_proj_last)(x, *params[i], rev)
                         - gru.gru_reference(x, *params[i], rev, not seq)).abs().max())
                  for x, i, seq, rev in calls)
        err_random = {}
        for din in (64, 128):
            rargs = random_args(din)
            d = torch.cat([((gru.gru_proj_last if last else gru.gru_proj_seq)(*rargs, rev)
                            - gru.gru_reference(*rargs, rev, last)).abs().flatten()
                           for rev in (False, True) for last in (False, True)])
            err_random[f"din{din}"] = {"max": float(d.max()), "mean": float(d.mean())}
        for name, (fn, n) in cases.items():
            fn()
            reps = []
            for _ in range(args.reps):
                start.record()
                for _ in range(n):
                    fn()
                end.record()
                torch.cuda.synchronize()
                reps.append(start.elapsed_time(end) / n)
            out[name] = reps
    ptxas = [ln.strip() for ln in (kernels.GRU_FWD.build_log or "").splitlines()
             if "Used" in ln or "spill" in ln]
    print(json.dumps({"root": args.root, "card": card, "ptxas": ptxas, "max_abs_err": err,
                      "abs_err_random": err_random, "ms": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
