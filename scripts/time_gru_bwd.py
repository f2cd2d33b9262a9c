"""Time the GRU backward kernel (csrc/gru_bwd.cu) on the card.

Builds the kernel from a checkout (this one unless --root names another),
makes the cotangent recurrence's inputs at T = 123 from a forward of the
shipped layer 1 over uniform inputs (as chip_smoke.py phase 3 does), and
prints CUDA-event milliseconds per launch at each batch, each rep 20
launches after a warm-up, with the card's name and power limit.  To compare
two checkouts on one card, time them in one session in the order parent,
change, change, parent:

    python scripts/time_gru_bwd.py [--root DIR] [--batches 512 8192] [--reps 5]

Prints one JSON object: {"root", "card", "ptxas": [the register lines of
the build], "ms": {batch: [rep, ...]}}.
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
    ap.add_argument("--batches", type=int, nargs="+", default=[512, 8192])
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
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    layer = load_params()["layers"][0]
    w, bzr, r, rbh = (torch.from_numpy(layer[k][0]).cuda() for k in ("w", "bzr", "r", "rbh"))
    rT = r.T.contiguous()
    rng = np.random.default_rng(7)
    out = {}
    for b in args.batches:
        x = torch.from_numpy(rng.uniform(-1, 1, (T, b, 64)).astype(np.float32)).cuda()
        with torch.no_grad():
            hs = gru.gru_proj_seq(x, w, bzr, r, rbh, False)
            gates = gru.recompute_gates(x, w, bzr, r, rbh, hs, False)
        ct = torch.from_numpy(rng.standard_normal((T, b, 64)).astype(np.float32)).cuda()
        ins = [*gates, ct]
        gru.gru_bwd(*ins, rT)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        reps = []
        for _ in range(args.reps):
            start.record()
            for _ in range(20):
                gru.gru_bwd(*ins, rT)
            end.record()
            torch.cuda.synchronize()
            reps.append(start.elapsed_time(end) / 20)
        out[b] = reps
    ptxas = [ln.strip() for ln in (kernels.GRU_BWD.build_log or "").splitlines() if "Used" in ln]
    print(json.dumps({"root": args.root, "card": card, "ptxas": ptxas, "ms": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
