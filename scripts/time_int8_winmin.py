"""Time the int8 window-min scan kernel (csrc/int8_winmin.cu) on the card.

Builds the kernel from a checkout (this one unless --root names another),
makes chip_smoke.py phase 3's inputs (8192 full-range int8 queries, seed 1)
over 2^18 rows (phase 3's shape) and 2^21 rows (the main path's chunk:
choose_chunk's 8 x 2^18), checks the kernel against the plain version once
per size and ratio (vals and args bit for bit), and prints CUDA-event
milliseconds per launch, each rep the mean of several launches after a
warm-up, with the int8 TOP/s they give, the ptxas register lines of the
build and the card's name and power limit.  To compare two checkouts on
one card, time them in one session in the order parent, change, change,
parent:

    python scripts/time_int8_winmin.py [--root DIR] [--rows 262144 2097152]
                                       [--ratios 1.0 1.3] [--reps 5]

Prints one JSON object: {"root", "card", "ptxas": [...], "equal": {"rows/ratio":
bool}, "ms": {"rows/ratio": [rep, ...]}, "tops": {"rows/ratio": [rep, ...]}}.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

QUERIES = 8192


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--rows", type=int, nargs="+", default=[1 << 18, 1 << 21])
    ap.add_argument("--ratios", type=float, nargs="+", default=[1.0, 1.3])
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    from deepreadmapper_tpu_torch import kernels
    from deepreadmapper_tpu_torch.ops import scan_kernel as sk

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    rng = np.random.default_rng(1)
    q8 = torch.from_numpy(rng.integers(-127, 128, (QUERIES, 128), dtype=np.int8)).cuda()
    out = {"root": args.root, "card": card, "equal": {}, "ms": {}, "tops": {}}
    for rows in args.rows:
        r8 = torch.from_numpy(rng.integers(-127, 128, (rows, 128), dtype=np.int8)).cuda()
        ops = 2.0 * rows * QUERIES * 128
        launches = max(2, (5 << 18) // rows)  # 5 at 2^18 rows, 2 at 2^21
        for ratio in args.ratios:
            key, ratio2 = f"{rows}/{ratio}", 2.0 * float(np.float32(ratio))
            v, a = sk.int8_winmin(q8, r8, rows - 1000, ratio2)
            vr, ar = sk.int8_winmin_reference(q8, r8, rows - 1000, ratio2)
            out["equal"][key] = bool(torch.equal(v, vr) and torch.equal(a, ar))
            del v, a, vr, ar
            torch.cuda.empty_cache()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            reps = []
            for _ in range(args.reps):
                start.record()
                for _ in range(launches):
                    sk.int8_winmin(q8, r8, rows, ratio2)
                end.record()
                torch.cuda.synchronize()
                reps.append(start.elapsed_time(end) / launches)
            out["ms"][key] = reps
            out["tops"][key] = [ops / (t * 1e-3) / 1e12 for t in reps]
        del r8
    out["ptxas"] = [ln.strip() for ln in (kernels.INT8_WINMIN.build_log or "").splitlines()
                    if "Used" in ln or "spill" in ln]
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
