"""Time the PQ window-min scan kernel (csrc/pq_winmin.cu) on the card.

Builds the kernel from a checkout (this one unless --root names another),
makes chip_smoke.py phase 3's inputs (2^18 rows of PQ codes x 8192 queries,
seed 3, m 8 and 16, 256 codebook entries a subspace), checks the kernel
against the plain version once per m and ratio (vals and args bit for bit),
and prints CUDA-event milliseconds per launch, each rep 5 launches after a
warm-up, with the int8 TOP/s they give, the ptxas register lines of the
build and the card's name and power limit.  Ratio 1.3 is the kind a
PQFLAT search scores at when its queries outgrow the codebook's scale;
ratio 1 is the shared-scale case.  To compare two checkouts on one card,
time them in one session in the order parent, change, change, parent:

    python scripts/time_pq_winmin.py [--root DIR] [--ms 8 16] [--ratios 1.0 1.3]
                                     [--reps 5]

Prints one JSON object: {"root", "card", "ptxas": [...], "equal": {"m/ratio":
bool}, "ms": {"m/ratio": [rep, ...]}, "tops": {"m/ratio": [rep, ...]}}.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

ROWS, QUERIES = 1 << 18, 8192


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--ms", type=int, nargs="+", default=[8, 16])
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
    rng = np.random.default_rng(3)
    q8 = torch.from_numpy(rng.integers(-127, 128, (QUERIES, 128), dtype=np.int8)).cuda()
    ops = 2.0 * ROWS * QUERIES * 128
    out = {"root": args.root, "card": card, "equal": {}, "ms": {}, "tops": {}}
    for m in args.ms:
        codes = torch.from_numpy(rng.integers(0, 256, (ROWS, m), dtype=np.uint8)).cuda()
        cent8 = torch.from_numpy(
            rng.integers(-127, 128, (m, 256, 128 // m), dtype=np.int8)).cuda()
        for ratio in args.ratios:
            key, ratio2 = f"{m}/{ratio}", 2.0 * float(np.float32(ratio))
            v, a = sk.pq_winmin(q8, codes, cent8, ROWS, ratio2)
            vr, ar = sk.pq_winmin_reference(q8, codes, cent8, ROWS, ratio2)
            out["equal"][key] = bool(torch.equal(v, vr) and torch.equal(a, ar))
            del vr, ar
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            reps = []
            for _ in range(args.reps):
                start.record()
                for _ in range(5):
                    sk.pq_winmin(q8, codes, cent8, ROWS, ratio2)
                end.record()
                torch.cuda.synchronize()
                reps.append(start.elapsed_time(end) / 5)
            out["ms"][key] = reps
            out["tops"][key] = [ops / (t * 1e-3) / 1e12 for t in reps]
    out["ptxas"] = [ln.strip() for ln in (kernels.PQ_WINMIN.build_log or "").splitlines()
                    if "Used" in ln or "spill" in ln]
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
