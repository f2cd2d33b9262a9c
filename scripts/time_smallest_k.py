#!/usr/bin/env python3
"""Time exact_knn's selection of a score tile's k smallest on the card:
index/knn_build._select_smallest_k (the k-th value by torch.topk, the
columns below it and the lowest ties, then a stable sort of k) against
ops/topk.smallest_k, the stable sort of the whole row that every other
search path uses.  The tile is exact_knn's at chip_smoke.py phase 12 (c):
1,344 query rows x 199,702 reference rows, k = 49 (3 M_hnsw + the self
column), scores of random tanh-bounded vectors.  Checks that both routes return the same
values and columns, and prints CUDA-event ms per call of each, in turns.

    python scripts/time_smallest_k.py [--rows 1344] [--width 199702] [--k 49]
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=1344)
    ap.add_argument("--width", type=int, default=199702)
    ap.add_argument("--k", type=int, default=49)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    import torch

    from deepreadmapper_tpu_torch.index import knn_build
    from deepreadmapper_tpu_torch.ops import topk

    if not torch.cuda.is_available():
        raise SystemExit("time_smallest_k: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(0)
    v = torch.tanh(torch.randn(args.width, 128, device="cuda", generator=g))
    q = v[: args.rows]
    x = (q * q).sum(1)[:, None] + (v * v).sum(1)[None, :] - 2.0 * (q @ v.T)

    def select():
        return knn_build._select_smallest_k(x, args.k)

    def full_sort():
        return topk.smallest_k(x, args.k)

    a, b = select(), full_sort()
    if not (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])):
        raise SystemExit("time_smallest_k: the routes disagree")
    times = {"select": [], "sort": []}
    for name in ("select", "sort", "sort", "select") * args.reps:
        fn = select if name == "select" else full_sort
        fn()
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times[name].append(start.elapsed_time(end))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(f"[time_smallest_k] {smi.stdout.strip()}; tile {args.rows} x {args.width}, "
          f"k {args.k}: select {min(times['select']):.3f}-{max(times['select']):.3f} ms, "
          f"full stable sort {min(times['sort']):.3f}-{max(times['sort']):.3f} ms "
          f"({len(times['select'])} calls each, in turns); results equal")
    return 0


if __name__ == "__main__":
    sys.exit(main())
