#!/usr/bin/env python3
"""SW top-1 of `build-index --index-type PQFLAT` -> `pipeline 128 10 128
--rerank sw` on chip_smoke.py's simulation shrunk to CPU size (200 kbp
genome, 1,024 reads of 150 bp), through either package's CLI on the CPU.

    python scripts/sw_top1_cpu_size.py --package jax     # the JAX package
    python scripts/sw_top1_cpu_size.py --package torch   # the PyTorch port

On the CPU both packages search PQFLAT with the exact scan (the fused scan
runs on a TPU or a CUDA device only), so the SW rerank sees each read's
exact top 10.  chip_smoke.py gates the port's exact-scan SW rerank at this
size on the JAX package's reading (JAX_SW_TOP1_READS).  Prints one line:
the package, the SW top-1 as a share and in reads, and the wall seconds.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--package", choices=("jax", "torch"), required=True)
    args = ap.parse_args(argv)
    if args.package == "jax":
        os.environ["JAX_PLATFORMS"] = "cpu"
        import jax

        jax.config.update("jax_platforms", "cpu")
        from deepreadmapper_tpu import cli
    else:
        from deepreadmapper_tpu_torch import cli
    import chip_smoke as cs

    work = os.path.join(cs.WORK, f"cpu_size_{args.package}")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        ref, fq, starts, strands, _, _ = cs.simulate(work, cs.CPU_SIZE_BP,
                                                     cs.CPU_SIZE_READS)
        idx, out = os.path.join(work, "idx"), os.path.join(work, "out")
        t0 = time.perf_counter()
        if cli.main(["build-index", ref, idx, str(cs.READ_LEN),
                     "--index-type", "PQFLAT"]) != 0:
            raise SystemExit("build-index failed")
        if cli.main(["pipeline", idx, fq, ref, "128", "10", "128", out,
                     "--rerank", "sw"]) != 0:
            raise SystemExit("pipeline failed")
        secs = time.perf_counter() - t0
        top1 = cs.sw_top1(os.path.join(out, "results.sam"), starts, strands)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"[sw_top1_cpu_size] {args.package}: SW top-1 {top1:.4f} "
          f"({round(top1 * cs.CPU_SIZE_READS)}/{cs.CPU_SIZE_READS} reads), "
          f"{cs.CPU_SIZE_BP} bp, {secs:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
