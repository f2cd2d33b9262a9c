"""Run one main-path phase of a checkout's chip_smoke.py on the card.

Imports chip_smoke.py from the checkout that --root names (this one by
default), builds its kernels and runs one phase that needs nothing from the
others: genome (INT8FLAT build-index -> pipeline, 2 Mbp), genome_pq
(PQFLAT -> pipeline --rerank sw, 5 Mbp), genome_ivf (IVFINT8 at 40M rows,
three routes) or genome_ivfpq (IVFPQ at 10M rows, three routes; it runs
genome_pq first, whose build and search it is checked against), printing
the phase's own lines (build and pipeline times, steady reads/s, search
splits, gates).  For an end-to-end A/B of two
checkouts, run them in one session in the order parent, change, change,
parent:

    python scripts/time_phase.py [--root DIR]
        [--phase genome|genome_pq|genome_ivf|genome_ivfpq]
"""

from __future__ import annotations

import argparse
import collections
import importlib
import os
import shutil
import sys


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--phase", choices=("genome", "genome_pq", "genome_ivf", "genome_ivfpq"),
                    default="genome_pq")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    cs = importlib.import_module("chip_smoke")
    if os.path.dirname(os.path.abspath(cs.__file__)) != root:
        raise SystemExit(f"chip_smoke.py imported from {cs.__file__}, not from {root}")
    cs.phase_device()
    shutil.rmtree(cs.WORK, ignore_errors=True)
    os.makedirs(cs.WORK)
    cs.phase_build()
    results = collections.defaultdict(dict)
    if args.phase == "genome_ivfpq":
        cs.phase_genome_ivfpq(results, cs.phase_genome_pq(results))
    else:
        getattr(cs, "phase_" + args.phase)(results)
    shutil.rmtree(cs.WORK, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
