#!/usr/bin/env python3
"""chip_smoke.py phase 12's HNSWPQ readings (a) and (b) on the first 1,024
of the phase's 8,192 simulated reads, through either package on the CPU:

  (a) `build-index --index-type HNSWPQ` on the seeded 20 kbp genome (39,702
      windows), `pipeline 128 128 128`: recall@10 against the exact fp32
      top-10 of the same embeddings, and overlap@64 with the exhaustive scan
      of the index's own codes and codebook (PQFLAT, exact=True);
  (b) the same genome at stride 4, `pipeline 128 10 5` (each of the 5 hits
      expands into 7 dense windows, re-embedded and reranked by L2): the
      SAM primary's top-1 (within 5 bp of the simulated start, on its
      strand).

    python scripts/hnsw_cpu_size.py --package jax     # the JAX package
    python scripts/hnsw_cpu_size.py --package torch   # the PyTorch port

Every read is searched and reranked on its own, so the first 1,024 reads
answer as they do inside the full batch.  chip_smoke.py gates the port on
the card at the JAX package's readings less 0.01 (JAX_HNSW_RECALL10,
JAX_HNSW_SPARSE_TOP1).  Prints one line per part: the package, the
readings, the wall seconds.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--package", choices=("jax", "torch"), required=True)
    args = ap.parse_args(argv)
    dev = []
    if args.package == "jax":
        os.environ["JAX_PLATFORMS"] = "cpu"
        import jax

        jax.config.update("jax_platforms", "cpu")
        from deepreadmapper_tpu import cli
        from deepreadmapper_tpu.index.flat import FlatIndex
        from deepreadmapper_tpu.index.pq_flat import PQFlatIndex
        from deepreadmapper_tpu.index.registry import load_index
        from deepreadmapper_tpu.io import fasta as fasta_io
        from deepreadmapper_tpu.models.encoder import Vectorizer
        from deepreadmapper_tpu.pipeline.build import embed_fasta_windows

        on = {}
    else:
        from deepreadmapper_tpu_torch import cli
        from deepreadmapper_tpu_torch.index.flat import FlatIndex
        from deepreadmapper_tpu_torch.index.pq_flat import PQFlatIndex
        from deepreadmapper_tpu_torch.index.registry import load_index
        from deepreadmapper_tpu_torch.io import fasta as fasta_io
        from deepreadmapper_tpu_torch.models.encoder import Vectorizer
        from deepreadmapper_tpu_torch.pipeline.build import embed_fasta_windows

        dev, on = ["--device", "cpu"], {"device": "cpu"}
    import chip_smoke as cs

    work = os.path.join(cs.WORK, f"hnsw_cpu_{args.package}")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    n = cs.HNSW_GATE_READS
    try:
        ref, fq, starts, strands, mat, _ = cs.simulate(work, cs.HNSW_GENOME_BP, cs.N_READS)
        sub = os.path.join(work, "first.fastq")
        with open(fq) as f, open(sub, "w") as g:
            g.writelines(line for _, line in zip(range(4 * n), f))

        t0 = time.perf_counter()
        idx, out = os.path.join(work, "dense"), os.path.join(work, "dense_out")
        if cli.main(["build-index", ref, idx, str(cs.READ_LEN), "--index-type", "HNSWPQ",
                     *dev]) != 0:
            raise SystemExit("build-index failed")
        if cli.main(["pipeline", idx, sub, ref, str(cs.HNSW_EF), "128", "128", out,
                     "--no-sam", *dev]) != 0:
            raise SystemExit("pipeline failed")
        ids = np.load(os.path.join(out, "indices.npy")).astype(np.int64)
        vec = Vectorizer(**on)
        q = vec.vectorize_wrapped_bytes(mat[:n], np.full(n, cs.READ_LEN + 2))
        windows = embed_fasta_windows(fasta_io.parse_fasta_records(ref), cs.READ_LEN, 1, vec)
        oracle, _ = FlatIndex(windows, **on).search(q, 10)
        engine, _ = load_index(idx, **on)
        adc, _ = PQFlatIndex(engine.codes, engine.codebook, engine.ntotal, **on).search(
            q, 64, exact=True)
        recall, overlap = cs._recall(ids[:, :10], oracle), cs._recall(ids[:, :64], adc)
        ceiling = cs._recall(adc[:, :10], oracle)
        print(f"[hnsw_cpu_size] {args.package} (a): recall@10 {recall:.4f}, overlap@64 "
              f"{overlap:.4f}, the exhaustive scan's recall@10 {ceiling:.4f}; {n} reads, "
              f"{engine.ntotal} windows, {time.perf_counter() - t0:.1f} s")

        t0 = time.perf_counter()
        idx, out = os.path.join(work, "sparse"), os.path.join(work, "sparse_out")
        if cli.main(["build-index", ref, idx, str(cs.READ_LEN), str(cs.HNSW_SPARSE_STRIDE),
                     "--index-type", "HNSWPQ", *dev]) != 0:
            raise SystemExit("build-index failed")
        if cli.main(["pipeline", idx, sub, ref, *cs.HNSW_SPARSE_ARGS, out, *dev]) != 0:
            raise SystemExit("pipeline failed")
        top1 = cs.sw_top1(os.path.join(out, "results.sam"), starts[:n], strands[:n])
        print(f"[hnsw_cpu_size] {args.package} (b): top-1 {top1:.4f} "
              f"({round(top1 * n)}/{n} reads), stride {cs.HNSW_SPARSE_STRIDE}, "
              f"{time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
