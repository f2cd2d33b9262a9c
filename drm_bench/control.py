"""The control of the comparison that decides `correct`: the plain
reference put in the program's place and computed one precision below the
configuration's (TF32 for fp32 with TF32 off), judged as a run is judged.
Its numbers set the upper reading of each limit; a run's set the lower.

    python3 -m drm_bench.control --workload <cell> --seeds 1 2 3 [--requests 2]

prints one JSON line a seed: {"workload", "seed", "correct", "checks",
"info"}, judged by the same verdict as a run (``judge.verdict``); the
control has to come out not correct.  The benchmark's own runs do not run
it.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile

import numpy as np
import torch

from drm_bench import gen, harness
from drm_bench.reference import encoder as ref_enc
from drm_bench.reference import judge as ref_judge
from drm_bench.reference import sam as ref_sam
from drm_bench.reference import scan as ref_scan


def reference_run(genome: np.ndarray, cfg: dict, traffic: dict, pool: list[dict],
                  device, windowed: bool) -> dict:
    """The reference's own index and request outputs, computed in TF32 and
    written as the program writes them: the index at the configuration's
    stride, npy rows of the columns the stride gives and SAM lines in the
    order of the request's rerank (reference/rerank_<rerank>.py).  Returns
    the index as the judge reads it."""
    dev = torch.device(device)
    req = traffic["request"]
    k = ref_scan.search_columns(cfg, req)
    kind = ref_judge.index_kind(cfg)
    rerank = ref_judge.rerank_kind(req)
    with ref_enc.precision(tf32=True):
        enc = ref_enc.Encoder(dev)
        g = torch.from_numpy(genome).to(dev)
        env = ref_judge.rerank_env(cfg, req, enc, g)
        state = kind.reference_state(enc, g, cfg)
        idx = kind.index_of(state, dev)
        for p in pool:
            emb = ref_enc.embed_reads(enc, p["reads"]).cpu().numpy()
            sq, ratio = ref_scan.query_scale_ratio(np.float32(np.abs(emb).max()), idx.scale)
            q8 = ref_scan.quantize_host(emb, sq)
            s, ids = ref_scan.scan(torch.from_numpy(q8).to(dev), idx.rows, idx.ntotal,
                                   idx.ntotal, ratio, k, windowed)
            ids = ids.cpu().numpy()
            d = ref_scan.distances(s.cpu().numpy(), q8, np.full(len(q8), ratio), idx.scale,
                                   windowed)
            os.makedirs(p["out"], exist_ok=True)
            np.save(os.path.join(p["out"], "indices.npy"), ids.astype(np.uint64))
            np.save(os.path.join(p["out"], "distances.npy"), d.astype(np.float32))
            if req.get("write_sam", True):
                final = rerank.order(env, ids, p["reads"], emb)
                with open(os.path.join(p["out"], "results.sam"), "w") as f:
                    for name, r, row in zip(p["names"], p["reads"], final):
                        f.writelines(ref_sam.read_lines(name, r.tobytes().decode(), row))
    return state


def run_control(cell_name: str, seed: int, device, n_requests: int,
                root: str = harness.ROOT, tmp: str | None = None) -> dict:
    """One seed of the control, judged by the run's own verdict."""
    bench = harness.load_bench(root)
    _, cfg, traffic = harness.cell_spec(bench, cell_name, root)
    work = tempfile.mkdtemp(prefix="drm_bench_control_", dir=tmp)
    try:
        genome = gen.make_genome(int(cfg["genome_bp"]), seed)
        pool = gen.make_pool(work, genome, dict(traffic, pool_requests=max(
            n_requests, 1)), seed)
        for j, p in enumerate(pool):
            p["out"] = os.path.join(work, "out", str(j))
        dev = torch.device(device)
        windowed = dev.type == "cuda" and 2 * ref_scan.index_positions(
            genome.size, int(cfg["ref_len"]), int(cfg["stride"])).size >= ref_scan.FUSED_MIN_ROWS
        index = reference_run(genome, cfg, traffic, pool, dev, windowed)
        view = {"genome": genome, "config": cfg, "traffic": traffic, "index": index,
                "windowed": windowed, "requests": pool}
        numbers, info = ref_judge.judge(view, dev, seed, float(cfg["limits"]["index_gap"]),
                                        int(traffic["check_reads"]))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    checks, correct = ref_judge.verdict(numbers, ref_judge.limits(cfg, traffic))
    return {"workload": cell_name, "seed": seed, "correct": correct, "checks": checks,
            "info": info}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m drm_bench.control")
    ap.add_argument("--workload", required=True, nargs="+")
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--requests", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("drm_bench.control: no CUDA device is visible", file=sys.stderr)
        return 2
    for cell in args.workload:
        for seed in args.seeds:
            print(json.dumps(run_control(cell, seed, "cuda", args.requests)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
