"""Command-line entry points of the port: ``build-index``, ``pipeline`` and
``finetune``, with the positional arguments of ``deepreadmapper_tpu/cli.py``.

  pipeline     <index_prefix> <query> <ref> [ef k k_clusters output_dir
               use_dynamic use_streaming]
  build-index  <ref> <index_prefix> <ref_len> [stride M_pq nbits M_hnsw EFC]
               [--weights tuned.npz]
  finetune     <ref> <ref_len> [-o tuned.npz --steps --batch --lr ...]

All run on the CUDA device; ``--device cpu`` runs them on the CPU, and
without a card and without that flag they exit with status 2 before
reading or writing anything.  Flags of the JAX CLI that the port does not
have yet are accepted and raise NotImplementedError, so a command line
written for either package gives a clear answer.
"""

from __future__ import annotations

import argparse
import sys

from deepreadmapper_tpu_torch import not_ported, resolve_device

# Flags of the JAX CLI whose features are not ported yet (ROADMAP.md).
_PIPELINE_UNPORTED = (
    "--cigar", "--mapq", "--mapq-calibrated", "--long-reads", "--qual",
    "--sort", "--bam", "--mark-duplicates", "--distributed",
    "--paired-interleaved", "--no-rescue",
)
_PIPELINE_UNPORTED_VALUED = (
    "--paired2", "--read-group", "--profile", "--lr-max-chunks",
    "--max-isize", "--min-isize",
)
_BUILD_UNPORTED = ("--resume", "--distributed")
_BUILD_UNPORTED_VALUED = ("--shards", "--level-mode", "--build-mode")


def _add_device(p):
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the port runs (default: the CUDA device; "
                        "without one the command fails unless --device cpu)")


def _add_pipeline(sub):
    p = sub.add_parser("pipeline", help="full search pipeline")
    p.add_argument("index_prefix")
    p.add_argument("query_file")
    p.add_argument("ref_file")
    p.add_argument("ef", nargs="?", type=int, default=None)
    p.add_argument("k", nargs="?", type=int, default=None)
    p.add_argument("k_clusters", nargs="?", type=int, default=None)
    p.add_argument("output_dir", nargs="?", default=".")
    p.add_argument("use_dynamic", nargs="?", type=int, default=0)
    p.add_argument("use_streaming", nargs="?", type=int, default=0)
    p.add_argument("--no-sam", action="store_true")
    p.add_argument("--rerank", default="l2", choices=["l2", "sw"])
    p.add_argument("--dense-rerank", action="store_true",
                   help="exactly re-rank the search candidates on a dense "
                        "(stride 1) index")
    p.add_argument("--weights", default=None, metavar="NPZ",
                   help="encoder weights npz for query embedding")
    _add_device(p)
    for flag in _PIPELINE_UNPORTED:
        p.add_argument(flag, action="store_true", help="not ported yet")
    for flag in _PIPELINE_UNPORTED_VALUED:
        p.add_argument(flag, default=None, help="not ported yet")


def _add_build(sub):
    p = sub.add_parser("build-index", help="build an index from a reference")
    p.add_argument("ref_file")
    p.add_argument("index_prefix")
    p.add_argument("ref_len", type=int)
    p.add_argument("stride", nargs="?", type=int, default=1)
    p.add_argument("M_pq", nargs="?", type=int, default=8)
    p.add_argument("nbits", nargs="?", type=int, default=8)
    p.add_argument("M_hnsw", nargs="?", type=int, default=16)
    p.add_argument("EFC", nargs="?", type=int, default=200)
    p.add_argument("--index-type", default="INT8FLAT",
                   help="INT8FLAT (default: exhaustive int8 scan) | FLAT "
                        "(exact fp32) | PQFLAT (exhaustive PQ scan, 8 B/vector "
                        "at M_pq 8) | IVFINT8 (cluster-pruned int8 scan; EF "
                        "acts as nprobe) | IVFPQ (cluster-pruned PQ scan); "
                        "other engines are not ported yet")
    p.add_argument("--opq", action="store_true",
                   help="learn an OPQ rotation before PQ (PQFLAT/IVFPQ)")
    p.add_argument("--nlist", type=int, default=0,
                   help="IVF coarse clusters (0 = auto, ~sqrt(N))")
    p.add_argument("--weights", default=None, metavar="NPZ",
                   help="fine-tuned encoder weights npz (finetune output): "
                        "embeds the windows and is copied into the index, "
                        "so pipeline embeds the queries with it")
    _add_device(p)
    for flag in _BUILD_UNPORTED:
        p.add_argument(flag, action="store_true", help="not ported yet")
    for flag in _BUILD_UNPORTED_VALUED:
        p.add_argument(flag, default=None, help="not ported yet")


def _add_finetune(sub):
    p = sub.add_parser("finetune", help="fine-tune the encoder on a reference")
    p.add_argument("ref_file")
    p.add_argument("ref_len", type=int)
    p.add_argument("-o", "--output", default="finetuned.npz")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch", type=int, default=512)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--sub-rate", type=float, default=0.01,
                   help="substitution noise for simulated training reads; "
                        "match the expected read error rate")
    p.add_argument("--indel-rate", type=float, default=0.0,
                   help="insertion+deletion noise (each, per base) for "
                        "training reads; match long-read error profiles")
    p.add_argument("--max-shift", type=int, default=0,
                   help="offset training reads 0..N bases from their source "
                        "window (shift-matched tuning for sparse indexes: "
                        "use stride-1)")
    p.add_argument("--resume", default=None, metavar="NPZ",
                   help="start from a previously saved weights npz")
    p.add_argument("--state", default=None, metavar="NPZ",
                   help="full training-state checkpoint (params, Adam "
                        "moments, rng); loaded if it exists, saved back "
                        "after training: exact resume (the port's own "
                        "layout)")
    _add_device(p)


def _refuse_unported(args, flags) -> None:
    for flag in flags:
        if getattr(args, flag.lstrip("-").replace("-", "_")) not in (None, False):
            raise not_ported(flag)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="deepreadmapper_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    _add_pipeline(sub)
    _add_build(sub)
    _add_finetune(sub)
    args = ap.parse_args(argv)
    try:
        device = resolve_device(None if args.device == "cuda" else args.device)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    if args.cmd == "pipeline":
        _refuse_unported(args, _PIPELINE_UNPORTED + _PIPELINE_UNPORTED_VALUED)
        from deepreadmapper_tpu_torch.pipeline.search import run_pipeline

        vectorizer = None
        if args.weights:
            from deepreadmapper_tpu_torch.models.encoder import (
                Vectorizer,
                load_params,
            )

            vectorizer = Vectorizer(load_params(args.weights), device=device)
        res = run_pipeline(
            args.index_prefix,
            args.query_file,
            args.ref_file,
            ef=args.ef,
            k=args.k,
            k_clusters=args.k_clusters,
            output_dir=args.output_dir,
            use_dynamic=bool(args.use_dynamic),
            use_streaming=bool(args.use_streaming),
            rerank=args.rerank,
            dense_rerank=args.dense_rerank,
            write_sam=not args.no_sam,
            vectorizer=vectorizer,
            device=device,
        )
        print(
            f"[MAIN] {res['num_queries']} queries | embed {res['t_embed']:.2f}s "
            f"| search {res['t_search']:.2f}s | post {res['t_post']:.2f}s"
        )
        return 0

    if args.cmd == "build-index":
        _refuse_unported(args, _BUILD_UNPORTED + _BUILD_UNPORTED_VALUED)
        from deepreadmapper_tpu_torch.config import BuildConfig
        from deepreadmapper_tpu_torch.pipeline.build import build_index

        cfg = BuildConfig(
            stride=args.stride,
            m_pq=args.M_pq,
            nbits=args.nbits,
            m_hnsw=args.M_hnsw,
            efc=args.EFC,
            opq=args.opq,
            nlist=args.nlist,
        )
        config = build_index(
            args.ref_file,
            args.index_prefix,
            args.ref_len,
            stride=args.stride,
            index_type=args.index_type,
            build_cfg=cfg,
            device=device,
            weights=args.weights,
        )
        print(f"[BUILD INDEX] saved {config['n_vects']} vectors to "
              f"{args.index_prefix}")
        return 0

    if args.cmd == "finetune":
        from deepreadmapper_tpu_torch.models.encoder import load_params
        from deepreadmapper_tpu_torch.pipeline.finetune import finetune, save_params_npz

        params, losses = finetune(
            args.ref_file, args.ref_len, steps=args.steps, batch=args.batch,
            lr=args.lr, seed=args.seed, sub_rate=args.sub_rate,
            max_shift=args.max_shift, indel_rate=args.indel_rate,
            params=load_params(args.resume) if args.resume else None,
            state_path=args.state, device=device,
        )
        save_params_npz(params, args.output)
        print(f"[FINETUNE] {args.steps} steps, loss {losses[0]:.4f} -> "
              f"{losses[-1]:.4f}, saved {args.output}")
        return 0
    return 1


if __name__ == "__main__":
    sys.exit(main())
