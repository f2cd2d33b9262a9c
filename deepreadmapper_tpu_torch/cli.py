"""Command-line entry points of the port, with the subcommands and
positional arguments of ``deepreadmapper_tpu/cli.py``:

  pipeline     <index_prefix> <query> <ref> [ef k k_clusters output_dir
               use_dynamic use_streaming] [--cigar --mapq ... --profile DIR]
               [--paired2 R2 | --paired-interleaved] [--long-reads]
               [--distributed]
  build-index  <ref> <index_prefix> <ref_len> [stride M_pq nbits M_hnsw EFC]
               [--index-type T --build-mode insert|knn --level-mode rng|centroid
                --weights tuned.npz --resume --shards N --distributed]
  serve        <index_prefix> <ref> (JSONL requests on stdin)
  inference    <seqs> <ref_len> [out.npy] [batch]
  finetune     <ref> <ref_len> [-o tuned.npz --steps --batch --lr ...]
               [--distributed]
  info         <index_prefix>
  plan         <genome FASTA | base count> [ref_len] [--stride --hbm-gb]
  gen-ref      -i input -l ref_len -s stride -o out

The commands that compute run on the CUDA device; ``--device cpu`` runs
them on the CPU, and without a card and without that flag they exit with
status 2 before reading or writing anything.  info, plan and gen-ref touch
no device.  ``--distributed`` joins the process group torchrun starts
(``torchrun --nproc-per-node N -m deepreadmapper_tpu_torch.cli ...``):
each rank works on ``cuda:LOCAL_RANK`` over NCCL, or on the CPU over gloo
with ``--device cpu``; build-index then embeds and saves only each rank's
shards, pipeline loads only each rank's shards and writes its outputs on
rank 0, and finetune trains each rank on its slice of the global batch
(the JAX CLI trains over every device of its mesh; under PyTorch that takes
one process a card) and writes on rank 0.
"""

from __future__ import annotations

import argparse
import os
import sys

from deepreadmapper_tpu_torch import resolve_device

# plan's card memory without a visible card: the H100's 80 GB
_DEFAULT_HBM_GB = 80.0
# Device memory an INT8FLAT search needs beside its resident index: an
# 8192-read search at the main path's 2^21-row chunk (choose_chunk) took
# 9.136 GB above the resident index and encoder, per chunk and so whatever
# the index's size (chip_smoke.py phase 11, genome_lr; NVIDIA H100 80GB
# HBM3, 700.00 W).  Rounded up; plan holds it back from the card's memory
# unless --hbm-gb is given.
_SCAN_WORKSPACE_GB = 9.2


def _add_device(p):
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the port runs (default: the CUDA device; "
                        "without one the command fails unless --device cpu)")


def _add_distributed(p, what: str):
    p.add_argument("--distributed", action="store_true",
                   help=f"multi-process run under torchrun: {what}; run the "
                        "same command on every rank (NCCL on the cards, gloo "
                        "with --device cpu)")


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
    p.add_argument("--cigar", action="store_true",
                   help="real SW-traceback CIGARs (soft clips + M/I/D), "
                        "alignment-exact POS and NM/MD/AS on primary lines")
    p.add_argument("--mapq", action="store_true",
                   help="margin-based MAPQ on primary lines (best vs best at "
                        "a different locus; repeats get 0)")
    p.add_argument("--mapq-calibrated", action="store_true",
                   help="with --mapq: map the margin MAPQ through the fitted "
                        "calibration table")
    p.add_argument("--qual", action="store_true",
                   help="FASTQ base qualities in the QUAL column")
    p.add_argument("--sort", action="store_true",
                   help="coordinate-sort the SAM (SO:coordinate)")
    p.add_argument("--bam", action="store_true",
                   help="also write results.bam (with --sort, and its .bai)")
    p.add_argument("--mark-duplicates", action="store_true",
                   help="mark duplicates (FLAG 0x400; best MAPQ stays "
                        "unmarked)")
    p.add_argument("--read-group", default=None, metavar="RG",
                   help="@RG header + RG:Z tag on every line; fields with a "
                        "required ID: (e.g. 'ID:run1,SM:sampleA')")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler Chrome trace of the query "
                        "embed and the search into DIR")
    p.add_argument("--long-reads", action="store_true",
                   help="map reads longer than the index window by chunk -> "
                        "search -> chain voting; chained read-start "
                        "placements, support MAPQ, FLAG-2048 lines for split "
                        "reads")
    p.add_argument("--lr-max-chunks", type=int, default=128,
                   help="--long-reads: at most this many chunks (votes) a "
                        "read; the chunk stride widens past half a window "
                        "beyond ~(N/2)*ref_len bases")
    p.add_argument("--paired2", default=None, metavar="R2_FASTQ",
                   help="paired-end mode: the mate (R2) FASTQ; FR proper-pair "
                        "resolution, paired FLAG/RNEXT/PNEXT/TLEN, pair-margin "
                        "MAPQ")
    p.add_argument("--max-isize", type=int, default=1000,
                   help="paired-end: maximum outer insert size")
    p.add_argument("--min-isize", type=int, default=0,
                   help="paired-end: minimum outer insert size")
    p.add_argument("--paired-interleaved", action="store_true",
                   help="the query FASTQ holds interleaved R1/R2 records; "
                        "split (beside the outputs) and map as pairs")
    p.add_argument("--no-rescue", action="store_true",
                   help="paired-end: no SW mate rescue (the scan of the "
                        "expected mate interval next to an anchored end "
                        "when no proper pair exists)")
    _add_device(p)
    _add_distributed(p, "each rank loads ONLY its index shards, the search "
                        "merges across the ranks, rank 0 writes the outputs")


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
                        "acts as nprobe) | IVFPQ (cluster-pruned PQ scan) | "
                        "HNSWPQ (the reference-parity engine: HNSW graph + "
                        "PQ codes, ADC beam search; EF is the beam width) | "
                        "HNSWFLAT (HNSW graph over fp32 vectors)")
    p.add_argument("--opq", action="store_true",
                   help="learn an OPQ rotation before PQ (PQFLAT/IVFPQ)")
    p.add_argument("--nlist", type=int, default=0,
                   help="IVF coarse clusters (0 = auto, ~sqrt(N))")
    p.add_argument("--level-mode", default="rng", choices=["rng", "centroid"],
                   help="HNSW level assignment: seeded exponential RNG "
                        "(default) or hnswm's deterministic centroid-"
                        "partition medoids")
    p.add_argument("--build-mode", default="insert", choices=["insert", "knn"],
                   help="HNSW construction: incremental insert on the host "
                        "(default) or the kNN-graph builder on the device")
    p.add_argument("--weights", default=None, metavar="NPZ",
                   help="fine-tuned encoder weights npz (finetune output): "
                        "embeds the windows and is copied into the index, "
                        "so pipeline embeds the queries with it")
    p.add_argument("--resume", action="store_true",
                   help="crash-resumable streaming build: code chunks "
                        "checkpoint to <prefix>/.build_cache/ and a rerun "
                        "skips what is already embedded (INT8FLAT, IVFINT8, "
                        "PQFLAT, IVFPQ from FASTA)")
    p.add_argument("--shards", type=int, default=1,
                   help="shard the index over N sub-indexes (shard_i/ + "
                        "sharded.txt), for one card or several")
    _add_device(p)
    _add_distributed(p, "every rank embeds and saves ONLY its own shards "
                        "(its genome slice)")


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
    _add_distributed(p, "data parallelism, each rank trains on its slice of "
                        "the --batch global batch (which must divide by the "
                        "world size); rank 0 writes -o and --state")
    _add_device(p)


def _add_serve(sub):
    p = sub.add_parser(
        "serve",
        help="serving daemon: load the index once, answer FASTQ->SAM "
             "requests over line-delimited JSON on stdin/stdout",
    )
    p.add_argument("index_prefix")
    p.add_argument("ref_file")
    p.add_argument("--ef", type=int, default=None)
    p.add_argument("--k", type=int, default=None)
    p.add_argument("--k-clusters", type=int, default=None)
    p.add_argument("--rerank", default="l2", choices=["l2", "sw"])
    p.add_argument("--dense-rerank", action="store_true")
    p.add_argument("--cigar", action="store_true")
    p.add_argument("--mapq", action="store_true")
    _add_device(p)


def _add_info(sub):
    p = sub.add_parser("info", help="inspect an index directory (no engine load)")
    p.add_argument("index_prefix")


def _add_plan(sub):
    p = sub.add_parser(
        "plan",
        help="deployment sizing advisor: engine/stride/shard "
             "recommendations for a genome size + device memory budget",
    )
    p.add_argument("genome", help="reference FASTA path OR a base count "
                                  "like 3.1e9 / 3100000000")
    p.add_argument("ref_len", nargs="?", type=int, default=150)
    p.add_argument("--stride", type=int, default=0,
                   help="fix the stride (default: recommend one)")
    p.add_argument("--hbm-gb", type=float, default=None,
                   help="usable device memory per card for index residency "
                        "(default: the visible card's memory less the "
                        f"search's {_SCAN_WORKSPACE_GB:g} GB scan workspace; "
                        f"{_DEFAULT_HBM_GB:g} GB less it without a card)")


def _add_inference(sub):
    p = sub.add_parser("inference", help="embed sequences to npy")
    p.add_argument("input_file")
    p.add_argument("ref_len", type=int)
    p.add_argument("output", nargs="?", default="embeddings.npy")
    p.add_argument("batch_size", nargs="?", type=int, default=65536,
                   help="windows or reads embedded per streamed chunk")
    p.add_argument("--stride", type=int, default=1)
    p.add_argument("--weights", default=None, metavar="NPZ",
                   help="fine-tuned encoder weights npz (default: shipped "
                        "pretrained model)")
    _add_device(p)


def _add_gen_ref(sub):
    p = sub.add_parser("gen-ref", help="dump windowed sequences to txt")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-l", "--ref-len", type=int, required=True)
    p.add_argument("-s", "--stride", type=int, default=1)
    p.add_argument("-o", "--output", required=True)
    p.add_argument("-L", "--lookup", action="store_true",
                   help="no <...> wrapping (lookup mode)")


def _init_distributed(device):
    """--distributed: join torchrun's process group, over NCCL on the card
    (cuda:LOCAL_RANK) or gloo with --device cpu; returns the device this
    rank computes on."""
    from deepreadmapper_tpu_torch.parallel.distributed import (
        init_distributed,
        rank,
        world_size,
    )

    backend = "nccl" if device.type == "cuda" else "gloo"
    device = init_distributed(backend, device=None if device.type == "cuda" else device)
    print(f"[DIST] rank {rank()} of {world_size()}, backend {backend}, device {device}")
    return device


def _split_interleaved(path: str, output_dir: str):
    """Split an interleaved FASTQ (R1, R2, R1, ...) into
    <output_dir>/_interleaved_R1.fastq and _R2.fastq, kept beside the
    outputs; returns the two paths, or None for an odd record count.  Under
    a process group rank 0 writes them and the others wait for it."""
    from deepreadmapper_tpu_torch.io.fileio import read_bytes
    from deepreadmapper_tpu_torch.parallel.distributed import barrier, is_main

    data = read_bytes(path).split(b"\n")
    recs = [data[i: i + 4] for i in range(0, len(data) - 3, 4)]
    if len(recs) % 2:
        return None
    os.makedirs(output_dir, exist_ok=True)
    p1 = os.path.join(output_dir, "_interleaved_R1.fastq")
    p2 = os.path.join(output_dir, "_interleaved_R2.fastq")
    if is_main():
        with open(p1, "wb") as f1, open(p2, "wb") as f2:
            for j, rec in enumerate(recs):
                (f1 if j % 2 == 0 else f2).write(b"\n".join(rec) + b"\n")
    barrier()
    return p1, p2


def _info(index_prefix: str) -> int:
    """The JAX CLI's ``info``: config.txt, files on disk, bytes a vector."""
    from deepreadmapper_tpu_torch.io.configstore import load_config

    cfg_path = os.path.join(index_prefix, "config.txt")
    if not os.path.exists(cfg_path):
        print(f"[INFO] no config.txt under {index_prefix}")
        return 1
    config = load_config(cfg_path)
    for key, val in config.items():
        print(f"{key}: {val}")
    if os.path.exists(os.path.join(index_prefix, "sharded.txt")):
        shard_ids = sorted(d for d in os.listdir(index_prefix) if d.startswith("shard_"))
        print(f"sharded: yes ({len(shard_ids)} shard dirs on disk)")
    total = 0
    for root, _dirs, files in os.walk(index_prefix):
        for fn in sorted(files):
            p = os.path.join(root, fn)
            sz = os.path.getsize(p)
            total += sz
            print(f"file: {os.path.relpath(p, index_prefix)}  {sz/1e6:.2f} MB")
    print(f"disk_total_mb: {total/1e6:.2f}")
    nv = int(config.get("n_vects", 0))
    if nv:
        print(f"bytes_per_vector: {total/nv:.1f}")
    if config.get("weights"):
        print("encoder: index-matched fine-tuned weights (encoder.npz)")
    return 0


def _card_gb() -> float:
    """Memory of the visible card (else the H100's) in GB (1e9 bytes), less
    the search's scan workspace: what an index may hold."""
    import torch

    total = (torch.cuda.get_device_properties(0).total_memory / 1e9
             if torch.cuda.is_available() else _DEFAULT_HBM_GB)
    return total - _SCAN_WORKSPACE_GB


def _plan(args) -> int:
    """The JAX CLI's ``plan``, the same sizing rules and output, against the
    card's memory less the scan workspace by default."""
    if os.path.exists(args.genome):
        from deepreadmapper_tpu_torch.utils.memory import estimate_window_count

        n_bases = os.path.getsize(args.genome)  # ~1 B/base incl headers
        dense = estimate_window_count(args.genome, args.ref_len, 1)
    else:
        n_bases = int(float(args.genome))
        dense = max(0, (n_bases - args.ref_len) + 1) * 2
    hbm = (args.hbm_gb if args.hbm_gb is not None else _card_gb()) * 1e9
    stride = args.stride or (1 if dense * 128 <= hbm else 4)
    nv = dense // stride
    print(f"genome: ~{n_bases/1e6:.1f} Mbp -> {nv} vectors at "
          f"stride {stride} (both strands)")
    engines = [
        ("INT8FLAT", nv * 128, "near-exact (0.995+ recall@10)"),
        ("IVFINT8", int(nv * 128 / 0.8),
         "sub-linear scan; the >100M-row tier (EF = nprobe)"),
        ("PQFLAT+OPQ", nv * 8 + 2 ** 8 * 128 * 4,
         "16x less HBM; 0.96-0.99 raw top-1 with rerank"),
        ("PQFLAT16+OPQ", nv * 16 + 2 ** 8 * 128 * 4, "0.989 raw at 16 B/vector"),
        ("FLAT", nv * 128 * 4, "exact fp32 oracle (small refs only)"),
    ]
    print(f"{'engine':<14}{'index':>10}  {'chips':>5}  notes")
    for name, nbytes, note in engines:
        shards = max(1, -(-nbytes // int(hbm)))
        print(f"{name:<14}{nbytes/1e9:>9.2f}G  {shards:>5}  {note}")
    print(
        "recommend: "
        + (
            "INT8FLAT, 1 chip"
            if nv * 128 <= hbm
            else f"INT8FLAT over --shards {-(-nv * 128 // int(hbm))} "
                 f"(or PQFLAT+OPQ on "
                 f"{max(1, -(-(nv * 8) // int(hbm)))} chip(s) at 8 B/vec)"
        )
    )
    if stride > 1:
        print(
            f"stride {stride} halves nothing for free: run finetune "
            f"--max-shift {stride - 1} first (sparse top-1 0.81 -> "
            "0.995 measured at 46 Mbp), then build with "
            "--weights tuned.npz"
        )
    print("long reads: add pipeline --long-reads (chunk+chain); "
          "crash safety: build-index --resume")
    return 0


def _gen_ref(args) -> int:
    from deepreadmapper_tpu_torch.io.fasta import parse_fasta_records, windows_as_strings

    records = parse_fasta_records(args.input)
    seqs, _ = windows_as_strings(records, args.ref_len, args.stride,
                                 lookup_mode=args.lookup)
    with open(args.output, "w") as f:
        for s in seqs:
            f.write(s + "\n")
    print(f"[GEN-REF] wrote {len(seqs)} windows to {args.output}")
    return 0


def _vectorizer(weights, device):
    from deepreadmapper_tpu_torch.models.encoder import Vectorizer, load_params

    return Vectorizer(load_params(weights) if weights else None, device=device)


def _inference(args, device) -> int:
    import numpy as np

    from deepreadmapper_tpu_torch.io.fileio import true_ext
    from deepreadmapper_tpu_torch.io.readers import FASTA_EXTS, FASTQ_EXTS
    from deepreadmapper_tpu_torch.pipeline.build import (
        embed_input_file,
        stream_embed_fasta_to_npy,
        stream_embed_seqs_to_npy,
    )

    vec = _vectorizer(args.weights, device)
    ext = true_ext(args.input_file)
    if ext in FASTA_EXTS:
        n = stream_embed_fasta_to_npy(args.input_file, args.output, args.ref_len,
                                      args.stride, vec, window_chunk=args.batch_size)
        print(f"[INFERENCE] streamed ({n}, 128) to {args.output}")
        return 0
    if ext in FASTQ_EXTS or ext == ".txt":
        n = stream_embed_seqs_to_npy(args.input_file, args.output, vec,
                                     batch=args.batch_size)
        print(f"[INFERENCE] streamed ({n}, 128) to {args.output}")
        return 0
    emb = embed_input_file(args.input_file, args.ref_len, args.stride, vec)
    np.save(args.output, emb)
    print(f"[INFERENCE] wrote {emb.shape} to {args.output}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="deepreadmapper_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    _add_pipeline(sub)
    _add_build(sub)
    _add_serve(sub)
    _add_info(sub)
    _add_plan(sub)
    _add_inference(sub)
    _add_finetune(sub)
    _add_gen_ref(sub)
    args = ap.parse_args(argv)

    if args.cmd == "info":
        return _info(args.index_prefix)
    if args.cmd == "plan":
        return _plan(args)
    if args.cmd == "gen-ref":
        return _gen_ref(args)
    try:
        device = resolve_device(None if args.device == "cuda" else args.device)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    if args.cmd == "pipeline":
        if args.distributed:
            device = _init_distributed(device)
        from deepreadmapper_tpu_torch.pipeline.search import (
            run_pipeline,
            run_pipeline_paired,
        )

        if args.read_group:
            # fail fast: a malformed read group would otherwise raise only
            # in the SAM writer, after the embed and the search
            from deepreadmapper_tpu_torch.io.sam import parse_read_group

            parse_read_group(args.read_group)
        if args.paired_interleaved and not args.paired2:
            split = _split_interleaved(args.query_file, args.output_dir)
            if split is None:
                print("[MAIN] ERROR: interleaved FASTQ holds an odd number of "
                      "records")
                return 1
            args.query_file, args.paired2 = split
        vectorizer = _vectorizer(args.weights, device) if args.weights else None
        common = dict(
            ef=args.ef, k=args.k, k_clusters=args.k_clusters,
            output_dir=args.output_dir, use_streaming=bool(args.use_streaming),
            rerank=args.rerank, dense_rerank=args.dense_rerank,
            write_sam=not args.no_sam, cigar=args.cigar, mapq=args.mapq,
            mapq_calibrated=args.mapq_calibrated, long_reads=args.long_reads,
            qual=args.qual, sort=args.sort, bam=args.bam,
            mark_dups=args.mark_duplicates, read_group=args.read_group,
            vectorizer=vectorizer, device=device,
        )
        if args.paired2:
            res = run_pipeline_paired(
                args.index_prefix, args.query_file, args.paired2, args.ref_file,
                max_isize=args.max_isize, min_isize=args.min_isize,
                rescue=not args.no_rescue, **common,
            )
            print(f"[MAIN] {res['num_queries']} reads | "
                  f"{res['n_proper']}/{res['num_pairs']} proper pairs | "
                  f"embed {res['t_embed']:.2f}s | search {res['t_search']:.2f}s")
            return 0
        res = run_pipeline(
            args.index_prefix, args.query_file, args.ref_file,
            use_dynamic=bool(args.use_dynamic), lr_max_chunks=args.lr_max_chunks,
            profile_dir=args.profile, **common,
        )
        print(
            f"[MAIN] {res['num_queries']} queries | embed {res['t_embed']:.2f}s "
            f"| search {res['t_search']:.2f}s | post {res['t_post']:.2f}s"
        )
        return 0

    if args.cmd == "build-index":
        from deepreadmapper_tpu_torch.config import BuildConfig
        from deepreadmapper_tpu_torch.pipeline.build import (
            build_index,
            build_index_distributed,
        )

        cfg = BuildConfig(
            stride=args.stride,
            m_pq=args.M_pq,
            nbits=args.nbits,
            m_hnsw=args.M_hnsw,
            efc=args.EFC,
            build_mode=args.build_mode,
            opq=args.opq,
            nlist=args.nlist,
            level_mode=args.level_mode,
        )
        if args.distributed:
            device = _init_distributed(device)
            config = build_index_distributed(
                args.ref_file,
                args.index_prefix,
                args.ref_len,
                stride=args.stride,
                index_type=args.index_type,
                build_cfg=cfg,
                n_shards=args.shards,
                weights=args.weights,
                device=device,
            )
        else:
            config = build_index(
                args.ref_file,
                args.index_prefix,
                args.ref_len,
                stride=args.stride,
                index_type=args.index_type,
                build_cfg=cfg,
                device=device,
                weights=args.weights,
                resume=args.resume,
                n_shards=args.shards,
            )
        print(f"[BUILD INDEX] saved {config['n_vects']} vectors to "
              f"{args.index_prefix}")
        return 0

    if args.cmd == "serve":
        from deepreadmapper_tpu_torch.pipeline.serve import serve

        defaults = {
            k: v
            for k, v in {
                "ef": args.ef,
                "k": args.k,
                "k_clusters": args.k_clusters,
                "rerank": args.rerank,
                "dense_rerank": args.dense_rerank,
                "cigar": args.cigar,
                "mapq": args.mapq,
            }.items()
            if v not in (None, False)
        }
        n = serve(args.index_prefix, args.ref_file, defaults=defaults, device=device)
        print(f"[SERVE] answered {n} requests", file=sys.stderr)
        return 0

    if args.cmd == "inference":
        return _inference(args, device)

    if args.cmd == "finetune":
        from deepreadmapper_tpu_torch.models.encoder import load_params
        from deepreadmapper_tpu_torch.parallel.distributed import is_main
        from deepreadmapper_tpu_torch.pipeline.finetune import finetune, save_params_npz

        if args.distributed:
            device = _init_distributed(device)

        params, losses = finetune(
            args.ref_file, args.ref_len, steps=args.steps, batch=args.batch,
            lr=args.lr, seed=args.seed, sub_rate=args.sub_rate,
            max_shift=args.max_shift, indel_rate=args.indel_rate,
            params=load_params(args.resume) if args.resume else None,
            state_path=args.state, device=device,
        )
        if is_main():
            save_params_npz(params, args.output)
            print(f"[FINETUNE] {args.steps} steps, loss {losses[0]:.4f} -> "
                  f"{losses[-1]:.4f}, saved {args.output}")
        return 0
    return 1


if __name__ == "__main__":
    sys.exit(main())
