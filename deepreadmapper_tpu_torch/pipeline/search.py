"""End-to-end search pipeline (L2 or Smith-Waterman rerank).

Counterpart of ``deepreadmapper_tpu/pipeline/search.py``: index load ->
query load/embed -> search -> post-process -> outputs.  indices.npy /
distances.npy hold the RAW search results (or, with --dense-rerank at
stride 1 on the L2 path, the reranked ones), exactly as the JAX package
writes them; SAM holds the post-processed candidates.
"""

from __future__ import annotations

import os
import time

import numpy as np

from deepreadmapper_tpu_torch import native
from deepreadmapper_tpu_torch import tokenizer as tok
from deepreadmapper_tpu_torch.config import SearchConfig
from deepreadmapper_tpu_torch.io import fasta as fasta_io
from deepreadmapper_tpu_torch.io import sam as sam_io
from deepreadmapper_tpu_torch.io.fastq import parse_fastq_bytes
from deepreadmapper_tpu_torch.io.fileio import true_ext
from deepreadmapper_tpu_torch.io.readers import FASTA_EXTS, FASTQ_EXTS, read_txt
from deepreadmapper_tpu_torch.io.results import load_embeddings_npy, save_results
from deepreadmapper_tpu_torch import not_ported, resolve_device
from deepreadmapper_tpu_torch.index.ivf_int8 import IVFInt8Index
from deepreadmapper_tpu_torch.index.registry import load_index
from deepreadmapper_tpu_torch.models.encoder import Vectorizer, load_params
from deepreadmapper_tpu_torch.pipeline import postprocess as pp
from deepreadmapper_tpu_torch.tokenizer_device import pack_wrapped_numpy


def _load_queries(path: str, vectorizer: Vectorizer):
    """Returns (embeddings [Q,128] fp32, wrapped query seqs or None, ids)."""
    ext = true_ext(path)
    if ext == ".npy":
        return load_embeddings_npy(path), None, []
    if ext in FASTQ_EXTS:
        mat, lengths, ids = parse_fastq_bytes(path)
        # 48-byte wire upload + device tokenizer
        emb = vectorizer.vectorize_wrapped_bytes(mat, lengths)
        seqs = [bytes(row[: int(n)]).decode() for row, n in zip(mat, lengths)]
        return emb, seqs, ids
    if ext in FASTA_EXTS or ext == ".txt":
        if ext == ".txt":
            seqs = read_txt(path)
        else:
            records = fasta_io.parse_fasta_records(path)
            seqs = [r.tobytes().decode() for r in records]
        return vectorizer.vectorize(seqs), seqs, []
    raise ValueError(f"Unsupported query input: {path}")


def vectorizer_for_index(index_prefix: str, config: dict,
                         vectorizer: Vectorizer | None = None,
                         device=None) -> Vectorizer:
    """The encoder that must embed queries against this index: an explicit
    vectorizer wins; else the index-recorded weights (<prefix>/encoder.npz);
    else the shipped pretrained model."""
    if vectorizer is not None:
        return vectorizer
    if config.get("weights"):
        wpath = os.path.join(index_prefix, str(config["weights"]))
        print(f"[MAIN] using index-matched encoder weights: {wpath}")
        return Vectorizer(load_params(wpath), device=device)
    return Vectorizer(device=device)


def run_pipeline(
    index_prefix: str,
    query_file: str,
    ref_file: str,
    ef: int | None = None,
    k: int | None = None,
    k_clusters: int | None = None,
    output_dir: str = ".",
    use_dynamic: bool = False,
    use_streaming: bool = False,
    rerank: str = "l2",
    dense_rerank: bool = False,
    write_sam: bool = True,
    vectorizer: Vectorizer | None = None,
    device=None,
    search_stats: dict | None = None,
) -> dict:
    """Run the pipeline; returns a timing/result summary.

    rerank="l2" reranks sparse candidates by sqrt-L2 of re-embedded windows;
    rerank="sw" reranks every candidate by Smith-Waterman score against the
    read (at any stride), and the SAM holds the SW-ranked ids.
    dense_rerank=True re-embeds and exactly reranks the search candidates
    on a dense (stride 1) index on the L2 path; indices.npy / distances.npy
    then hold the reranked sqrt-L2 results.  Otherwise they hold the raw
    search results.  ef is nprobe for the IVF engines; search_stats, when a
    dict, receives their search-effort counters (other engines ignore it).
    device defaults to the CUDA device (raises without one)."""
    if rerank not in ("l2", "sw"):
        raise ValueError(f"unknown rerank {rerank!r} (l2 | sw)")
    if use_streaming:
        raise not_ported("use_streaming")
    device = resolve_device(device)
    scfg = SearchConfig()
    ef = ef if ef is not None else scfg.ef
    k = k if k is not None else scfg.k

    t0 = time.time()
    engine, config = load_index(index_prefix, device)
    ref_len = int(config["ref_len"])
    stride = int(config["stride"])
    if stride == 1:
        k_clusters = k
    elif k_clusters is None:
        k_clusters = scfg.k_clusters
    t_index = time.time() - t0

    vectorizer = vectorizer_for_index(index_prefix, config, vectorizer, device)
    t0 = time.time()
    query_emb, query_seqs, query_ids = _load_queries(query_file, vectorizer)
    t_embed = time.time() - t0

    t0 = time.time()
    if search_stats is not None and isinstance(engine, IVFInt8Index):
        neighbors, distances = engine.search(query_emb, k_clusters, ef,
                                             stats=search_stats)
    else:
        neighbors, distances = engine.search(query_emb, k_clusters, ef)
    t_search = time.time() - t0

    os.makedirs(output_dir, exist_ok=True)
    sam_file = os.path.join(output_dir, "results.sam")
    have_seqs = query_seqs is not None
    if dense_rerank and stride == 1 and (not have_seqs or rerank == "sw"):
        print("[MAIN] WARNING: --dense-rerank ignored ("
              + ("precomputed query embeddings carry no sequences"
                 if not have_seqs else "SW rerank already reranks at stride 1")
              + "); saving raw search results")

    t0 = time.time()
    final_ids = final_d = None
    records = None
    if have_seqs:
        records = fasta_io.parse_fasta_records(ref_file)
        multi = len(records) > 1
        if multi:
            if use_dynamic:
                print("[MAIN] WARNING: use_dynamic has no separate meaning for "
                      "multi-record references; using record-aware static "
                      "handling")
            # window ids are per-record cumulative window counts; fetches
            # address the concatenated base stream
            genome = np.concatenate(records)
            dense_off, base_off = fasta_io.record_window_table(records, ref_len, 1)
            sparse_off, _ = fasta_io.record_window_table(records, ref_len, stride)
            bound = 2 * int(dense_off[-1])
            rec_names = fasta_io.parse_fasta_names(ref_file)
            rec_lens = [int(len(r)) for r in records]
        else:
            genome = (
                records[0] if len(records) == 1
                else fasta_io.extract_fasta_sequence(ref_file)
            )
            dense_off = sparse_off = base_off = None
            rec_names = rec_lens = None
            if use_dynamic:
                bound = int(genome.size)
            else:
                # number of dense windows x 2 strands
                bound = 2 * max(0, int(genome.size) - ref_len + 1)

        def embed_windows(unique_ids: np.ndarray):
            if multi:
                unique_ids = fasta_io.translate_window_ids(
                    unique_ids, dense_off, base_off
                )
            # candidates are re-embedded WRAPPED, the space the index was
            # built in; the pool stays on the device for the rerank
            if native.available():
                wire = native.pack_windows_by_id(genome, ref_len, unique_ids)
            else:
                mat, lengths = fasta_io.fetch_windows_by_id(
                    genome, unique_ids, ref_len, tok.MAX_LEN, wrap=True
                )
                wire = pack_wrapped_numpy(mat, lengths)
            return vectorizer.vectorize_wire(wire, device_out=True)

        if rerank == "sw":
            def fetch_windows(ids: np.ndarray):
                if multi:
                    ids = fasta_io.translate_window_ids(ids, dense_off, base_off)
                return fasta_io.fetch_windows_by_id(
                    genome, ids, ref_len, max_len=ref_len, wrap=False
                )

            q_mat, q_lens = tok.strings_to_bytes(query_seqs)
            sw_timings = {}
            final_ids, final_d = pp.post_process_sw(
                neighbors, q_mat, q_lens, fetch_windows, stride, k,
                k_clusters, bound, sparse_off=sparse_off, dense_off=dense_off,
                device=vectorizer.device, timings=sw_timings,
            )
            print(f"[MAIN] sw rerank: fetch {sw_timings['fetch']:.3f}s | "
                  f"score {sw_timings['sw']:.3f}s | sort {sw_timings['sort']:.3f}s")
        else:
            final_ids, final_d = pp.post_process_l2(
                neighbors, distances, query_emb, embed_windows, stride, k,
                k_clusters, bound, force_rerank=dense_rerank,
                sparse_off=sparse_off, dense_off=dense_off,
            )
        if write_sam:
            pg = (f"pipeline {index_prefix} {query_file} ef={ef} k={k}"
                  f" k_clusters={k_clusters} rerank={rerank}"
                  + (" dense_rerank" if dense_rerank else ""))
            sam_io.write_sam(
                query_seqs, query_ids, final_ids.ravel(), "ref", ref_len, k,
                sam_file, record_names=rec_names, record_lens=rec_lens,
                dense_off=dense_off, pg=pg,
            )
    t_post = time.time() - t0

    if dense_rerank and stride == 1 and rerank != "sw" and final_d is not None:
        save_results(final_ids, final_d,
                     os.path.join(output_dir, "indices.npy"),
                     os.path.join(output_dir, "distances.npy"), k)
    else:
        # raw search results: k columns dense, k_clusters sparse
        save_results(neighbors, distances,
                     os.path.join(output_dir, "indices.npy"),
                     os.path.join(output_dir, "distances.npy"),
                     k if stride == 1 else k_clusters)
    return {
        "num_queries": int(query_emb.shape[0]),
        "k": k,
        "k_clusters": k_clusters,
        "stride": stride,
        "neighbors": neighbors,
        "distances": distances,
        "final_ids": final_ids,
        "final_d": final_d,
        "query_seqs": query_seqs,
        "query_ids": query_ids,
        "records": records,
        "t_index": t_index,
        "t_embed": t_embed,
        "t_search": t_search,
        "t_post": t_post,
    }
