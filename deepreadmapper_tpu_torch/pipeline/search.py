"""End-to-end search pipeline (L2 or Smith-Waterman rerank; long reads;
paired ends).

Counterpart of ``deepreadmapper_tpu/pipeline/search.py``: index load ->
query load/embed -> search -> post-process -> outputs.  indices.npy /
distances.npy hold the RAW search results (or, with --dense-rerank at
stride 1 on the L2 path, the reranked ones), exactly as the JAX package
writes them; SAM holds the post-processed candidates.
"""

from __future__ import annotations

import contextlib
import os
import re
import time

import numpy as np

from deepreadmapper_tpu_torch import native
from deepreadmapper_tpu_torch import tokenizer as tok
from deepreadmapper_tpu_torch.config import SearchConfig
from deepreadmapper_tpu_torch.io import fasta as fasta_io
from deepreadmapper_tpu_torch.io import sam as sam_io
from deepreadmapper_tpu_torch.io.bam import sam_to_bam
from deepreadmapper_tpu_torch.io.fastq import (
    parse_fastq,
    parse_fastq_bytes,
    parse_fastq_quals,
)
from deepreadmapper_tpu_torch.io.fileio import true_ext
from deepreadmapper_tpu_torch.io.readers import FASTA_EXTS, FASTQ_EXTS, read_txt
from deepreadmapper_tpu_torch.io.results import load_embeddings_npy, save_results
from deepreadmapper_tpu_torch import resolve_device
from deepreadmapper_tpu_torch.index.hnsw import HNSWPQIndex
from deepreadmapper_tpu_torch.index.ivf_int8 import IVFInt8Index
from deepreadmapper_tpu_torch.index.registry import load_index
from deepreadmapper_tpu_torch.models.encoder import Vectorizer, load_params
from deepreadmapper_tpu_torch.parallel import distributed as dist_
from deepreadmapper_tpu_torch.pipeline import longread as lr_mod
from deepreadmapper_tpu_torch.pipeline import postprocess as pp
from deepreadmapper_tpu_torch.pipeline.paired import PAD_ID, rescue_mates, resolve_pairs
from deepreadmapper_tpu_torch.tokenizer_device import pack_wrapped_numpy
from deepreadmapper_tpu_torch.utils.progress import Progress
from deepreadmapper_tpu_torch.utils import trace
from deepreadmapper_tpu_torch.utils.trace import device_trace

_CIGAR_RUN = re.compile(r"(\d+)([MID])")


def _load_queries(path: str, vectorizer: Vectorizer, embed: bool = True):
    """Returns (embeddings [Q,128] fp32, wrapped query seqs or None, ids).

    embed=False skips the encoder pass and returns no embeddings: long-read
    requests embed chunks, not whole reads (a whole-read embedding covers
    only the first ~121 bases).  FASTQ queries run in the spans embed.parse
    (the parse and the read strings; counter reads) and
    embed.encode (upload, device tokenizer, #1, the result's fetch)."""
    ext = true_ext(path)
    if ext == ".npy":
        return load_embeddings_npy(path), None, []
    if ext in FASTQ_EXTS:
        if not embed:
            seqs, ids = parse_fastq(path)
            return None, seqs, ids
        with trace.span("embed.parse"):
            mat, lengths, ids = parse_fastq_bytes(path)
            seqs = [bytes(row[: int(n)]).decode() for row, n in zip(mat, lengths)]
            trace.count("reads", len(seqs))
        with trace.span("embed.encode"):
            # 48-byte wire upload + device tokenizer
            emb = vectorizer.vectorize_wrapped_bytes(mat, lengths)
        return emb, seqs, ids
    if ext in FASTA_EXTS or ext == ".txt":
        if ext == ".txt":
            seqs = read_txt(path)
        else:
            records = fasta_io.parse_fasta_records(path)
            seqs = [r.tobytes().decode() for r in records]
        if not embed:
            return None, seqs, []
        return vectorizer.vectorize(seqs), seqs, []
    raise ValueError(f"Unsupported query input: {path}")


def _primary_alignment_cigars(
    query_seqs, primary_ids, genome, ref_len, multi, dense_off, base_off
):
    """Real SW-traceback CIGARs (native) for each query's primary hit, in
    reference orientation: reverse-strand alignments reverse their op runs
    and swap soft clips, and the returned pos_off shifts the SAM POS to the
    alignment's leftmost reference base.  Returns (cigars [Q], pos_off [Q],
    tags [Q], each a "\tNM:i:..\tMD:Z:..\tAS:i:.." suffix from
    io.sam.alignment_tags) or (None, None, None) when the native library is
    unavailable.  Counterpart of search._primary_alignment_cigars."""
    if not native.available():
        print("[MAIN] WARNING: --cigar needs the native library; skipping")
        return None, None, None
    ids = np.asarray(primary_ids, np.int64)
    fetch_ids = (
        fasta_io.translate_window_ids(ids, dense_off, base_off) if multi else ids
    )
    w_mat, w_lens = fasta_io.fetch_windows_by_id(
        genome, np.maximum(fetch_ids, 0), ref_len, max_len=ref_len, wrap=False
    )
    reads = [q[1:-1] if q.startswith("<") and q.endswith(">") else q
             for q in query_seqs]
    a_mat, a_lens = tok.strings_to_bytes(reads)
    _, a_span, b_span, cigs = native.sw_cigar(a_mat, a_lens, w_mat, w_lens)
    cigars: list[str] = []
    tags: list[str] = []
    pos_off = np.zeros(len(reads), np.int64)
    for i in range(len(reads)):
        body = cigs[i]
        if not body or ids[i] < 0:
            cigars.append("")  # overflow / invalid -> pseudo CIGAR
            tags.append("")
            continue
        alen = int(a_lens[i])
        a0, a1 = int(a_span[i, 0]), int(a_span[i, 1])
        b0, b1 = int(b_span[i, 0]), int(b_span[i, 1])
        runs = [(int(n), op) for n, op in _CIGAR_RUN.findall(body)]
        # NM/MD/AS from the native-orientation alignment; a reverse-strand
        # MD is re-expressed in forward-reference orientation by the helper
        nm, md, as_ = sam_io.alignment_tags(
            a_mat[i], w_mat[i], a0, b0, runs, reverse=bool(ids[i] & 1)
        )
        tags.append(f"\tNM:i:{nm}\tMD:Z:{md}\tAS:i:{as_}")
        if ids[i] & 1:  # reverse strand: reference orientation reverses ops
            body = "".join(f"{n}{op}" for n, op in reversed(runs))
            left, right = alen - a1, a0
            pos_off[i] = ref_len - b1
        else:
            left, right = a0, alen - a1
            pos_off[i] = b0
        cigars.append((f"{left}S" if left else "") + body
                      + (f"{right}S" if right else ""))
    return cigars, pos_off, tags


# Copied verbatim from deepreadmapper_tpu/pipeline/search.py (that module
# imports jax): the empirical MAPQ recalibration table.  Raw margin-quality
# bin -> observed mis-mapping rate, measured by
# scripts/eval_mapq_calibration.py on the hard synthetic (tandem arrays 5% +
# dispersed 1%-divergent repeat families 8%, read err 1%, INT8FLAT, 2 Mbp,
# seeds 0 fit / 1 validate), pooled to a monotone table (PAVA).  Keys: raw
# bin lower edges; values: calibrated MAPQ for the bin.
_MAPQ_CAL_BINS = np.array([0, 1, 10, 20, 30, 40, 50, 60], np.int32)
_MAPQ_CAL_VALS = np.array([0, 3, 5, 12, 19, 19, 24, 24], np.int32)


def calibrate_mapq(q_raw: np.ndarray) -> np.ndarray:
    """Map raw margin MAPQ through the fitted monotone table (see
    _MAPQ_CAL_BINS).  Interpolation within a bin keeps the order of raw
    values.  Copied from the JAX package's search.calibrate_mapq."""
    q = np.asarray(q_raw, np.float64)
    idx = np.clip(
        np.searchsorted(_MAPQ_CAL_BINS, q, side="right") - 1, 0,
        len(_MAPQ_CAL_BINS) - 1,
    )
    lo_b = _MAPQ_CAL_BINS[idx].astype(np.float64)
    hi_b = np.concatenate([_MAPQ_CAL_BINS[1:], [61]])[idx].astype(np.float64)
    lo_v = _MAPQ_CAL_VALS[idx].astype(np.float64)
    hi_v = np.concatenate([_MAPQ_CAL_VALS[1:], [_MAPQ_CAL_VALS[-1] + 1]])[
        idx
    ].astype(np.float64)
    frac = np.where(hi_b > lo_b, (q - lo_b) / (hi_b - lo_b), 0.0)
    return np.clip(np.rint(lo_v + frac * (hi_v - lo_v)), 0, 60).astype(np.int32)


def compute_mapq(
    ids: np.ndarray,
    vals: np.ndarray,
    ref_len: int,
    higher_is_better: bool = False,
    dense_off: np.ndarray | None = None,
) -> np.ndarray:
    """Margin-based mapping quality for each query's primary candidate:
    how much better the best placement scores than the best placement at a
    different locus.  "Same locus" = same strand, same record, position
    within ref_len of the primary.  dense_off (multi-record references):
    per-record cumulative window offsets, so adjacency across a chromosome
    boundary is not taken for the same locus.

    mapq = round(60 * relative margin), clipped to [0, 60]; 60 when no
    competing locus is among the candidates; 0 for an exact tie or an
    invalid (-1) primary.  Copied from the JAX package's
    search.compute_mapq (float64 host arithmetic)."""
    ids = np.asarray(ids, np.int64)
    vals = np.asarray(vals, np.float64)
    nq, k = ids.shape
    out = np.full(nq, 60, np.int32)
    if k < 2:
        out[ids[:, 0] < 0] = 0
        return out
    pos = ids >> 1
    same_locus = (np.abs(pos - pos[:, :1]) <= ref_len) & (
        (ids & 1) == (ids[:, :1] & 1)
    )
    if dense_off is not None:
        rec = np.searchsorted(dense_off, pos, side="right") - 1
        same_locus &= rec == rec[:, :1]
    competitor = ~same_locus & (ids >= 0)
    has = competitor.any(axis=1)
    j2 = np.argmax(competitor, axis=1)
    best = vals[:, 0]
    second = vals[np.arange(nq), j2]
    if higher_is_better:
        margin = best - second
        scale = np.maximum(np.abs(best), 1e-9)
    else:
        margin = second - best
        scale = np.maximum(np.abs(second), 1e-9)
    q = np.clip(np.rint(60.0 * margin / scale), 0, 60).astype(np.int32)
    out[has] = q[has]
    out[ids[:, 0] < 0] = 0
    return out


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


def _search(engine, query_emb, k_clusters, ef, search_stats):
    """engine.search, with the search-effort counters where the engine keeps
    them (the IVF and HNSW engines); others answer without stats."""
    if search_stats is not None and isinstance(engine, (IVFInt8Index, HNSWPQIndex)):
        return engine.search(query_emb, k_clusters, ef, stats=search_stats)
    return engine.search(query_emb, k_clusters, ef)


def _profiler(profile_dir: str | None, device):
    """torch.profiler over the whole request after the index load (host
    and, on a card, device activity, with the tracer's spans), or a null
    context.  The JAX package traces the search with jax.profiler; here
    the trace also covers the embed, the post-processing and the files."""
    if not profile_dir:
        return contextlib.nullcontext()
    return device_trace(profile_dir, "pipeline.pt.trace.json", cuda=device.type == "cuda")


def _finish_sam(sam_file, output_dir, sort, mark_dups, bam):
    """The SAM's last steps, in this order: coordinate sort, duplicate
    marking, results.bam (with a .bai when sorted)."""
    if sort:
        sam_io.sort_sam_file(sam_file)
    if mark_dups:
        nd = sam_io.mark_duplicates(sam_file)
        if nd:
            print(f"[MAIN] marked {nd} duplicate lines (FLAG 0x400)")
    if bam:
        bam_file = os.path.join(output_dir, "results.bam")
        # a BAI is valid only over coordinate-sorted records; drop a stale
        # index from an earlier sorted run into the same dir
        if not sort and os.path.exists(bam_file + ".bai"):
            os.remove(bam_file + ".bai")
        sam_to_bam(sam_file, bam_file, bai_path=bam_file + ".bai" if sort else None)


def _map_long(query_seqs, query_ids, vectorizer, engine, genome, ref_len, k, ef,
              stride, max_chunks, multi, dense_off, sparse_off, base_off, sam_file,
              cigar, sam_kw):
    """run_pipeline's long-read branch: chunk -> search -> chain
    (pipeline/longread.py) in one global base space, then the SAM (when
    sam_file is set) with support MAPQ, FLAG-2048 supplementary lines and,
    with cigar, banded-alignment CIGARs.  Returns (ids, dists, timings).
    Counterpart of the long_reads branch of the JAX run_pipeline."""
    clean = [sam_io._clean_query(q) for q in query_seqs]
    if multi:
        # sparse window index -> concatenated base stream; base start ->
        # record-cumulative dense window id, clamped into its record
        def ids_to_base(w):
            r, loc = fasta_io.record_of(w, sparse_off)
            return base_off[r] + loc * stride

        def base_to_dense(s, rev):
            r = np.clip(np.searchsorted(base_off, s, side="right") - 1,
                        0, len(base_off) - 2)
            loc = np.clip(s - base_off[r], 0, dense_off[r + 1] - dense_off[r] - 1)
            return 2 * (dense_off[r] + loc) + rev
    else:
        n_dense = max(1, int(genome.size) - ref_len + 1)

        def ids_to_base(w):
            return w * stride

        def base_to_dense(s, rev):
            return 2 * np.minimum(s, n_dense - 1) + rev

    timings: dict = {}
    ids, dists, mapq, supp = lr_mod.map_long_reads(
        clean, vectorizer, engine, ref_len, k, ef, stride=stride,
        ids_to_base=ids_to_base, base_to_dense=base_to_dense, timings=timings,
        max_chunks=max_chunks,
    )
    if supp:
        print(f"[MAIN] split-read: {len(supp)} reads carry supplementary "
              "(FLAG 2048) segments")
    if sam_file is not None:
        pc = po = pt = None
        if cigar:
            # band = one window: the chain places the read to within the
            # vote tolerance, so the alignment's diagonal lies in the band
            pc, po, pt = lr_mod.banded_primary_cigars(
                clean, ids[:, 0], genome, band=ref_len,
                dense_off=dense_off if multi else None,
                base_off=base_off if multi else None,
            )
        sam_io.write_sam(query_seqs, query_ids, ids.ravel(), "ref", ref_len, k,
                         sam_file, mapq=mapq, supplementary=supp,
                         primary_cigars=pc, primary_pos_off=po, primary_tags=pt,
                         **sam_kw)
    return ids, dists, timings


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
    cigar: bool = False,
    mapq: bool = False,
    mapq_calibrated: bool = False,
    long_reads: bool = False,
    lr_max_chunks: int = 128,
    qual: bool = False,
    sort: bool = False,
    bam: bool = False,
    mark_dups: bool = False,
    read_group: str | None = None,
    profile_dir: str | None = None,
    vectorizer: Vectorizer | None = None,
    search_cfg: SearchConfig | None = None,
    preloaded: tuple | None = None,
    search_stats: dict | None = None,
    device=None,
) -> dict:
    """Run the pipeline; returns a timing/result summary.

    rerank="l2" reranks sparse candidates by sqrt-L2 of re-embedded windows;
    rerank="sw" reranks every candidate by Smith-Waterman score against the
    read (at any stride), and the SAM holds the SW-ranked ids.
    dense_rerank=True re-embeds and exactly reranks the search candidates
    on a dense (stride 1) index on the L2 path; indices.npy / distances.npy
    then hold the reranked sqrt-L2 results.  Otherwise they hold the raw
    search results.  ef is nprobe for the IVF engines and the beam width
    for the HNSW engines; search_stats, when a dict, receives their
    search-effort counters (other engines ignore it).

    The SAM options follow the JAX package: cigar (real SW-traceback CIGARs
    and NM/MD/AS on primaries), mapq (margin MAPQ; mapq_calibrated maps it
    through the fitted table on the non-streaming L2 path), qual (FASTQ
    qualities), read_group (@RG + RG:Z), sort, mark_dups, bam (results.bam,
    with a .bai when sorted).  use_streaming reranks and appends the SAM
    per search_cfg.query_batch_size reads, and saves no npy.  profile_dir
    writes a torch.profiler Chrome trace of the request, its spans
    included.
    preloaded=(engine, config) skips the index load (the serve daemon).
    device defaults to the CUDA device (raises without one).

    long_reads=True maps reads longer than one window by chunk -> search ->
    chain (pipeline/longread.py, at most lr_max_chunks chunks a read): the
    SAM holds chained read-start placements with support MAPQ and FLAG-2048
    supplementary lines for split reads, cigar=True banded-aligns the
    primaries, and indices.npy / distances.npy hold the chained ids and
    1 - chunk-support fraction.  The returned t_lr_split splits its time
    into host_pack / embed / search / chain.

    Spans (utils.trace): pipeline.index, pipeline.embed, pipeline.search,
    pipeline.post (children post.fasta, post.l2 or post.sw.fetch /
    post.sw.score / post.sw.sort, post.sam, post.finish, or
    post.long_reads) and write.npy; the returned t_embed, t_search and
    t_post are the three pipeline spans' seconds."""
    if rerank not in ("l2", "sw"):
        raise ValueError(f"unknown rerank {rerank!r} (l2 | sw)")
    device = resolve_device(device)
    scfg = search_cfg or SearchConfig()
    ef = ef if ef is not None else scfg.ef
    k = k if k is not None else scfg.k

    with trace.span("pipeline.index") as index_span:
        engine, config = preloaded if preloaded else load_index(index_prefix, device)
    ref_len = int(config["ref_len"])
    stride = int(config["stride"])
    if stride == 1:
        k_clusters = k
    elif k_clusters is None:
        k_clusters = scfg.k_clusters

    vectorizer = vectorizer_for_index(index_prefix, config, vectorizer, device)
    with _profiler(profile_dir, device):
        with trace.span("pipeline.embed") as embed_span:
            query_emb, query_seqs, query_ids = _load_queries(query_file, vectorizer,
                                                             embed=not long_reads)
        with trace.span("pipeline.search") as search_span:
            neighbors = distances = None
            if not long_reads:
                # the long-read path searches its chunk batch below instead
                neighbors, distances = _search(engine, query_emb, k_clusters, ef,
                                               search_stats)

        # Under a process group every rank runs the same pipeline (the same
        # reads, the sharded search merged on every rank); only rank 0 writes
        # the output files.  write_sam keeps its role in the control flow (the
        # streaming fallback below): the other ranks still run per batch and
        # skip the writes.
        is_main = dist_.is_main()
        sam_out = write_sam and is_main
        os.makedirs(output_dir, exist_ok=True)
        sam_file = os.path.join(output_dir, "results.sam")
        have_seqs = query_seqs is not None
        if use_streaming and not write_sam:
            # streaming exists to bound SAM memory; without SAM it would rerank
            # per batch and emit nothing at all
            print("[MAIN] WARNING: use_streaming without SAM output has nothing to "
                  "stream; falling back to the non-streaming path")
            use_streaming = False
        if cigar and not have_seqs:
            print("[MAIN] WARNING: --cigar ignored (precomputed query embeddings "
                  "carry no sequences to align)")
            cigar = False
        if mapq and not have_seqs:
            print("[MAIN] WARNING: --mapq ignored (no SAM output without query "
                  "sequences)")
            mapq = False
        if long_reads:
            if not have_seqs:
                raise ValueError(
                    "--long-reads needs query SEQUENCES (precomputed embeddings "
                    "only cover the first ~121 bases of each read)")
            if cigar and not native.available():
                print("[MAIN] WARNING: --cigar needs the native library (banded "
                      "long-read aligner); skipping")
                cigar = False
            for flag, name, why in (
                    (use_streaming, "use_streaming", ""),
                    (rerank == "sw", "--rerank sw", " (placements are chunk-support "
                     "chains, not SW-reranked)"),
                    (dense_rerank, "--dense-rerank", "")):
                if flag:
                    print(f"[MAIN] WARNING: {name} ignored with --long-reads{why}")
            use_streaming, rerank, dense_rerank = False, "l2", False
            # support-margin MAPQ is intrinsic to chain voting: long-read
            # primaries and their supplementaries always score on that scale
            mapq = True
        if dense_rerank and stride == 1 and (not have_seqs or rerank == "sw"):
            print("[MAIN] WARNING: --dense-rerank ignored ("
                  + ("precomputed query embeddings carry no sequences"
                     if not have_seqs else "SW rerank already reranks at stride 1")
                  + "); saving raw search results")
        quals = None
        if qual:
            if have_seqs and true_ext(query_file) in FASTQ_EXTS:
                quals = parse_fastq_quals(query_file)
            else:
                print("[MAIN] WARNING: --qual needs FASTQ queries; ignored")
        pg = (f"pipeline {index_prefix} {query_file} ef={ef} k={k}"
              f" k_clusters={k_clusters} rerank={rerank}"
              + (" dense_rerank" if dense_rerank else "")
              + (" cigar" if cigar else "")
              + (" mapq" if mapq else "")
              + (" long_reads" if long_reads else ""))

        final_ids = final_d = None
        records = None
        lr_timings = None
        t_long = 0.0
        with trace.span("pipeline.post") as post_span:
            if have_seqs:
                with trace.span("post.fasta"):
                    records = fasta_io.parse_fasta_records(ref_file)
                    multi = len(records) > 1
                    if multi:
                        if use_dynamic:
                            print("[MAIN] WARNING: use_dynamic has no separate meaning "
                                  "for multi-record references; using record-aware "
                                  "static handling")
                        # window ids are per-record cumulative window counts;
                        # fetches address the concatenated base stream
                        genome = np.concatenate(records)
                        dense_off, base_off = fasta_io.record_window_table(records,
                                                                           ref_len, 1)
                        sparse_off, _ = fasta_io.record_window_table(records, ref_len,
                                                                     stride)
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
                sam_kw = dict(record_names=rec_names, record_lens=rec_lens,
                              dense_off=dense_off, pg=pg, quals=quals, rg=read_group)

                def embed_windows(unique_ids: np.ndarray):
                    if multi:
                        unique_ids = fasta_io.translate_window_ids(
                            unique_ids, dense_off, base_off
                        )
                    # candidates are re-embedded WRAPPED, the space the index
                    # was built in; the pool stays on the device for the rerank
                    if vectorizer.max_len != tok.MAX_LEN:
                        mat, lengths = fasta_io.fetch_windows_by_id(
                            genome, unique_ids, ref_len, vectorizer.max_len, wrap=True
                        )
                        return vectorizer.vectorize_tokens(
                            tok.tokenize_bytes_fast(mat, lengths, vectorizer.max_len),
                            device_out=True)
                    if native.available():
                        wire = native.pack_windows_by_id(genome, ref_len, unique_ids)
                    else:
                        mat, lengths = fasta_io.fetch_windows_by_id(
                            genome, unique_ids, ref_len, tok.MAX_LEN, wrap=True
                        )
                        wire = pack_wrapped_numpy(mat, lengths)
                    return vectorizer.vectorize_wire(wire, device_out=True)

                def cigars_of(seqs, primary_ids):
                    return _primary_alignment_cigars(seqs, primary_ids, genome, ref_len,
                                                     multi, dense_off, base_off)

                if long_reads:
                    with trace.span("post.long_reads") as long_span:
                        final_ids, final_d, lr_timings = _map_long(
                            query_seqs, query_ids, vectorizer, engine, genome, ref_len,
                            k, ef, stride, lr_max_chunks, multi, dense_off, sparse_off,
                            base_off, sam_file if sam_out else None, cigar, sam_kw)
                    t_long = long_span.seconds
                elif rerank == "sw":
                    with trace.span("post.sw.fetch"):
                        q_mat, q_lens = tok.strings_to_bytes(query_seqs)
                    final_ids, final_d = pp.post_process_sw(
                        neighbors, q_mat, q_lens, None, stride, k, k_clusters, bound,
                        sparse_off=sparse_off, dense_off=dense_off,
                        device=vectorizer.device, genome=genome, ref_len=ref_len,
                        base_off=base_off,
                    )
                    if sam_out:
                        with trace.span("post.sam"):
                            mq = (compute_mapq(final_ids, final_d, ref_len,
                                               higher_is_better=True, dense_off=dense_off)
                                  if mapq else None)
                            sam_io.write_sam(
                                query_seqs, query_ids, final_ids.ravel(), "ref",
                                ref_len, k, sam_file, mapq=mq, **sam_kw)
                elif use_streaming:
                    bs = scfg.query_batch_size
                    nq = query_emb.shape[0]
                    sprog = Progress(nq, "[MAIN] rerank+SAM reads")
                    for start in range(0, nq, bs):
                        end = min(start + bs, nq)
                        with trace.span("post.l2"):
                            ids_b, d_b = pp.post_process_l2(
                                neighbors[start:end], distances[start:end],
                                query_emb[start:end], embed_windows, stride, k,
                                k_clusters, bound, force_rerank=dense_rerank,
                                sparse_off=sparse_off, dense_off=dense_off,
                            )
                        with trace.span("post.sam"):
                            pc = po = mq = pt = None
                            if cigar:
                                pc_b, po_b, pt_b = cigars_of(query_seqs[start:end],
                                                             ids_b[:, 0])
                                if pc_b is not None:
                                    # per-batch lists are indexed by the GLOBAL
                                    # query number inside format_sam_records
                                    pc = [""] * start + pc_b
                                    pt = [""] * start + pt_b
                                    po = np.concatenate([np.zeros(start, np.int64), po_b])
                            if mapq:
                                mq = np.concatenate([
                                    np.zeros(start, np.int32),
                                    compute_mapq(ids_b, d_b, ref_len, dense_off=dense_off),
                                ])
                            if sam_out:
                                sam_io.write_sam(
                                    query_seqs[start:end], query_ids, ids_b.ravel(), "ref",
                                    ref_len, k, sam_file, append=start > 0,
                                    write_header=start == 0, query_offset=start,
                                    primary_cigars=pc, primary_pos_off=po,
                                    primary_tags=pt, mapq=mq, **sam_kw,
                                )
                        sprog.update(end - start)
                    sprog.close()
                else:
                    with trace.span("post.l2"):
                        final_ids, final_d = pp.post_process_l2(
                            neighbors, distances, query_emb, embed_windows, stride, k,
                            k_clusters, bound, force_rerank=dense_rerank,
                            sparse_off=sparse_off, dense_off=dense_off,
                        )
                    if sam_out:
                        with trace.span("post.sam"):
                            pc = po = mq = pt = None
                            if cigar:
                                pc, po, pt = cigars_of(query_seqs, final_ids[:, 0])
                            if mapq:
                                mq = compute_mapq(final_ids, final_d, ref_len,
                                                  dense_off=dense_off)
                                if mapq_calibrated:
                                    mq = calibrate_mapq(mq)
                            sam_io.write_sam(
                                query_seqs, query_ids, final_ids.ravel(), "ref", ref_len,
                                k, sam_file, primary_cigars=pc, primary_pos_off=po,
                                primary_tags=pt, mapq=mq, **sam_kw,
                            )
            if sam_out and os.path.exists(sam_file) and (sort or mark_dups or bam):
                with trace.span("post.finish"):
                    _finish_sam(sam_file, output_dir, sort, mark_dups, bam)

        # a streamed run's output is its SAM alone, as in the JAX package
        if not use_streaming and is_main:
            npys = (os.path.join(output_dir, "indices.npy"),
                    os.path.join(output_dir, "distances.npy"))
            with trace.span("write.npy"):
                if long_reads:
                    # chained read-start placements; "distances" are 1 - the
                    # chunk-support fraction (ascending better)
                    save_results(final_ids, final_d, *npys, k)
                elif (dense_rerank and stride == 1 and rerank != "sw"
                      and final_d is not None):
                    save_results(final_ids, final_d, *npys, k)
                else:
                    # raw search results: k columns dense, k_clusters sparse
                    save_results(neighbors, distances, *npys,
                                 k if stride == 1 else k_clusters)
        # the long-read path searches inside pipeline.post: t_search is its
        # post.long_reads span, t_post the rest
        return {
            "num_queries": (len(query_seqs) if query_emb is None
                            else int(query_emb.shape[0])),
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
            "t_index": index_span.seconds,
            "t_embed": embed_span.seconds,
            "t_search": t_long if long_reads else search_span.seconds,
            "t_post": post_span.seconds - t_long,
            "t_lr_split": lr_timings,
        }


def _promote(ids, d, chosen):
    """Swap each row's chosen pair member into the primary column; a rescued
    id absent from the candidate list overwrites column 0 (its npy distance
    keeps the displaced value: rescue scores live on the SW scale, not the
    engine's)."""
    ids = ids.copy()
    d = d.copy()
    for i in range(ids.shape[0]):
        if chosen[i] < 0 or ids[i, 0] == chosen[i]:
            continue
        js = np.flatnonzero(ids[i] == chosen[i])
        if js.size:
            j = int(js[0])
            ids[i, 0], ids[i, j] = ids[i, j], ids[i, 0]
            d[i, 0], d[i, j] = d[i, j], d[i, 0]
        else:
            ids[i, 0] = chosen[i]
    return ids, d


def _rescue(pair, ids1, d1, ids2, d2, sgn, seqs1, seqs2, lens1, lens2, records,
            dense_off, ref_len, max_isize, min_isize):
    """Mate rescue for the improper pairs: scan the expected FR mate
    interval next to the better-scoring end with the native SW scorer,
    clipped to the anchor's record; a hit makes the pair proper with an
    SW-identity MAPQ on the rescued end.  Updates pair in place; returns the
    number of pairs rescued."""
    multi = dense_off is not None
    if multi:
        base_off = fasta_io.record_window_table(records, ref_len, 1)[1]

        def _rec(bpos):
            return int(np.clip(np.searchsorted(base_off, bpos, side="right") - 1,
                               0, len(base_off) - 2))

        def _to_base(aid):
            return int(fasta_io.translate_window_ids(np.asarray([aid]), dense_off,
                                                     base_off)[0])

        def _to_dense(base_id):
            r = _rec(base_id >> 1)
            # clamp into the record's stride-1 window grid: a mate shorter
            # than ref_len rescued within the record's last (ref_len -
            # mate_len) bases shifts left by at most that difference
            loc = min(int((base_id >> 1) - base_off[r]),
                      int(dense_off[r + 1] - dense_off[r] - 1))
            return 2 * (int(dense_off[r]) + loc) + (base_id & 1)

        def _bounds(base_id):
            r = _rec(base_id >> 1)
            return int(base_off[r]), int(base_off[r + 1])
    else:
        total = int(sum(len(r) for r in records))

        def _to_base(aid):
            return aid

        def _to_dense(base_id):
            return int(base_id)

        def _bounds(_base_id):
            return 0, total
    genome = records[0] if len(records) == 1 else np.concatenate(records)
    # anchor confidence = its single-end margin: an ambiguous anchor must
    # not mint a confident rescued pair
    se1 = compute_mapq(ids1, sgn * d1, ref_len, dense_off=dense_off)
    se2 = compute_mapq(ids2, sgn * d2, ref_len, dense_off=dense_off)
    anchors, targets, alens, bounds, tgt_end = [], [], [], [], []
    for i in np.flatnonzero(~pair["proper"]):
        use1 = sgn * d1[i, 0] <= sgn * d2[i, 0]  # anchor: the better top hit
        aid = int(ids1[i, 0] if use1 else ids2[i, 0])
        if aid < 0:
            continue
        base_aid = _to_base(aid)
        anchors.append(base_aid)
        alens.append(int(lens1[i] if use1 else lens2[i]))
        tread = seqs2[i] if use1 else seqs1[i]
        targets.append(tread[1:-1] if len(tread) > 2 else tread)
        bounds.append(_bounds(base_aid))
        tgt_end.append((i, 2 if use1 else 1))
    if not anchors:
        return 0
    r_ids, r_scores = rescue_mates(
        np.asarray(anchors), targets, np.asarray(alens), genome, max_isize,
        min_isize, rec_bounds=np.asarray(bounds, np.int64),
    )
    n_rescued = 0
    for (i, end), rid, rsc in zip(tgt_end, r_ids, r_scores):
        if rid == PAD_ID:
            continue
        did = _to_dense(int(rid))
        if end == 2:
            pair["b_id"][i], pair["a_id"][i], lq = did, ids1[i, 0], int(lens2[i])
        else:
            pair["a_id"][i], pair["b_id"][i], lq = did, ids2[i, 0], int(lens1[i])
        pair["proper"][i] = True
        a_id, b_id = int(pair["a_id"][i]), int(pair["b_id"][i])
        ap, bp = a_id >> 1, b_id >> 1
        pair["tlen"][i] = -(ap + int(lens1[i]) - bp) if a_id & 1 else bp + int(lens2[i]) - ap
        # the rescued end: SW-identity-scaled quality, capped at 40
        rq = int(min(40, round(60.0 * int(rsc) / max(lq, 1))))
        if end == 2:
            pair["mapq2"][i], pair["mapq1"][i] = rq, int(se1[i])
        else:
            pair["mapq1"][i], pair["mapq2"][i] = rq, int(se2[i])
        n_rescued += 1
    return n_rescued


def run_pipeline_paired(
    index_prefix: str,
    query_file1: str,
    query_file2: str,
    ref_file: str,
    ef: int | None = None,
    k: int | None = None,
    k_clusters: int | None = None,
    output_dir: str = ".",
    rerank: str = "l2",
    dense_rerank: bool = False,
    write_sam: bool = True,
    mapq: bool = False,
    mapq_calibrated: bool = False,
    qual: bool = False,
    max_isize: int = 1000,
    min_isize: int = 0,
    cigar: bool = False,
    long_reads: bool = False,
    use_streaming: bool = False,
    sort: bool = False,
    bam: bool = False,
    mark_dups: bool = False,
    read_group: str | None = None,
    rescue: bool = True,
    vectorizer: Vectorizer | None = None,
    search_cfg: SearchConfig | None = None,
    preloaded: tuple | None = None,
    device=None,
) -> dict:
    """Paired-end mapping: both ends run the single-end pipeline against one
    resident engine, then pipeline/paired.resolve_pairs picks the FR-proper
    candidate combination per pair, and mate rescue (rescue=True) scans the
    expected mate interval of each improper pair with the native SW scorer.
    The SAM gets the paired vocabulary (FLAG 0x1/0x2/0x8/0x20/0x40/0x80,
    RNEXT '=' or the mate's record, PNEXT, signed TLEN) with each pair's
    chosen members as primaries; mapq uses the pair margin for proper pairs;
    indices.npy / distances.npy stack R1's rows, then R2's.  cigar,
    long_reads and use_streaming are not supported here and are ignored
    with a warning, as in the JAX package.  Besides the JAX package's keys,
    the result holds t_index, t_ends (each end's embed and search seconds)
    and t_pair_split (the host seconds of resolve, rescue and sam).
    Under a process group every rank runs it and rank 0 writes the
    outputs.  Counterpart of the JAX run_pipeline_paired."""
    for flag, name in ((cigar, "--cigar"), (long_reads, "--long-reads"),
                       (use_streaming, "use_streaming")):
        if flag:
            print(f"[MAIN] WARNING: {name} not supported in paired-end "
                  "mode yet; ignored")
    device = resolve_device(device)
    timings = {}
    t0 = time.time()
    engine, config = preloaded if preloaded else load_index(index_prefix, device)
    t_index = time.time() - t0
    vectorizer = vectorizer_for_index(index_prefix, config, vectorizer, device)
    ref_len = int(config["ref_len"])
    common = dict(
        ef=ef, k=k, k_clusters=k_clusters, output_dir=output_dir, rerank=rerank,
        dense_rerank=dense_rerank, write_sam=False, vectorizer=vectorizer,
        search_cfg=search_cfg, preloaded=(engine, config), device=device,
    )
    res1 = run_pipeline(index_prefix, query_file1, ref_file, **common)
    res2 = run_pipeline(index_prefix, query_file2, ref_file, **common)

    def _final(res):
        if res["final_ids"] is not None:
            return np.asarray(res["final_ids"]), np.asarray(res["final_d"])
        return np.asarray(res["neighbors"]), np.asarray(res["distances"])

    ids1, d1 = _final(res1)
    ids2, d2 = _final(res2)
    if ids1.shape[0] != ids2.shape[0]:
        raise ValueError(f"paired inputs differ in read count: {ids1.shape[0]} vs "
                         f"{ids2.shape[0]}")
    seqs1, qids1 = res1["query_seqs"], res1["query_ids"]
    seqs2, qids2 = res2["query_seqs"], res2["query_ids"]
    if qids1 and qids2 and qids1 != qids2:
        raise ValueError("paired FASTQs disagree on read names/order (mates must "
                         "share QNAME row by row; ids are /1 /2-suffix-stripped "
                         "at parse)")
    lens1 = np.array([len(s) - 2 for s in seqs1], np.int64)
    lens2 = np.array([len(s) - 2 for s in seqs2], np.int64)

    t0 = time.time()
    records = res1["records"] or fasta_io.parse_fasta_records(ref_file)
    multi = len(records) > 1
    if multi:
        dense_off = fasta_io.record_window_table(records, ref_len, 1)[0]
        rec_names = fasta_io.parse_fasta_names(ref_file)
        rec_lens = [int(len(r)) for r in records]
    else:
        dense_off = rec_names = rec_lens = None
    # resolve_pairs takes ascending-better scores; SW scores are descending
    sgn = -1.0 if rerank == "sw" else 1.0
    pair = resolve_pairs(ids1, sgn * d1, ids2, sgn * d2, lens1, lens2, max_isize,
                         min_isize, ref_len, dense_off=dense_off)
    timings["resolve"] = time.time() - t0

    t0 = time.time()
    n_rescued = 0
    if rescue and not pair["proper"].all():
        n_rescued = _rescue(pair, ids1, d1, ids2, d2, sgn, seqs1, seqs2, lens1, lens2,
                            records, dense_off, ref_len, max_isize, min_isize)
    if n_rescued:
        print(f"[MAIN] mate rescue: {n_rescued} pairs recovered by SW scan")
    timings["rescue"] = time.time() - t0

    t0 = time.time()
    ids1p, d1p = _promote(ids1, d1, pair["a_id"])
    ids2p, d2p = _promote(ids2, d2, pair["b_id"])

    def _rname_pos(wid):
        if wid < 0:
            return "*", 0
        w = int(wid) >> 1
        if multi:
            r, loc = fasta_io.record_of(np.asarray([w]), dense_off)
            return rec_names[int(r[0])], int(loc[0]) + 1
        return "ref", w + 1

    def _mate_dict(my_ids, other_ids, first, tl_sign):
        out = {}
        base = 0x1 | (0x40 if first else 0x80)
        for i in range(my_ids.shape[0]):
            o = int(other_ids[i, 0])
            flag = base | (0x2 if pair["proper"][i] else 0)
            if o < 0:
                flag |= 0x8
                rnext, pnext = "=", 0
            else:
                if o & 1:
                    flag |= 0x20
                rn_o, pnext = _rname_pos(o)
                rnext = "=" if rn_o == _rname_pos(int(my_ids[i, 0]))[0] else rn_o
            out[i] = (flag, rnext, pnext, tl_sign * int(pair["tlen"][i]))
        return out

    mate1 = _mate_dict(ids1p, ids2p, first=True, tl_sign=1)
    mate2 = _mate_dict(ids2p, ids1p, first=False, tl_sign=-1)
    mq1 = mq2 = None
    if mapq:
        hib = rerank == "sw"
        s1 = compute_mapq(ids1p, d1p, ref_len, dense_off=dense_off, higher_is_better=hib)
        s2 = compute_mapq(ids2p, d2p, ref_len, dense_off=dense_off, higher_is_better=hib)
        mq1 = np.where(pair["proper"], pair["mapq1"], s1).astype(np.int32)
        mq2 = np.where(pair["proper"], pair["mapq2"], s2).astype(np.int32)
        if mapq_calibrated:
            mq1, mq2 = calibrate_mapq(mq1), calibrate_mapq(mq2)

    # under a process group only rank 0 writes the outputs (run_pipeline)
    is_main = dist_.is_main()
    os.makedirs(output_dir, exist_ok=True)
    if write_sam and is_main:
        sam_file = os.path.join(output_dir, "results.sam")
        pg = (f"pipeline-paired {index_prefix} {query_file1} {query_file2} "
              f"max_isize={max_isize}")
        sam_kw = dict(record_names=rec_names, record_lens=rec_lens,
                      dense_off=dense_off, rg=read_group)
        out_k = ids1p.shape[1]
        sam_io.write_sam(seqs1, qids1, ids1p.ravel(), "ref", ref_len, out_k, sam_file,
                         mapq=mq1, quals=parse_fastq_quals(query_file1) if qual else None,
                         mate=mate1, pg=pg, **sam_kw)
        sam_io.write_sam(seqs2, qids2, ids2p.ravel(), "ref", ref_len, out_k, sam_file,
                         append=True, write_header=False, mapq=mq2,
                         quals=parse_fastq_quals(query_file2) if qual else None,
                         mate=mate2, **sam_kw)
        _finish_sam(sam_file, output_dir, sort, mark_dups, bam)
    if is_main:
        save_results(np.vstack([ids1p, ids2p]), np.vstack([d1p, d2p]),
                     os.path.join(output_dir, "indices.npy"),
                     os.path.join(output_dir, "distances.npy"), ids1p.shape[1])
    timings["sam"] = time.time() - t0
    n_proper = int(pair["proper"].sum())
    print(f"[MAIN] paired: {n_proper}/{ids1.shape[0]} proper pairs "
          f"(max_isize {max_isize})")
    return {
        "num_pairs": int(ids1.shape[0]),
        "n_proper": n_proper,
        "n_rescued": n_rescued,
        "pair": pair,
        "t_index": t_index,
        "t_embed": res1["t_embed"] + res2["t_embed"],
        "t_search": res1["t_search"] + res2["t_search"],
        "t_post": res1["t_post"] + res2["t_post"],
        "t_ends": [(res1["t_embed"], res1["t_search"]), (res2["t_embed"], res2["t_search"])],
        "t_pair_split": timings,
        "num_queries": int(ids1.shape[0]) * 2,
    }
