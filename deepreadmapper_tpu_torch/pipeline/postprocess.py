"""Candidate post-processing: the L2 path (dense passthrough, or sparse
expansion + dedup + re-embed + sqrt-L2 rerank) and the Smith-Waterman
rerank.

Counterpart of ``deepreadmapper_tpu/pipeline/postprocess.py``.  Semantics,
including the deliberate divergences from the C++ reference documented
there, are the same: clipped expansion slots are masked, not shifted.  One
divergence from the JAX package: its SW rerank sorts ``-scores`` in int32,
where the INT32_MIN of an invalid slot negates to itself, so invalid slots
sort FIRST; here they sort last.
"""

from __future__ import annotations

import numpy as np
import torch

from deepreadmapper_tpu_torch import resolve_device
from deepreadmapper_tpu_torch.io.fasta import translate_window_ids
from deepreadmapper_tpu_torch.ops.sw import sw_scores, sw_scores_by_id
from deepreadmapper_tpu_torch.ops.topk import as_f32, smallest_k
from deepreadmapper_tpu_torch.utils import trace

_INT32_MIN = np.iinfo(np.int32).min


# Copied from deepreadmapper_tpu/pipeline/postprocess.py (that module imports jax).
def expand_candidates(
    neighbors: np.ndarray,
    stride: int,
    bound: int,
    k_clusters: int,
    sparse_off: np.ndarray | None = None,
    dense_off: np.ndarray | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Expand sparse hits to dense window-id candidates.

    neighbors: int array [Q, >=k_clusters] of sparse ids (-1 = missing).
    Returns (cand_ids [Q, C] int64 with -1 for invalid, C = k_clusters*(2s-1)).

    Multi-record references pass per-record window tables (sparse_off at the
    index stride, dense_off at stride 1, from io.fasta.record_window_table):
    the expansion then runs in each hit's RECORD-LOCAL id space and
    candidates are clipped to that record; returned ids are global dense ids
    (2*dense_off[r] + local).
    """
    s = stride
    q = neighbors.shape[0]
    sparse = neighbors[:, :k_clusters].astype(np.int64)
    offs = np.arange(-(s - 1), s, dtype=np.int64)  # 2s-1 offsets
    if sparse_off is None:
        ap = sparse * s  # [Q, kc]
        cand = ap[:, :, None] + offs[None, None, :]  # [Q, kc, 2s-1]
        valid = (
            (sparse[:, :, None] >= 0)
            & (ap[:, :, None] < bound)
            & (cand >= 0)
            & (cand < bound)
        )
        cand = np.where(valid, cand, -1)
        return cand.reshape(q, -1), valid.reshape(q, -1)

    from deepreadmapper_tpu_torch.io.fasta import record_of

    st = sparse & 1
    r, w_loc = record_of(sparse >> 1, sparse_off)
    sparse_loc = 2 * w_loc + st
    ap = sparse_loc * s
    bound_r = 2 * (dense_off[r + 1] - dense_off[r])  # [Q, kc]
    cand_loc = ap[:, :, None] + offs[None, None, :]
    valid = (
        (sparse[:, :, None] >= 0)
        & (ap[:, :, None] < bound_r[:, :, None])
        & (cand_loc >= 0)
        & (cand_loc < bound_r[:, :, None])
    )
    cand = 2 * dense_off[r][:, :, None] + cand_loc
    cand = np.where(valid, cand, -1)
    return cand.reshape(q, -1), valid.reshape(q, -1)


# Copied from deepreadmapper_tpu/pipeline/postprocess.py (that module imports jax).
def unique_pool(cand_ids: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Global dedup.  Returns (unique ids sorted ascending [U], pool index per
    candidate slot [Q, C] int32 with -1 for invalid)."""
    flat = cand_ids.ravel()
    valid = flat >= 0
    uniq = np.unique(flat[valid])
    pool_idx = np.full(flat.shape, -1, dtype=np.int32)
    pool_idx[valid] = np.searchsorted(uniq, flat[valid]).astype(np.int32)
    return uniq, pool_idx.reshape(cand_ids.shape)


# Copied from deepreadmapper_tpu/pipeline/postprocess.py (that module imports jax).
def check_invariant(k: int, k_clusters: int, stride: int) -> None:
    """Validate k against the REAL sparse candidate count
    k_clusters * (2*stride - 1) with a clear error."""
    if stride > 1:
        n_cands = k_clusters * (2 * stride - 1)
        if k > n_cands:
            raise ValueError(
                f"Final k={k} too large: sparse expansion yields only "
                f"k_clusters*(2*stride-1) = {k_clusters}*{2 * stride - 1} = "
                f"{n_cands} candidates per query. Reduce k or raise "
                "k_clusters."
            )


def post_process_sw(
    neighbors: np.ndarray,
    query_mat: np.ndarray,
    query_lens: np.ndarray,
    fetch_windows,
    stride: int,
    k: int,
    k_clusters: int,
    bound: int,
    query_chunk: int = 512,
    sparse_off: np.ndarray | None = None,
    dense_off: np.ndarray | None = None,
    device: torch.device | str | None = None,
    genome: np.ndarray | None = None,
    ref_len: int | None = None,
    base_off: np.ndarray | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Smith-Waterman post-processing (reference post_process_sw_*): expand
    sparse hits, score every candidate slot by SW against the wrapped query
    (windows are ``a``, queries ``b``), keep the top k by score descending.
    There is no dense short-circuit: at stride 1 the k_clusters hits are
    reranked.

    query_mat/query_lens: wrapped query bytes + true lengths.
    genome, ref_len: the reference's bases and its windows' length; with a
      multi-record reference the concatenated records, whose stream
      positions base_off and dense_off give (io.fasta.translate_window_ids).
    fetch_windows: callable(ids [M]) -> (bytes [M, W], lens [M]) unwrapped
      candidate windows (host), in place of the genome: CPU only.
    device: where the scores run (default: the CUDA device when present).

    Given the genome, it goes to the device once, each call's id matrix and
    query rows with it, and ops.sw.sw_scores_by_id scores the pairs there:
    on the card all Q x C pairs in one call, each window read by id where
    it is scored (nothing is fetched on the host); on CPU tensors
    query_chunk reads a call, through its plain version (fetch_windows_by_id
    and the plain SW).  A fetch_windows callable is fetched and scored
    query_chunk reads at a time.

    Spans (utils.trace): post.sw.fetch (the expansion and the genome's
    upload; then for each call its ids and query rows, or the callable's
    fetch and pair layout), post.sw.score (the scoring and the download;
    on the card its attr pairs_by_id counts the pairs scored by id) and
    post.sw.sort.

    Invalid slots score INT32_MIN and sort last; the sort is stable, so
    ties keep candidate order.  Returns (final_ids [Q, k] int64,
    final_scores [Q, k] int32).
    """
    check_invariant(k, k_clusters, stride)
    if stride == 1 and k > k_clusters:
        raise ValueError(
            f"Final k={k} > k_clusters={k_clusters}: the dense SW rerank "
            "has only k_clusters candidates per query."
        )
    dev = resolve_device(device)
    if genome is None and dev.type != "cpu":
        raise ValueError("post_process_sw reads the windows by id on the card: "
                         "pass genome= and ref_len=")
    with trace.span("post.sw.fetch"):
        if stride == 1:
            cand_ids = neighbors[:, :k_clusters].astype(np.int64)
        else:
            cand_ids, _ = expand_candidates(
                neighbors, stride, bound, k_clusters, sparse_off, dense_off
            )
        if genome is not None:
            g_t = torch.from_numpy(np.ascontiguousarray(genome)).to(dev)
    q, c = cand_ids.shape
    chunk = query_chunk if dev.type == "cpu" else max(q, 1)
    out_ids = np.empty((q, k), dtype=np.int64)
    out_scores = np.empty((q, k), dtype=np.int32)
    for start in range(0, q, chunk):
        end = min(start + chunk, q)
        with trace.span("post.sw.fetch"):
            if genome is None:
                flat_ids = cand_ids[start:end].ravel()
                pairs = fetch_windows(np.where(flat_ids >= 0, flat_ids, 0)) + (
                    np.repeat(query_mat[start:end], c, axis=0),
                    np.repeat(query_lens[start:end], c, axis=0))
            else:
                ids = cand_ids[start:end]
                if base_off is not None:
                    ids = translate_window_ids(ids, dense_off, base_off)
                ids_t, q_t, ql_t = (torch.from_numpy(np.ascontiguousarray(x)).to(dev)
                                    for x in (ids, query_mat[start:end],
                                              query_lens[start:end]))
        with trace.span("post.sw.score") as score_span:
            if genome is None:
                scores = sw_scores(*(torch.from_numpy(np.ascontiguousarray(x))
                                     for x in pairs)).numpy()
            else:
                scores = sw_scores_by_id(g_t, ids_t, ref_len, q_t, ql_t).cpu().numpy()
                if dev.type != "cpu":
                    score_span.add("pairs_by_id", scores.size)
        with trace.span("post.sw.sort"):
            out_ids[start:end], out_scores[start:end] = _top_k(
                scores.reshape(end - start, c), cand_ids[start:end], k)
    return out_ids, out_scores


def _top_k(scores: np.ndarray, cand_ids: np.ndarray, k: int):
    """The k best slots of each row of scores [n, C] by score descending,
    stably; invalid slots (cand_ids < 0) score INT32_MIN and sort last.
    Returns (ids [n, k], scores [n, k])."""
    scores = np.where(cand_ids >= 0, scores, np.int32(_INT32_MIN))
    # int64 negation: -INT32_MIN does not wrap, so invalid slots sort last
    order = np.argsort(-scores.astype(np.int64), axis=1, kind="stable")[:, :k]
    return (np.take_along_axis(cand_ids, order, axis=1),
            np.take_along_axis(scores, order, axis=1))


def rerank_l2(query_emb: torch.Tensor, pool_emb: torch.Tensor,
              pool_idx: torch.Tensor, cand_ids: torch.Tensor, k: int):
    """Per-query sqrt-L2 rerank over padded candidate slots (the
    _rerank_l2_device counterpart): query_emb [Q,D], pool_emb [U,D],
    pool_idx [Q,C] (-1 invalid), cand_ids [Q,C] -> (dists [Q,k], ids [Q,k]);
    ties keep the lower slot."""
    ce = pool_emb[pool_idx.clamp(min=0).long()]  # [Q, C, D]
    diff = ce - query_emb[:, None, :]
    d = torch.sqrt(torch.sum(diff * diff, dim=-1))
    d = torch.where(pool_idx >= 0, d, torch.inf)
    vals, pos = smallest_k(d, k)
    return vals, torch.gather(cand_ids, 1, pos)


def post_process_l2(
    neighbors: np.ndarray,
    distances: np.ndarray,
    query_embeddings,
    embed_windows,
    stride: int,
    k: int,
    k_clusters: int,
    bound: int,
    force_rerank: bool = False,
    sparse_off: np.ndarray | None = None,
    dense_off: np.ndarray | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """L2 post-processing (reference post_process_l2_{static,dynamic}).

    neighbors/distances: ANN output [Q, >=k or >=k_clusters].
    query_embeddings: [Q, D] fp32, numpy or a tensor (the rerank runs on
      its device).
    embed_windows: callable(unique window ids) -> [U, D] embeddings (numpy
      or a tensor) of those windows.
    bound: dense-id validity bound.
    force_rerank: rerank even at stride == 1 (the ANN list is the
      candidate set).

    Spans (utils.trace), opened only when it reranks (past stride 1, or
    force_rerank): post.l2.expand (the expansion and the dedup; counters
    slots, the candidate slots, and windows, the unique windows
    re-embedded), then post.l2.rank (the rerank and the download).  The
    spans between them, post.l2.pack and post.l2.embed, are the
    embed_windows callable's own (search.run_pipeline's opens them).

    Returns (final_ids [Q, k] int64, final_dists [Q, k] fp32).
    """
    check_invariant(k, k_clusters, stride)
    if stride == 1 and not force_rerank:
        # Dense: passthrough of ANN ids/distances (squared L2).
        return (
            neighbors[:, :k].astype(np.int64),
            distances[:, :k].astype(np.float32),
        )
    if stride == 1 and k > neighbors.shape[1]:
        raise ValueError(
            f"Final k={k} > ANN candidate count {neighbors.shape[1]} "
            "for the dense rerank."
        )
    with trace.span("post.l2.expand") as expand_span:
        if stride == 1:
            cand_ids = neighbors.astype(np.int64)
        else:
            cand_ids, _ = expand_candidates(
                neighbors, stride, bound, k_clusters, sparse_off, dense_off
            )
        uniq, pool_idx = unique_pool(cand_ids)
        expand_span.add("slots", cand_ids.size)
        expand_span.add("windows", uniq.size)
    pool_emb = as_f32(embed_windows(uniq))
    with trace.span("post.l2.rank"):
        dev = pool_emb.device
        d, ids = rerank_l2(
            as_f32(query_embeddings, dev),
            pool_emb,
            torch.from_numpy(pool_idx).to(dev),
            torch.from_numpy(cand_ids).to(dev),
            k,
        )
        return ids.cpu().numpy().astype(np.int64), d.cpu().numpy().astype(np.float32)
