"""kNN-graph HNSW construction on the device: exact kNN by matmuls, then the
shrink heuristic for a slab of nodes at once.

Counterpart of ``deepreadmapper_tpu/index/knn_build.py`` (the reference's
second builder, the GANN-paper CPU port src/gann_hnsw/gann_hnsw.cpp:168-278,
turned into dense device work): every row's exact k nearest neighbours
come from ``ops.topk.l2_topk`` in query chunks sized by memory, the FAISS
shrink heuristic (hnsw_build._select_neighbors_heuristic) runs as one loop
over candidate rank with all nodes of a slab pruned in lockstep, reverse
edges are a host integer scatter, and a second prune caps the degree at 2M.
Upper levels reuse the same level assignment as the insert builder and the
same kNN + prune on their subsets; layers of at most 4,096 nodes run on the
host.  The output is the insert builder's HNSWGraphData, so the beam search
does not depend on the builder.

Every choice is the JAX package's: ties go to the lower id, the prune keeps
candidate j iff d(node, c_j) < d(c_j, c_s) for every kept s (strict), with
``pair = sq + sq - 2 cross``, so on integer-valued vectors the graph equals
the JAX package's exactly.  Chunk and slab sizes bound device memory and do
not change the result.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from deepreadmapper_tpu_torch import resolve_device
from deepreadmapper_tpu_torch.index.hnsw_build import (
    HNSWGraphData,
    _levels_for,
    _select_neighbors_heuristic,
)
from deepreadmapper_tpu_torch.ops.topk import as_f32, l2_topk

_BIG = 3.4e38
_TILE_ELEMS = 1 << 28  # scores a query chunk x reference tile (1 GiB fp32)
_HOST_MAX = 4096       # layers up to this many nodes are built on the host


def _on_device(vectors, device) -> torch.Tensor:
    """fp32 tensor on device: a tensor stays where it is unless device= says,
    numpy goes to device or, by default, the card."""
    if torch.is_tensor(vectors) and device is None:
        return as_f32(vectors)
    return as_f32(vectors, resolve_device(device))


def _select_smallest_k(x: torch.Tensor, k: int):
    """ops.topk.smallest_k's answer for a [rows, N] score tile against the
    whole reference, by selection: the k-th smallest value of each row
    (torch.topk's values are exact, whatever order it picks ties in), every
    column below it, then the lowest columns equal to it up to k, then a
    stable sort of those k by value.  2x a full stable sort on the card at
    1,344 x 199,702, k 49 (scripts/time_smallest_k.py, PERF.md)."""
    kth = torch.topk(x, k, dim=1, largest=False, sorted=False).values.amax(
        dim=1, keepdim=True)
    below = x < kth
    need = k - below.sum(dim=1, keepdim=True)
    eq = x == kth
    sel = below | (eq & (torch.cumsum(eq, dim=1, dtype=torch.int32) <= need))
    cols = sel.nonzero()[:, 1].view(x.shape[0], k)  # ascending within a row
    vals, pos = torch.sort(torch.gather(x, 1, cols), dim=1, stable=True)
    return vals, torch.gather(cols, 1, pos)


def exact_knn(vectors, k: int, query_chunk: int | None = None,
              ref_chunk: int = 262144, device=None):
    """Self-excluded exact kNN of every row against all rows.

    Returns (dists [N, k] squared L2 ascending, ids [N, k] int64), -1 / BIG
    padded when N-1 < k.  query_chunk defaults to as many rows as keep one
    [query_chunk, min(N, ref_chunk)] score tile at 2^28 elements.  Each
    tile selects its k before it sorts (_select_smallest_k); the chunks are
    copied to the host anyway, so its host sync costs nothing extra."""
    vj = _on_device(vectors, device)  # on the device once, never per chunk
    n = vj.shape[0]
    kq = min(k + 1, n)  # +1 so the self hit can be dropped
    if query_chunk is None:
        query_chunk = max(1, min(8192, _TILE_ELEMS // max(min(n, ref_chunk), 1)))
    out_d = np.empty((n, k), dtype=np.float32)
    out_i = np.empty((n, k), dtype=np.int64)
    for s in range(0, n, query_chunk):
        e = min(s + query_chunk, n)
        d, i = l2_topk(vj[s:e], vj, kq, chunk=ref_chunk, select=_select_smallest_k)
        d, i = d.cpu().numpy(), i.cpu().numpy()
        rows = np.arange(s, e)[:, None]
        # Drop the self column: the self hit has distance exactly 0 and wins
        # the lower-id tie-break unless an identical lower-id row exists, so
        # locate it explicitly and compact the row around it.
        self_col = np.argmax(i == rows, axis=1)
        has_self = np.take_along_axis(i == rows, self_col[:, None], axis=1)[:, 0]
        self_col = np.where(has_self, self_col, kq - 1)
        keep = np.arange(kq)[None, :] != self_col[:, None]
        d = d[keep].reshape(e - s, kq - 1)
        i = i[keep].reshape(e - s, kq - 1)
        if kq - 1 < k:
            pad = k - (kq - 1)
            d = np.pad(d, ((0, 0), (0, pad)), constant_values=np.float32(_BIG))
            i = np.pad(i, ((0, 0), (0, pad)), constant_values=-1)
        out_d[s:e] = d[:, :k]
        out_i[s:e] = i[:, :k]
    return out_d, out_i


def _prune_heuristic_device(cand_vecs: torch.Tensor, cand_d: torch.Tensor,
                            cand_valid: torch.Tensor, cap: int) -> torch.Tensor:
    """FAISS shrink heuristic for a slab of nodes at once.

    cand_vecs  [B, K, D] candidate vectors, rank-ascending by cand_d
    cand_d     [B, K]    squared L2 node -> candidate
    cand_valid [B, K]    bool
    Keep candidate j iff d(node, c_j) < d(c_j, c_s) for every already kept
    s, and fewer than cap kept so far.  Returns the keep mask [B, K]."""
    b, kk, _ = cand_vecs.shape
    sq = torch.sum(cand_vecs * cand_vecs, dim=-1)
    cross = torch.bmm(cand_vecs, cand_vecs.transpose(1, 2))
    pair = sq[:, :, None] + sq[:, None, :] - 2.0 * cross  # [B, K, K]
    keep = torch.zeros((b, kk), dtype=torch.bool, device=cand_vecs.device)
    count = torch.zeros((b,), dtype=torch.int32, device=cand_vecs.device)
    for j in range(kk):
        # least distance from candidate j to any candidate kept so far
        dj = torch.where(keep, pair[:, j, :], _BIG).amin(dim=1)
        ok = cand_valid[:, j] & (cand_d[:, j] < dj) & (count < cap)
        keep[:, j] = ok
        count += ok.to(torch.int32)
    return keep


def prune_neighbors(vectors, cand_ids: np.ndarray, cand_d: np.ndarray, cap: int,
                    slab: int | None = None, device=None) -> np.ndarray:
    """Run the device prune slab by slab; compact the kept ids to [N, cap]
    int32, -1 padded.  cand_ids rows must be distance-ascending (exact_knn
    order).  vectors: numpy (to device, by default the card) or a tensor
    (its device unless device= says)."""
    vj = _on_device(vectors, device)
    n, kk = cand_ids.shape
    if slab is None:
        # bound the [slab, K, K] pairwise tensor (+ its masked copy) to ~2 GB
        slab = max(256, min(16384, int(2e9 / max(kk * kk * 8, 1))))
    out = np.full((n, cap), -1, dtype=np.int32)
    c = min(cap, kk)
    for s in range(0, n, slab):
        e = min(s + slab, n)
        ids = cand_ids[s:e]
        ids_t = torch.from_numpy(np.ascontiguousarray(ids, np.int64)).to(vj.device)
        keep = _prune_heuristic_device(
            vj[ids_t.clamp(min=0)],
            torch.from_numpy(np.ascontiguousarray(cand_d[s:e], np.float32)).to(vj.device),
            ids_t >= 0, cap,
        ).cpu().numpy()
        # compact kept ids to the left (stable: kept entries stay rank-sorted)
        order = np.argsort(~keep, axis=1, kind="stable")
        sel = np.take_along_axis(ids, order, axis=1)[:, :c]
        nkeep = keep.sum(axis=1, keepdims=True)
        out[s:e, :c] = np.where(np.arange(c)[None, :] < nkeep, sel, -1)
    return out


def _edge_dists(v: torch.Tensor, vq: torch.Tensor, cand: torch.Tensor) -> torch.Tensor:
    """Squared L2 from each slab node to its candidate list; BIG for -1."""
    g = v[cand.clamp(min=0)]
    dd = torch.sum((g - vq[:, None, :]) ** 2, dim=2)
    return torch.where(cand >= 0, dd, _BIG)


# Copied from deepreadmapper_tpu/index/knn_build.py (host numpy; that module imports jax).
def _add_reverse_edges(fwd: np.ndarray, n: int, cap: int):
    """GANN backward-edge gather/scatter (gann_hnsw.cpp:580-659) as fully
    vectorized numpy integer work: every edge a->b contributes b->a; returns
    candidate lists [N, fwd_w + in_cap] (forward first, then incoming), -1
    padded.  Hub in-degree is capped at 4*cap — hubs are already densely
    connected and the later distance-rank+prune keeps <= cap anyway."""
    fwd_w = fwd.shape[1]
    src = np.repeat(np.arange(n, dtype=np.int64), fwd_w)
    dst = fwd.reshape(-1).astype(np.int64)
    ok = dst >= 0
    src, dst = src[ok], dst[ok]
    order = np.argsort(dst, kind="stable")
    rsrc, rdst = src[order], dst[order]
    counts = np.bincount(rdst, minlength=n)
    offs = np.concatenate([[0], np.cumsum(counts[:-1])])
    pos = np.arange(rdst.size, dtype=np.int64) - offs[rdst]
    in_cap = int(min(counts.max(initial=0), 4 * cap))
    cand = np.full((n, fwd_w + in_cap), -1, dtype=np.int64)
    cand[:, :fwd_w] = fwd
    sel = pos < in_cap
    cand[rdst[sel], fwd_w + pos[sel]] = rsrc[sel]
    return cand


# Copied from deepreadmapper_tpu/index/knn_build.py (host numpy; that module imports jax).
def _dedup_rows(cand: np.ndarray) -> np.ndarray:
    """Per-row dedup preserving first appearance; -1 padded.  Vectorized:
    sort each row by (value, position), mark non-first members of each equal
    run, scatter the mask back, then stable-compact valid entries left."""
    n, w = cand.shape
    if w == 0:
        return cand.copy()
    posk = np.arange(w, dtype=np.int64)[None, :]
    key = cand * w + posk  # value-major, position-minor; -1 stays smallest
    order = np.argsort(key, axis=1, kind="stable")
    sv = np.take_along_axis(cand, order, axis=1)
    dup_sorted = np.zeros((n, w), dtype=bool)
    dup_sorted[:, 1:] = sv[:, 1:] == sv[:, :-1]
    dup = np.zeros((n, w), dtype=bool)
    np.put_along_axis(dup, order, dup_sorted, axis=1)
    valid = (cand >= 0) & ~dup
    corder = np.argsort(~valid, axis=1, kind="stable")
    out = np.take_along_axis(np.where(valid, cand, -1), corder, axis=1)
    return out


# Copied from deepreadmapper_tpu/index/knn_build.py (host numpy; that module imports jax).
def _prune_host(v: np.ndarray, cand: np.ndarray, d: np.ndarray, cap: int):
    """Host shrink heuristic (same rule as _prune_heuristic_device)."""
    n = cand.shape[0]
    out = np.full((n, cap), -1, dtype=np.int32)
    for r in range(n):
        ok = cand[r] >= 0
        sel = _select_neighbors_heuristic(
            v, r, list(zip(d[r][ok].tolist(), cand[r][ok].tolist())), cap
        )
        out[r, : len(sel)] = sel
    return out


# Copied from deepreadmapper_tpu/index/knn_build.py (host numpy; that module imports jax).
def _knn_layer_host(v: np.ndarray, m: int, cap: int, k_cand: int) -> np.ndarray:
    """Tiny layers (upper HNSW levels) run entirely on the host."""
    n = v.shape[0]
    # x2+y2-2xy form: the [n,n,D] broadcast difference would transiently
    # allocate up to ~8.6 GB at the n=4096 cutoff for a 67 MB result.
    sq = (v * v).sum(axis=1)
    d2 = (sq[:, None] + sq[None, :] - 2.0 * (v @ v.T)).astype(np.float32)
    np.fill_diagonal(d2, np.inf)
    k = min(k_cand, n - 1)
    ki = np.argsort(d2, axis=1, kind="stable")[:, :k]
    kd = np.take_along_axis(d2, ki, axis=1)
    fwd = _prune_host(v, ki.astype(np.int64), kd, m)
    cand = _dedup_rows(_add_reverse_edges(fwd, n, cap))
    dc = np.where(
        cand >= 0,
        np.take_along_axis(d2, np.maximum(cand, 0), axis=1),
        np.float32(np.inf),
    )
    order = np.argsort(dc, axis=1, kind="stable")
    cand = np.take_along_axis(cand, order, axis=1)
    dc = np.take_along_axis(dc, order, axis=1)
    return _prune_host(v, cand, dc, cap)


def _knn_layer(vj: torch.Tensor, m: int, cap: int, k_cand: int,
               timings: dict | None = None) -> np.ndarray:
    """One graph layer: exact kNN -> heuristic prune to m forward edges ->
    reverse edges -> rank by distance -> prune to cap.  Returns [N, cap].
    timings, when a dict, gets the seconds of exact_knn, prune (both
    prunes) and reverse_rank."""
    n = vj.shape[0]
    if n <= 1:
        return np.full((n, cap), -1, dtype=np.int32)
    if n <= _HOST_MAX:
        return _knn_layer_host(vj.cpu().numpy(), m, cap, k_cand)
    t = timings if timings is not None else {}
    t0 = time.perf_counter()
    kd, ki = exact_knn(vj, min(k_cand, n - 1))
    t1 = time.perf_counter()
    fwd = prune_neighbors(vj, ki, kd, m)
    t2 = time.perf_counter()
    cand = _dedup_rows(_add_reverse_edges(fwd, n, cap))
    # distance-rank the merged candidate lists slab-wise on the device
    width = cand.shape[1]
    d = np.empty((n, width), dtype=np.float32)
    slab = 16384
    for s in range(0, n, slab):
        e = min(s + slab, n)
        cp = torch.from_numpy(cand[s:e]).to(vj.device)
        d[s:e] = _edge_dists(vj, vj[s:e], cp).cpu().numpy()
    order = np.argsort(d, axis=1, kind="stable")
    cand = np.take_along_axis(cand, order, axis=1)
    d = np.take_along_axis(d, order, axis=1)
    t3 = time.perf_counter()
    # Hub nodes can have huge in-degree; the heuristic keeps <= cap diverse
    # neighbours and essentially never reaches past the nearest few*cap, so
    # bound the pairwise-prune width.
    w = min(cand.shape[1], max(4 * cap, k_cand))
    out = prune_neighbors(vj, cand[:, :w], d[:, :w], cap)
    t4 = time.perf_counter()
    for key, sec in (("exact_knn", t1 - t0), ("prune", t2 - t1 + t4 - t3),
                     ("reverse_rank", t3 - t2)):
        t[key] = t.get(key, 0.0) + sec
    return out


def build_hnsw_knn(vectors, m: int = 16, seed: int = 5489, k_cand: int | None = None,
                   level_mode: str = "rng", device=None,
                   timings: dict | None = None) -> HNSWGraphData:
    """kNN-graph HNSW construction (GANN-equivalent) on ``device`` (default:
    where a tensor is, else the card).

    Produces the same HNSWGraphData layout as hnsw_build.build_hnsw, so the
    batched beam search does not depend on the builder.  k_cand (default
    3M) is the kNN width fed to the pruning heuristic.  timings, when a
    dict, gets the seconds of the level assignment (levels), the level-0
    split (exact_knn, prune, reverse_rank) and upper_levels."""
    host = np.ascontiguousarray(
        vectors.cpu().numpy() if torch.is_tensor(vectors) else vectors, dtype=np.float32)
    vd = _on_device(vectors, device)
    n = vd.shape[0]
    if k_cand is None:
        k_cand = 3 * m
    t0 = time.perf_counter()
    levels = _levels_for(host, m, seed, level_mode)
    max_level = int(levels.max(initial=0))
    if timings is not None:
        timings["levels"] = time.perf_counter() - t0

    neighbors0 = _knn_layer(vd, m, 2 * m, k_cand, timings)

    t0 = time.perf_counter()
    level_gids: list[np.ndarray] = []
    level_nbrs: list[np.ndarray] = []
    for lvl in range(1, max_level + 1):
        gids = np.flatnonzero(levels >= lvl).astype(np.int64)
        nb = _knn_layer(vd[torch.from_numpy(gids).to(vd.device)], m, m,
                        min(k_cand, max(int(gids.size) - 1, 1)))
        level_gids.append(gids)
        level_nbrs.append(nb.astype(np.int32))  # already row indices in-level
    if timings is not None:
        timings["upper_levels"] = time.perf_counter() - t0
    # entry point: deepest node, lowest id on ties (hnsw_build puts the last
    # inserted deepest node at entry; any top-level node is a valid entry)
    if max_level >= 1:
        entry = int(level_gids[-1][0])
    else:
        entry = 0 if n else -1
    return HNSWGraphData(
        neighbors0=neighbors0.astype(np.int32),
        level_gids=level_gids,
        level_nbrs=level_nbrs,
        entry_gid=entry,
        max_level=max_level,
        m=m,
    )
