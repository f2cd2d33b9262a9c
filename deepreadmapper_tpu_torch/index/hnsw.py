"""HNSW index with a batched beam search on the device (HNSWPQ, HNSWFLAT).

Counterpart of ``deepreadmapper_tpu/index/hnsw.py``, byte-compatible on
disk (``hnsw.npz``: the graph, and the PQ codes + centroids or the fp32
vectors).  The reference's engine is FAISS IndexHNSWPQ, one query at a time
on a CPU thread; here the per-query loop is vectorized ACROSS a batch of
queries, as in the JAX package:

  * upper levels: greedy descent, all queries stepping in lockstep for a
    fixed ``descent_steps`` per level (gather neighbour rows -> distances ->
    move where closer);
  * level 0: a fixed-``ef`` beam.  Each of ``iters`` steps expands every
    query's best unexpanded slot, gathers its 2M neighbours, scores them
    (fp32 L2 or ADC), masks the ones already in the beam, and merges beam
    and neighbours by a stable smallest-ef selection.  No early exit: every
    query does the same work, so the effort counters follow from the shapes.

Ties are broken as the JAX package breaks them: ``argmin`` takes the first
minimum, and the merge keeps the lower position (beam before neighbours),
which ``ops.topk.smallest_k`` (a stable sort) does and ``torch.topk`` does
not promise.  Graph construction runs on the host (``hnsw_build``, the
native insert builder) or as the kNN builder on the device (``knn_build``).
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from deepreadmapper_tpu_torch import resolve_device
from deepreadmapper_tpu_torch.config import BuildConfig
from deepreadmapper_tpu_torch.index.hnsw_build import HNSWGraphData, build_hnsw
from deepreadmapper_tpu_torch.index.registry import register_index
from deepreadmapper_tpu_torch.ops import pq as pq_ops
from deepreadmapper_tpu_torch.ops.topk import as_f32, smallest_k

_INF = float("inf")


def _make_dist_fn(mode: str, storage: torch.Tensor, qdata: torch.Tensor):
    """Returns dist(ids [Q, W] int64) -> [Q, W] fp32 (ids valid/clamped)."""
    if mode == "flat":
        vectors, q = storage, qdata  # [N, D], [Q, D]

        def dist(ids):
            diff = vectors[ids] - q[:, None, :]  # [Q, W, D]
            return torch.sum(diff * diff, dim=-1)

    else:  # "pq"
        codes, tables = storage, qdata  # [N, m] uint8, [Q, m, ksub]
        qn, m = tables.shape[0], tables.shape[1]
        qi = torch.arange(qn, device=tables.device)[:, None, None]
        mi = torch.arange(m, device=tables.device)[None, None, :]

        def dist(ids):
            c = codes[ids].long()  # [Q, W, m]
            return torch.sum(tables[qi, mi, c], dim=-1)  # t[q, w, j] = tables[q, j, c]

    return dist


def _pick(x: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
    """x[q, j[q]] for each row q."""
    return torch.gather(x, 1, j[:, None])[:, 0]


def hnsw_search_device(
    neigh0: torch.Tensor,
    levels: tuple,  # of (gids [nl] int64 ascending, nbr_rows [nl, M] int32)
    entry_gid: int,
    storage: torch.Tensor,
    qdata: torch.Tensor,
    *,
    ef: int,
    iters: int,
    k: int,
    mode: str,
    descent_steps: int = 16,
):
    """The batched HNSW search on the device of its tensors; returns
    (dists [Q, k] fp32, ids [Q, k] int64, -1 where the beam is short).
    Counterpart of the JAX hnsw_search_device, step for step."""
    dev = qdata.device
    qn = qdata.shape[0]
    dist = _make_dist_fn(mode, storage, qdata)

    # ---- upper-level greedy descent (lockstep across the batch) ----
    cur_gid = torch.full((qn,), int(entry_gid), dtype=torch.int64, device=dev)
    cur_d = dist(cur_gid[:, None])[:, 0]
    for gids, nbr_rows in reversed(levels):  # highest level first
        # the entry is the max-level node, so it exists on every level
        rows = torch.searchsorted(gids, cur_gid).clamp_(0, gids.shape[0] - 1)
        for _ in range(descent_steps):
            nr = nbr_rows[rows].long()  # [Q, M]
            ng = gids[nr.clamp(min=0)]
            nd = torch.where(nr >= 0, dist(ng), _INF)
            bi = torch.argmin(nd, dim=1)  # the first minimum, as jnp.argmin
            bd = _pick(nd, bi)
            move = bd < cur_d
            cur_gid = torch.where(move, _pick(ng, bi), cur_gid)
            rows = torch.where(move, _pick(nr, bi), rows)
            cur_d = torch.minimum(bd, cur_d)

    # ---- level-0 batched beam search ----
    ar = torch.arange(qn, device=dev)
    beam_ids = torch.full((qn, ef), -1, dtype=torch.int64, device=dev)
    beam_ids[:, 0] = cur_gid
    beam_d = torch.full((qn, ef), _INF, dtype=torch.float32, device=dev)
    beam_d[:, 0] = cur_d
    expanded = torch.zeros((qn, ef), dtype=torch.bool, device=dev)
    no_exp = torch.zeros((qn, neigh0.shape[1]), dtype=torch.bool, device=dev)
    for _ in range(iters):
        frontier_d = torch.where(expanded | (beam_ids < 0), _INF, beam_d)
        j = torch.argmin(frontier_d, dim=1)
        has_frontier = _pick(frontier_d, j) < _INF
        expanded[ar, j] = True
        node = _pick(beam_ids, j)
        nbrs = neigh0[node.clamp(min=0)].long()  # [Q, 2M]
        valid = (nbrs >= 0) & has_frontier[:, None]
        ng = nbrs.clamp(min=0)
        nd = torch.where(valid, dist(ng), _INF)
        dup = (ng[:, :, None] == beam_ids[:, None, :]).any(dim=2)
        nd = nd.masked_fill(dup, _INF)
        cat_d = torch.cat([beam_d, nd], dim=1)
        cat_i = torch.cat([beam_ids, torch.where(nd < _INF, ng, -1)], dim=1)
        cat_e = torch.cat([expanded, no_exp], dim=1)
        # lax.top_k(-cat_d, ef): ascending, the lower position on ties
        beam_d, pos = smallest_k(cat_d, ef)
        beam_ids = torch.gather(cat_i, 1, pos)
        expanded = torch.gather(cat_e, 1, pos)
    return beam_d[:, :k], beam_ids[:, :k]


@register_index("HNSWPQ")
class HNSWPQIndex:
    """HNSW graph + PQ codes, ADC search (FAISS IndexHNSWPQ equivalent)."""

    storage_mode = "pq"
    _Q_BATCH = 8192  # queries a device batch: [Q, 2M, D] gathers, [Q, 2M, ef] masks

    def __init__(self, graph: HNSWGraphData, codes, codebook, vectors, ntotal: int,
                 device: torch.device | str | None = None):
        self.graph = graph
        self.codes = codes          # [N, m] uint8 (pq) or None
        self.codebook = codebook    # PQCodebook (pq) or None
        self.vectors = vectors      # [N, D] fp32 (flat) or None
        self.ntotal = ntotal
        self.device = resolve_device(device)
        self._dev = None

    @classmethod
    def build(cls, embeddings, cfg: BuildConfig | None = None, device=None,
              timings: dict | None = None):
        """Graph (cfg.build_mode: the native insert builder on the host, or
        the kNN builder on the device; cfg.level_mode), then for HNSWPQ the
        PQ codebook on the half sample and the codes.  timings, when a dict,
        gets the seconds of the graph build and of the kNN build's parts."""
        cfg = cfg or BuildConfig()
        dev = resolve_device(device)
        t = timings if timings is not None else {}
        vecs = np.ascontiguousarray(
            embeddings.cpu().numpy() if torch.is_tensor(embeddings) else embeddings,
            dtype=np.float32)
        t0 = time.perf_counter()
        if cfg.build_mode == "knn":
            from deepreadmapper_tpu_torch.index.knn_build import build_hnsw_knn

            graph = build_hnsw_knn(vecs, m=cfg.m_hnsw, seed=cfg.seed,
                                   level_mode=cfg.level_mode, device=dev, timings=t)
        elif cfg.build_mode == "insert":
            graph = build_hnsw(vecs, m=cfg.m_hnsw, efc=cfg.efc, seed=cfg.seed,
                               level_mode=cfg.level_mode)
        else:
            raise ValueError(f"build_mode must be 'insert' or 'knn', got {cfg.build_mode!r}")
        t["graph"] = time.perf_counter() - t0
        if cls.storage_mode == "pq":
            t0 = time.perf_counter()
            train = pq_ops.sample_training_set(vecs, cfg.sample_rate)
            cb = pq_ops.train_pq(train, m=cfg.m_pq, nbits=cfg.nbits,
                                 iters=cfg.kmeans_iters, seed=cfg.seed, device=dev)
            codes = pq_ops.encode_pq(vecs, cb)
            t["pq"] = time.perf_counter() - t0
            return cls(graph, codes, cb, None, vecs.shape[0], dev)
        return cls(graph, None, None, vecs, vecs.shape[0], dev)

    def _device(self):
        """(neighbors0, levels, storage) on the device, uploaded once."""
        if self._dev is None:
            g, dev = self.graph, self.device
            levels = tuple(
                (torch.from_numpy(np.asarray(gids, np.int64)).to(dev),
                 torch.from_numpy(np.asarray(nbrs, np.int32)).to(dev))
                for gids, nbrs in zip(g.level_gids, g.level_nbrs))
            store = self.codes if self.storage_mode == "pq" else self.vectors
            self._dev = (torch.from_numpy(np.asarray(g.neighbors0, np.int32)).to(dev),
                         levels, torch.from_numpy(np.ascontiguousarray(store)).to(dev))
        return self._dev

    def search(self, queries, k: int, ef: int = 128, stats: dict | None = None):
        """-> (ids [Q, k] int64, -1 padded; squared distances [Q, k] fp32,
        inf where the id is -1).  stats, when a dict, is filled with the
        JAX package's SEARCH-EFFORT counters: the beam does fixed work per
        query (ef expansions of 2M slots plus the level descent), so they
        follow from the graph's shape."""
        neigh0, levels, storage = self._device()
        ef = max(ef, k)
        if stats is not None:
            g = self.graph
            upper = sum(lg.shape[0] for lg in g.level_gids)
            stats["queries"] = stats.get("queries", 0) + len(queries)
            stats["beam_expansions_per_query"] = ef
            stats["neighbor_slots_scored_per_query"] = ef * 2 * g.m
            stats["descent_levels"] = g.max_level
            stats["graph_degree"] = 2 * g.m
            stats["upper_level_nodes"] = upper
            stats["ntotal"] = self.ntotal
            stats["coverage"] = round(ef * 2 * g.m / max(self.ntotal, 1), 6)
        q_all = as_f32(queries, self.device)
        kk = min(k, ef)
        ds, ids = [], []
        for s in range(0, q_all.shape[0], self._Q_BATCH):
            q = q_all[s : s + self._Q_BATCH]
            qdata = (pq_ops.adc_tables(q, self.codebook.centroids)
                     if self.storage_mode == "pq" else q)
            d, i = hnsw_search_device(neigh0, levels, self.graph.entry_gid, storage,
                                      qdata, ef=ef, iters=ef, k=kk,
                                      mode=self.storage_mode)
            ds.append(d.cpu())
            ids.append(i.cpu())
        if ds:
            i = torch.cat(ids).numpy().astype(np.int64)
            d = torch.cat(ds).numpy().astype(np.float32)
        else:
            i = np.zeros((0, kk), np.int64)
            d = np.zeros((0, kk), np.float32)
        d[i < 0] = np.inf
        if k > i.shape[1]:
            i = np.pad(i, ((0, 0), (0, k - i.shape[1])), constant_values=-1)
            d = np.pad(d, ((0, 0), (0, k - d.shape[1])), constant_values=np.inf)
        return i, d

    # -- persistence: the JAX package's hnsw.npz keys --
    def save(self, index_prefix: str) -> None:
        os.makedirs(index_prefix, exist_ok=True)
        g = self.graph
        payload = {
            "neighbors0": g.neighbors0,
            "entry_gid": g.entry_gid,
            "max_level": g.max_level,
            "m": g.m,
            "ntotal": self.ntotal,
            "n_levels": len(g.level_gids),
        }
        for lvl, (gids, nbrs) in enumerate(zip(g.level_gids, g.level_nbrs)):
            payload[f"gids_{lvl}"] = gids
            payload[f"nbrs_{lvl}"] = nbrs
        if self.storage_mode == "pq":
            payload["codes"] = self.codes
            payload["centroids"] = self.codebook.centroids.cpu().numpy()
        else:
            payload["vectors"] = self.vectors
        np.savez(os.path.join(index_prefix, "hnsw.npz"), **payload)

    @classmethod
    def load(cls, index_prefix: str, config: dict | None = None, device=None):
        dev = resolve_device(device)
        z = np.load(os.path.join(index_prefix, "hnsw.npz"))
        n_levels = int(z["n_levels"])
        graph = HNSWGraphData(
            neighbors0=z["neighbors0"],
            level_gids=[z[f"gids_{lvl}"] for lvl in range(n_levels)],
            level_nbrs=[z[f"nbrs_{lvl}"] for lvl in range(n_levels)],
            entry_gid=int(z["entry_gid"]),
            max_level=int(z["max_level"]),
            m=int(z["m"]),
        )
        if cls.storage_mode == "pq":
            cb = pq_ops.PQCodebook(torch.from_numpy(z["centroids"]).to(dev))
            return cls(graph, z["codes"], cb, None, int(z["ntotal"]), dev)
        return cls(graph, None, None, z["vectors"], int(z["ntotal"]), dev)


@register_index("HNSWFLAT")
class HNSWFlatIndex(HNSWPQIndex):
    """HNSW graph over exact fp32 vectors (IndexHNSWFlat equivalent)."""

    storage_mode = "flat"
