"""IVF-pruned int8 scan (IVFINT8): k-means coarse quantizer + slab-major
int8 codes, scanned chunk by chunk on the probed slabs.

Counterpart of ``deepreadmapper_tpu/index/ivf_int8.py``, byte-compatible on
disk (``ivf_int8.npz``).  Build: coarse k-means (15 Lloyd iterations) on an
evenly spaced sample, nearest-centroid assignment of every row, recursive
2-means splits of clusters above the slab capacity, first-fit-decreasing
bin packing into slabs (numpy, copied from the JAX package with its rng).
Search (``ef`` = nprobe): score the queries against the centroids, keep the
top nprobe clusters, map them to slabs (a slab probed twice by one query
is scanned once), invert the (query, slab) pairs into VISITS of QTK queries
x one slab, expand each visit into its slab's chunk STEPS, and run the
chunked scan of ``ops/ivf_kernel``:

- serve-size batches (q * nprobe <= _FUSED_MAX_PAIRS) plan on the device
  (``device_plan_chunked``) and merge the packed per-visit states;
- larger batches plan on the host (``_build_plan_chunked``) and, from
  _FOLD_MIN_Q queries on with k <= FS*KP, fold into a per-query
  accumulator instead;
- ``exact=True`` scores every probed slab in full and keeps an exact
  per-visit top-kp (plain torch, no kernel): the parity escape from the
  scan's windowed top-2.

Scores are the int8 scan's, ``r^2 qn + rn - 2r q8.r8`` with r = sq/sc,
exact integers carried in fp32.  The probe's top-k is exact and stable
(the JAX package takes approx_max_k on a TPU from nlist 2048 on).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from deepreadmapper_tpu_torch import resolve_device
from deepreadmapper_tpu_torch.config import BuildConfig
from deepreadmapper_tpu_torch.index.int8_flat import quantize_host, query_scale_ratio
from deepreadmapper_tpu_torch.index.registry import register_index
from deepreadmapper_tpu_torch.ops import ivf_kernel as ik
from deepreadmapper_tpu_torch.ops.scan_kernel import fused_score
from deepreadmapper_tpu_torch.ops.topk import as_f32, smallest_k

_BIGF = np.float32(3.4e38)


# Copied from deepreadmapper_tpu/index/ivf_int8.py (that module imports jax).
def auto_nlist(n: int) -> int:
    """~sqrt(N) clusters, power of two, clamped to [16, 8192]."""
    if n <= 0:
        return 16
    return int(min(8192, max(16, 1 << int(round(np.log2(max(np.sqrt(n), 2)))))))


def _kmeans_coarse(data: torch.Tensor, init: torch.Tensor, nlist: int, iters: int,
                   chunk: int = 16384) -> torch.Tensor:
    """Lloyd iterations for the coarse quantizer (fp32, scaled-int8 domain),
    the assignment chunked so [chunk, nlist] distances stay bounded.  The
    update sums through a one-hot matmul, as the JAX package does: unlike a
    scatter-add (atomics on CUDA) it is deterministic.  fp32 matmuls run in
    full fp32 on the card (torch.backends.cuda.matmul.allow_tf32 is False,
    PyTorch's default, and the port never sets it)."""
    cent = init
    n = data.shape[0]
    for _ in range(iters):
        cn = torch.sum(cent * cent, dim=-1)
        sums = torch.zeros_like(cent)
        counts = torch.zeros((nlist,), dtype=torch.float32, device=data.device)
        for s in range(0, n, chunk):
            dc = data[s:s + chunk]
            d2 = torch.sum(dc * dc, dim=-1, keepdim=True) - 2.0 * (dc @ cent.T) + cn[None, :]
            a = torch.argmin(d2, dim=-1)
            del d2
            oh = torch.zeros((dc.shape[0], nlist), dtype=torch.float32, device=data.device)
            oh.scatter_(1, a[:, None], 1.0)
            sums += oh.T @ dc
            counts += oh.sum(dim=0)
            del oh
        new = sums / torch.clamp(counts[:, None], min=1.0)
        cent = torch.where(counts[:, None] > 0, new, cent)
    return cent


def _assign_nearest(codes8: np.ndarray, cent: torch.Tensor, chunk: int = 65536) -> np.ndarray:
    """Nearest centroid of every int8 row (fp32 distances without the row
    norm, lowest centroid on ties) -> ids [N] int32 on the host.  The
    matmul runs in full fp32 on the card too: the port leaves
    torch.backends.cuda.matmul.allow_tf32 at its default, False."""
    cn = torch.sum(cent * cent, dim=-1)
    out = np.empty(codes8.shape[0], np.int32)
    for s in range(0, codes8.shape[0], chunk):
        r = torch.from_numpy(np.ascontiguousarray(codes8[s:s + chunk])).to(cent.device)
        d2 = cn[None, :] - 2.0 * (r.to(torch.float32) @ cent.T)
        out[s:s + r.shape[0]] = torch.argmin(d2, dim=-1).to(torch.int32).cpu().numpy()
    return out


# Copied from deepreadmapper_tpu/index/ivf_int8.py (that module imports jax).
def _two_means(sub: np.ndarray, rng, iters: int = 8):
    """Host 2-means on one oversized cluster's fp32 rows; returns (side_b
    mask, mean_a, mean_b).  Lloyd iterations run on a <=16k-row SUBSAMPLE
    (the split boundary needs two rough centroids, not converged ones —
    at the 500M-row tier full-cluster iterations made splitting the
    longest build phase), then ONE full assignment pass splits every row.
    Falls back to an arbitrary halving when the rows are (near-)identical
    — planted repeats — which 2-means cannot split."""
    n = sub.shape[0]
    step = max(1, n // 16384)
    samp = sub[::step]
    ns = samp.shape[0]
    ca, cb = samp[rng.integers(ns)], samp[rng.integers(ns)]
    for _ in range(iters):
        da = ((samp - ca) ** 2).sum(1)
        db = ((samp - cb) ** 2).sum(1)
        nb = db < da
        if nb.all() or (~nb).all():
            break
        ca = samp[~nb].mean(0)
        cb = samp[nb].mean(0)
    b = ((sub - cb) ** 2).sum(1) < ((sub - ca) ** 2).sum(1)
    if b.all() or (~b).all():
        b = np.zeros(n, bool)
        b[n // 2:] = True
    ca = sub[~b].mean(0)
    cb = sub[b].mean(0)
    return b, ca, cb


# Copied from deepreadmapper_tpu/index/ivf_int8.py (that module imports jax).
def _split_and_pack(codes: np.ndarray, assign: np.ndarray, cent0: np.ndarray,
                    cap: int, seed: int, fetch=None):
    """Recursively split oversized clusters, then bin-pack clusters into
    fixed-capacity slabs (first-fit decreasing).

    fetch(rows) -> fp32 vectors for the 2-means split; defaults to reading
    `codes` rows directly (IVFPQ passes a PQ-reconstruction callback so
    only oversized clusters ever materialize as vectors).

    Returns (row_order_per_slot, slot_per_row omitted), concretely:
    clusters as (rows, centroid) in pack order, slab_of [C] int32, n_slabs.
    """
    if fetch is None:
        fetch = lambda rows: codes[rows].astype(np.float32)  # noqa: E731
    nlist0 = cent0.shape[0]
    order = np.argsort(assign, kind="stable")
    counts = np.bincount(assign, minlength=nlist0)
    bounds = np.concatenate([[0], np.cumsum(counts)])
    rng = np.random.default_rng(seed)
    stack = [
        (order[bounds[c]:bounds[c + 1]], cent0[c], None)
        for c in range(nlist0)
        if counts[c] > 0
    ]
    clusters = []
    # vectors are fetched ONCE per oversized root and sliced down the
    # recursion (re-fetching per level dominated genome-scale builds);
    # degenerate giants (>4M rows) halve by id order first — adjacent row
    # ids are shifted windows of one locus, so the halves stay coherent
    # and the fetch stays bounded
    _FETCH_CAP = 4_000_000
    while stack:
        rows, cc, vecs = stack.pop()
        if len(rows) <= cap:
            clusters.append((rows, cc))
            continue
        if vecs is None and len(rows) > _FETCH_CAP:
            h = len(rows) // 2
            stack.append((rows[:h], cc, None))
            stack.append((rows[h:], cc, None))
            continue
        if vecs is None:
            vecs = fetch(rows)
        b, ca, cb = _two_means(vecs, rng)
        stack.append((rows[~b], ca, vecs[~b]))
        stack.append((rows[b], cb, vecs[b]))
        del vecs

    # first-fit decreasing: vectorized first-slab-with-room lookup per
    # cluster keeps this O(C) numpy calls, not O(C*S) python loops
    clusters.sort(key=lambda rc: -len(rc[0]))
    sizes = np.array([len(rc[0]) for rc in clusters], np.int64)
    n_slabs_hint = int(-(-sizes.sum() // cap)) + 1
    free = np.full(n_slabs_hint, cap, np.int64)
    slab_of = np.empty(len(clusters), np.int32)
    hi = 0  # slabs opened so far
    for ci, sz in enumerate(sizes):
        fits = np.nonzero(free[: hi + 1] >= sz)[0]
        si = int(fits[0]) if fits.size else hi
        if si >= hi:
            hi = si + 1
            if hi > free.size:
                free = np.concatenate([free, np.full(hi, cap, np.int64)])
        free[si] -= sz
        slab_of[ci] = si
    return clusters, slab_of, hi


def ivf_cap(n: int, nlist: int) -> int:
    """Slab capacity: 1.25x the mean cluster, rounded up to KP so the
    strided-window selection tiles exactly (ivf_int8.py:440-443)."""
    return max(-(-int(np.ceil(n / nlist * 1.25)) // 128) * 128, 128)


def coarse_centroids(sample: np.ndarray, nlist: int, seed: int,
                     device: torch.device) -> np.ndarray:
    """k-means init (evenly spaced sample rows + 1e-3 seeded jitter) and 15
    Lloyd iterations on the device -> centroids [nlist, d] fp32 (host)."""
    d = sample.shape[1]
    idx = (np.arange(nlist) * (sample.shape[0] / nlist)).astype(np.int64)
    rng = np.random.default_rng(seed)
    init = sample[idx] + rng.standard_normal((nlist, d)).astype(np.float32) * 1e-3
    cent = _kmeans_coarse(as_f32(sample, device), as_f32(init, device), nlist, 15)
    return cent.cpu().numpy()


def lay_out(clusters, slab_of, n_slabs: int, cap: int, codes: np.ndarray):
    """Clusters in pack order -> (centroids [C, d] fp32, slab-major codes
    [(n_slabs+1)*cap, ...], row_ids [(n_slabs+1)*cap] int64, -1 = empty)."""
    cent = np.stack([cc for _rows, cc in clusters]).astype(np.float32)
    codes_cm = np.zeros(((n_slabs + 1) * cap,) + codes.shape[1:], codes.dtype)
    row_ids = np.full((n_slabs + 1) * cap, -1, np.int64)
    used = np.zeros(n_slabs, np.int64)
    for ci, (rows, _cc) in enumerate(clusters):
        si = slab_of[ci]
        base = si * cap + used[si]
        codes_cm[base:base + len(rows)] = codes[rows]
        row_ids[base:base + len(rows)] = rows
        used[si] += len(rows)
    return cent, codes_cm, row_ids


# Copied from deepreadmapper_tpu/index/ivf_int8.py (that module imports jax).
def _pad_bucket(n: int) -> int:
    """Geometric to 1024, then 1024-multiples — bounds compile signatures
    (remote AOT compiles cost tens of seconds each) at <10% pad waste."""
    p = 64
    while p < n and p < 1024:
        p *= 2
    if p < n:
        p = -(-n // 1024) * 1024
    return p


def device_plan_chunked(slabs: torch.Tensor, qtile: int, dump_slab: int,
                        nch_dev: torch.Tensor, cbase_dev: torch.Tensor,
                        s_static: int):
    """The host plan re-expressed in tensor ops on the device (JAX
    ``device_plan_chunked``): slab dedup per query (a duplicate goes to the
    dump slab), (query, slab) pairs sorted stably by slab, tiled into visits
    of qtile, each visit expanded to its slab's chunk steps.  s_static
    bounds the step count; tail steps scan the dump chunk as visit n.

    slabs [Q, nprobe] int -> (step_chunk [s_static] int32, step_visit
    [s_static+1] int32 (-1 sentinel), qidx [n+1, qtile] int32 (dump row Q),
    slot_of [Q, nprobe] int32)."""
    dev = slabs.device
    q, nprobe = slabs.shape
    n = q * nprobe
    slabs = slabs.long()
    srt = torch.sort(slabs, dim=1).values
    dup_srt = torch.cat([torch.zeros((q, 1), dtype=torch.bool, device=dev),
                         srt[:, 1:] == srt[:, :-1]], dim=1)
    rank = torch.argsort(slabs, dim=1, stable=True)
    dup = torch.zeros_like(dup_srt).scatter(1, rank, dup_srt)
    slabs = torch.where(dup, torch.full_like(slabs, dump_slab), slabs)

    flat = slabs.reshape(-1)
    qs = torch.arange(q, dtype=torch.long, device=dev).repeat_interleave(nprobe)
    order = torch.argsort(flat, stable=True)
    cs = flat[order]
    qq = qs[order]
    idx = torch.arange(n, dtype=torch.long, device=dev)
    new_slab = torch.cat([torch.ones(1, dtype=torch.bool, device=dev), cs[1:] != cs[:-1]])
    seg_start = torch.cummax(torch.where(new_slab, idx, torch.zeros_like(idx)), 0).values
    r = idx - seg_start
    new_visit = new_slab | (r % qtile == 0)
    visit_id = torch.cumsum(new_visit.long(), 0) - 1
    slot = visit_id * qtile + r % qtile
    qidx = torch.full(((n + 1) * qtile,), q, dtype=torch.long, device=dev).scatter(0, slot, qq)
    slot_of = torch.zeros(n, dtype=torch.long, device=dev).scatter(0, order, slot)
    # visit -> slab: every pair of a visit scatters the same slab
    visit_slab = torch.full((n,), dump_slab, dtype=torch.long, device=dev).scatter(
        0, visit_id, cs)
    n_real_v = visit_id[n - 1] + 1
    visit_slab = torch.where(idx < n_real_v, visit_slab, torch.full_like(visit_slab, dump_slab))
    nch_v = nch_dev.long()[visit_slab]
    offs = torch.cumsum(nch_v, 0)
    total = offs[n_real_v - 1]
    starts = offs - nch_v
    sidx = torch.arange(s_static, dtype=torch.long, device=dev)
    mark = torch.zeros(s_static, dtype=torch.long, device=dev).scatter_reduce(
        0, torch.clamp(starts, max=s_static - 1), idx + 1, "amax")
    sv0 = torch.clamp(torch.cummax(mark, 0).values - 1, min=0)
    in_range = sidx < total
    dump_chunk = cbase_dev.long()[dump_slab]
    step_visit = torch.where(in_range, sv0, torch.full_like(sv0, n))
    step_chunk = torch.where(in_range, cbase_dev.long()[visit_slab[sv0]] + (sidx - starts[sv0]),
                             dump_chunk)
    step_visit = torch.cat([step_visit, torch.full((1,), -1, dtype=torch.long, device=dev)])
    return (step_chunk.to(torch.int32), step_visit.to(torch.int32),
            qidx.reshape(n + 1, qtile).to(torch.int32), slot_of.reshape(q, nprobe).to(torch.int32))


def drop_pad_steps(plan):
    """The plan without its tail of padding steps.  They all belong to one
    pad visit that no slot references and scan the all-empty dump chunk, so
    they change nothing a merge reads.  The TPU's grid streams past them;
    on the card the visit's one block walks them in turn (a 256-read fused
    search at 40M rows spent 466 ms of its kernel there before they were
    cut).  step_visit ascends, the pad visit last."""
    step_chunk, step_visit, qidx, slot_of = plan
    last = int(slot_of.max()) // ik.QTK   # the last visit a slot references
    n = int((step_visit[:-1] <= last).sum())
    return step_chunk[:n], torch.cat([step_visit[:n], step_visit[-1:]]), qidx, slot_of


@register_index("IVFINT8")
class IVFInt8Index:
    """Cluster-pruned int8 scan (sub-linear; ``ef`` acts as nprobe)."""

    # the JAX package's route thresholds, kept until the card is measured
    # at other values: fused device plan up to this many (query, probe)
    # pairs; fold accumulator from this many queries on (k <= FS*KP)
    _FUSED_MAX_PAIRS = 8192
    _FOLD_MIN_Q = 4096
    _Q_BATCH = 8192
    _EXACT_VISITS = 64  # visits per batch of the exact path's [v, QTK, rows] scores

    def __init__(self, codes_cm, centroids, row_ids, slab_of, scale, ntotal, cap,
                 n_slabs, device: torch.device | str | None = None):
        self.codes_cm = codes_cm        # [(n_slabs+1)*cap, D] int8 (host)
        self.centroids = centroids      # [C, D] fp32 (scaled domain)
        self.row_ids = row_ids          # [(n_slabs+1)*cap] int64, -1 = empty
        self.slab_of = slab_of          # [C] int32: cluster -> slab
        self.scale = float(scale)
        self.ntotal = int(ntotal)
        self.cap = int(cap)
        self.n_slabs = int(n_slabs)     # excludes the trailing empty slab
        self.nlist = centroids.shape[0]
        self.device = resolve_device(device)
        self._dev = None
        self._rowmap = None             # chunk-space -> original row ids
        self._slabfill = None
        self._chunkmeta = None

    # ------------------------------------------------------------- build

    @classmethod
    def build(cls, embeddings, cfg: BuildConfig | None = None, device=None):
        x = np.asarray(embeddings, np.float32)
        amax = float(np.max(np.abs(x))) if x.size else 1.0
        scale = max(amax, 1e-30) / 127.0
        return cls.build_from_codes(quantize_host(x, scale), scale, cfg, device=device)

    @classmethod
    def build_from_codes(cls, codes: np.ndarray, scale: float,
                         cfg: BuildConfig | None = None, device=None, timings=None):
        """Build from int8 codes (the streaming FASTA path hands these over
        from the device quantizer).  timings, when a dict, gets the seconds
        of each build phase."""
        import time

        cfg = cfg or BuildConfig()
        dev = resolve_device(device)
        t = timings if timings is not None else {}
        n, _d = codes.shape
        nlist = cfg.nlist if cfg.nlist else auto_nlist(n)
        nlist = min(nlist, max(n, 1))
        cap = ivf_cap(n, nlist)

        t0 = time.perf_counter()
        target = min(n, max(nlist * 24, 4096), 131_072)
        step = max(1, n // max(target, 1))
        cent0 = coarse_centroids(codes[::step].astype(np.float32), nlist, cfg.seed, dev)
        t1 = time.perf_counter()
        assign = _assign_nearest(codes, torch.from_numpy(cent0).to(dev))
        t2 = time.perf_counter()
        clusters, slab_of, n_slabs = _split_and_pack(codes, assign, cent0, cap, cfg.seed + 1)
        cent, codes_cm, row_ids = lay_out(clusters, slab_of, n_slabs, cap, codes)
        t["kmeans"], t["assign"] = t1 - t0, t2 - t1
        t["split_pack"] = time.perf_counter() - t2
        return cls(codes_cm, cent, row_ids, slab_of, scale, n, cap, n_slabs, dev)

    # ------------------------------------------------------------ layout

    def _slab_fill_counts(self) -> np.ndarray:
        """Real (non-empty) rows per slab."""
        if self._slabfill is None:
            self._slabfill = (self.row_ids >= 0).reshape(-1, self.cap).sum(1).astype(np.int64)
        return self._slabfill

    def _chunk_meta(self):
        """(nchunks [n_slabs+1], chunk_base [n_slabs+1], n_chunks_total) of
        the fill-aware chunked layout: slab s owns ceil(fill/CHK) chunks."""
        if self._chunkmeta is None:
            fill = self._slab_fill_counts()[: self.n_slabs]
            self._chunkmeta = ik.chunk_layout(fill, ik.CHK)
        return self._chunkmeta

    def _chunk_rows_host(self):
        """Slab-space codes -> chunked layout: (codesC [n_chunks*CHK, D]
        int8, row_idC [n_chunks*CHK] int64), each slab's filled prefix at
        its chunk range, the rest zero / -1."""
        _nch, cbase, ntot = self._chunk_meta()
        fill = self._slab_fill_counts()
        codesC = np.zeros((ntot * ik.CHK, self.codes_cm.shape[1]), np.int8)
        ridC = np.full(ntot * ik.CHK, -1, np.int64)
        for si in range(self.n_slabs):
            f = int(fill[si])
            b = int(cbase[si]) * ik.CHK
            codesC[b:b + f] = self.codes_cm[si * self.cap: si * self.cap + f]
            ridC[b:b + f] = self.row_ids[si * self.cap: si * self.cap + f]
        return codesC, ridC

    def _chunk_store(self):
        """(store, rnC [n_chunks, CHK] fp32, row_idC) on the device: the
        int8 rows [n_chunks, CHK, D] and their norms, 3.4e38 on empty rows."""
        codesC, ridC = self._chunk_rows_host()
        ntot = self._chunk_meta()[2]
        c3 = torch.from_numpy(codesC.reshape(ntot, ik.CHK, -1)).to(self.device)
        rn = torch.empty((ntot, ik.CHK), dtype=torch.float32, device=self.device)
        for s in range(0, ntot, 256):  # bounded int32 temporaries
            x = c3[s:s + 256].to(torch.int32)
            rn[s:s + 256] = (x * x).sum(-1).to(torch.float32)
        live = torch.from_numpy((ridC >= 0).reshape(ntot, ik.CHK)).to(self.device)
        rn = torch.where(live, rn, torch.full_like(rn, float(_BIGF)))
        return c3, rn, ridC

    def _device(self):
        """(store, rnC, centroids, centroid norms, slab_of, nchunks,
        chunk_base) on the device, built once."""
        if self._dev is None:
            store, rn, ridC = self._chunk_store()
            nch, cbase, _ = self._chunk_meta()
            cent = torch.from_numpy(np.ascontiguousarray(self.centroids, np.float32)).to(
                self.device)
            self._rowmap = ridC
            self._dev = (store, rn, cent, torch.sum(cent * cent, dim=-1),
                         torch.from_numpy(self.slab_of.astype(np.int64)).to(self.device),
                         torch.from_numpy(nch).to(self.device),
                         torch.from_numpy(cbase).to(self.device))
        return self._dev

    # ------------------------------------------------------------- kernels

    def _kernel_scan(self, step_chunk, step_visit, qsteps, store, rn, ratio2):
        """The packed chunk scan over this engine's store (IVFPQ overrides)."""
        return ik.ivf_chunk_scan_int8(step_chunk, step_visit, qsteps, store, rn, ratio2)

    def _kernel_scan_fold(self, step_chunk, step_visit, qidx, qsteps, nq, store, rn, ratio2):
        """The fold chunk scan over this engine's store (IVFPQ overrides)."""
        return ik.ivf_chunk_scan_int8_fold(step_chunk, step_visit, qidx, qsteps, store,
                                           rn, ratio2, nq)

    def _rows_of(self, store, chunks: torch.Tensor) -> torch.Tensor:
        """int8 rows [.., CHK, D] of the given chunks (the exact path)."""
        return store[chunks]

    def _use_fold(self, q: int, k: int) -> bool:
        return q >= self._FOLD_MIN_Q and k <= ik.FS * ik.KP

    # ------------------------------------------------------------- plans

    def _probe(self, q8: torch.Tensor, nprobe: int, ratio) -> torch.Tensor:
        """Top-nprobe clusters per query [Q, nprobe] (device): centroid
        scores cn - 2r q8.c (the row norm is constant per query), rounded
        once as XLA rounds them, exact stable top-k."""
        _s, _rn, cent, cn = self._device()[:4]
        d2 = fused_score(cn[None, :], 2.0 * float(np.float32(ratio)),
                         q8.to(torch.float32) @ cent.T)
        return smallest_k(d2, nprobe)[1]

    def _worst_chunks(self, q: int, nprobe: int) -> int:
        """Static step bound of the device plan: each query's probed slabs
        are distinct after dedup, so its steps are at most the sum of the
        nprobe largest chunk counts (bucketed as the JAX package does)."""
        nch, _cbase, _ntot = self._chunk_meta()
        real = np.sort(nch[: self.n_slabs])[::-1]
        per_q = int(real[: min(nprobe, real.size)].sum()) + max(0, nprobe - real.size)
        return _pad_bucket(q * per_q)

    def _build_plan_chunked(self, probe: np.ndarray, qtile: int):
        """Host plan (a numpy copy of the JAX package's): the same slab
        dedup and query tiling produce VISITS (one (slab, query-tile) pair
        each), then each visit expands to its slab's ceil(fill/CHK) chunk
        STEPS.

        Returns (step_chunk [s_pad] int32 global chunk ids, step_visit
        [s_pad+1] int32 (consecutive per visit, -1 sentinel), qidx
        [v_pad, qtile] int32 (dump row = Q), slot_of [Q, nprobe] int32
        into the [v_pad*qtile] visit-slot space)."""
        q, nprobe = probe.shape
        nch, cbase, _ntot = self._chunk_meta()
        slabs = self.slab_of[probe].astype(np.int64)
        srt = np.sort(slabs, axis=1)
        dup_sorted = np.concatenate(
            [np.zeros((q, 1), bool), srt[:, 1:] == srt[:, :-1]], axis=1
        )
        empty = self.n_slabs
        for_rank = np.argsort(slabs, axis=1, kind="stable")
        dup = np.zeros_like(dup_sorted)
        np.put_along_axis(dup, for_rank, dup_sorted, axis=1)
        slabs = np.where(dup, empty, slabs)
        pairs_c = slabs.ravel()
        pairs_q = np.repeat(np.arange(q, dtype=np.int32), nprobe)
        order = np.argsort(pairs_c, kind="stable")
        cs = pairs_c[order]
        qs = pairs_q[order]
        counts = np.bincount(cs, minlength=self.n_slabs + 1)
        visits_per = -(-counts // qtile)
        v_real = int(visits_per.sum())
        v_pad = _pad_bucket(v_real + 1)
        seg_start = np.concatenate([[0], np.cumsum(counts)[:-1]])
        visit_base = np.concatenate([[0], np.cumsum(visits_per)[:-1]])
        r = np.arange(cs.size) - seg_start[cs]
        visit_of_pair = visit_base[cs] + r // qtile
        slot = visit_of_pair * qtile + r % qtile
        qidx = np.full(v_pad * qtile, q, np.int32)
        qidx[slot] = qs
        slot_of = np.empty(q * nprobe, np.int32)
        slot_of[order] = slot
        used = counts > 0
        visit_slab = np.repeat(
            np.nonzero(used)[0].astype(np.int64), visits_per[used]
        )  # [v_real]
        nch_v = nch[visit_slab].astype(np.int64)
        s_real = int(nch_v.sum())
        s_pad = _pad_bucket(s_real)
        dump_chunk = int(cbase[self.n_slabs])
        step_visit = np.full(s_pad + 1, -1, np.int32)
        step_visit[:s_real] = np.repeat(
            np.arange(v_real, dtype=np.int32), nch_v
        )
        # padded steps form one pad visit (id v_real < v_pad) over the dump
        # chunk; its outputs are never referenced by slot_of
        step_visit[s_real:s_pad] = v_real
        step_chunk = np.full(s_pad, dump_chunk, np.int32)
        starts = np.cumsum(nch_v) - nch_v
        step_chunk[:s_real] = (
            np.repeat(cbase[visit_slab].astype(np.int64), nch_v)
            + (np.arange(s_real) - np.repeat(starts, nch_v))
        ).astype(np.int32)
        return step_chunk, step_visit, qidx.reshape(v_pad, qtile), \
            slot_of.reshape(q, nprobe)

    def _accum_stats(self, stats: dict, probe: np.ndarray, nprobe: int):
        """Accumulate per-batch effort counters from the probe set (dups
        within a row scan nothing extra, mirroring the plan's dedup)."""
        fill = self._slab_fill_counts()
        slabs = np.sort(self.slab_of[probe].astype(np.int64), axis=1)
        dup = np.concatenate(
            [np.zeros((len(slabs), 1), bool), slabs[:, 1:] == slabs[:, :-1]],
            axis=1,
        )
        rows_per_q = np.where(dup, 0, fill[slabs]).sum(1)
        stats["queries"] = stats.get("queries", 0) + len(slabs)
        stats["probed_rows"] = stats.get("probed_rows", 0) + int(rows_per_q.sum())
        stats["nprobe"] = nprobe
        stats["nlist"] = self.nlist
        stats["ntotal"] = self.ntotal

    # ------------------------------------------------------------- search

    def _host_plan(self, probe_dev: torch.Tensor, nprobe: int, stats):
        """Probe download, effort counters, host plan, plan upload."""
        probe = probe_dev.to(torch.int64).cpu().numpy()
        if stats is not None:
            self._accum_stats(stats, probe, nprobe)
        plan = self._build_plan_chunked(probe, ik.QTK)
        return drop_pad_steps([torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                               for a in plan])

    @staticmethod
    def _count_plan(plan, timings: dict) -> None:
        """Add the plan's referenced visits, their chunk steps and the
        distinct chunks those steps read to timings (plan_visits,
        plan_steps, plan_chunks); padding visits are left out."""
        step_chunk, step_visit, qidx, slot_of = plan
        _first, count = ik.visit_steps(step_visit, qidx.shape[0])
        wanted = torch.zeros(qidx.shape[0], dtype=torch.bool, device=qidx.device)
        wanted[slot_of.reshape(-1).long() // ik.QTK] = True
        stepped = wanted[step_visit[:-1].long()]
        timings["plan_visits"] = timings.get("plan_visits", 0) + int(wanted.sum())
        timings["plan_steps"] = timings.get("plan_steps", 0) + int(count[wanted].sum())
        timings["plan_chunks"] = (timings.get("plan_chunks", 0)
                                  + int(torch.unique(step_chunk[stepped]).numel()))

    def _exact_scan(self, q8_pad, plan, nprobe: int, kp: int, k: int, ratio2: float):
        """Every probed slab scored in full: an exact stable top-kp per
        visit (plain torch), then the slot merge.  -> (d [q, k], chunk-space
        ids [q, k])."""
        store, rn = self._device()[:2]
        step_chunk, step_visit, qidx, slot_of = plan
        n_visits = qidx.shape[0]
        first, count = ik.visit_steps(step_visit, n_visits)
        q = slot_of.shape[0]
        ds = torch.full((n_visits * ik.QTK, kp), float(_BIGF), device=q8_pad.device)
        rs = torch.zeros((n_visits * ik.QTK, kp), dtype=torch.int32, device=q8_pad.device)
        wanted = torch.zeros(n_visits, dtype=torch.bool, device=q8_pad.device)
        wanted[slot_of.reshape(-1).long() // ik.QTK] = True
        for nc in torch.unique(count[wanted]).tolist():
            vis = torch.nonzero(wanted & (count == nc)).squeeze(1)
            for b0 in range(0, vis.numel(), self._EXACT_VISITS):
                vb = vis[b0:b0 + self._EXACT_VISITS]
                ch = (first[vb].long()[:, None]
                      + torch.arange(nc, device=vb.device)[None, :])
                ch = step_chunk.long()[ch]                            # [v, nc]
                rows = self._rows_of(store, ch).reshape(vb.numel(), nc * ik.CHK, -1)
                dot = torch.bmm(q8_pad[qidx[vb].long()].to(torch.float32),
                                rows.to(torch.float32).transpose(1, 2))
                sc = fused_score(rn[ch].reshape(vb.numel(), 1, nc * ik.CHK), ratio2, dot)
                kk = min(kp, nc * ik.CHK)
                d, pos = smallest_k(sc, kk)                           # [v, QTK, kk]
                ids = (torch.gather(ch, 1, (pos // ik.CHK).reshape(vb.numel(), -1))
                       .reshape(pos.shape) * ik.CHK + pos % ik.CHK)
                sl = (vb.long()[:, None] * ik.QTK
                      + torch.arange(ik.QTK, device=vb.device)[None, :]).reshape(-1)
                ds[sl, :kk] = d.reshape(-1, kk)
                rs[sl, :kk] = ids.reshape(-1, kk).to(torch.int32)
        cat_d = ds[slot_of.reshape(-1).long()].reshape(q, nprobe * kp)
        cat_i = rs[slot_of.reshape(-1).long()].reshape(q, nprobe * kp)
        d, sel = smallest_k(cat_d, k)
        return d, torch.gather(cat_i, 1, sel)

    def search(self, queries: np.ndarray, k: int, ef: int = 32, exact: bool = False,
               approx_probe: bool | None = None, stats: dict | None = None,
               timings: dict | None = None):
        """ef = nprobe (clusters scanned per query).  exact=True scores the
        probed slabs in full (the probe set is then the only approximation).
        approx_probe is accepted for interface parity: the probe is always
        the exact stable top-k here.  Returns (ids [Q, k] int64 original row
        ids, dists [Q, k] fp32 squared-L2 estimates), as Int8FlatIndex.

        stats, when a dict, is filled with search-effort counters
        (probed_rows_per_query, coverage, centroid_evals_per_query); they
        need the probe set on the host, so serve-size batches then take the
        host-plan route.  timings, when a dict, gets seconds per phase
        (probe, plan, kernel, merge, download; device-synchronised) and the
        plan's step and visit counts."""
        del approx_probe
        queries = np.asarray(queries, np.float32)
        nq = queries.shape[0]
        if self.ntotal == 0 or nq == 0:
            return np.full((nq, k), -1, np.int64), np.full((nq, k), np.inf, np.float32)
        nprobe = int(np.clip(ef if ef else 32, 1, self.nlist))
        k_eff = min(k, self.ntotal)
        k_scan = min(k_eff, nprobe * (min(k_eff, self.cap) if exact else ik.KP))
        sq, ratio = query_scale_ratio(queries, self.scale)
        q8_all = quantize_host(queries, sq)
        out_d = np.empty((nq, k_scan), np.float32)
        out_i = np.empty((nq, k_scan), np.int64)
        for s in range(0, nq, self._Q_BATCH):
            e = min(s + self._Q_BATCH, nq)
            if exact:
                route = "exact"
            elif stats is None and (e - s) * nprobe <= self._FUSED_MAX_PAIRS:
                route = "fused"  # serve-size batch: the plan is built on the device
            else:
                route = "fold" if self._use_fold(e - s, k_scan) else "packed"
            out_i[s:e], out_d[s:e] = self.search_batch(q8_all[s:e], ratio, nprobe,
                                                       k_scan, route, stats, timings)
        if k_scan < k:
            out_d = np.pad(out_d, ((0, 0), (0, k - k_scan)), constant_values=np.inf)
            out_i = np.pad(out_i, ((0, 0), (0, k - k_scan)), constant_values=-1)
        if stats is not None and stats.get("queries"):
            stats["probed_rows_per_query"] = round(stats["probed_rows"] / stats["queries"], 1)
            stats["coverage"] = round(stats["probed_rows_per_query"] / max(self.ntotal, 1), 6)
            stats["centroid_evals_per_query"] = self.nlist
        return out_i, out_d

    def search_batch(self, q8_np: np.ndarray, ratio, nprobe: int, k: int, route: str,
                     stats: dict | None = None, timings: dict | None = None):
        """One batch of queries already quantized at scale sq (ratio = sq /
        the code scale) -> (row ids [q, k] int64, -1 where invalid; fp32
        squared-L2 estimates [q, k], inf there).  route: "fused" (device
        plan, packed merge), "packed" or "fold" (host plan), or "exact".
        nprobe may exceed this index's nlist (a sharded search probes the
        largest shard's count everywhere): the probe then takes every
        cluster, and the extra columns repeat the last one, which the
        plan's duplicate rule sends to the empty slab -- the JAX package's
        clip of its padded probe."""
        import time

        store, rn, _cent, _cn, slab_dev, nch_dev, cbase_dev = self._device()
        kp = min(k, self.cap) if route == "exact" else ik.KP
        ratio2 = 2.0 * float(np.float32(ratio))
        tm = timings

        def lap(name, t0):
            if tm is None:
                return t0
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            t1 = time.perf_counter()
            tm[name] = tm.get(name, 0.0) + (t1 - t0)
            return t1

        nq = q8_np.shape[0]
        t0 = time.perf_counter()
        q8 = torch.from_numpy(np.ascontiguousarray(q8_np)).to(self.device)
        q8_pad = torch.cat([q8, torch.zeros((1, q8.shape[1]), dtype=torch.int8,
                                            device=self.device)])
        probe = self._probe(q8, min(nprobe, self.nlist), ratio)
        if nprobe > self.nlist:
            probe = torch.cat([probe, torch.full((nq, nprobe - self.nlist), self.nlist - 1,
                                                 dtype=probe.dtype, device=probe.device)], 1)
        t0 = lap("probe", t0)
        if route == "exact":
            plan = self._host_plan(probe, nprobe, stats)
            t0 = lap("plan", t0)
            d_b, i_b = self._exact_scan(q8_pad, plan, nprobe, kp, k, ratio2)
            t0 = lap("kernel", t0)
        elif route == "fused":
            plan = drop_pad_steps(device_plan_chunked(
                slab_dev[probe], ik.QTK, self.n_slabs, nch_dev, cbase_dev,
                self._worst_chunks(nq, nprobe)))
            t0 = lap("plan", t0)
            step_chunk, step_visit, qidx, slot_of = plan
            packed = self._kernel_scan(step_chunk, step_visit, q8_pad[qidx.long()], store,
                                       rn, ratio2)
            t0 = lap("kernel", t0)
            d_b, i_b = ik.merge_packed(packed, slot_of, nprobe, k)
            t0 = lap("merge", t0)
        else:
            plan = self._host_plan(probe, nprobe, stats)
            t0 = lap("plan", t0)
            step_chunk, step_visit, qidx, slot_of = plan
            qsteps = q8_pad[qidx.long()]
            if route == "fold":
                facc = self._kernel_scan_fold(step_chunk, step_visit, qidx, qsteps, nq,
                                              store, rn, ratio2)
                t0 = lap("kernel", t0)
                d_b, i_b = ik.merge_fold(facc, nq, k)
            else:
                packed = self._kernel_scan(step_chunk, step_visit, qsteps, store, rn,
                                           ratio2)
                t0 = lap("kernel", t0)
                d_b, i_b = ik.merge_packed(packed, slot_of, nprobe, k)
            t0 = lap("merge", t0)
        d_b = d_b.cpu().numpy()
        i_b = i_b.to(torch.int64).cpu().numpy()
        lap("download", t0)
        if tm is not None:
            self._count_plan(plan, tm)
        # chunk-space rows -> original row ids; unset slots (_BIG) and
        # empty rows are invalid; quantized scores -> fp32 squared L2
        valid = (i_b >= 0) & (d_b < _BIGF / 2)
        qn = (q8_np.astype(np.int64) ** 2).sum(1).astype(np.float32)
        s2 = np.float32(self.scale) ** 2
        r2 = np.float32(ratio) ** 2
        return (np.where(valid, self._rowmap[np.maximum(i_b, 0)], -1),
                np.where(valid, (d_b + r2 * qn[:, None]) * s2, np.inf).astype(np.float32))

    # -------------------------------------------------------- persistence

    def save(self, index_prefix: str) -> None:
        os.makedirs(index_prefix, exist_ok=True)
        np.savez(
            os.path.join(index_prefix, "ivf_int8.npz"),
            codes_cm=self.codes_cm,
            centroids=self.centroids,
            row_ids=self.row_ids,
            slab_of=self.slab_of,
            scale=np.float64(self.scale),
            ntotal=self.ntotal,
            cap=self.cap,
            n_slabs=self.n_slabs,
        )

    @classmethod
    def load(cls, index_prefix: str, config: dict | None = None, device=None):
        z = np.load(os.path.join(index_prefix, "ivf_int8.npz"))
        return cls(
            z["codes_cm"], z["centroids"], z["row_ids"], z["slab_of"],
            float(z["scale"]), int(z["ntotal"]), int(z["cap"]), int(z["n_slabs"]),
            device,
        )
