"""Sharded ANN index: one complete sub-index per shard, a global top-k merge.

Counterpart of ``deepreadmapper_tpu/parallel/sharded_ann.py`` for all seven
engines (FLAT, INT8FLAT, PQFLAT, IVFINT8, IVFPQ, HNSWPQ, HNSWFLAT), with
its on-disk layout (``shard_i/`` directories + ``sharded.txt``).  Each
position of the mesh's 'shard' axis holds the port's own engine over a
contiguous slice of the vectors, on its own device.  The JAX package runs
one SPMD program over every shard, so it pads every shard to one global
shape; here a search loops over the query blocks of the 'data' axis and
over the shards, each shard's engine answers its top k_local, and one
merge follows ``_merge_fn``:

  * pad rows (the last real row repeated up to a shard multiple) and the
    boundary shard's rows from ``ntotal % n_local`` on are masked;
  * the shards' lists concatenate shard-major and one stable
    ``smallest_k`` takes the top k, so ties go to the lower shard, then the
    earlier column, as ``lax.top_k`` orders them;
  * ids travel as (local int32, shard int32) and the host composes int64
    global ids (``compose_global_ids``), so only the per-shard row count
    must fit int32.

The rules that decide answers are the JAX package's: the INT8FLAT and
PQFLAT shards quantize each data block with their own scale and return
fp32 squared L2 (distances x s^2), so shards with different scales merge
in one metric; the IVF shards probe up to the largest shard's cluster
count (``nprobe`` clipped there), quantize with each shard's scale over
the WHOLE batch, scan at ``k_local = min(k_eff, nprobe * KP, n_local)``,
fold from ``IVF_FOLD_MIN_Q`` queries per block on, and merge at
``k_merge = min(k, n_shard * k_local)``.  The IVF probe is the exact
stable top-k (the JAX package's approximate probe is not ported).

Shards on one device run one after another, so a card holding several
shards needs the search workspace of one shard at a time.  Under a
process group (``load_distributed``) every rank searches its own shards,
one all_gather exchanges the [Q, k_local] lists, and every rank merges the
same answer.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from deepreadmapper_tpu_torch.config import BuildConfig
from deepreadmapper_tpu_torch.index.int8_flat import quantize_host, query_scale_ratio
from deepreadmapper_tpu_torch.index.registry import engine_class
from deepreadmapper_tpu_torch.ops import ivf_kernel as ik
from deepreadmapper_tpu_torch.ops import scan_kernel as sk
from deepreadmapper_tpu_torch.ops.topk import smallest_k
from deepreadmapper_tpu_torch.parallel import distributed as dist_
from deepreadmapper_tpu_torch.parallel.mesh import Mesh, make_distributed_mesh

# fold-mode threshold of the sharded IVF search (queries a data block):
# below it the packed merge is cheaper (IVFInt8Index._FOLD_MIN_Q)
IVF_FOLD_MIN_Q = 4096
_Q_SUPER_PER_DATA = 8192  # queries a data block per pass

_KINDS = {"FLAT": "flat", "INT8FLAT": "int8flat", "PQFLAT": "pqflat",
          "IVFINT8": "ivfint8", "IVFPQ": "ivfpq", "HNSWPQ": "graph",
          "HNSWFLAT": "graph"}


# Copied from deepreadmapper_tpu/parallel/sharded_ann.py (that module imports jax).
def read_manifest(index_prefix: str) -> dict:
    """Parse <prefix>/sharded.txt (key:value lines) -- the single source of
    truth for shard count shared by the registry loader and load()."""
    meta = {}
    with open(os.path.join(index_prefix, "sharded.txt")) as f:
        for line in f:
            line = line.strip()
            if not line or ":" not in line:
                continue
            k, v = line.split(":", 1)
            meta[k] = v
    return meta


# Copied from deepreadmapper_tpu/parallel/sharded_ann.py (that module imports jax).
def compose_global_ids(local: np.ndarray, shard: np.ndarray,
                       n_local: int) -> np.ndarray:
    """(local int32, shard int32) -> int64 global ids (shard*n_local+local).

    The merge never forms global ids, so a sharded index may exceed 2^31
    total vectors; -1 locals (masked/invalid) stay -1."""
    loc = local.astype(np.int64)
    shd = shard.astype(np.int64)
    return np.where(loc >= 0, shd * np.int64(n_local) + loc, np.int64(-1))


def build_engine(index_type: str, rows, cfg: BuildConfig | None, device):
    """One shard's engine from its fp32 rows, as that engine builds alone."""
    cls = engine_class(index_type)
    if index_type in ("FLAT", "INT8FLAT"):
        return cls.build(rows, device=device)
    return cls.build(rows, cfg or BuildConfig(), device=device)


def split_shard_rows(rows: np.ndarray, n_shards: int) -> list[np.ndarray]:
    """Pad by REPEATING the last real row to a shard multiple (pad ids are
    masked at the merge by ntotal; unlike sentinel values a real row does
    not disturb a shard's PQ or coarse k-means), enforce the int32 per-shard
    row bound, split evenly."""
    pad = (-rows.shape[0]) % n_shards
    if pad:
        rows = np.concatenate([rows, np.repeat(rows[-1:], pad, axis=0)])
    if rows.shape[0] // n_shards >= 2**31:
        raise NotImplementedError(
            f"{rows.shape[0] // n_shards} rows/shard exceeds the int32 "
            "local-id space; use more shards"
        )
    return np.split(rows, n_shards)


class ShardedANNIndex:
    """Build / search / save / load a sharded index of any engine."""

    def __init__(self, subs, mesh: Mesh, ntotal: int, index_type: str,
                 shard_ids: list[int] | None = None):
        if index_type not in _KINDS:
            raise ValueError(f"Unknown index_type {index_type!r}; known: {sorted(_KINDS)}")
        self.subs = subs
        self.mesh = mesh
        self.ntotal = int(ntotal)
        self.index_type = index_type
        self.kind = _KINDS[index_type]
        # real rows per shard (IVF: the slab layout is bigger; validity and
        # global ids live in row space)
        self.n_local = int(subs[0].ntotal)
        # the global shard ids of self.subs: all of them, or under a process
        # group this rank's contiguous block (load_distributed)
        self.shard_ids = list(range(len(subs))) if shard_ids is None else list(shard_ids)
        self._local_only = False

    @classmethod
    def build(cls, embeddings: np.ndarray, mesh: Mesh, cfg: BuildConfig | None = None,
              index_type: str = "INT8FLAT"):
        """Split the rows over the mesh's shard axis and build each shard's
        engine on its device."""
        parts = split_shard_rows(np.asarray(embeddings, np.float32), mesh.shape["shard"])
        subs = [build_engine(index_type, p, cfg, mesh.shard_device(s))
                for s, p in enumerate(parts)]
        return cls(subs, mesh, embeddings.shape[0], index_type)

    # -------------------------------------------------------------- search

    def search(self, queries: np.ndarray, k: int, ef: int = 128):
        """queries [Q, D] -> (ids [Q, k] int64 global, -1 padded; dists
        [Q, k] fp32, inf there).  ef is nprobe for the IVF kinds and the
        beam width for the graph kinds.  Q splits into blocks over the
        'data' axis (padded to a multiple of it, 8192 rows a block a pass),
        and every block runs on every shard."""
        queries = np.asarray(queries, np.float32)
        nq = queries.shape[0]
        n_data = self.mesh.shape["data"]
        if self.kind in ("ivfint8", "ivfpq"):
            shard_fn, k_merge = self._ivf_setup(queries, k, ef)
            align = n_data
        else:
            ef_eff = max(ef, k)
            k_local = min(ef_eff, self.n_local)
            k_merge = k

            def shard_fn(li, sub, lo, hi, qb):
                return sub.search(queries[lo:hi], k_local, ef_eff)

            # the fused scans pad a block to their query tile; over-padding
            # is harmless for the other kinds
            fused_dev = self.mesh.shard_device(self.shard_ids[0]).type == "cuda"
            align = (n_data * sk.QT if self.kind in ("int8flat", "pqflat") and fused_dev
                     else n_data)
        out_i = np.full((nq, k), -1, np.int64)
        out_d = np.full((nq, k), np.inf, np.float32)
        q_super = _Q_SUPER_PER_DATA * n_data
        for s in range(0, nq, q_super):
            e = min(s + q_super, nq)
            width = q_super if nq > q_super else (e - s + (-(e - s)) % align)
            qb = width // n_data
            for db in range(n_data):
                lo, hi = s + db * qb, min(s + (db + 1) * qb, e)
                if lo >= hi:  # a block of padding only (the same on every rank)
                    continue
                parts = [shard_fn(li, sub, lo, hi, qb) for li, sub in enumerate(self.subs)]
                ids, d = self._merge(parts, k_merge)
                out_i[lo:hi, :ids.shape[1]] = ids
                out_d[lo:hi, :d.shape[1]] = d
        return out_i, out_d

    def _ivf_setup(self, queries: np.ndarray, k: int, ef: int):
        """(shard_fn, k_merge) of an IVF search: nprobe clipped to the
        largest shard's cluster count, so a full probe is exhaustive on
        every shard; each shard's query scale over the whole batch (IVFPQ:
        of the rotated queries), so every data block -- and the one-index
        engine -- quantizes identically."""
        cmax = max(sub.nlist for sub in self.subs)
        if self._local_only:
            cmax = dist_.global_max(cmax)
        nprobe = int(np.clip(ef if ef else 32, 1, cmax))
        k_eff = min(k, self.ntotal)
        k_local = min(k_eff, nprobe * ik.KP, self.n_local)
        k_merge = min(k, self.mesh.shape["shard"] * k_local)
        coded = []
        for sub in self.subs:
            rot = getattr(sub, "rot", None)
            qs = queries @ rot if rot is not None and queries.size else queries
            sq, ratio = query_scale_ratio(qs, sub.scale)
            coded.append((quantize_host(qs, sq), ratio))

        def shard_fn(li, sub, lo, hi, qb):
            q8, ratio = coded[li]
            fold = qb >= IVF_FOLD_MIN_Q and k_local <= ik.FS * ik.KP
            return sub.search_batch(q8[lo:hi], ratio, nprobe, k_local,
                                    "fold" if fold else "packed")

        return shard_fn, k_merge

    def _merge(self, parts, k: int):
        """Per-shard (local ids [q, kl], dists [q, kl]) in shard order ->
        (global ids [q, k'], dists [q, k']) with k' = min(k, shards x kl),
        on the device of this process's first shard (a stable sort of
        [q, shards x kl] takes about 0.4 s on the host at q 8192, 4 x 128).
        Under a process group the lists of every rank are gathered first
        (one collective), so every rank merges the same answer."""
        dev = self.mesh.shard_device(self.shard_ids[0])
        i = torch.from_numpy(np.stack([p[0] for p in parts]).astype(np.int64)).to(dev)
        d = torch.from_numpy(np.stack([p[1] for p in parts]).astype(np.float32)).to(dev)
        shard = torch.tensor(self.shard_ids, dtype=torch.int64, device=dev)
        if self._local_only:
            # fp32 distances and int32-bounded ids are exact in float64
            both = dist_.all_gather_cat(torch.stack([d.double(), i.double()]), dim=1)
            d, i = both[0].float(), both[1].long()
            shard = torch.arange(self.mesh.shape["shard"], dtype=torch.int64, device=dev)
        n_local, ntotal = self.n_local, self.ntotal
        full, boundary = ntotal // n_local, ntotal % n_local
        sh = shard[:, None, None].expand_as(i)
        valid = (i >= 0) & (i < n_local) & ((sh < full) | ((sh == full) & (i < boundary)))
        d = torch.where(valid, d, torch.full_like(d, float("inf")))
        i = torch.where(valid, i, torch.full_like(i, -1))
        sh = torch.where(valid, sh, torch.full_like(sh, -1))
        q = d.shape[1]
        vals, pos = smallest_k(d.permute(1, 0, 2).reshape(q, -1), k)
        i_all = torch.gather(i.permute(1, 0, 2).reshape(q, -1), 1, pos)
        s_all = torch.gather(sh.permute(1, 0, 2).reshape(q, -1), 1, pos)
        return (compose_global_ids(i_all.cpu().numpy(), s_all.cpu().numpy(), n_local),
                vals.cpu().numpy())

    # -------------------------------------------------------- persistence

    def save(self, index_prefix: str) -> None:
        """One sub-index directory per shard (shard_0/ .. shard_{S-1}/) plus
        the sharded.txt manifest (rank 0); config.txt is the build
        pipeline's, as for a one-engine index."""
        os.makedirs(index_prefix, exist_ok=True)
        for si, sub in zip(self.shard_ids, self.subs):
            sub.save(os.path.join(index_prefix, f"shard_{si}"))
        if dist_.is_main():
            with open(os.path.join(index_prefix, "sharded.txt"), "w") as f:
                f.write(f"n_shard:{self.mesh.shape['shard']}\n")
                f.write(f"ntotal:{self.ntotal}\n")
                f.write(f"inner:{self.index_type}\n")

    @classmethod
    def load(cls, index_prefix: str, mesh: Mesh):
        """Every shard, shard s on mesh.shard_device(s)."""
        meta = read_manifest(index_prefix)
        n_shard = int(meta["n_shard"])
        if mesh.shape["shard"] != n_shard:
            raise ValueError(
                f"index has {n_shard} shards but mesh shard axis is "
                f"{mesh.shape['shard']}"
            )
        eng = engine_class(meta["inner"])
        subs = [eng.load(os.path.join(index_prefix, f"shard_{si}"),
                         device=mesh.shard_device(si)) for si in range(n_shard)]
        return cls(subs, mesh, int(meta["ntotal"]), meta["inner"])

    @classmethod
    def load_distributed(cls, index_prefix: str, device=None):
        """Multi-process load: every rank loads ONLY its own shards
        (``distributed.load_own_shards``) onto its device.  Contract:
        ``init_distributed`` first, and every rank calls search() with the
        IDENTICAL query batch; each rank then holds the merged answer.  One
        process behaves as ``load`` on its device.  Unlike the JAX package
        the graph kinds work here too: no SPMD program constrains them."""
        from deepreadmapper_tpu_torch import resolve_device

        device = resolve_device(device)
        subs, mine, meta = dist_.load_own_shards(index_prefix, device=device)
        devices = [torch.device(d) for d in dist_.all_gather_object(str(device))]
        mesh = make_distributed_mesh(int(meta["n_shard"]), devices)
        obj = cls(subs, mesh, int(meta["ntotal"]), meta["inner"], shard_ids=mine)
        obj._local_only = dist_.world_size() > 1
        return obj
