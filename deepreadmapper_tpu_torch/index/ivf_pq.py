"""IVFPQ: the IVF-pruned scan over PQ codes (8-16 B per row).

Counterpart of ``deepreadmapper_tpu/index/ivf_pq.py``, byte-compatible on
disk (``ivf_pq.npz``: slab-major codes_cm [(S+1)*cap, m] uint8, the coarse
centroids, row ids, slab map, the PQ centroids and, with OPQ, rot).  It
subclasses IVFINT8: probe, plans, merges and the search loop are the same;
storage, build and the chunk scan differ.  Coarse clustering runs in the
int8-reconstruction domain (the vectors the scan scores), and the scan
rebuilds every row from its codes through the int8 codebook, so the score
is the int8 scan's on the reconstruction: distances equal PQFLAT's.

On the device the codes live in the chunked layout byte-packed, [n_chunks,
ceil(m/4), CHK] int32 (code j in byte j%4 of word j//4, each chunk's words
of one row CHK apart), with the reconstructions' norms [n_chunks, CHK].
OPQ queries rotate into the code space before the search, as PQFLAT's.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from deepreadmapper_tpu_torch import resolve_device
from deepreadmapper_tpu_torch.config import BuildConfig
from deepreadmapper_tpu_torch.index.ivf_int8 import (
    _BIGF,
    IVFInt8Index,
    _split_and_pack,
    auto_nlist,
    coarse_centroids,
    ivf_cap,
    lay_out,
)
from deepreadmapper_tpu_torch.index.registry import register_index
from deepreadmapper_tpu_torch.ops import ivf_kernel as ik
from deepreadmapper_tpu_torch.ops import pq as pq_ops
from deepreadmapper_tpu_torch.ops.topk import as_f32


# Copied from deepreadmapper_tpu/index/ivf_pq.py (that module imports jax).
def _recon_int8_host(codes: np.ndarray, cent8: np.ndarray) -> np.ndarray:
    """[n, m] uint8 codes -> [n, d] int8 reconstruction (host gather)."""
    parts = [cent8[j][codes[:, j].astype(np.int64)] for j in range(cent8.shape[0])]
    return np.concatenate(parts, axis=1)


def _assign_nearest_pq(codes: np.ndarray, cent8: np.ndarray, cent0: np.ndarray,
                       device: torch.device, chunk: int = 65536) -> np.ndarray:
    """Nearest coarse centroid of every PQ row, as the JAX package assigns
    them: the int8 reconstruction (exact) against the centroids rounded to
    bf16, products summed in fp32 (bf16 x int8-valued products are exact in
    fp32), minus the fp32 centroid norms -> ids [N] int32 (host).  Rows at
    a near-equal distance to two centroids may flip against the JAX
    package's, whose matmul sums in another order."""
    cent = torch.from_numpy(np.ascontiguousarray(cent0, np.float32)).to(device)
    cn = torch.sum(cent * cent, dim=-1)
    cent_bf = cent.to(torch.bfloat16).to(torch.float32)
    cb8 = torch.from_numpy(cent8).to(device)
    out = np.empty(codes.shape[0], np.int32)
    for s in range(0, codes.shape[0], chunk):
        cc = torch.from_numpy(np.ascontiguousarray(codes[s:s + chunk])).to(device)
        r = pq_ops.reconstruct8(cc, cb8).to(torch.float32)
        d2 = cn[None, :] - 2.0 * (r @ cent_bf.T)
        out[s:s + cc.shape[0]] = torch.argmin(d2, dim=-1).to(torch.int32).cpu().numpy()
    return out


# Copied from deepreadmapper_tpu/index/ivf_pq.py (that module imports jax).
def pack_codes_t(codes_cm: np.ndarray) -> np.ndarray:
    """[N, m] uint8 codes -> [ceil(m/4), N] int32, 4 codes per word.

    Transposed for lane density (pq_flat.py layout rule) AND byte-packed:
    a [m, N] int32 upload costs 4 B/code — 32 B/row at m=8, defeating PQ's
    footprint; packed it is 1 B/code (8 B/row + the 4 B/row norm array).
    """
    n, m = codes_cm.shape
    mp = -(-m // 4)
    packed = np.zeros((mp, n), np.uint32)
    # chunk the row range: a whole-matrix uint32 transpose would be a
    # 4 B/code transient (tens of GB at the 500M+-row tier)
    chunk = 1 << 22
    for s0 in range(0, n, chunk):
        e0 = min(s0 + chunk, n)
        ct = codes_cm[s0:e0].T.astype(np.uint32)  # [m, chunk]
        for j in range(m):
            packed[j // 4, s0:e0] |= ct[j] << (8 * (j % 4))
    return packed.view(np.int32)


@register_index("IVFPQ")
class IVFPQIndex(IVFInt8Index):
    """Cluster-pruned PQ scan (sub-linear at 8-16 B/row; ``ef`` = nprobe)."""

    def __init__(self, codes_cm, centroids, row_ids, slab_of, codebook, ntotal, cap,
                 n_slabs, rot=None, device: torch.device | str | None = None):
        self.codebook = codebook                      # PQCodebook fp32
        self.cb8 = pq_ops.quantize_codebook(codebook)
        self.rot = None if rot is None else np.asarray(rot, np.float32)
        super().__init__(codes_cm, centroids, row_ids, slab_of, self.cb8.scale, ntotal,
                         cap, n_slabs, device)

    # ------------------------------------------------------------- build

    @classmethod
    def build(cls, embeddings, cfg: BuildConfig | None = None, device=None):
        """Train PQ (or OPQ) on the evenly spaced sample, encode all, build."""
        cfg = cfg or BuildConfig()
        dev = resolve_device(device)
        x = as_f32(embeddings, dev)
        train = pq_ops.sample_training_set(x, cfg.sample_rate)
        rot = None
        if cfg.opq:
            cb, rot = pq_ops.train_opq(train, m=cfg.m_pq, nbits=cfg.nbits,
                                       iters=cfg.opq_iters, seed=cfg.seed, device=dev)
        else:
            cb = pq_ops.train_pq(train, m=cfg.m_pq, nbits=cfg.nbits,
                                 iters=cfg.kmeans_iters, seed=cfg.seed, device=dev)
        codes = pq_ops.encode_pq(x, cb, rot=rot)
        return cls.build_from_codes(codes, cb, cfg, rot=rot, device=dev)

    @classmethod
    def build_from_codes(cls, codes: np.ndarray, codebook, cfg=None, rot=None,
                         scale: float | None = None, device=None, timings=None):
        """Build from PQ codes [N, m] uint8 and their codebook (the
        streaming FASTA path hands these over from the device encoder).
        `scale` is accepted for signature parity with IVFInt8Index and
        ignored (the codebook carries it)."""
        del scale
        cfg = cfg or BuildConfig()
        dev = resolve_device(device)
        t = timings if timings is not None else {}
        cb8 = pq_ops.quantize_codebook(codebook)
        n, _m = codes.shape
        nlist = cfg.nlist if cfg.nlist else auto_nlist(n)
        nlist = min(nlist, max(n, 1))
        cap = ivf_cap(n, nlist)

        t0 = time.perf_counter()
        target = min(n, max(nlist * 24, 4096), 131_072)
        step = max(1, n // max(target, 1))
        sample = _recon_int8_host(codes[::step], cb8.cent8).astype(np.float32)
        cent0 = coarse_centroids(sample, nlist, cfg.seed, dev)
        t1 = time.perf_counter()
        assign = _assign_nearest_pq(codes, cb8.cent8, cent0, dev)
        t2 = time.perf_counter()
        clusters, slab_of, n_slabs = _split_and_pack(
            codes, assign, cent0, cap, cfg.seed + 1,
            fetch=lambda rows: _recon_int8_host(codes[rows], cb8.cent8).astype(np.float32),
        )
        cent, codes_cm, row_ids = lay_out(clusters, slab_of, n_slabs, cap, codes)
        t["kmeans"], t["assign"] = t1 - t0, t2 - t1
        t["split_pack"] = time.perf_counter() - t2
        return cls(codes_cm, cent, row_ids, slab_of, codebook, n, cap, n_slabs, rot=rot,
                   device=dev)

    # ------------------------------------------------------------ layout

    def _chunk_packed_host(self):
        """Slab-space codes -> the chunked layout: (packedC [mp,
        n_chunks*CHK] int32, rnC [n_chunks*CHK] fp32 recon norms, 3.4e38 on
        padding, ridC [n_chunks*CHK] int64 row ids)."""
        _nch, cbase, ntot = self._chunk_meta()
        fill = self._slab_fill_counts()
        cap = self.cap
        packed = pack_codes_t(self.codes_cm)  # [mp, (S+1)*cap]
        mp = packed.shape[0]
        rn_src = pq_ops.recon_norms(torch.from_numpy(self.codes_cm),
                                    torch.from_numpy(self.cb8.cent_norms)).numpy()
        rn_src = rn_src.astype(np.float32)
        packedC = np.zeros((mp, ntot * ik.CHK), np.int32)
        rnC = np.full(ntot * ik.CHK, _BIGF, np.float32)
        ridC = np.full(ntot * ik.CHK, -1, np.int64)
        for si in range(self.n_slabs):
            f = int(fill[si])
            b = int(cbase[si]) * ik.CHK
            packedC[:, b:b + f] = packed[:, si * cap: si * cap + f]
            rnC[b:b + f] = rn_src[si * cap: si * cap + f]
            ridC[b:b + f] = self.row_ids[si * cap: si * cap + f]
        return packedC, rnC, ridC

    def _chunk_store(self):
        """((packed codes [n_chunks, mp, CHK] int32, cent2d [m*ksub, dsub]
        int8), rnC [n_chunks, CHK], row_idC) on the device."""
        packedC, rnC, ridC = self._chunk_packed_host()
        ntot = self._chunk_meta()[2]
        mp = packedC.shape[0]
        packed = torch.from_numpy(np.ascontiguousarray(
            packedC.reshape(mp, ntot, ik.CHK).transpose(1, 0, 2))).to(self.device)
        cent8 = self.cb8.cent8
        cent2d = torch.from_numpy(cent8.reshape(-1, cent8.shape[-1])).to(self.device)
        rn = torch.from_numpy(rnC.reshape(ntot, ik.CHK)).to(self.device)
        return (packed, cent2d), rn, ridC

    # ------------------------------------------------------------- kernels

    def _kernel_scan(self, step_chunk, step_visit, qsteps, store, rn, ratio2):
        packed, cent2d = store
        return ik.ivf_chunk_scan_pq(step_chunk, step_visit, qsteps, packed, rn, cent2d,
                                    ratio2, self.codes_cm.shape[1])

    def _kernel_scan_fold(self, step_chunk, step_visit, qidx, qsteps, nq, store, rn, ratio2):
        packed, cent2d = store
        return ik.ivf_chunk_scan_pq_fold(step_chunk, step_visit, qidx, qsteps, packed, rn,
                                         cent2d, ratio2, self.codes_cm.shape[1], nq)

    def _rows_of(self, store, chunks: torch.Tensor) -> torch.Tensor:
        packed, cent2d = store
        flat = chunks.reshape(-1)
        rows = ik._pq_rows(packed[flat], cent2d, self.codes_cm.shape[1])
        return rows.reshape(chunks.shape + rows.shape[1:])

    # ------------------------------------------------------------ search

    def search(self, queries: np.ndarray, k: int, ef: int = 32, exact: bool = False,
               approx_probe: bool | None = None, stats: dict | None = None,
               timings: dict | None = None):
        """ef = nprobe; distances are squared-L2 estimates to the PQ
        reconstruction (PQFLAT's).  OPQ queries rotate into the code space
        on the host, as in the JAX package."""
        queries = np.asarray(queries, np.float32)
        if self.rot is not None and queries.size:
            queries = queries @ self.rot
        return super().search(queries, k, ef=ef, exact=exact, approx_probe=approx_probe,
                              stats=stats, timings=timings)

    # -------------------------------------------------------- persistence

    def save(self, index_prefix: str) -> None:
        os.makedirs(index_prefix, exist_ok=True)
        payload = dict(
            codes_cm=self.codes_cm,
            centroids=self.centroids,
            row_ids=self.row_ids,
            slab_of=self.slab_of,
            pq_centroids=self.codebook.centroids.cpu().numpy(),
            ntotal=self.ntotal,
            cap=self.cap,
            n_slabs=self.n_slabs,
        )
        if self.rot is not None:
            payload["rot"] = self.rot
        np.savez(os.path.join(index_prefix, "ivf_pq.npz"), **payload)

    @classmethod
    def load(cls, index_prefix: str, config: dict | None = None, device=None):
        z = np.load(os.path.join(index_prefix, "ivf_pq.npz"))
        dev = resolve_device(device)
        return cls(
            z["codes_cm"], z["centroids"], z["row_ids"], z["slab_of"],
            pq_ops.PQCodebook(torch.tensor(z["pq_centroids"], device=dev)),
            int(z["ntotal"]), int(z["cap"]), int(z["n_slabs"]),
            rot=z["rot"] if "rot" in z.files else None, device=dev,
        )
