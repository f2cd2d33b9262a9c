"""Exhaustive PQ scan index (PQFLAT, optionally with an OPQ rotation).

Counterpart of ``deepreadmapper_tpu/index/pq_flat.py``, byte-compatible on
disk (``pq.npz``: codes, centroids, ntotal, and rot when present).  The
distance to a PQ reconstruction is the exact squared L2 to the
reconstructed vector, so the scan rebuilds rows from an int8-quantized
codebook (exactly int8-valued) and scores them as INT8FLAT does:

    score = ||q8||^2 + ||recon8||^2 - 2 * q8 . recon8      (exact integers)

at 8 B of codes per vector on the device.  On a CUDA device at N >= 2^18
rows the search runs the fused window-min scan (``csrc/pq_winmin.cu``);
otherwise the chunked exact-in-quantized-space scan, whose top-k is exact
and stable.  Codes stay [N, m] uint8 on the device: the JAX package's
transposed [m, N] int32 layout exists for the TPU's (8, 128) lane tiling.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from deepreadmapper_tpu_torch.config import BuildConfig
from deepreadmapper_tpu_torch import resolve_device
from deepreadmapper_tpu_torch.index.int8_flat import search_quantized
from deepreadmapper_tpu_torch.index.registry import register_index
from deepreadmapper_tpu_torch.ops import pq as pq_ops
from deepreadmapper_tpu_torch.ops import scan_kernel as sk
from deepreadmapper_tpu_torch.ops.topk import as_f32


@register_index("PQFLAT")
class PQFlatIndex:
    _CHUNK = 131072  # rows per exact-scan chunk: bounds [q_batch, chunk] scores
    _Q_BATCH = 8192

    def __init__(self, codes: np.ndarray, codebook: pq_ops.PQCodebook,
                 ntotal: int, rot: np.ndarray | None = None,
                 device: torch.device | str | None = None):
        self.codes = codes               # [N, m] uint8 (host)
        self.codebook = codebook
        self.ntotal = ntotal
        # Optional OPQ rotation Rt [d, d]: codes live in the rotated space
        # (y = x @ Rt); queries rotate at search time.  Rt is orthogonal, so
        # L2 distances are unchanged.
        self.rot = None if rot is None else np.asarray(rot, np.float32)
        self.cb8 = pq_ops.quantize_codebook(codebook)
        self.device = resolve_device(device)
        self._dev = None
        self._rn = None

    @classmethod
    def build(cls, embeddings, cfg: BuildConfig | None = None, device=None):
        """Train PQ (or OPQ) on the evenly spaced half sample, encode all."""
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
        return cls(codes, cb, codes.shape[0], rot, dev)

    def _device(self):
        """(codes [Np, m] uint8, cent8 [m, ksub, dsub] int8) on the device,
        codes padded ONCE to a chunk multiple: 2^18 rows at 2^18 rows and
        above, else the scan's candidate tile; pad rows are masked by
        ntotal in both scans."""
        if self._dev is None:
            codes = self.codes
            n = codes.shape[0]
            base = sk._PAD_BASE if n >= sk._PAD_BASE else sk.CT
            pad = (-n) % min(base, max(n, 1))
            if pad:
                codes = np.pad(codes, ((0, pad), (0, 0)))
            self._dev = (torch.tensor(codes, device=self.device),
                         torch.tensor(self.cb8.cent8, device=self.device))
        return self._dev

    def _device_norms(self) -> torch.Tensor:
        """Row norms of the int8 reconstructions for the exact scan, on
        first use (the fused scan recomputes them in the kernel)."""
        if self._rn is None:
            codes, _ = self._device()
            cn = torch.tensor(self.cb8.cent_norms, device=self.device)
            self._rn = torch.cat([pq_ops.recon_norms(codes[s : s + self._CHUNK], cn)
                                  for s in range(0, codes.shape[0], self._CHUNK)])
        return self._rn

    def search(self, queries: np.ndarray, k: int, ef: int = 0,
               exact: bool = False):
        """ef accepted for interface parity; an exhaustive scan ignores it.
        exact=True forces the chunked exact scan.  The OPQ rotation applies
        to the fp32 queries on the host, as in the JAX package, so both
        quantize the same rotated values."""
        n = self.ntotal
        queries = np.asarray(queries, np.float32)
        if self.rot is not None and queries.size:
            queries = queries @ self.rot  # into the OPQ-rotated space
        codes, cent8 = self._device() if n else (None, None)
        np_ = int(codes.shape[0]) if n else 0
        use_fused = not exact and sk.can_fuse(n, np_, min(k, n), self.device)

        def fused(q8, k_eff, ratio):
            return sk.fused_scan_topk(q8, codes, n, k_eff, sk.choose_chunk(np_),
                                      ratio=ratio, cent8=cent8)

        def chunks():
            rn = self._device_norms()
            step = min(self._CHUNK, np_)
            return ((c0, pq_ops.reconstruct8(codes[c0 : c0 + step], cent8),
                     rn[c0 : c0 + step]) for c0 in range(0, np_, step))

        return search_quantized(queries, k, n, self.cb8.scale, self.device,
                                fused if use_fused else None, chunks, self._Q_BATCH)

    def save(self, index_prefix: str) -> None:
        os.makedirs(index_prefix, exist_ok=True)
        payload = dict(
            codes=self.codes,
            centroids=self.codebook.centroids.cpu().numpy(),
            ntotal=self.ntotal,
        )
        if self.rot is not None:
            payload["rot"] = self.rot
        np.savez(os.path.join(index_prefix, "pq.npz"), **payload)

    @classmethod
    def load(cls, index_prefix: str, config: dict | None = None, device=None):
        z = np.load(os.path.join(index_prefix, "pq.npz"))
        dev = resolve_device(device)
        return cls(
            z["codes"],
            pq_ops.PQCodebook(torch.tensor(z["centroids"], device=dev)),
            int(z["ntotal"]),
            rot=z["rot"] if "rot" in z.files else None,
            device=dev,
        )
