"""INT8 exhaustive-scan index: symmetric int8 quantization + exact int8 scoring.

Counterpart of ``deepreadmapper_tpu/index/int8_flat.py``, byte-compatible
on disk (``int8.npz``: codes, scale, ntotal).  With one global scale s,

    ||q - r||^2 = s^2 * (qn8 + rn8 - 2 * q8 . r8)

and every term is an exact integer, so ordering and ties are deterministic.
On a CUDA device at N >= 2^18 rows the search runs the fused window-min scan
(``ops.scan_kernel.fused_scan_topk``, the ``csrc/int8_winmin.cu`` kernel);
otherwise it scores the full [Q, chunk] matrix and takes an exact top-k.
Both top-k selections are exact here (the JAX package uses approx_max_k on
a TPU).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from deepreadmapper_tpu_torch import resolve_device
from deepreadmapper_tpu_torch.index.registry import register_index
from deepreadmapper_tpu_torch.ops import scan_kernel as sk
from deepreadmapper_tpu_torch.ops.topk import as_f32, merge_smallest_k, smallest_k

_BIGF = 3.4e38


def quantize(x: torch.Tensor, scale: float) -> torch.Tensor:
    """fp32 -> int8 with symmetric clipping at +-127, on x's device.
    torch.round rounds half to even, as jnp.round does; the scale is a
    tensor operand so the division is a true fp32 division."""
    x = x.to(torch.float32)
    s = torch.full((1,), scale, dtype=torch.float32, device=x.device)
    return torch.clamp(torch.round(x / s), -127, 127).to(torch.int8)


# Copied from deepreadmapper_tpu/index/int8_flat.py (that module imports jax).
def quantize_host(x: np.ndarray, scale) -> np.ndarray:
    """Host twin of quantize() — same rounding (banker's) and clipping."""
    return np.clip(
        np.round(np.asarray(x, np.float32) / np.float32(scale)), -127, 127
    ).astype(np.int8)


# Copied from deepreadmapper_tpu/index/int8_flat.py (that module imports jax).
def query_scale_ratio(queries: np.ndarray, code_scale: float):
    """Pick the query quantization scale: the code scale when the batch
    fits it (exact shared-scale integer scoring), else the batch's own
    amax/127 (no clipping; the sq/sc ratio folds into the score)."""
    sc = np.float32(code_scale)
    qmax = np.float32(np.max(np.abs(queries))) if queries.size else sc
    sq = max(sc, qmax / np.float32(127.0))
    return sq, np.float32(sq / sc)


def _int8_topk(q8: torch.Tensor, chunks, ntotal: int, k: int, ratio=1.0):
    """Exact top-k in the quantized space.  q8 [Q,D] int8; chunks yields
    (first row, rows [C,D] int8, row norms [C] int32) over the padded rows
    in order.  Scores r^2*qn + rn - 2r*(q8.r8) with r = sq/sc, rounded as
    the JAX package's XLA computes them (r^2*qn + rn in fp32, then one fused
    multiply-subtract) so ratio != 1 gives the same bits; at ratio 1 every
    term is exact."""
    dev = q8.device
    q32 = q8.to(torch.int32)
    qn = torch.sum(q32 * q32, dim=-1, dtype=torch.int32).to(torch.float32)
    r = torch.full((1,), float(np.float32(ratio)), dtype=torch.float32, device=dev)
    r2 = float(2.0 * np.float32(ratio))
    qf = q8.to(torch.float32)
    best_d = best_i = None
    for c0, rc, rnc in chunks:
        dot = qf @ rc.to(torch.float32).T  # [Q, chunk], exact integers
        base = r * r * qn[:, None] + rnc[None, :].to(torch.float32)
        scores = sk.fused_score(base, r2, dot)
        ids = torch.arange(c0, c0 + rc.shape[0], device=dev)
        scores = torch.where(ids[None, :] < ntotal, scores, _BIGF)
        d, pos = smallest_k(scores, k)
        i = ids[pos]
        if best_d is None:
            best_d, best_i = d, i
        else:
            best_d, best_i = merge_smallest_k(best_d, best_i, d, i, k)
    return best_d, best_i


def search_quantized(queries: np.ndarray, k: int, ntotal: int, code_scale: float,
                     device: torch.device, fused, chunks, q_batch: int = 8192):
    """The search loop shared by the int8-valued scans (INT8FLAT, PQFLAT).

    Queries quantize with their own scale when the batch exceeds the code
    scale (query_scale_ratio; the ratio folds into the score) and run in
    q_batch slices.  fused(q8, k, ratio) -> (rn - 2r q.r, ids) is the
    window-min scan over the store; when it is None, chunks() yields the
    (first row, int8 rows, norms) chunks of the exact scan.  Returns
    (ids [Q, k] int64, fp32 squared-L2 estimates [Q, k]); past ntotal the
    columns are -1 / inf."""
    nq = queries.shape[0]
    if ntotal == 0:
        return (np.full((nq, k), -1, np.int64), np.full((nq, k), np.inf, np.float32))
    k_eff = min(k, ntotal)
    sq, ratio = query_scale_ratio(queries, code_scale)
    q8_all = quantize_host(queries, sq)
    pending = []
    for s in range(0, nq, q_batch):
        e = min(s + q_batch, nq)
        qb = q8_all[s:e]
        if fused is not None:
            width = q_batch if nq > q_batch else (e - s + (-(e - s)) % sk.QT)
            if qb.shape[0] < width:
                qb = np.pad(qb, ((0, width - qb.shape[0]), (0, 0)))
            res = fused(torch.from_numpy(qb).to(device), k_eff, ratio)
        else:
            res = _int8_topk(torch.from_numpy(qb).to(device), chunks(), ntotal,
                             k_eff, ratio)
        pending.append((s, e, res))
    d = np.empty((nq, k_eff), np.float32)
    i = np.empty((nq, k_eff), np.int64)
    s2 = np.float32(code_scale) ** 2
    qn_all = (q8_all.astype(np.int64) ** 2).sum(1).astype(np.float32)
    for s, e, (db, ib) in pending:
        # quantized-space scores -> fp32 squared L2 estimate; the fused
        # scan returns rn - 2(sq/sc) q.r, so add the scaled query norm
        db = db.cpu().numpy()[: e - s]
        if fused is not None:
            db = db + (ratio * ratio) * qn_all[s:e, None]
        d[s:e] = db * s2
        i[s:e] = ib.cpu().numpy()[: e - s]
    if k_eff < k:
        d = np.pad(d, ((0, 0), (0, k - k_eff)), constant_values=np.inf)
        i = np.pad(i, ((0, 0), (0, k - k_eff)), constant_values=-1)
    return i, d


@register_index("INT8FLAT")
class Int8FlatIndex:
    """Exhaustive int8 scan (near-exact recall, 128 B/vector)."""

    _CHUNK = 262144
    _Q_BATCH = 8192  # [q_batch, chunk] score tensors must fit device memory

    def __init__(self, codes: np.ndarray, scale: float, ntotal: int,
                 device: torch.device | str | None = None):
        self.codes = codes              # [N, D] int8 (host)
        self.scale = float(scale)
        self.ntotal = ntotal
        self.device = resolve_device(device)
        self._dev = None
        self._rn = None

    @classmethod
    def build(cls, embeddings, device=None):
        """Global symmetric scale from the data (amax / 127)."""
        x = as_f32(embeddings)
        amax = float(torch.max(torch.abs(x))) if x.numel() else 1.0
        scale = max(amax, 1e-30) / 127.0
        codes = quantize(x, scale).cpu().numpy()
        return cls(codes, scale, codes.shape[0], device)

    def _device(self) -> torch.Tensor:
        """Codes on the device, padded ONCE to a chunk multiple: 2^18 rows
        at 2^18 rows and above, else the scan's candidate tile; both paths
        mask pad rows by ntotal themselves."""
        if self._dev is None:
            codes = self.codes
            n = codes.shape[0]
            base = sk._PAD_BASE if n >= sk._PAD_BASE else sk.CT
            pad = (-n) % min(base, max(n, 1))
            if pad:
                codes = np.pad(codes, ((0, pad), (0, 0)))
            self._dev = torch.tensor(codes, device=self.device)
        return self._dev

    def _device_norms(self) -> torch.Tensor:
        """Row norms for the unfused path, computed on first use (the fused
        scan recomputes norms in the kernel and never reads them)."""
        if self._rn is None:
            c = self._device()
            parts = []
            for s in range(0, c.shape[0], self._CHUNK):  # bounded int32 temps
                x = c[s : s + self._CHUNK].to(torch.int32)
                parts.append((x * x).sum(1, dtype=torch.int32))
            self._rn = torch.cat(parts)
        return self._rn

    def search(self, queries: np.ndarray, k: int, ef: int = 0,
               exact: bool = False):
        """ef accepted for interface parity; an exhaustive scan ignores it.
        exact=True forces the unfused full-score path."""
        n = self.ntotal
        c = self._device() if n else None
        np_ = int(c.shape[0]) if n else 0
        use_fused = not exact and sk.can_fuse(n, np_, min(k, n), self.device)

        def fused(q8, k_eff, ratio):
            return sk.fused_scan_topk(q8, c, n, k_eff, sk.choose_chunk(np_), ratio=ratio)

        def chunks():
            rn = self._device_norms()
            step = min(self._CHUNK, np_)
            return ((c0, c[c0 : c0 + step], rn[c0 : c0 + step])
                    for c0 in range(0, np_, step))

        return search_quantized(np.asarray(queries, np.float32), k, n, self.scale,
                                self.device, fused if use_fused else None, chunks,
                                self._Q_BATCH)

    def save(self, index_prefix: str) -> None:
        os.makedirs(index_prefix, exist_ok=True)
        np.savez(
            os.path.join(index_prefix, "int8.npz"),
            codes=self.codes,
            scale=np.float64(self.scale),
            ntotal=self.ntotal,
        )

    @classmethod
    def load(cls, index_prefix: str, config: dict | None = None, device=None):
        z = np.load(os.path.join(index_prefix, "int8.npz"))
        return cls(z["codes"], float(z["scale"]), int(z["ntotal"]), device)
