"""Product quantization: codebook training, encoding, the int8 codebook.

Counterpart of ``deepreadmapper_tpu/ops/pq.py`` (the reference's FAISS
IndexHNSWPQ quantization layer): M_pq sub-vectors x 2^nbits centroids
trained by k-means on an evenly spaced sample, vectors encoded to M_pq uint8
codes.  Training runs all subquantizers as one batched k-means on an
explicit device: data [m, n, dsub] against centroids [m, ksub, dsub], the
assignment one batched matmul, the update one scatter-add.

The scan side (PQFLAT) reconstructs rows from an int8-quantized codebook
(:class:`PQInt8Codebook`): the distance to the reconstruction is then an
exact int8 dot product, the same scan as INT8FLAT's.

Backends sum matmuls in different orders, so k-means assignments on near
ties may differ from the JAX package's; on data with clear clusters the
codebooks agree closely and the codes exactly (tests/test_torch_pq.py).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from deepreadmapper_tpu_torch.ops.topk import as_f32


class PQCodebook(NamedTuple):
    centroids: torch.Tensor  # [m, ksub, dsub] fp32

    @property
    def m(self) -> int:
        return self.centroids.shape[0]

    @property
    def ksub(self) -> int:
        return self.centroids.shape[1]

    @property
    def dsub(self) -> int:
        return self.centroids.shape[2]


# Copied from deepreadmapper_tpu/ops/pq.py (that module imports jax).
def sample_training_set(vectors: np.ndarray, sample_rate: float = 0.5) -> np.ndarray:
    """Evenly-spaced training sample (create_training_set, index.cpp:57-84)."""
    total = vectors.shape[0]
    n_train = max(1, int(total * sample_rate))
    step = total / n_train
    idx = np.minimum((np.arange(n_train) * step).astype(np.int64), total - 1)
    return vectors[idx]


def _host_f32(a) -> np.ndarray:
    """numpy array or tensor -> fp32 numpy array on the host."""
    return np.asarray(a.cpu().numpy() if torch.is_tensor(a) else a, np.float32)


def _split(x: torch.Tensor, m: int) -> torch.Tensor:
    """[n, d] -> [m, n, dsub]."""
    n, d = x.shape
    return x.reshape(n, m, d // m).permute(1, 0, 2).contiguous()


def _sq_dists(data: torch.Tensor, cent: torch.Tensor) -> torch.Tensor:
    """[m, n, dsub] x [m, k, dsub] -> [m, n, k] squared distances
    ||x||^2 - 2 x.c + ||c||^2, summed in the JAX package's order.  Built in
    place: the [m, n, k] tensor (2 GB at 262k x 256 x 8) exists once."""
    d2 = torch.bmm(data, cent.transpose(1, 2))
    d2.mul_(-2.0).add_(torch.sum(data * data, dim=-1, keepdim=True))
    return d2.add_(torch.sum(cent * cent, dim=-1)[:, None, :])


def _kmeans_batched(data: torch.Tensor, init: torch.Tensor, iters: int) -> torch.Tensor:
    """Batched Lloyd iterations.  data [m, n, dsub], init [m, k, dsub].
    Ties in the assignment go to the lowest centroid (torch.argmin returns
    the first minimum); an empty cluster keeps its previous centroid.  The
    update sums through a one-hot matmul, as the JAX package does, which
    unlike a scatter-add (atomics on CUDA) is deterministic."""
    cent = init
    k = cent.shape[1]
    for _ in range(iters):
        d2 = _sq_dists(data, cent)
        a = torch.argmin(d2, dim=-1)  # [m, n]
        del d2
        onehot = torch.zeros(a.shape + (k,), dtype=data.dtype, device=data.device)
        onehot.scatter_(2, a[..., None], 1.0)  # [m, n, k], built in place
        counts = onehot.sum(dim=1)  # [m, k], exact
        sums = torch.bmm(onehot.transpose(1, 2), data)  # [m, k, dsub]
        del onehot
        new = sums / torch.clamp(counts[..., None], min=1.0)
        cent = torch.where(counts[..., None] > 0, new, cent)
    return cent


def train_pq(train_vectors, m: int = 8, nbits: int = 8, iters: int = 25,
             seed: int = 1234, device=None) -> PQCodebook:
    """train_vectors [n, d] (numpy or a tensor) -> codebook on ``device``
    (default: where a tensor is, else the CPU)."""
    ksub = 1 << nbits
    x = as_f32(train_vectors, device)
    n, d = x.shape
    if d % m:
        raise ValueError(f"dim {d} not divisible by M_pq {m}")
    data = _split(x, m)
    # Deterministic init: evenly spaced distinct training points per subq.
    if n < ksub:
        reps = -(-ksub // n)
        idx = np.tile(np.arange(n), reps)[:ksub]
    else:
        idx = (np.arange(ksub) * (n / ksub)).astype(np.int64)
    rng = np.random.default_rng(seed)
    jitter = rng.standard_normal((m, ksub, d // m)).astype(np.float32) * 1e-5
    init = data[:, torch.from_numpy(idx).to(data.device), :] + torch.from_numpy(
        jitter).to(data.device)  # tiny jitter splits duplicate points
    return PQCodebook(_kmeans_batched(data, init, iters))


def train_opq(train_vectors: np.ndarray, m: int = 8, nbits: int = 8,
              iters: int = 10, pq_iters: int = 8, seed: int = 1234,
              device=None) -> tuple[PQCodebook, np.ndarray]:
    """OPQ (non-parametric): alternate k-means in the rotated space, warm-
    started from the previous centroids, with the orthogonal-Procrustes
    update Rt = U @ Vt from svd(X^T @ recon) (numpy, as the JAX package).
    Returns (codebook in the ROTATED space, Rt [d, d]); y = x @ Rt."""
    if iters < 1:
        raise ValueError("train_opq needs iters >= 1 (opq_iters in BuildConfig)")
    x = _host_f32(train_vectors)
    n, d = x.shape
    rt = np.eye(d, dtype=np.float32)
    cb = None
    for _ in range(iters):
        y = x @ rt
        if cb is None:
            cb = train_pq(y, m=m, nbits=nbits, iters=pq_iters, seed=seed, device=device)
        else:
            data = _split(as_f32(y, cb.centroids.device), m)
            cb = PQCodebook(_kmeans_batched(data, cb.centroids, pq_iters))
        recon = pq_reconstruct(encode_pq(y, cb), cb)
        # min ||x @ Rt - recon||_F over orthogonal Rt (Procrustes)
        u, _, vt = np.linalg.svd(x.T @ recon)
        rt = (u @ vt).astype(np.float32)
    data = _split(as_f32(x @ rt, cb.centroids.device), m)
    return PQCodebook(_kmeans_batched(data, cb.centroids, pq_iters)), rt


def encode_device(x: torch.Tensor, codebook: PQCodebook,
                  rot: torch.Tensor | None = None) -> torch.Tensor:
    """fp32 rows [n, d] on the codebook's device -> codes [n, m] uint8 there
    (nearest centroid per subspace, lowest on ties); rot, the OPQ rotation,
    is applied first."""
    if rot is not None:
        x = x @ rot
    d2 = _sq_dists(_split(x, codebook.m), codebook.centroids)
    return torch.argmin(d2, dim=-1).to(torch.uint8).T


def encode_pq(vectors, codebook: PQCodebook, chunk: int = 262144,
              rot: np.ndarray | None = None) -> np.ndarray:
    """Chunked encode on the codebook's device -> [n, m] uint8 (host).
    rot (the OPQ rotation) is applied per chunk on the device, so the full
    rotated fp32 matrix never exists."""
    dev = codebook.centroids.device
    n = vectors.shape[0]
    out = np.empty((n, codebook.m), dtype=np.uint8)
    rot_dev = None if rot is None else as_f32(rot, dev)
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        out[s:e] = encode_device(as_f32(vectors[s:e], dev), codebook, rot_dev).cpu().numpy()
    return out


class PQInt8Codebook(NamedTuple):
    """Int8-quantized codebook for the reconstruct-then-int8-scan form: one
    global scale, so every reconstruction is exactly int8-valued and its
    score against int8 queries is an exact integer."""

    cent8: np.ndarray       # [m, ksub, dsub] int8
    scale: float            # fp32 dequant scale (value = cent8 * scale)
    cent_norms: np.ndarray  # [m, ksub] int32 squared sub-norms


# Copied from deepreadmapper_tpu/ops/pq.py (that module imports jax).
def quantize_codebook(codebook: PQCodebook) -> PQInt8Codebook:
    cent = _host_f32(codebook.centroids)
    amax = float(np.max(np.abs(cent))) if cent.size else 1.0
    scale = max(amax, 1e-30) / 127.0
    cent8 = np.clip(np.round(cent / scale), -127, 127).astype(np.int8)
    cn = np.sum(cent8.astype(np.int32) ** 2, axis=-1, dtype=np.int32)
    return PQInt8Codebook(cent8, scale, cn)


# Copied from deepreadmapper_tpu/ops/pq.py (that module imports jax).
def cent8_block_diag(cent8: np.ndarray) -> np.ndarray:
    """[m, ksub, dsub] int8 -> [m*ksub, m*dsub] fp32 block-diagonal decoder:
    onehot(codes) @ this = the int8 reconstruction, exactly."""
    m, ksub, dsub = cent8.shape
    flat = np.zeros((m * ksub, m * dsub), np.float32)
    for j in range(m):
        flat[j * ksub : (j + 1) * ksub, j * dsub : (j + 1) * dsub] = cent8[j]
    return flat


def recon_norms(codes: torch.Tensor, cent_norms: torch.Tensor) -> torch.Tensor:
    """[N, m] uint8 codes -> [N] int32 squared norms of the int8 recon."""
    cols = torch.arange(codes.shape[1], device=codes.device)
    return cent_norms[cols[None, :], codes.long()].sum(dim=1, dtype=torch.int32)


def reconstruct8(codes: torch.Tensor, cent8: torch.Tensor) -> torch.Tensor:
    """[N, m] uint8 codes, [m, ksub, dsub] int8 -> [N, m*dsub] int8 rows
    (the rows the PQ scan scores)."""
    n, m = codes.shape
    cols = torch.arange(m, device=codes.device)
    return cent8[cols[None, :], codes.long()].reshape(n, -1)


def pq_reconstruct(codes: np.ndarray, codebook: PQCodebook) -> np.ndarray:
    """Decode codes back to fp32 vectors [n, d] (host)."""
    cent = _host_f32(codebook.centroids)
    parts = [cent[j][codes[:, j].astype(np.int64)] for j in range(codebook.m)]
    return np.concatenate(parts, axis=1)


def adc_tables(queries, cent: torch.Tensor) -> torch.Tensor:
    """[Q, d] -> ADC tables [Q, m, ksub] of squared sub-distances
    ||q||^2 - 2 q.c + ||c||^2, summed in the JAX package's order, on the
    codebook's device."""
    q = _split(as_f32(queries, cent.device), cent.shape[0])  # [m, Q, dsub]
    return _sq_dists(q, cent).permute(1, 0, 2).contiguous()


def adc_distances_gather(tables: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """tables [Q, m, ksub], codes [C, m] -> distances [Q, C] (gather form):
    the sum over m of tables[q, m, codes[c, m]]."""
    m = tables.shape[1]
    c = codes.long().T  # [m, C]
    picked = torch.stack([tables[:, j, c[j]] for j in range(m)])  # [m, Q, C]
    return picked.sum(dim=0)


def codes_to_onehot(codes: torch.Tensor, ksub: int = 256) -> torch.Tensor:
    """[C, m] uint8 -> bf16 one-hot [C, m*ksub] (exact 0/1 values)."""
    c, m = codes.shape
    flat = codes.long() + torch.arange(m, device=codes.device) * ksub  # [C, m]
    out = torch.zeros((c, m * ksub), dtype=torch.bfloat16, device=codes.device)
    return out.scatter_(1, flat, 1.0)


def adc_distances_onehot(tables: torch.Tensor, onehot: torch.Tensor) -> torch.Tensor:
    """tables [Q, m, ksub], onehot [C, m*ksub] -> [Q, C] as one matmul.
    The table is rounded to bf16 as in the JAX package; the product of a
    bf16 entry and a 0/1 is exact, and the sum accumulates in fp32 (a bf16
    matmul here would round its output to bf16)."""
    t_flat = tables.reshape(tables.shape[0], -1).to(torch.bfloat16).float()
    return t_flat @ onehot.float().T
