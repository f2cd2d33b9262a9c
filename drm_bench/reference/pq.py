"""Plain reference of product quantization as the PQFLAT engine defines it
(the reference mapper's src/hnswpq/index.cpp:215-223: M_pq sub-vectors,
2^nbits centroids trained by k-means on an evenly spaced sample of the
windows, each window coded by its nearest centroid in every sub-space),
and of the int8 codebook its scan rebuilds rows from.  Plain PyTorch and
NumPy; nothing of the port is imported.
"""

from __future__ import annotations

import numpy as np
import torch


def sample_positions(genome_len: int, ref_len: int, stride: int,
                     sample_rate: float, max_rows: int) -> np.ndarray:
    """Positions of the training windows: every step-th window (both
    strands), step set so the sample holds about sample_rate of the rows,
    at most max_rows (the configuration's train_rows)."""
    nv = 2 * max(0, (genome_len - ref_len) // stride + 1)
    target = max(1, min(int(nv * sample_rate), max_rows))
    step = max(1, -(-nv // target)) * stride
    return np.arange(0, (genome_len - ref_len) // step + 1, dtype=np.int64) * step


def _split(x: torch.Tensor, m: int) -> torch.Tensor:
    n, d = x.shape
    return x.reshape(n, m, d // m).permute(1, 0, 2)


def kmeans(train: torch.Tensor, m: int, nbits: int, iters: int, seed: int) -> torch.Tensor:
    """Lloyd's k-means in each sub-space from evenly spaced training rows
    (jittered by 1e-5 N(0, 1) from the seed, which splits duplicates);
    nearest centroid by squared distance, the lower index on ties; an empty
    cluster keeps its centroid.  Returns centroids [m, 2^nbits, d/m]."""
    ksub = 1 << nbits
    n, d = train.shape
    data = _split(train.float(), m)  # [m, n, dsub]
    if n < ksub:
        idx = np.tile(np.arange(n), -(-ksub // n))[:ksub]
    else:
        idx = (np.arange(ksub) * (n / ksub)).astype(np.int64)
    jitter = np.random.default_rng(seed).standard_normal((m, ksub, d // m)).astype(np.float32)
    cent = data[:, torch.from_numpy(idx).to(train.device), :] + torch.from_numpy(
        jitter * np.float32(1e-5)).to(train.device)
    for _ in range(iters):
        d2 = ((data * data).sum(-1, keepdim=True) - 2 * data @ cent.transpose(1, 2)
              + (cent * cent).sum(-1)[:, None, :])
        a = torch.argmin(d2, dim=-1)  # [m, n]
        del d2
        # sums through a one-hot product: deterministic, unlike atomics
        onehot = torch.zeros(a.shape + (ksub,), device=train.device)
        onehot.scatter_(2, a[..., None], 1.0)
        counts = onehot.sum(dim=1)
        sums = onehot.transpose(1, 2) @ data
        del onehot
        cent = torch.where(counts[..., None] > 0, sums / counts.clamp(min=1)[..., None], cent)
    return cent


def int8_codebook(cent: np.ndarray):
    """(cent8 [m, ksub, dsub] int8, scale): one global scale amax / 127."""
    cent = np.asarray(cent, np.float32)
    amax = float(np.max(np.abs(cent))) if cent.size else 1.0
    scale = max(amax, 1e-30) / 127.0
    return np.clip(np.round(cent / scale), -127, 127).astype(np.int8), scale


def nearest(x: torch.Tensor, cent: torch.Tensor) -> torch.Tensor:
    """Squared distances [n, m, ksub] of rows x [n, d] to each sub-space's
    centroids cent [m, ksub, dsub], in float64."""
    m, ksub, dsub = cent.shape
    xs = x.double().reshape(x.shape[0], m, dsub).transpose(0, 1)  # [m, n, dsub]
    c = cent.double()
    d2 = ((xs * xs).sum(-1, keepdim=True) - 2 * xs @ c.transpose(1, 2)
          + (c * c).sum(-1)[:, None, :])
    return d2.transpose(0, 1)


def objective(x: torch.Tensor, cent: torch.Tensor, chunk: int = 32768) -> float:
    """The k-means objective: the mean over rows x [n, d] of the squared
    distance to the nearest centroid, summed over the sub-spaces, in
    float64."""
    total = 0.0
    for s in range(0, x.shape[0], chunk):
        total += float(nearest(x[s : s + chunk], cent).min(-1).values.sum())
    return total / max(1, x.shape[0])


def code_gap(x: torch.Tensor, cent: torch.Tensor, codes: torch.Tensor):
    """(reference codes [n, m], gap [n, m]): the nearest centroid of each
    sub-vector (lower index on ties) and, for the given codes, how far (in
    the codebook's int8 steps of 1/127) x lies on the wrong side of the
    boundary between the given centroid and the nearest one: 0 when the
    given code is a nearest centroid."""
    d2 = nearest(x, cent)
    ref = torch.argmin(d2, dim=-1)
    c = codes.long()
    d_given = torch.gather(d2, 2, c[..., None])[..., 0]
    d_best = torch.gather(d2, 2, ref[..., None])[..., 0]
    cm = cent.double()
    mi = torch.arange(cm.shape[0], device=x.device)[None, :]
    sep = torch.linalg.vector_norm(cm[mi, c] - cm[mi, ref], dim=-1)
    gap = torch.where(c == ref, 0.0, (d_given - d_best) / (2 * sep.clamp(min=1e-30)))
    return ref, gap * 127.0


def reconstruct8(codes: torch.Tensor, cent8: torch.Tensor) -> torch.Tensor:
    """[n, m] codes -> int8 rows [n, m * dsub] from the int8 codebook."""
    m = cent8.shape[0]
    parts = [cent8[j][codes[:, j].long()] for j in range(m)]
    return torch.cat(parts, dim=1)
