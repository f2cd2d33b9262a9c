"""Exact L2 top-k and the stable top-k every search path shares.

Counterpart of ``deepreadmapper_tpu/ops/topk.py``.  Distances are SQUARED L2
(``||q||^2 + ||r||^2 - 2 q.r``), streamed over reference chunks with a
running merge.  Ties go to the lower id, as ``jax.lax.top_k`` orders them:
``torch.topk`` promises no order among equal values, so every selection here
goes through a stable sort.
"""

from __future__ import annotations

import numpy as np
import torch

_BIG = 3.4e38


def smallest_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k smallest entries of each row, ascending; among equal values
    the lower column comes first.  -> (values [.., k], columns [.., k])."""
    vals, pos = torch.sort(x, dim=-1, stable=True)
    return vals[..., :k], pos[..., :k]


def merge_smallest_k(best_d, best_i, d, i, k: int):
    """Running merge of two ascending candidate lists (ties keep the earlier
    list's entry first, as top_k over their concatenation does)."""
    cat_d = torch.cat([best_d, d], dim=1)
    cat_i = torch.cat([best_i, i], dim=1)
    vals, pos = smallest_k(cat_d, k)
    return vals, torch.gather(cat_i, 1, pos)


def as_f32(a, device=None) -> torch.Tensor:
    """numpy array or tensor -> fp32 tensor on device (default: where it is)."""
    if not torch.is_tensor(a):
        a = torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))
    return a.to(device=device, dtype=torch.float32)


def _scores(q, r, qn):
    rn = torch.sum(r * r, dim=-1)
    return qn[:, None] + rn[None, :] - 2.0 * (q @ r.T)


def l2_topk(queries, refs, k: int, chunk: int = 262144,
            device: torch.device | str | None = None, select=smallest_k):
    """Exact top-k by squared L2.  queries [Q,D], refs [N,D] (numpy or
    tensors) -> (dists [Q,k] f32, ids [Q,k] int64) sorted ascending; ties
    go to the lower id; with fewer than k refs the tail is _BIG / -1.
    select(scores, k) picks each score tile's k: any function with
    smallest_k's answer."""
    q = as_f32(queries, device)
    r = as_f32(refs, q.device)
    n = r.shape[0]
    k_eff = min(k, n)
    qn = torch.sum(q * q, dim=-1)
    if n <= chunk:
        d, i = select(_scores(q, r, qn), k_eff)
    else:
        d = torch.full((q.shape[0], k_eff), _BIG, dtype=torch.float32, device=q.device)
        i = torch.zeros((q.shape[0], k_eff), dtype=torch.int64, device=q.device)
        for start in range(0, n, chunk):
            dc, ic = select(_scores(q, r[start : start + chunk], qn), k_eff)
            d, i = merge_smallest_k(d, i, dc, ic + start, k_eff)
    if k_eff < k:
        pad = k - k_eff
        d = torch.cat([d, torch.full((d.shape[0], pad), _BIG, dtype=d.dtype,
                                     device=d.device)], dim=1)
        i = torch.cat([i, torch.full((i.shape[0], pad), -1, dtype=i.dtype,
                                     device=i.device)], dim=1)
    return d, i
