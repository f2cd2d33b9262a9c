"""Index-sharded exact search with a top-k merge over the shards.

Counterpart of ``deepreadmapper_tpu/parallel/sharded_search.py``.  The
reference rows split evenly over the mesh's 'shard' axis; each shard
computes its exact top-k on its own device (``ops.topk.l2_topk``) with ids
offset into the global space, and one stable ``smallest_k`` over the
shard-major concatenation merges them.  That is ``lax.top_k``'s order over
the JAX package's tiled all_gather: equal distances go to the lower shard,
then to the lower id.
"""

from __future__ import annotations

import torch

from deepreadmapper_tpu_torch.ops.topk import l2_topk, smallest_k
from deepreadmapper_tpu_torch.parallel.mesh import Mesh


def sharded_l2_topk(queries, refs, k: int, mesh: Mesh):
    """queries [Q, D], refs [N, D] (numpy or tensors; N must divide by the
    shard axis -- pad beforehand if needed).  Returns (dists [Q, k] fp32,
    global ids [Q, k] int64), on the CPU."""
    n_shard = mesh.shape["shard"]
    n = refs.shape[0]
    if n % n_shard:
        raise ValueError(f"refs rows {n} not divisible by shard axis {n_shard}")
    shard_rows = n // n_shard
    ds, ids = [], []
    for s in range(n_shard):
        d, i = l2_topk(queries, refs[s * shard_rows:(s + 1) * shard_rows],
                       min(k, shard_rows), device=mesh.shard_device(s))
        ds.append(d.cpu())
        ids.append(i.cpu() + s * shard_rows)
    d_all, i_all = torch.cat(ds, dim=1), torch.cat(ids, dim=1)
    vals, pos = smallest_k(d_all, k)
    return vals, torch.gather(i_all, 1, pos)
