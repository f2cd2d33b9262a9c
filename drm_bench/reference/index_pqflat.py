"""The PQFLAT index as the judge reads it: a codebook of 2^nbits centroids
in each of m_pq sub-spaces, trained by k-means on an evenly spaced sample
of the windows, and the codes of every window at the configuration's
stride (positions 0, s, 2s, ..., both strands), its nearest centroid in
each sub-space (reference/pq.py).  The judge finds this file by the
configuration's index_type.

The codebook.  k-means on windows of a random genome has no clusters to
settle in: a last-bit difference between the two sides' embeddings flips a
near-tie assignment and the iterations carry it on, so two sound fp32
trainings end with centroids apart.  What they share is how well the
codebook quantizes the sample: ``kmeans_excess`` is the k-means objective
of the program's centroids over the reference's own training sample,
relative to that of the reference's own k-means from the same start, less
one.  A shortened training (fewer iterations, a smaller sample) reads well
above the spread of sound runs.

The codes are then judged against the program's codebook, which that
number has judged: a code counts as right when the window's embedding lies
within ``eps`` (in the int8 codebook's steps of 1/127) of the boundary
between the given centroid and the nearest one; ``index_gap`` is the
widest such distance.  The reference rebuilds the int8 codebook the scan
reconstructs rows from, and scans the program's choice at those boundaries
and its own codes everywhere else.
"""

from __future__ import annotations

import numpy as np
import torch

from drm_bench.reference import pq as ref_pq
from drm_bench.reference import scan as ref_scan


def program_state(engine) -> dict:
    """What the judge reads of the program's engine: codes and centroids."""
    return {"codes": engine.codes, "centroids": engine.codebook.centroids.cpu().numpy()}


def _train(enc, genome: torch.Tensor, cfg: dict):
    """(training rows, the reference's own centroids)."""
    ref_len = int(cfg["ref_len"])
    pos = ref_pq.sample_positions(genome.numel(), ref_len, int(cfg["stride"]),
                                  float(cfg["sample_rate"]), int(cfg["train_rows"]))
    train = torch.cat([e for _, e in ref_scan.window_embeddings(enc, genome, ref_len, pos)])
    cent = ref_pq.kmeans(train, int(cfg["m_pq"]), int(cfg["nbits"]),
                         int(cfg["kmeans_iters"]), int(cfg["pq_seed"]))
    return train, cent


def reference_state(enc, genome: torch.Tensor, cfg: dict) -> dict:
    """The reference's own index (for the control)."""
    train, cent = _train(enc, genome, cfg)
    del train
    m = cent.shape[0]
    parts = []
    ref_len = int(cfg["ref_len"])
    pos = ref_scan.index_positions(genome.numel(), ref_len, int(cfg["stride"]))
    for _, e in ref_scan.window_embeddings(enc, genome, ref_len, pos):
        xs = e.reshape(e.shape[0], m, -1).transpose(0, 1)
        d2 = ((xs * xs).sum(-1, keepdim=True) - 2 * xs @ cent.transpose(1, 2)
              + (cent * cent).sum(-1)[:, None, :])
        parts.append(torch.argmin(d2, dim=-1).T.to(torch.uint8))
    return {"codes": torch.cat(parts).cpu().numpy(), "centroids": cent.cpu().numpy()}


def _index(codes: torch.Tensor, centroids) -> ref_scan.Index:
    c8, scale = ref_pq.int8_codebook(centroids)
    cent8 = torch.from_numpy(c8).to(codes.device)
    return ref_scan.Index(codes, scale, lambda flat: ref_pq.reconstruct8(flat, cent8))


def index_of(state: dict, device) -> ref_scan.Index:
    return _index(torch.from_numpy(state["codes"]).to(device), state["centroids"])


def judge(enc, genome: torch.Tensor, cfg: dict, state: dict, eps: float,
          numbers: dict, info: dict) -> ref_scan.Index:
    """Train again, embed every window of the index again and judge the
    program's codebook (numbers["kmeans_excess"]) and codes
    (numbers["index_gap"]); returns the index the reference scans."""
    dev = genome.device
    ref_len = int(cfg["ref_len"])
    pos = ref_scan.index_positions(genome.numel(), ref_len, int(cfg["stride"]))
    codes = state["codes"]
    if codes.shape[0] != 2 * pos.size:
        raise AssertionError(f"index holds {codes.shape[0]} rows, the genome has "
                             f"{2 * pos.size} at stride {cfg['stride']}")
    cent = torch.from_numpy(np.asarray(state["centroids"], np.float32)).to(dev)
    train, own_cent = _train(enc, genome, cfg)
    own_j = ref_pq.objective(train, own_cent)
    numbers["kmeans_excess"] = ref_pq.objective(train, cent) / own_j - 1.0
    info["kmeans_objective"] = own_j
    info["train_rows"] = int(train.shape[0])
    del train
    info["centroid_gap_p50_max"] = [float(x) for x in torch.quantile(
        torch.linalg.vector_norm(own_cent.double() - cent.double(), dim=-1).flatten(),
        torch.tensor([0.5, 1.0], dtype=torch.float64, device=dev)) * 127.0]
    adopted = torch.empty(codes.shape, dtype=torch.uint8, device=dev)
    gap_max, n_diff = 0.0, 0
    for r0, emb in ref_scan.window_embeddings(enc, genome, ref_len, pos):
        prog = torch.from_numpy(codes[r0 : r0 + emb.shape[0]]).to(dev)
        own, gap = ref_pq.code_gap(emb, cent, prog)
        own = own.to(torch.uint8)
        gap_max = max(gap_max, float(gap.max()))
        n_diff += int((own != prog).sum())
        adopted[r0 : r0 + emb.shape[0]] = torch.where(gap <= eps, prog, own)
    numbers["index_gap"] = gap_max
    info["index_codes_unequal"] = n_diff
    return _index(adopted, state["centroids"])
