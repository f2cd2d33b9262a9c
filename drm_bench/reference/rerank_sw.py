"""The Smith-Waterman rerank as the judge reads it (a request's rerank
"sw"; the judge finds this file by that name): every candidate of a read
(reference/scan.candidates) scored by Smith-Waterman against the wrapped
read (reference/sw.py), the highest first, stably, missing candidates
last; the first k kept.  Scores are integers, so a read's SAM lines are
right when they equal those of the reference's order."""

from __future__ import annotations

import numpy as np
import torch

from drm_bench.reference import encoder as ref_enc
from drm_bench.reference import sam as ref_sam
from drm_bench.reference import scan as ref_scan
from drm_bench.reference import sw as ref_sw
from drm_bench.roofline import sw_score


def sw_order(genome: torch.Tensor, ref_len: int, reads: np.ndarray, ids: np.ndarray):
    """Candidate ids [n, c] reordered by Smith-Waterman score against the
    wrapped reads, highest first, stable; missing candidates last."""
    dev = genome.device
    n, c = ids.shape
    flat = torch.from_numpy(ids.reshape(-1)).to(dev)
    valid = flat >= 0
    pos = torch.clamp(flat, min=0) >> 1
    j = torch.arange(ref_len, device=dev)[None, :]
    comp = torch.from_numpy(ref_scan._COMP).to(dev)
    fwd = genome[pos[:, None] + j]
    rev = comp[genome[pos[:, None] + ref_len - 1 - j].long()]
    win = torch.where((flat & 1).bool()[:, None], rev, fwd)
    mat, lens = ref_enc.wrap_reads(reads)
    qa = torch.from_numpy(np.repeat(mat, c, axis=0)).to(dev)
    ql = torch.from_numpy(np.repeat(lens, c)).to(dev)
    s = ref_sw.sw_scores(win, torch.full((n * c,), ref_len, device=dev), qa, ql)
    s = torch.where(valid, s.long(), torch.iinfo(torch.int64).min // 2).view(n, c)
    order = torch.sort(-s, dim=1, stable=True).indices.cpu().numpy()
    return np.take_along_axis(ids, order, axis=1)


def order(env: dict, raw: np.ndarray, reads: np.ndarray, emb) -> np.ndarray:
    """The reference's final ids [n, k] of npy rows raw (emb unused)."""
    cand = ref_scan.candidates(raw, env["stride"], env["k"], env["bound"])
    return sw_order(env["genome"], env["ref_len"], reads, cand)[:, : env["k"]]


def judge_sam(env: dict, raw, reads, emb, names, seqs, got):
    """(reads whose lines are wrong [n] bool, numbers added, diagnostics)."""
    final = order(env, raw, reads, emb)
    return np.array(ref_sam.unequal(names, seqs, got, final), bool), {}, {}


def limits(cfg: dict) -> dict:
    return {}


def least_s(ctx, reads: int) -> dict:
    """The least time of the window's Smith-Waterman cells: every candidate
    pair a read has, the k_clusters of a dense row (k, which the pipeline
    sets k_clusters to at stride 1) or the valid slots of a sparse row's
    expansion, read from each completed request's indices.npy."""
    cfg, req = ctx.config, ctx.traffic["request"]
    stride = int(cfg["stride"])
    if stride == 1:
        pairs = reads * int(req["k"])
    else:
        bound = 2 * ref_scan.num_windows(int(cfg["genome_bp"]), int(cfg["ref_len"]))
        pairs = sum(int((ref_scan.candidates(ref_scan.load_ids(r["out"]), stride,
                                             int(req["k"]), bound) >= 0).sum())
                    for r in ctx.replies if r["ok"])
    return {sw_score.KERNEL: sw_score.least_s(pairs, int(cfg["ref_len"]),
                                              int(ctx.traffic["read_len"]) + 2)}
