"""Plain reference of the genome windows, the int8 quantization and the
exhaustive int8 scan, in plain PyTorch and NumPy.

Semantics (those of the reference mapper's INT8FLAT search as the port
defines them, docs of ``index/int8_flat.py`` and ``ops/scan_kernel.py``):

* Windows: every s-th position p = i s of the genome (s the index's
  stride, 1 for a dense index) gives two rows, 2i (the window as it
  stands) and 2i + 1 (its reverse complement); a row is tokenized as
  '<' + window + '>'.
* Codes: round(x / s) half to even, clipped to +-127, the division in fp32;
  the index scale is 1/127 (the encoder's outputs are tanh-bounded).
* Queries quantize with the code scale sc when they fit it, else with their
  own sq = max|q| / 127; the ratio r = sq / sc folds into the score.
* Score of a query q8 and a row r8: rn - 2r (q8 . r8) with rn = |r8|^2,
  rounded once to fp32; rows at or past ntotal never win.
* The card's scan (2^18 rows or more) keeps, for each window of 128 rows,
  the lowest score and the lowest row that has it, then the k lowest
  windows, ties to the lower window; distance = (score + r^2 |q8|^2) sc^2.
  Below 2^18 rows, or off the card, the k lowest rows, ties to the lower
  row; the score there carries r^2 |q8|^2 (rounded in fp32 as r*r*qn + rn)
  and distance = score sc^2.
"""

from __future__ import annotations

import numpy as np
import torch

INT8_SCALE = 1.0 / 127.0
W = 128
FUSED_MIN_ROWS = 1 << 18
_BIG = 3.4e38
_COMP = np.zeros(256, np.uint8)
for _a, _b in zip(b"ACGTN", b"TGCAN"):
    _COMP[_a] = _b


def window_rows(genome: torch.Tensor, positions: torch.Tensor, ref_len: int,
                width: int = 124) -> tuple[torch.Tensor, torch.Tensor]:
    """Wrapped byte rows [2n, width] of the windows at the given positions
    (forward, reverse complement interleaved) and their true lengths
    (ref_len + 2); genome is a uint8 ACGT tensor."""
    dev = genome.device
    body = min(ref_len, width - 1)
    pos = positions.to(dev).long()[:, None]
    j = torch.arange(body, device=dev)[None, :]
    comp = torch.from_numpy(_COMP).to(dev)
    n = pos.shape[0]
    mat = torch.zeros((2 * n, width), dtype=torch.uint8, device=dev)
    mat[:, 0] = ord("<")
    mat[0::2, 1 : 1 + body] = genome[pos + j]
    mat[1::2, 1 : 1 + body] = comp[genome[pos + ref_len - 1 - j].long()]
    if ref_len + 2 <= width:
        mat[:, ref_len + 1] = ord(">")
    return mat, torch.full((2 * n,), ref_len + 2, dtype=torch.int64, device=dev)


def num_windows(genome_len: int, ref_len: int) -> int:
    return max(0, genome_len - ref_len + 1)


def index_positions(genome_len: int, ref_len: int, stride: int) -> np.ndarray:
    """Positions of an index's windows: 0, s, 2s, ... up to
    (genome_len - ref_len) // s * s; row 2i + strand is the i-th."""
    if genome_len < ref_len:
        return np.zeros(0, np.int64)
    return np.arange((genome_len - ref_len) // stride + 1, dtype=np.int64) * stride


def load_ids(out_dir: str) -> np.ndarray:
    """A request's indices.npy as int64 (-1 where the row holds none)."""
    return np.load(f"{out_dir}/indices.npy").astype(np.uint64).view(np.int64)


def search_columns(cfg: dict, keys: dict) -> int:
    """Columns of a request's npy rows: k at stride 1, past it the
    k_clusters sparse hits (keys: the request's own keys)."""
    if int(cfg["stride"]) == 1:
        return int(keys["k"])
    return int(keys.get("k_clusters", cfg["k_clusters"]))


def candidates(raw: np.ndarray, stride: int, k: int, bound: int) -> np.ndarray:
    """The rerank's candidate dense ids [n, C] of npy rows raw [n, cols]
    (-1 where a slot holds none).  At stride 1 a row's first k.  Past it
    each sparse hit h expands to h s - (s - 1) ... h s + (s - 1), the
    reference mapper's post_processor.cpp:74-201 with ``actual_position =
    sparse_id * stride``; slots outside [0, bound), and every slot of a hit
    with h s >= bound or h < 0, hold none (bound: 2 x the genome's dense
    windows)."""
    if stride == 1:
        return raw[:, :k].astype(np.int64)
    hits = raw.astype(np.int64)
    ap = hits * stride
    cand = ap[:, :, None] + np.arange(-(stride - 1), stride, dtype=np.int64)
    ok = (hits >= 0)[:, :, None] & (ap < bound)[:, :, None] & (cand >= 0) & (cand < bound)
    return np.where(ok, cand, -1).reshape(raw.shape[0], -1)


def window_embeddings(enc, genome: torch.Tensor, ref_len: int, positions,
                      batch: int = 16384):
    """Yield (first row, fp32 embeddings [2n, 128]) over the windows at the
    given positions (an int64 array), in order."""
    from drm_bench.reference.encoder import tokenize

    positions = torch.from_numpy(np.asarray(positions, np.int64))
    for s in range(0, positions.numel(), batch):
        mat, lens = window_rows(genome, positions[s : s + batch], ref_len)
        yield 2 * s, enc(tokenize(mat, lens))


def embed_ids(enc, genome: torch.Tensor, ref_len: int, ids: np.ndarray,
              batch: int = 16384) -> torch.Tensor:
    """fp32 embeddings [n, 128] of the windows with the given dense ids
    (2 x position + strand, each >= 0), on the encoder's device."""
    from drm_bench.reference.encoder import tokenize

    ids = torch.from_numpy(np.asarray(ids, np.int64))
    outs = [torch.zeros((0, 128), device=enc.device)]
    for s in range(0, ids.numel(), batch):
        part = ids[s : s + batch].to(genome.device)
        mat, lens = window_rows(genome, part >> 1, ref_len)
        pick = 2 * torch.arange(part.numel(), device=genome.device) + (part & 1)
        outs.append(enc(tokenize(mat[pick], lens[pick])))
    return torch.cat(outs)


def quantize(x: torch.Tensor, scale: float) -> torch.Tensor:
    """fp32 -> int8 codes: round half to even, clipped to +-127."""
    s = torch.full((1,), scale, dtype=torch.float32, device=x.device)
    return torch.clamp(torch.round(x.float() / s), -127, 127).to(torch.int8)


def quantize_host(x: np.ndarray, scale) -> np.ndarray:
    return np.clip(np.round(np.asarray(x, np.float32) / np.float32(scale)),
                   -127, 127).astype(np.int8)


def rounding_gap(x: torch.Tensor, scale, codes: torch.Tensor) -> torch.Tensor:
    """How far (in code steps) each value x / scale lies outside the rounding
    cell of the given code: 0 when the code is a right rounding of x."""
    t = torch.clamp(x.double() / float(np.float32(scale)), -127.0, 127.0)
    return torch.clamp((t - codes.double()).abs() - 0.5, min=0.0)


def alternative_codes(x: np.ndarray, scale, eps: float):
    """For each value, the code on the other side of its nearest rounding
    boundary and whether that boundary lies within eps code steps."""
    t = np.clip(np.asarray(x, np.float64) / float(np.float32(scale)), -127.0, 127.0)
    c = quantize_host(x, scale).astype(np.int64)
    step = np.where(t >= c, 1, -1)
    near = (0.5 - np.abs(t - c)) < eps
    alt = np.clip(c + step, -127, 127)
    return alt.astype(np.int8), near & (alt != c)


def query_scale_ratio(qmax: np.float32, code_scale: float):
    """(sq, ratio) for a batch whose largest |value| is qmax."""
    sc = np.float32(code_scale)
    sq = max(sc, np.float32(qmax) / np.float32(127.0))
    return sq, np.float32(sq / sc)


def _fused(base: torch.Tensor, r2: torch.Tensor, dot: torch.Tensor) -> torch.Tensor:
    """base - r2 * dot, exact in float64, rounded once to fp32."""
    return (base.double() - r2 * dot.double()).float()


def _row_norms(r8: torch.Tensor) -> torch.Tensor:
    r = r8.to(torch.int32)
    return (r * r).sum(dim=1).float()


def _ratio_terms(ratio, n: int, dev):
    """Per-query (ratio fp32 tensor [Q], 2 ratio as float64 [Q])."""
    ratio = np.array(np.broadcast_to(np.asarray(ratio, np.float32), (n,)))
    rr = torch.from_numpy(np.ascontiguousarray(ratio)).to(dev)
    r2 = torch.from_numpy((np.float32(2.0) * ratio).astype(np.float64)).to(dev)
    return rr, r2


def _smallest(v: torch.Tensor, a: torch.Tensor, k: int):
    """The k smallest of each row of v [Q, n], ties to the earlier column,
    with the matching entries of a [Q, n]."""
    sv, pos = torch.sort(v, dim=1, stable=True)
    return sv[:, :k], torch.gather(a, 1, pos[:, :k])


def scan(q8: torch.Tensor, rows, n_rows: int, ntotal: int, ratio, k: int,
         windowed: bool, chunk: int = 65536, q_block: int = 8192):
    """q8 [Q, 128] int8; ratio, one a query (fp32); rows(start, end) ->
    int8 [end - start, 128] on q8's device for 0 <= start < end <= n_rows.
    Returns (scores [Q, k] fp32, row ids [Q, k] int64), both in the
    search's order.  Each chunk's k best are merged into the running k best
    with the earlier chunk first on ties, which is the order over all."""
    dev = q8.device
    rr_all, r2_all = _ratio_terms(ratio, q8.shape[0], dev)
    chunk = chunk // W * W
    out_s, out_i = [], []
    with torch.no_grad():
        for b0 in range(0, q8.shape[0], q_block):
            qb = q8[b0 : b0 + q_block]
            rr, r2 = rr_all[b0 : b0 + q_block], r2_all[b0 : b0 + q_block]
            qf = qb.float()
            qn = (qb.to(torch.int32) ** 2).sum(1).float()
            best_s = best_i = None
            for s in range(0, n_rows, chunk):
                e = min(s + chunk, n_rows)
                r8 = rows(s, e)
                rn = _row_norms(r8)
                ids = torch.arange(s, e, device=dev)
                dot = r8.float() @ qf.T  # [c, Q], exact integers
                if windowed:
                    rn = torch.where(ids < ntotal, rn, torch.full_like(rn, _BIG))
                    sc = _fused(rn[:, None], r2[None, :], dot)
                    pad = (-(e - s)) % W
                    if pad:
                        sc = torch.cat([sc, torch.full((pad, sc.shape[1]), _BIG, device=dev)])
                    s3 = sc.view(-1, W, sc.shape[1])
                    vmin = s3.amin(dim=1)
                    widx = torch.arange(W, dtype=torch.int32, device=dev)[None, :, None]
                    amin = torch.where(s3 == vmin[:, None, :], widx, 2**30).amin(dim=1)
                    base = torch.arange(s, s + s3.shape[0] * W, W, device=dev)[:, None]
                    v, a = vmin.T, (base + amin).T
                else:
                    bse = rr[None, :] * rr[None, :] * qn[None, :] + rn[:, None]
                    sc = _fused(bse, r2[None, :], dot)
                    v = torch.where((ids < ntotal)[:, None], sc, _BIG).T
                    a = ids[None, :].expand_as(v)
                cs, ci = _smallest(v.contiguous(), a.contiguous(), k)
                if best_s is None:
                    best_s, best_i = cs, ci
                else:
                    best_s, best_i = _smallest(torch.cat([best_s, cs], 1),
                                               torch.cat([best_i, ci], 1), k)
            out_s.append(best_s)
            out_i.append(best_i)
    if not out_s:
        return (torch.zeros((0, k), device=dev), torch.zeros((0, k), dtype=torch.int64,
                                                            device=dev))
    return torch.cat(out_s), torch.cat(out_i)


def score_rows(q8: torch.Tensor, r8: torch.Tensor, ratio, windowed: bool) -> torch.Tensor:
    """The scan's score of each query q8 [Q, 128] against its own rows
    r8 [Q, k, 128], or against the same rows r8 [k, 128] -> fp32 [Q, k]."""
    rr, r2 = _ratio_terms(ratio, q8.shape[0], q8.device)
    if r8.dim() == 2:
        dot = q8.double() @ r8.double().T
        rn = (r8.to(torch.int32) ** 2).sum(-1).float()[None, :]
    else:
        dot = torch.einsum("qd,qkd->qk", q8.double(), r8.double())
        rn = (r8.to(torch.int32) ** 2).sum(-1).float()
    if windowed:
        return _fused(rn, r2[:, None], dot)
    qn = (q8.to(torch.int32) ** 2).sum(1).float()
    return _fused(rr[:, None] * rr[:, None] * qn[:, None] + rn, r2[:, None], dot)


def distances(scores: np.ndarray, q8: np.ndarray, ratio, code_scale, windowed: bool):
    """The search's fp32 squared-L2 estimates from its scores (ratio, one a
    query)."""
    s2 = np.float32(code_scale) ** 2
    d = np.asarray(scores, np.float32)
    if windowed:
        qn = (q8.astype(np.int64) ** 2).sum(1).astype(np.float32)
        ratio = np.asarray(ratio, np.float32)
        d = d + ((ratio * ratio) * qn)[:, None]
    return d * s2


class Index:
    """An index as the scan scores it: codes [ntotal, c] and, where the
    codes are not the int8 rows themselves, expand(codes [n, c]) -> int8
    rows [n, 128]."""

    def __init__(self, codes: torch.Tensor, scale: float, expand=None):
        self.codes, self.scale, self.expand = codes, scale, expand
        self.ntotal = codes.shape[0]

    def rows(self, s: int, e: int) -> torch.Tensor:
        return self.rows_at(slice(s, e))

    def rows_at(self, ids) -> torch.Tensor:
        c = self.codes[ids]
        if self.expand is None:
            return c
        return self.expand(c.reshape(-1, c.shape[-1])).reshape(*c.shape[:-1], -1)
