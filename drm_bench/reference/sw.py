"""Plain reference of the Smith-Waterman score the rerank sorts by (the
reference mapper's calc_sw_score): local alignment of raw bytes, match +1,
mismatch -1, linear gap -1, the score being the best cell.  Plain PyTorch,
row by row: within a row the gap from the left is a running maximum,
H[i][j] = max_l<=j (E[l] - (j - l)) with E[j] = max(0, H[i-1][j-1] + s,
H[i-1][j] - 1).  Nothing of the port is imported.
"""

from __future__ import annotations

import torch


def sw_scores(a: torch.Tensor, a_lens: torch.Tensor, b: torch.Tensor,
              b_lens: torch.Tensor) -> torch.Tensor:
    """a [P, la], b [P, lb] uint8 with true lengths [P] -> int32 scores [P]."""
    p, la = a.shape
    lb = b.shape[1]
    dev = a.device
    if p == 0:
        return torch.zeros(0, dtype=torch.int32, device=dev)
    cols = torch.arange(lb, device=dev)
    bb = torch.where(cols[None, :] < b_lens.to(dev)[:, None], b.long(), -2)
    h_prev = torch.zeros((p, lb), dtype=torch.int32, device=dev)
    best = torch.zeros(p, dtype=torch.int32, device=dev)
    j = cols.to(torch.int32)[None, :]
    for i in range(la):
        ai = torch.where(i < a_lens.to(dev), a[:, i].long(), -1)
        s = torch.where(bb == ai[:, None], 1, -1).to(torch.int32)
        diag = torch.cat([torch.zeros((p, 1), dtype=torch.int32, device=dev),
                          h_prev[:, :-1]], dim=1)
        e = torch.clamp(torch.maximum(diag + s, h_prev - 1), min=0)
        h = torch.cummax(e + j, dim=1).values - j
        best = torch.maximum(best, h.amax(dim=1))
        h_prev = h
    return best
