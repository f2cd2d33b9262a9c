"""Smith-Waterman local alignment scores, batched over pairs.

Counterpart of ``deepreadmapper_tpu/ops/sw.py`` and ``ops/sw_pallas.py``
(the parity target there is the reference's calc_sw_score): match +1,
mismatch -1, linear gap -1, score = the max DP cell, comparing raw bytes, so
the '<'/'>' wrap bytes of a wrapped read simply mismatch.

Bytes past a row's true length are replaced by sentinels (254 in ``a``, 255
in ``b``) that never match, so cells outside the true region stay below the
running max and the padded DP equals the true-length DP.  The two sentinel
values are reserved, as in the JAX package.

:func:`sw_scores` runs ``csrc/sw_score.cu`` on CUDA tensors and the plain
wavefront :func:`sw_scores_reference` on CPU tensors.
"""

from __future__ import annotations

import torch

from deepreadmapper_tpu_torch import kernels

_PAD_A = 254
_PAD_B = 255

_KT = 128       # pairs per block (csrc/sw_score.cu THREADS)
_MAX_LR = 512   # longest a row the kernel's shared memory holds


def _pack(mat: torch.Tensor, lens: torch.Tensor, pad: int) -> torch.Tensor:
    """Replace bytes past each row's length with the sentinel."""
    cols = torch.arange(mat.shape[1], device=mat.device)[None, :]
    return torch.where(cols >= lens[:, None], torch.tensor(pad, dtype=mat.dtype,
                                                           device=mat.device), mat)


def _sw_batch(av: torch.Tensor, bflip: torch.Tensor, lr: int, lc: int) -> torch.Tensor:
    """Anti-diagonal wavefront (the ``_sw_batch`` counterpart).  av [n, lr+1]
    int32 row bytes with a sentinel at column 0; bflip [n, 2lr+lc+2] int32
    with bflip[:, lr+lc+1-t] = b[t] (1-based).  Returns the max cell [n]."""
    n, width = av.shape
    zeros = torch.zeros((n, width), dtype=torch.int32, device=av.device)
    h1 = h2 = zeros
    best = torch.zeros(n, dtype=torch.int32, device=av.device)
    pad = torch.zeros((n, 1), dtype=torch.int32, device=av.device)
    for d in range(2, lr + lc + 1):
        bv = bflip[:, lr + lc + 1 - d : lr + lc + 1 - d + width]
        s = torch.where(av == bv, 1, -1)
        h2s = torch.cat([pad, h2[:, :-1]], dim=1)  # H[i-1, j-1]
        h1s = torch.cat([pad, h1[:, :-1]], dim=1)  # H[i-1, j]
        h = torch.maximum(torch.clamp(h2s + s, min=0),
                          torch.maximum(h1s, h1) - 1)
        best = torch.maximum(best, h.amax(dim=1))
        h2, h1 = h1, h
    return best


def sw_scores_reference(a_mat, a_lens, b_mat, b_lens, chunk: int = 8192):
    """Plain version of the kernel.  a_mat [P, lr] / b_mat [P, lc] uint8 with
    per-row true lengths [P] -> int32 [P], on the inputs' device."""
    dev = a_mat.device
    p, lr = a_mat.shape
    lc = b_mat.shape[1]
    out = torch.zeros(p, dtype=torch.int32, device=dev)
    if p == 0:
        return out
    a = _pack(a_mat, a_lens.to(dev), _PAD_A).to(torch.int32)
    b = _pack(b_mat, b_lens.to(dev), _PAD_B).to(torch.int32)
    av = torch.full((p, lr + 1), _PAD_A, dtype=torch.int32, device=dev)
    av[:, 1:] = a
    # width 2lr+lc+2 keeps the slice of the smallest diagonal in bounds
    bflip = torch.full((p, 2 * lr + lc + 2), _PAD_B, dtype=torch.int32, device=dev)
    bflip[:, lr + 1 : lr + lc + 1] = torch.flip(b, dims=[1])
    for s in range(0, p, chunk):
        out[s : s + chunk] = _sw_batch(av[s : s + chunk], bflip[s : s + chunk], lr, lc)
    return out


def sw_scores(a_mat: torch.Tensor, a_lens: torch.Tensor, b_mat: torch.Tensor,
              b_lens: torch.Tensor) -> torch.Tensor:
    """Batched SW scores: csrc/sw_score.cu on CUDA tensors, the plain version
    on CPU tensors.  a_mat [P, lr] / b_mat [P, lc] uint8, lengths [P] (any
    integer type; clipped to [0, width]) -> int32 [P]."""
    if a_mat.dtype != torch.uint8 or b_mat.dtype != torch.uint8:
        raise TypeError(f"sw_scores takes uint8 bytes, got {a_mat.dtype}, {b_mat.dtype}")
    if a_mat.dim() != 2 or b_mat.dim() != 2:
        raise ValueError("sw_scores needs 2-D byte matrices")
    p = a_mat.shape[0]
    if b_mat.shape[0] != p or a_lens.shape != (p,) or b_lens.shape != (p,):
        raise ValueError(
            f"sw_scores: {p} a rows, {b_mat.shape[0]} b rows, lengths "
            f"{tuple(a_lens.shape)} / {tuple(b_lens.shape)}"
        )
    dev = a_mat.device
    if b_mat.device != dev:
        raise ValueError(f"a_mat on {dev}, b_mat on {b_mat.device}")
    if dev.type == "cpu":
        return sw_scores_reference(a_mat, a_lens, b_mat, b_lens)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    lr, lc = a_mat.shape[1], b_mat.shape[1]
    if lr > _MAX_LR:
        raise ValueError(f"sw_score kernel holds a rows up to {_MAX_LR} bytes, got {lr}")
    out = torch.empty(p, dtype=torch.int32, device=dev)
    if p == 0:
        return out
    a_mat = a_mat.contiguous()
    b_mat = b_mat.contiguous()
    la = a_lens.to(device=dev, dtype=torch.int32).contiguous()
    lb = b_lens.to(device=dev, dtype=torch.int32).contiguous()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        kernels.SW_SCORE.launch(
            a_mat.data_ptr(), la.data_ptr(), b_mat.data_ptr(), lb.data_ptr(),
            out.data_ptr(), p, lr, lc, stream,
        )
    return out
