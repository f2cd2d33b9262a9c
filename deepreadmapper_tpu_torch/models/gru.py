"""Fused input projection + GRU recurrence, forward only.

Counterpart of ``deepreadmapper_tpu/models/gru_pallas.py`` (``gru_proj_seq``
and ``gru_proj_last``).  Same layout contract:

  x    [T, B, din]  time-major layer input, fp32 or bf16
  hs   [T, B, 64]   hidden state after step t, in ORIGINAL time positions
                    for both directions, in x's dtype
  hT   [B, 64]      final carry (== hs[-1] forward, hs[0] reverse), fp32

Parameters: w [din, 192], bzr [192] (bz, br, Wbh), r [64, 192], rbh [64].
Gate math and the carry are fp32 whatever the input dtype.

On CUDA tensors both entries launch the hand-written kernel
``csrc/gru_fwd.cu``; on CPU tensors they run :func:`gru_reference`, the plain
version.  No other device is accepted.
"""

from __future__ import annotations

import torch

from deepreadmapper_tpu_torch import kernels

H = 64
G = 3 * H


def gru_reference(x, w, bzr, r, rbh, reverse: bool, last_only: bool):
    """Plain version: transcribes gru_pallas._scan_proj_impl.  bf16 inputs
    are upcast, the projection is one matmul over all steps, and the
    recurrence is a Python loop over time."""
    t_steps, b, din = x.shape
    in_dt = x.dtype
    f32 = torch.float32
    x, w, bzr, r, rbh = (a.to(f32) for a in (x, w, bzr, r, rbh))
    gx = (x.reshape(t_steps * b, din) @ w + bzr).reshape(t_steps, b, G)
    h = torch.zeros((b, H), dtype=f32, device=x.device)
    hs = torch.empty((t_steps, b, H), dtype=f32, device=x.device)
    steps = range(t_steps - 1, -1, -1) if reverse else range(t_steps)
    for t in steps:
        gh = h @ r
        gxt = gx[t]
        z = torch.sigmoid(gxt[:, :H] + gh[:, :H])
        rg = torch.sigmoid(gxt[:, H : 2 * H] + gh[:, H : 2 * H])
        n = torch.tanh(gxt[:, 2 * H :] + rg * (gh[:, 2 * H :] + rbh))
        h = (1.0 - z) * n + z * h
        hs[t] = h
    if last_only:
        return h
    return hs.to(in_dt)


def _check(x, w, bzr, r, rbh):
    if x.dim() != 3:
        raise ValueError(f"x must be [T, B, din], got {tuple(x.shape)}")
    din = x.shape[2]
    shapes = {"w": (w, (din, G)), "bzr": (bzr, (G,)), "r": (r, (H, G)),
              "rbh": (rbh, (H,))}
    for name, (a, shape) in shapes.items():
        if tuple(a.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(a.shape)}")
        if a.device != x.device:
            raise ValueError(f"{name} is on {a.device}, x on {x.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")


def _launch(x, w, bzr, r, rbh, reverse: bool, last_only: bool):
    """Run csrc/gru_fwd.cu on CUDA tensors; allocates the output."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"gru kernel takes fp32 or bf16 x, got {x.dtype}")
    t_steps, b, din = x.shape
    if din % 4:
        raise ValueError(f"gru kernel needs din % 4 == 0, got {din}")
    x = x.contiguous()
    params = [a.to(torch.float32).contiguous() for a in (w, bzr, r, rbh)]
    if last_only:
        out = torch.empty((b, H), dtype=torch.float32, device=x.device)
        hs_ptr, hl_ptr = None, out.data_ptr()
    else:
        out = torch.empty((t_steps, b, H), dtype=x.dtype, device=x.device)
        hs_ptr, hl_ptr = out.data_ptr(), None
    if b == 0 or t_steps == 0:
        return out.zero_()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        kernels.GRU_FWD.launch(
            x.data_ptr(), *(p.data_ptr() for p in params), hs_ptr, hl_ptr,
            t_steps, b, din, int(reverse), int(x.dtype == torch.bfloat16),
            stream,
        )
    return out


def _dispatch(x, w, bzr, r, rbh, reverse: bool, last_only: bool):
    _check(x, w, bzr, r, rbh)
    if x.is_cuda:
        return _launch(x, w, bzr, r, rbh, reverse, last_only)
    return gru_reference(x, w, bzr, r, rbh, reverse, last_only)


def gru_proj_seq(x, w, bzr, r, rbh, reverse: bool) -> torch.Tensor:
    """Fused projection + recurrence, all hidden states:
    x [T,B,din] -> hs [T,B,64] in original positions, in x's dtype."""
    return _dispatch(x, w, bzr, r, rbh, reverse, last_only=False)


def gru_proj_last(x, w, bzr, r, rbh, reverse: bool) -> torch.Tensor:
    """Fused projection + recurrence, final hidden only: -> hT [B,64] fp32."""
    return _dispatch(x, w, bzr, r, rbh, reverse, last_only=True)
