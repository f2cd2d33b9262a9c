"""Fused input projection + GRU recurrence, and its gradient.

Counterpart of ``deepreadmapper_tpu/models/gru_pallas.py`` (``gru_proj_seq``
and ``gru_proj_last`` with their manual backward).  Same layout contract:

  x    [T, B, din]  time-major layer input, fp32 or bf16
  hs   [T, B, 64]   hidden state after step t, in ORIGINAL time positions
                    for both directions, in x's dtype
  hT   [B, 64]      final carry (== hs[-1] forward, hs[0] reverse), fp32

Parameters: w [din, 192], bzr [192] (bz, br, Wbh), r [64, 192], rbh [64].
Gate math and the carry are fp32 whatever the input dtype.

On CUDA tensors both entries launch the hand-written kernel
``csrc/gru_fwd.cu``; on CPU tensors they run :func:`gru_reference`, the plain
version.  No other device is accepted.

With grad enabled and an input that requires grad, both entries go through
an autograd Function whose backward is :func:`bwd_manual`: the gates are
recomputed in parallel from the saved hidden states, the cotangent
recurrence (the only sequential part) is :func:`gru_bwd` (the kernel
``csrc/gru_bwd.cu`` on CUDA tensors, :func:`gru_bwd_reference` on CPU
tensors), and the weight and input gradients are batched matmuls over all
steps.  Under ``no_grad`` the entries call the forward directly and save
nothing.
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


def gru_bwd_reference(h_prev, z, r, n, gnb, ct, rT, reverse: bool = False):
    """Plain version of the cotangent recurrence: transcribes the lax.scan
    branch of gru_pallas._bwd_manual as a Python loop over time.  Inputs
    [T,B,64] fp32 and rT [192,64]; returns (dgx [T,B,192], dghn [T,B,64])
    fp32.  The JAX recurrence's dgh [T,B,192] is cat(dgx[..., :128], dghn):
    its first 128 columns repeat dgx's, so only the last 64 are returned.
    The walk runs t = T-1 .. 0, or t = 0 .. T-1 for a reverse-direction GRU."""
    t_steps, b, _ = z.shape
    lam = torch.zeros((b, H), dtype=torch.float32, device=z.device)
    dgx = torch.empty((t_steps, b, G), dtype=torch.float32, device=z.device)
    dghn = torch.empty((t_steps, b, H), dtype=torch.float32, device=z.device)
    steps = range(t_steps) if reverse else range(t_steps - 1, -1, -1)
    for t in steps:
        zt, rt, nt = z[t], r[t], n[t]
        d = lam + ct[t]  # total cotangent on h_t
        dz = d * (h_prev[t] - nt)
        dn = d * (1.0 - zt)
        dgn = dn * (1.0 - nt * nt)
        dr = dgn * gnb[t]
        dgh_n = dgn * rt
        dgz = dz * zt * (1.0 - zt)
        dgr = dr * rt * (1.0 - rt)
        dgx[t] = torch.cat([dgz, dgr, dgn], dim=-1)
        dghn[t] = dgh_n
        lam = d * zt + torch.cat([dgz, dgr, dgh_n], dim=-1) @ rT
    return dgx, dghn


def _launch_bwd(ins, rT, reverse: bool):
    """Run csrc/gru_bwd.cu on CUDA tensors; allocates the outputs.  The
    kernel copies its inputs in 16-byte pieces, so an input that starts off
    a 16-byte boundary (a view into a larger tensor) is copied first."""
    t_steps, b, _ = ins[0].shape
    dgx = torch.empty((t_steps, b, G), dtype=torch.float32, device=rT.device)
    dghn = torch.empty((t_steps, b, H), dtype=torch.float32, device=rT.device)
    if b == 0 or t_steps == 0:
        return dgx, dghn
    ins = [a if a.data_ptr() % 16 == 0 else a.clone() for a in ins]
    with torch.cuda.device(rT.device):
        stream = torch.cuda.current_stream(rT.device).cuda_stream
        kernels.GRU_BWD.launch(
            *(a.data_ptr() for a in ins), rT.data_ptr(), dgx.data_ptr(),
            dghn.data_ptr(), t_steps, b, int(reverse), stream,
        )
    return dgx, dghn


def gru_bwd(h_prev, z, r, n, gnb, ct, rT, reverse: bool = False):
    """Cotangent recurrence of one GRU call: (h_prev, z, r, n, gnb, ct)
    [T,B,64] fp32 and rT [192,64] fp32 -> (dgx [T,B,192], dghn [T,B,64])
    fp32, as gru_bwd_reference.  The kernel on CUDA tensors, the plain
    version on CPU tensors."""
    ins = (h_prev, z, r, n, gnb, ct)
    shape = tuple(z.shape)
    if len(shape) != 3 or shape[2] != H:
        raise ValueError(f"gates must be [T, B, {H}], got {shape}")
    for a in (*ins, rT):
        if a.dtype != torch.float32:
            raise TypeError(f"gru_bwd takes fp32 tensors, got {a.dtype}")
        if a.device != z.device:
            raise ValueError(f"inputs on {a.device} and {z.device}")
    if any(tuple(a.shape) != shape for a in ins) or tuple(rT.shape) != (G, H):
        raise ValueError(f"gru_bwd shapes: {[tuple(a.shape) for a in (*ins, rT)]}")
    if z.is_cuda:
        return _launch_bwd([a.contiguous() for a in ins], rT.contiguous(), reverse)
    if z.device.type != "cpu":
        raise ValueError(f"unsupported device {z.device}")
    return gru_bwd_reference(*ins, rT, reverse)


def recompute_gates(x, w, bzr, r, rbh, hs, reverse: bool):
    """The inputs of the cotangent recurrence, (h_prev, z, r, n, gnb)
    [T,B,64], recomputed in parallel from one GRU call's fp32 inputs and its
    hidden states hs (original positions), in the forward step's op order.
    The reverse direction's h_prev at t is hs[t+1]."""
    t_steps, b, din = x.shape
    h_prev = torch.zeros_like(hs)
    if reverse:
        h_prev[:-1] = hs[1:]
    else:
        h_prev[1:] = hs[:-1]
    gx = (x.reshape(t_steps * b, din) @ w + bzr).reshape(t_steps, b, G)
    gh = h_prev @ r
    z = torch.sigmoid(gx[..., :H] + gh[..., :H])
    rg = torch.sigmoid(gx[..., H : 2 * H] + gh[..., H : 2 * H])
    gnb = gh[..., 2 * H :] + rbh  # the r-gated recurrent term of n
    n = torch.tanh(gx[..., 2 * H :] + rg * gnb)
    return h_prev, z, rg, n, gnb


def bwd_manual(x, w, bzr, r, rbh, reverse: bool, hs, ct_seq):
    """Gradients (dx, dw, dbzr, dr, drbh) of one GRU call from its saved
    hidden states hs [T,B,64] (original positions) and their cotangent;
    counterpart of gru_pallas._bwd_manual.  Runs in fp32; each gradient
    comes back in its input's dtype.  The reverse direction is walked by
    index (no flips)."""
    in_dts = (x.dtype, w.dtype, bzr.dtype, r.dtype, rbh.dtype)
    f32 = torch.float32
    xf, wf, bzrf, rf, rbhf, hsf, ct = (
        a.to(f32) for a in (x, w, bzr, r, rbh, hs, ct_seq)
    )
    t_steps, b, din = xf.shape
    h_prev, z, rg, n, gnb = recompute_gates(xf, wf, bzrf, rf, rbhf, hsf, reverse)

    # -- the sequential cotangent recurrence
    dgx, dghn = gru_bwd(h_prev, z, rg, n, gnb, ct, rf.T, reverse)
    del z, rg, n, gnb

    # -- hoisted contractions over all steps; dgh = cat(dgx[..., :128], dghn)
    dgx2 = dgx.reshape(t_steps * b, G)
    dghn2 = dghn.reshape(t_steps * b, H)
    hp2t = h_prev.reshape(t_steps * b, H).T
    dx = (dgx2 @ wf.T).reshape(t_steps, b, din)
    dw = xf.reshape(t_steps * b, din).T @ dgx2
    dbzr = dgx2.sum(0)
    dr = torch.cat([hp2t @ dgx2[:, : 2 * H], hp2t @ dghn2], 1)
    drbh = dghn2.sum(0)
    grads = (dx, dw, dbzr, dr, drbh)
    return tuple(g.to(dt) for g, dt in zip(grads, in_dts))


class _ProjSeq(torch.autograd.Function):
    """gru_proj_seq with the manual backward; saves its output hs."""

    @staticmethod
    def forward(ctx, x, w, bzr, r, rbh, reverse):
        hs = _dispatch(x, w, bzr, r, rbh, reverse, last_only=False)
        ctx.save_for_backward(x, w, bzr, r, rbh, hs)
        ctx.reverse = reverse
        return hs

    @staticmethod
    def backward(ctx, ct):
        *primals, hs = ctx.saved_tensors
        return (*bwd_manual(*primals, ctx.reverse, hs, ct), None)


class _ProjLast(torch.autograd.Function):
    """gru_proj_last with the manual backward; recomputes hs with the
    forward (kernel #1 on CUDA tensors) rather than keep it."""

    @staticmethod
    def forward(ctx, x, w, bzr, r, rbh, reverse):
        ctx.save_for_backward(x, w, bzr, r, rbh)
        ctx.reverse = reverse
        return _dispatch(x, w, bzr, r, rbh, reverse, last_only=True)

    @staticmethod
    def backward(ctx, ct):
        x, w, bzr, r, rbh = ctx.saved_tensors
        hs = _dispatch(x, w, bzr, r, rbh, ctx.reverse, last_only=False)
        # the hT cotangent sits at the recurrence's last step: original
        # position T-1 forward, 0 reverse
        ct_seq = torch.zeros(hs.shape, dtype=ct.dtype, device=ct.device)
        ct_seq[0 if ctx.reverse else hs.shape[0] - 1] = ct
        return (*bwd_manual(x, w, bzr, r, rbh, ctx.reverse, hs, ct_seq), None)


def _needs_grad(*args) -> bool:
    return torch.is_grad_enabled() and any(a.requires_grad for a in args)


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
    if _needs_grad(x, w, bzr, r, rbh):
        return _ProjSeq.apply(x, w, bzr, r, rbh, reverse)
    return _dispatch(x, w, bzr, r, rbh, reverse, last_only=False)


def gru_proj_last(x, w, bzr, r, rbh, reverse: bool) -> torch.Tensor:
    """Fused projection + recurrence, final hidden only: -> hT [B,64] fp32."""
    if _needs_grad(x, w, bzr, r, rbh):
        return _ProjLast.apply(x, w, bzr, r, rbh, reverse)
    return _dispatch(x, w, bzr, r, rbh, reverse, last_only=True)
