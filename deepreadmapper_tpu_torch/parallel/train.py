"""Encoder fine-tuning step: InfoNCE + alignment, Adam.

Counterpart of ``deepreadmapper_tpu/parallel/train.py``.  A read's embedding
should match the embedding of its source genome window: InfoNCE over
L2-normalised embeddings with in-batch negatives, plus an L2 alignment
term.  ``params`` is the dict of :func:`models.encoder.torch_params` (leaf
tensors that require grad); the forward and backward of its four GRU calls
run the CUDA kernels on a GPU (``models.gru``).

One device.  The JAX package shards the batch over its whole mesh (pure
data parallelism with replicated params); the port's multi-card data
parallelism with ``torch.distributed`` waits as ROADMAP Queue A #14.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from deepreadmapper_tpu_torch.models.encoder import encode_tokens_impl, named_leaves


def leaves(params: dict) -> list[torch.Tensor]:
    """The params dict's tensors in the order of ``encoder.named_leaves``."""
    return [t for _, t in named_leaves(params)]


def make_optimizer(params: dict, lr: float = 1e-4) -> torch.optim.Adam:
    """Adam with optax.adam's defaults and formula (eps outside the square
    root, no eps_root)."""
    return torch.optim.Adam(leaves(params), lr=lr, betas=(0.9, 0.999), eps=1e-8)


def loss_fn(params: dict, read_tokens: torch.Tensor, window_tokens: torch.Tensor,
            temperature: float = 0.07) -> torch.Tensor:
    """InfoNCE between read embeddings and their source-window embeddings,
    with in-batch negatives; plus 0.1 x the mean squared distance."""
    re = encode_tokens_impl(params, read_tokens)
    we = encode_tokens_impl(params, window_tokens)
    re_n = re / (torch.linalg.vector_norm(re, dim=-1, keepdim=True) + 1e-6)
    we_n = we / (torch.linalg.vector_norm(we, dim=-1, keepdim=True) + 1e-6)
    logits = re_n @ we_n.T / temperature
    labels = torch.arange(logits.shape[0], device=logits.device)
    nce = F.cross_entropy(logits, labels)
    align = torch.mean(torch.sum((re - we) ** 2, dim=-1))
    return nce + 0.1 * align


def train_step(params: dict, opt: torch.optim.Optimizer, read_tokens: torch.Tensor,
               window_tokens: torch.Tensor) -> torch.Tensor:
    """One step in place on params and opt; returns the loss (a detached
    0-d tensor on the params' device, so the caller decides when to wait
    for it)."""
    opt.zero_grad(set_to_none=True)
    loss = loss_fn(params, read_tokens, window_tokens)
    loss.backward()
    opt.step()
    return loss.detach()
