"""Encoder fine-tuning step: InfoNCE + alignment, Adam.

Counterpart of ``deepreadmapper_tpu/parallel/train.py``.  A read's embedding
should match the embedding of its source genome window: InfoNCE over
L2-normalised embeddings with in-batch negatives, plus an L2 alignment
term.  ``params`` is the dict of :func:`models.encoder.torch_params` (leaf
tensors that require grad); the forward and backward of its four GRU calls
run the CUDA kernels on a GPU (``models.gru``).

The step is data-parallel over the ``torch.distributed`` group, the
counterpart of the JAX package's ``make_train_step(optimizer, mesh)``, which
shards the batch over the whole mesh with replicated params: each rank
holds a contiguous slice of the global batch and the loss is taken over the
GLOBAL batch.  Without a group (world size 1) the gather and the gradient
sum do nothing, and the step is the one-device step.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from deepreadmapper_tpu_torch.models.encoder import encode_tokens_impl, named_leaves
from deepreadmapper_tpu_torch.parallel import distributed as dist_


def leaves(params: dict) -> list[torch.Tensor]:
    """The params dict's tensors in the order of ``encoder.named_leaves``."""
    return [t for _, t in named_leaves(params)]


def make_optimizer(params: dict, lr: float = 1e-4) -> torch.optim.Adam:
    """Adam with optax.adam's defaults and formula (eps outside the square
    root, no eps_root)."""
    return torch.optim.Adam(leaves(params), lr=lr, betas=(0.9, 0.999), eps=1e-8)


def _with_own_rows(mine: torch.Tensor) -> torch.Tensor:
    """Every rank's rows in rank order, detached, with this rank's slot
    holding ``mine`` itself, so a backward reaches only this rank's rows."""
    b, r = mine.shape[0], dist_.rank()
    every = dist_.all_gather_cat(mine.detach())
    return torch.cat([every[:r * b], mine, every[(r + 1) * b:]])


def loss_fn(params: dict, read_tokens: torch.Tensor, window_tokens: torch.Tensor,
            temperature: float = 0.07) -> torch.Tensor:
    """InfoNCE between read embeddings and their source-window embeddings,
    with in-batch negatives; plus 0.1 x the mean squared distance.

    The tokens are this rank's slice of the global batch (rows
    [r B/W, (r+1) B/W), the contiguous split of the JAX batch sharding), and
    the loss is the GLOBAL batch's.  Each rank encodes only its rows and
    gathers the others' embeddings detached, so its backward gives its own
    rows' share of the gradient; the sum over the ranks is the one-process
    gradient.  (A gather that carries gradients,
    ``torch.distributed.nn.all_gather``, would sum every rank's copy of the
    loss in its backward: W times the gradient.)"""
    re = _with_own_rows(encode_tokens_impl(params, read_tokens))
    we = _with_own_rows(encode_tokens_impl(params, window_tokens))
    re_n = re / (torch.linalg.vector_norm(re, dim=-1, keepdim=True) + 1e-6)
    we_n = we / (torch.linalg.vector_norm(we, dim=-1, keepdim=True) + 1e-6)
    logits = re_n @ we_n.T / temperature
    labels = torch.arange(logits.shape[0], device=logits.device)
    nce = F.cross_entropy(logits, labels)
    align = torch.mean(torch.sum((re - we) ** 2, dim=-1))
    return nce + 0.1 * align


def train_step(params: dict, opt: torch.optim.Optimizer, read_tokens: torch.Tensor,
               window_tokens: torch.Tensor) -> torch.Tensor:
    """One step in place on params and opt, on this rank's slice of the
    global batch: loss_fn's backward, the gradients summed over the ranks
    (one all_reduce), then the optimizer.  Every rank puts the same
    gradient bytes into the same Adam, so the params stay replicated.
    Returns the global loss (a detached 0-d tensor on the params' device,
    so the caller decides when to wait for it)."""
    opt.zero_grad(set_to_none=True)
    loss = loss_fn(params, read_tokens, window_tokens)
    loss.backward()
    dist_.all_reduce_sum_([p.grad for p in leaves(params)])
    opt.step()
    return loss.detach()
