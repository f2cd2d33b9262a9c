"""deepreadmapper_tpu_torch — the read mapper in PyTorch with CUDA kernels.

A port of ``deepreadmapper_tpu`` (JAX/XLA/Pallas) to PyTorch on an NVIDIA
Hopper GPU.  Module names follow the JAX package so each counterpart is easy
to find.  The port imports ``torch`` and never ``jax``; the JAX-free host
layer of the JAX package (``io``, ``tokenizer``, ``native``, ``config``,
``utils.progress``) is imported, not copied.

Layer map:
  tokenizer_device   2-bit wire rows -> token ids, as torch integer ops
  models/            bi-GRU encoder (``gru`` wraps the GRU CUDA kernel)
  ops/               exact L2 top-k, the fused int8 window-min scan
  index/             FLAT and INT8FLAT engines, the index registry
  pipeline/          build-index and the search pipeline (L2 path)
  kernels            nvcc + ctypes build/load of ``csrc/*.cu``, launch counts

Every hand-written kernel has a plain PyTorch version beside it.  A wrapper
runs the plain version only for CPU tensors; for CUDA tensors it launches the
kernel or raises.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def default_device() -> torch.device:
    """The first CUDA device when one is present, else the CPU."""
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def not_ported(what: str) -> NotImplementedError:
    """The error for a feature of the JAX package the port does not have yet."""
    return NotImplementedError(
        f"{what} is not ported to deepreadmapper_tpu_torch yet; see "
        "ROADMAP.md (Queue A) for the order of the remaining work, or use "
        "deepreadmapper_tpu"
    )
