"""deepreadmapper_tpu_torch — the read mapper in PyTorch with CUDA kernels.

A port of ``deepreadmapper_tpu`` (JAX/XLA/Pallas) to PyTorch on an NVIDIA
Hopper GPU.  Module names follow the JAX package so each counterpart is easy
to find.  The port imports ``torch`` and never ``jax``, nor anything of the
JAX package: the JAX-free host layer it needs (``io``, ``tokenizer``,
``native``, ``config``, ``utils.progress``, ``utils.memory``) is copied
here, each copy naming its origin in its first line.  Two things are read
by path from the JAX package's tree, as data, never imported: the shipped
encoder weights (``deepreadmapper_tpu/models/data/finetuned_sgn33.npz``)
and, by ``native``, the C++ sources under the repository's ``native/``.

Layer map:
  io/, tokenizer,    FASTA/FASTQ/SAM/config files, the 3-mer tokenizer, the
  native, config     native C++ loader (built into ``_build/``), settings
  tokenizer_device   2-bit wire rows -> token ids, as torch integer ops
  models/            bi-GRU encoder (``gru`` wraps the GRU CUDA kernel)
  ops/               exact L2 top-k, the int8/PQ window-min scans, PQ, SW,
                     the IVF chunk scans
  index/             FLAT, INT8FLAT, PQFLAT, IVFINT8, IVFPQ, HNSWPQ, HNSWFLAT;
                     the registry
  parallel/          the sharded index, its device grid, torch.distributed
  pipeline/          build-index and the search pipeline (L2 and SW paths)
  kernels            nvcc + ctypes build/load of ``csrc/*.cu``, launch counts

Every entry point runs on the CUDA device unless its caller passes
``device="cpu"`` (``--device cpu`` on the CLI); without a card it raises
rather than carry on on the CPU.  Every hand-written kernel has a plain
PyTorch version beside it.  A wrapper runs the plain version only for CPU
tensors; for CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def default_device() -> torch.device:
    """The first CUDA device.  Raises when none is visible: the port never
    falls back to the CPU on its own; pass device="cpu" to ask for it."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "deepreadmapper_tpu_torch: no CUDA device is visible "
            "(torch.cuda.is_available() is False); pass device='cpu' "
            "(--device cpu on the command line) to run on the CPU"
        )
    return torch.device("cuda")


def resolve_device(device: torch.device | str | None) -> torch.device:
    """An explicit device as given, else the default (the card)."""
    return torch.device(device) if device is not None else default_device()

