"""Exact (brute-force) index — the recall oracle, on ``ops.topk.l2_topk``.

Counterpart of ``deepreadmapper_tpu/index/flat.py``; same ``vectors.npy``.
Ids are sequential positions in insertion order (2*pos | strand for the
dense windowed reference)."""

from __future__ import annotations

import os

import numpy as np
import torch

from deepreadmapper_tpu_torch import resolve_device
from deepreadmapper_tpu_torch.index.registry import register_index
from deepreadmapper_tpu_torch.ops.topk import l2_topk


@register_index("FLAT")
class FlatIndex:
    def __init__(self, embeddings: np.ndarray,
                 device: torch.device | str | None = None):
        self.embeddings = np.ascontiguousarray(embeddings, dtype=np.float32)
        self.device = resolve_device(device)
        self._dev = None

    @classmethod
    def build(cls, embeddings: np.ndarray, device=None):
        return cls(embeddings, device)

    @property
    def ntotal(self) -> int:
        return self.embeddings.shape[0]

    def search(self, queries: np.ndarray, k: int, ef: int = 0):
        """ef is accepted for interface parity and ignored (exact search)."""
        if self._dev is None:
            self._dev = torch.from_numpy(self.embeddings).to(self.device)
        d, i = l2_topk(queries, self._dev, k, device=self.device)
        return i.cpu().numpy(), d.cpu().numpy()

    def save(self, index_prefix: str) -> None:
        os.makedirs(index_prefix, exist_ok=True)
        np.save(os.path.join(index_prefix, "vectors.npy"), self.embeddings)

    @classmethod
    def load(cls, index_prefix: str, config: dict | None = None, device=None):
        return cls(np.load(os.path.join(index_prefix, "vectors.npy")), device)
