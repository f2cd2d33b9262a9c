"""Index engine registry: the engine is chosen by the ``index_type`` key of
the index directory's config.txt, as in ``deepreadmapper_tpu/index/registry.py``.
The on-disk layout is shared, so an index built by either package loads in
the other."""

from __future__ import annotations

import os

import torch

from deepreadmapper_tpu_torch.io.configstore import load_config
from deepreadmapper_tpu_torch import not_ported

_REGISTRY: dict[str, type] = {}


def register_index(index_type: str):
    def deco(cls):
        _REGISTRY[index_type] = cls
        return cls

    return deco


def load_index(index_prefix: str, device: torch.device | str | None = None):
    """Load an index directory (config.txt + engine files); returns
    (engine, config)."""
    # the engines register themselves on import
    from deepreadmapper_tpu_torch.index import (  # noqa: F401
        flat,
        hnsw,
        int8_flat,
        ivf_int8,
        ivf_pq,
        pq_flat,
    )

    config_path = os.path.join(index_prefix, "config.txt")
    if not os.path.exists(config_path):
        raise FileNotFoundError(f"Config file does not exist: {config_path}")
    config = load_config(config_path)
    itype = str(config.get("index_type", ""))
    if os.path.exists(os.path.join(index_prefix, "sharded.txt")):
        raise not_ported("a sharded index (sharded.txt)")
    cls = _REGISTRY.get(itype)
    if cls is None:
        raise not_ported(f"index_type {itype!r}")
    return cls.load(index_prefix, config, device=device), config
