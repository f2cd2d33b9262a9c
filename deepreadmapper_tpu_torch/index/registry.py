"""Index engine registry: the engine is chosen by the ``index_type`` key of
the index directory's config.txt, as in ``deepreadmapper_tpu/index/registry.py``.
The on-disk layout is shared, so an index built by either package loads in
the other."""

from __future__ import annotations

import os

import torch

from deepreadmapper_tpu_torch.io.configstore import load_config

_REGISTRY: dict[str, type] = {}


def register_index(index_type: str):
    def deco(cls):
        _REGISTRY[index_type] = cls
        return cls

    return deco


def engine_class(index_type: str) -> type:
    """The engine registered under index_type."""
    # the engines register themselves on import
    from deepreadmapper_tpu_torch.index import (  # noqa: F401
        flat,
        hnsw,
        int8_flat,
        ivf_int8,
        ivf_pq,
        pq_flat,
    )

    cls = _REGISTRY.get(index_type)
    if cls is None:
        raise ValueError(f"Unknown index_type {index_type!r}; known: {sorted(_REGISTRY)}")
    return cls


def load_index(index_prefix: str, device: torch.device | str | None = None):
    """Load an index directory (config.txt + engine files); returns
    (engine, config).  A sharded index (sharded.txt) loads as a
    ``parallel.sharded_ann.ShardedANNIndex``: under a process group of
    more than one rank each rank loads ONLY its own shards
    (``load_distributed``), else every shard over ``make_mesh`` -- the
    visible cards when device is the default card, else the one device."""
    config_path = os.path.join(index_prefix, "config.txt")
    if not os.path.exists(config_path):
        raise FileNotFoundError(f"Config file does not exist: {config_path}")
    config = load_config(config_path)
    itype = str(config.get("index_type", ""))
    if os.path.exists(os.path.join(index_prefix, "sharded.txt")):
        from deepreadmapper_tpu_torch import resolve_device
        from deepreadmapper_tpu_torch.parallel.distributed import world_size
        from deepreadmapper_tpu_torch.parallel.mesh import make_mesh
        from deepreadmapper_tpu_torch.parallel.sharded_ann import (
            ShardedANNIndex,
            read_manifest,
        )

        if world_size() > 1:
            return ShardedANNIndex.load_distributed(index_prefix, device), config
        dev = resolve_device(device)
        devices = ([torch.device("cuda", i) for i in range(torch.cuda.device_count())]
                   if dev.type == "cuda" and dev.index is None else [dev])
        n_shard = int(read_manifest(index_prefix)["n_shard"])
        return ShardedANNIndex.load(index_prefix, make_mesh(n_shard=n_shard,
                                                            devices=devices)), config
    return engine_class(itype).load(index_prefix, config, device=device), config
