# Copied from deepreadmapper_tpu/io/idmap.py, the JAX-free host layer; kept in step with it.
"""Binary label-map persistence (reference: save_id_map/load_id_map,
src/utils/utils.cpp:599-641 — raw size_t dump, unused in the active path but
part of the index directory contract)."""

from __future__ import annotations

import os

import numpy as np


def save_id_map(labels: np.ndarray, folder_path: str, mapping_file: str = "id_map.bin") -> str:
    os.makedirs(folder_path, exist_ok=True)
    path = os.path.join(folder_path, mapping_file)
    np.asarray(labels, dtype=np.uint64).tofile(path)
    return path


def load_id_map(mapping_path: str) -> np.ndarray:
    size = os.path.getsize(mapping_path)
    if size % 8:
        raise ValueError("Mapping file size is not a multiple of 8 bytes")
    return np.fromfile(mapping_path, dtype=np.uint64)
