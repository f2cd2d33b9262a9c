# Copied from deepreadmapper_tpu/io/results.py, the JAX-free host layer; kept in step with it.
"""Result persistence (reference: save_results, src/utils/utils.cpp:264-334).

indices.npy is uint64 [nq, k] (the reference writes size_t), distances.npy is
float32 [nq, k]; both C-order.
"""

from __future__ import annotations

import numpy as np


def save_results(
    neighbors: np.ndarray,
    distances: np.ndarray,
    indices_file: str,
    distances_file: str,
    k: int,
) -> None:
    idx = np.ascontiguousarray(neighbors[:, :k]).astype(np.uint64)
    dst = np.ascontiguousarray(distances[:, :k]).astype(np.float32)
    np.save(indices_file if indices_file.endswith(".npy") else indices_file + ".npy", idx)
    np.save(distances_file if distances_file.endswith(".npy") else distances_file + ".npy", dst)


def load_embeddings_npy(path: str) -> np.ndarray:
    arr = np.load(path)
    if arr.ndim != 2:
        raise ValueError(f"Expected 2D array in {path}, got shape {arr.shape}")
    return arr.astype(np.float32)
