# Copied from deepreadmapper_tpu/config.py, the JAX-free host layer; kept in step with it.
"""Typed configuration for the pipeline.

The reference uses three config tiers (compile-time constexpr namespaces in
includes/utils/config.hpp:10-57, positional CLI args, and a persisted per-index
config.txt).  Here a single set of dataclasses replaces the constexpr tier; the
config.txt store lives in io/configstore.py and keeps on-disk parity with the
reference (src/utils/utils.cpp:505-597).
"""

from __future__ import annotations

import dataclasses

# Sequence wrapping markers (reference: includes/utils/parse_inputs.hpp:10-11).
PREFIX = "<"
POSTFIX = ">"


@dataclasses.dataclass(frozen=True)
class InferenceConfig:
    """Encoder inference parameters (reference config.hpp:16-26).

    The reference pipelines 2048 concurrent OpenVINO requests of batch 100;
    on TPU a single large device batch saturates the MXU instead.
    """

    max_len: int = 123          # model sequence length (tokens)
    out_size: int = 128         # embedding dimension
    device_batch: int = 8192    # sequences per device dispatch
    dtype: str = "float32"      # "float32" for parity, "bfloat16" for speed


@dataclasses.dataclass(frozen=True)
class BuildConfig:
    """Index build parameters (reference config.hpp:28-40, hnswpq/index.cpp:214-223)."""

    stride: int = 1
    m_pq: int = 8               # PQ subquantizers
    nbits: int = 8              # bits per PQ code
    m_hnsw: int = 16            # HNSW graph degree
    efc: int = 200              # HNSW efConstruction
    build_mode: str = "insert"  # "insert" (incremental) | "knn" (MXU kNN graph)
    level_mode: str = "rng"     # "rng" | "centroid" (hnswm's deterministic
                                # partition-medoid levels, hnsw.cpp:701-796)
    sample_rate: float = 0.5    # fraction of vectors used to train PQ
    kmeans_iters: int = 25      # PQ k-means iterations (FAISS default)
    seed: int = 1234            # deterministic codebook init
    opq: bool = False           # learn an orthogonal rotation before PQ
    opq_iters: int = 10         # OPQ alternation rounds
    nlist: int = 0              # IVF coarse clusters (0 = auto ~sqrt(N))


@dataclasses.dataclass(frozen=True)
class SearchConfig:
    """Search parameters (reference config.hpp:42-50)."""

    ef: int = 128               # HNSW beam width
    k: int = 128                # top-K results
    k_clusters: int = 5         # sparse-index candidates per query
    query_batch_size: int = 5000  # streaming post-process batch
    chunk_size: int = 10_000_000  # candidate re-embedding chunk
