# Copied from deepreadmapper_tpu/utils/memory.py, the JAX-free host layer; kept in step with it.
"""Memory estimators (reference: estimate_memory, src/hnswpq/index.cpp:5-53;
FASTA RAM estimate, parse_inputs.cpp:290-295; estimate_token_count,
parse_inputs.cpp:16-40)."""

from __future__ import annotations

import os


def estimate_index_memory(
    num_vectors: int,
    dim: int = 128,
    m_pq: int = 8,
    nbits: int = 8,
    m_hnsw: int = 16,
    n_train: int = 0,
) -> dict:
    """Bytes by component for a PQ+HNSW index (mirrors index.cpp:5-53)."""
    ksub = 1 << nbits
    dsub = dim // m_pq
    codebooks = m_pq * ksub * dsub * 4
    codes = num_vectors * m_pq
    graph = int(num_vectors * m_hnsw * 1.5) * 4
    metadata = num_vectors * 4
    out = {
        "pq_codebooks": codebooks,
        "pq_codes": codes,
        "hnsw_graph": graph,
        "metadata": metadata,
        "total": codebooks + codes + graph + metadata,
    }
    if n_train:
        training = n_train * dim * 4 + codebooks + n_train * m_pq * 4
        out["training_peak"] = codebooks + training
    return out


def estimate_window_count(fasta_path: str, ref_len: int, stride: int = 1) -> int:
    """File-size-based window estimate (estimate_token_count semantics:
    forward + reverse complement, header overhead subtracted).  Gzipped
    inputs stream-decompress to count bytes — the ISIZE footer is useless
    for multi-member gzip (BGZF ends with an empty member whose ISIZE is
    0, and concatenated .gz files only report the last member)."""
    size = os.path.getsize(fasta_path)
    with open(fasta_path, "rb") as f:
        if f.read(2) == b"\x1f\x8b":
            import gzip

            f.seek(0)
            size = 0
            with gzip.open(f, "rb") as g:
                while True:
                    chunk = g.read(1 << 22)
                    if not chunk:
                        break
                    size += len(chunk)
    if size < 100:
        return 0
    bases = size - 100
    if bases < ref_len:
        return 0
    return ((bases - ref_len) // stride + 1) * 2


def estimate_windows_ram(total_windows: int, ref_len: int, wrapped: bool = True) -> float:
    """MB to materialize window strings (parse_inputs.cpp:290) — our pipeline
    streams token matrices instead, so this is the AVOIDED cost."""
    return total_windows * (ref_len + (2 if wrapped else 0)) / (1024.0 * 1024.0)
