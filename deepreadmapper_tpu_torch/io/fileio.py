# Copied from deepreadmapper_tpu/io/fileio.py, the JAX-free host layer; kept in step with it.
"""Transparent gzip support for every sequence-file reader.

Real-world FASTA/FASTQ ship gzipped; the reference links zlib but never
actually decompresses inputs (read_file dispatches on the literal
extension, src/utils/utils.cpp:188-215, and rejects .gz).  Here every
reader funnels through read_bytes(), which gunzips on the 1f 8b magic (so
a mis-named .gz works too), and extension dispatch uses true_ext(), which
looks through a trailing .gz.
"""

from __future__ import annotations

import os


def read_bytes(path: str) -> bytes:
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] == b"\x1f\x8b":
        import gzip

        data = gzip.decompress(data)
    return data


def read_bytes_arr(path: str):
    """File contents as a uint8 array; plain files come back as a
    READ-ONLY np.memmap so a 3 Gbp genome is paged, not slurped — the
    reference's mmap readers (src/utils/parse_inputs.cpp:117-162) recast
    for numpy.  Gzipped files decompress to a regular array (no random
    access into a DEFLATE stream).  Callers treat the result as
    immutable and must copy slices they keep."""
    import numpy as np

    with open(path, "rb") as f:
        magic = f.read(2)
    if magic == b"\x1f\x8b":
        return np.frombuffer(read_bytes(path), dtype=np.uint8)
    if os.path.getsize(path) == 0:
        return np.empty(0, dtype=np.uint8)
    return np.memmap(path, dtype=np.uint8, mode="r")


def true_ext(path: str) -> str:
    """File extension for dispatch, looking through a trailing .gz."""
    if path.endswith(".gz"):
        path = path[:-3]
    return os.path.splitext(path)[1].lower()
