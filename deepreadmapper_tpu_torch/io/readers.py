# Copied from deepreadmapper_tpu/io/readers.py, the JAX-free host layer; kept in step with it.
"""Generic input dispatch (reference: read_file, src/utils/utils.cpp:188-215).

.fna/.fasta/.fa -> windowed FASTA; .fastq/.fq -> FASTQ + ids; .txt -> one
sequence per line; anything else is rejected.
"""

from __future__ import annotations

import os

from deepreadmapper_tpu_torch.io.fasta import parse_fasta_records, windows_as_strings
from deepreadmapper_tpu_torch.io.fastq import parse_fastq
from deepreadmapper_tpu_torch.io.fileio import read_bytes, true_ext

FASTA_EXTS = {".fna", ".fasta", ".fa"}
FASTQ_EXTS = {".fastq", ".fq"}


def read_txt(path: str) -> list[str]:
    data = read_bytes(path)
    return [ln.decode() for ln in data.replace(b"\r", b"\n").split(b"\n") if ln]


def read_file(
    path: str,
    ref_len: int = 0,
    stride: int = 1,
    lookup_mode: bool = False,
) -> tuple[list[str], list[str]]:
    """Returns (sequences, query_ids); ids are empty except for FASTQ."""
    ext = true_ext(path)
    if ext in FASTA_EXTS:
        records = parse_fasta_records(path)
        seqs, _labels = windows_as_strings(records, ref_len, stride, lookup_mode)
        return seqs, []
    if ext in FASTQ_EXTS:
        return parse_fastq(path)
    if ext == ".txt":
        return read_txt(path), []
    raise ValueError(
        f"Unsupported file format: {ext}. Only .fna/.fasta/.fa/.fastq/.fq/.txt (+.gz)"
    )
