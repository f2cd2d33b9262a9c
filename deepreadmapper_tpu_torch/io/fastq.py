# Copied from deepreadmapper_tpu/io/fastq.py, the JAX-free host layer; kept in step with it.
"""FASTQ parsing (reference: format_fastq, src/utils/parse_inputs.cpp:843-950).

4-line records; line 0 (minus leading '@') is the query id cut at the first
space/tab/'/'; line 1 is the sequence, wrapped '<seq>' for the tokenizer.
"""

from __future__ import annotations

import numpy as np

from deepreadmapper_tpu_torch.io.fileio import read_bytes


def parse_fastq(path: str) -> tuple[list[str], list[str]]:
    """Returns (wrapped sequences, query ids) in file order."""
    data = read_bytes(path)
    seqs: list[str] = []
    ids: list[str] = []
    for lineno, line in enumerate(data.split(b"\n")):
        phase = lineno % 4
        if phase == 0:
            if not line:
                continue
            h = line[1:] if line.startswith(b"@") else line
            cut = len(h)
            for sep in (b" ", b"\t", b"/"):
                p = h.find(sep)
                if p != -1:
                    cut = min(cut, p)
            ids.append(h[:cut].decode())
        elif phase == 1:
            seqs.append("<" + line.decode() + ">")
    return seqs, ids


def parse_fastq_quals(path: str) -> list[str]:
    """Per-read base-quality strings (4-line record phase 3), file order.

    The reference drops qualities entirely (format_fastq keeps only id +
    sequence, parse_inputs.cpp:843-950) and writes QUAL '*'; pipeline
    --qual re-reads them here so SAM consumers (callers) see real base
    qualities.  Separate pass — the hot embed path never pays for it."""
    data = read_bytes(path)
    quals: list[str] = []
    lines = data.split(b"\n")
    for lineno in range(3, len(lines), 4):
        quals.append(lines[lineno].decode())
    return quals


def parse_fastq_bytes(path: str) -> tuple[np.ndarray, np.ndarray, list[str]]:
    """Tokenizer-ready variant: ('<'+seq+'>') byte matrix + lengths + ids.

    Avoids building Python string objects for the sequences on the hot path.
    """
    seqs, ids = parse_fastq(path)
    if not seqs:
        return np.zeros((0, 1), np.uint8), np.zeros(0, np.int64), ids
    lengths = np.array([len(s) for s in seqs], dtype=np.int64)
    width = int(lengths.max())
    mat = np.zeros((len(seqs), width), dtype=np.uint8)
    for i, s in enumerate(seqs):
        b = np.frombuffer(s.encode(), dtype=np.uint8)
        mat[i, : b.size] = b
    return mat, lengths, ids
