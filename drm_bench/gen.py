"""The one traffic generator: a seeded genome and a seeded pool of request
FASTQ files, read from a traffic file's parameters.

The genome and reads follow ``chip_smoke.simulate`` (uniform random bases;
wgsim-style reads: a uniform start, either strand, independent substitutions;
read names ``_<start>_<strand>_<i>`` carry the truth), with every draw taken
from ``--seed``.  A request's size comes from the traffic file:

  {"kind": "fixed", "reads": 8192}
  {"kind": "log_uniform", "low": 128, "high": 2048}

A log-uniform mix uses the same set of sizes for every seed, the pool's
quantiles of the distribution, sent in a balanced order (any run of
requests draws evenly from the whole range) that the seed permutes: two
seeds then ask for the same work in another order, and a window that
ends mid-pool still sees the distribution, so neither moves the tail.
"""

from __future__ import annotations

import os

import numpy as np

ACGT = np.frombuffer(b"ACGT", np.uint8)


def make_genome(genome_bp: int, seed: int) -> np.ndarray:
    """Uniform random ACGT bases (uint8 bytes) of the given length."""
    rng = np.random.default_rng([seed, 0])
    return ACGT[rng.integers(0, 4, genome_bp, dtype=np.uint8)]


def write_fasta(path: str, genome: np.ndarray, name: str = "synthetic") -> None:
    """One record, 80 bases a line."""
    full = genome.size // 80 * 80
    body = genome[:full].reshape(-1, 80)
    nl = np.full((body.shape[0], 1), ord("\n"), np.uint8)
    with open(path, "wb") as f:
        f.write(b">" + name.encode() + b"\n")
        f.write(np.concatenate([body, nl], axis=1).tobytes())
        if full < genome.size:
            f.write(genome[full:].tobytes() + b"\n")


def request_sizes(spec: dict, n_requests: int, seed: int) -> list[int]:
    """Reads of each request of the pool, in the order they are sent."""
    kind = spec["kind"]
    if kind == "fixed":
        return [int(spec["reads"])] * n_requests
    if kind == "log_uniform":
        if n_requests & (n_requests - 1):
            raise ValueError(f"a log-uniform pool holds a power of two of requests, "
                             f"not {n_requests}")
        lo, hi = np.log(spec["low"]), np.log(spec["high"])
        q = (np.arange(n_requests) + 0.5) / n_requests
        sizes = np.rint(np.exp(lo + q * (hi - lo))).astype(np.int64)
        # bit-reversed order: every aligned run of 2^j requests holds one size
        # of each 2^j-quantile stratum, so any window's prefix is a balanced
        # draw; the seed flips bits of the order (same strata, another order)
        bits = n_requests.bit_length() - 1
        i = np.arange(n_requests)
        rev = np.zeros_like(i)
        for b in range(bits):
            rev |= ((i >> b) & 1) << (bits - 1 - b)
        mask = int(np.random.default_rng([seed, 1]).integers(0, n_requests))
        return [int(s) for s in sizes[rev ^ mask]]
    raise ValueError(f"unknown request size kind {kind!r}")


def make_reads(genome: np.ndarray, n: int, read_len: int, sub_rate: float,
               rng: np.random.Generator):
    """(reads uint8 [n, read_len] as sequenced, starts [n], strands [n])."""
    starts = rng.integers(0, genome.size - read_len + 1, n)
    strands = rng.integers(0, 2, n)
    idx = np.searchsorted(ACGT, genome[starts[:, None] + np.arange(read_len)[None, :]])
    rev = strands == 1
    idx[rev] = 3 - idx[rev][:, ::-1]  # reverse complement (A<->T, C<->G)
    mask = rng.random((n, read_len)) < sub_rate
    idx[mask] = rng.integers(0, 4, int(mask.sum()))
    return ACGT[idx], starts, strands


def write_fastq(path: str, reads: np.ndarray, starts, strands, first: int) -> None:
    qual = b"I" * reads.shape[1]
    with open(path, "wb") as f:
        f.write(b"".join(
            b"@_%d_%d_%d\n%s\n+\n%s\n" % (s, t, first + i, r.tobytes(), qual)
            for i, (r, s, t) in enumerate(zip(reads, starts, strands))))


def make_pool(work: str, genome: np.ndarray, traffic: dict, seed: int) -> list[dict]:
    """Write the pool's request FASTQ files under work; returns one dict a
    request: {"fastq", "reads", "starts", "strands", "names"}."""
    sizes = request_sizes(traffic["request_reads"], int(traffic["pool_requests"]), seed)
    rng = np.random.default_rng([seed, 2])
    pool, first = [], 0
    for j, n in enumerate(sizes):
        reads, starts, strands = make_reads(genome, n, int(traffic["read_len"]),
                                            float(traffic["sub_rate"]), rng)
        path = os.path.join(work, f"req{j:03d}.fastq")
        write_fastq(path, reads, starts, strands, first)
        pool.append({"fastq": path, "reads": reads, "starts": starts,
                     "strands": strands, "names": [f"_{s}_{t}_{first + i}" for i, (s, t)
                                                   in enumerate(zip(starts, strands))]})
        first += n
    return pool
