#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of the read mapper on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

Phases (any failure raises and the exit code is not 0):
  1. device   name, nvidia-smi name/power limit; TF32 off
  2. build    nvcc builds every kernel of the main path from csrc/
  3. kernels  each kernel against its plain PyTorch version at main-path
              shapes, with CUDA-event times of both
  4. fixture  the port's CLI build-index -> pipeline on tests/data/ecoli_150
              (truth check: read position within 2 bp among the top 128),
              and PQFLAT with OPQ -> --rerank sw (SAM primary within 2 bp)
  5. genome   build-index -> pipeline on a seeded 2 Mbp genome and 8192
              simulated 150 bp reads; top-1 accuracy, launch counts, the
              fused scan against the exact scan (top-1) and against its
              plain-driven self (bit for bit)
  6. genome_pq build-index --index-type PQFLAT -> pipeline --rerank sw on a
              seeded 5 Mbp genome (~10M windows) and 8192 reads; SW top-1
              from the SAM, launch counts of the PQ scan and SW kernels,
              the SW rerank's host/kernel split, the fused PQ scan against
              its plain-driven self (bit for bit); then the same simulation
              shrunk to the JAX package's CPU size (200 kbp, 1024 reads),
              SW top-1 over the exact scan's candidates
The last lines are one JSON object of kernel results, the nvidia-smi line,
and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, ".smoke")
FIXTURE = os.path.join(ROOT, "tests", "data")

GRU_B, GRU_T = 8192, 123
SCAN_ROWS, SCAN_Q = 1 << 18, 8192
SW_PAIRS = 65536                    # 512 reads x 128 candidates, 150 x 152 bytes
GENOME_BP, N_READS, READ_LEN = 2_000_000, 8192, 150
PQ_GENOME_BP = 5_000_000            # ~10M windows: the README's PQFLAT tier
SW_TOP1_FLOOR = 0.96                # main path at 5 Mbp (PERF.md section 2)
CPU_SIZE_BP, CPU_SIZE_READS = 200_000, 1024  # the simulation shrunk to CPU size
# SW top-1 (reads of CPU_SIZE_READS) that the JAX package reaches there on the
# CPU, where its search is the exact scan: the gate of the port's exact-scan
# SW rerank at that size.  Recorded, not measured here (this script imports
# no JAX): `python scripts/sw_top1_cpu_size.py --package jax` prints it.
JAX_SW_TOP1_READS = 1021


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_time(fn, reps: int) -> float:
    """Mean ms per call of fn over reps calls, by CUDA events (one warm-up)."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"[device] {name} | count {torch.cuda.device_count()} | torch "
        f"{torch.__version__} cuda {torch.version.cuda}")
    log(f"[device] nvidia-smi: {smi}")
    return name, smi


def phase_build():
    from concurrent.futures import ThreadPoolExecutor

    from deepreadmapper_tpu_torch import kernels

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(kernels.ALL)) as pool:  # one nvcc per source, all at once
        libs = list(pool.map(lambda k: k.build(), kernels.ALL))
    log(f"[build] all kernels in {time.perf_counter() - t0:.1f} s")
    for k, so in zip(kernels.ALL, libs):
        log(f"[build] {k.name}: {os.path.relpath(so, ROOT)} in "
            f"{k.build_seconds if k.build_seconds is not None else 0.0:.1f} s")
        for line in k.build_log.splitlines():
            if "ptxas info" in line and ("Used" in line or "spill" in line
                                         or "Compiling" in line):
                log(f"[build]   {line.strip()}")


def _gru_inputs(din: int, dtype, rng):
    import torch

    from deepreadmapper_tpu_torch.models.encoder import load_params

    layer = load_params()["layers"][0 if din == 64 else 1]
    x = rng.uniform(-1.0, 1.0, (GRU_T, GRU_B, din)).astype(np.float32)
    dev = torch.device("cuda")
    p = [torch.from_numpy(layer[k][0]).to(dev, dtype) for k in ("w", "bzr", "r", "rbh")]
    return torch.from_numpy(x).to(dev, dtype), p


def check_gru(results: dict):
    import torch

    from deepreadmapper_tpu_torch.models import gru

    rng = np.random.default_rng(0)
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for din in (64, 128):
            x, (w, bzr, r, rbh) = _gru_inputs(din, dtype, rng)
            for reverse in (False, True):
                for last in (False, True):
                    fn = gru.gru_proj_last if last else gru.gru_proj_seq
                    got = fn(x, w, bzr, r, rbh, reverse)
                    want = gru.gru_reference(x, w, bzr, r, rbh, reverse, last)
                    torch.cuda.synchronize()
                    err = (got.float() - want.float()).abs().max().item()
                    tol = 1e-2 if (dtype == torch.bfloat16 and not last) else 1e-4
                    tag = (f"{str(dtype)[6:]} din={din} "
                           f"{'rev' if reverse else 'fwd'} {'last' if last else 'seq'}")
                    if not (got.shape == want.shape and got.dtype == want.dtype
                            and err <= tol):
                        raise AssertionError(f"gru {tag}: max abs err {err} > {tol}")
                    worst = max(worst, err)
                    log(f"[kernels] gru {tag}: max abs err {err:.3e} (tol {tol})")
    # one encoder batch = layer 1 fwd/bwd all steps (din 64) + layer 2
    # fwd/bwd last step (din 128), fp32, B = 8192
    x1, p1 = _gru_inputs(64, torch.float32, rng)
    x2, p2 = _gru_inputs(128, torch.float32, rng)

    def batch(impl):
        def run():
            for rev in (False, True):
                impl(x1, *p1, rev, False)
            for rev in (False, True):
                impl(x2, *p2, rev, True)
        return run

    def kernel_impl(x, w, b, r, rb, rev, last):
        return (gru.gru_proj_last if last else gru.gru_proj_seq)(x, w, b, r, rb, rev)

    t_plain_a = cuda_time(batch(gru.gru_reference), 3)
    t_kernel = cuda_time(batch(kernel_impl), 10)
    t_plain_b = cuda_time(batch(gru.gru_reference), 3)
    t_plain = (t_plain_a + t_plain_b) / 2
    log(f"[kernels] gru encoder batch (4 calls, B={GRU_B}, fp32): kernel "
        f"{t_kernel:.3f} ms | plain {t_plain_a:.3f} / {t_plain_b:.3f} ms")
    results["gru_fwd"] = {"max_abs_err": worst, "ms": t_kernel, "plain_ms": t_plain}


def check_int8(results: dict):
    import torch

    from deepreadmapper_tpu_torch.ops import scan_kernel as sk

    dev = torch.device("cuda")
    rng = np.random.default_rng(1)
    q8 = torch.from_numpy(rng.integers(-127, 128, (SCAN_Q, 128), dtype=np.int8)).to(dev)
    cases = [
        ("full-range ratio 1", 127, 2.0),
        ("full-range ratio 1.3", 127, 2.0 * float(np.float32(1.3))),
        ("tie-heavy ratio 1", 2, 2.0),
    ]
    worst = 0.0
    for tag, amp, ratio2 in cases:
        r8 = torch.from_numpy(
            rng.integers(-amp, amp + 1, (SCAN_ROWS, 128), dtype=np.int8)).to(dev)
        ntotal = SCAN_ROWS - 1000  # mask part of the last tile
        v, a = sk.int8_winmin(q8, r8, ntotal, ratio2)
        vr, ar = sk.int8_winmin_reference(q8, r8, ntotal, ratio2)
        torch.cuda.synchronize()
        if not (torch.equal(v, vr) and torch.equal(a, ar)):
            bad = (v != vr) | (a != ar)
            raise AssertionError(
                f"int8_winmin {tag}: {int(bad.sum())} of {bad.numel()} entries differ")
        worst = max(worst, (v - vr).abs().max().item())
        log(f"[kernels] int8_winmin {tag}: vals and args exactly equal "
            f"({SCAN_ROWS} rows x {SCAN_Q} queries)")
    r8 = torch.from_numpy(
        rng.integers(-127, 128, (2 * SCAN_ROWS, 128), dtype=np.int8)).to(dev)
    d, i = sk.fused_scan_topk(q8, r8, 2 * SCAN_ROWS - 777, 128, SCAN_ROWS)
    dr, ir = sk.fused_scan_topk(q8, r8, 2 * SCAN_ROWS - 777, 128, SCAN_ROWS,
                                winmin=sk.int8_winmin_reference)
    torch.cuda.synchronize()
    if not (torch.equal(d, dr) and torch.equal(i, ir)):
        raise AssertionError("fused_scan_topk: kernel-driven != plain-driven")
    log("[kernels] fused_scan_topk 2 chunks x 2^18 rows, k=128: kernel-driven "
        "== plain-driven")
    rs = r8[:SCAN_ROWS]
    t_plain_a = cuda_time(lambda: sk.int8_winmin_reference(q8, rs, SCAN_ROWS, 2.0), 2)
    t_kernel = cuda_time(lambda: sk.int8_winmin(q8, rs, SCAN_ROWS, 2.0), 5)
    t_plain_b = cuda_time(lambda: sk.int8_winmin_reference(q8, rs, SCAN_ROWS, 2.0), 2)
    t_plain = (t_plain_a + t_plain_b) / 2
    tops = 2.0 * SCAN_ROWS * SCAN_Q * 128 / (t_kernel * 1e-3) / 1e12
    log(f"[kernels] int8_winmin {SCAN_ROWS} rows x {SCAN_Q} queries: kernel "
        f"{t_kernel:.3f} ms ({tops:.1f} int8 TOP/s) | plain {t_plain_a:.3f} / "
        f"{t_plain_b:.3f} ms")
    results["int8_winmin"] = {"max_abs_err": worst, "ms": t_kernel,
                              "plain_ms": t_plain}


def _sw_pairs(rng, p: int):
    """p (window, '<'-wrapped read) byte pairs at the main path's widths: a
    random genome's windows, every read copied from its pair's window with
    1% substitutions, as post_process_sw scores them."""
    acgt = np.frombuffer(b"ACGT", np.uint8)
    g = acgt[rng.integers(0, 4, 1 << 20)]
    pos = rng.integers(0, g.size - READ_LEN, p)
    a = g[pos[:, None] + np.arange(READ_LEN)]
    b = np.full((p, READ_LEN + 2), ord(">"), np.uint8)
    b[:, 0] = ord("<")
    b[:, 1:-1] = a[rng.permutation(p)]  # mostly unrelated windows ...
    own = rng.random(p) < 0.1           # ... and some the read's own
    b[own, 1:-1] = a[own]
    mask = rng.random((p, READ_LEN)) < 0.01
    b[:, 1:-1][mask] = acgt[rng.integers(0, 4, int(mask.sum()))]
    return a, np.full(p, READ_LEN), b, np.full(p, READ_LEN + 2)


def _sw_edge_pairs(rng):
    """Zero lengths, lengths that differ within a warp, N bytes, exact
    copies, and a batch size that is not a multiple of 128."""
    p = 1000
    acgtn = np.frombuffer(b"ACGTN", np.uint8)
    a = acgtn[rng.integers(0, 5, (p, READ_LEN))]
    b = acgtn[rng.integers(0, 5, (p, READ_LEN + 2))]
    b[:, 0], b[:, -1] = ord("<"), ord(">")
    b[::3, 1:-1] = a[::3]
    la, lb = np.full(p, READ_LEN), np.full(p, READ_LEN + 2)
    la[::7] = rng.integers(0, READ_LEN + 1, la[::7].shape)
    lb[::5] = rng.integers(0, READ_LEN + 3, lb[::5].shape)
    la[11] = lb[12] = 0
    return a, la, b, lb


def check_sw(results: dict):
    import torch

    from deepreadmapper_tpu_torch.ops import sw

    dev = torch.device("cuda")
    rng = np.random.default_rng(2)
    worst = 0
    for tag, pairs in (("edge cases", _sw_edge_pairs(rng)),
                       (f"{SW_PAIRS} pairs", _sw_pairs(rng, SW_PAIRS))):
        a, la, b, lb = (torch.from_numpy(x).to(dev) for x in pairs)
        got = sw.sw_scores(a, la, b, lb)
        want = sw.sw_scores_reference(a, la, b, lb)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            bad = int((got != want).sum())
            raise AssertionError(f"sw_score {tag}: {bad} of {got.numel()} scores differ")
        worst = max(worst, (got - want).abs().max().item() if got.numel() else 0)
        log(f"[kernels] sw_score {tag}: scores exactly equal (max {int(got.max())})")
    cells = float((la.double() * lb.double()).sum())
    t_plain_a = cuda_time(lambda: sw.sw_scores_reference(a, la, b, lb), 1)
    t_kernel = cuda_time(lambda: sw.sw_scores(a, la, b, lb), 10)
    t_plain_b = cuda_time(lambda: sw.sw_scores_reference(a, la, b, lb), 1)
    log(f"[kernels] sw_score {SW_PAIRS} pairs of {READ_LEN}x{READ_LEN + 2}: kernel "
        f"{t_kernel:.3f} ms ({cells / (t_kernel * 1e-3) / 1e9:.1f} GCUPS) | plain "
        f"{t_plain_a:.3f} / {t_plain_b:.3f} ms")
    results["sw_score"] = {"max_abs_err": float(worst), "ms": t_kernel,
                           "plain_ms": (t_plain_a + t_plain_b) / 2}


def check_pq(results: dict):
    import torch

    from deepreadmapper_tpu_torch.ops import scan_kernel as sk

    dev = torch.device("cuda")
    rng = np.random.default_rng(3)
    q8 = torch.from_numpy(rng.integers(-127, 128, (SCAN_Q, 128), dtype=np.int8)).to(dev)
    ntotal = SCAN_ROWS - 1000  # mask part of the last tile
    times, worst = {}, 0.0
    for m in (8, 16):
        codes = torch.from_numpy(
            rng.integers(0, 256, (SCAN_ROWS, m), dtype=np.uint8)).to(dev)
        cent8 = torch.from_numpy(
            rng.integers(-127, 128, (m, 256, 128 // m), dtype=np.int8)).to(dev)
        for ratio in (1.0, 1.3):
            ratio2 = 2.0 * float(np.float32(ratio))
            v, a = sk.pq_winmin(q8, codes, cent8, ntotal, ratio2)
            vr, ar = sk.pq_winmin_reference(q8, codes, cent8, ntotal, ratio2)
            torch.cuda.synchronize()
            if not (torch.equal(v, vr) and torch.equal(a, ar)):
                bad = (v != vr) | (a != ar)
                raise AssertionError(f"pq_winmin m={m} ratio {ratio}: "
                                     f"{int(bad.sum())} of {bad.numel()} entries differ")
            worst = max(worst, (v - vr).abs().max().item())
            log(f"[kernels] pq_winmin m={m} ratio {ratio}: vals and args exactly equal "
                f"({SCAN_ROWS} rows x {SCAN_Q} queries)")
        t_plain_a = cuda_time(
            lambda: sk.pq_winmin_reference(q8, codes, cent8, SCAN_ROWS, 2.0), 2)
        t_kernel = cuda_time(lambda: sk.pq_winmin(q8, codes, cent8, SCAN_ROWS, 2.0), 5)
        t_plain_b = cuda_time(
            lambda: sk.pq_winmin_reference(q8, codes, cent8, SCAN_ROWS, 2.0), 2)
        tops = 2.0 * SCAN_ROWS * SCAN_Q * 128 / (t_kernel * 1e-3) / 1e12
        log(f"[kernels] pq_winmin m={m} {SCAN_ROWS} rows x {SCAN_Q} queries: kernel "
            f"{t_kernel:.3f} ms ({tops:.1f} int8 TOP/s) | plain {t_plain_a:.3f} / "
            f"{t_plain_b:.3f} ms")
        times[m] = (t_kernel, (t_plain_a + t_plain_b) / 2)
    results["pq_winmin"] = {"max_abs_err": worst, "ms": times[8][0],
                            "plain_ms": times[8][1]}


def truth_hits(indices: np.ndarray, names: list[str], slack: int) -> int:
    """Reads whose name-encoded position is within slack bp of a candidate."""
    hits = 0
    for row, name in zip(indices.astype(np.int64), names):
        pos = int(name.split("_")[1]) - 1
        hits += bool(np.any(np.abs(row // 2 - pos) <= slack))
    return hits


def phase_fixture():
    from deepreadmapper_tpu_torch import cli

    work = os.path.join(WORK, "fixture")
    fna = os.path.join(FIXTURE, "ecoli_150.fna")
    fq = os.path.join(FIXTURE, "test_data.fastq")
    if cli.main(["build-index", fna, os.path.join(work, "idx"), "150"]) != 0:
        raise AssertionError("fixture build-index failed")
    out = os.path.join(work, "out")
    if cli.main(["pipeline", os.path.join(work, "idx"), fq, fna, "128", "128",
                 "5", out]) != 0:
        raise AssertionError("fixture pipeline failed")
    with open(fq) as f:
        names = [ln[1:].split()[0] for ln in f.read().splitlines()[0::4]]
    hits = truth_hits(np.load(os.path.join(out, "indices.npy")), names, 2)
    log(f"[fixture] truth hits {hits}/{len(names)} (need >= 135)")
    if hits < 135:
        raise AssertionError(f"fixture truth hits {hits} < 135")
    # PQFLAT with OPQ, then the SW rerank: the SAM primary is the SW best
    if cli.main(["build-index", fna, os.path.join(work, "pq"), "150",
                 "--index-type", "PQFLAT", "--opq"]) != 0:
        raise AssertionError("fixture PQFLAT build-index failed")
    out = os.path.join(work, "pq_out")
    if cli.main(["pipeline", os.path.join(work, "pq"), fq, fna, "128", "10", "128",
                 out, "--rerank", "sw"]) != 0:
        raise AssertionError("fixture SW pipeline failed")
    pos, _ = sam_primaries(os.path.join(out, "results.sam"))
    truth = np.array([int(n.split("_")[1]) - 1 for n in names])
    top1 = int(np.sum(np.abs(pos - truth) <= 2))
    log(f"[fixture] PQFLAT+OPQ, SW rerank: primary within 2 bp {top1}/{len(names)} "
        "(need >= 135)")
    if top1 < 135:
        raise AssertionError(f"fixture SW top-1 {top1} < 135")


def simulate(work: str, genome_bp: int = GENOME_BP, n_reads: int = N_READS):
    """Seeded genome FASTA + wgsim-style reads (uniform start, either strand,
    1% substitutions) as a FASTQ whose read names carry _<start>_<strand>_<i>,
    the same reads as a '<'-wrapped byte matrix, and the genome's bytes."""
    rng = np.random.default_rng(0)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    g = rng.integers(0, 4, genome_bp).astype(np.uint8)
    ref = os.path.join(work, "ref.fna")
    with open(ref, "wb") as f:
        f.write(b"> synthetic\n")
        body = acgt[g]
        for i in range(0, genome_bp, 80):
            f.write(body[i : i + 80].tobytes() + b"\n")
    rng = np.random.default_rng(1)
    starts = rng.integers(0, genome_bp - READ_LEN + 1, n_reads)
    strands = rng.integers(0, 2, n_reads)
    reads = g[starts[:, None] + np.arange(READ_LEN)[None, :]]
    rev = strands == 1
    reads[rev] = 3 - reads[rev][:, ::-1]  # reverse complement (A<->T, C<->G)
    mask = rng.random((n_reads, READ_LEN)) < 0.01
    reads[mask] = rng.integers(0, 4, int(mask.sum()))
    fq = os.path.join(work, "reads.fastq")
    qual = b"I" * READ_LEN
    with open(fq, "wb") as f:
        for i in range(n_reads):
            f.write(b"@_%d_%d_%d\n%s\n+\n%s\n" % (
                starts[i], strands[i], i, acgt[reads[i]].tobytes(), qual))
    wrapped = np.concatenate([
        np.full((n_reads, 1), ord("<"), np.uint8), acgt[reads],
        np.full((n_reads, 1), ord(">"), np.uint8)], axis=1)
    return ref, fq, starts, strands, wrapped, body


def fetch_windows(genome: np.ndarray, ids: np.ndarray):
    """(bytes [M, READ_LEN], lengths) of the windows 2*pos | strand of one
    ACGT genome: odd ids are the reverse complement."""
    comp = np.zeros(256, np.uint8)
    comp[np.frombuffer(b"ACGT", np.uint8)] = np.frombuffer(b"TGCA", np.uint8)
    w = genome[(ids >> 1)[:, None] + np.arange(READ_LEN)]
    rev = (ids & 1) == 1
    w[rev] = comp[w[rev][:, ::-1]]
    return w, np.full(ids.size, READ_LEN)


def sam_primaries(sam: str) -> tuple[np.ndarray, np.ndarray]:
    """(0-based position, strand) of each read's first SAM record, in read
    order; -1 position for an unmapped primary."""
    pos, strand, prev = [], [], None
    with open(sam) as f:
        for ln in f:
            if ln.startswith("@"):
                continue
            rec = ln.split("\t", 4)
            if rec[0] == prev:
                continue
            prev = rec[0]
            flag = int(rec[1])
            pos.append(-1 if flag & 4 else int(rec[3]) - 1)
            strand.append(int(bool(flag & 16)))
    return np.array(pos), np.array(strand)


def sw_top1(sam: str, starts: np.ndarray, strands: np.ndarray) -> float:
    """Share of reads whose SAM primary is within 5 bp of the truth, on the
    right strand."""
    pos, strand = sam_primaries(sam)
    if pos.shape != starts.shape:
        raise AssertionError(f"SAM has {pos.size} reads, expected {starts.size}")
    return float(np.mean((np.abs(pos - starts) <= 5) & (strand == strands)))


def phase_genome(results: dict):
    import torch

    from deepreadmapper_tpu_torch import cli, kernels
    from deepreadmapper_tpu_torch.index.int8_flat import (
        quantize_host,
        query_scale_ratio,
    )
    from deepreadmapper_tpu_torch.index.registry import load_index
    from deepreadmapper_tpu_torch.ops import scan_kernel as sk
    from deepreadmapper_tpu_torch.models.encoder import Vectorizer

    work = os.path.join(WORK, "genome")
    os.makedirs(work, exist_ok=True)
    ref, fq, starts, strands, mat, _ = simulate(work)
    idx, out = os.path.join(work, "idx"), os.path.join(work, "out")
    torch.cuda.reset_peak_memory_stats()

    kernels.reset_counts()
    t0 = time.perf_counter()
    if cli.main(["build-index", ref, idx, str(READ_LEN)]) != 0:
        raise AssertionError("genome build-index failed")
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    if cli.main(["pipeline", idx, fq, ref, "128", "128", "5", out, "--no-sam"]) != 0:
        raise AssertionError("genome pipeline failed")
    torch.cuda.synchronize()
    launches = kernels.counts()
    peak = torch.cuda.max_memory_allocated()

    n_windows = 2 * (GENOME_BP - READ_LEN + 1)
    log(f"[genome] build: {n_windows} windows in {t_build:.2f} s "
        f"({n_windows / t_build:.0f} windows/s)")
    log(f"[genome] launches in build-index + pipeline: {launches}")
    log(f"[genome] max_memory_allocated in build-index + pipeline: "
        f"{peak / 2**30:.2f} GiB")
    n_batches = -(-N_READS // 8192)
    if launches["gru_fwd"] <= 0 or launches["int8_winmin"] < 2 * n_batches:
        raise AssertionError(f"main path missed a kernel: {launches}")
    for name in ("gru_fwd", "int8_winmin"):
        results[name]["launches"] = launches[name]

    ids = np.load(os.path.join(out, "indices.npy")).astype(np.int64)
    top = ids[:, 0]
    ok = (np.abs((top >> 1) - starts) <= 5) & ((top & 1) == strands)
    top1 = float(ok.mean())
    log(f"[genome] top-1 (position +-5 bp and strand): {top1:.4f} (need >= 0.99)")
    if top1 < 0.99:
        raise AssertionError(f"genome top-1 {top1} < 0.99")

    # steady state: the same search again, index already resident
    engine, _ = load_index(idx)
    vec = Vectorizer()
    lengths = np.full(N_READS, READ_LEN + 2)
    engine.search(vec.vectorize_wrapped_bytes(mat, lengths), 128)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    q = vec.vectorize_wrapped_bytes(mat, lengths)
    fused_i, fused_d = engine.search(q, 128)
    torch.cuda.synchronize()
    t_steady = time.perf_counter() - t0
    log(f"[genome] steady embed+search: {N_READS} reads in {t_steady:.3f} s "
        f"({N_READS / t_steady:.0f} reads/s)")

    # The fused scan keeps one row per 128-row window (the contract of the
    # JAX package's kernel).  A read's exact top-128 are mostly its own
    # overlapping same-strand windows, which share one or two windows, so
    # the fused list is held to the exact scan only at the top; the fused
    # list itself must equal the plain-driven fused scan bit for bit.
    sub = slice(0, 1024)
    _, ex_d = engine.search(q[sub], 128, exact=True)
    fd = fused_d[sub]
    recall = float(np.mean(fd <= ex_d[:, -1:] * (1 + 1e-6)))
    same_top = float(np.mean(fd[:, 0] == ex_d[:, 0]))
    log(f"[genome] fused vs exact scan on 1024 reads: same top-1 distance "
        f"{same_top:.4f} (need >= 0.99); tie-aware recall@128 {recall:.4f} "
        "(window reduction, not gated)")
    if same_top < 0.99:
        raise AssertionError("fused scan top-1 disagrees with the exact scan")
    sq, ratio = query_scale_ratio(q[sub], engine.scale)
    q8 = torch.from_numpy(quantize_host(q[sub], sq)).cuda()
    codes = engine._device()
    chunk = sk.choose_chunk(codes.shape[0])
    kd, ki = sk.fused_scan_topk(q8, codes, engine.ntotal, 128, chunk, ratio=ratio)
    pd, pi = sk.fused_scan_topk(q8, codes, engine.ntotal, 128, chunk,
                                ratio=ratio, winmin=sk.int8_winmin_reference)
    if not (torch.equal(kd, pd) and torch.equal(ki, pi)):
        raise AssertionError("genome-scale fused scan: kernel != plain version")
    log(f"[genome] fused scan over {codes.shape[0]} rows x 1024 reads: "
        "kernel-driven == plain-driven")


def phase_genome_pq(results: dict):
    """build-index PQFLAT -> pipeline --rerank sw through the CLI on a
    ~10M-window genome: the path of the PQ scan and SW kernels."""
    import contextlib
    import io

    import torch

    from deepreadmapper_tpu_torch import cli, kernels
    from deepreadmapper_tpu_torch.index.int8_flat import (
        quantize_host,
        query_scale_ratio,
    )
    from deepreadmapper_tpu_torch.index.registry import load_index
    from deepreadmapper_tpu_torch.models.encoder import Vectorizer
    from deepreadmapper_tpu_torch.ops import scan_kernel as sk
    from deepreadmapper_tpu_torch.ops import sw

    work = os.path.join(WORK, "genome_pq")
    os.makedirs(work, exist_ok=True)
    ref, fq, starts, strands, mat, _ = simulate(work, PQ_GENOME_BP, N_READS)
    idx, out = os.path.join(work, "idx"), os.path.join(work, "out")
    torch.cuda.reset_peak_memory_stats()

    kernels.reset_counts()
    t0 = time.perf_counter()
    if cli.main(["build-index", ref, idx, str(READ_LEN), "--index-type", "PQFLAT"]) != 0:
        raise AssertionError("PQFLAT build-index failed")
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["pipeline", idx, fq, ref, "128", "10", "128", out,
                       "--rerank", "sw"])
    torch.cuda.synchronize()
    t_pipe = time.perf_counter() - t0
    launches = kernels.counts()
    peak = torch.cuda.max_memory_allocated()
    sys.stdout.write(buf.getvalue())
    if rc != 0:
        raise AssertionError("PQFLAT --rerank sw pipeline failed")

    n_windows = 2 * (PQ_GENOME_BP - READ_LEN + 1)
    log(f"[genome_pq] build: {n_windows} windows in {t_build:.2f} s "
        f"({n_windows / t_build:.0f} windows/s)")
    log(f"[genome_pq] pipeline (load, embed, search, SW rerank, SAM): {t_pipe:.2f} s")
    log(f"[genome_pq] launches in build-index + pipeline: {launches}")
    log(f"[genome_pq] max_memory_allocated in build-index + pipeline: "
        f"{peak / 2**30:.2f} GiB")
    if min(launches["gru_fwd"], launches["pq_winmin"], launches["sw_score"]) <= 0:
        raise AssertionError(f"main path missed a kernel: {launches}")
    for name in ("pq_winmin", "sw_score"):
        results[name]["launches"] = launches[name]

    # SW reranks the search's own candidates (indices.npy, k=10 at stride
    # 1): it must find the true window whenever the search delivered it
    top1 = sw_top1(os.path.join(out, "results.sam"), starts, strands)
    cand = np.load(os.path.join(out, "indices.npy")).astype(np.int64)
    hit = (np.abs((cand >> 1) - starts[:, None]) <= 5) & ((cand & 1) == strands[:, None])
    recall, pq_top1 = float(hit.any(axis=1).mean()), float(hit[:, 0].mean())
    log(f"[genome_pq] SW-reranked top-1 (position +-5 bp and strand): {top1:.4f} "
        f"(need >= {SW_TOP1_FLOOR}, >= the search's top-1 {pq_top1:.4f}, and >= its "
        f"recall@10 {recall:.4f} - 0.001)")
    if top1 < SW_TOP1_FLOOR or top1 < pq_top1 or top1 < recall - 0.001:
        raise AssertionError(f"PQFLAT + SW top-1 {top1} (search top-1 {pq_top1}, "
                             f"recall@10 {recall})")

    # the SW rerank split: host fetch/sort and upload+score+download from
    # the pipeline's own line, the kernel alone by CUDA events on as many
    # pairs of the same widths
    split = [ln for ln in buf.getvalue().splitlines() if ln.startswith("[MAIN] sw rerank")]
    p = N_READS * 10
    a, la, b, lb = (torch.from_numpy(x).cuda()
                    for x in _sw_pairs(np.random.default_rng(4), p))
    t_sw = cuda_time(lambda: sw.sw_scores(a, la, b, lb), 3)
    log(f"[genome_pq] {split[0][7:] if split else 'no sw line'}; the kernel alone on "
        f"{p} pairs: {t_sw:.2f} ms (CUDA events)")

    # steady state: the same embed + search again, index already resident
    engine, _ = load_index(idx)
    vec = Vectorizer()
    lengths = np.full(N_READS, READ_LEN + 2)
    engine.search(vec.vectorize_wrapped_bytes(mat, lengths), 10)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    q = vec.vectorize_wrapped_bytes(mat, lengths)
    fused_i, fused_d = engine.search(q, 10)
    torch.cuda.synchronize()
    t_steady = time.perf_counter() - t0
    log(f"[genome_pq] steady embed+search (k=10): {N_READS} reads in {t_steady:.3f} s "
        f"({N_READS / t_steady:.0f} reads/s)")

    sub = slice(0, 1024)
    _, ex_d = engine.search(q[sub], 10, exact=True)
    same_top = float(np.mean(fused_d[sub, 0] == ex_d[:, 0]))
    log(f"[genome_pq] fused vs exact PQ scan on 1024 reads: same top-1 distance "
        f"{same_top:.4f} (need >= 0.99)")
    if same_top < 0.99:
        raise AssertionError("fused PQ scan top-1 disagrees with the exact scan")
    sq, ratio = query_scale_ratio(q[sub], engine.cb8.scale)
    q8 = torch.from_numpy(quantize_host(q[sub], sq)).cuda()
    codes, cent8 = engine._device()
    chunk = sk.choose_chunk(codes.shape[0])
    kd, ki = sk.fused_scan_topk(q8, codes, engine.ntotal, 128, chunk, ratio=ratio,
                                cent8=cent8)
    pd, pi = sk.fused_scan_topk(q8, codes, engine.ntotal, 128, chunk, ratio=ratio,
                                cent8=cent8, winmin=sk.pq_winmin_reference)
    if not (torch.equal(kd, pd) and torch.equal(ki, pi)):
        raise AssertionError("genome-scale fused PQ scan: kernel != plain version")
    log(f"[genome_pq] fused PQ scan over {codes.shape[0]} rows x 1024 reads: "
        "kernel-driven == plain-driven")
    check_cpu_size_sw()


def check_cpu_size_sw():
    """The genome_pq simulation shrunk to the size the JAX package was run
    at on the CPU, where its search is the exact PQ scan: the port's SW
    rerank of the exact scan's top 10 against the JAX package's top-1, and
    the port's main path (fused scan) beside it."""
    from deepreadmapper_tpu_torch import cli
    from deepreadmapper_tpu_torch.index.registry import load_index
    from deepreadmapper_tpu_torch.models.encoder import Vectorizer
    from deepreadmapper_tpu_torch.pipeline import postprocess as pp

    work = os.path.join(WORK, "cpu_size")
    os.makedirs(work, exist_ok=True)
    ref, fq, starts, strands, mat, genome = simulate(work, CPU_SIZE_BP, CPU_SIZE_READS)
    idx, out = os.path.join(work, "idx"), os.path.join(work, "out")
    if cli.main(["build-index", ref, idx, str(READ_LEN), "--index-type", "PQFLAT"]) != 0:
        raise AssertionError("CPU-size PQFLAT build-index failed")
    if cli.main(["pipeline", idx, fq, ref, "128", "10", "128", out, "--rerank", "sw"]) != 0:
        raise AssertionError("CPU-size SW pipeline failed")
    fused_top1 = sw_top1(os.path.join(out, "results.sam"), starts, strands)
    engine, _ = load_index(idx)
    lengths = np.full(CPU_SIZE_READS, READ_LEN + 2)
    cand, _ = engine.search(Vectorizer().vectorize_wrapped_bytes(mat, lengths), 10,
                            exact=True)
    ids, _ = pp.post_process_sw(cand, mat, lengths, lambda x: fetch_windows(genome, x),
                                1, 10, 10, 2 * (CPU_SIZE_BP - READ_LEN + 1))
    top = ids[:, 0]
    hits = int(np.sum((np.abs((top >> 1) - starts) <= 5) & ((top & 1) == strands)))
    log(f"[cpu_size] {CPU_SIZE_BP} bp, {CPU_SIZE_READS} reads: SW top-1 over the exact "
        f"scan's top 10 {hits}/{CPU_SIZE_READS} (need >= {JAX_SW_TOP1_READS}, the JAX "
        f"package's recorded CPU reading); the main path (fused scan) {fused_top1:.4f}")
    if hits < JAX_SW_TOP1_READS:
        raise AssertionError(f"CPU-size SW top-1 {hits} < {JAX_SW_TOP1_READS} reads")


def main() -> int:
    sys.path.insert(0, ROOT)
    name, smi = phase_device()
    import deepreadmapper_tpu_torch  # noqa: F401  (fails outside a checkout)

    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    results = {}
    t0 = time.perf_counter()
    phase_build()
    check_gru(results)
    check_int8(results)
    check_sw(results)
    check_pq(results)
    phase_fixture()
    phase_genome(results)
    phase_genome_pq(results)
    shutil.rmtree(WORK, ignore_errors=True)
    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")
    log(f"[done] all phases in {time.perf_counter() - t0:.1f} s; jax never imported")

    from deepreadmapper_tpu_torch import kernels

    replaces = {
        "gru_fwd": "deepreadmapper_tpu/models/gru_pallas.py:82",
        "int8_winmin": "deepreadmapper_tpu/ops/scan_kernel.py:112",
        "sw_score": "deepreadmapper_tpu/ops/sw_pallas.py:38",
        "pq_winmin": "deepreadmapper_tpu/ops/scan_kernel.py:143",
    }
    rows = [
        {"name": k.name, "route": "cuda",
         "source": os.path.relpath(k.source, ROOT),
         "replaces": replaces[k.name], **results[k.name]}
        for k in kernels.ALL
    ]
    print(json.dumps({"kernels": rows}))
    print(smi)
    import torch

    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
