#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of the read mapper on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

Phases (any failure raises and the exit code is not 0):
  1. device   name, nvidia-smi name/power limit; TF32 off
  2. build    nvcc builds every kernel of the main path from csrc/
  3. kernels  each kernel against its plain PyTorch version at main-path
              shapes, with CUDA-event times of both
  4. fixture  the port's CLI build-index -> pipeline on tests/data/ecoli_150
              (truth check: read position within 2 bp among the top 128)
  5. genome   build-index -> pipeline on a seeded 2 Mbp genome and 8192
              simulated 150 bp reads; top-1 accuracy, launch counts, the
              fused scan against the exact scan (top-1) and against its
              plain-driven self (bit for bit)
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
GENOME_BP, N_READS, READ_LEN = 2_000_000, 8192, 150


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
    from deepreadmapper_tpu_torch import kernels

    for k in kernels.ALL:
        so = k.build()
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


def simulate(work: str):
    """Seeded genome FASTA + wgsim-style reads (uniform start, either strand,
    1% substitutions) as a FASTQ whose read names carry _<start>_<strand>_<i>,
    and the same reads as a '<'-wrapped byte matrix."""
    rng = np.random.default_rng(0)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    g = rng.integers(0, 4, GENOME_BP).astype(np.uint8)
    ref = os.path.join(work, "ref.fna")
    with open(ref, "wb") as f:
        f.write(b"> synthetic\n")
        body = acgt[g]
        for i in range(0, GENOME_BP, 80):
            f.write(body[i : i + 80].tobytes() + b"\n")
    rng = np.random.default_rng(1)
    starts = rng.integers(0, GENOME_BP - READ_LEN + 1, N_READS)
    strands = rng.integers(0, 2, N_READS)
    reads = g[starts[:, None] + np.arange(READ_LEN)[None, :]]
    rev = strands == 1
    reads[rev] = 3 - reads[rev][:, ::-1]  # reverse complement (A<->T, C<->G)
    mask = rng.random((N_READS, READ_LEN)) < 0.01
    reads[mask] = rng.integers(0, 4, int(mask.sum()))
    fq = os.path.join(work, "reads.fastq")
    qual = b"I" * READ_LEN
    with open(fq, "wb") as f:
        for i in range(N_READS):
            f.write(b"@_%d_%d_%d\n%s\n+\n%s\n" % (
                starts[i], strands[i], i, acgt[reads[i]].tobytes(), qual))
    wrapped = np.concatenate([
        np.full((N_READS, 1), ord("<"), np.uint8), acgt[reads],
        np.full((N_READS, 1), ord(">"), np.uint8)], axis=1)
    return ref, fq, starts, strands, wrapped


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
    ref, fq, starts, strands, mat = simulate(work)
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
    for name, n in launches.items():
        results[name]["launches"] = n

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
    phase_fixture()
    phase_genome(results)
    shutil.rmtree(WORK, ignore_errors=True)
    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")
    log(f"[done] all phases in {time.perf_counter() - t0:.1f} s; jax never imported")

    from deepreadmapper_tpu_torch import kernels

    replaces = {
        "gru_fwd": "deepreadmapper_tpu/models/gru_pallas.py:82",
        "int8_winmin": "deepreadmapper_tpu/ops/scan_kernel.py:112",
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
