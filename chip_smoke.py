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
              simulated 150 bp reads; top-1 accuracy, launch counts,
              steady reads/s (median of 5 passes), the fused scan against the exact scan (top-1) and against its
              plain-driven self (bit for bit)
  6. genome_pq build-index --index-type PQFLAT -> pipeline --rerank sw on a
              seeded 5 Mbp genome (~10M windows) and 8192 reads; SW top-1
              from the SAM, launch counts of the PQ scan and SW kernels,
              the SW rerank's host/kernel split, the fused PQ scan against
              its plain-driven self (bit for bit); then the same simulation
              shrunk to the JAX package's CPU size (200 kbp, 1024 reads),
              SW top-1 over the exact scan's candidates
  7. genome_ivf build-index --index-type IVFINT8 (auto nlist) -> pipeline at
              nprobe 32 on a seeded 20 Mbp genome (39,999,702 windows) and
              8192 reads (host plan + fold); in process 2048 reads (host
              plan + packed) and 256 reads (fused device plan); top-1 against
              the exhaustive int8 scan of the index's own codes
  8. genome_ivfpq the same three routes on phase 6's genome and reads with
              --index-type IVFPQ; codes and codebook against phase 6's PQFLAT
              build, top-1 against its search
  9. finetune on phase 5's genome: one training step's gradients on the
              card against the same step on the CPU; the CLI's finetune at
              its defaults (100 steps, batch 512, lr 1e-4; the loss must
              fall); a profile of three steps; build-index --weights ->
              pipeline on phase 5's reads (top-1 >= phase 5's - 0.01)
 10. genome_sam on phase 5's index, genome and reads at k 10: pipeline
              --mapq --cigar --qual --read-group --sort --mark-duplicates
              --bam (SEQ + CIGAR + MD rebuild the genome, CIGARs cover 150
              bases, POS, MAPQ range, QUAL, RG, sort order, BAM + BAI);
              use_streaming 1 == 0 byte for byte; --mapq-calibrated ==
              calibrate_mapq(raw); --rerank sw --mapq launches sw_score;
              inference == the pipeline's embeddings; the bf16 Vectorizer's
              top-1; serve in process == the one-shot pipeline; the bench
              twin's line and ids; --profile names gru_fwd and int8_winmin
 11. genome_pe a seeded 5 Mbp genome with 5% planted 2 kb repeats, 4,096 FR
              pairs (insert 500 +- 50, 2% substitutions), INT8FLAT, k 16:
              each end single-end, then run_pipeline_paired --max-isize
              700 --mapq (proper-pair rate, paired top-1 per end against
              single-end, MAPQ >= 30 precision, the split), --rerank sw
              through the CLI (launches sw_score), a serve fastq2 request
              (== the one-shot run); genome_lr on phase 5's index: 256
              reads each of 1 and 5 kb at 1% and 5% error (40% indels) and
              a chimera, --long-reads --cigar --mapq (top-1, MAPQ >= 30
              precision, FLAG 2048, SEQ + CIGAR + MD rebuild the genome,
              the host_pack / embed / search / chain split, the scan's
              workspace above the resident index)
 12. genome_hnsw the graph engines at the reference's default index parameters
              (M_pq 8, nbits 8, M_hnsw 16, EFC 200, ef 128), 8192 reads: (a)
              HNSWPQ by the native insert builder on a seeded 20 kbp genome
              (39,702 windows), recall@10 against the exact fp32 top-10
              (first 1024 reads: against the JAX package's CPU reading) and
              overlap@64 with the exhaustive scan of the index's own codes;
              (b) the same genome at stride 4 with k_clusters 5 (the
              re-embed + L2 rerank), SAM top-1 on the first 1024 reads
              against the JAX package's CPU reading; (c) HNSWFLAT
              --build-mode knn --level-mode centroid on a seeded 100 kbp
              genome (199,702 windows, kNN graph on the card), recall@10;
              the build splits, search times, reads/s, effort counters and a
              profile of one search
 13. genome_shard the sharded index on the one card, phase 5's genome and
              reads: (a) in one process, build-index --shards 4 -> pipeline
              (INT8FLAT; top-1 against phase 5's, int8_winmin on every shard,
              the steady search against phase 5's unsharded index, memory per
              shard), FLAT over the same embeddings (--shards 4 and
              sharded_l2_topk against the unsharded exact search), PQFLAT
              --shards 2 -> --rerank sw, IVFINT8 and IVFPQ --shards 2 at
              nprobe 32 (fold and packed routes), each against the unsharded
              engine over the same codes, and HNSWPQ --shards 2 at phase 12
              (a)'s size against its recall; (b) the CLI under torchrun
              (build-index --distributed --shards 4, pipeline --distributed,
              a 1-rank NCCL group) and (c) the API in two spawned ranks on
              the one card (gloo collectives): their indices.npy,
              distances.npy and results.sam equal (a)'s byte for byte, and
              rank 1 writes no file
 14. finetune_dp data-parallel fine-tuning on phase 5's genome: (a) two gloo
              ranks on the one card through the API, 10 steps at the CLI's
              global batch of 512 (256 a rank), seed 0, against the
              one-process finetune of the same steps on the card (losses
              rtol 1e-4, each weight's update within rule C7), one step's
              gradient summed over the ranks against the one-process
              gradient (within 1e-4 of each tensor's largest value), the
              ranks' weights and gradients equal byte for byte, rank 1 never
              saves the state, gru_fwd 12 and gru_bwd 8 launches a step on
              each rank, the step time per rank and the collectives' share
              of it; (b) the CLI under torchrun (finetune --distributed, a
              1-rank NCCL group, so no collective runs: the CLI's plumbing)
              against the same command without --distributed (the fp32 weights of
              their --state files within C7; each npz is its state's weights
              in fp16); (c) the one-process run of (a) under utils.trace's
              stage and device_trace: the Chrome trace names gru_fwd and
              gru_bwd
 15. graft_entry the twin of __graft_entry__.py (graft_entry.py): entry()'s forward on the
              card against entry(device="cpu") (rule C2, gru_fwd launched);
              dryrun_multichip(4), four shards on the one card (and at the
              card count when that is another count above 1): one training
              step, the sharded search of every engine against its oracle,
              the sharded fixture SAM, paired and long-read passes
Phase 6 also builds a PQFLAT at M_pq 64 over 600,000 of its genome's
windows (fused route; top-1 distance bit for bit the exact scan's on reads
rescaled under the codebook's scale, and at the reads' own scale the same
row or distance) and runs pipeline --rerank sw at ref_len 600 on the 200
kbp genome (the kernel launched); phase 8 builds IVFPQ at M_pq 64 on the fixture and maps
150 reads (#7) and 4,200 (#8) through the CLI.
Phase 3 also times the int8 scan at the main path's 2^21-row chunk (its
results line), holds the four IVF chunk scans against their plain versions
on a chunked layout of >= 2^21 rows under an 8192-query x nprobe-32 plan
(and times the fold pass of #6 and #8 alone on it), and the GRU backward's
cotangent recurrence at the training batch (512) and at 8192, and times the
GRU forward per encoder batch (B = 8192) and per launch at the training
batch.  It holds the Smith-Waterman kernel to its plain version bit for bit
on edge cases (P 0-3, the two pairs of a register apart in length, lr 512,
lc > lr in one pass and in two, each G forced) and at the SW rerank's
launch sizes (5,120 and 17,920 pairs) and 65,536, times it at those three,
measures the DPX add-max rate its bound divides by, and counts the DPX
instructions in its SASS.  It holds the shapes past the old limits to their
plain versions bit for bit and times them beside their bounds: pq_winmin at
m 64 and 128, the IVFPQ scans (#7, #8) at m 2 and 64 on the IVF layout, and
sw_score at 600 x 150 and 2,000 x 150 (windows against reads: the reads
become the rows), 600 x 600 and 2,000 x 2,000; and sw_score's wider tiers
(SW_TIERS: 5,000 x 5,000 and 14,600 x 14,600 in "global", 32,768 x 32,800
in "int32"), one launch each, bit for bit, with the scratch bytes, the
tier and the bound at the s16x2 or s32 DPX rate it measures.  Phase 6
also runs build-index at ref_len 6,000 on a 50 kbp genome and pipeline
--rerank sw on 512 reads of 6 kb (sw_score's "global" tier), and holds
that rerank on the card to its CPU run on the same candidates.
The last lines are one JSON object of kernel results (time, plain time,
bound, library time, launches on the main path, and rank 0's launches in
phase 14 (a)), the nvidia-smi line, and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

from collections import Counter

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, ".smoke")
FIXTURE = os.path.join(ROOT, "tests", "data")

GRU_B, GRU_T = 8192, 123
TRAIN_B, TRAIN_STEPS = 512, 100     # the finetune CLI's default batch and steps
SCAN_ROWS, SCAN_Q = 1 << 18, 8192
SCAN_CHUNK = 1 << 21                # the INT8FLAT main path's chunk (choose_chunk: 8 x 2^18)
# SW pairs a launch, 150 x 152 bytes: a query chunk of the SW rerank (512
# reads) at stride 1 and k_clusters 10, the main path's (phase 6 makes 16);
# one at stride 4 and k_clusters 5 (35 candidates a read); the shape of the
# first version's table row
SW_PAIRS = (5120, 17920, 65536)
# (a width, b width) past the kernel's old 512-byte rows, at SW_PAIRS[0] pairs:
# windows of ref_len 600 / 2,000 against reads (the wrapper swaps them), and
# wide rows on both sides (one pass; passes with edges in shared memory)
SW_WIDE = ((600, 150), (2000, 150), (600, 600), (2000, 2000))
# (a width, b width, pairs) past the shared tier's 4,842-byte rows: the
# "global" tier (one pass and four; twelve passes) and the "int32" tier past
# 32,767-byte rows; few pairs where the plain version walks 29k-66k
# anti-diagonals
SW_TIERS = ((5000, 5000, 1024), (14600, 14600, 256), (32768, 32800, 4))
# phase 6's pipeline --rerank sw past shared memory: ref_len 6,000 windows
# against 6 kb reads (6,002 wrapped), one rerank chunk of 512 reads x 10
WIDE_SW_REF_LEN, WIDE_SW_GENOME_BP, WIDE_SW_READS = 6000, 50_000, 512
WIDE_SW_CPU_READS = 2               # reads the CPU rerank repeats (20 pairs)
PQ_M64_ROWS = 600_000               # phase 6's PQFLAT at M_pq 64: >= 2^19 windows
SW_WIDE_REF_LEN = 600               # phase 6's pipeline --rerank sw past the old 512-byte rows
PQ_MS = (8, 16, 64, 128)            # phase 3's pq_winmin m: 64 and 128 take 2- and 1-byte entries
IVF_PQ_MS = (2, 64)                 # phase 3's extra IVFPQ m (the main layout runs m 8)
GENOME_BP, N_READS, READ_LEN = 2_000_000, 8192, 150
PQ_GENOME_BP = 5_000_000            # ~10M windows: the README's PQFLAT tier
SW_TOP1_FLOOR = 0.96                # main path at 5 Mbp (PERF.md section 2)
CPU_SIZE_BP, CPU_SIZE_READS = 200_000, 1024  # the simulation shrunk to CPU size
# SW top-1 (reads of CPU_SIZE_READS) that the JAX package reaches there on the
# CPU, where its search is the exact scan: the gate of the port's exact-scan
# SW rerank at that size.  Recorded, not measured here (this script imports
# no JAX): `python scripts/sw_top1_cpu_size.py --package jax` prints it.
JAX_SW_TOP1_READS = 1021
IVF_GENOME_BP = 20_000_000          # 39,999,702 windows: the JAX package's IVF record shape
IVF_NPROBE = 32
IVF_KERNEL_ROWS = 1 << 21           # the IVF kernels' layout in phase 3 holds at least this
# H100 SXM peak rates (NVIDIA H100 datasheet) for the bound of each kernel
HBM_BYTES_S = 3.35e12
INT8_OPS_S = 1979e12                # int8 tensor cores, dense
FP32_OPS_S = 67e12                  # fp32 outside the tensor cores (an FMA is 2)
TF32_OPS_S = 495e12                 # TF32 tensor cores, dense
# 32-bit integer add / compare / min / max: 64 results per SM per clock at
# compute capability 9.0 (CUDA C++ Programming Guide), 132 SMs, 1.98 GHz
INT32_OPS_S = 132 * 64 * 1.98e9
# The fewest instructions a Smith-Waterman cell needs on this card: DPX
# carries two cells a register in 16-bit halves, and two cells take the
# match xor, its add-max to {0, 2}, the add-max of diagonal and up, the
# relu add-max of left, the add-max that keeps H - 1, and half a three-way
# max for the best (csrc/sw_score.cu): 5.5 instructions for two cells.  The
# rate is DPX's as check_sw measures it (NVIDIA's data sheet gives none).
SW_OPS_PER_CELL = 5.5 / 2
# The "int32" tier runs the same steps on one cell a register: 5.5 a cell,
# at the s32 DPX rate check_sw measures (its SASS count is logged beside it)
SW32_OPS_PER_CELL = 5.5
SAM_K = 10                          # phase 10's k: 81,920 SAM lines for 8192 reads
BENCH_REPS = 100                    # the bench twin's tiling: bench.py's 15,000 reads
# phase 11: results/eval_paired_r3_5mbp.json's shape (scripts/eval_paired.py)
PE_GENOME_BP, PE_PAIRS, PE_K = 5_000_000, 4096, 16
PE_ISIZE, PE_ISIZE_SD, PE_ERR = 500, 50, 0.02
PE_MAX_ISIZE = PE_ISIZE + 4 * PE_ISIZE_SD
PE_REPEAT_FRAC, PE_REPEAT_BLOCK = 0.05, 2_000
# paired top-1 (R1, R2) the JAX package reached at that shape on a TPU
# (results/eval_paired_r3_5mbp.json): the gate is this less 0.01
JAX_PE_TOP1 = (0.9451, 0.9468)
# phase 11's long reads: scripts/eval_longread.py's grid at its default size
LR_LENS, LR_ERRS, LR_READS = (1_000, 5_000), (0.01, 0.05), 256
# phase 12: the reference's default index parameters (BASELINE.md: M_pq 8,
# nbits 8, M_hnsw 16, EFC 200, ef 128 -- build-index's and pipeline's defaults)
HNSW_GENOME_BP = 20_000             # 39,702 windows: the README's "sim 40k win" row
HNSW_KNN_GENOME_BP = 100_000        # 199,702 windows: results/centroid_levels_r2.json's genome
HNSW_EF = 128
HNSW_SPARSE_STRIDE = 4
HNSW_GATE_READS = 1024             # (a) and (b) are gated on the first 1024 reads
HNSW_SPARSE_ARGS = (str(HNSW_EF), "10", "5")  # ef, k, k_clusters: 5 hits x 7 windows
# (a)'s recall@10 and (b)'s top-1 (first HNSW_GATE_READS reads) that the JAX
# package reaches on the CPU on the same seeded inputs: `python
# scripts/hnsw_cpu_size.py --package jax` prints them.  Recorded, not measured
# here (no JAX import).
JAX_HNSW_RECALL10 = 0.7844  # the port on the CPU: 0.7846; the exhaustive scan of the codes: 0.7838
JAX_HNSW_SPARSE_TOP1 = 942 / HNSW_GATE_READS  # 0.9199; a second run 940 (the native build
# inserts in parallel above 1,024 rows); the port on the CPU: 942 in two runs
# phase 13: the sharded index on the one card
SHARD_N = 4                         # (a)'s INT8FLAT shards of phase 5's genome: 999,926 rows each
SHARD_N_OTHER = 2                   # PQFLAT, IVFINT8, IVFPQ and HNSWPQ shards
SHARD_FLAT_READS = 1024             # the exact fp32 search's reads (bounds its score tiles)
SHARD_PACKED_READS = 2048           # the IVF packed route's batch (#5, #7): 2048 x 32 pairs
SHARD_TIMEOUT = 300                 # seconds for each process phase 13 starts
DP_STEPS, DP_RANKS = 10, 2           # phase 14: steps, gloo ranks on the one card
# bwa's tab form with literal "\t" escapes; io.sam.parse_read_group (both
# packages) takes the fields without bwa's leading "@RG"
SAM_RG = "ID:smoke\\tSM:s1"
BGZF_EOF = bytes.fromhex("1f8b08040000000000ff0600424302001b0003000000000000000000")
# bench.py's JSON keys: the bench twin's line must carry exactly these
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "device_qps", "qps_median",
              "device_qps_median", "e2e_trials_s", "device_trials_s", "stage_s"}


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


def bound(nbytes: float, ops: float, ops_s: float) -> dict:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over the peak rate for their type."""
    t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, ops / ops_s * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def sass_opcodes(so: str, fragment: str) -> dict:
    """Opcode counts of each function of a built library whose name holds
    fragment, from `cuobjdump -sass` of the toolkit that built it."""
    import re

    from deepreadmapper_tpu_torch import kernels

    tool = os.path.join(os.path.dirname(kernels.nvcc_path()), "cuobjdump")
    text = subprocess.run([tool, "-sass", so], capture_output=True, text=True,
                          check=True).stdout
    funcs, cur = {}, None
    for ln in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", ln)
        if m:
            cur = funcs.setdefault(m.group(1), Counter()) if fragment in m.group(1) else None
            continue
        m = re.match(r"\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)", ln)
        if m and cur is not None:
            cur[m.group(1)] += 1
    return funcs


def strip_name(func: str) -> str:
    """'S=5' for sw_score_kernel<5, SHARED, false>'s mangled name (and an
    older checkout's sw_score_kernel<5> or <5, SHARED>), 'S=40 global' /
    'S=40 int32' for the wider tiers' kernels, ' by id' after either for the
    by-id flavour's, else the name."""
    import re

    m = re.search(r"sw_score_kernelILi(\d+)E(?:Li(\d)E)?(Lb1E)?", func)
    if not m:
        return func
    tier = ("", " global", " int32")[int(m.group(2) or 0)]
    return f"S={m.group(1)}{tier}{' by id' if m.group(3) else ''}"


def dpx_count(ops) -> int:
    """DPX instructions among SASS opcode counts: VIADDMNMX, VIMNMX3 and the
    16x2 forms of VIMNMX (Hopper's plain integer max is VIMNMX too)."""
    return sum(n for op, n in ops.items()
               if op.startswith(("VIADDMNMX", "VIMNMX3"))
               or (op.startswith("VIMNMX") and "16" in op))


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
    per_source = list({k.source_name: k for k in kernels.ALL}.values())
    with ThreadPoolExecutor(len(per_source)) as pool:  # one nvcc per source, all at once
        libs = list(pool.map(lambda k: k.build(), per_source))
    log(f"[build] all kernels in {time.perf_counter() - t0:.1f} s")
    for k, so in zip(per_source, libs):
        log(f"[build] {k.source_name}: {os.path.relpath(so, ROOT)} in "
            f"{k.build_seconds if k.build_seconds is not None else 0.0:.1f} s")
        for line in k.build_log.splitlines():
            if "ptxas info" in line and ("Used" in line or "spill" in line
                                         or "Compiling" in line):
                log(f"[build]   {line.strip()}")


def _gru_inputs(din: int, dtype, rng, b: int = GRU_B):
    import torch

    from deepreadmapper_tpu_torch.models.encoder import load_params

    layer = load_params()["layers"][0 if din == 64 else 1]
    x = rng.uniform(-1.0, 1.0, (GRU_T, b, din)).astype(np.float32)
    dev = torch.device("cuda")
    p = [torch.from_numpy(layer[k][0]).to(dev, dtype) for k in ("w", "bzr", "r", "rbh")]
    return torch.from_numpy(x).to(dev, dtype), p


def _tf32_exact(t) -> bool:
    """Whether every value of t is a TF32 value: its 13 low mantissa bits are 0."""
    import torch

    return bool(((t.float().contiguous().view(torch.int32) & 0x1FFF) == 0).all())


def _gru_tf32_passes(x, w, r) -> tuple:
    """The TF32 passes an fp32-accurate x W and h R need on these operands:
    hi hi, plus lo hi unless the left operand is TF32, plus hi lo unless the
    weights are.  The carry h is fp32 and takes its remainder pass."""
    return 1 + (not _tf32_exact(x)) + (not _tf32_exact(w)), 2 + (not _tf32_exact(r))


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

    # the library yardstick: cuDNN's bidirectional GRU (fp32, TF32 off) on
    # the same two layer inputs; the port never calls it
    lib1 = torch.nn.GRU(64, 64, bidirectional=True).cuda()
    lib2 = torch.nn.GRU(128, 64, bidirectional=True).cuda()

    def library():
        with torch.no_grad():
            lib1(x1)
            lib2(x2)

    t_plain_a = cuda_time(batch(gru.gru_reference), 3)
    t_kernel = cuda_time(batch(kernel_impl), 10)
    t_lib = cuda_time(library, 10)
    t_plain_b = cuda_time(batch(gru.gru_reference), 3)
    t_plain = (t_plain_a + t_plain_b) / 2
    # 2 directions x T steps x B rows x (input + recurrent products) x 3 gates
    ops = sum(2 * GRU_T * GRU_B * 2 * (din + 64) * 192 for din in (64, 128))
    nbytes = 4 * GRU_T * GRU_B * (64 + 128) + 4 * GRU_T * GRU_B * 64 * 2 + 4 * GRU_B * 64 * 2
    # fp32 accuracy on the tensor cores: the TF32 passes these inputs need
    # (the shipped weights come from fp16 and need no remainder pass); the
    # three passes of any fp32 weights and the fp32 bound outside the tensor
    # cores are kept for the log
    passes = {din: _gru_tf32_passes(x, p[0], p[2]) for din, x, p in ((64, x1, p1), (128, x2, p2))}
    tc_ops = sum(2 * GRU_T * GRU_B * 2 * 192 * (din * pxw + 64 * phr)
                 for din, (pxw, phr) in passes.items())
    bd = bound(nbytes, tc_ops, TF32_OPS_S)
    log(f"[kernels] gru encoder batch (4 calls, B={GRU_B}, fp32): kernel "
        f"{t_kernel:.3f} ms | plain {t_plain_a:.3f} / {t_plain_b:.3f} ms | cuDNN "
        f"torch.nn.GRU {t_lib:.3f} ms | {ops / 1e9:.1f} GFLOP | bound {bd['bound_ms']:.3f} ms "
        f"(TF32 passes x W, h R on these inputs: "
        f"{', '.join(f'din {d} {a}, {b}' for d, (a, b) in passes.items())}; "
        f"3 passes {bound(nbytes, 3 * ops, TF32_OPS_S)['bound_ms']:.3f} ms; fp32 outside "
        f"the tensor cores {bound(nbytes, ops, FP32_OPS_S)['bound_ms']:.3f} ms)")
    results["gru_fwd"] = {"max_abs_err": worst, "ms": t_kernel, "plain_ms": t_plain,
                          **bd, "library_ms": t_lib}
    # one launch at the training batch, per layer, as fine-tuning calls them
    for din, last in ((64, False), (128, True)):
        x, p = _gru_inputs(din, torch.float32, rng, TRAIN_B)
        fn = gru.gru_proj_last if last else gru.gru_proj_seq
        log(f"[kernels] gru one launch at B={TRAIN_B} din={din} "
            f"({'last' if last else 'seq'}, fp32): "
            f"{cuda_time(lambda: fn(x, *p, False), 20):.3f} ms")


def _bwd_inputs(b: int, reverse: bool, rng):
    """Cotangent-recurrence inputs at [GRU_T, b, 64] on the card as the main
    path makes them: the gates of a forward of the shipped layer 1 (in the
    given direction) over uniform inputs, a normal cotangent, and rT."""
    import torch

    from deepreadmapper_tpu_torch.models import gru
    from deepreadmapper_tpu_torch.models.encoder import load_params

    layer = load_params()["layers"][0]
    w, bzr, r, rbh = (torch.from_numpy(layer[k][int(reverse)]).cuda()
                      for k in ("w", "bzr", "r", "rbh"))
    x = torch.from_numpy(rng.uniform(-1, 1, (GRU_T, b, 64)).astype(np.float32)).cuda()
    hs = gru.gru_proj_seq(x, w, bzr, r, rbh, reverse)
    gates = gru.recompute_gates(x, w, bzr, r, rbh, hs, reverse)
    ct = torch.from_numpy(rng.standard_normal((GRU_T, b, 64)).astype(np.float32)).cuda()
    return [*gates, ct], r.T.contiguous()


def check_gru_bwd(results: dict):
    """Kernel #9 against its plain version at the training batch, at 8192
    and at a ragged batch, both walks, on both outputs (dgx [T,B,192], dghn
    [T,B,64]); CUDA-event times at 512 and 8192; the whole two-layer GRU
    gradient beside cuDNN's."""
    import torch

    from deepreadmapper_tpu_torch.models import gru

    rng = np.random.default_rng(7)
    worst = 0.0
    for b in (TRAIN_B, GRU_B, 1001):
        for reverse in (False, True):
            ins, rT = _bwd_inputs(b, reverse, rng)
            got = gru.gru_bwd(*ins, rT, reverse)
            want = gru.gru_bwd_reference(*ins, rT, reverse)
            torch.cuda.synchronize()
            errs = [(float((g - w).abs().max()), float(w.abs().max())) for g, w in zip(got, want)]
            rel = max(e / m for e, m in errs)
            tag = f"B={b} {'rev' if reverse else 'fwd'}"
            if not (all(g.shape == w.shape for g, w in zip(got, want)) and rel <= 1e-5):
                raise AssertionError(f"gru_bwd {tag}: max rel err {rel} > 1e-5")
            worst = max([worst] + [e for e, _ in errs])
            log(f"[kernels] gru_bwd {tag}: max abs err {max(e for e, _ in errs):.3e}, over "
                f"the max abs value {rel:.3e} (tol 1e-5)")
        del ins, got, want
    times = {}
    for b in (TRAIN_B, GRU_B):
        ins, rT = _bwd_inputs(b, False, rng)
        t_plain_a = cuda_time(lambda: gru.gru_bwd_reference(*ins, rT), 2)
        t_kernel = cuda_time(lambda: gru.gru_bwd(*ins, rT), 20)
        t_plain_b = cuda_time(lambda: gru.gru_bwd_reference(*ins, rT), 2)
        # each sequence and step: 6 x 64 fp32 in, dgx 192 + dghn 64 fp32 out
        # (2,560 B); 192 x 64 FMA.  The earlier outputs, dgx and dgh [.., 192],
        # made it 3,072 B: logged beside it so the history reads on
        ops = 2.0 * GRU_T * b * 192 * 64
        bd = bound(4.0 * GRU_T * b * (6 * 64 + 192 + 64), ops, FP32_OPS_S)
        bd_old = bound(4.0 * GRU_T * b * (6 * 64 + 2 * 192), ops, FP32_OPS_S)
        times[b] = (t_kernel, (t_plain_a + t_plain_b) / 2, bd)
        log(f"[kernels] gru_bwd T={GRU_T} B={b}: kernel {t_kernel:.3f} ms | plain "
            f"{t_plain_a:.3f} / {t_plain_b:.3f} ms | bound {bd['bound_ms']:.4f} ms "
            f"({bd['bound_by']}; 2,560 B a sequence and step; with dgh stored whole, "
            f"3,072 B: {bd_old['bound_ms']:.4f} ms)")
        del ins
    t_kernel, t_plain, bd = times[TRAIN_B]
    results["gru_bwd"] = {"max_abs_err": worst, "ms": t_kernel, "plain_ms": t_plain, **bd,
                          "library_ms": None}
    _gru_grad_yardstick()


def _gru_grad_yardstick():
    """The two bidirectional layers' forward + backward at the training
    batch: the port (kernels #1 and #9, the hoisted matmuls) beside cuDNN's
    torch.nn.GRU (fp32, TF32 off), which the port never calls."""
    import torch

    from deepreadmapper_tpu_torch.models import gru
    from deepreadmapper_tpu_torch.models.encoder import load_params

    gen = torch.Generator(device="cuda").manual_seed(0)
    x1 = torch.randn(GRU_T, TRAIN_B, 64, device="cuda", generator=gen, requires_grad=True)
    lp = [{k: torch.from_numpy(layer[k]).cuda().requires_grad_() for k in layer}
          for layer in load_params()["layers"]]

    def port():
        out1 = torch.cat([gru.gru_proj_seq(x1, lp[0]["w"][d], lp[0]["bzr"][d], lp[0]["r"][d],
                                           lp[0]["rbh"][d], bool(d)) for d in (0, 1)], -1)
        h_t = torch.cat([gru.gru_proj_last(out1, lp[1]["w"][d], lp[1]["bzr"][d],
                                           lp[1]["r"][d], lp[1]["rbh"][d], bool(d))
                         for d in (0, 1)], -1)
        h_t.sum().backward()

    lib1 = torch.nn.GRU(64, 64, bidirectional=True).cuda()
    lib2 = torch.nn.GRU(128, 64, bidirectional=True).cuda()

    def library():
        out1, _ = lib1(x1)
        _, h_n = lib2(out1)
        h_n.sum().backward()

    t_lib_a = cuda_time(library, 10)
    t_port = cuda_time(port, 10)
    t_lib_b = cuda_time(library, 10)
    log(f"[kernels] GRU forward + backward, 2 bidirectional layers, T={GRU_T} B={TRAIN_B} "
        f"fp32: port (kernels #1, #9 + matmuls) {t_port:.3f} ms | cuDNN torch.nn.GRU "
        f"{t_lib_a:.3f} / {t_lib_b:.3f} ms")


def check_int8(results: dict):
    import torch

    from deepreadmapper_tpu_torch.ops import scan_kernel as sk

    dev = torch.device("cuda")
    rng = np.random.default_rng(1)
    q8 = torch.from_numpy(rng.integers(-127, 128, (SCAN_Q, 128), dtype=np.int8)).to(dev)
    # tie-heavy: every row one of 16 patterns of values in {-2..2}, so most
    # window minima are shared and only the lowest-row rule decides
    patterns = rng.integers(-2, 3, (16, 128), dtype=np.int8)
    cases = [
        ("full-range ratio 1", lambda: rng.integers(-127, 128, (SCAN_ROWS, 128), dtype=np.int8),
         2.0),
        ("full-range ratio 1.3",
         lambda: rng.integers(-127, 128, (SCAN_ROWS, 128), dtype=np.int8),
         2.0 * float(np.float32(1.3))),
        ("tie-heavy ratio 1", lambda: patterns[rng.integers(0, 16, SCAN_ROWS)], 2.0),
    ]
    worst = 0.0
    for tag, rows, ratio2 in cases:
        r8 = torch.from_numpy(rows()).to(dev)
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
    tops = 2.0 * SCAN_ROWS * SCAN_Q * 128 / (t_kernel * 1e-3) / 1e12
    log(f"[kernels] int8_winmin {SCAN_ROWS} rows x {SCAN_Q} queries: kernel "
        f"{t_kernel:.3f} ms ({tops:.1f} int8 TOP/s) | plain {t_plain_a:.3f} / "
        f"{t_plain_b:.3f} ms")
    # the main path's launch (phase 5's INT8FLAT search), held and timed
    # at ratio 1
    rows = SCAN_CHUNK
    del r8, rs, d, i, dr, ir
    r8 = torch.from_numpy(rng.integers(-127, 128, (rows, 128), dtype=np.int8)).to(dev)
    v, a = sk.int8_winmin(q8, r8, rows - 1000, 2.0)
    vr, ar = sk.int8_winmin_reference(q8, r8, rows - 1000, 2.0)
    torch.cuda.synchronize()
    if not (torch.equal(v, vr) and torch.equal(a, ar)):
        raise AssertionError(f"int8_winmin at {rows} rows: kernel != plain")
    del v, a, vr, ar
    torch.cuda.empty_cache()
    t_plain_a = cuda_time(lambda: sk.int8_winmin_reference(q8, r8, rows, 2.0), 1)
    t_kernel = cuda_time(lambda: sk.int8_winmin(q8, r8, rows, 2.0), 3)
    t_plain_b = cuda_time(lambda: sk.int8_winmin_reference(q8, r8, rows, 2.0), 1)
    ops = 2.0 * rows * SCAN_Q * 128
    nbytes = rows * 128 + SCAN_Q * 128 + (rows // sk.W) * SCAN_Q * 8
    b = bound(nbytes, ops, INT8_OPS_S)
    log(f"[kernels] int8_winmin {rows} rows x {SCAN_Q} queries (the main path's chunk): "
        f"vals and args exactly equal; kernel {t_kernel:.3f} ms "
        f"({ops / (t_kernel * 1e-3) / 1e12:.1f} int8 TOP/s) | plain {t_plain_a:.3f} / "
        f"{t_plain_b:.3f} ms | bound {b['bound_ms']:.3f} ms ({b['bound_by']})")
    results["int8_winmin"] = {"max_abs_err": worst, "ms": t_kernel,
                              "plain_ms": (t_plain_a + t_plain_b) / 2, **b,
                              "library_ms": None}


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


def _sw_more_pairs(rng):
    """(tag, pairs, G) cases beyond the main-path shapes: batch sizes 0-3
    (an odd P takes a pad pair of length 0), the two pairs of one register
    differing in la and lb with one of them empty, lr = 512 against itself
    (score 512), lc > lr with one pass and with two, and each G the
    wrapper can choose at the main path's widths, forced."""
    a, la, b, lb = _sw_pairs(rng, 8)
    cases = [(f"P={p}", (a[:p], la[:p], b[:p], lb[:p]), None) for p in range(4)]
    la2, lb2 = la[:4].copy(), lb[:4].copy()
    la2[1], lb2[1], la2[2], lb2[3] = 37, 0, 0, 91
    cases.append(("la/lb differ in a register", (a[:4], la2, b[:4], lb2), None))
    acgt = np.frombuffer(b"ACGT", np.uint8)
    x = acgt[rng.integers(0, 4, (3, 512))]
    cases.append(("lr 512 identical", (x, np.full(3, 512), x.copy(), np.full(3, 512)), None))
    for lc in (600, 2000):  # 2000 > 32 x 40 columns: two passes
        a3 = acgt[rng.integers(0, 4, (9, 100))]
        b3 = acgt[rng.integers(0, 4, (9, lc))]
        b3[:, 300:400] = a3
        cases.append((f"lc {lc} > lr 100", (a3, rng.integers(0, 101, 9), b3,
                                           rng.integers(0, lc + 1, 9)), None))
    edge = _sw_edge_pairs(rng)
    cases += [(f"edge cases, G={g}", edge, g) for g in (None, 4, 8, 16, 32)]
    return cases


def _sw_wide_pairs(rng, p: int, lr: int, lc: int):
    """p pairs of random ACGT rows lr and lc wide, the narrower copied into
    the wider one (1% substitutions) in every second pair, a tenth of the
    lengths ragged."""
    acgt = np.frombuffer(b"ACGT", np.uint8)
    a = acgt[rng.integers(0, 4, (p, lr))]
    b = acgt[rng.integers(0, 4, (p, lc))]
    n = min(lr, lc)
    if lr >= lc:
        b[::2] = a[::2, lr - lc:]
    else:
        a[::2] = b[::2, lc - lr:]
    mask = rng.random((p, n)) < 0.01
    (b if lr >= lc else a)[mask] = acgt[rng.integers(0, 4, int(mask.sum()))]
    la, lb = np.full(p, lr), np.full(p, lc)
    la[1::10] = rng.integers(0, lr + 1, la[1::10].shape)
    lb[3::10] = rng.integers(0, lc + 1, lb[3::10].shape)
    return a, la, b, lb


def _sw_by_id_request(rng):
    """The SW rerank's launch on the card: a genome of 4 Mbp, N_READS
    '<'-wrapped reads cut from windows on either strand (1% substitutions)
    and 10 window ids a read: the read's own, random ones on both strands,
    ids past the genome's end and -1 slots.  (genome, ids [N_READS, 10],
    query rows [N_READS, READ_LEN + 2], lengths)."""
    acgt = np.frombuffer(b"ACGT", np.uint8)
    comp = np.zeros(256, np.uint8)
    comp[acgt] = np.frombuffer(b"TGCA", np.uint8)
    glen = 1 << 22
    genome = acgt[rng.integers(0, 4, glen)]
    ids = rng.integers(0, 2 * (glen - READ_LEN + 1), (N_READS, 10))
    pos = ids[:, 0] >> 1
    w = genome[pos[:, None] + np.arange(READ_LEN)]
    rev = (ids[:, 0] & 1) == 1
    w[rev] = comp[w[rev][:, ::-1]]
    mask = rng.random(w.shape) < 0.01
    w[mask] = acgt[rng.integers(0, 4, int(mask.sum()))]
    q = np.full((N_READS, READ_LEN + 2), ord(">"), np.uint8)
    q[:, 0], q[:, 1:-1] = ord("<"), w
    past = rng.random((N_READS, 10)) < 0.01
    past[:, 0] = False
    ids[past] = 2 * rng.integers(glen - READ_LEN + 1, glen + 50, int(past.sum())) + 1
    ids[rng.random((N_READS, 10)) < 0.01] = -1
    return genome, ids, q, np.full(N_READS, READ_LEN + 2, np.int32)


def sw_launches(launches: dict) -> int:
    """#3's launches in a kernels.counts(): its matrix and by-id entries."""
    return launches["sw_score"] + launches["sw_score_by_id"]


def dpx_rate(s32: bool = False) -> float:
    """Lane instructions a second of sw_dpx_rate's loop of independent DPX
    add-max instructions (__viaddmax_s16x2_relu, or __viaddmax_s32_relu) on
    every scheduler."""
    import torch

    from deepreadmapper_tpu_torch import kernels

    blocks, iters = 132 * 16, 4096
    out = torch.empty(blocks * 256, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    ms = cuda_time(lambda: kernels.SW_DPX_RATE.launch(out.data_ptr(), blocks, iters,
                                                      int(s32), stream), 5)
    return blocks * 256 * iters * 32 / (ms * 1e-3)


def cuda_once(fn):
    """(fn(), its ms by CUDA events): one call, no warm-up."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def check_sw(results: dict):
    import torch

    from deepreadmapper_tpu_torch import kernels
    from deepreadmapper_tpu_torch.ops import sw

    dev = torch.device("cuda")
    rng = np.random.default_rng(2)
    for tag, pairs, group in _sw_more_pairs(rng):
        a, la, b, lb = (torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in pairs)
        got = sw.sw_scores(a, la, b, lb, group=group)
        want = sw.sw_scores_reference(a, la, b, lb)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            bad = int((got != want).sum())
            raise AssertionError(f"sw_score {tag}: {bad} of {got.numel()} scores differ")
        log(f"[kernels] sw_score {tag} (G, S, passes "
            f"{sw.sw_layout(a.shape[0], a.shape[1], b.shape[1], group)}): scores exactly "
            f"equal (max {int(got.max()) if got.numel() else '-'})")
    rate = dpx_rate()
    log(f"[kernels] DPX add-max rate (measured, sw_dpx_rate): {rate / 1e12:.2f} T/s "
        f"({rate / (132 * 1.98e9):.1f} a clock an SM at 1.98 GHz); published int32 "
        f"{INT32_OPS_S / 1e12:.2f} T/s")
    shapes = {}
    for p in SW_PAIRS:
        a, la, b, lb = (torch.from_numpy(x).to(dev)
                        for x in _sw_pairs(np.random.default_rng(2), p))
        la, lb = la.int(), lb.int()  # the wrapper then launches nothing but the kernel
        got = sw.sw_scores(a, la, b, lb)
        want = sw.sw_scores_reference(a, la, b, lb)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            bad = int((got != want).sum())
            raise AssertionError(f"sw_score {p} pairs: {bad} of {p} scores differ")
        del got, want
        cells = float((la.double() * lb.double()).sum())
        t_plain_a = cuda_time(lambda: sw.sw_scores_reference(a, la, b, lb), 1)
        t_kernel = cuda_time(lambda: sw.sw_scores(a, la, b, lb), 50)
        t_plain_b = cuda_time(lambda: sw.sw_scores_reference(a, la, b, lb), 1)
        nbytes = float(la.sum() + lb.sum()) + 4.0 * 3 * p
        bd = bound(nbytes, SW_OPS_PER_CELL * cells, rate)
        g = sw.sw_layout(p, a.shape[1], b.shape[1])
        shapes[p] = {"ms": t_kernel, "plain_ms": (t_plain_a + t_plain_b) / 2, **bd,
                     "groups": g[0]}
        log(f"[kernels] sw_score {p} pairs of {READ_LEN}x{READ_LEN + 2} (G, S, passes {g}): "
            f"scores exactly equal; kernel {t_kernel:.4f} ms ({cells / (t_kernel * 1e-3) / 1e9:.1f}"
            f" GCUPS) | plain {t_plain_a:.3f} / {t_plain_b:.3f} ms | bound "
            f"{bd['bound_ms']:.4f} ms ({bd['bound_by']}: {SW_OPS_PER_CELL} instructions a "
            f"cell at the measured DPX rate)")
    # the main path's launch: one request's windows read by id from the genome
    from deepreadmapper_tpu_torch.io.fasta import fetch_windows_by_id

    host = _sw_by_id_request(np.random.default_rng(5))
    genome, ids, q, ql = (torch.from_numpy(x).to(dev) for x in host)
    p = ids.numel()
    before = kernels.SW_SCORE_BY_ID.launches
    got = sw.sw_scores_by_id(genome, ids, READ_LEN, q, ql)
    torch.cuda.synchronize()
    launched = kernels.SW_SCORE_BY_ID.launches - before
    w_mat, w_lens = fetch_windows_by_id(host[0], host[1].ravel(), READ_LEN, max_len=READ_LEN)
    a, la, b, lb = (torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in
                    (w_mat, w_lens.astype(np.int32), np.repeat(host[2], 10, axis=0),
                     np.repeat(host[3], 10)))
    want = sw.sw_scores_reference(a, la, b, lb).view(got.shape)
    torch.cuda.synchronize()
    if launched != 1 or not torch.equal(got, want):
        raise AssertionError(f"sw_score by id, {p} pairs: {int((got != want).sum())} scores "
                             f"differ from the plain version ({launched} launches)")
    top = int(got[:, 0].min())
    del got, want
    cells = float((la.double() * lb.double()).sum())
    t_plain_a = cuda_time(lambda: sw.sw_scores_reference(a, la, b, lb), 1)
    t_kernel = cuda_time(lambda: sw.sw_scores_by_id(genome, ids, READ_LEN, q, ql), 50)
    t_plain_b = cuda_time(lambda: sw.sw_scores_reference(a, la, b, lb), 1)
    bd = bound(float(la.sum() + ql.sum()) + 4.0 * 3 * p, SW_OPS_PER_CELL * cells, rate)
    g = sw.sw_layout(p, READ_LEN, READ_LEN + 2)
    by_id = {"ms": t_kernel, "plain_ms": (t_plain_a + t_plain_b) / 2, **bd, "pairs": p,
             "layout": g}
    log(f"[kernels] sw_score by id: {N_READS} reads x 10 windows of a {genome.numel()} bp "
        f"genome ({p} pairs of {READ_LEN}x{READ_LEN + 2}; G, S, passes, tier {g}; both "
        f"strands, ids past the end and -1): one launch, scores exactly equal to the plain "
        f"version on the host-fetched windows (every read's own window scores >= {top}); "
        f"kernel {t_kernel:.4f} ms ({cells / (t_kernel * 1e-3) / 1e9:.1f} GCUPS) | plain "
        f"{t_plain_a:.3f} / {t_plain_b:.3f} ms (the fetch not timed) | bound "
        f"{bd['bound_ms']:.4f} ms ({bd['bound_by']})")
    del genome, ids, q, ql, a, la, b, lb
    wide = {}
    for lr, lc in SW_WIDE:
        p = SW_PAIRS[0]
        a, la, b, lb = (torch.from_numpy(x).to(dev)
                        for x in _sw_wide_pairs(np.random.default_rng(lr + lc), p, lr, lc))
        la, lb = la.int(), lb.int()
        before = kernels.SW_SCORE.launches
        got = sw.sw_scores(a, la, b, lb)
        want = sw.sw_scores_reference(a, la, b, lb)  # the rows as given: a, lr wide
        torch.cuda.synchronize()
        if kernels.SW_SCORE.launches != before + 1 or not torch.equal(got, want):
            raise AssertionError(f"sw_score {lr}x{lc}: {int((got != want).sum())} of {p} "
                                 f"scores differ ({kernels.SW_SCORE.launches - before} "
                                 "launches)")
        del got, want
        cells = float((la.double() * lb.double()).sum())
        t_kernel = cuda_time(lambda: sw.sw_scores(a, la, b, lb), 10)
        t_plain = cuda_time(lambda: sw.sw_scores_reference(a, la, b, lb), 1)
        bd = bound(float(la.sum() + lb.sum()) + 4.0 * 3 * p, SW_OPS_PER_CELL * cells, rate)
        layout = sw.sw_layout(p, min(lr, lc), max(lr, lc))
        wide[f"{lr}x{lc}"] = {"ms": t_kernel, "plain_ms": t_plain, **bd, "layout": layout}
        log(f"[kernels] sw_score {p} pairs of {lr}x{lc} (rows {min(lr, lc)} wide; G, S, "
            f"passes {layout}): scores exactly equal to the plain version; kernel "
            f"{t_kernel:.4f} ms ({cells / (t_kernel * 1e-3) / 1e9:.1f} GCUPS) | plain "
            f"{t_plain:.3f} ms | bound {bd['bound_ms']:.4f} ms ({bd['bound_by']})")
    rate32 = dpx_rate(s32=True)
    log(f"[kernels] DPX add-max rate, s32 (measured, sw_dpx_rate): {rate32 / 1e12:.2f} T/s "
        f"({rate32 / (132 * 1.98e9):.1f} a clock an SM at 1.98 GHz)")
    tiers = {}
    for lr, lc, p in SW_TIERS:
        a, la, b, lb = _sw_wide_pairs(np.random.default_rng(lr + lc), p, lr, lc)
        if lr < lc:
            a[0] = b[0, lc - lr:]  # an exact copy: scores lr
        a, la, b, lb = (torch.from_numpy(x).to(dev) for x in (a, la, b, lb))
        la, lb = la.int(), lb.int()
        layout = sw.sw_layout(p, lr, lc)
        scratch = sw.sw_scratch_bytes(p, lr, lc)
        before = kernels.SW_SCORE.launches
        got = sw.sw_scores(a, la, b, lb)
        torch.cuda.synchronize()
        launched = kernels.SW_SCORE.launches - before
        want, t_plain = cuda_once(lambda: sw.sw_scores_reference(a, la, b, lb))
        if launched != 1 or not torch.equal(got, want):
            raise AssertionError(f"sw_score {lr}x{lc} ({layout[3]} tier): "
                                 f"{int((got != want).sum())} of {p} scores differ "
                                 f"({launched} launches)")
        if lr < lc and int(got[0]) != min(lr, lc):
            raise AssertionError(f"sw_score {lr}x{lc}: an exact copy scores {int(got[0])}")
        top = int(got.max())
        del got, want
        cells = float((la.double() * lb.double()).sum())
        t_kernel = cuda_time(lambda: sw.sw_scores(a, la, b, lb), 3)
        wide32 = layout[3] == "int32"
        bd = bound(float(la.sum() + lb.sum()) + 4.0 * 3 * p,
                   (SW32_OPS_PER_CELL if wide32 else SW_OPS_PER_CELL) * cells,
                   rate32 if wide32 else rate)
        tiers[f"{lr}x{lc}"] = {"ms": t_kernel, "plain_ms": t_plain, **bd, "pairs": p,
                               "layout": layout, "scratch_bytes": scratch}
        log(f"[kernels] sw_score {p} pairs of {lr}x{lc}, tier {layout[3]} (G, S, passes "
            f"{layout[:3]}; scratch {scratch} bytes): one launch, scores exactly equal to "
            f"the plain version (max {top}); kernel {t_kernel:.4f} ms "
            f"({cells / (t_kernel * 1e-3) / 1e9:.1f} GCUPS) | plain {t_plain:.3f} ms | "
            f"bound {bd['bound_ms']:.4f} ms ({bd['bound_by']}: "
            f"{SW32_OPS_PER_CELL if wide32 else SW_OPS_PER_CELL} instructions a cell at the "
            f"measured {'s32' if wide32 else 's16x2'} DPX rate)")
    funcs = sass_opcodes(kernels.SW_SCORE.build(), "sw_score_kernel")
    dpx = {strip_name(f): dpx_count(c) for f, c in funcs.items()}
    main_s = f"S={by_id['layout'][1]} by id"  # the main path's instantiation
    log(f"[kernels] sw_score SASS (sm_90a), DPX instructions by strip: {dpx}; the main "
        f"path's {main_s}: {dict(sum((c for f, c in funcs.items() if strip_name(f) == main_s), Counter()).most_common(12))}")
    if not dpx.get(main_s):
        raise AssertionError(f"sw_score's {main_s} kernel has no DPX instruction")
    for tag in ("S=40 global", "S=40 int32"):
        ops = sum((c for f, c in funcs.items() if strip_name(f) == tag), Counter())
        log(f"[kernels] sw_score {tag} SASS: {dpx.get(tag, 0)} DPX instructions (ptxas "
            f"unswitches the row loop: each copy of the 40-column step holds 4 add-max "
            f"and half a three-way max a cell); {dict(ops.most_common(12))}")
        if not dpx.get(tag):
            raise AssertionError(f"sw_score's {tag} kernel has no DPX instruction")
    rates = {strip_name(f): dict(c.most_common(6))
             for f, c in sass_opcodes(kernels.SW_SCORE.build(), "dpx_rate_kernel").items()}
    log(f"[kernels] sw_dpx_rate SASS: {rates}")
    results["sw_score"] = {"max_abs_err": 0.0, "ms": by_id["ms"], "plain_ms": by_id["plain_ms"],
                           "bound_ms": by_id["bound_ms"], "bound_by": by_id["bound_by"],
                           "library_ms": None,
                           "extra": {"by_id": by_id,
                                     "pairs": {str(p): v for p, v in shapes.items()},
                                     "wide": wide, "tiers": tiers,
                                     "dpx_instructions": dpx[main_s],
                                     "dpx_rate_measured": rate,
                                     "dpx_rate_s32_measured": rate32}}


def check_pq(results: dict):
    import torch

    from deepreadmapper_tpu_torch.ops import scan_kernel as sk

    dev = torch.device("cuda")
    rng = np.random.default_rng(3)
    q8 = torch.from_numpy(rng.integers(-127, 128, (SCAN_Q, 128), dtype=np.int8)).to(dev)
    ntotal = SCAN_ROWS - 1000  # mask part of the last tile
    times, worst, by_m = {}, 0.0, {}
    for m in PQ_MS:
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
        # timed at ratio 1.3: a PQFLAT search quantizes its queries on their
        # own scale when they outgrow the codebook's (see phase genome_pq)
        r2 = 2.0 * float(np.float32(1.3))
        t_plain_a = cuda_time(
            lambda: sk.pq_winmin_reference(q8, codes, cent8, SCAN_ROWS, r2), 2)
        t_kernel = cuda_time(lambda: sk.pq_winmin(q8, codes, cent8, SCAN_ROWS, r2), 5)
        t_plain_b = cuda_time(
            lambda: sk.pq_winmin_reference(q8, codes, cent8, SCAN_ROWS, r2), 2)
        tops = 2.0 * SCAN_ROWS * SCAN_Q * 128 / (t_kernel * 1e-3) / 1e12
        bd = bound(SCAN_ROWS * m + 256 * 128 + SCAN_Q * 128 + (SCAN_ROWS // sk.W) * SCAN_Q * 8,
                   2.0 * SCAN_ROWS * SCAN_Q * 128, INT8_OPS_S)
        log(f"[kernels] pq_winmin m={m} {SCAN_ROWS} rows x {SCAN_Q} queries, ratio 1.3: "
            f"kernel {t_kernel:.3f} ms ({tops:.1f} int8 TOP/s) | "
            f"plain {t_plain_a:.3f} / {t_plain_b:.3f} ms | bound {bd['bound_ms']:.3f} ms "
            f"({bd['bound_by']})")
        times[m] = (t_kernel, (t_plain_a + t_plain_b) / 2)
        by_m[str(m)] = {"ms": t_kernel, "plain_ms": times[m][1], **bd}
    # tie-heavy: codebook entries in {-1, 0, 1}, 4 a subspace (m 8, nbits 2),
    # every row one of 16 code patterns, so most window minima are shared
    # and only the lowest-row rule decides
    patterns = rng.integers(0, 4, (16, 8), dtype=np.uint8)
    codes = torch.from_numpy(patterns[rng.integers(0, 16, SCAN_ROWS)]).to(dev)
    cent8 = torch.from_numpy(rng.integers(-1, 2, (8, 4, 16), dtype=np.int8)).to(dev)
    for ratio in (1.0, 1.3):
        ratio2 = 2.0 * float(np.float32(ratio))
        v, a = sk.pq_winmin(q8, codes, cent8, ntotal, ratio2)
        vr, ar = sk.pq_winmin_reference(q8, codes, cent8, ntotal, ratio2)
        torch.cuda.synchronize()
        if not (torch.equal(v, vr) and torch.equal(a, ar)):
            bad = (v != vr) | (a != ar)
            raise AssertionError(f"pq_winmin tie-heavy ratio {ratio}: "
                                 f"{int(bad.sum())} of {bad.numel()} entries differ")
        log(f"[kernels] pq_winmin tie-heavy (m=8, nbits 2, codebook in {{-1, 0, 1}}, 16 code "
            f"patterns) ratio {ratio}: vals and args exactly equal")
    nbytes = SCAN_ROWS * 8 + 8 * 256 * 16 + SCAN_Q * 128 + (SCAN_ROWS // sk.W) * SCAN_Q * 8
    results["pq_winmin"] = {"max_abs_err": worst, "ms": times[8][0],
                            "plain_ms": times[8][1],
                            **bound(nbytes, 2.0 * SCAN_ROWS * SCAN_Q * 128, INT8_OPS_S),
                            "library_ms": None, "extra": {"m": by_m}}


def _ivf_engines(rng, dev):
    """An IVFINT8 and an IVFPQ (m 8, nbits 8) engine over one random chunked
    layout of >= IVF_KERNEL_ROWS rows: slabs of 1-3 chunks, every second
    slab tie-heavy (int8 values in [-2, 2]; PQ codes in {0, 1}), and a
    quarter more clusters than slabs, so queries probe some slabs twice."""
    from deepreadmapper_tpu_torch.index.ivf_int8 import IVFInt8Index
    from deepreadmapper_tpu_torch.index.ivf_pq import IVFPQIndex
    from deepreadmapper_tpu_torch.ops import ivf_kernel as ik
    from deepreadmapper_tpu_torch.ops import pq as pq_ops
    import torch

    cap = 3 * ik.CHK
    fills = rng.integers(1, cap + 1, IVF_KERNEL_ROWS // cap * 4)
    fills = fills[: int(np.searchsorted(np.cumsum(fills), IVF_KERNEL_ROWS)) + 1]
    s, n = fills.size, int(fills.sum())
    live = (np.arange(cap)[None, :] < fills[:, None]).ravel()
    slots = np.nonzero(live)[0]
    tie = np.repeat(np.arange(s) % 2 == 1, fills)
    row_ids = np.full((s + 1) * cap, -1, np.int64)
    row_ids[slots] = rng.permutation(n)
    codes = np.zeros(((s + 1) * cap, 128), np.int8)
    codes[slots] = np.where(tie[:, None], rng.integers(-2, 3, (n, 128)),
                            rng.integers(-127, 128, (n, 128)))
    pq_codes = np.zeros(((s + 1) * cap, 8), np.uint8)
    pq_codes[slots] = np.where(tie[:, None], rng.integers(0, 2, (n, 8)),
                               rng.integers(0, 256, (n, 8)))
    nlist = s + s // 4
    slab_of = np.concatenate([np.arange(s), rng.integers(0, s, nlist - s)]).astype(np.int32)
    cent = rng.standard_normal((nlist, 128)).astype(np.float32)
    book = pq_ops.PQCodebook(torch.from_numpy(
        rng.standard_normal((8, 256, 16)).astype(np.float32) * 0.3).to(dev))
    return (IVFInt8Index(codes, cent, row_ids, slab_of, 1 / 127, n, cap, s, dev),
            IVFPQIndex(pq_codes, cent, row_ids, slab_of, book, n, cap, s, device=dev))


def _ivf_pq_engine(eng8, m: int, rng, dev):
    """An IVFPQ engine at m (nbits 8) over eng8's layout: the same slabs,
    clusters and row ids, new random codes (in {0, 1} on the tie-heavy
    slabs) and a random codebook of 128/m-wide entries."""
    from deepreadmapper_tpu_torch.index.ivf_pq import IVFPQIndex
    from deepreadmapper_tpu_torch.ops import pq as pq_ops
    import torch

    slots = np.nonzero(eng8.row_ids >= 0)[0]
    tie = (slots // eng8.cap) % 2 == 1
    codes = np.zeros((eng8.row_ids.size, m), np.uint8)
    codes[slots] = np.where(tie[:, None], rng.integers(0, 2, (slots.size, m)),
                            rng.integers(0, 256, (slots.size, m)))
    book = pq_ops.PQCodebook(torch.from_numpy(
        rng.standard_normal((m, 256, 128 // m)).astype(np.float32) * 0.3).to(dev))
    return IVFPQIndex(codes, eng8.centroids, eng8.row_ids, eng8.slab_of, book,
                      eng8.ntotal, eng8.cap, eng8.n_slabs, device=dev)


def _hold_equal(tag: str, got, want) -> None:
    """got == want bit for bit (fp32 compared as int32 bit patterns)."""
    import torch

    gi, wi = got.view(torch.int32), want.view(torch.int32)
    if gi.shape != wi.shape or not bool((gi == wi).all()):
        bad = int((gi != wi).sum()) if gi.shape == wi.shape else -1
        raise AssertionError(f"{tag}: {bad} of {gi.numel()} values differ from the plain version")


def check_ivf(results: dict):
    """The four IVF chunk scans against their plain versions, bit for bit,
    under one plan of 8192 queries x nprobe 32 over >= 2^21 rows."""
    import torch

    from deepreadmapper_tpu_torch import kernels
    from deepreadmapper_tpu_torch.index.ivf_int8 import drop_pad_steps
    from deepreadmapper_tpu_torch.ops import ivf_kernel as ik

    dev = torch.device("cuda")
    rng = np.random.default_rng(6)
    eng8, engpq = _ivf_engines(rng, dev)
    nq = SCAN_Q
    probe = np.argsort(rng.random((nq, eng8.nlist)), axis=1)[:, :IVF_NPROBE]
    plan = [torch.from_numpy(a).to(dev) for a in eng8._build_plan_chunked(probe, ik.QTK)]
    padded = plan[0].shape[0]
    sc, sv, qidx, slot_of = drop_pad_steps(plan)  # as the engine launches it
    q8 = torch.from_numpy(rng.integers(-127, 128, (nq + 1, 128), dtype=np.int8)).to(dev)
    q8[nq] = 0
    qsteps = q8[qidx.long()]
    ratio2 = 2.0 * float(np.float32(1.3))
    vis = torch.unique(slot_of.reshape(-1).long() // ik.QTK)
    _first, count = ik.visit_steps(sv, qidx.shape[0])
    steps, visits = int(count[vis].sum()), int(vis.numel())
    chunks = int(torch.unique(sc[torch.isin(sv[:-1].long(), vis)]).numel())
    c8, rn8 = eng8._device()[:2]
    (packed, cent2d), rnpq = engpq._device()[:2]
    log(f"[kernels] IVF layout: {eng8.ntotal} rows in {eng8.n_slabs} slabs of "
        f"{int(eng8._chunk_meta()[0][:-1].min())}-{int(eng8._chunk_meta()[0][:-1].max())} "
        f"chunks; plan of {nq} queries x nprobe {IVF_NPROBE}: {visits} visits, {steps} "
        f"chunk steps (the plan's {padded} less its padding) over {chunks} distinct chunks")
    rows_out = ik.fold_rows(nq)

    def cases(r2):
        """name -> (kernel call, plain call, compared part, bytes per chunk, output bytes)"""
        return {
            "ivf_chunk_int8": (
                lambda: ik.ivf_chunk_scan_int8(sc, sv, qsteps, c8, rn8, r2),
                lambda: ik.ivf_chunk_scan_int8_reference(sc, sv, qsteps, c8, rn8, r2),
                lambda x: x[vis], ik.CHK * (128 + 4), visits * ik.QTK * 4 * ik.KP * 4),
            "ivf_chunk_int8_fold": (
                lambda: ik.ivf_chunk_scan_int8_fold(sc, sv, qidx, qsteps, c8, rn8, r2, nq),
                lambda: ik.ivf_chunk_scan_int8_fold_reference(sc, sv, qidx, qsteps, c8, rn8,
                                                              r2, nq),
                lambda x: x[:nq], ik.CHK * (128 + 4), rows_out * 2 * ik.FS * ik.KP * 4),
            "ivf_chunk_pq": (
                lambda: ik.ivf_chunk_scan_pq(sc, sv, qsteps, packed, rnpq, cent2d, r2, 8),
                lambda: ik.ivf_chunk_scan_pq_reference(sc, sv, qsteps, packed, rnpq, cent2d,
                                                       r2, 8),
                lambda x: x[vis], ik.CHK * (8 + 4), visits * ik.QTK * 4 * ik.KP * 4),
            "ivf_chunk_pq_fold": (
                lambda: ik.ivf_chunk_scan_pq_fold(sc, sv, qidx, qsteps, packed, rnpq, cent2d,
                                                  r2, 8, nq),
                lambda: ik.ivf_chunk_scan_pq_fold_reference(sc, sv, qidx, qsteps, packed,
                                                            rnpq, cent2d, r2, 8, nq),
                lambda x: x[:nq], ik.CHK * (8 + 4), rows_out * 2 * ik.FS * ik.KP * 4),
        }

    for ratio in (1.0, 1.3):
        for name, (kernel, plain, part, _sb, _ob) in cases(2.0 * float(np.float32(ratio))).items():
            got, want = kernel(), plain()
            torch.cuda.synchronize()
            _hold_equal(f"{name} ratio {ratio}", part(got), part(want))
            del got, want
    log("[kernels] IVF chunk scans: packed states of every referenced visit and fold "
        "rows [0, nq) bit-exact vs plain at ratio 1 and 1.3")
    for name, (kernel, plain, _part, chunk_bytes, out_bytes) in cases(
            2.0 * float(np.float32(1.3))).items():
        t_plain_a = cuda_time(plain, 1)
        t_kernel = cuda_time(kernel, 3)
        t_plain_b = cuda_time(plain, 1)
        b = _ivf_bound(chunks, steps, visits, chunk_bytes // ik.CHK, out_bytes)
        step_gb = (steps * chunk_bytes + visits * ik.QTK * 128 + out_bytes) / 1e9
        log(f"[kernels] {name}: kernel {t_kernel:.3f} ms | plain {t_plain_a:.3f} / "
            f"{t_plain_b:.3f} ms | bound {b['bound_ms']:.3f} ms ({b['bound_by']}; "
            f"{2.0 * steps * ik.QTK * ik.CHK * 128 / 1e12:.3f} int8 TOP; {step_gb:.3f} GB "
            f"when each chunk step reads its rows, {step_gb / HBM_BYTES_S * 1e12:.3f} ms)")
        results[name] = {"max_abs_err": 0.0, "ms": t_kernel,
                         "plain_ms": (t_plain_a + t_plain_b) / 2, **b, "library_ms": None}
    # IVFPQ at m 2 (a subspace of 64 bytes, both in one code word) and 64
    # (2-byte codebook entries, 16 code planes) on the same plan, packed and
    # fold, against the plain versions bit for bit
    r2 = 2.0 * float(np.float32(1.3))
    for m in IVF_PQ_MS:
        eng = _ivf_pq_engine(eng8, m, np.random.default_rng(60 + m), dev)
        (pk_m, cb_m), rn_m = eng._device()[:2]
        calls = {
            "ivf_chunk_pq": (
                lambda: ik.ivf_chunk_scan_pq(sc, sv, qsteps, pk_m, rn_m, cb_m, r2, m),
                lambda: ik.ivf_chunk_scan_pq_reference(sc, sv, qsteps, pk_m, rn_m, cb_m,
                                                       r2, m),
                lambda x: x[vis], visits * ik.QTK * 4 * ik.KP * 4),
            "ivf_chunk_pq_fold": (
                lambda: ik.ivf_chunk_scan_pq_fold(sc, sv, qidx, qsteps, pk_m, rn_m, cb_m, r2,
                                                  m, nq),
                lambda: ik.ivf_chunk_scan_pq_fold_reference(sc, sv, qidx, qsteps, pk_m,
                                                            rn_m, cb_m, r2, m, nq),
                lambda x: x[:nq], rows_out * 2 * ik.FS * ik.KP * 4),
        }
        for name, (kernel, plain, part, out_bytes) in calls.items():
            kc = getattr(kernels, name.upper())
            before = kc.launches
            got, want = kernel(), plain()
            torch.cuda.synchronize()
            if kc.launches != before + 1:
                raise AssertionError(f"{name} m={m} did not launch its kernel")
            _hold_equal(f"{name} m={m}", part(got), part(want))
            del got, want
            t_kernel = cuda_time(kernel, 3)
            t_plain = cuda_time(plain, 1)
            b = _ivf_bound(chunks, steps, visits, -(-m // 4) * 4 + 4, out_bytes)
            results[name].setdefault("extra", {}).setdefault("m", {})[str(m)] = {
                "ms": t_kernel, "plain_ms": t_plain, **b}
            log(f"[kernels] {name} m={m}: packed states / fold rows bit-exact vs plain at "
                f"ratio 1.3; kernel {t_kernel:.3f} ms | plain {t_plain:.3f} ms | bound "
                f"{b['bound_ms']:.3f} ms ({b['bound_by']})")
        del eng, pk_m, cb_m, rn_m
    # the fold pass of #6 and #8 alone over the PQ scan's states: the kernel
    # (its index sorted beforehand), then with the index sort as they run it
    r2 = 2.0 * float(np.float32(1.3))
    states = ik.ivf_chunk_scan_pq(sc, sv, qsteps, packed, rnpq, cent2d, r2, 8)
    index = ik.fold_index(qidx, count, nq)
    _hold_equal("the fold pass alone", ik.ivf_fold(states, sv, qidx, nq, index),
                ik.ivf_chunk_scan_pq_fold(sc, sv, qidx, qsteps, packed, rnpq, cent2d, r2, 8, nq))
    t_fold = cuda_time(lambda: ik.ivf_fold(states, sv, qidx, nq, index), 3)
    t_index = cuda_time(lambda: ik.ivf_fold(states, sv, qidx, nq), 3)
    fb = bound(visits * ik.QTK * 4 * ik.KP * 4 + rows_out * 2 * ik.FS * ik.KP * 4, 0.0,
               INT8_OPS_S)
    log(f"[kernels] the fold pass alone (second pass of ivf_chunk_int8_fold and "
        f"ivf_chunk_pq_fold), on the PQ scan's states: kernel {t_fold:.3f} ms, with its "
        f"index sort {t_index:.3f} ms | bound {fb['bound_ms']:.3f} ms (bytes); equal to "
        "ivf_chunk_pq_fold's accumulator")
    del eng8, engpq, c8, rn8, packed, rnpq, states, index
    torch.cuda.empty_cache()


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
    # the IVF engines (auto nlist 32; 150 reads x nprobe 16: the fused route)
    for index_type, extra in (("IVFINT8", []), ("IVFPQ", ["--opq"])):
        idx, out = os.path.join(work, index_type), os.path.join(work, index_type + "_out")
        if cli.main(["build-index", fna, idx, "150", "--index-type", index_type, *extra]) != 0:
            raise AssertionError(f"fixture {index_type} build-index failed")
        if cli.main(["pipeline", idx, fq, fna, "16", "128", "128", out]) != 0:
            raise AssertionError(f"fixture {index_type} pipeline failed")
        hits = truth_hits(np.load(os.path.join(out, "indices.npy")), names, 2)
        log(f"[fixture] {index_type}{' + OPQ' if extra else ''}, nprobe 16: truth hits "
            f"{hits}/{len(names)} (need >= 135)")
        if hits < 135:
            raise AssertionError(f"fixture {index_type} truth hits {hits} < 135")


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
    ref, fq, starts, strands, mat, body = simulate(work)
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

    top1 = _top1(np.load(os.path.join(out, "indices.npy")), starts, strands)
    log(f"[genome] top-1 (position +-5 bp and strand): {top1:.4f} (need >= 0.99)")
    if top1 < 0.99:
        raise AssertionError(f"genome top-1 {top1} < 0.99")

    # steady state: the same search again, index already resident
    engine, _ = load_index(idx)
    vec = Vectorizer()
    lengths = np.full(N_READS, READ_LEN + 2)
    engine.search(vec.vectorize_wrapped_bytes(mat, lengths), 128)  # warm
    torch.cuda.synchronize()
    reps = []  # (embed + search, the embed: it ends in a download) per pass
    for _ in range(5):
        t0 = time.perf_counter()
        q = vec.vectorize_wrapped_bytes(mat, lengths)
        t_embed = time.perf_counter() - t0
        fused_i, fused_d = engine.search(q, 128)
        torch.cuda.synchronize()
        reps.append((time.perf_counter() - t0, t_embed))
    t_steady, t_embed = (float(np.median([r[i] for r in reps])) for i in (0, 1))
    log(f"[genome] steady embed+search: {N_READS} reads in {t_steady:.3f} s "
        f"({N_READS / t_steady:.0f} reads/s; median of {len(reps)} passes, "
        f"{min(r[0] for r in reps):.3f}-{max(r[0] for r in reps):.3f} s; the embed "
        f"{t_embed:.3f} s of it)")
    _profile("genome", "pass",
             lambda: [engine.search(vec.vectorize_wrapped_bytes(mat, lengths), 128)
                      for _ in range(2)], 2, _SEARCH_GROUPS)

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
    return {"ref": ref, "fq": fq, "starts": starts, "strands": strands, "top1": top1,
            "idx": idx, "out": out, "genome": body, "wrapped": mat}


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
    ref, fq, starts, strands, mat, body = simulate(work, PQ_GENOME_BP, N_READS)
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
    if min(launches["gru_fwd"], launches["pq_winmin"], sw_launches(launches)) <= 0:
        raise AssertionError(f"main path missed a kernel: {launches}")
    results["pq_winmin"]["launches"] = launches["pq_winmin"]
    results["sw_score"]["launches"] = sw_launches(launches)

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
    pqflat = {"sim": (ref, fq, starts, strands, mat), "idx": idx, "top1": pq_top1}

    # the SW kernel alone by CUDA events on the request's pairs, by id (the
    # rerank's host split: the post.sw.* spans of a traced run)
    g, c, m, ml = (torch.from_numpy(np.ascontiguousarray(x)).cuda() for x in
                   (body, cand, mat, np.full(N_READS, READ_LEN + 2, np.int32)))
    t_sw = cuda_time(lambda: sw.sw_scores_by_id(g, c, READ_LEN, m, ml), 3)
    log(f"[genome_pq] the SW kernel alone on the request's {c.numel()} pairs by id: "
        f"{t_sw:.2f} ms (CUDA events)")
    del g, c, m, ml

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
    # the ratio this search scored at (the kernel's ratio2 is twice it)
    _, batch_ratio = query_scale_ratio(
        q if engine.rot is None else np.asarray(q, np.float32) @ engine.rot, engine.cb8.scale)
    log(f"[genome_pq] steady embed+search (k=10): {N_READS} reads in {t_steady:.3f} s "
        f"({N_READS / t_steady:.0f} reads/s); query scale ratio {batch_ratio:.4f}")

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
    del engine, codes, cent8
    check_pqflat_m64(ref, q)
    check_cpu_size_sw()
    check_wide_sw_cli()
    return pqflat


def check_pqflat_m64(ref: str, q: np.ndarray):
    """PQFLAT at M_pq 64 (2-byte codebook entries) over the first
    PQ_M64_ROWS windows of phase 6's genome, searched with its 8192 reads:
    the fused route (pq_winmin), its top-1 distance against the exact scan
    on 1024 reads (bit for bit at query scale ratio 1), and the
    kernel-driven scan against the plain-driven one."""
    import torch

    from deepreadmapper_tpu_torch import kernels
    from deepreadmapper_tpu_torch.config import BuildConfig
    from deepreadmapper_tpu_torch.index.int8_flat import quantize_host, query_scale_ratio
    from deepreadmapper_tpu_torch.index.pq_flat import PQFlatIndex
    from deepreadmapper_tpu_torch.io import fasta as fasta_io
    from deepreadmapper_tpu_torch.models.encoder import Vectorizer
    from deepreadmapper_tpu_torch.ops import scan_kernel as sk
    from deepreadmapper_tpu_torch.pipeline.build import embed_fasta_windows

    t0 = time.perf_counter()
    rec = fasta_io.parse_fasta_records(ref)[0][: PQ_M64_ROWS // 2 + READ_LEN - 1]
    emb = embed_fasta_windows([rec], READ_LEN, 1, Vectorizer())
    engine = PQFlatIndex.build(emb, BuildConfig(m_pq=64), device="cuda")
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    kernels.reset_counts()
    t0 = time.perf_counter()
    engine.search(q, 10)
    torch.cuda.synchronize()
    t_search = time.perf_counter() - t0
    launches = kernels.counts()
    log(f"[genome_pq] PQFLAT M_pq 64 over {engine.ntotal} windows: embed + train + encode "
        f"{t_build:.2f} s; search of {q.shape[0]} reads (k 10) {t_search:.3f} s; launches "
        f"{launches}")
    if engine.ntotal < 1 << 19 or launches["pq_winmin"] < 1:
        raise AssertionError(f"PQFLAT M_pq 64 missed the fused route: {launches}")
    # one batch for both scans.  Where the reads fit the codebook's scale
    # (query scale ratio exactly 1) every term of both scans is an exact
    # integer, so the top-1 distance must be the exact scan's bit for bit
    # (phase 6's rule at m 8): the reads are rescaled under it for that gate.
    # At these reads' own ratio (past 1) the two scans round the distance in
    # other orders (ops/scan_kernel.py vs int8_flat._int8_topk): the top-1
    # there agrees when its row is the same or its distance is within that
    # rounding
    sub = slice(0, 1024)
    sc = np.float32(engine.cb8.scale)
    q_fit = q[sub] * np.float32(0.999 * 127.0 * sc / np.max(np.abs(q[sub])))
    _, ratio_fit = query_scale_ratio(q_fit, sc)
    kernels.reset_counts()
    fit_i, fit_d = engine.search(q_fit, 10)
    fit_launches = kernels.counts()["pq_winmin"]
    fex_i, fex_d = engine.search(q_fit, 10, exact=True)
    fit_same = float(np.mean(fit_d[:, 0] == fex_d[:, 0]))
    log(f"[genome_pq] PQFLAT M_pq 64 fused vs exact scan on the same 1024 reads rescaled "
        f"under the codebook's scale (query scale ratio {float(ratio_fit)!r}, pq_winmin "
        f"launches {fit_launches}): the same top-1 distance bit for bit {fit_same:.4f} "
        f"(need >= 0.99), the same row {float(np.mean(fit_i[:, 0] == fex_i[:, 0])):.4f}")
    if ratio_fit != 1 or fit_launches < 1 or fit_same < 0.99:
        raise AssertionError("PQFLAT M_pq 64 at ratio 1: fused top-1 distance is not the "
                             "exact scan's")
    sq, ratio = query_scale_ratio(q[sub], sc)
    sub_i, sub_d = engine.search(q[sub], 10)
    ex_i, ex_d = engine.search(q[sub], 10, exact=True)
    same_d = sub_d[:, 0] == ex_d[:, 0]
    agree = float(np.mean((sub_i[:, 0] == ex_i[:, 0]) | same_d
                          | (np.abs(sub_d[:, 0] - ex_d[:, 0]) <= 1e-6 * np.abs(ex_d[:, 0]))))
    log(f"[genome_pq] PQFLAT M_pq 64 fused vs exact scan on the same 1024 reads at their own "
        f"query scale ratio {float(ratio)!r}: top-1 agrees {agree:.4f} (need >= 0.99; the "
        f"same distance bit for bit {float(np.mean(same_d)):.4f}, the same row "
        f"{float(np.mean(sub_i[:, 0] == ex_i[:, 0])):.4f})")
    if agree < 0.99:
        raise AssertionError("PQFLAT M_pq 64: fused top-1 disagrees with the exact scan")
    q8 = torch.from_numpy(quantize_host(q[sub], sq)).cuda()
    codes, cent8 = engine._device()
    chunk = sk.choose_chunk(codes.shape[0])
    kd, ki = sk.fused_scan_topk(q8, codes, engine.ntotal, 128, chunk, ratio=ratio,
                                cent8=cent8)
    pd, pi = sk.fused_scan_topk(q8, codes, engine.ntotal, 128, chunk, ratio=ratio,
                                cent8=cent8, winmin=sk.pq_winmin_reference)
    if not (torch.equal(kd, pd) and torch.equal(ki, pi)):
        raise AssertionError("PQFLAT M_pq 64 fused scan: kernel != plain version")
    log(f"[genome_pq] PQFLAT M_pq 64 fused scan over {codes.shape[0]} rows x 1024 reads: "
        "kernel-driven == plain-driven")


def check_cpu_size_sw():
    """The genome_pq simulation shrunk to the size the JAX package was run
    at on the CPU, where its search is the exact PQ scan: the port's SW
    rerank of the exact scan's top 10 against the JAX package's top-1, and
    the port's main path (fused scan) beside it."""
    import torch

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
    ids, _ = pp.post_process_sw(cand, mat, lengths, None, 1, 10, 10,
                                2 * (CPU_SIZE_BP - READ_LEN + 1), genome=genome,
                                ref_len=READ_LEN)
    top = ids[:, 0]
    hits = int(np.sum((np.abs((top >> 1) - starts) <= 5) & ((top & 1) == strands)))
    log(f"[cpu_size] {CPU_SIZE_BP} bp, {CPU_SIZE_READS} reads: SW top-1 over the exact "
        f"scan's top 10 {hits}/{CPU_SIZE_READS} (need >= {JAX_SW_TOP1_READS}, the JAX "
        f"package's recorded CPU reading); the main path (fused scan) {fused_top1:.4f}")
    if hits < JAX_SW_TOP1_READS:
        raise AssertionError(f"CPU-size SW top-1 {hits} < {JAX_SW_TOP1_READS} reads")

    # windows of SW_WIDE_REF_LEN bytes: the SW rerank scores 600 x 152 pairs,
    # the reads as the kernel's rows
    from deepreadmapper_tpu_torch import kernels

    idx600, out600 = os.path.join(work, "idx600"), os.path.join(work, "out600")
    if cli.main(["build-index", ref, idx600, str(SW_WIDE_REF_LEN)]) != 0:
        raise AssertionError(f"build-index at ref_len {SW_WIDE_REF_LEN} failed")
    kernels.reset_counts()
    t0 = time.perf_counter()
    rc = cli.main(["pipeline", idx600, fq, ref, "128", "10", "128", out600, "--rerank", "sw"])
    torch.cuda.synchronize()
    t_pipe = time.perf_counter() - t0
    launches = kernels.counts()
    top = np.load(os.path.join(out600, "indices.npy")).astype(np.int64)[:, 0]
    inside = float(np.mean(((top >> 1) <= starts) & (starts + READ_LEN <= (top >> 1)
                                                       + SW_WIDE_REF_LEN)
                           & ((top & 1) == strands)))
    log(f"[cpu_size] pipeline --rerank sw at ref_len {SW_WIDE_REF_LEN}: {t_pipe:.2f} s, "
        f"launches {launches}; top-1 window holds the read for {inside:.4f} of reads "
        "(need >= 0.95)")
    if rc != 0 or sw_launches(launches) < 1:
        raise AssertionError(f"--rerank sw at ref_len {SW_WIDE_REF_LEN}: rc {rc}, {launches}")
    if inside < 0.95:
        raise AssertionError(f"ref_len {SW_WIDE_REF_LEN} SW top-1 holds the read for {inside}")


def check_wide_sw_cli():
    """build-index at ref_len WIDE_SW_REF_LEN on a seeded WIDE_SW_GENOME_BP
    genome -> pipeline --rerank sw on WIDE_SW_READS simulated reads of that
    length (either strand, 1% substitutions; no --long-reads): the SW
    rerank's pairs are 6,000 x 6,002 bytes, past shared memory, so
    sw_score runs in its "global" tier.  Then the same rerank in process on
    the pipeline's candidates (its indices.npy), on the card and (the first
    WIDE_SW_CPU_READS reads) with device="cpu": ids and scores equal, and
    the pipeline's SAM primaries are the card rerank's top-1.  The top-1
    against the simulated truth is printed, not gated (the encoder was
    trained at 150 bp)."""
    import torch

    from deepreadmapper_tpu_torch import cli, kernels
    from deepreadmapper_tpu_torch.io import fasta as fasta_io
    from deepreadmapper_tpu_torch.ops import sw
    from deepreadmapper_tpu_torch.pipeline import postprocess as pp
    from deepreadmapper_tpu_torch.tokenizer import strings_to_bytes

    n, L = WIDE_SW_READS, WIDE_SW_REF_LEN
    work = os.path.join(WORK, "wide_sw")
    os.makedirs(work, exist_ok=True)
    gstr = _make_genome(WIDE_SW_GENOME_BP, 17)
    ref, fq = os.path.join(work, "ref.fna"), os.path.join(work, "reads.fastq")
    _write_fasta(ref, gstr)
    rng = np.random.default_rng(18)
    starts = rng.integers(0, WIDE_SW_GENOME_BP - L + 1, n)
    strands = rng.integers(0, 2, n)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    seqs = []
    for st, sd in zip(starts, strands):
        r = gstr[st: st + L]
        r = np.frombuffer((r.translate(_COMP)[::-1] if sd else r).encode(), np.uint8).copy()
        mask = rng.random(L) < 0.01
        r[mask] = acgt[rng.integers(0, 4, int(mask.sum()))]
        seqs.append(r.tobytes().decode())
    _write_fastq(fq, [(f"_{st}_{sd}_{i}", s)
                      for i, (st, sd, s) in enumerate(zip(starts, strands, seqs))])
    idx, out = os.path.join(work, "idx"), os.path.join(work, "out")
    t0 = time.perf_counter()
    if cli.main(["build-index", ref, idx, str(L)]) != 0:
        raise AssertionError(f"build-index at ref_len {L} failed")
    t_build = time.perf_counter() - t0
    tiers = []

    def recording(kernel, tier_arg):  # the tier argument of each launch of #3
        launch = kernel.launch

        def wrapped(*args):
            tiers.append(sw._TIERS[args[tier_arg]])
            return launch(*args)
        return wrapped

    kernels.reset_counts()
    kernels.SW_SCORE.launch = recording(kernels.SW_SCORE, 12)
    kernels.SW_SCORE_BY_ID.launch = recording(kernels.SW_SCORE_BY_ID, 16)
    t0 = time.perf_counter()
    try:
        rc = cli.main(["pipeline", idx, fq, ref, "128", "10", "128", out, "--rerank", "sw"])
        torch.cuda.synchronize()
    finally:
        del kernels.SW_SCORE.launch, kernels.SW_SCORE_BY_ID.launch
    t_pipe = time.perf_counter() - t0
    launches = kernels.counts()
    log(f"[wide_sw] build-index {WIDE_SW_GENOME_BP} bp at ref_len {L} "
        f"({2 * (WIDE_SW_GENOME_BP - L + 1)} windows) {t_build:.2f} s; pipeline --rerank sw on "
        f"{n} reads of {L} bp: rc {rc}, {t_pipe:.2f} s, launches {launches}, sw_score tiers "
        f"{tiers}")
    if rc != 0 or sw_launches(launches) < 1 or set(tiers) != {"global"}:
        raise AssertionError(f"--rerank sw at ref_len {L}: rc {rc}, {launches}, {tiers}")
    # indices.npy holds the search's candidates (the SAM the SW-ranked ids):
    # the rerank again on them, on the card and on the CPU
    cand = np.load(os.path.join(out, "indices.npy")).astype(np.int64)
    genome = fasta_io.parse_fasta_records(ref)[0]
    q_mat, q_lens = strings_to_bytes(seqs)
    bound_ids = 2 * (WIDE_SW_GENOME_BP - L + 1)

    def fetch(w):
        return fasta_io.fetch_windows_by_id(genome, w, L, max_len=L)

    t0 = time.perf_counter()
    gi, gs = pp.post_process_sw(cand, q_mat, q_lens, None, 1, 10, 10, bound_ids,
                                genome=genome, ref_len=L)
    t_card = time.perf_counter() - t0
    # the kernel alone on the rerank's pairs (one launch of n x 10 by id), by CUDA events
    g, c, q, ql = (torch.from_numpy(np.ascontiguousarray(x)).cuda() for x in
                   (genome, cand, q_mat, q_lens.astype(np.int32)))
    p, w = c.numel(), q.shape[1]
    layout = sw.sw_layout(p, L, w)
    t_kernel = cuda_time(lambda: sw.sw_scores_by_id(g, c, L, q, ql), 3)
    cells = float(ql.double().sum()) * 10 * L
    bd = bound(10.0 * float(ql.sum()) + p * L + 4.0 * 3 * p, SW_OPS_PER_CELL * cells,
               dpx_rate())
    log(f"[wide_sw] sw_score alone on the rerank's {p} pairs of {L}x{w}, by id (G, S, "
        f"passes, tier {layout}; scratch {sw.sw_scratch_bytes(p, L, w)} bytes): "
        f"{t_kernel:.3f} ms ({cells / (t_kernel * 1e-3) / 1e9:.1f} GCUPS) | bound "
        f"{bd['bound_ms']:.3f} ms ({bd['bound_by']})")
    del g, c, q, ql
    m = WIDE_SW_CPU_READS
    t0 = time.perf_counter()
    ci, cs = pp.post_process_sw(cand[:m], q_mat[:m], q_lens[:m], fetch, 1, 10, 10,
                                bound_ids, device="cpu")
    t_cpu = time.perf_counter() - t0
    equal = bool(np.array_equal(gi[:m], ci) and np.array_equal(gs[:m], cs))
    pos, strand = sam_primaries(os.path.join(out, "results.sam"))
    same_sam = float(np.mean((pos == gi[:, 0] >> 1) & (strand == (gi[:, 0] & 1))))
    top = gi[:, 0]
    top1 = float(np.mean((np.abs((top >> 1) - starts) <= 5) & ((top & 1) == strands)))
    log(f"[wide_sw] post_process_sw on the pipeline's candidates: card {t_card:.2f} s "
        f"({n} x 10 pairs), CPU {t_cpu:.2f} s (the first {m} reads): ids and scores equal "
        f"{equal}; the SAM primaries are the card rerank's top-1 for {same_sam:.4f} of "
        f"reads (need 1); best score {int(gs.max())}; top-1 against the simulated truth "
        f"(+-5 bp, strand; not gated) {top1:.4f}")
    if not equal or same_sam != 1.0:
        raise AssertionError(f"wide SW rerank: card == CPU {equal}, SAM == card {same_sam}")


def _top1(ids: np.ndarray, starts: np.ndarray, strands: np.ndarray) -> float:
    """Share of reads whose first candidate is within 5 bp of the truth, on
    the right strand."""
    top = ids[:, 0].astype(np.int64)
    return float(np.mean((np.abs((top >> 1) - starts) <= 5) & ((top & 1) == strands)))


def _split(tm: dict) -> str:
    return " | ".join(f"{k} {tm[k] * 1e3:.1f} ms" for k in
                      ("probe", "plan", "kernel", "merge", "download") if k in tm)


def _ivf_bound(chunks: int, steps: int, visits: int, row_bytes: int, out_bytes: int) -> dict:
    """An IVF scan's bound on a plan: each distinct chunk the plan steps
    through is read once (CHK rows of row_bytes, norm included), each visit
    its QTK query rows, the output written once; every chunk step does QTK
    x CHK int8 dot products of 128."""
    from deepreadmapper_tpu_torch.ops import ivf_kernel as ik

    return bound(chunks * ik.CHK * row_bytes + visits * ik.QTK * 128 + out_bytes,
                 2.0 * steps * ik.QTK * ik.CHK * 128, INT8_OPS_S)


def _plan_bound(tm: dict, row_bytes: int, nq: int, fold: bool) -> str:
    """The scan's bound on this batch's plan; the output is the fold
    accumulator or the packed visit states."""
    from deepreadmapper_tpu_torch.ops import ivf_kernel as ik

    visits = tm["plan_visits"]
    out = (ik.fold_rows(nq) * 2 * ik.FS if fold else visits * ik.QTK * 4) * ik.KP * 4
    b = _ivf_bound(tm["plan_chunks"], tm["plan_steps"], visits, row_bytes, out)
    return f"scan bound {b['bound_ms']:.3f} ms ({b['bound_by']})"


def _ivf_routes(tag: str, engine, q: np.ndarray, packed_kernel: str, fold_kernel: str,
                results: dict, row_bytes: int) -> None:
    """On a loaded IVF engine: the device layout; the 8192-read batch again
    (host plan + fold), timed with its split; the same batch through the
    packed merge (same top-1 distance for every read); a quarter of the
    batch, 2048 reads (host plan + packed), and 256 reads (fused device
    plan), each with the counts set to 0 just before and read just after;
    the fused reads against the host plan, bit for bit."""
    import torch

    from deepreadmapper_tpu_torch import kernels

    t0 = time.perf_counter()
    engine._device()
    torch.cuda.synchronize()
    log(f"[{tag}] device layout (chunked rows + norms, upload): "
        f"{time.perf_counter() - t0:.2f} s")
    engine.search(q, 128, ef=IVF_NPROBE)  # warm
    torch.cuda.synchronize()
    tm, stats = {}, {}
    t0 = time.perf_counter()
    _, fd = engine.search(q, 128, ef=IVF_NPROBE, stats=stats, timings=tm)
    t_fold = time.perf_counter() - t0
    log(f"[{tag}] steady search of {len(q)} reads (host plan + fold, split synchronised): "
        f"{t_fold:.3f} s ({len(q) / t_fold:.0f} reads/s); {_split(tm)}; plan "
        f"{tm['plan_visits']} visits, {tm['plan_steps']} chunk steps over "
        f"{tm['plan_chunks']} distinct chunks, {_plan_bound(tm, row_bytes, len(q), True)}; "
        f"{stats['probed_rows_per_query']} rows probed per read (coverage {stats['coverage']})")
    engine._FOLD_MIN_Q = 1 << 30  # the packed merge on the same batch
    tm = {}
    _, pd = engine.search(q, 128, ef=IVF_NPROBE, timings=tm)
    del engine._FOLD_MIN_Q
    same = float(np.mean(fd[:, 0] == pd[:, 0]))
    log(f"[{tag}] the same {len(q)} reads through the packed merge: {_split(tm)}; same "
        f"top-1 distance as the fold for {same:.4f} of reads (need 1)")
    if same != 1.0:
        raise AssertionError(f"{tag}: fold and packed top-1 distances differ")
    launched = 0
    n_fused = engine._FUSED_MAX_PAIRS // IVF_NPROBE  # 256: the largest fused batch
    for n, route in ((len(q) // 4, "host plan + packed"), (n_fused, "fused device plan")):
        kernels.reset_counts()
        tm = {}
        t0 = time.perf_counter()
        ids, d = engine.search(q[:n], 128, ef=IVF_NPROBE, timings=tm)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = kernels.counts()
        log(f"[{tag}] {n} reads ({route}): {dt * 1e3:.1f} ms ({n / dt:.0f} reads/s); "
            f"{_split(tm)}; {tm['plan_visits']} visits, {tm['plan_steps']} chunk steps over "
            f"{tm['plan_chunks']} distinct chunks, {_plan_bound(tm, row_bytes, n, False)}; "
            f"launches {packed_kernel} {counts[packed_kernel]}, {fold_kernel} "
            f"{counts[fold_kernel]}")
        if counts[packed_kernel] < 1 or counts[fold_kernel] != 0:
            raise AssertionError(f"{tag}: {n} reads missed {packed_kernel}: {counts}")
        launched += counts[packed_kernel]
    engine._FUSED_MAX_PAIRS = 0
    hi, hd = engine.search(q[:n_fused], 128, ef=IVF_NPROBE)
    del engine._FUSED_MAX_PAIRS
    if not (np.array_equal(hi, ids) and np.array_equal(hd, d)):
        raise AssertionError(f"{tag}: fused route != host plan on {n_fused} reads")
    log(f"[{tag}] {n_fused} reads: fused device plan == host plan, ids and distances bit "
        "for bit")
    results[packed_kernel]["launches"] = launched


def _build_split(tag: str, config: dict, t_build: float, bt: dict) -> None:
    n = config["n_vects"]
    split = " | ".join(f"{k} {bt[k]:.2f} s" for k in
                       ("embed", "kmeans", "assign", "split_pack", "graph", "pq", "save")
                       if k in bt)
    log(f"[{tag}] build: {n} windows in {t_build:.2f} s ({n / t_build:.0f} windows/s); "
        f"{split}")


def phase_genome_ivf(results: dict):
    """build-index --index-type IVFINT8 -> pipeline at nprobe 32 on a 20 Mbp
    genome: the IVF slice at the JAX package's recorded shape."""
    import gc

    import torch

    from deepreadmapper_tpu_torch import cli, kernels
    from deepreadmapper_tpu_torch.index.int8_flat import Int8FlatIndex
    from deepreadmapper_tpu_torch.index.registry import load_index
    from deepreadmapper_tpu_torch.models.encoder import Vectorizer
    from deepreadmapper_tpu_torch.pipeline.build import build_index

    work = os.path.join(WORK, "genome_ivf")
    os.makedirs(work, exist_ok=True)
    ref, fq, starts, strands, mat, _ = simulate(work, IVF_GENOME_BP, N_READS)
    idx, out = os.path.join(work, "idx"), os.path.join(work, "out")
    torch.cuda.reset_peak_memory_stats()
    bt = {}
    t0 = time.perf_counter()
    config = build_index(ref, idx, READ_LEN, index_type="IVFINT8", timings=bt)
    torch.cuda.synchronize()
    _build_split("genome_ivf", config, time.perf_counter() - t0, bt)
    kernels.reset_counts()
    t0 = time.perf_counter()
    rc = cli.main(["pipeline", idx, fq, ref, str(IVF_NPROBE), "128", "128", out, "--no-sam"])
    torch.cuda.synchronize()
    t_pipe = time.perf_counter() - t0
    launches = kernels.counts()
    if rc != 0:
        raise AssertionError("IVFINT8 pipeline failed")
    log(f"[genome_ivf] pipeline (load, embed, search {N_READS} reads, write): {t_pipe:.2f} s; "
        f"launches {launches}; max_memory_allocated in build + pipeline "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if launches["ivf_chunk_int8_fold"] < 1 or launches["gru_fwd"] < 1:
        raise AssertionError(f"IVFINT8 main path missed a kernel: {launches}")
    results["ivf_chunk_int8_fold"]["launches"] = launches["ivf_chunk_int8_fold"]
    top1 = _top1(np.load(os.path.join(out, "indices.npy")), starts, strands)

    engine, _ = load_index(idx)
    q = Vectorizer().vectorize_wrapped_bytes(mat, np.full(N_READS, READ_LEN + 2))
    log(f"[genome_ivf] {engine.ntotal} rows, nlist {engine.nlist}, {engine.n_slabs} slabs "
        f"of cap {engine.cap}, {engine._chunk_meta()[2]} chunks of {2048} rows")
    _ivf_routes("genome_ivf", engine, q, "ivf_chunk_int8", "ivf_chunk_int8_fold", results,
                engine.codes_cm.shape[1] + 4)

    # the exhaustive fused int8 scan over the index's own codes, same reads
    live = engine.row_ids >= 0
    codes = np.empty((engine.ntotal, engine.codes_cm.shape[1]), np.int8)
    codes[engine.row_ids[live]] = engine.codes_cm[live]
    scale, n = engine.scale, engine.ntotal
    del engine, live
    gc.collect()
    torch.cuda.empty_cache()
    flat = Int8FlatIndex(codes, scale, n)
    t0 = time.perf_counter()
    ei, _ = flat.search(q, 128)
    torch.cuda.synchronize()
    exh = _top1(ei, starts, strands)
    log(f"[genome_ivf] top-1 (position +-5 bp and strand) at nprobe {IVF_NPROBE}: {top1:.4f} "
        f"(need >= the exhaustive int8 scan's {exh:.4f} - 0.02; that scan "
        f"{time.perf_counter() - t0:.2f} s incl. upload)")
    if top1 < exh - 0.02:
        raise AssertionError(f"IVFINT8 top-1 {top1} < exhaustive {exh} - 0.02")
    del flat, codes
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(work, ignore_errors=True)


def phase_genome_ivfpq(results: dict, pqflat: dict):
    """build-index --index-type IVFPQ -> pipeline at nprobe 32 on phase 6's
    5 Mbp genome and reads."""
    import torch

    from deepreadmapper_tpu_torch import cli, kernels
    from deepreadmapper_tpu_torch.index.registry import load_index
    from deepreadmapper_tpu_torch.models.encoder import Vectorizer
    from deepreadmapper_tpu_torch.pipeline.build import build_index

    ref, fq, starts, strands, mat = pqflat["sim"]
    work = os.path.join(WORK, "genome_ivfpq")
    idx, out = os.path.join(work, "idx"), os.path.join(work, "out")
    torch.cuda.reset_peak_memory_stats()
    bt = {}
    t0 = time.perf_counter()
    config = build_index(ref, idx, READ_LEN, index_type="IVFPQ", timings=bt)
    torch.cuda.synchronize()
    _build_split("genome_ivfpq", config, time.perf_counter() - t0, bt)
    # the stream encode is PQFLAT's: the same codebook and codes
    z = np.load(os.path.join(pqflat["idx"], "pq.npz"))
    y = np.load(os.path.join(idx, "ivf_pq.npz"))
    live = y["row_ids"] >= 0
    codes = np.empty_like(z["codes"])
    codes[y["row_ids"][live]] = y["codes_cm"][live]
    if not (np.array_equal(codes, z["codes"])
            and np.array_equal(y["pq_centroids"], z["centroids"])):
        raise AssertionError("IVFPQ codes or codebook differ from the PQFLAT build's")
    log("[genome_ivfpq] PQ codebook and codes equal the PQFLAT build's (phase 6)")
    kernels.reset_counts()
    t0 = time.perf_counter()
    rc = cli.main(["pipeline", idx, fq, ref, str(IVF_NPROBE), "128", "128", out, "--no-sam"])
    torch.cuda.synchronize()
    t_pipe = time.perf_counter() - t0
    launches = kernels.counts()
    if rc != 0:
        raise AssertionError("IVFPQ pipeline failed")
    log(f"[genome_ivfpq] pipeline (load, embed, search {N_READS} reads, write): "
        f"{t_pipe:.2f} s; launches {launches}; max_memory_allocated in build + pipeline "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if launches["ivf_chunk_pq_fold"] < 1 or launches["gru_fwd"] < 1:
        raise AssertionError(f"IVFPQ main path missed a kernel: {launches}")
    results["ivf_chunk_pq_fold"]["launches"] = launches["ivf_chunk_pq_fold"]
    top1 = _top1(np.load(os.path.join(out, "indices.npy")), starts, strands)
    log(f"[genome_ivfpq] top-1 (position +-5 bp and strand) at nprobe {IVF_NPROBE}: "
        f"{top1:.4f} (need >= the PQFLAT search's {pqflat['top1']:.4f} - 0.02)")
    if top1 < pqflat["top1"] - 0.02:
        raise AssertionError(f"IVFPQ top-1 {top1} < PQFLAT {pqflat['top1']} - 0.02")
    engine, _ = load_index(idx)
    q = Vectorizer().vectorize_wrapped_bytes(mat, np.full(N_READS, READ_LEN + 2))
    log(f"[genome_ivfpq] {engine.ntotal} rows, nlist {engine.nlist}, {engine.n_slabs} slabs "
        f"of cap {engine.cap}, {engine._chunk_meta()[2]} chunks")
    _ivf_routes("genome_ivfpq", engine, q, "ivf_chunk_pq", "ivf_chunk_pq_fold", results,
                4 * -(-engine.codes_cm.shape[1] // 4) + 4)
    del engine
    check_ivfpq_m64_cli()


def check_ivfpq_m64_cli():
    """build-index --index-type IVFPQ at M_pq 64 -> pipeline on the fixture:
    its 150 reads (the device plan, packed scan #7) and the same reads 28
    times over (4,200 reads: the host plan's fold route, #8)."""
    import torch

    from deepreadmapper_tpu_torch import cli, kernels

    work = os.path.join(WORK, "ivfpq_m64")
    os.makedirs(work, exist_ok=True)
    fna, fq = os.path.join(FIXTURE, "ecoli_150.fna"), os.path.join(FIXTURE, "test_data.fastq")
    idx = os.path.join(work, "idx")
    if cli.main(["build-index", fna, idx, str(READ_LEN), "1", "64", "--index-type",
                 "IVFPQ"]) != 0:
        raise AssertionError("IVFPQ M_pq 64 build-index failed")
    with open(fq) as f:
        text = f.read()
    names = text.splitlines()[0::4]
    tiled = os.path.join(work, "reads_x28.fastq")
    with open(tiled, "w") as f:
        f.write(text * 28)
    for tag, reads, kernel in (("150 reads", fq, "ivf_chunk_pq"),
                               ("4,200 reads", tiled, "ivf_chunk_pq_fold")):
        out = os.path.join(work, f"out_{kernel}")
        kernels.reset_counts()
        t0 = time.perf_counter()
        rc = cli.main(["pipeline", idx, reads, fna, "16", "128", "128", out, "--no-sam"])
        torch.cuda.synchronize()
        t_pipe = time.perf_counter() - t0
        launches = kernels.counts()
        hits = truth_hits(np.load(os.path.join(out, "indices.npy"))[:150], names, 2)
        log(f"[genome_ivfpq] IVFPQ M_pq 64 on the fixture, {tag} at nprobe 16: {t_pipe:.2f} s, "
            f"launches {launches}; truth hits {hits}/150 (need >= 135)")
        if rc != 0 or launches[kernel] < 1 or hits < 135:
            raise AssertionError(f"IVFPQ M_pq 64 pipeline ({tag}): rc {rc}, hits {hits}, "
                                 f"{launches}")


_STEP_GROUPS = (  # kernel-name fragment -> part of a training step
    ("gru_fwd", "GRU forward (#1)"), ("gru_bwd", "GRU backward (#9)"),
    ("gemm", "matmuls"), ("Kernel2", "matmuls"), ("index", "embedding gather/scatter"),
    ("sort", "embedding gather/scatter"), ("multi_tensor", "Adam"), ("adam", "Adam"),
    ("Memcpy", "copies"), ("Memset", "copies"),
)
_SEARCH_GROUPS = (  # kernel-name fragment -> part of an INT8FLAT embed + search
    ("int8_winmin", "int8 scan (#2)"), ("gru_fwd", "GRU forward (#1)"), ("sort", "sort"),
    ("Memcpy", "copies"), ("Memset", "copies"),
)


def _profile(tag: str, unit: str, run, n: int, groups) -> None:
    """torch.profiler over run() (n units of work): device time per unit by
    part (kernel-name fragment -> part; the rest "other"), and the device's
    busy share of the window."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    parts: dict[str, float] = {}
    for e in prof.key_averages():
        us = float(e.self_device_time_total)
        if e.device_type != DeviceType.CUDA or us <= 0:  # kernels, copies, memsets
            continue
        part = next((p for frag, p in groups if frag.lower() in e.key.lower()), "other")
        parts[part] = parts.get(part, 0.0) + us
    busy = sum(parts.values()) / 1e3
    if busy <= 0:
        log(f"[{tag}] profiler: no device time recorded")
        return
    split = " | ".join(f"{k} {v / 1e3 / n:.2f} ms" for k, v in
                       sorted(parts.items(), key=lambda kv: -kv[1]))
    log(f"[{tag}] profile over {n} x one {unit} (profiler on): wall {wall * 1e3 / n:.2f} ms/{unit}, "
        f"device busy {busy / n:.2f} ms/{unit} ({busy / (wall * 1e3):.1%}); per {unit}: {split}")


def phase_finetune(results: dict, genome: dict):
    """finetune -> build-index --weights -> pipeline on phase 5's genome and
    reads: kernels #9 and #1 on the training path."""
    import contextlib
    import io

    import torch

    from deepreadmapper_tpu_torch import cli, kernels
    from deepreadmapper_tpu_torch.io import fasta as fasta_io
    from deepreadmapper_tpu_torch.models import encoder as enc
    from deepreadmapper_tpu_torch.parallel import train
    from deepreadmapper_tpu_torch.pipeline import finetune as ft

    ref, fq = genome["ref"], genome["fq"]
    work = os.path.join(WORK, "finetune")
    os.makedirs(work, exist_ok=True)
    seq = fasta_io.extract_fasta_sequence(ref)

    # 1. one step's gradients: the card (kernels) against the CPU (plain)
    rt, wt = ft.sample_pairs(seq, READ_LEN, TRAIN_B, np.random.default_rng(0))
    grads = {}
    for dev in ("cuda", "cpu"):
        params = enc.torch_params(enc.load_params(), dev, requires_grad=True)
        t0 = time.perf_counter()
        loss = train.loss_fn(params, torch.from_numpy(rt).to(dev), torch.from_numpy(wt).to(dev))
        loss.backward()
        grads[dev] = (loss.item(), [p.grad.cpu() for p in train.leaves(params)])
        log(f"[finetune] one step's loss + gradients on {dev}: loss {grads[dev][0]:.6f}, "
            f"{time.perf_counter() - t0:.2f} s")
    worst = 0.0
    for g, c in zip(grads["cuda"][1], grads["cpu"][1]):
        worst = max(worst, float((g - c).abs().max() / c.abs().max()))
    log(f"[finetune] card vs CPU gradients, batch {TRAIN_B}: worst max abs diff / max abs "
        f"value over the 9 tensors {worst:.3e} (need <= 1e-4)")
    if worst > 1e-4:
        raise AssertionError(f"finetune gradients: card vs CPU {worst} > 1e-4")

    # 2. the CLI at its defaults; the losses are read off finetune's return,
    # a host timestamp is taken where each step starts (sampling), and the
    # optimizer's construction is timed
    tuned = os.path.join(work, "tuned.npz")
    seen, stamps, t_opt = {}, [], []
    run, sample, make_opt = ft.finetune, ft.sample_pairs, ft.make_optimizer

    def recording(*a, **kw):
        seen["params"], seen["losses"] = run(*a, **kw)
        return seen["params"], seen["losses"]

    def stamped(*a, **kw):
        stamps.append(time.perf_counter())
        return sample(*a, **kw)

    def timed_opt(*a, **kw):
        t = time.perf_counter()
        opt = make_opt(*a, **kw)
        t_opt.append(time.perf_counter() - t)
        return opt

    dynamo_before = "torch._dynamo" in sys.modules
    ft.finetune, ft.sample_pairs, ft.make_optimizer = recording, stamped, timed_opt
    kernels.reset_counts()
    t0 = time.perf_counter()
    try:
        rc = cli.main(["finetune", ref, str(READ_LEN), "-o", tuned])
    finally:
        ft.finetune, ft.sample_pairs, ft.make_optimizer = run, sample, make_opt
    torch.cuda.synchronize()
    t_ft = time.perf_counter() - t0
    launches = kernels.counts()
    if rc != 0:
        raise AssertionError("finetune CLI failed")
    losses = np.asarray(seen["losses"])
    first, last = float(losses[:10].mean()), float(losses[-10:].mean())
    half = TRAIN_STEPS // 2
    steady = (stamps[-1] - stamps[half - 1]) / (TRAIN_STEPS - half)
    log(f"[finetune] CLI: {TRAIN_STEPS} steps of {TRAIN_B} pairs in {t_ft:.2f} s "
        f"({TRAIN_STEPS / t_ft:.2f} steps/s, {TRAIN_STEPS * TRAIN_B / t_ft:.0f} pairs/s): "
        f"set-up to the first step {stamps[0] - t0:.2f} s (of which torch.optim.Adam's "
        f"construction {t_opt[0]:.2f} s; torch._dynamo loaded before it: {dynamo_before}), "
        f"first step {stamps[1] - stamps[0]:.2f} s, steady {steady * 1e3:.2f} ms/step "
        f"({1 / steady:.1f} steps/s, {TRAIN_B / steady:.0f} pairs/s; host clock between "
        f"step starts, steps {half}-{TRAIN_STEPS}), last step + save "
        f"{t0 + t_ft - stamps[-1]:.2f} s")
    log(f"[finetune] loss mean of the first 10 steps {first:.4f}, of the last 10 "
        f"{last:.4f}; launches {launches}")
    if losses.size != TRAIN_STEPS or not np.isfinite(losses).all() or not last < first:
        raise AssertionError(f"finetune losses: {losses.tolist()}")
    if launches["gru_bwd"] != 8 * TRAIN_STEPS or launches["gru_fwd"] != 12 * TRAIN_STEPS:
        raise AssertionError(f"finetune launches: {launches} (want gru_bwd 8 and gru_fwd "
                             "12 per step)")
    results["gru_bwd"]["launches"] = launches["gru_bwd"]

    # 3. where a step's time goes: host sampling, and the device by part
    rng = np.random.default_rng(1)
    t0 = time.perf_counter()
    batches = [ft.sample_pairs(seq, READ_LEN, TRAIN_B, rng) for _ in range(3)]
    t_sample = (time.perf_counter() - t0) / 3
    log(f"[finetune] host sampling of {TRAIN_B} pairs: {t_sample * 1e3:.2f} ms per step")
    params = enc.torch_params(seen["params"], "cuda", requires_grad=True)
    opt = train.make_optimizer(params)
    batches = [tuple(torch.from_numpy(a).cuda() for a in b) for b in batches]
    train.train_step(params, opt, *batches[0])  # warm
    _profile("finetune", "step",
             lambda: [train.train_step(params, opt, rt, wt) for rt, wt in batches],
             len(batches), _STEP_GROUPS)

    # 4. build-index --weights -> pipeline on phase 5's reads
    idx, out = os.path.join(work, "idx"), os.path.join(work, "out")
    buf = io.StringIO()
    kernels.reset_counts()
    with contextlib.redirect_stdout(buf):
        rc_b = cli.main(["build-index", ref, idx, str(READ_LEN), "--weights", tuned])
        rc_p = cli.main(["pipeline", idx, fq, ref, "128", "128", "5", out, "--no-sam"])
    torch.cuda.synchronize()
    launches = kernels.counts()
    sys.stdout.write(buf.getvalue())
    if rc_b != 0 or rc_p != 0:
        raise AssertionError("build-index --weights -> pipeline failed")
    if "index-matched encoder weights" not in buf.getvalue():
        raise AssertionError("the pipeline did not load the index's fine-tuned weights")
    if launches["gru_fwd"] <= 0 or launches["int8_winmin"] <= 0:
        raise AssertionError(f"fine-tuned index path missed a kernel: {launches}")
    top1 = _top1(np.load(os.path.join(out, "indices.npy")), genome["starts"],
                 genome["strands"])
    log(f"[finetune] fine-tuned INT8FLAT index, {N_READS} reads: top-1 {top1:.4f} (need >= "
        f"phase 5's {genome['top1']:.4f} - 0.01); launches {launches}")
    if top1 < genome["top1"] - 0.01:
        raise AssertionError(f"fine-tuned top-1 {top1} < {genome['top1']} - 0.01")


def _sam_reads(path: str) -> tuple[list[str], dict]:
    """(header lines, read name -> its SAM lines split into fields, in file
    order)."""
    header, reads = [], {}
    with open(path) as f:
        for ln in f:
            if ln.startswith("@"):
                header.append(ln.rstrip("\n"))
            else:
                fields = ln.rstrip("\n").split("\t")
                reads.setdefault(fields[0], []).append(fields)
    return header, reads


def _primary(lines: list) -> list:
    return next(f for f in lines if not int(f[1]) & 0x100)


def _reconstruct_ref(seq: str, cigar: str, md: str) -> str:
    """SEQ + CIGAR + MD -> the reference bases they align to (the samtools
    calmd identity; tests/test_sam_tags.py's check)."""
    import re

    aligned, si = [], 0
    for n, op in re.findall(r"(\d+)([MIDSH])", cigar):
        n = int(n)
        if op == "M":
            aligned.append(seq[si:si + n])
            si += n
        elif op in ("I", "S"):
            si += n
    qa, ref, qi = "".join(aligned), [], 0
    for tok in re.findall(r"(\d+|\^[A-Z]+|[A-Z])", md):
        if tok.isdigit():
            ref.append(qa[qi:qi + int(tok)])
            qi += int(tok)
        elif tok.startswith("^"):
            ref.append(tok[1:])
        else:
            ref.append(tok)
            qi += 1
    return "".join(ref)


def _bam_records(path: str) -> int:
    """Records in a BAM file (gunzipped whole; checks the magic and the
    BGZF EOF block)."""
    import gzip
    import struct

    raw = open(path, "rb").read()
    if not raw.endswith(BGZF_EOF):
        raise AssertionError(f"{path} does not end in the BGZF EOF block")
    data = gzip.decompress(raw)
    if data[:4] != b"BAM\x01":
        raise AssertionError(f"{path}: magic {data[:4]!r}")
    (l_text,) = struct.unpack_from("<i", data, 4)
    off = 8 + l_text
    (n_ref,) = struct.unpack_from("<i", data, off)
    off += 4
    for _ in range(n_ref):
        (l_name,) = struct.unpack_from("<i", data, off)
        off += 8 + l_name
    n = 0
    while off < len(data):
        (block,) = struct.unpack_from("<i", data, off)
        off += 4 + block
        n += 1
    if off != len(data):
        raise AssertionError(f"{path}: a record overruns the data")
    return n


class _Timers:
    """Accumulated host seconds of named module functions while patched in:
    where the SAM path's time goes."""

    def __init__(self, targets):
        self.targets, self.s, self.saved = targets, {}, []

    def __enter__(self):
        for label, mod, name in self.targets:
            fn = getattr(mod, name)
            self.saved.append((mod, name, fn))

            def timed(*a, _fn=fn, _label=label, **kw):
                t0 = time.perf_counter()
                try:
                    return _fn(*a, **kw)
                finally:
                    self.s[_label] = self.s.get(_label, 0.0) + time.perf_counter() - t0

            setattr(mod, name, timed)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)

    def line(self) -> str:
        return " | ".join(f"{k} {v:.3f} s" for k, v in self.s.items())


def phase_genome_sam(genome: dict):
    """The full single-end SAM path on phase 5's index, genome and reads
    (k = 10): MAPQ, CIGAR/NM/MD/AS, QUAL, read group, sort, duplicates,
    BAM; streaming; calibrated and SW MAPQ; inference; the bf16 encoder;
    serve; the bench twin; --profile.  Every gate raises."""
    import contextlib
    import io

    import torch

    from deepreadmapper_tpu_torch import bench, cli, kernels
    from deepreadmapper_tpu_torch.index.registry import load_index
    from deepreadmapper_tpu_torch.io import sam as sam_io
    from deepreadmapper_tpu_torch.io.fastq import parse_fastq_bytes
    from deepreadmapper_tpu_torch.models.encoder import Vectorizer
    from deepreadmapper_tpu_torch.ops.pack import bits_needed, pack_ids_device, unpack_ids_host
    from deepreadmapper_tpu_torch.ops.topk import l2_topk
    from deepreadmapper_tpu_torch.pipeline import postprocess as pp
    from deepreadmapper_tpu_torch.pipeline import search as ps
    from deepreadmapper_tpu_torch.pipeline.build import embed_fasta_windows
    from deepreadmapper_tpu_torch.pipeline.serve import serve
    from deepreadmapper_tpu_torch.tokenizer_device import pack_wrapped

    work = os.path.join(WORK, "genome_sam")
    os.makedirs(work, exist_ok=True)
    ref, idx, starts, strands = genome["ref"], genome["idx"], genome["starts"], genome["strands"]
    gbytes = genome["genome"].tobytes().decode()
    n = starts.size
    # phase 5's reads with qualities that vary along each read, so a
    # reversed QUAL shows
    quals = ["".join(chr(33 + (7 * j + i) % 41) for j in range(READ_LEN)) for i in range(n)]
    fq = os.path.join(work, "reads.fastq")
    with open(genome["fq"]) as src, open(fq, "w") as f:
        for i, rec in enumerate(zip(*[iter(src.read().splitlines())] * 4)):
            f.write(f"{rec[0]}\n{rec[1]}\n+\n{quals[i]}\n")
    reads = {f"_{starts[i]}_{strands[i]}_{i}": i for i in range(n)}
    top = np.load(os.path.join(genome["out"], "indices.npy"))[:, 0].astype(np.int64)
    right = (np.abs((top >> 1) - starts) <= 5) & ((top & 1) == strands)  # as phase 5 judges
    args = [idx, fq, ref, "128", str(SAM_K), "5"]
    rg = ["--read-group", SAM_RG]

    # 1. the full feature path
    out = os.path.join(work, "full")
    timers = _Timers([("quals", ps, "parse_fastq_quals"), ("rerank", pp, "post_process_l2"),
                      ("cigar", ps, "_primary_alignment_cigars"), ("mapq", ps, "compute_mapq"),
                      ("sam", sam_io, "write_sam"), ("sort", sam_io, "sort_sam_file"),
                      ("dups", sam_io, "mark_duplicates"), ("bam", ps, "sam_to_bam")])
    kernels.reset_counts()
    t0 = time.perf_counter()
    with timers:
        rc = cli.main(["pipeline", *args, out, "--mapq", "--cigar", "--qual", *rg, "--sort",
                       "--mark-duplicates", "--bam"])
    t_full = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError("genome_sam full pipeline failed")
    log(f"[genome_sam] full pipeline ({n} reads, k {SAM_K}): {t_full:.2f} s; host split: "
        f"{timers.line()}; launches {kernels.counts()}")
    sam = os.path.join(out, "results.sam")
    header, recs = _sam_reads(sam)
    lines = [f for v in recs.values() for f in v]
    if len(recs) != n or len(lines) != n * SAM_K:
        raise AssertionError(f"SAM holds {len(recs)} reads, {len(lines)} lines")
    if "@RG\tID:smoke\tSM:s1" not in header or not all(f[-1] == "RG:Z:smoke" for f in lines):
        raise AssertionError("read group missing from the header or a line")
    mapqs = np.array([int(f[4]) for f in lines])
    if mapqs.min() < 0 or mapqs.max() > 60:
        raise AssertionError(f"MAPQ out of [0, 60]: {mapqs.min()}..{mapqs.max()}")
    comp = str.maketrans("ACGT", "TGCA")
    n_real = pos_ok = pos_n = 0
    prim_mapq = np.zeros(n, np.int64)
    for name, fl in recs.items():
        i = reads[name]
        for f in fl:
            real = "\tNM:i:" in "\t" + "\t".join(f[11:])
            rev = int(f[1]) & 16 and real
            want_q = quals[i][::-1] if rev else quals[i]
            if f[10] != want_q:
                raise AssertionError(f"{name}: QUAL differs from the FASTQ's")
        p = _primary(fl)
        prim_mapq[i] = int(p[4])
        tags = {t.split(":", 2)[0]: t.split(":", 2)[2] for t in p[11:]}
        if "MD" not in tags:
            continue
        n_real += 1
        pos, cigar, seq = int(p[3]), p[5], p[9]
        recon = _reconstruct_ref(seq, cigar, tags["MD"])
        if recon != gbytes[pos - 1: pos - 1 + len(recon)]:
            raise AssertionError(f"{name}: SEQ + CIGAR + MD do not rebuild the genome at {pos}")
        import re

        ops = re.findall(r"(\d+)([MIDS])", cigar)
        if sum(int(k) for k, op in ops if op in "MIS") != READ_LEN:
            raise AssertionError(f"{name}: CIGAR {cigar} does not cover {READ_LEN} bases")
        if right[i]:
            lead = int(ops[0][0]) if ops[0][1] == "S" else 0
            pos_n += 1
            pos_ok += pos - lead == starts[i] + 1
    if n_real < 0.99 * n:
        raise AssertionError(f"only {n_real} of {n} primaries carry a real CIGAR")
    log(f"[genome_sam] {n_real} primaries with a real CIGAR: every one rebuilds the genome "
        f"from SEQ + CIGAR + MD and covers {READ_LEN} bases; POS - leading clip == the "
        f"simulated start on {pos_ok}/{pos_n} primaries with a right top-1 (need >= 0.99); "
        f"QUAL and RG on every line")
    if pos_ok < 0.99 * pos_n:
        raise AssertionError(f"POS right on {pos_ok}/{pos_n}")
    keys = [(f[2], int(f[3])) for ln in open(sam) if not ln.startswith("@")
            for f in [ln.split("\t", 4)]]
    if keys != sorted(keys) or "SO:coordinate" not in header[0]:
        raise AssertionError("the SAM is not coordinate-sorted")
    n_bam = _bam_records(os.path.join(out, "results.bam"))
    if n_bam != len(lines) or not os.path.exists(os.path.join(out, "results.bam.bai")):
        raise AssertionError(f"BAM holds {n_bam} records of {len(lines)}, or no .bai")
    hist = np.bincount(prim_mapq, minlength=61)
    log(f"[genome_sam] sorted; BAM: {n_bam} records, EOF block, .bai; primary MAPQ "
        f"histogram (value:count) {dict((int(q), int(c)) for q, c in enumerate(hist) if c)}; "
        f"median MAPQ, right top-1 {np.median(prim_mapq[right]):.0f} ({right.sum()} reads), "
        f"wrong {np.median(prim_mapq[~right]) if (~right).any() else float('nan'):.0f} "
        f"({(~right).sum()} reads)")

    # 2. streaming: two batches of the default 5000 reads, the same bytes
    outs = {}
    for streaming in ("1", "0"):
        o = os.path.join(work, f"stream{streaming}")
        t0 = time.perf_counter()
        if cli.main(["pipeline", *args, o, "0", streaming, "--mapq", "--cigar", "--qual",
                     *rg]) != 0:
            raise AssertionError("genome_sam streaming pipeline failed")
        outs[streaming] = (open(os.path.join(o, "results.sam"), "rb").read(),
                           time.perf_counter() - t0)
    if outs["1"][0] != outs["0"][0]:
        raise AssertionError("the streamed SAM differs from the one-shot SAM")
    log(f"[genome_sam] use_streaming 1 ({-(-n // 5000)} batches of at most 5000 reads) "
        f"and 0: byte-identical SAMs "
        f"({len(outs['1'][0])} bytes; {outs['1'][1]:.2f} s against {outs['0'][1]:.2f} s)")

    # 3. MAPQ: calibrated on the L2 path, raw on the SW path
    o = os.path.join(work, "cal")
    if cli.main(["pipeline", *args, o, "--mapq", "--mapq-calibrated"]) != 0:
        raise AssertionError("genome_sam --mapq-calibrated failed")
    raw = {k: int(_primary(v)[4]) for k, v in _sam_reads(
        os.path.join(work, "stream0", "results.sam"))[1].items()}
    cal = {k: int(_primary(v)[4]) for k, v in _sam_reads(os.path.join(o, "results.sam"))[1].items()}
    names = sorted(raw)
    if not np.array_equal(ps.calibrate_mapq(np.array([raw[k] for k in names])),
                          np.array([cal[k] for k in names])):
        raise AssertionError("calibrated MAPQ != calibrate_mapq(raw MAPQ)")
    o = os.path.join(work, "sw")
    kernels.reset_counts()
    t0 = time.perf_counter()
    if cli.main(["pipeline", *args, o, "--rerank", "sw", "--mapq"]) != 0:
        raise AssertionError("genome_sam --rerank sw --mapq failed")
    launches = kernels.counts()
    sw_q = [int(_primary(v)[4]) for v in _sam_reads(os.path.join(o, "results.sam"))[1].values()]
    if sw_launches(launches) <= 0 or min(sw_q) < 0 or max(sw_q) > 60:
        raise AssertionError(f"SW MAPQ path: launches {launches}, MAPQ {min(sw_q)}..{max(sw_q)}")
    log(f"[genome_sam] --mapq-calibrated == calibrate_mapq(raw) on {len(names)} reads; "
        f"--rerank sw --mapq in {time.perf_counter() - t0:.2f} s, launches {launches}, "
        f"median primary MAPQ {np.median(sw_q):.0f}")

    # 4. inference on the FASTQ against the pipeline path's embeddings
    emb_path = os.path.join(work, "emb.npy")
    if cli.main(["inference", fq, str(READ_LEN), emb_path]) != 0:
        raise AssertionError("inference failed")
    mat, lengths, _ = parse_fastq_bytes(fq)
    vec = Vectorizer()
    want = vec.vectorize_wrapped_bytes(mat, lengths)
    err = float(np.abs(np.load(emb_path) - want).max())
    log(f"[genome_sam] inference npy vs the pipeline's embeddings: max abs diff {err:.2e} "
        "(need <= 1e-5)")
    if err > 1e-5:
        raise AssertionError(f"inference differs from the pipeline's embeddings by {err}")

    # 5. the bf16 Vectorizer on the INT8FLAT index
    engine, config = load_index(idx)
    top1 = {}
    for dtype in ("float32", "bfloat16"):
        v = Vectorizer(dtype=dtype)
        v.vectorize_wrapped_bytes(mat, lengths)  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        q = v.vectorize_wrapped_bytes(mat, lengths)
        t_e = time.perf_counter() - t0
        ids, _ = engine.search(q, 1)
        top1[dtype] = (_top1(ids, starts, strands), t_e)
    log(f"[genome_sam] bf16 Vectorizer: top-1 {top1['bfloat16'][0]:.4f} against fp32 "
        f"{top1['float32'][0]:.4f} (need >= fp32 - 0.01); embed {top1['bfloat16'][1]:.3f} s "
        f"against {top1['float32'][1]:.3f} s")
    if top1["bfloat16"][0] < top1["float32"][0] - 0.01:
        raise AssertionError(f"bf16 top-1 {top1['bfloat16'][0]}")

    # 6. serve in process: two requests, quit (phase 11 serves a paired one)
    del engine
    o1, o2 = os.path.join(work, "srv1"), os.path.join(work, "srv2")
    reqs = [{"id": "plain", "fastq": fq, "output_dir": o1, "ef": 128, "k": SAM_K,
             "k_clusters": 5},
            {"id": "tags", "fastq": fq, "output_dir": o2, "ef": 128, "k": SAM_K,
             "k_clusters": 5, "mapq": True, "cigar": True, "qual": True,
             "read_group": SAM_RG},
            {"cmd": "quit"}]
    sout = io.StringIO()
    with contextlib.redirect_stdout(io.StringIO()) as noise:
        served = serve(idx, ref, in_stream=io.StringIO(
            "".join(json.dumps(r) + "\n" for r in reqs)), out_stream=sout)
    replies = [json.loads(ln) for ln in sout.getvalue().splitlines()]
    if noise.getvalue() or served != 2 or [r.get("ok") for r in replies] != [True] * 4:
        raise AssertionError(f"serve: {served} served, replies {replies}, stdout "
                             f"{noise.getvalue()[:200]!r}")
    o1_one = os.path.join(work, "one_shot")
    one = ps.run_pipeline(idx, fq, ref, ef=128, k=SAM_K, k_clusters=5, output_dir=o1_one)
    same = [open(os.path.join(o1, "results.sam"), "rb").read()
            == open(os.path.join(o1_one, "results.sam"), "rb").read(),
            open(os.path.join(o2, "results.sam"), "rb").read()
            == open(os.path.join(work, "stream0", "results.sam"), "rb").read()]
    if not all(same):
        raise AssertionError(f"serve's SAMs differ from the one-shot pipeline's: {same}")
    warm = replies[2]
    log(f"[genome_sam] serve: t_load {replies[0]['t_load']:.3f} s; warm request (tags) embed + "
        f"search {warm['t_embed'] + warm['t_search']:.3f} s, post {warm['t_post']:.3f} s; the "
        f"one-shot run {one['t_embed'] + one['t_search']:.3f} s (index load "
        f"{one['t_index']:.3f} s); both SAMs equal the one-shot ones")

    # 7. the bench twin: its line, and its ids against an unpacked top-k
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = bench.main(reps=BENCH_REPS)
    line = buf.getvalue().strip().splitlines()
    rec = json.loads(line[-1]) if line else {}
    log(f"[genome_sam] bench twin: {line[-1] if line else 'no line'}")
    if rc != 0 or len(line) != 1 or set(rec) != BENCH_KEYS or not rec["value"] > 0:
        raise AssertionError(f"bench twin line: {line}")
    _, ids = bench.bench(reps=BENCH_REPS, trials=1)
    mat_f, len_f, _ = parse_fastq_bytes(os.path.join(FIXTURE, "test_data.fastq"))
    mat_f, len_f = np.tile(mat_f, (BENCH_REPS, 1)), np.tile(len_f, BENCH_REPS)
    from deepreadmapper_tpu_torch.io import fasta as fasta_io

    vec4 = Vectorizer(device_batch=4096)
    ref_emb = embed_fasta_windows(
        fasta_io.parse_fasta_records(os.path.join(FIXTURE, "ecoli_150.fna")), 150, 1, vec4,
        device_out=True)
    with torch.no_grad():
        emb = vec4.encoder.encode_packed(torch.from_numpy(pack_wrapped(mat_f, len_f)).cuda())
        _, plain = l2_topk(emb, ref_emb, 128)
    plain = plain.cpu().numpy()
    nb = bits_needed(ref_emb.shape[0])
    round_trip = unpack_ids_host(pack_ids_device(torch.from_numpy(plain).cuda(), nb)
                                 .cpu().numpy(), 128, nb)
    if not (np.array_equal(ids, plain) and np.array_equal(round_trip, plain)):
        raise AssertionError("the bench twin's unpacked ids != the unpacked top-k")
    log(f"[genome_sam] bench twin ids ({ids.shape[0]} x 128, {nb}-bit packs) == the "
        "unpacked top-k on the card")

    # 8. --profile: the trace names both kernels of the path.  On phase 5's
    # index: the fixture's 1,702 rows are below the fused scan's 2^18-row
    # threshold (scan_kernel.MIN_FUSED_N), so its search launches no #2
    pdir = os.path.join(work, "profile")
    if cli.main(["pipeline", *args, os.path.join(work, "prof_out"), "--no-sam",
                 "--profile", pdir]) != 0:
        raise AssertionError("--profile pipeline failed")
    trace = json.load(open(os.path.join(pdir, "pipeline.pt.trace.json")))
    kern = [e["name"] for e in trace["traceEvents"] if e.get("cat") == "kernel"]
    found = {k: sum(k in name for name in kern) for k in ("gru_fwd", "int8_winmin")}
    log(f"[genome_sam] --profile trace: {len(kern)} kernel events, by name {found}")
    if not all(found.values()):
        raise AssertionError(f"the trace names no {[k for k, v in found.items() if not v]}")


# -- phase 11: paired ends and long reads -------------------------------------

_COMP = str.maketrans("ACGT", "TGCA")


def _make_genome(n_bp: int, seed: int) -> str:
    """scripts/demo_genome_scale.make_genome's genome (the same draws),
    built from bytes."""
    rng = np.random.default_rng(seed)
    return np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, n_bp)].tobytes().decode()


def _simulate_pairs(genome: str, n_pairs: int, read_len: int, isize_mean: int,
                    isize_sd: int, err: float, seed: int):
    """scripts/eval_paired.py's simulate_pairs, copied: FR pairs, R1 forward
    at the fragment start, R2 the reverse complement of its end, inserts
    from N(mean, sd) clipped to [2 read_len, mean + 4 sd], substitutions at
    err.  Returns (r1, r2, truth): truth holds (R1 start, R2 start)."""
    rng = np.random.default_rng(seed)
    bases = np.array(list("ACGT"))
    max_start = len(genome) - (isize_mean + 4 * isize_sd) - 1
    starts = rng.integers(0, max_start, n_pairs)
    isizes = np.clip(rng.normal(isize_mean, isize_sd, n_pairs).astype(int),
                     2 * read_len, isize_mean + 4 * isize_sd)

    def mutate(s):
        out = list(s)
        for i in np.flatnonzero(rng.random(len(out)) < err):
            out[i] = rng.choice(bases[bases != out[i]])
        return "".join(out)

    r1, r2, truth = [], [], []
    for i, (s, isz) in enumerate(zip(starts, isizes)):
        a = mutate(genome[s: s + read_len])
        b = mutate(genome[s + isz - read_len: s + isz]).translate(_COMP)[::-1]
        r1.append((f"p{i}", a))
        r2.append((f"p{i}", b))
        truth.append((int(s), int(s + isz - read_len)))
    return r1, r2, truth


def _lr_mutate(seq: str, sub: float, indel: float, rng) -> str:
    """scripts/eval_longread.py's mutate, copied: per base a deletion (indel
    / 2), an insertion before it (indel / 2) or a substitution (sub)."""
    out = []
    bases = "ACGT"
    for ch in seq:
        r = rng.random()
        if r < indel / 2:
            continue
        if r < indel:
            out.append(rng.choice(list(bases)))
            out.append(ch)
            continue
        if r < indel + sub:
            out.append(rng.choice([b for b in bases if b != ch]))
        else:
            out.append(ch)
    return "".join(out)


def _write_fastq(path: str, reads) -> None:
    with open(path, "w") as f:
        for name, seq in reads:
            f.write(f"@{name}\n{seq}\n+\n{'I' * len(seq)}\n")


def _write_fasta(path: str, genome: str) -> None:
    with open(path, "w") as f:
        f.write("> sim\n")
        for i in range(0, len(genome), 80):
            f.write(genome[i: i + 80] + "\n")


def _end_top1(ids: np.ndarray, truth: np.ndarray, strand: int) -> float:
    """Share of reads whose first candidate is within 5 bp of the truth, on
    the end's strand (R1 forward, R2 reverse)."""
    top = np.asarray(ids)[:, 0].astype(np.int64)
    return float(np.mean((np.abs((top >> 1) - truth) <= 5) & ((top & 1) == strand)))


def _paired_mapq30(sam: str, t1: np.ndarray, t2: np.ndarray) -> tuple[int, int]:
    """scripts/eval_paired.py's MAPQ calibration: among primaries with MAPQ
    >= 30, those within 110 bp of their end's start; returns (right, all)."""
    ok = tot = 0
    with open(sam) as f:
        for ln in f:
            if ln.startswith("@"):
                continue
            fl = ln.split("\t", 5)
            flag = int(fl[1])
            if flag & 0x900 or int(fl[4]) < 30:
                continue
            i = int(fl[0][1:])
            tot += 1
            ok += abs(int(fl[3]) - 1 - (t2[i] if flag & 0x80 else t1[i])) <= 110
    return ok, tot


def phase_genome_pe():
    """Paired ends at the shape of the JAX package's paired record
    (results/eval_paired_r3_5mbp.json): a seeded 5 Mbp genome with 5% of it
    planted as 2 kb repeats (scripts/eval_paired.py's recipe), 4,096 FR
    pairs of 150 bp (insert 500 +- 50, 2% substitutions), INT8FLAT, k 16:
    each end single-end, then run_pipeline_paired --max-isize 700 --mapq,
    then the same pairs with --rerank sw through the CLI, then a serve
    fastq2 request.  Every gate raises."""
    import contextlib
    import io

    import torch

    from deepreadmapper_tpu_torch import cli, kernels, native
    from deepreadmapper_tpu_torch.index.registry import load_index
    from deepreadmapper_tpu_torch.models.encoder import Vectorizer
    from deepreadmapper_tpu_torch.pipeline.search import run_pipeline, run_pipeline_paired
    from deepreadmapper_tpu_torch.pipeline.serve import serve

    if not native.available():
        raise AssertionError("the native library is not loaded: mate rescue would find "
                             "nothing and the banded CIGARs would be skipped")
    work = os.path.join(WORK, "genome_pe")
    os.makedirs(work, exist_ok=True)
    t0 = time.perf_counter()
    genome = _make_genome(PE_GENOME_BP, 0)
    rng = np.random.default_rng(7)  # eval_paired.py plants with seed + 7
    g = np.frombuffer(genome.encode(), np.uint8).copy()
    for _ in range(int(PE_GENOME_BP * PE_REPEAT_FRAC / PE_REPEAT_BLOCK)):
        src = rng.integers(0, PE_GENOME_BP // 2 - PE_REPEAT_BLOCK)
        dst = rng.integers(PE_GENOME_BP // 2, PE_GENOME_BP - PE_REPEAT_BLOCK)
        g[dst: dst + PE_REPEAT_BLOCK] = g[src: src + PE_REPEAT_BLOCK]
    genome = g.tobytes().decode()
    r1, r2, truth = _simulate_pairs(genome, PE_PAIRS, READ_LEN, PE_ISIZE, PE_ISIZE_SD,
                                    PE_ERR, seed=1)
    t1 = np.array([t[0] for t in truth], np.int64)
    t2 = np.array([t[1] for t in truth], np.int64)
    ref, f1, f2 = (os.path.join(work, n) for n in ("ref.fna", "r1.fastq", "r2.fastq"))
    _write_fasta(ref, genome)
    _write_fastq(f1, r1)
    _write_fastq(f2, r2)
    t_sim = time.perf_counter() - t0

    idx = os.path.join(work, "idx")
    t0 = time.perf_counter()
    if cli.main(["build-index", ref, idx, str(READ_LEN)]) != 0:
        raise AssertionError("genome_pe build-index failed")
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    log(f"[genome_pe] {PE_GENOME_BP} bp, {int(PE_GENOME_BP * PE_REPEAT_FRAC / PE_REPEAT_BLOCK)} "
        f"planted {PE_REPEAT_BLOCK} bp repeats, {PE_PAIRS} pairs simulated in {t_sim:.1f} s; "
        f"INT8FLAT build {t_build:.1f} s")

    # single-end per end, against one resident engine
    vec = Vectorizer()
    preloaded = load_index(idx)
    se = {}
    for end, fq, tcol, strand in (("R1", f1, t1, 0), ("R2", f2, t2, 1)):
        res = run_pipeline(idx, fq, ref, k=PE_K, output_dir=os.path.join(work, "se_" + end),
                           write_sam=False, vectorizer=vec, preloaded=preloaded)
        se[end] = _end_top1(res["final_ids"], tcol, strand)
    del preloaded
    torch.cuda.empty_cache()

    # paired, from the index load on
    out = os.path.join(work, "pe")
    kernels.reset_counts()
    t0 = time.perf_counter()
    res = run_pipeline_paired(idx, f1, f2, ref, k=PE_K, output_dir=out, mapq=True,
                              max_isize=PE_MAX_ISIZE)
    torch.cuda.synchronize()
    t_pair = time.perf_counter() - t0
    launches = kernels.counts()
    ids = np.load(os.path.join(out, "indices.npy"))
    pe = {"R1": _end_top1(ids[:PE_PAIRS], t1, 0), "R2": _end_top1(ids[PE_PAIRS:], t2, 1)}
    proper = res["n_proper"] / PE_PAIRS
    ok, tot = _paired_mapq30(os.path.join(out, "results.sam"), t1, t2)
    prec = ok / max(tot, 1)
    (e1, s1), (e2, s2) = res["t_ends"]
    tm = res["t_pair_split"]
    log(f"[genome_pe] paired (--max-isize {PE_MAX_ISIZE}, --mapq, k {PE_K}): wall "
        f"{t_pair:.2f} s = index load {res['t_index']:.2f} | R1 embed {e1:.3f} search "
        f"{s1:.3f} | R2 embed {e2:.3f} search {s2:.3f} | resolve {tm['resolve']:.3f} | rescue "
        f"{tm['rescue']:.3f} ({res['n_rescued']} pairs rescued) | SAM + npy {tm['sam']:.3f} s; "
        f"launches {launches}")
    log(f"[genome_pe] proper-pair rate {proper:.4f} (need >= 0.995); top-1 R1 {pe['R1']:.4f} / "
        f"R2 {pe['R2']:.4f} paired against {se['R1']:.4f} / {se['R2']:.4f} single-end (need >= "
        f"single-end and >= {JAX_PE_TOP1[0] - 0.01:.4f} / {JAX_PE_TOP1[1] - 0.01:.4f}); MAPQ >= 30 "
        f"precision {prec:.4f} on {tot} primaries (need >= 0.995)")
    bad = []
    if proper < 0.995:
        bad.append(f"proper-pair rate {proper}")
    for j, end in enumerate(("R1", "R2")):
        if pe[end] < se[end] or pe[end] < JAX_PE_TOP1[j] - 0.01:
            bad.append(f"paired top-1 {end} {pe[end]}")
    if prec < 0.995:
        bad.append(f"MAPQ >= 30 precision {prec}")
    if launches["gru_fwd"] <= 0 or launches["int8_winmin"] <= 0:
        bad.append(f"launches {launches}")
    if bad:
        raise AssertionError(f"genome_pe: {bad}")

    # the SW rerank on the same pairs, through the CLI
    o = os.path.join(work, "pe_sw")
    kernels.reset_counts()
    t0 = time.perf_counter()
    if cli.main(["pipeline", idx, f1, ref, "128", str(PE_K), "5", o, "--paired2", f2,
                 "--rerank", "sw", "--mapq", "--max-isize", str(PE_MAX_ISIZE)]) != 0:
        raise AssertionError("genome_pe --rerank sw failed")
    t_sw = time.perf_counter() - t0
    launches = kernels.counts()
    ids = np.load(os.path.join(o, "indices.npy"))
    sw = (_end_top1(ids[:PE_PAIRS], t1, 0), _end_top1(ids[PE_PAIRS:], t2, 1))
    log(f"[genome_pe] --rerank sw: {t_sw:.2f} s, top-1 {sw[0]:.4f} / {sw[1]:.4f}, launches "
        f"{launches}")
    if sw_launches(launches) <= 0:
        raise AssertionError(f"the paired SW run launched no sw_score: {launches}")

    # serve: a fastq2 request equals the one-shot paired run
    so = os.path.join(work, "srv")
    reqs = [{"id": "pe", "fastq": f1, "fastq2": f2, "output_dir": so, "k": PE_K,
             "mapq": True, "max_isize": PE_MAX_ISIZE}, {"cmd": "quit"}]
    sout = io.StringIO()
    with contextlib.redirect_stdout(io.StringIO()):
        served = serve(idx, ref, in_stream=io.StringIO(
            "".join(json.dumps(r) + "\n" for r in reqs)), out_stream=sout)
    replies = [json.loads(ln) for ln in sout.getvalue().splitlines()]
    same = all(open(os.path.join(so, n), "rb").read() == open(os.path.join(out, n), "rb").read()
               for n in ("results.sam", "indices.npy", "distances.npy"))
    log(f"[genome_pe] serve fastq2 request: ok {replies[1].get('ok')}, embed + search "
        f"{replies[1].get('t_embed', 0) + replies[1].get('t_search', 0):.3f} s; SAM and npy "
        f"byte-identical to the one-shot run: {same}")
    if served != 1 or not replies[1].get("ok") or not same:
        raise AssertionError(f"serve's paired request: {replies}, identical {same}")
    shutil.rmtree(work, ignore_errors=True)


def phase_genome_lr(genome: dict):
    """Long reads on phase 5's 2 Mbp INT8FLAT index and genome
    (scripts/eval_longread.py's default size): 256 reads each of 1 and 5
    kb at 1% and 5% error, 40% of it indels, both strands, and one
    chimera; pipeline --long-reads --cigar --mapq.  Every gate raises."""
    import re

    import torch

    from deepreadmapper_tpu_torch import cli, kernels, native
    from deepreadmapper_tpu_torch.index.registry import load_index
    from deepreadmapper_tpu_torch.models.encoder import Vectorizer
    from deepreadmapper_tpu_torch.pipeline.longread import chunk_read
    from deepreadmapper_tpu_torch.pipeline.search import run_pipeline

    if not native.available():
        raise AssertionError("the native library is not loaded: no banded CIGARs")
    work = os.path.join(WORK, "genome_lr")
    os.makedirs(work, exist_ok=True)
    gstr = genome["genome"].tobytes().decode()
    ref, idx = genome["ref"], genome["idx"]
    n_bp = len(gstr)
    # the chimera (eval_longread.py's: 800 + 700 bp from the two halves)
    # through the CLI: the entry point loads the index
    rng = np.random.default_rng(99)
    a = int(rng.integers(0, n_bp // 2 - 1000))
    b = int(rng.integers(n_bp // 2, n_bp - 1000))
    chim = (_lr_mutate(gstr[a: a + 800], 0.005, 0.005, rng)
            + _lr_mutate(gstr[b: b + 700], 0.005, 0.005, rng))
    fq = os.path.join(work, "chim.fastq")
    _write_fastq(fq, [("chim", chim)])
    out = os.path.join(work, "chim")
    if cli.main(["pipeline", idx, fq, ref, "128", "4", "5", out, "--long-reads", "--cigar",
                 "--mapq"]) != 0:
        raise AssertionError("genome_lr chimera pipeline failed")
    lines = [ln.split("\t") for ln in open(os.path.join(out, "results.sam"))
             if not ln.startswith("@")]
    supp = [f for f in lines if int(f[1]) & 0x800]
    log(f"[genome_lr] chimera ({a} + 800 bp, {b} + 700 bp): primary POS "
        f"{_primary(lines)[3]}, supplementary {[(f[3], f[5]) for f in supp]}")
    if not supp or abs(int(supp[0][3]) - 1 - b) > 110:
        raise AssertionError(f"the chimera has no FLAG-2048 line at its second locus: {supp}")

    # the scan's workspace: an 8192-read search of the main path (two
    # 2^21-row chunks, choose_chunk) above what stays resident (the index,
    # uploaded by a first search, and the encoder)
    vec = Vectorizer()
    preloaded = load_index(idx)
    engine = preloaded[0]
    q = vec.vectorize_wrapped_bytes(genome["wrapped"], np.full(N_READS, READ_LEN + 2))
    engine.search(q[:8], 4)
    torch.cuda.synchronize()
    index_bytes = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    engine.search(q, 128)
    torch.cuda.synchronize()
    ws_main = torch.cuda.max_memory_allocated() - index_bytes
    log(f"[genome_lr] resident index + encoder {index_bytes / 2**30:.3f} GiB; an {N_READS}-read "
        f"k-128 search's workspace above it {ws_main / 2**30:.3f} GiB "
        f"({ws_main / 1e9:.3f} GB)")
    rows, n_real = [], 0
    kernels.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    for L in LR_LENS:
        for err in LR_ERRS:
            rng = np.random.default_rng(L + int(err * 1000))  # eval_longread.py's seeds
            reads, starts, strands = [], [], []
            for i in range(LR_READS):
                s = int(rng.integers(0, n_bp - L))
                seq = _lr_mutate(gstr[s: s + L], err * 0.6, err * 0.4, rng)
                st = int(rng.integers(0, 2))
                reads.append((f"r{i}", seq.translate(_COMP)[::-1] if st else seq))
                starts.append(s)
                strands.append(st)
            fq = os.path.join(work, f"lr_{L}_{err}.fastq")
            _write_fastq(fq, reads)
            out = os.path.join(work, f"out_{L}_{err}")
            t0 = time.perf_counter()
            res = run_pipeline(idx, fq, ref, k=4, output_dir=out, long_reads=True, cigar=True,
                               mapq=True, vectorizer=vec, preloaded=preloaded)
            dt = time.perf_counter() - t0
            ids = np.load(os.path.join(out, "indices.npy"))
            tol = max(20, int(L * err))  # eval_longread.py's: indel drift grows with L * err
            ok = (np.abs(ids[:, 0] // 2 - np.array(starts)) <= tol) & (
                ids[:, 0] % 2 == np.array(strands))
            mq = np.zeros(LR_READS, np.int64)
            for ln in open(os.path.join(out, "results.sam")):
                if ln.startswith("@"):
                    continue
                f = ln.rstrip("\n").split("\t")
                if int(f[1]) & 0x900:
                    continue
                i = int(f[0][1:])
                mq[i] = int(f[4])
                tags = {t.split(":", 2)[0]: t.split(":", 2)[2] for t in f[11:]}
                if "MD" in tags:
                    n_real += 1
                    pos, recon = int(f[3]), _reconstruct_ref(f[9], f[5], tags["MD"])
                    if recon != gstr[pos - 1: pos - 1 + len(recon)]:
                        raise AssertionError(f"{L} bp, {err}: r{i}'s SEQ + CIGAR + MD do not "
                                             f"rebuild the genome at {pos}")
                    ops = re.findall(r"(\d+)([MIDS])", f[5])
                    if sum(int(n) for n, op in ops if op in "MIS") != len(f[9]):
                        raise AssertionError(f"r{i}: CIGAR {f[5]} does not cover its SEQ")
            hi = mq >= 30
            split = res["t_lr_split"]
            n_chunks = sum(len(chunk_read(len(seq), READ_LEN)) for _, seq in reads)
            row = {"read_len": L, "err": err, "top1": float(ok.mean()),
                   "mapq30_precision": float(ok[hi].mean()) if hi.any() else 1.0,
                   "mapq30_frac": float(hi.mean()), "reads_per_s": LR_READS / dt,
                   "chunks": n_chunks, "split_s": {k: round(v, 4) for k, v in split.items()},
                   "t_post_s": round(res["t_post"], 4)}
            rows.append(row)
            log(f"[genome_lr] {json.dumps(row)}")
    torch.cuda.synchronize()
    launches = kernels.counts()
    peak = torch.cuda.max_memory_allocated()
    log(f"[genome_lr] launches over the four rows {launches}; {n_real} real-CIGAR primaries "
        f"rebuild the genome; peak device memory {peak / 2**30:.3f} GiB, the workspace above "
        f"the resident index + encoder {(peak - index_bytes) / 2**30:.3f} GiB "
        f"({(peak - index_bytes) / 1e9:.3f} GB)")
    bad = [f"{r['read_len']} bp at {r['err']}: top-1 {r['top1']:.4f}, MAPQ >= 30 precision "
           f"{r['mapq30_precision']:.4f}" for r in rows
           if r["top1"] < 0.99 or r["mapq30_precision"] < 0.99]
    if launches["gru_fwd"] <= 0 or launches["int8_winmin"] <= 0:
        bad.append(f"launches {launches}")
    if n_real < 0.99 * len(rows) * LR_READS:
        bad.append(f"only {n_real} real CIGARs")
    if bad:
        raise AssertionError(f"genome_lr: {bad}")
    shutil.rmtree(work, ignore_errors=True)


_HNSW_GROUPS = (  # kernel-name fragment -> part of an HNSW beam search
    ("gru", "gru_fwd"), ("sort", "merge (sort)"), ("index", "gathers"), ("gather", "gathers"),
    ("reduce", "reductions"), ("elementwise", "elementwise"), ("cat", "concat"),
    ("gemm", "matmul"), ("memcpy", "copies"),
)


class _BuildTimings:
    """Hands a timings dict to every build_index call the CLI makes while
    entered: the build split of a build-index command."""

    def __init__(self):
        self.t = {}

    def __enter__(self):
        from deepreadmapper_tpu_torch.pipeline import build

        self.orig = orig = build.build_index

        def timed(*a, **kw):
            return orig(*a, timings=self.t, **kw)

        build.build_index = timed
        return self.t

    def __exit__(self, *exc):
        from deepreadmapper_tpu_torch.pipeline import build

        build.build_index = self.orig


def _hnsw_build(tag: str, argv: list) -> tuple[float, dict]:
    """build-index through the CLI; logs and returns (seconds, split)."""
    import torch

    from deepreadmapper_tpu_torch import cli

    t0 = time.perf_counter()
    with _BuildTimings() as bt:
        if cli.main(["build-index", *argv]) != 0:
            raise AssertionError(f"{tag} build-index failed")
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    split = " | ".join(f"{k} {bt[k]:.2f} s" for k in
                       ("embed", "graph", "levels", "exact_knn", "prune", "reverse_rank",
                        "upper_levels", "pq", "save") if k in bt)
    log(f"[{tag}] build-index {' '.join(argv[3:])}: {t_build:.2f} s; {split}")
    return t_build, bt


def _hnsw_pipeline(tag: str, argv: list) -> float:
    import torch

    from deepreadmapper_tpu_torch import cli

    t0 = time.perf_counter()
    if cli.main(["pipeline", *argv]) != 0:
        raise AssertionError(f"{tag} pipeline failed")
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def _recall(ids: np.ndarray, oracle: np.ndarray) -> float:
    """Mean share of each row of oracle found in the same row of ids."""
    k = oracle.shape[1]
    return float(np.mean([np.intersect1d(a, b).size / k for a, b in zip(ids, oracle)]))


def phase_genome_hnsw():
    """The graph engines at the reference's default index parameters:
    (a) HNSWPQ, insert build, dense, 39,702 windows; (b) the same genome at
    stride 4 with the re-embed + L2 rerank; (c) HNSWFLAT by the kNN builder
    on the card with centroid levels, 199,702 windows.  #1 (gru_fwd) embeds
    the windows and reads of each part and the sparse rerank's windows."""
    import torch

    from deepreadmapper_tpu_torch import default_device, kernels, native
    from deepreadmapper_tpu_torch.index.pq_flat import PQFlatIndex
    from deepreadmapper_tpu_torch.index.registry import load_index
    from deepreadmapper_tpu_torch.io import fasta as fasta_io
    from deepreadmapper_tpu_torch.models.encoder import Vectorizer
    from deepreadmapper_tpu_torch.ops.topk import l2_topk
    from deepreadmapper_tpu_torch.pipeline.build import embed_fasta_windows

    if not native.available():  # the Python insert builder would look like a hang
        raise AssertionError("genome_hnsw: the native library did not build")
    dev = default_device()
    vec = Vectorizer()
    lengths = np.full(N_READS, READ_LEN + 2)

    def steady(tag, engine, mat, q, k):
        """The index resident: embed + search of the reads mat (median of
        3), the search alone, its effort counters and a profile of one
        search of their embeddings q."""
        engine.search(q, k, ef=HNSW_EF)  # warm
        torch.cuda.synchronize()
        reps = []
        for _ in range(3):
            t0 = time.perf_counter()
            qq = vec.vectorize_wrapped_bytes(mat, lengths)
            t1 = time.perf_counter()
            engine.search(qq, k, ef=HNSW_EF)
            torch.cuda.synchronize()
            reps.append((time.perf_counter() - t0, time.perf_counter() - t1))
        t_all, t_search = (float(np.median([r[i] for r in reps])) for i in (0, 1))
        stats = {}
        engine.search(q[:1], k, ef=HNSW_EF, stats=stats)
        log(f"[{tag}] steady embed+search: {N_READS} reads in {t_all:.3f} s "
            f"({N_READS / t_all:.0f} reads/s; median of 3); the search alone {t_search:.3f} s "
            f"({N_READS / t_search:.0f} reads/s) at ef {HNSW_EF}, k {k}; counters {stats}")
        _profile(tag, "search", lambda: engine.search(q, k, ef=HNSW_EF), 1, _HNSW_GROUPS)

    # (a) HNSWPQ, dense: recall@10 against the exact fp32 top-10, overlap@64
    # with the exhaustive scan over the index's own codes and codebook
    work = os.path.join(WORK, "genome_hnsw")
    os.makedirs(work, exist_ok=True)
    ref, fq, starts, strands, mat, _ = simulate(work, HNSW_GENOME_BP, N_READS)
    idx, out = os.path.join(work, "hnswpq"), os.path.join(work, "hnswpq_out")
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counts()
    _hnsw_build("genome_hnsw a", [ref, idx, str(READ_LEN), "--index-type", "HNSWPQ"])
    t_pipe = _hnsw_pipeline("genome_hnsw a", [idx, fq, ref, str(HNSW_EF), "128", "128", out,
                                              "--no-sam"])
    launches = kernels.counts()
    log(f"[genome_hnsw a] pipeline (load, embed, search {N_READS} reads, write): "
        f"{t_pipe:.2f} s; launches {launches}; max_memory_allocated in build + pipeline "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    ids = np.load(os.path.join(out, "indices.npy")).astype(np.int64)
    q = vec.vectorize_wrapped_bytes(mat, lengths)
    windows = embed_fasta_windows(fasta_io.parse_fasta_records(ref), READ_LEN, 1, vec)
    _, oracle = l2_topk(q, windows, 10, device=dev)
    oracle = oracle.cpu().numpy()
    n = HNSW_GATE_READS
    recall, recall_all = _recall(ids[:n, :10], oracle[:n]), _recall(ids[:, :10], oracle)
    recall_a = recall
    engine, _ = load_index(idx)
    adc = PQFlatIndex(engine.codes, engine.codebook, engine.ntotal, device=dev)
    a_ids, _ = adc.search(q, 64, exact=True)
    overlap, ceiling = _recall(ids[:, :64], a_ids), _recall(a_ids[:n, :10], oracle[:n])
    top1 = _top1(ids, starts, strands)
    log(f"[genome_hnsw a] {engine.ntotal} windows: recall@10 against the exact fp32 top-10 "
        f"on the first {n} reads {recall:.4f} (need >= the JAX package's CPU reading "
        f"{JAX_HNSW_RECALL10:.4f} - 0.01 and >= this run's exhaustive scan of its codes on "
        f"those reads {ceiling:.4f} - 0.01), on all {N_READS} {recall_all:.4f}; overlap@64 "
        f"with that scan {overlap:.4f} (need >= 0.90); top-1 (position +-5 bp and strand) "
        f"{top1:.4f}")
    steady("genome_hnsw a", engine, mat, q, 128)
    bad = []
    if recall < max(JAX_HNSW_RECALL10, ceiling) - 0.01 or overlap < 0.90:
        bad.append(f"(a) recall@10 {recall}, overlap@64 {overlap}")
    if launches["gru_fwd"] <= 0:
        bad.append(f"(a) launches {launches}")
    del engine, adc

    # (b) the same genome at stride 4: 5 hits x 7 re-embedded windows, L2 rerank
    idx, out = os.path.join(work, "sparse"), os.path.join(work, "sparse_out")
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counts()
    _hnsw_build("genome_hnsw b", [ref, idx, str(READ_LEN), str(HNSW_SPARSE_STRIDE),
                                  "--index-type", "HNSWPQ"])
    t_pipe = _hnsw_pipeline("genome_hnsw b", [idx, fq, ref, *HNSW_SPARSE_ARGS, out])
    launches = kernels.counts()
    pos, strand = sam_primaries(os.path.join(out, "results.sam"))
    top1_all = float(np.mean((np.abs(pos - starts) <= 5) & (strand == strands)))
    top1 = float(np.mean((np.abs(pos[:n] - starts[:n]) <= 5) & (strand[:n] == strands[:n])))
    log(f"[genome_hnsw b] stride {HNSW_SPARSE_STRIDE}, pipeline {' '.join(HNSW_SPARSE_ARGS)} "
        f"(load, embed, search, rerank, SAM): {t_pipe:.2f} s ({N_READS / t_pipe:.0f} reads/s); "
        f"launches {launches}; max_memory_allocated in build + pipeline "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; top-1 on the first {n} reads "
        f"{top1:.4f} (need >= the JAX package's CPU reading {JAX_HNSW_SPARSE_TOP1:.4f} - 0.01), "
        f"on all {N_READS} {top1_all:.4f}")
    if top1 < JAX_HNSW_SPARSE_TOP1 - 0.01:
        bad.append(f"(b) top-1 {top1}")
    if launches["gru_fwd"] <= 0:
        bad.append(f"(b) launches {launches}")
    shutil.rmtree(work, ignore_errors=True)

    # (c) HNSWFLAT, kNN build on the card, centroid levels
    work = os.path.join(WORK, "genome_hnsw_knn")
    os.makedirs(work, exist_ok=True)
    ref, fq, starts, strands, mat, _ = simulate(work, HNSW_KNN_GENOME_BP, N_READS)
    idx, out = os.path.join(work, "idx"), os.path.join(work, "out")
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counts()
    _hnsw_build("genome_hnsw c", [ref, idx, str(READ_LEN), "--index-type", "HNSWFLAT",
                                  "--build-mode", "knn", "--level-mode", "centroid"])
    t_pipe = _hnsw_pipeline("genome_hnsw c", [idx, fq, ref, str(HNSW_EF), "10", "10", out,
                                              "--no-sam"])
    launches = kernels.counts()
    log(f"[genome_hnsw c] pipeline (load, embed, search {N_READS} reads, write): "
        f"{t_pipe:.2f} s; launches {launches}; max_memory_allocated in build + pipeline "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    engine, _ = load_index(idx)
    q = vec.vectorize_wrapped_bytes(mat, lengths)
    _, oracle = l2_topk(q, engine.vectors, 10, device=dev)
    ids = np.load(os.path.join(out, "indices.npy")).astype(np.int64)
    recall = _recall(ids, oracle.cpu().numpy())
    log(f"[genome_hnsw c] {engine.ntotal} windows, {engine.graph.max_level} upper levels: "
        f"recall@10 against the exact fp32 top-10 {recall:.4f} (need >= 0.99); top-1 "
        f"{_top1(ids, starts, strands):.4f}")
    steady("genome_hnsw c", engine, mat, q, 10)
    if recall < 0.99:
        bad.append(f"(c) recall@10 {recall}")
    if launches["gru_fwd"] <= 0:
        bad.append(f"(c) launches {launches}")
    del engine
    shutil.rmtree(work, ignore_errors=True)
    if bad:
        raise AssertionError(f"genome_hnsw: {bad}")
    return {"recall_a": recall_a}


def _shard_codes(index) -> np.ndarray:
    """The codes of a sharded IVF index back in row order, shard after
    shard, pad rows dropped: what an unsharded build would index."""
    parts = []
    for sub in index.subs:
        rows = np.zeros((sub.ntotal, sub.codes_cm.shape[1]), sub.codes_cm.dtype)
        live = sub.row_ids >= 0
        rows[sub.row_ids[live]] = sub.codes_cm[live]
        parts.append(rows)
    return np.concatenate(parts)[: index.ntotal]


def _same_outputs(tag: str, got: str, want: str) -> None:
    for name in ("indices.npy", "distances.npy", "results.sam"):
        with open(os.path.join(got, name), "rb") as f, open(os.path.join(want, name), "rb") as g:
            if f.read() != g.read():
                raise AssertionError(f"genome_shard {tag}: {name} differs from (a)'s")


def _run_child(tag: str, cmd: list, env=None) -> str:
    """One process phase 13 starts: its output, or raise (it is killed at
    SHARD_TIMEOUT)."""
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=SHARD_TIMEOUT)
    if proc.returncode != 0:
        raise AssertionError(f"genome_shard {tag} failed ({proc.returncode}):\n"
                             f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    log(f"[genome_shard {tag}] {' '.join(cmd[1:6])} ... {cmd[-1]}: "
        f"{time.perf_counter() - t0:.2f} s")
    return proc.stdout + proc.stderr


_RANK_CHILD = """
import sys
root, port, rank, ref, fq, prefix, out, n_shards, k = sys.argv[1:10]
sys.path.insert(0, root)
import torch
from deepreadmapper_tpu_torch.parallel import distributed as dist
dev = dist.init_distributed("gloo", device="cuda:0", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=2, rank=int(rank))
import torch.distributed
print(f"[rank {rank}] backend {torch.distributed.get_backend()} device {dev}", flush=True)
from deepreadmapper_tpu_torch.pipeline.build import build_index_distributed
from deepreadmapper_tpu_torch.pipeline.search import run_pipeline
build_index_distributed(ref, prefix, 150, n_shards=int(n_shards), device=dev)
run_pipeline(prefix, fq, ref, ef=128, k=int(k), k_clusters=5, output_dir=out + rank,
             device=dev)
print(f"RANK{rank}-OK", flush=True)
"""


def phase_genome_shard(genome: dict, hnsw: dict):
    """The sharded index on the one card (module docstring, phase 13).  #1
    embeds in every part; #2 runs on each INT8FLAT shard, #4 and #3 on the
    PQFLAT shards and their rerank, #5-#8 on the IVF shards."""
    import socket

    import torch

    from deepreadmapper_tpu_torch import cli, default_device, kernels
    from deepreadmapper_tpu_torch.config import BuildConfig
    from deepreadmapper_tpu_torch.index.flat import FlatIndex
    from deepreadmapper_tpu_torch.index.ivf_int8 import IVFInt8Index
    from deepreadmapper_tpu_torch.index.ivf_pq import IVFPQIndex
    from deepreadmapper_tpu_torch.index.pq_flat import PQFlatIndex
    from deepreadmapper_tpu_torch.index.registry import load_index
    from deepreadmapper_tpu_torch.io import fasta as fasta_io
    from deepreadmapper_tpu_torch.io.configstore import load_config, save_config
    from deepreadmapper_tpu_torch.models.encoder import Vectorizer
    from deepreadmapper_tpu_torch.ops.topk import l2_topk
    from deepreadmapper_tpu_torch.parallel.mesh import make_mesh
    from deepreadmapper_tpu_torch.parallel.sharded_ann import ShardedANNIndex
    from deepreadmapper_tpu_torch.parallel.sharded_search import sharded_l2_topk
    from deepreadmapper_tpu_torch.pipeline.build import INT8_SCALE, embed_fasta_windows

    work = os.path.join(WORK, "genome_shard")
    os.makedirs(work, exist_ok=True)
    ref, fq, starts, strands = genome["ref"], genome["fq"], genome["starts"], genome["strands"]
    dev = default_device()
    vec = Vectorizer()
    lengths = np.full(N_READS, READ_LEN + 2)
    q = vec.vectorize_wrapped_bytes(genome["wrapped"], lengths)
    bad = []

    def build(tag, argv):
        t0 = time.perf_counter()
        with _BuildTimings() as bt:
            if cli.main(["build-index", *argv]) != 0:
                raise AssertionError(f"genome_shard {tag} build-index failed")
        torch.cuda.synchronize()
        _build_split(f"genome_shard {tag}", load_config(os.path.join(argv[1], "config.txt")),
                     time.perf_counter() - t0, bt)

    def pipeline(tag, argv, need):
        """pipeline through the CLI, the launch counts of this run alone;
        each kernel in need must have launched."""
        kernels.reset_counts()
        t0 = time.perf_counter()
        if cli.main(["pipeline", *argv]) != 0:
            raise AssertionError(f"genome_shard {tag} pipeline failed")
        torch.cuda.synchronize()
        c = kernels.counts()
        log(f"[genome_shard {tag}] pipeline {' '.join(argv[3:])}: "
            f"{time.perf_counter() - t0:.2f} s; launches {c}")
        if any(c[n] <= 0 for n in need):
            bad.append(f"{tag}: launches {c}, need {need}")
        return c

    def steady(fn) -> float:
        fn()  # warm
        torch.cuda.synchronize()
        reps = []
        for _ in range(3):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            reps.append(time.perf_counter() - t0)
        return float(np.median(reps))

    # (a) INT8FLAT, 4 shards on the card, through the CLI
    idx, out_a = os.path.join(work, "idx"), os.path.join(work, "out_a")
    build("a INT8FLAT", [ref, idx, str(READ_LEN), "--shards", str(SHARD_N)])
    c = pipeline("a INT8FLAT", [idx, fq, ref, "128", str(SAM_K), "5", out_a],
                 ("gru_fwd", "int8_winmin"))
    if c["int8_winmin"] < SHARD_N:
        bad.append(f"(a) int8_winmin launched {c['int8_winmin']} times for {SHARD_N} shards")
    top1 = _top1(np.load(os.path.join(out_a, "indices.npy")), starts, strands)
    log(f"[genome_shard a] INT8FLAT {SHARD_N} shards: top-1 {top1:.4f} (need >= phase 5's "
        f"{genome['top1']:.4f} - 0.01)")
    if top1 < genome["top1"] - 0.01:
        bad.append(f"(a) INT8FLAT top-1 {top1}")
    sharded, _ = load_index(idx)
    one, _ = load_index(genome["idx"])
    torch.cuda.synchronize()
    m0 = torch.cuda.memory_allocated()
    t_sh = steady(lambda: sharded.search(q, 128))
    resident = torch.cuda.memory_allocated() - m0
    torch.cuda.reset_peak_memory_stats()
    sharded.search(q, 128)
    torch.cuda.synchronize()
    work_peak = torch.cuda.max_memory_allocated() - torch.cuda.memory_allocated()
    t_one = steady(lambda: one.search(q, 128))
    log(f"[genome_shard a] steady search of {N_READS} reads (k 128, median of 3): "
        f"{SHARD_N} shards {t_sh:.4f} s against the unsharded index's {t_one:.4f} s; "
        f"resident {resident / SHARD_N / 1e9:.3f} GB a shard, search workspace above the "
        f"resident shards {work_peak / 1e9:.3f} GB (one shard at a time)")
    _profile("genome_shard a", "search", lambda: sharded.search(q, 128), 1, _SEARCH_GROUPS)
    del sharded, one

    # FLAT over the same embeddings: the sharded engine and sharded_l2_topk
    # against the unsharded exact search
    emb = embed_fasta_windows(fasta_io.parse_fasta_records(ref), READ_LEN, 1, vec)
    qf = q[:SHARD_FLAT_READS]
    flat = FlatIndex(emb, dev)
    i1, d1 = flat.search(qf, 16)
    fsh = ShardedANNIndex.build(emb, make_mesh(n_shard=SHARD_N, devices=[dev]),
                                index_type="FLAT")
    i2, d2 = fsh.search(qf, 16)
    n_div = emb.shape[0] - emb.shape[0] % SHARD_N
    refs = flat._dev[:n_div]
    d3, i3 = sharded_l2_topk(qf, refs, 16, make_mesh(n_shard=SHARD_N, devices=[dev]))
    d4, i4 = l2_topk(qf, refs, 16, device=dev)
    same = (np.array_equal(i2, i1) and np.array_equal(i3.numpy(), i4.cpu().numpy()))
    dmax = max(float(np.max(np.abs(d2 - d1) / np.maximum(1.0, np.abs(d1)))),
               float(torch.max(torch.abs(d3 - d4.cpu()) / torch.clamp(d4.cpu().abs(), min=1))))
    log(f"[genome_shard a] FLAT {SHARD_N} shards, {SHARD_FLAT_READS} reads, k 16: ids equal "
        f"the unsharded search's {same} (ShardedANNIndex and sharded_l2_topk), distances "
        f"within {dmax:.2e} relative (need <= 1e-4)")
    if not same or dmax > 1e-4:
        bad.append(f"(a) FLAT ids equal {same}, distances {dmax}")
    del flat, fsh, refs, emb

    # PQFLAT, 2 shards (one codebook), then the SW rerank; against the
    # unsharded engine over the same codes
    pq, pq1 = os.path.join(work, "pq"), os.path.join(work, "pq1")
    build("a PQFLAT", [ref, pq, str(READ_LEN), "--index-type", "PQFLAT",
                       "--shards", str(SHARD_N_OTHER)])
    pipe = ["128", "10", "128"]
    pipeline("a PQFLAT", [pq, fq, ref, *pipe, os.path.join(work, "pq_out"), "--rerank", "sw"],
             ("gru_fwd", "pq_winmin", "sw_score_by_id"))
    shpq, cfg = load_index(pq)
    s0 = shpq.subs[0]
    codes = np.concatenate([s.codes for s in shpq.subs])[: shpq.ntotal]
    PQFlatIndex(codes, s0.codebook, shpq.ntotal, s0.rot, dev).save(pq1)
    save_config(cfg, pq1)
    pipeline("a PQFLAT unsharded", [pq1, fq, ref, *pipe, os.path.join(work, "pq1_out"),
                                    "--rerank", "sw"], ("pq_winmin", "sw_score_by_id"))
    sw_sh = sw_top1(os.path.join(work, "pq_out", "results.sam"), starts, strands)
    sw_one = sw_top1(os.path.join(work, "pq1_out", "results.sam"), starts, strands)
    log(f"[genome_shard a] PQFLAT {SHARD_N_OTHER} shards -> --rerank sw: SW top-1 {sw_sh:.4f} "
        f"(need >= the unsharded engine's {sw_one:.4f} - 0.01)")
    if sw_sh < sw_one - 0.01:
        bad.append(f"(a) PQFLAT SW top-1 {sw_sh} against {sw_one}")
    del shpq

    # IVFINT8 and IVFPQ, 2 shards at nprobe 32: 8192 reads (fold) through
    # the CLI, 2048 in process (packed); against the unsharded engines
    for kind, fold_k, packed_k in (("IVFINT8", "ivf_chunk_int8_fold", "ivf_chunk_int8"),
                                   ("IVFPQ", "ivf_chunk_pq_fold", "ivf_chunk_pq")):
        tag = f"a {kind}"
        pk, out_k = os.path.join(work, kind.lower()), os.path.join(work, kind.lower() + "_out")
        build(tag, [ref, pk, str(READ_LEN), "--index-type", kind, "--shards", str(SHARD_N_OTHER)])
        pipeline(tag, [pk, fq, ref, str(IVF_NPROBE), "10", "10", out_k, "--no-sam"],
                 ("gru_fwd", fold_k))
        top_sh = _top1(np.load(os.path.join(out_k, "indices.npy")), starts, strands)
        shx, _ = load_index(pk)
        kernels.reset_counts()
        ids_p, _ = shx.search(q[:SHARD_PACKED_READS], 10, ef=IVF_NPROBE)
        torch.cuda.synchronize()
        c = kernels.counts()
        if c[packed_k] <= 0:
            bad.append(f"{tag} packed route: launches {c}")
        s0 = shx.subs[0]
        t0 = time.perf_counter()
        if kind == "IVFINT8":
            base = IVFInt8Index.build_from_codes(_shard_codes(shx), INT8_SCALE, BuildConfig(),
                                                 device=dev)
        else:
            base = IVFPQIndex.build_from_codes(_shard_codes(shx), s0.codebook, BuildConfig(),
                                               rot=s0.rot, device=dev)
        t_base = time.perf_counter() - t0
        ids1, _ = base.search(q, 10, ef=IVF_NPROBE)
        ids1_p, _ = base.search(q[:SHARD_PACKED_READS], 10, ef=IVF_NPROBE)
        top_one = _top1(ids1, starts, strands)
        n_p = SHARD_PACKED_READS
        log(f"[genome_shard {tag}] {SHARD_N_OTHER} shards ({[s.nlist for s in shx.subs]} "
            f"clusters) at nprobe {IVF_NPROBE}: top-1 {top_sh:.4f} on {N_READS} reads (fold; "
            f"need >= the unsharded engine's {top_one:.4f} - 0.02; its build from the same "
            f"codes {t_base:.2f} s, {base.nlist} clusters); {n_p} reads (packed, launches {c}) "
            f"{_top1(ids_p, starts[:n_p], strands[:n_p]):.4f} against "
            f"{_top1(ids1_p, starts[:n_p], strands[:n_p]):.4f}")
        if top_sh < top_one - 0.02:
            bad.append(f"{tag} top-1 {top_sh} against {top_one}")
        del shx, base

    # HNSWPQ, 2 shards, at phase 12 (a)'s size and parameters
    hw = os.path.join(work, "hnsw")
    os.makedirs(hw, exist_ok=True)
    href, hfq, _hs, _hd, hmat, _ = simulate(hw, HNSW_GENOME_BP, N_READS)
    hidx, hout = os.path.join(hw, "idx"), os.path.join(hw, "out")
    build("a HNSWPQ", [href, hidx, str(READ_LEN), "--index-type", "HNSWPQ",
                       "--shards", str(SHARD_N_OTHER)])
    pipeline("a HNSWPQ", [hidx, hfq, href, str(HNSW_EF), "128", "128", hout, "--no-sam"],
             ("gru_fwd",))
    hq = vec.vectorize_wrapped_bytes(hmat, lengths)
    windows = embed_fasta_windows(fasta_io.parse_fasta_records(href), READ_LEN, 1, vec)
    _, oracle = l2_topk(hq, windows, 10, device=dev)
    n = HNSW_GATE_READS
    recall = _recall(np.load(os.path.join(hout, "indices.npy"))[:n, :10].astype(np.int64),
                     oracle.cpu().numpy()[:n])
    log(f"[genome_shard a] HNSWPQ {SHARD_N_OTHER} shards: recall@10 on the first {n} reads "
        f"{recall:.4f} (need >= phase 12 (a)'s unsharded {hnsw['recall_a']:.4f} - 0.02)")
    if recall < hnsw["recall_a"] - 0.02:
        bad.append(f"(a) HNSWPQ recall@10 {recall}")

    # (b) the CLI under torchrun, a 1-rank NCCL group: the same index path,
    # so the SAM's @PG line matches (a)'s
    run = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "1", "-m", "deepreadmapper_tpu_torch.cli"]
    shutil.rmtree(idx)
    out_b = os.path.join(work, "out_b")
    said = _run_child("b torchrun", run + ["build-index", ref, idx, str(READ_LEN),
                                           "--distributed", "--shards", str(SHARD_N)])
    said += _run_child("b torchrun", run + ["pipeline", idx, fq, ref, "128", str(SAM_K), "5",
                                            out_b, "--distributed"])
    backends = sorted({ln for ln in said.splitlines() if "[DIST]" in ln})
    log(f"[genome_shard b] {backends}")
    _same_outputs("(b) torchrun", out_b, out_a)
    log("[genome_shard b] indices.npy, distances.npy, results.sam equal (a)'s byte for byte")

    # (c) two ranks on the one card through the API, gloo collectives
    shutil.rmtree(idx)
    out_c = os.path.join(work, "out_c")
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = str(sock.getsockname()[1])
    sock.close()
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-c", _RANK_CHILD, ROOT, port, str(r), ref, fq,
                               idx, out_c, str(SHARD_N), str(SAM_K)], cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    try:
        for r, proc in enumerate(procs):
            text, _ = proc.communicate(timeout=SHARD_TIMEOUT)
            if proc.returncode != 0 or f"RANK{r}-OK" not in text:
                raise AssertionError(f"genome_shard (c) rank {r} failed:\n{text[-3000:]}")
            log(f"[genome_shard c] {[ln for ln in text.splitlines() if '[rank' in ln]}")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    log(f"[genome_shard c] two ranks on {torch.cuda.get_device_name(0)}: build + pipeline "
        f"{time.perf_counter() - t0:.2f} s")
    _same_outputs("(c) two ranks", out_c + "0", out_a)
    if os.listdir(out_c + "1"):
        bad.append(f"(c) rank 1 wrote {os.listdir(out_c + '1')}")
    log("[genome_shard c] rank 0's outputs equal (a)'s byte for byte; rank 1 wrote no file")
    shutil.rmtree(work, ignore_errors=True)
    if bad:
        raise AssertionError(f"genome_shard: {bad}")


# -- phase 14: data-parallel fine-tuning ---------------------------------------

_DP_CHILD = """
import json, os, sys, time
root, port, rank, ref, work, steps, batch = sys.argv[1:8]
sys.path.insert(0, root)
import numpy as np
import torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
from deepreadmapper_tpu_torch import kernels
from deepreadmapper_tpu_torch.models import encoder as enc
from deepreadmapper_tpu_torch.parallel import distributed as dist
from deepreadmapper_tpu_torch.parallel import train
from deepreadmapper_tpu_torch.pipeline import finetune as ft
dev = dist.init_distributed("gloo", device="cuda:0", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=2, rank=int(rank))
stamps, comm, saves = [], {"all_reduce": [], "all_gather": []}, []
sample, save = ft.sample_pairs, ft.save_train_state

def counted_save(*a, **kw):
    saves.append(a[0])
    return save(*a, **kw)

def stamped(*a, **kw):
    stamps.append(time.perf_counter())
    return sample(*a, **kw)

def timed(key, fn):
    def run(*a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        comm[key].append(time.perf_counter() - t)
        return out
    return run

ft.sample_pairs = stamped
ft.save_train_state = counted_save
dist.all_reduce_sum_ = timed("all_reduce", dist.all_reduce_sum_)
dist.all_gather_cat = timed("all_gather", dist.all_gather_cat)
kernels.reset_counts()
t0 = time.perf_counter()
params, losses = ft.finetune(ref, 150, steps=int(steps), batch=int(batch), seed=0,
                             device=dev, state_path=os.path.join(work, "state", "st.npz"))
torch.cuda.synchronize()
wall = time.perf_counter() - t0
counts = kernels.counts()
np.savez(os.path.join(work, "res", f"rank{rank}.npz"), np.asarray(losses),
         *train.leaves(params))
n = len(stamps)
steady = (stamps[-1] - stamps[2]) / (n - 3)
said = {"rank": int(rank), "device": str(dev), "counts": counts, "wall": wall,
        "setup": stamps[0] - t0, "steady": steady, "saves": len(saves),
        "all_reduce": sum(comm["all_reduce"][2:n - 1]) / (n - 3),
        "all_gather": sum(comm["all_gather"][4:2 * n - 2]) / (n - 3)}
# one step's gradient from the shipped weights on finetune's first batch,
# summed over the ranks
rt, wt = sample(ft.fasta_io.extract_fasta_sequence(ref), 150, int(batch),
                np.random.default_rng(0))
per = int(batch) // 2
rows = slice(int(rank) * per, (int(rank) + 1) * per)
p0 = enc.torch_params(enc.load_params(), dev, requires_grad=True)
loss = train.loss_fn(p0, torch.from_numpy(rt[rows]).to(dev), torch.from_numpy(wt[rows]).to(dev))
loss.backward()
grads = [q.grad for q in train.leaves(p0)]
dist.all_reduce_sum_(grads)
np.savez(os.path.join(work, "res", f"grad{rank}.npz"), np.asarray(loss.item()),
         *[g.cpu().numpy() for g in grads])
print("DPRESULT " + json.dumps(said), flush=True)
print(f"RANK{rank}-OK", flush=True)
"""


def _hold_c7(tag: str, got, want, init, grads, steps: int, lr: float) -> str:
    """Rule C7 (ROADMAP Queue C) on each weight's update after `steps` Adam
    steps from `init`: within 5e-6, or within steps x 2 x lr where the first
    gradient is non-zero but within 1e-4 of its tensor's largest; at most 1%
    of the weights may take that allowance (at B = 512 on the shipped
    weights 1.15% are eligible for it).  Raises; returns the readings."""
    worst, worst_near, n_near, n_loose, n_all = 0.0, 0.0, 0, 0, 0
    for g, w, i, gr in zip(got, want, init, grads):
        ag = np.abs(gr)
        near = (ag > 0) & (ag <= 1e-4 * ag.max())
        diff = np.abs((g - i) - (w - i))
        worst = max(worst, float(diff[~near].max()))
        if near.any():
            worst_near = max(worst_near, float(diff[near].max()))
        n_near, n_all = n_near + int(near.sum()), n_all + near.size
        n_loose += int((diff[near] > 5e-6).sum())
    said = (f"updates within {worst:.3e} (need <= 5e-6); weights eligible for the "
            f"near-zero-gradient allowance {n_near}/{n_all} ({n_near / n_all:.2%}), within "
            f"{worst_near:.3e} (need <= {steps * 2 * lr:.0e}); weights taking it (beyond "
            f"5e-6) {n_loose} ({n_loose / n_all:.2%}, need <= 1%)")
    if worst > 5e-6 or worst_near > steps * 2 * lr or n_loose > 0.01 * n_all:
        raise AssertionError(f"finetune_dp {tag}: {said}")
    return said


def phase_finetune_dp(results: dict, genome: dict, smi: str):
    """Data-parallel fine-tuning on the one card (module docstring, phase
    14): #1 and #9 on every rank."""
    import socket

    import torch

    from deepreadmapper_tpu_torch import kernels
    from deepreadmapper_tpu_torch.io import fasta as fasta_io
    from deepreadmapper_tpu_torch.models import encoder as enc
    from deepreadmapper_tpu_torch.parallel import train
    from deepreadmapper_tpu_torch.pipeline import finetune as ft
    from deepreadmapper_tpu_torch.utils.trace import device_trace, global_tracer, stage

    ref = genome["ref"]
    work = os.path.join(WORK, "finetune_dp")
    for sub in ("state", "res", "trace", "b"):
        os.makedirs(os.path.join(work, sub), exist_ok=True)
    lr, per = 1e-4, TRAIN_B // DP_RANKS

    # (a) two gloo ranks on cuda:0, then one process with the same steps
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = str(sock.getsockname()[1])
    sock.close()
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-c", _DP_CHILD, ROOT, port, str(r), ref, work,
                               str(DP_STEPS), str(TRAIN_B)], cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(DP_RANKS)]
    said = []
    try:
        for r, proc in enumerate(procs):
            text, _ = proc.communicate(timeout=SHARD_TIMEOUT)
            if proc.returncode != 0 or f"RANK{r}-OK" not in text:
                raise AssertionError(f"finetune_dp (a) rank {r} failed:\n{text[-3000:]}")
            said.append(json.loads(next(ln for ln in text.splitlines()
                                        if ln.startswith("DPRESULT "))[len("DPRESULT "):]))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    t_ranks = time.perf_counter() - t0
    seq = fasta_io.extract_fasta_sequence(ref)
    t = time.perf_counter()
    ft.sample_pairs(seq, READ_LEN, TRAIN_B, np.random.default_rng(1))
    t_sample = time.perf_counter() - t
    for d in said:
        log(f"[finetune_dp a] rank {d['rank']} on {d['device']} ({smi}): {DP_STEPS} steps of "
            f"{per} rows of the global {TRAIN_B} in {d['wall']:.2f} s, set-up to the first step "
            f"{d['setup']:.2f} s, steady {d['steady'] * 1e3:.2f} ms/step (host clock between "
            f"step starts, steps 3-{DP_STEPS}): all_reduce of the gradients "
            f"{d['all_reduce'] * 1e3:.2f} ms ({d['all_reduce'] / d['steady']:.1%}), the two "
            f"embedding all_gathers {d['all_gather'] * 1e3:.2f} ms "
            f"({d['all_gather'] / d['steady']:.1%}) a step (each synchronised on both sides); "
            f"host sampling of the whole global batch {t_sample * 1e3:.2f} ms (one draw in "
            f"this process); launches {d['counts']}")
    log(f"[finetune_dp a] two ranks in {t_ranks:.2f} s, processes included ({smi})")
    for d in said:
        c = d["counts"]
        if c["gru_fwd"] != 12 * DP_STEPS or c["gru_bwd"] != 8 * DP_STEPS:
            raise AssertionError(f"finetune_dp (a) rank {d['rank']} launches {c} (want "
                                 "gru_fwd 12 and gru_bwd 8 a step)")
    def arrays(name):
        out = []
        for r in range(DP_RANKS):
            with np.load(os.path.join(work, "res", f"{name}{r}.npz")) as z:
                out.append([z[f"arr_{i}"] for i in range(len(z.files))])
        return out

    ranks, rgrads = arrays("rank"), arrays("grad")
    for a, b in [*zip(*ranks), *zip(*rgrads)]:
        if a.dtype != b.dtype or a.tobytes() != b.tobytes():
            raise AssertionError("finetune_dp (a): the ranks' weights, losses or summed "
                                 "gradients differ")
    if [d["saves"] for d in said] != [1, 0] or \
            os.listdir(os.path.join(work, "state")) != ["st.npz"]:
        raise AssertionError(f"finetune_dp (a): state saves {[d['saves'] for d in said]} "
                             f"(want [1, 0]), state dir {os.listdir(os.path.join(work, 'state'))}")
    log("[finetune_dp a] the two ranks' losses, weights and summed gradients are equal byte "
        "for byte; rank 0 saved the --state file once, rank 1 never")

    # (c) the one-process run of the same steps, traced
    tracer = global_tracer()
    kernels.reset_counts()
    with stage("finetune_dp one process"), device_trace(os.path.join(work, "trace")) as tpath:
        one, losses = ft.finetune(ref, READ_LEN, steps=DP_STEPS, batch=TRAIN_B, seed=0,
                                  lr=lr, device="cuda")
        torch.cuda.synchronize()
    c_one = kernels.counts()
    rt, wt = ft.sample_pairs(seq, READ_LEN, TRAIN_B, np.random.default_rng(0))
    params = enc.torch_params(enc.load_params(), "cuda", requires_grad=True)
    loss0 = train.loss_fn(params, torch.from_numpy(rt).cuda(), torch.from_numpy(wt).cuda())
    loss0.backward()
    grads = [p.grad.cpu().numpy() for p in train.leaves(params)]
    init = train.leaves(enc.load_params())
    # one step: the ranks' all-reduced gradient against the one-process one
    # (a gradient scaled by the world size misses by the whole largest value)
    g_rel = max(float(np.abs(a - b).max() / np.abs(b).max())
                for a, b in zip(rgrads[0][1:], grads))
    l_rel = abs(float(rgrads[0][0]) - loss0.item()) / abs(loss0.item())
    log(f"[finetune_dp a] one step's gradient summed over the two ranks against one "
        f"process on the card: within {g_rel:.2e} of each tensor's largest value (need <= "
        f"1e-4), loss within rtol {l_rel:.2e} (need <= 1e-5)")
    if g_rel > 1e-4 or l_rel > 1e-5:
        raise AssertionError(f"finetune_dp (a): summed gradients {g_rel:.3e}, loss {l_rel:.3e}")
    rel = float(np.max(np.abs(ranks[0][0] - np.asarray(losses)) / np.abs(losses)))
    log(f"[finetune_dp a] one process, {DP_STEPS} steps of {TRAIN_B} on the card: losses "
        f"{losses[0]:.5f} -> {losses[-1]:.5f}; the two ranks' global losses within rtol "
        f"{rel:.2e} (need <= 1e-4); launches {c_one}")
    if rel > 1e-4:
        raise AssertionError(f"finetune_dp (a): losses {ranks[0][0].tolist()} against {losses}")
    log(f"[finetune_dp a] two ranks against one process: "
        f"{_hold_c7('(a)', ranks[0][1:], train.leaves(one), init, grads, DP_STEPS, lr)}")
    trace = json.load(open(tpath))
    kern = [e["name"] for e in trace["traceEvents"] if e.get("cat") == "kernel"]
    found = {k: sum(k in name for name in kern) for k in ("gru_fwd", "gru_bwd")}
    log(f"[finetune_dp c] stage + device_trace: {tracer.spans[-1].name!r} {tracer.spans[-1].seconds:.2f} "
        f"s (profiler on; {smi}), {len(kern)} kernel events in "
        f"{os.path.getsize(tpath) / 1e6:.1f} MB, by name {found}")
    if not all(found.values()):
        raise AssertionError(f"finetune_dp (c): the trace names no "
                             f"{[k for k, v in found.items() if not v]}")

    # (b) the CLI under torchrun (a 1-rank NCCL group) beside the same command
    # without --distributed, both at once
    argv = ["finetune", ref, str(READ_LEN), "--steps", str(DP_STEPS), "--batch",
            str(TRAIN_B), "--seed", "0"]
    cmds = {
        "torchrun": [sys.executable, "-m", "torch.distributed.run", "--standalone",
                     "--nproc-per-node", "1", "-m", "deepreadmapper_tpu_torch.cli", *argv,
                     "--distributed"],
        "plain": [sys.executable, "-m", "deepreadmapper_tpu_torch.cli", *argv],
    }
    t0 = time.perf_counter()
    procs = {tag: subprocess.Popen(
        cmd + ["-o", os.path.join(work, "b", f"{tag}.npz"), "--state",
               os.path.join(work, "b", f"{tag}_state.npz")],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for tag, cmd in cmds.items()}
    try:
        for tag, proc in procs.items():
            text, _ = proc.communicate(timeout=SHARD_TIMEOUT)
            if proc.returncode != 0 or "[FINETUNE] 10 steps" not in text:
                raise AssertionError(f"finetune_dp (b) {tag} failed:\n{text[-3000:]}")
            log(f"[finetune_dp b] {tag}: "
                f"{[ln for ln in text.splitlines() if '[DIST]' in ln or '[FINETUNE]' in ln]}")
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    log(f"[finetune_dp b] both commands at once in {time.perf_counter() - t0:.2f} s ({smi})")
    got = {}
    for tag in cmds:
        with np.load(os.path.join(work, "b", f"{tag}_state.npz")) as z:
            named = {k: z[k] for k in z.files}
        state = train.leaves(enc.params_from_named(named))
        saved = train.leaves(enc.load_params(os.path.join(work, "b", f"{tag}.npz")))
        for a, b in zip(saved, state):
            if not np.array_equal(a, b.astype(np.float16).astype(np.float32)):
                raise AssertionError(f"finetune_dp (b) {tag}: the npz is not its state in fp16")
        got[tag] = state
    log(f"[finetune_dp b] torchrun --distributed against the plain CLI, fp32 weights of the "
        f"state files: {_hold_c7('(b)', got['torchrun'], got['plain'], init, grads, DP_STEPS, lr)}"
        "; each npz is its state's weights in fp16")
    for name in results:
        results[name]["launches_finetune_dp"] = said[0]["counts"][name]
    shutil.rmtree(work, ignore_errors=True)


def phase_graft_entry():
    """__graft_entry__.py's twin on the card: entry()'s forward against the same
    forward on the CPU (rule C2), and dryrun_multichip(4) with its four
    shards on the one card (and at the card count when that is another
    count above 1), each with its launches."""
    import torch

    from deepreadmapper_tpu_torch import graft_entry, kernels

    fwd, (tokens,) = graft_entry.entry()
    kernels.reset_counts()
    t0 = time.perf_counter()
    got = fwd(tokens)
    torch.cuda.synchronize()
    t_fwd = time.perf_counter() - t0
    launches = kernels.counts()
    cfwd, (ctokens,) = graft_entry.entry(device="cpu")
    want = cfwd(ctokens)
    err = float((got.cpu() - want).abs().max())
    log(f"[graft_entry] entry(): {tuple(got.shape)} {got.dtype} on {got.device} in "
        f"{t_fwd * 1e3:.1f} ms (first call); max abs diff from entry(device='cpu') "
        f"{err:.2e} (rtol 1e-4, atol 1e-4); launches {launches}")
    if (tuple(got.shape) != (256, 128) or not bool(torch.isfinite(got).all())
            or launches["gru_fwd"] < 1):
        raise AssertionError(f"entry() forward: {tuple(got.shape)}, launches {launches}")
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    counts = [4] + [n for n in (torch.cuda.device_count(),) if n > 1 and n != 4]
    for n in counts:
        kernels.reset_counts()
        t0 = time.perf_counter()
        readings = graft_entry.dryrun_multichip(n)
        torch.cuda.synchronize()
        launches = kernels.counts()
        log(f"[graft_entry] dryrun_multichip({n}) in {time.perf_counter() - t0:.1f} s: "
            f"{json.dumps(readings)}; launches {launches}")
        if min(launches["gru_fwd"], launches["gru_bwd"]) < 1:
            raise AssertionError(f"dryrun_multichip({n}) missed a kernel: {launches}")


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
    check_ivf(results)
    check_gru_bwd(results)
    log(f"[time] phases 1-3 in {time.perf_counter() - t0:.1f} s")
    phase_fixture()
    genome = phase_genome(results)
    log(f"[time] phases 1-5 in {time.perf_counter() - t0:.1f} s")
    pqflat = phase_genome_pq(results)
    log(f"[time] phases 1-6 in {time.perf_counter() - t0:.1f} s")
    phase_genome_ivf(results)
    log(f"[time] phases 1-7 in {time.perf_counter() - t0:.1f} s")
    phase_genome_ivfpq(results, pqflat)
    log(f"[time] phases 1-8 in {time.perf_counter() - t0:.1f} s")
    phase_finetune(results, genome)
    log(f"[time] phases 1-9 in {time.perf_counter() - t0:.1f} s")
    t10 = time.perf_counter()
    phase_genome_sam(genome)
    log(f"[time] phase 10 (genome_sam) in {time.perf_counter() - t10:.1f} s; phases 1-10 in "
        f"{time.perf_counter() - t0:.1f} s")
    t11 = time.perf_counter()
    phase_genome_pe()
    t_pe = time.perf_counter() - t11
    phase_genome_lr(genome)
    log(f"[time] phase 11 (genome_pe {t_pe:.1f} s, genome_lr "
        f"{time.perf_counter() - t11 - t_pe:.1f} s) in {time.perf_counter() - t11:.1f} s; "
        f"phases 1-11 in {time.perf_counter() - t0:.1f} s")
    t12 = time.perf_counter()
    hnsw = phase_genome_hnsw()
    log(f"[time] phase 12 (genome_hnsw) in {time.perf_counter() - t12:.1f} s; phases 1-12 in "
        f"{time.perf_counter() - t0:.1f} s")
    t13 = time.perf_counter()
    phase_genome_shard(genome, hnsw)
    log(f"[time] phase 13 (genome_shard) in {time.perf_counter() - t13:.1f} s; phases 1-13 in "
        f"{time.perf_counter() - t0:.1f} s")
    t14 = time.perf_counter()
    phase_finetune_dp(results, genome, smi)
    log(f"[time] phase 14 (finetune_dp) in {time.perf_counter() - t14:.1f} s; phases 1-14 in "
        f"{time.perf_counter() - t0:.1f} s")
    t15 = time.perf_counter()
    phase_graft_entry()
    log(f"[time] phase 15 (graft_entry) in {time.perf_counter() - t15:.1f} s; phases 1-15 in "
        f"{time.perf_counter() - t0:.1f} s")
    shutil.rmtree(WORK, ignore_errors=True)
    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")
    jax_pkg = sorted(m for m in sys.modules
                     if m == "deepreadmapper_tpu" or m.startswith("deepreadmapper_tpu."))
    if jax_pkg:
        raise AssertionError(f"the port imported the JAX package: {jax_pkg}")
    log(f"[done] all phases in {time.perf_counter() - t0:.1f} s; neither jax nor the JAX "
        "package was imported")

    from deepreadmapper_tpu_torch import kernels

    replaces = {
        "gru_fwd": "deepreadmapper_tpu/models/gru_pallas.py:82",
        "int8_winmin": "deepreadmapper_tpu/ops/scan_kernel.py:112",
        "sw_score": "deepreadmapper_tpu/ops/sw_pallas.py:38",
        "pq_winmin": "deepreadmapper_tpu/ops/scan_kernel.py:143",
        "ivf_chunk_int8": "deepreadmapper_tpu/ops/ivf_kernel.py:245",
        "ivf_chunk_int8_fold": "deepreadmapper_tpu/ops/ivf_kernel.py:445",
        "ivf_chunk_pq": "deepreadmapper_tpu/ops/ivf_kernel.py:562",
        "ivf_chunk_pq_fold": "deepreadmapper_tpu/ops/ivf_kernel.py:669",
        "gru_bwd": "deepreadmapper_tpu/models/gru_pallas.py:188",
    }
    keys = ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "launches_finetune_dp")
    source = {k.name: k.source for k in kernels.ALL}  # sw_score_by_id: #3's row
    rows = [
        {"name": name, "route": "cuda",
         "source": os.path.relpath(source[name], ROOT),
         "replaces": tpu, **{key: results[name][key] for key in keys},
         **results[name].get("extra", {})}
        for name, tpu in replaces.items()
    ]
    print(json.dumps({"kernels": rows}))
    print(smi)
    import torch

    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
