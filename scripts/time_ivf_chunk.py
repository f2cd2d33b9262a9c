"""Time the four IVF chunk scans (csrc/ivf_chunk.cu) and their fold pass on the card.

Imports chip_smoke.py from a checkout (this one unless --root names
another) and makes phase 3's IVF inputs with it: the chunked layout of
>= 2^21 rows (every second slab tie-heavy) and the plan of 8192 queries x
nprobe 32 with its padding steps cut, as the engine launches it.  Checks
each kernel against its plain version once (packed states of every
referenced visit, fold rows [0, nq), bit for bit), and prints CUDA-event
milliseconds per launch (each rep the mean of 3 launches after a warm-up),
the bound (each distinct chunk of the plan read once), the ptxas register
lines of the build and the card's name and power limit.  ``ivf_fold`` is
the fold pass of the two fold scans alone over the PQ scan's packed
states, held to the plain fold scan: the kernel alone (its index sorted
once beforehand), and ``ivf_fold+index`` the same with the index sort, as
the fold scans run it.  A checkout without ``ops.ivf_kernel.ivf_fold``
takes ``--kernels`` naming the four scans.

To compare two checkouts on one card, either time them in one session in
the order parent, change, change, parent (``--root``), or pass
``--against DIR``: it builds that checkout's ``csrc/ivf_chunk.cu`` (same C
entries) and times its four scans in turns with this checkout's, through
this checkout's wrappers, each rep this, that, that, this, so that drift
of the card's clock falls on both alike:

    python scripts/time_ivf_chunk.py [--root DIR] [--ratio 1.3] [--reps 5]
                                     [--kernels ivf_chunk_int8 ...] [--against DIR]

Prints one JSON object: {"root", "card", "plan": {...}, "ptxas": [...],
"equal": {kernel: bool}, "ms": {kernel: [rep, ...]}, "bound_ms": {kernel: ms}},
with --against also "against": {"root", "equal", "ms"}.
"""

from __future__ import annotations

import argparse
import glob
import hashlib
import importlib
import json
import os
import subprocess
import sys

import numpy as np

NAMES = ("ivf_chunk_int8", "ivf_chunk_int8_fold", "ivf_chunk_pq", "ivf_chunk_pq_fold",
         "ivf_fold", "ivf_fold+index")
# scan name -> its CudaKernel in kernels.py
ATTRS = {"ivf_chunk_int8": "IVF_CHUNK_INT8", "ivf_chunk_int8_fold": "IVF_CHUNK_INT8_FOLD",
         "ivf_chunk_pq": "IVF_CHUNK_PQ", "ivf_chunk_pq_fold": "IVF_CHUNK_PQ_FOLD"}


def against_kernels(kernels, root: str) -> dict:
    """The four scans' C entries built from another checkout's
    csrc/ivf_chunk.cu (its own headers) into this checkout's build dir."""
    csrc = os.path.join(root, "deepreadmapper_tpu_torch", "csrc")
    src = os.path.join(csrc, "ivf_chunk.cu")
    h = hashlib.sha256(" ".join(kernels.NVCC_FLAGS).encode())
    for path in sorted(glob.glob(os.path.join(csrc, "*.cuh"))) + [src]:
        with open(path, "rb") as f:
            h.update(f.read())
    so = os.path.join(kernels.BUILD_DIR, f"ivf_chunk-against-{h.hexdigest()[:16]}.so")
    out = {}
    for attr in ATTRS.values():
        mine = getattr(kernels, attr)
        k = kernels.CudaKernel(mine.name, mine.argtypes, mine.source_name)
        k.source = src
        k.so_path = lambda so=so: so
        out[attr] = k
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--ratio", type=float, default=1.3)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--kernels", nargs="+", choices=NAMES, default=list(NAMES))
    ap.add_argument("--against", help="another checkout, timed in turns with this one")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    cs = importlib.import_module("chip_smoke")
    if os.path.dirname(os.path.abspath(cs.__file__)) != root:
        raise SystemExit(f"chip_smoke.py imported from {cs.__file__}, not from {root}")
    from deepreadmapper_tpu_torch import kernels
    from deepreadmapper_tpu_torch.index.ivf_int8 import drop_pad_steps
    from deepreadmapper_tpu_torch.ops import ivf_kernel as ik

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    rng = np.random.default_rng(6)  # chip_smoke.check_ivf's inputs
    eng8, engpq = cs._ivf_engines(rng, dev)
    nq = cs.SCAN_Q
    probe = np.argsort(rng.random((nq, eng8.nlist)), axis=1)[:, :cs.IVF_NPROBE]
    plan = [torch.from_numpy(a).to(dev) for a in eng8._build_plan_chunked(probe, ik.QTK)]
    sc, sv, qidx, slot_of = drop_pad_steps(plan)
    q8 = torch.from_numpy(rng.integers(-127, 128, (nq + 1, 128), dtype=np.int8)).to(dev)
    q8[nq] = 0
    qsteps = q8[qidx.long()]
    vis = torch.unique(slot_of.reshape(-1).long() // ik.QTK)
    _first, count = ik.visit_steps(sv, qidx.shape[0])
    steps, visits = int(count[vis].sum()), int(vis.numel())
    chunks = int(torch.unique(sc[torch.isin(sv[:-1].long(), vis)]).numel())
    c8, rn8 = eng8._device()[:2]
    (packed, cent2d), rnpq = engpq._device()[:2]
    r2 = 2.0 * float(np.float32(args.ratio))
    rows_out = ik.fold_rows(nq)
    state_bytes = visits * ik.QTK * 4 * ik.KP * 4
    fold_bytes = rows_out * 2 * ik.FS * ik.KP * 4
    cases = {  # name -> (kernel, plain, compared part, bytes a row, output bytes)
        "ivf_chunk_int8": (
            lambda: ik.ivf_chunk_scan_int8(sc, sv, qsteps, c8, rn8, r2),
            lambda: ik.ivf_chunk_scan_int8_reference(sc, sv, qsteps, c8, rn8, r2),
            lambda x: x[vis], 128 + 4, state_bytes),
        "ivf_chunk_int8_fold": (
            lambda: ik.ivf_chunk_scan_int8_fold(sc, sv, qidx, qsteps, c8, rn8, r2, nq),
            lambda: ik.ivf_chunk_scan_int8_fold_reference(sc, sv, qidx, qsteps, c8, rn8,
                                                          r2, nq),
            lambda x: x[:nq], 128 + 4, fold_bytes),
        "ivf_chunk_pq": (
            lambda: ik.ivf_chunk_scan_pq(sc, sv, qsteps, packed, rnpq, cent2d, r2, 8),
            lambda: ik.ivf_chunk_scan_pq_reference(sc, sv, qsteps, packed, rnpq, cent2d,
                                                   r2, 8),
            lambda x: x[vis], 8 + 4, state_bytes),
        "ivf_chunk_pq_fold": (
            lambda: ik.ivf_chunk_scan_pq_fold(sc, sv, qidx, qsteps, packed, rnpq, cent2d,
                                              r2, 8, nq),
            lambda: ik.ivf_chunk_scan_pq_fold_reference(sc, sv, qidx, qsteps, packed,
                                                        rnpq, cent2d, r2, 8, nq),
            lambda x: x[:nq], 8 + 4, fold_bytes),
    }
    if {"ivf_fold", "ivf_fold+index"} & set(args.kernels):
        states = ik.ivf_chunk_scan_pq(sc, sv, qsteps, packed, rnpq, cent2d, r2, 8)
        index = ik.fold_index(qidx, count, nq)
        for name, idx in (("ivf_fold", index), ("ivf_fold+index", None)):
            cases[name] = (
                lambda idx=idx: ik.ivf_fold(states, sv, qidx, nq, idx),
                cases["ivf_chunk_pq_fold"][1], lambda x: x[:nq], 0, state_bytes + fold_bytes)
    out = {"root": root, "card": card,
           "plan": {"rows": eng8.ntotal, "visits": visits, "steps": steps, "chunks": chunks},
           "equal": {}, "ms": {}, "bound_ms": {}}
    other = {}
    if args.against:
        other = against_kernels(kernels, os.path.abspath(args.against))
        out["against"] = {"root": os.path.abspath(args.against), "equal": {}, "ms": {}}
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)

    def rep(fn) -> float:
        """ms a launch: the mean of 3 launches."""
        start.record()
        for _ in range(3):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / 3

    for name in args.kernels:
        kernel, plain, part, row_bytes, out_bytes = cases[name]
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        out["equal"][name] = bool(torch.equal(part(got).view(torch.int32),
                                              part(want).view(torch.int32)))
        del got, want
        # each distinct chunk read once, every chunk step's products; the
        # fold pass alone reads the packed states and writes the accumulator
        if name.startswith("ivf_fold"):
            out["bound_ms"][name] = cs.bound(out_bytes, 0.0, cs.INT8_OPS_S)["bound_ms"]
        else:
            nbytes = chunks * ik.CHK * row_bytes + visits * ik.QTK * 128 + out_bytes
            out["bound_ms"][name] = cs.bound(nbytes, 2.0 * steps * ik.QTK * ik.CHK * 128,
                                             cs.INT8_OPS_S)["bound_ms"]
        if name in ATTRS and other:
            attr = ATTRS[name]
            mine, theirs = getattr(kernels, attr), other[attr]

            def run_theirs(kernel=kernel, attr=attr, mine=mine, theirs=theirs):
                setattr(kernels, attr, theirs)
                try:
                    return kernel()
                finally:
                    setattr(kernels, attr, mine)

            got, want = run_theirs(), plain()
            torch.cuda.synchronize()
            out["against"]["equal"][name] = bool(torch.equal(part(got).view(torch.int32),
                                                             part(want).view(torch.int32)))
            del got, want
            kernel(), run_theirs()  # warm-up
            a, b = [], []
            for _ in range(args.reps):
                t = [rep(kernel), rep(run_theirs), rep(run_theirs), rep(kernel)]
                a.append((t[0] + t[3]) / 2)
                b.append((t[1] + t[2]) / 2)
            out["ms"][name], out["against"]["ms"][name] = a, b
        else:
            kernel()  # warm-up
            out["ms"][name] = [rep(kernel) for _ in range(args.reps)]
    log = "".join(k.build_log for k in (kernels.IVF_CHUNK_INT8, kernels.IVF_CHUNK_INT8_FOLD,
                                        kernels.IVF_CHUNK_PQ, kernels.IVF_CHUNK_PQ_FOLD,
                                        *other.values()))
    out["ptxas"] = [ln.strip() for ln in log.splitlines()
                    if "Used" in ln or "spill" in ln or "Compiling" in ln]
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
