"""Time the Smith-Waterman kernel (csrc/sw_score.cu) on the card.

Builds the kernel from a checkout (this one unless --root names another),
makes chip_smoke.py phase 3's pairs (its generator, seed 2: a random
genome's 150-byte windows against '<'-wrapped 152-byte reads, 10% of them
the read's own window) at the main path's launch sizes, checks each size
against the plain version bit for bit, and prints CUDA-event milliseconds
per launch (each rep 50 launches after 20 to warm up; int32 lengths, so
the wrapper launches nothing else) with the GCUPS they give,
the G the wrapper chose (null for a checkout without `sw_layout`), the
ptxas register lines, the count of DPX instructions in the kernel's SASS
and the card's name and power limit.  5,120 pairs is one query chunk of
the SW rerank at stride 1 and k_clusters 10 (512 reads x 10), 17,920 one
at stride 4 and k_clusters 5 (35 candidates a read), 65,536 chip_smoke.py's
earlier table shape.  `--groups G` forces the kernel's G (checkouts with
`sw_layout` only).  `--by-id` times the SW rerank's request instead
(checkouts with `sw_scores_by_id` only): P / 10 reads of a random 4.64 Mbp
genome against 10 window ids each, both strands, scored by the by-id
flavour in one launch ("ms"), against the same pairs laid out as matrices
and scored in 5,120-pair launches, the host-fetch path's chunks
("ms_chunks": the kernel alone, no fetch); "equal" holds the two to each
other.  To compare two checkouts on one card, time them on one machine in
the order parent, change, change, parent:

    python scripts/time_sw_score.py [--root DIR] [--pairs 5120 17920 65536]
                                    [--reps 5] [--groups G] [--by-id]

Prints one JSON object: {"root", "card", "ptxas": [...], "sass": {"S=5":
{"dpx", "instructions"}, ...} (one entry a strip the kernel is built for),
"opcodes": {...} (the SASS of the first size's strip), "groups": {P: G},
"equal": {P: bool}, "ms": {P: [rep, ...]}, "gcups": {P: [rep, ...]}}.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from collections import Counter

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--pairs", type=int, nargs="+", default=[5120, 17920, 65536])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--groups", type=int, default=None)
    ap.add_argument("--by-id", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    import numpy as np
    import torch

    import chip_smoke  # the pair generator and the SASS reader of this checkout

    sys.path.insert(0, os.path.abspath(args.root))
    from deepreadmapper_tpu_torch import kernels
    from deepreadmapper_tpu_torch.ops import sw

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    layout = getattr(sw, "sw_layout", None)
    kw = {} if args.groups is None else {"group": args.groups}
    out = {"root": args.root, "card": card, "groups": {}, "equal": {}, "ms": {},
           "gcups": {}}
    if args.by_id:
        out["ms_chunks"] = {}
    for p in args.pairs:
        if args.by_id:
            _time_by_id(out, p, args, sw, kw)
            continue
        a, la, b, lb = (torch.from_numpy(x).cuda()
                        for x in chip_smoke._sw_pairs(np.random.default_rng(2), p))
        la, lb = la.int(), lb.int()  # the wrapper then launches nothing but the kernel
        got = sw.sw_scores(a, la, b, lb, **kw)
        out["equal"][p] = bool(torch.equal(got, sw.sw_scores_reference(a, la, b, lb)))
        out["groups"][p] = (layout(p, a.shape[1], b.shape[1], args.groups)[0]
                            if layout else None)
        cells = float((la.double() * lb.double()).sum())
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        for _ in range(20):  # warm-up
            sw.sw_scores(a, la, b, lb, **kw)
        reps = []
        for _ in range(args.reps):
            start.record()
            for _ in range(50):
                sw.sw_scores(a, la, b, lb, **kw)
            end.record()
            torch.cuda.synchronize()
            reps.append(start.elapsed_time(end) / 50)
        out["ms"][p] = reps
        out["gcups"][p] = [cells / (t * 1e-3) / 1e9 for t in reps]
    out["ptxas"] = [ln.strip() for ln in (kernels.SW_SCORE.build_log or "").splitlines()
                    if "Used" in ln or "spill" in ln]
    funcs = chip_smoke.sass_opcodes(kernels.SW_SCORE.build(), "sw_score_kernel")
    out["sass"] = {chip_smoke.strip_name(f): {"dpx": chip_smoke.dpx_count(c),
                                              "instructions": sum(c.values())}
                   for f, c in funcs.items()}
    if layout:  # the instantiation of the first size's strip
        s = layout(args.pairs[0], 150, 152, args.groups)[1]
        tag = f"S={s}" + (" by id" if args.by_id else "")
        funcs = {f: c for f, c in funcs.items() if chip_smoke.strip_name(f) == tag}
    out["opcodes"] = dict(sum(funcs.values(), Counter()).most_common())
    print(json.dumps(out))
    return 0


def _events_ms(fn, reps: int) -> list[float]:
    """CUDA-event ms of fn, each rep 50 calls after 20 to warm up."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for _ in range(20):
        fn()
    out = []
    for _ in range(reps):
        start.record()
        for _ in range(50):
            fn()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end) / 50)
    return out


def _time_by_id(out: dict, p: int, args, sw, kw: dict) -> None:
    """The SW rerank's request of p pairs (p / 10 reads x 10 ids): by id in
    one launch, and laid out in 5,120-pair launches."""
    import numpy as np
    import torch

    from deepreadmapper_tpu_torch.io import fasta

    rng = np.random.default_rng(2)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    ref_len, c = 150, 10
    genome = acgt[rng.integers(0, 4, 4_641_652)]
    ids = rng.integers(0, 2 * (genome.size - ref_len + 1), (p // c, c))
    w_mat, w_lens = fasta.fetch_windows_by_id(genome, ids.ravel(), ref_len, max_len=ref_len)
    q = np.full((p // c, ref_len + 2), ord(">"), np.uint8)
    q[:, 0] = ord("<")
    q[:, 1:-1] = w_mat[::c]  # each read its first window's, 1% substituted
    mask = rng.random((p // c, ref_len)) < 0.01
    q[:, 1:-1][mask] = acgt[rng.integers(0, 4, int(mask.sum()))]
    ql = np.full(p // c, ref_len + 2)
    g_d, i_d, q_d, ql_d = (torch.from_numpy(x).cuda() for x in (genome, ids, q, ql))
    a, la, b, lb = (torch.from_numpy(np.ascontiguousarray(x)).cuda() for x in
                    (w_mat, w_lens, np.repeat(q, c, axis=0), np.repeat(ql, c)))
    la, lb, ql_d = la.int(), lb.int(), ql_d.int()

    def by_id():
        return sw.sw_scores_by_id(g_d, i_d, ref_len, q_d, ql_d, **kw)

    def chunks():
        return torch.cat([sw.sw_scores(a[s:s + 5120], la[s:s + 5120], b[s:s + 5120],
                                       lb[s:s + 5120]) for s in range(0, p, 5120)])

    out["equal"][p] = bool(torch.equal(by_id().view(-1), chunks()))
    out["groups"][p] = sw.sw_layout(p, ref_len, ref_len + 2, args.groups)[0]
    out["ms"][p] = _events_ms(by_id, args.reps)
    out["ms_chunks"][p] = _events_ms(chunks, args.reps)
    cells = float(p * ref_len * (ref_len + 2))
    out["gcups"][p] = [cells / (t * 1e-3) / 1e9 for t in out["ms"][p]]


if __name__ == "__main__":
    sys.exit(main())
