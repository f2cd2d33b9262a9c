"""The INT8FLAT index as the judge reads it: the embedding of every window
at the configuration's stride (positions 0, s, 2s, ..., both strands) as
int8 codes at the scale 1/127 (reference/scan.py).  The judge finds this
file by the configuration's index_type; a file of the same form for
another index type is all that type needs here.

Rounding.  The reference's fp32 embeddings and the program's differ in the
last bits, so a value next to a rounding boundary may round either way.  A
code counts as right when the reference's value lies within ``eps`` code
steps of the code's rounding cell; ``index_gap`` is the widest such
distance over the whole index (0 where every code is the reference's own
rounding).  The index the reference scans takes the program's choice at
those boundaries and its own everywhere else.
"""

from __future__ import annotations

import torch

from drm_bench.reference import scan as ref_scan


def program_state(engine) -> dict:
    """What the judge reads of the program's engine: its codes."""
    return {"codes": engine.codes}


def reference_state(enc, genome: torch.Tensor, cfg: dict) -> dict:
    """The reference's own index (for the control)."""
    ref_len = int(cfg["ref_len"])
    pos = ref_scan.index_positions(genome.numel(), ref_len, int(cfg["stride"]))
    codes = torch.cat([ref_scan.quantize(e, ref_scan.INT8_SCALE) for _, e in
                       ref_scan.window_embeddings(enc, genome, ref_len, pos)])
    return {"codes": codes.cpu().numpy()}


def index_of(state: dict, device) -> ref_scan.Index:
    return ref_scan.Index(torch.from_numpy(state["codes"]).to(device), ref_scan.INT8_SCALE)


def judge(enc, genome: torch.Tensor, cfg: dict, state: dict, eps: float,
          numbers: dict, info: dict) -> ref_scan.Index:
    """Embed every window of the index again and judge the program's codes against it:
    numbers["index_gap"]; returns the index the reference scans."""
    dev = genome.device
    ref_len = int(cfg["ref_len"])
    pos = ref_scan.index_positions(genome.numel(), ref_len, int(cfg["stride"]))
    codes = state["codes"]
    if codes.shape[0] != 2 * pos.size:
        raise AssertionError(f"index holds {codes.shape[0]} rows, the genome has "
                             f"{2 * pos.size} at stride {cfg['stride']}")
    adopted = torch.empty(codes.shape, dtype=torch.int8, device=dev)
    gap_max, n_diff = 0.0, 0
    for r0, emb in ref_scan.window_embeddings(enc, genome, ref_len, pos):
        prog = torch.from_numpy(codes[r0 : r0 + emb.shape[0]]).to(dev)
        own = ref_scan.quantize(emb, ref_scan.INT8_SCALE)
        gap = ref_scan.rounding_gap(emb, ref_scan.INT8_SCALE, prog)
        gap_max = max(gap_max, float(gap.max()))
        n_diff += int((own != prog).sum())
        adopted[r0 : r0 + emb.shape[0]] = torch.where(gap <= eps, prog, own)
    numbers["index_gap"] = gap_max
    info["index_codes_unequal"] = n_diff
    return ref_scan.Index(adopted, ref_scan.INT8_SCALE)
