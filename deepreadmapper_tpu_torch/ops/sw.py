"""Smith-Waterman local alignment scores, batched over pairs.

Counterpart of ``deepreadmapper_tpu/ops/sw.py`` and ``ops/sw_pallas.py``
(the parity target there is the reference's calc_sw_score): match +1,
mismatch -1, linear gap -1, score = the max DP cell, comparing raw bytes, so
the '<'/'>' wrap bytes of a wrapped read simply mismatch.

Bytes past a row's true length are replaced by sentinels (254 in ``a``, 255
in ``b``) that never match, so cells outside the true region stay below the
running max and the padded DP equals the true-length DP.  The two sentinel
values are reserved, as in the JAX package.

The score is symmetric in a and b, so :func:`sw_scores` puts the narrower
side in the rows (``a``) and the wider one in the columns: the kernel keeps
the rows' words where every lane of a group reads them and walks the
columns in passes.  It runs ``csrc/sw_score.cu`` on CUDA tensors and the
plain wavefront :func:`sw_scores_reference` on CPU tensors.  On the card it
takes pairs of any width, as the JAX package's ``sw_scores_auto`` does,
in one of three tiers that :func:`sw_layout` picks from the widths:
"shared" (rows in shared memory: a narrower side up to 4,842 bytes, so
short reads against windows of any length), "global" (rows and pass edges
in a global scratch: up to 32,767 bytes, e.g. 6 kb reads against ref_len
6,000 windows) and "int32" (one pair a group in 32-bit lanes past 32,767,
where the 16-bit halves would wrap).

:func:`sw_scores_by_id` scores the SW rerank's pairs without laying them
out: each window is read by its id from a copy of the genome where it is
scored, each query by its row, in the same kernel and tiers.
"""

from __future__ import annotations

import numpy as np
import torch

from deepreadmapper_tpu_torch import kernels
from deepreadmapper_tpu_torch.io.fasta import fetch_windows_by_id

_PAD_A = 254
_PAD_B = 255

# A score is at most the narrower width, and no DP value the kernel forms
# exceeds the score (a match adds 2 to H - 1), so the kernel's signed 16-bit
# halves hold rows up to this width; past it the "int32" tier runs
_MAX_LR = 32767
_THREADS = 128  # lanes a block (csrc/sw_score.cu THREADS)
# columns a lane holds in registers: the kernel's instantiations of S
_STRIPS = (1, 2, 3, 4, 5, 6, 8, 10, 12, 16, 20, 24, 32, 40)
_SMEM = 232_448  # shared memory a block may use on an H100
_SCRATCH = 1 << 30  # bytes of global scratch one launch of the wider tiers may use
_TIERS = ("shared", "global", "int32")  # csrc/sw_score.cu's Tier, in order
# lanes that put 4 warps on each scheduler of an H100 (132 SMs x 4)
_LANES_WANTED = 132 * 4 * 4 * 32


def _pack(mat: torch.Tensor, lens: torch.Tensor, pad: int) -> torch.Tensor:
    """Replace bytes past each row's length with the sentinel."""
    cols = torch.arange(mat.shape[1], device=mat.device)[None, :]
    return torch.where(cols >= lens[:, None], torch.tensor(pad, dtype=mat.dtype,
                                                           device=mat.device), mat)


def _sw_batch(av: torch.Tensor, bflip: torch.Tensor, lr: int, lc: int) -> torch.Tensor:
    """Anti-diagonal wavefront (the ``_sw_batch`` counterpart).  av [n, lr+1]
    int32 row bytes with a sentinel at column 0; bflip [n, 2lr+lc+2] int32
    with bflip[:, lr+lc+1-t] = b[t] (1-based).  Returns the max cell [n]."""
    n, width = av.shape
    zeros = torch.zeros((n, width), dtype=torch.int32, device=av.device)
    h1 = h2 = zeros
    best = torch.zeros(n, dtype=torch.int32, device=av.device)
    pad = torch.zeros((n, 1), dtype=torch.int32, device=av.device)
    for d in range(2, lr + lc + 1):
        bv = bflip[:, lr + lc + 1 - d : lr + lc + 1 - d + width]
        s = torch.where(av == bv, 1, -1)
        h2s = torch.cat([pad, h2[:, :-1]], dim=1)  # H[i-1, j-1]
        h1s = torch.cat([pad, h1[:, :-1]], dim=1)  # H[i-1, j]
        h = torch.maximum(torch.clamp(h2s + s, min=0),
                          torch.maximum(h1s, h1) - 1)
        best = torch.maximum(best, h.amax(dim=1))
        h2, h1 = h1, h
    return best


def sw_scores_reference(a_mat, a_lens, b_mat, b_lens, chunk: int = 8192):
    """Plain version of the kernel.  a_mat [P, lr] / b_mat [P, lc] uint8 with
    per-row true lengths [P] -> int32 [P], on the inputs' device."""
    dev = a_mat.device
    p, lr = a_mat.shape
    lc = b_mat.shape[1]
    out = torch.zeros(p, dtype=torch.int32, device=dev)
    if p == 0:
        return out
    a = _pack(a_mat, a_lens.to(dev), _PAD_A).to(torch.int32)
    b = _pack(b_mat, b_lens.to(dev), _PAD_B).to(torch.int32)
    av = torch.full((p, lr + 1), _PAD_A, dtype=torch.int32, device=dev)
    av[:, 1:] = a
    # width 2lr+lc+2 keeps the slice of the smallest diagonal in bounds
    bflip = torch.full((p, 2 * lr + lc + 2), _PAD_B, dtype=torch.int32, device=dev)
    bflip[:, lr + 1 : lr + lc + 1] = torch.flip(b, dims=[1])
    for s in range(0, p, chunk):
        out[s : s + chunk] = _sw_batch(av[s : s + chunk], bflip[s : s + chunk], lr, lc)
    return out


def _passes(lc: int, g: int) -> int:
    """Passes over lc columns at G = g: a lane holds at most 40 a pass."""
    per_lane = -(-lc // g)
    return -(-per_lane // _STRIPS[-1])


def _smem_bytes(lr: int, lc: int, g: int) -> int:
    """Shared memory of a launch at G = g: the A words of 128 / g groups,
    and with more than one pass their right edges (two words a row)."""
    ng = _THREADS // g
    return 4 * (ng * (lr | 1) + (2 * ng * lr if _passes(lc, g) > 1 else 0))


def _tier(lr: int, lc: int) -> str:
    """Where a launch keeps its rows: shared memory while the A words of 4
    groups of 32 lanes, and with more than one pass their edges, fit it
    (rows lr <= 4,842 bytes against lc >= lr); else a global scratch, in
    16-bit halves up to 32,767-byte scores and in 32-bit lanes past them."""
    if _smem_bytes(lr, lc, 32) <= _SMEM:
        return "shared"
    return "global" if min(lr, lc) <= _MAX_LR else "int32"


def sw_layout(p: int, lr: int, lc: int,
              group: int | None = None) -> tuple[int, int, int, str]:
    """How csrc/sw_score.cu splits a launch of p pairs of widths lr x lc:
    (G, S, passes, tier).  A group of G lanes shares two pairs (one in the
    "int32" tier); each lane holds S columns of b, and the G x S columns a
    pass covers are walked in `passes` passes (more than one only when lc >
    32 x 40).  The tier (:func:`_tier`) says where the rows and the pass
    edges live.  G is the smallest power of two that gives the launch 4
    warps a scheduler of the card where p allows, and no smaller than the
    registers (S <= 40) and, in the "shared" tier, the shared memory (the A
    words of 128 / G groups, and their right edges between passes) need,
    and no more lanes than lc has columns: the wider tiers' lc (past 32 x
    40 columns) always takes G 32.  `group` forces G (tests)."""
    lc = max(lc, 1)
    tier = _tier(lr, lc)
    g_min = 1
    while g_min < 32 and (-(-lc // g_min) > _STRIPS[-1]
                          or (tier == "shared" and _smem_bytes(lr, lc, g_min) > _SMEM)):
        g_min *= 2
    if group is None:
        g, g_max = g_min, max(g_min, min(32, 1 << (lc.bit_length() - 1)))
        while g < g_max and (p + 1) // 2 * g < _LANES_WANTED:
            g *= 2
    elif group in (1, 2, 4, 8, 16, 32) and group >= g_min:
        g = group
    else:
        raise ValueError(f"sw_score takes G a power of two in [{g_min}, 32] at "
                         f"lr {lr}, lc {lc}, got {group}")
    per_lane = -(-lc // g)
    passes = _passes(lc, g)
    s = next(x for x in _STRIPS if x * passes >= per_lane)
    return g, s, passes, tier


def _scratch_per_block(lr: int, g: int) -> int:
    """Bytes of global scratch a block of the wider tiers takes: the A words
    of its 128 / g groups (lr | 1 each) and one edge word a row and group."""
    return 4 * (_THREADS // g) * ((lr | 1) + lr)


def _launch_split(p: int, lr: int, g: int, tier: str) -> tuple[int, int]:
    """(pairs a launch, scratch bytes) of a call of p > 0 pairs in one of
    the wider tiers: as many pairs as keep a launch's scratch at or under
    1 GiB, the scratch its largest launch takes."""
    ng, pg = _THREADS // g, 1 if tier == "int32" else 2
    step = min(p, max(1, _SCRATCH // _scratch_per_block(lr, g)) * ng * pg)
    return step, -(-step // (ng * pg)) * _scratch_per_block(lr, g)


def sw_scratch_bytes(p: int, lr: int, lc: int) -> int:
    """Bytes of global scratch :func:`sw_scores` allocates for p pairs with
    rows lr and columns lc wide (lr <= lc): 0 in the "shared" tier, else the
    scratch of its largest launch, at most 1 GiB (a call past that many
    pairs runs in several launches that reuse it)."""
    g, _, _, tier = sw_layout(p, lr, lc)
    return 0 if tier == "shared" or p == 0 else _launch_split(p, lr, g, tier)[1]


def sw_scores(a_mat: torch.Tensor, a_lens: torch.Tensor, b_mat: torch.Tensor,
              b_lens: torch.Tensor, group: int | None = None) -> torch.Tensor:
    """Batched SW scores: csrc/sw_score.cu on CUDA tensors, the plain version
    on CPU tensors.  a_mat [P, lr] / b_mat [P, lc] uint8, lengths [P] (any
    integer type; clipped to [0, width]) -> int32 [P].  The narrower side
    becomes the rows (the score is symmetric).  On the card any widths run
    in the tier :func:`sw_layout` picks; the wider tiers take a global
    scratch of :func:`sw_scratch_bytes` (at most 1 GiB: more pairs than
    that holds run in several launches).  The kernel reads no byte past a
    row's length: it takes the sentinels there itself.  `group` forces the
    kernel's G (tests; see :func:`sw_layout`)."""
    if a_mat.dtype != torch.uint8 or b_mat.dtype != torch.uint8:
        raise TypeError(f"sw_scores takes uint8 bytes, got {a_mat.dtype}, {b_mat.dtype}")
    if a_mat.dim() != 2 or b_mat.dim() != 2:
        raise ValueError("sw_scores needs 2-D byte matrices")
    p = a_mat.shape[0]
    if b_mat.shape[0] != p or a_lens.shape != (p,) or b_lens.shape != (p,):
        raise ValueError(
            f"sw_scores: {p} a rows, {b_mat.shape[0]} b rows, lengths "
            f"{tuple(a_lens.shape)} / {tuple(b_lens.shape)}"
        )
    dev = a_mat.device
    if b_mat.device != dev:
        raise ValueError(f"a_mat on {dev}, b_mat on {b_mat.device}")
    if a_mat.shape[1] > b_mat.shape[1]:
        a_mat, a_lens, b_mat, b_lens = b_mat, b_lens, a_mat, a_lens
    if dev.type == "cpu":
        return sw_scores_reference(a_mat, a_lens, b_mat, b_lens)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    lr, lc = a_mat.shape[1], b_mat.shape[1]
    g, strip, passes, tier = sw_layout(p, lr, lc, group)
    out = torch.empty(p, dtype=torch.int32, device=dev)
    if p == 0:
        return out
    a_mat = a_mat.contiguous()
    b_mat = b_mat.contiguous()
    la = a_lens.to(device=dev, dtype=torch.int32).contiguous()
    lb = b_lens.to(device=dev, dtype=torch.int32).contiguous()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for s, n, scratch in _launches(p, lr, g, tier, dev):
            kernels.SW_SCORE.launch(
                a_mat.data_ptr() + s * lr, la.data_ptr() + 4 * s,
                b_mat.data_ptr() + s * lc, lb.data_ptr() + 4 * s,
                out.data_ptr() + 4 * s, scratch,
                n, lr, lc, g, strip, passes, _TIERS.index(tier), stream,
            )
    return out


def _launches(p: int, lr: int, g: int, tier: str, dev: torch.device):
    """(first pair, pairs, scratch pointer or None) of each launch of a call
    of p > 0 pairs: one launch in the "shared" tier; in the wider tiers as
    many pairs a launch as :func:`_launch_split` allows, one scratch shared
    by all of them."""
    if tier == "shared":
        yield 0, p, None
        return
    step, nbytes = _launch_split(p, lr, g, tier)
    scratch = torch.empty(nbytes // 4, dtype=torch.int32, device=dev)
    for s in range(0, p, step):
        yield s, min(step, p - s), scratch.data_ptr()


def sw_scores_by_id(genome: torch.Tensor, ids: torch.Tensor, ref_len: int,
                    q_mat: torch.Tensor, q_lens: torch.Tensor,
                    group: int | None = None) -> torch.Tensor:
    """SW scores of genome windows, given by id, against query rows: the
    score of pair (r, j) is that of the window ids[r, j] against query r.
    genome [glen] uint8, ids [Q, C] int64 dense window ids (2 pos | strand;
    a window that does not lie inside the genome, a negative id's too, is
    ref_len zero bytes, as ``io.fasta.fetch_windows_by_id`` returns it),
    q_mat [Q, W] uint8 with lengths q_lens [Q] -> int32 [Q, C], equal to
    :func:`sw_scores` of the fetched windows against the repeated queries.

    On CUDA tensors csrc/sw_score.cu's by-id flavour reads each window from
    the genome and each query by its row where it scores them: no window
    and no query copy is laid out.  The windows are the rows when ref_len
    is at most W, else the columns, in the tier :func:`sw_layout` picks, in
    as many launches as :func:`sw_scores` would make.  On CPU
    tensors the plain version fetches the windows and runs
    :func:`sw_scores_reference`.  `group` forces the kernel's G (tests)."""
    if genome.dtype != torch.uint8 or q_mat.dtype != torch.uint8:
        raise TypeError(f"sw_scores_by_id takes uint8 bytes, got {genome.dtype}, "
                        f"{q_mat.dtype}")
    if genome.dim() != 1 or ids.dim() != 2 or q_mat.dim() != 2:
        raise ValueError("sw_scores_by_id needs a 1-D genome, [Q, C] ids and [Q, W] "
                         "query rows")
    qn, c = ids.shape
    if q_mat.shape[0] != qn or q_lens.shape != (qn,):
        raise ValueError(f"sw_scores_by_id: ids for {qn} queries, {q_mat.shape[0]} query "
                         f"rows, lengths {tuple(q_lens.shape)}")
    dev = genome.device
    if ids.device != dev or q_mat.device != dev:
        raise ValueError(f"genome on {dev}, ids on {ids.device}, queries on {q_mat.device}")
    p = qn * c
    if dev.type == "cpu":
        w_mat, w_lens = fetch_windows_by_id(genome.numpy(), ids.reshape(-1).numpy(),
                                            ref_len, max_len=ref_len)
        return sw_scores(torch.from_numpy(np.ascontiguousarray(w_mat)),
                         torch.from_numpy(w_lens), q_mat.repeat_interleave(c, dim=0),
                         q_lens.repeat_interleave(c), group).view(qn, c)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    width = q_mat.shape[1]
    rows = ref_len <= width  # the narrower side in the rows, as sw_scores puts it
    lr, lc = (ref_len, width) if rows else (width, ref_len)
    g, strip, passes, tier = sw_layout(p, lr, lc, group)
    out = torch.empty(p, dtype=torch.int32, device=dev)
    if p == 0:
        return out.view(qn, c)
    genome = genome.contiguous()
    ids = ids.to(torch.int64).contiguous()
    q_mat = q_mat.contiguous()
    ql = q_lens.to(device=dev, dtype=torch.int32).contiguous()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for s, n, scratch in _launches(p, lr, g, tier, dev):
            kernels.SW_SCORE_BY_ID.launch(
                genome.data_ptr(), genome.numel(), ids.data_ptr() + 8 * s,
                q_mat.data_ptr(), ql.data_ptr(), c, s, int(rows),
                out.data_ptr() + 4 * s, scratch,
                n, lr, lc, g, strip, passes, _TIERS.index(tier), stream,
            )
    return out.view(qn, c)
