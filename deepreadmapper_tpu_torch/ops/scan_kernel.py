"""Fused int8 / PQ scans: matmul + windowed top-1, then a top-k over the
windows.

Counterpart of ``deepreadmapper_tpu/ops/scan_kernel.py``.  The PQ scan
rebuilds each row from its codes through the int8 codebook (exactly
int8-valued) and then scores it as the int8 scan does.
Each window of W rows keeps only (min score, lowest argmin row) per query,
so the device writes [N/W, Q] instead of the [N, Q] score matrix; the
per-query top-k then runs on that reduced array.  Scores are
``rn - ratio2 * (q8 . r8)`` (the caller adds the query norm); rows at or past
``ntotal`` get ``rn = 3.4e38`` and never win.

All arithmetic is exact: int8 dot products are exact integers and every
term is below 2^24.  At ratio2 != 2 the score is rounded to fp32 once, as a
fused multiply-subtract: the JAX package's score as XLA computes it.  The
kernel (``csrc/int8_winmin.cu``, an explicit FMA) and the plain version
(:func:`int8_winmin_reference`, exact in float64, then one rounding)
therefore agree bit for bit at any ratio.
"""

from __future__ import annotations

import numpy as np
import torch

from deepreadmapper_tpu_torch import kernels
from deepreadmapper_tpu_torch.ops.pq import reconstruct8
from deepreadmapper_tpu_torch.ops.topk import merge_smallest_k, smallest_k

QT = 512      # query padding unit of the fused path
CT = 4096     # candidate padding unit below _PAD_BASE rows
W = 128       # reduction window: one (min, argmin) survivor per W rows
D = 128       # bytes per code row
_BIG = 3.4e38

MIN_FUSED_N = 1 << 18  # below this the scan is fast anyway; NW must exceed k
_PAD_BASE = 1 << 18    # pad codes to this multiple so chunks divide evenly
_MAX_CHUNK_UNITS = 8   # chunk <= 8 * 2^18 = 2^21 rows

# the scan block both kernels share (csrc/winmin.cuh, namespace scan)
_KQ = 128     # queries per block (QB)
_KR = 128     # the row slab (SLAB)
_KWPB = 32    # windows per block (WPB)


def can_fuse(n: int, n_padded: int, k: int, device: torch.device) -> bool:
    """The fused-scan eligibility predicate: a CUDA device, enough rows for
    the window reduction to make sense (and N/W >= k), padding laid out on
    the fused grid, and k within one chunk's window count."""
    return (
        torch.device(device).type == "cuda"
        and n >= MIN_FUSED_N
        and n_padded % _PAD_BASE == 0
        and k <= _PAD_BASE // W
    )


def choose_chunk(np_: int) -> int:
    """Largest chunk that divides np_ (a _PAD_BASE multiple), is a multiple
    of _PAD_BASE, and stays <= 2^21 rows."""
    units = np_ // _PAD_BASE
    for d in range(min(_MAX_CHUNK_UNITS, units), 0, -1):
        if units % d == 0:
            return d * _PAD_BASE
    return _PAD_BASE


def pad_rows(n: int, chunk: int) -> int:
    """Rows of padding needed for the fused path (chunk % CT == 0)."""
    return (-n) % chunk


def _winmin(s: torch.Tensor, w: int) -> tuple[torch.Tensor, torch.Tensor]:
    """[N, Q] scores -> per-window (min [N/w, Q], global argmin [N/w, Q]);
    on ties the lowest row wins."""
    n, q = s.shape
    s3 = s.reshape(n // w, w, q)
    vmin = s3.amin(dim=1)
    widx = torch.arange(w, dtype=torch.int32, device=s.device)[None, :, None]
    amin = torch.where(s3 == vmin[:, None, :], widx, 2**30).amin(dim=1)
    base = torch.arange(0, n, w, dtype=torch.int32, device=s.device)[:, None]
    return vmin, base + amin


def fused_score(base: torch.Tensor, ratio2: float, dot: torch.Tensor):
    """fp32 base - ratio2 * dot rounded ONCE to fp32, as an FMA rounds it.
    base is fp32 (an integer, or a sum of fp32 terms), dot holds exact
    integers below 2^22 and ratio2 is an fp32 value >= 2: then the float64
    difference is exact, so its rounding is the only one."""
    r2 = float(np.float32(ratio2))
    return (base.to(torch.float64) - r2 * dot.to(torch.float64)).to(torch.float32)


def _row_norms(r8: torch.Tensor) -> torch.Tensor:
    r = r8.to(torch.int32)
    return (r * r).sum(dim=1).to(torch.float32)  # exact: < 2^21


def aligned16(a: torch.Tensor) -> torch.Tensor:
    """a, or a copy of it when its data is off a 16-byte boundary."""
    return a if a.data_ptr() % 16 == 0 else a.clone()


def int8_winmin_reference(q8, r8, ntotal: int, ratio2: float, w: int = W):
    """Plain version of the kernel.  q8 [Qp, 128] int8, r8 [Np, 128] int8 ->
    (vals [Np/w, Qp] f32, args [Np/w, Qp] int32).  Loops over QT-query tiles
    so the [Np, QT] score matrix stays bounded."""
    np_ = r8.shape[0]
    rn = _row_norms(r8)
    rows = torch.arange(np_, device=r8.device)
    rn = torch.where(rows < ntotal, rn, torch.full_like(rn, _BIG))
    rf = r8.to(torch.float32)
    vals, args = [], []
    for s in range(0, q8.shape[0], QT):
        dot = rf @ q8[s : s + QT].to(torch.float32).T  # exact integers
        v, a = _winmin(fused_score(rn[:, None], ratio2, dot), w)
        vals.append(v)
        args.append(a)
    return torch.cat(vals, dim=1), torch.cat(args, dim=1)


def int8_winmin(q8, r8, ntotal: int, ratio2: float, w: int = W):
    """The window-min scan: csrc/int8_winmin.cu on CUDA tensors, the plain
    version on CPU tensors.  Same contract as int8_winmin_reference."""
    if q8.dtype != torch.int8 or r8.dtype != torch.int8:
        raise TypeError(f"int8_winmin takes int8 tensors, got {q8.dtype}, {r8.dtype}")
    if q8.dim() != 2 or r8.dim() != 2 or q8.shape[1] != D or r8.shape[1] != D:
        raise ValueError(
            f"int8_winmin needs q8 [Qp, {D}] and r8 [Np, {D}], got "
            f"{tuple(q8.shape)}, {tuple(r8.shape)}"
        )
    qp, np_ = q8.shape[0], r8.shape[0]
    if w % _KR or np_ % w:
        raise ValueError(f"need w % {_KR} == 0 and Np % w == 0 (w={w}, Np={np_})")
    if q8.device != r8.device:
        raise ValueError(f"q8 on {q8.device}, r8 on {r8.device}")
    if q8.device.type == "cpu":
        return int8_winmin_reference(q8, r8, ntotal, ratio2, w)
    if q8.device.type != "cuda":
        raise ValueError(f"unsupported device {q8.device}")
    if qp % _KQ:
        raise ValueError(f"int8_winmin kernel needs Qp % {_KQ} == 0, got {qp}")
    nwin = np_ // w
    if -(-nwin // _KWPB) > 65535:
        raise ValueError(f"int8_winmin grid too large for Np={np_}, w={w}")
    # the kernel reads the rows in 16-byte pieces: a view off a 16-byte
    # boundary is copied first
    q8 = q8.contiguous()
    r8 = aligned16(r8.contiguous())
    vals = torch.empty((nwin, qp), dtype=torch.float32, device=q8.device)
    args = torch.empty((nwin, qp), dtype=torch.int32, device=q8.device)
    if qp == 0 or nwin == 0:
        return vals, args
    nt = max(min(int(ntotal), np_), -1)
    with torch.cuda.device(q8.device):
        stream = torch.cuda.current_stream(q8.device).cuda_stream
        kernels.INT8_WINMIN.launch(
            q8.data_ptr(), r8.data_ptr(), vals.data_ptr(), args.data_ptr(),
            qp, np_, w, nt, float(ratio2), stream,
        )
    return vals, args


def pq_winmin_reference(q8, codes, cent8, ntotal: int, ratio2: float, w: int = W):
    """Plain version of the PQ kernel: rebuild the int8 rows from codes
    [Np, m] uint8 and the int8 codebook cent8 [m, ksub, 128/m], then the
    int8 window-min scan.  Same outputs as int8_winmin_reference."""
    return int8_winmin_reference(q8, reconstruct8(codes, cent8), ntotal, ratio2, w)


def pq_winmin(q8, codes, cent8, ntotal: int, ratio2: float, w: int = W):
    """The PQ window-min scan: csrc/pq_winmin.cu on CUDA tensors, the plain
    version on CPU tensors.  Same contract as pq_winmin_reference; codes
    must be < ksub."""
    if q8.dtype != torch.int8 or codes.dtype != torch.uint8 or cent8.dtype != torch.int8:
        raise TypeError(
            f"pq_winmin takes int8 queries, uint8 codes and an int8 codebook, "
            f"got {q8.dtype}, {codes.dtype}, {cent8.dtype}"
        )
    if q8.dim() != 2 or q8.shape[1] != D or codes.dim() != 2 or cent8.dim() != 3:
        raise ValueError(
            f"pq_winmin needs q8 [Qp, {D}], codes [Np, m], cent8 [m, ksub, dsub]; "
            f"got {tuple(q8.shape)}, {tuple(codes.shape)}, {tuple(cent8.shape)}"
        )
    m, ksub, dsub = cent8.shape
    if codes.shape[1] != m or m * dsub != D or ksub > 256:
        raise ValueError(f"codes {tuple(codes.shape)} do not fit cent8 {tuple(cent8.shape)}")
    qp, np_ = q8.shape[0], codes.shape[0]
    if w % _KR or np_ % w:
        raise ValueError(f"need w % {_KR} == 0 and Np % w == 0 (w={w}, Np={np_})")
    if not (q8.device == codes.device == cent8.device):
        raise ValueError(f"q8 on {q8.device}, codes on {codes.device}, cent8 on {cent8.device}")
    if q8.device.type == "cpu":
        return pq_winmin_reference(q8, codes, cent8, ntotal, ratio2, w)
    if q8.device.type != "cuda":
        raise ValueError(f"unsupported device {q8.device}")
    if qp % _KQ:
        raise ValueError(f"pq_winmin kernel needs Qp % {_KQ} == 0, got {qp}")
    nwin = np_ // w
    if -(-nwin // _KWPB) > 65535:
        raise ValueError(f"pq_winmin grid too large for Np={np_}, w={w}")
    # the kernel reads the codes and the codebook in 16-byte pieces: a view
    # off a 16-byte boundary is copied first
    q8 = q8.contiguous()
    codes, cent8 = aligned16(codes.contiguous()), aligned16(cent8.contiguous())
    vals = torch.empty((nwin, qp), dtype=torch.float32, device=q8.device)
    args = torch.empty((nwin, qp), dtype=torch.int32, device=q8.device)
    if qp == 0 or nwin == 0:
        return vals, args
    nt = max(min(int(ntotal), np_), -1)
    with torch.cuda.device(q8.device):
        stream = torch.cuda.current_stream(q8.device).cuda_stream
        kernels.PQ_WINMIN.launch(
            q8.data_ptr(), codes.data_ptr(), cent8.data_ptr(), vals.data_ptr(),
            args.data_ptr(), qp, np_, w, nt, float(ratio2), m, ksub, stream,
        )
    return vals, args


def fused_scan_topk(q8, store, ntotal: int, k: int, chunk: int, ratio=1.0,
                    w: int = W, winmin=None, cent8=None):
    """Chunked fused scan with an exact cross-chunk merge.

    q8 [Qp, 128] int8 queries; store [Np, 128] int8 rows, or with cent8
    (the int8 codebook [m, ksub, 128/m]) [Np, m] uint8 PQ codes; Np % chunk
    == 0 and chunk % w == 0; ntotal = count of real rows (the rest is
    padding, masked in the scan).  Returns (scores [Qp, k] f32 = rn - 2
    ratio q.r ascending, the caller adds the query norm; ids [Qp, k] int64).
    The top-k over window minima is exact and stable (the lower window wins
    ties).  winmin selects the scan (default: the kernel wrapper of the
    store's kind, int8_winmin or pq_winmin), called as
    winmin(q8, rows[, cent8], ntotal, ratio2, w)."""
    np_ = store.shape[0]
    ratio2 = 2.0 * float(np.float32(ratio))  # exact: the kernel takes fp32
    if winmin is None:
        winmin = int8_winmin if cent8 is None else pq_winmin
    extra = () if cent8 is None else (cent8,)
    best_d = best_i = None
    for c0 in range(0, np_, chunk):
        vals, args = winmin(q8, store[c0 : c0 + chunk], *extra, ntotal - c0, ratio2, w)
        # [chunk/W, Qp] -> [Qp, chunk/W]
        d, pos = smallest_k(vals.T, k)
        i = torch.gather(args.T, 1, pos).to(torch.int64) + c0
        if best_d is None:
            best_d, best_i = d, i
        else:
            best_d, best_i = merge_smallest_k(best_d, best_i, d, i, k)
    return best_d, best_i
