"""Chunked IVF scans (IVFINT8 / IVFPQ): per-visit windowed top-2, packed
or folded into a per-query accumulator.

Counterpart of ``deepreadmapper_tpu/ops/ivf_kernel.py``, with its contracts.
A plan of S chunk STEPS drives the scan: ``step_chunk [S]`` names the chunk
of the fill-aware layout each step scores, ``step_visit [S+1]`` the VISIT
(one query tile of QTK queries against one slab) it belongs to, consecutive
per visit, with a trailing -1.  Every visit scores its QTK queries against
its slab's rows, ``rn - ratio2 * (q8 . r8)`` rounded once (an FMA, as XLA
rounds it), and keeps, per query and per strided lane window (column j of a
chunk is in window j mod KP), the best and second-best (value, chunk-space
row id), earlier rows winning ties.  The packed scans store each visit's
state as one [QTK, 4*KP] block (vals | vals2 | args | args2, args as fp32
bit patterns); the fold scans insert it, visit by visit in ascending visit
id, into the FS sorted slots per window of each query's accumulator row
(``fold_rows(nq)`` rows of [FS*KP vals | FS*KP ids]), rows named by
``qidx [V, QTK]`` (the dump row nq takes padding).

On CUDA tensors the four scans run ``csrc/ivf_chunk.cu``; on CPU tensors
their plain versions below, which compute the same values.  A visit's
state is the lexicographic (value, row) top-2 of its rows per window, so
the plain scan takes it with stable sorts instead of the TPU's sequential
ladder.  The fold's insert ladder is not a stable sort (a displaced slot
that ties the next one swaps places with it), so the plain fold runs the
ladder itself, visit by visit.
"""

from __future__ import annotations

import numpy as np
import torch

from deepreadmapper_tpu_torch import kernels
from deepreadmapper_tpu_torch.ops.scan_kernel import aligned16, fused_score
from deepreadmapper_tpu_torch.ops.topk import smallest_k

QTK = 32      # queries per visit
KP = 128      # strided lane windows per visit (survivors per window: 2)
CHK = 2048    # rows per chunk
FS = 4        # fold slots per window
D = 128       # bytes per int8 row
_BIG = 3.4e38
_STEP_BATCH = 256  # steps per batch of the plain scans: bounds [S, QTK, CHK]


# Copied from deepreadmapper_tpu/ops/ivf_kernel.py (that module imports jax).
def chunk_layout(fill: np.ndarray, chk: int):
    """Per-slab fill counts [n_slabs] -> (nchunks [n_slabs+1] int32,
    chunk_base [n_slabs+1] int32, n_chunks_total incl. the trailing dump
    chunk).  Slab s owns chunks [chunk_base[s], chunk_base[s]+nchunks[s]);
    the dump slab (index n_slabs) owns the single all-empty trailing chunk."""
    nch = np.maximum(1, -(-np.asarray(fill, np.int64) // chk))
    nch = np.concatenate([nch, [1]]).astype(np.int32)  # + dump slab
    base = np.concatenate([[0], np.cumsum(nch[:-1])]).astype(np.int32)
    return nch, base, int(nch.sum())


def fold_rows(q: int) -> int:
    """Accumulator rows: q queries + 1 dump row, padded to a multiple of 8."""
    return -(-(q + 1) // 8) * 8


def unpack_scan(packed: torch.Tensor):
    """Packed [V, QTK, 4*KP] -> (vals, args, vals2, args2), each [V, QTK, KP]
    (args int32 through a same-width bitcast)."""
    return (
        packed[:, :, :KP],
        packed[:, :, 2 * KP:3 * KP].view(torch.int32),
        packed[:, :, KP:2 * KP],
        packed[:, :, 3 * KP:].view(torch.int32),
    )


def merge_packed(packed, slot_of, nprobe: int, k: int):
    """Slot gather + top-k over the packed scans' output: each (query,
    probe) pair contributes its slot's 2*KP (value, id) columns.  The top-k
    is exact and stable (the lower column wins ties), which is what the JAX
    package's approx_max_k returns on its CPU backend as well.  -> (d [q,k]
    f32 ascending, ids [q,k] int32 chunk-space rows)."""
    q = slot_of.shape[0]
    g = packed.reshape(-1, 4 * KP)[slot_of.reshape(-1).long()].reshape(q, nprobe, 4 * KP)
    cat_d = g[:, :, :2 * KP].reshape(q, nprobe * 2 * KP)
    cat_i = g[:, :, 2 * KP:].reshape(q, nprobe * 2 * KP).view(torch.int32)
    d, sel = smallest_k(cat_d, k)
    return d, torch.gather(cat_i, 1, sel)


def merge_fold(facc, q: int, k: int, fs: int = FS):
    """Fold accumulator [rows, 2*fs*KP] -> (d [q,k], ids [q,k] int32): one
    exact stable top-k over the fs*KP slots of each query row."""
    vals = facc[:q, :fs * KP]
    ids = facc[:q, fs * KP:].view(torch.int32)
    d, sel = smallest_k(vals, k)
    return d, torch.gather(ids, 1, sel)


# ----------------------------------------------------------------- plan maps


def visit_steps(step_visit: torch.Tensor, n_visits: int):
    """(first step [V] int32, step count [V] int32) of every visit, from the
    plan's step_visit [S+1] (consecutive per visit, -1 sentinel).  Visits
    with no steps get count 0."""
    s = step_visit.shape[0] - 1
    sv = step_visit[:s].long()
    idx = torch.arange(s, dtype=torch.long, device=sv.device)
    first = torch.full((n_visits,), s, dtype=torch.long, device=sv.device)
    first.scatter_reduce_(0, sv, idx, "amin")
    count = torch.bincount(sv, minlength=n_visits)[:n_visits]
    return first.to(torch.int32), count.to(torch.int32)


def fold_index(qidx: torch.Tensor, vcount: torch.Tensor, nq: int):
    """Each query's visit rows in ascending visit id: (order [V*QTK] int32
    flat visit-row slots grouped by query, start [nq] int32, count [nq]
    int32).  Rows of the dump query nq and of visits with no steps are
    left out (the TPU grid never folds a visit it does not step through)."""
    flat = qidx.reshape(-1).long()
    live = (flat < nq) & (vcount.long().repeat_interleave(qidx.shape[1]) > 0)
    key = torch.where(live, flat, torch.full_like(flat, nq))
    order = torch.sort(key, stable=True).indices
    count = torch.bincount(key, minlength=nq + 1)[:nq]
    start = torch.cumsum(count, 0) - count
    return order.to(torch.int32), start.to(torch.int32), count.to(torch.int32)


# ----------------------------------------------------------- plain versions


def _top2_lex(vals: torch.Tensor, ids: torch.Tensor, dim: int):
    """Lexicographic (value, position) top-2 along dim, as a sequential
    strict-< best/second-best ladder from (BIG, 0) keeps it: a candidate at
    BIG never displaces the initial (BIG, 0)."""
    v, pos = torch.sort(vals, dim=dim, stable=True)
    v = v.narrow(dim, 0, 2)
    a = torch.gather(ids, dim, pos.narrow(dim, 0, 2))
    a = torch.where(v < _BIG, a, torch.zeros_like(a))
    return v, a


def _pq_rows(packed_words: torch.Tensor, cent2d: torch.Tensor, m: int):
    """[S, mp, chk] byte-packed codes (code j in byte j%4 of word j//4) and
    the int8 codebook cent2d [m*ksub, dsub] -> int8 rows [S, chk, m*dsub]."""
    ksub = cent2d.shape[0] // m
    parts = []
    for j in range(m):
        code = (packed_words[:, j // 4, :] >> (8 * (j % 4))) & 255   # [S, chk]
        parts.append(cent2d[j * ksub + code.long()])                  # [S, chk, dsub]
    return torch.cat(parts, dim=-1)


def _step_states(step_chunk, step_visit, qsteps, rows_of, rnC, ratio2, chk):
    """Per-step windowed top-2 of every step: (v [S, QTK, KP, 2], a [...])
    with args in chunk-space rows.  rows_of(chunks) -> int8 rows [s, chk, D]."""
    dev = qsteps.device
    s_all = step_chunk.shape[0]
    lane = torch.arange(KP, dtype=torch.int32, device=dev)
    win = torch.arange(chk // KP, dtype=torch.int32, device=dev)
    col = (win[:, None] * KP + lane[None, :])                        # [W, KP]
    out_v = torch.full((s_all, QTK, KP, 2), _BIG, dtype=torch.float32, device=dev)
    out_a = torch.zeros((s_all, QTK, KP, 2), dtype=torch.int32, device=dev)
    # a chunk of empty rows (3.4e38 norms: the dump chunk, plan padding)
    # scores 3.4e38 everywhere and leaves the fresh state as it is
    live = torch.nonzero((rnC < _BIG).any(dim=1)[step_chunk.long()]).squeeze(1)
    for s0 in range(0, live.numel(), _STEP_BATCH):
        st = live[s0:s0 + _STEP_BATCH]
        ch = step_chunk[st].long()
        q = qsteps[step_visit[st].long()].to(torch.float32)          # [s, QTK, D]
        r = rows_of(ch).to(torch.float32)                            # [s, chk, D]
        dot = torch.bmm(q, r.transpose(1, 2))                        # exact integers
        sc = fused_score(rnC[ch][:, None, :], ratio2, dot)           # [s, QTK, chk]
        sc = sc.reshape(ch.shape[0], QTK, chk // KP, KP)
        ids = (ch.to(torch.int32)[:, None, None] * chk + col)[:, None].expand_as(sc)
        v, a = _top2_lex(sc, ids, dim=2)                             # [s, QTK, 2, KP]
        out_v[st] = v.transpose(2, 3)
        out_a[st] = a.transpose(2, 3)
    return out_v, out_a


def _visit_states(step_chunk, step_visit, qsteps, rows_of, rnC, ratio2, chk):
    """Each visit's state over all its steps: (v [V, QTK, KP, 2], a)."""
    n_visits = qsteps.shape[0]
    dev = qsteps.device
    sv, sa = _step_states(step_chunk, step_visit, qsteps, rows_of, rnC, ratio2, chk)
    first, count = visit_steps(step_visit, n_visits)
    v = torch.full((n_visits, QTK, KP, 2), _BIG, dtype=torch.float32, device=dev)
    a = torch.zeros((n_visits, QTK, KP, 2), dtype=torch.int32, device=dev)
    for t in range(int(count.max()) if n_visits else 0):
        live = torch.nonzero(count > t).squeeze(1)
        st = (first[live] + t).long()
        # the visit's state so far, then step t: earlier positions first
        cv, ca = _top2_lex(torch.cat([v[live], sv[st]], dim=3),
                           torch.cat([a[live], sa[st]], dim=3), dim=3)
        v[live], a[live] = cv, ca
    return v, a, count


def _pack(v: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """(v, a) [V, QTK, KP, 2] -> packed [V, QTK, 4*KP]."""
    af = a.contiguous().view(torch.float32)
    return torch.cat([v[..., 0], v[..., 1], af[..., 0], af[..., 1]], dim=2).contiguous()


def _insert_sorted(sv, si, cv, ci):
    """The TPU's insert ladder (strict '<', the displaced slot moves on):
    not a stable sort, since a displaced slot that ties the next one swaps
    places with it."""
    for j in range(len(sv)):
        take = cv < sv[j]
        sv[j], cv = torch.where(take, cv, sv[j]), torch.where(take, sv[j], cv)
        si[j], ci = torch.where(take, ci, si[j]), torch.where(take, si[j], ci)


def _fold(v, a, count, qidx, nq: int, fs: int = FS):
    """Fold every stepped visit's state into the per-query accumulator, the
    visits of each query in ascending visit id, best then second-best, as
    the TPU's grid folds them."""
    dev = v.device
    rows = fold_rows(nq)
    order, start, cnt = fold_index(qidx, count, nq)
    vf = v.reshape(-1, KP, 2)
    af = a.reshape(-1, KP, 2)
    sv = [torch.full((nq, KP), _BIG, dtype=torch.float32, device=dev) for _ in range(fs)]
    si = [torch.zeros((nq, KP), dtype=torch.int32, device=dev) for _ in range(fs)]
    for t in range(int(cnt.max()) if nq else 0):
        live = torch.nonzero(cnt > t).squeeze(1)
        slot = order[start[live].long() + t].long()
        lv = [x[live] for x in sv]
        li = [x[live] for x in si]
        for b in range(2):
            _insert_sorted(lv, li, vf[slot, :, b], af[slot, :, b])
        for j in range(fs):
            sv[j][live], si[j][live] = lv[j], li[j]
    facc = torch.full((rows, 2 * fs * KP), _BIG, dtype=torch.float32, device=dev)
    facc[:, fs * KP:] = 0.0
    if nq:
        facc[:nq, :fs * KP] = torch.cat(sv, dim=1)
        facc[:nq, fs * KP:] = torch.cat(si, dim=1).view(torch.float32)
    return facc


def _int8_rows(codesC):
    return lambda ch: codesC[ch]


def _pq_rows_of(packedC, cent2d, m):
    return lambda ch: _pq_rows(packedC[ch], cent2d, m)


def ivf_chunk_scan_int8_reference(step_chunk, step_visit, qsteps, codesC, rnC,
                                  ratio2: float, chk: int = CHK):
    """Plain version of the packed int8 scan.  step_chunk [S] int32,
    step_visit [S+1] int32, qsteps [V, QTK, D] int8, codesC [n_chunks, chk,
    D] int8 (dump chunk all zero), rnC [n_chunks, chk] fp32 (3.4e38 on empty
    rows) -> packed [V, QTK, 4*KP] fp32."""
    v, a, _ = _visit_states(step_chunk, step_visit, qsteps, _int8_rows(codesC),
                            rnC, ratio2, chk)
    return _pack(v, a)


def ivf_chunk_scan_int8_fold_reference(step_chunk, step_visit, qidx, qsteps, codesC,
                                       rnC, ratio2: float, nq: int, chk: int = CHK):
    """Plain version of the fold int8 scan: as the packed scan plus qidx
    [V, QTK] int32 -> accumulator [fold_rows(nq), 2*FS*KP] fp32.  Rows from
    nq on hold (BIG, 0)."""
    v, a, count = _visit_states(step_chunk, step_visit, qsteps, _int8_rows(codesC),
                                rnC, ratio2, chk)
    return _fold(v, a, count, qidx, nq)


def ivf_chunk_scan_pq_reference(step_chunk, step_visit, qsteps, packedC, rnC, cent2d,
                                ratio2: float, m: int, chk: int = CHK):
    """Plain version of the packed PQ scan: the rows are rebuilt from
    packedC [n_chunks, ceil(m/4), chk] int32 byte-packed codes through the
    int8 codebook cent2d [m*ksub, dsub]; the rest as the int8 scan."""
    v, a, _ = _visit_states(step_chunk, step_visit, qsteps,
                            _pq_rows_of(packedC, cent2d, m), rnC, ratio2, chk)
    return _pack(v, a)


def ivf_chunk_scan_pq_fold_reference(step_chunk, step_visit, qidx, qsteps, packedC,
                                     rnC, cent2d, ratio2: float, m: int, nq: int,
                                     chk: int = CHK):
    """Plain version of the fold PQ scan."""
    v, a, count = _visit_states(step_chunk, step_visit, qsteps,
                                _pq_rows_of(packedC, cent2d, m), rnC, ratio2, chk)
    return _fold(v, a, count, qidx, nq)


# ------------------------------------------------------------------ wrappers


def _check_plan(step_chunk, step_visit, qsteps, rnC, chk):
    if step_chunk.dtype != torch.int32 or step_visit.dtype != torch.int32:
        raise TypeError("step_chunk and step_visit must be int32")
    if qsteps.dtype != torch.int8 or rnC.dtype != torch.float32:
        raise TypeError(f"qsteps int8 and rnC fp32 expected, got {qsteps.dtype}, {rnC.dtype}")
    if step_visit.shape[0] != step_chunk.shape[0] + 1:
        raise ValueError("step_visit must have one entry more than step_chunk")
    if qsteps.dim() != 3 or qsteps.shape[1:] != (QTK, D):
        raise ValueError(f"qsteps must be [V, {QTK}, {D}], got {tuple(qsteps.shape)}")
    if chk != CHK or rnC.dim() != 2 or rnC.shape[1] != CHK:
        raise ValueError(f"the scans take chunks of {CHK} rows; rnC {tuple(rnC.shape)}")


def _device_of(*ts) -> torch.device:
    dev = ts[0].device
    if any(t.device != dev for t in ts):
        raise ValueError(f"inputs on different devices: {[str(t.device) for t in ts]}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _check_pq(packedC, cent2d, m: int):
    if packedC.dtype != torch.int32 or cent2d.dtype != torch.int8:
        raise TypeError(f"packedC int32 and cent2d int8 expected, got "
                        f"{packedC.dtype}, {cent2d.dtype}")
    ksub = cent2d.shape[0] // max(m, 1)
    if (m < 1 or D % m or cent2d.dim() != 2 or cent2d.shape[0] != m * ksub
            or cent2d.shape[1] * m != D or ksub > 256):
        raise ValueError(f"m={m} and cent2d {tuple(cent2d.shape)}: need m dividing "
                         f"{D}, cent2d [m*ksub, {D}/m], ksub <= 256")
    if packedC.dim() != 3 or packedC.shape[1] != -(-m // 4) or packedC.shape[2] != CHK:
        raise ValueError(f"packedC must be [n_chunks, {-(-m // 4)}, {CHK}], "
                         f"got {tuple(packedC.shape)}")
    return ksub


def _pq_aligned(packedC, rnC, cent2d):
    """The PQ scans' codes, norms and codebook, contiguous and 16-byte
    aligned: the kernel copies them in 16-byte pieces."""
    return tuple(aligned16(t.contiguous()) for t in (packedC, rnC, cent2d))


def _launch_args(step_chunk, step_visit, qsteps):
    """Contiguous plan tensors and the per-visit step ranges."""
    first, count = visit_steps(step_visit, qsteps.shape[0])
    return (step_chunk.contiguous(), first.contiguous(), count.contiguous(),
            qsteps.contiguous())


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def ivf_chunk_scan_int8(step_chunk, step_visit, qsteps, codesC, rnC, ratio2: float,
                        chk: int = CHK):
    """The packed int8 scan: csrc/ivf_chunk.cu on CUDA tensors, the plain
    version on CPU tensors.  Contract of ivf_chunk_scan_int8_reference."""
    _check_plan(step_chunk, step_visit, qsteps, rnC, chk)
    if codesC.dtype != torch.int8 or codesC.dim() != 3 or codesC.shape[1:] != (CHK, D):
        raise ValueError(f"codesC must be int8 [n_chunks, {CHK}, {D}]")
    dev = _device_of(step_chunk, step_visit, qsteps, codesC, rnC)
    if dev.type == "cpu":
        return ivf_chunk_scan_int8_reference(step_chunk, step_visit, qsteps, codesC,
                                             rnC, ratio2, chk)
    sc, first, count, qs = _launch_args(step_chunk, step_visit, qsteps)
    out = torch.empty((qs.shape[0], QTK, 4 * KP), dtype=torch.float32, device=dev)
    if qs.shape[0] == 0:
        return out
    # the int8 scan reads rows and norms in 16-byte pieces
    codesC, rnC = aligned16(codesC.contiguous()), aligned16(rnC.contiguous())
    with torch.cuda.device(dev):
        kernels.IVF_CHUNK_INT8.launch(
            sc.data_ptr(), first.data_ptr(), count.data_ptr(), qs.data_ptr(),
            codesC.data_ptr(), rnC.data_ptr(), out.data_ptr(), qs.shape[0],
            float(ratio2), _stream(dev))
    return out


def _fold_launch(kernel, dev, nq, qidx, count, scan_args, tail_args):
    order, start, cnt = fold_index(qidx, count, nq)
    rows = fold_rows(nq)
    v = qidx.shape[0]
    scratch = torch.empty((v, QTK, 4 * KP), dtype=torch.float32, device=dev)
    facc = torch.empty((rows, 2 * FS * KP), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        kernel.launch(*scan_args, order.data_ptr(), start.data_ptr(), cnt.data_ptr(),
                      scratch.data_ptr(), facc.data_ptr(), v, nq, rows, *tail_args,
                      _stream(dev))
    return facc


def ivf_chunk_scan_int8_fold(step_chunk, step_visit, qidx, qsteps, codesC, rnC,
                             ratio2: float, nq: int, chk: int = CHK):
    """The fold int8 scan: csrc/ivf_chunk.cu (scan, then the fold pass) on
    CUDA tensors, the plain version on CPU tensors."""
    _check_plan(step_chunk, step_visit, qsteps, rnC, chk)
    if codesC.dtype != torch.int8 or codesC.dim() != 3 or codesC.shape[1:] != (CHK, D):
        raise ValueError(f"codesC must be int8 [n_chunks, {CHK}, {D}]")
    if qidx.dtype != torch.int32 or qidx.shape != (qsteps.shape[0], QTK):
        raise ValueError(f"qidx must be int32 [{qsteps.shape[0]}, {QTK}]")
    dev = _device_of(step_chunk, step_visit, qidx, qsteps, codesC, rnC)
    if dev.type == "cpu":
        return ivf_chunk_scan_int8_fold_reference(step_chunk, step_visit, qidx, qsteps,
                                                  codesC, rnC, ratio2, nq, chk)
    sc, first, count, qs = _launch_args(step_chunk, step_visit, qsteps)
    codesC, rnC = aligned16(codesC.contiguous()), aligned16(rnC.contiguous())
    return _fold_launch(
        kernels.IVF_CHUNK_INT8_FOLD, dev, nq, qidx, count,
        (sc.data_ptr(), first.data_ptr(), count.data_ptr(), qs.data_ptr(),
         codesC.data_ptr(), rnC.data_ptr()),
        (float(ratio2),))


def ivf_chunk_scan_pq(step_chunk, step_visit, qsteps, packedC, rnC, cent2d,
                      ratio2: float, m: int, chk: int = CHK):
    """The packed PQ scan: csrc/ivf_chunk.cu on CUDA tensors, the plain
    version on CPU tensors.  Contract of ivf_chunk_scan_pq_reference."""
    _check_plan(step_chunk, step_visit, qsteps, rnC, chk)
    ksub = _check_pq(packedC, cent2d, m)
    dev = _device_of(step_chunk, step_visit, qsteps, packedC, rnC, cent2d)
    if dev.type == "cpu":
        return ivf_chunk_scan_pq_reference(step_chunk, step_visit, qsteps, packedC,
                                           rnC, cent2d, ratio2, m, chk)
    sc, first, count, qs = _launch_args(step_chunk, step_visit, qsteps)
    out = torch.empty((qs.shape[0], QTK, 4 * KP), dtype=torch.float32, device=dev)
    if qs.shape[0] == 0:
        return out
    packedC, rnC, cent2d = _pq_aligned(packedC, rnC, cent2d)
    with torch.cuda.device(dev):
        kernels.IVF_CHUNK_PQ.launch(
            sc.data_ptr(), first.data_ptr(), count.data_ptr(), qs.data_ptr(),
            packedC.data_ptr(), rnC.data_ptr(), cent2d.data_ptr(), out.data_ptr(),
            qs.shape[0], float(ratio2), m, ksub, _stream(dev))
    return out


def ivf_chunk_scan_pq_fold(step_chunk, step_visit, qidx, qsteps, packedC, rnC, cent2d,
                           ratio2: float, m: int, nq: int, chk: int = CHK):
    """The fold PQ scan: csrc/ivf_chunk.cu (scan, then the fold pass) on
    CUDA tensors, the plain version on CPU tensors."""
    _check_plan(step_chunk, step_visit, qsteps, rnC, chk)
    ksub = _check_pq(packedC, cent2d, m)
    if qidx.dtype != torch.int32 or qidx.shape != (qsteps.shape[0], QTK):
        raise ValueError(f"qidx must be int32 [{qsteps.shape[0]}, {QTK}]")
    dev = _device_of(step_chunk, step_visit, qidx, qsteps, packedC, rnC, cent2d)
    if dev.type == "cpu":
        return ivf_chunk_scan_pq_fold_reference(step_chunk, step_visit, qidx, qsteps,
                                                packedC, rnC, cent2d, ratio2, m, nq, chk)
    sc, first, count, qs = _launch_args(step_chunk, step_visit, qsteps)
    packedC, rnC, cent2d = _pq_aligned(packedC, rnC, cent2d)
    return _fold_launch(
        kernels.IVF_CHUNK_PQ_FOLD, dev, nq, qidx, count,
        (sc.data_ptr(), first.data_ptr(), count.data_ptr(), qs.data_ptr(),
         packedC.data_ptr(), rnC.data_ptr(), cent2d.data_ptr()),
        (float(ratio2), m, ksub))


def ivf_fold(states, step_visit, qidx, nq: int, index=None):
    """The fold pass alone over a packed scan's states [V, QTK, 4*KP]:
    csrc/ivf_chunk.cu's second pass on CUDA tensors, the plain fold on CPU
    tensors.  The fold scans run it after their scan; this entry times it
    alone.  index: fold_index(qidx, step counts, nq) when the caller has
    it (then only the kernel runs on the card).  -> accumulator
    [fold_rows(nq), 2*FS*KP] fp32."""
    v = states.shape[0]
    if states.dtype != torch.float32 or states.shape[1:] != (QTK, 4 * KP):
        raise ValueError(f"states must be fp32 [V, {QTK}, {4 * KP}]")
    if qidx.dtype != torch.int32 or qidx.shape != (v, QTK):
        raise ValueError(f"qidx must be int32 [{v}, {QTK}]")
    dev = _device_of(states, step_visit, qidx)
    if dev.type == "cpu":
        vals, args, vals2, args2 = unpack_scan(states)
        return _fold(torch.stack([vals, vals2], dim=3), torch.stack([args, args2], dim=3),
                     visit_steps(step_visit, v)[1], qidx, nq)
    if index is None:
        index = fold_index(qidx, visit_steps(step_visit, v)[1], nq)
    order, start, cnt = index
    rows = fold_rows(nq)
    states = states.contiguous()
    facc = torch.empty((rows, 2 * FS * KP), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        kernels.IVF_FOLD.launch(states.data_ptr(), order.data_ptr(), start.data_ptr(),
                                cnt.data_ptr(), facc.data_ptr(), nq, rows, _stream(dev))
    return facc
