# Copied from deepreadmapper_tpu/pipeline/paired.py, a JAX-free module; kept in step with it.
"""Paired-end resolution: pick the (R1, R2) candidate pair that forms a
proper FR pair, score it, and derive pair-aware per-end MAPQ.

The reference has no pairing at all (single FASTQ in, independent reads
out) even though its fixture reads carry wgsim `/1` pair suffixes.  Here
both ends run the normal single-end pipeline (search + rerank) and the
pairing step then chooses, per pair, the candidate combination that is
FR-oriented within the insert-size bound — which both fixes orientation
errors and disambiguates repeats: a repeat locus that ties on one end
almost never ties TOGETHER with the mate's locus.

Conventions: candidate ids are dense window ids (2*pos + strand); scores
are ASCENDING-better (callers negate SW scores).  Proper FR pair: ends on
opposite strands, the forward end not to the right of the reverse end,
outer distance within [min_isize, max_isize], same record.

Everything is vectorized over a block of pairs at once and blocks are
capped so the [B, k1, k2] temporaries stay bounded regardless of read
count (the single-end pipeline streams in bounded batches for the same
reason).
"""

from __future__ import annotations

import numpy as np

PAD_ID = -1

# [B, k1, k2] float64 is the biggest temporary; 64 MB at k=128
_BLOCK_ELEMS = 8_000_000


def _end_same_locus(ids: np.ndarray, chosen: np.ndarray, ref_len: int,
                    dense_off: np.ndarray | None) -> np.ndarray:
    """[n, k] bool: candidate is the SAME locus as this end's chosen
    placement (same strand, same record, within ref_len) — the same
    definition search.compute_mapq uses."""
    pos = ids >> 1
    cp = (chosen >> 1)[:, None]
    same = (np.abs(pos - cp) <= ref_len) & ((ids & 1) == (chosen & 1)[:, None])
    if dense_off is not None:
        rec = np.searchsorted(dense_off, pos, side="right") - 1
        crec = np.searchsorted(dense_off, np.maximum(chosen, 0) >> 1,
                               side="right") - 1
        same &= rec == crec[:, None]
    return same & (ids >= 0)


def resolve_pairs(
    ids1: np.ndarray,
    d1: np.ndarray,
    ids2: np.ndarray,
    d2: np.ndarray,
    read_len1: np.ndarray,
    read_len2: np.ndarray,
    max_isize: int,
    min_isize: int = 0,
    ref_len: int = 150,
    dense_off: np.ndarray | None = None,
) -> dict:
    """Choose the best proper pair per row from the two ends' candidate
    lists ([n, k] dense ids + ascending-better scores).

    Returns dict of arrays [n]: a_id / b_id (chosen primary per end —
    falls back to each end's own best when no proper pair exists),
    proper (bool), tlen (signed template length, R1 positive when R1 is
    the forward end), mapq1 / mapq2 (per-end pair-margin qualities: the
    margin to the best proper pair that places THIS end at a different
    locus — so a unique R1 keeps 60 even when its mate ties a tandem
    repeat, and vice versa; 0s when improper — callers fall back to
    single-end margins)."""
    ids1 = np.asarray(ids1, np.int64)
    ids2 = np.asarray(ids2, np.int64)
    d1 = np.asarray(d1, np.float64)
    d2 = np.asarray(d2, np.float64)
    l1 = np.asarray(read_len1, np.int64)
    l2 = np.asarray(read_len2, np.int64)
    n, k1 = ids1.shape
    k2 = ids2.shape[1]
    block = max(1, _BLOCK_ELEMS // max(k1 * k2, 1))

    out = {
        "a_id": np.empty(n, np.int64),
        "b_id": np.empty(n, np.int64),
        "proper": np.zeros(n, bool),
        "tlen": np.zeros(n, np.int64),
        "mapq1": np.zeros(n, np.int32),
        "mapq2": np.zeros(n, np.int32),
    }
    for s in range(0, n, block):
        e = min(s + block, n)
        _resolve_block(
            ids1[s:e], d1[s:e], ids2[s:e], d2[s:e], l1[s:e], l2[s:e],
            max_isize, min_isize, ref_len, dense_off, out, s,
        )
    return out


def rescue_mates(
    anchor_ids: np.ndarray,
    target_reads: list[str],
    anchor_lens: np.ndarray,
    genome: np.ndarray,
    max_isize: int,
    min_isize: int = 0,
    stride: int = 2,
    min_frac: float = 0.4,
    rec_bounds: np.ndarray | None = None,
    max_windows: int = 2048,
) -> tuple[np.ndarray, np.ndarray]:
    """BWA-style mate rescue: for each (anchored end, unplaced mate), scan
    the expected FR mate interval next to the anchor with the native
    Smith-Waterman scorer and return the best placement.

    anchor_ids: [n] dense ids of the anchored ends, in BASE coordinates
    (2*base_pos + strand).  target_reads: the unplaced mates (unwrapped
    strings, as sequenced).  Returns (ids [n], scores [n]): rescued BASE-
    coordinate ids (PAD_ID where nothing reached min_frac * mate_len
    SW score) and their SW scores.  rec_bounds ([n, 2]) clips each scan
    to the anchor's record.  All (read, window) SW pairs run as ONE
    native batch call.

    The reference cannot do this at all; BWA rescues exactly this way
    (SW over the mate window) — here the scan windows come straight from
    the genome byte array the pipeline already holds."""
    from deepreadmapper_tpu_torch import native

    anchor_ids = np.asarray(anchor_ids, np.int64)
    n = len(target_reads)
    out_ids = np.full(n, PAD_ID, np.int64)
    out_scores = np.zeros(n, np.int32)
    if not native.available() or n == 0:
        return out_ids, out_scores

    a_rows, b_rows, row_read, row_pos, row_strand = [], [], [], [], []
    for i, read in enumerate(target_reads):
        aid = int(anchor_ids[i])
        if aid < 0:
            continue
        p1 = aid >> 1
        lt = len(read)
        if aid & 1:  # anchor reverse -> mate forward, to the LEFT
            lo = p1 + int(anchor_lens[i]) - max_isize
            hi = min(p1 + int(anchor_lens[i]) - max(min_isize, 1), p1)
            strand = 0
            rb = read.encode()
        else:        # anchor forward -> mate reverse, to the RIGHT
            lo = max(p1 + max(min_isize, 1) - lt, p1)
            hi = p1 + max_isize - lt
            strand = 1
            # reverse windows hold revcomp(genome): the read matches the
            # FORWARD genome bytes after revcomp'ing the read itself
            rb = read.encode().translate(_RC_TABLE)[::-1]
        # the min/max clamps above keep the FR ordering invariant the
        # resolver enforces (forward end never right of the reverse end)
        glo = 0 if rec_bounds is None else int(rec_bounds[i, 0])
        ghi = genome.size if rec_bounds is None else int(rec_bounds[i, 1])
        lo = max(lo, glo)
        hi = min(hi, ghi - lt)
        if hi < lo:
            continue
        # never silently drop interval coverage: coarsen the stride so the
        # WHOLE mate interval is scanned within the window budget
        span = hi + 1 - lo
        eff = max(stride, -(-span // max_windows))
        positions = list(range(lo, hi + 1, eff))
        a = np.frombuffer(rb, np.uint8)
        for p in positions:
            a_rows.append(a)
            b_rows.append(genome[p: p + lt])
            row_read.append(i)
            row_pos.append(p)
            row_strand.append(strand)
    if not a_rows:
        return out_ids, out_scores
    aw = max(r.size for r in a_rows)
    bw = max(r.size for r in b_rows)
    m = len(a_rows)
    a_mat = np.zeros((m, aw), np.uint8)
    b_mat = np.zeros((m, bw), np.uint8)
    a_lens = np.empty(m, np.int64)
    b_lens = np.empty(m, np.int64)
    for j in range(m):
        a_mat[j, : a_rows[j].size] = a_rows[j]
        b_mat[j, : b_rows[j].size] = b_rows[j]
        a_lens[j] = a_rows[j].size
        b_lens[j] = b_rows[j].size
    scores, _a, _b, _c = native.sw_cigar(a_mat, a_lens, b_mat, b_lens,
                                         max_ops=1)
    row_read = np.asarray(row_read)
    row_pos = np.asarray(row_pos, np.int64)
    row_strand = np.asarray(row_strand, np.int64)
    for i in range(n):
        mask = row_read == i
        if not mask.any():
            continue
        s = scores[mask]
        j = int(np.argmax(s))
        if s[j] >= min_frac * len(target_reads[i]):
            out_ids[i] = 2 * int(row_pos[mask][j]) + int(row_strand[mask][j])
            out_scores[i] = int(s[j])
    return out_ids, out_scores


_RC_TABLE = bytes.maketrans(b"ACGTNacgtn", b"TGCANtgcan")


def _resolve_block(ids1, d1, ids2, d2, l1, l2, max_isize, min_isize,
                   ref_len, dense_off, out, base):
    n, k1 = ids1.shape
    k2 = ids2.shape[1]
    pos1 = ids1 >> 1
    pos2 = ids2 >> 1
    rev1 = (ids1 & 1).astype(bool)
    rev2 = (ids2 & 1).astype(bool)

    p1 = pos1[:, :, None]
    p2 = pos2[:, None, :]
    span12 = p2 + l2[:, None, None] - p1   # R1 forward, R2 reverse
    span21 = p1 + l1[:, None, None] - p2   # R2 forward, R1 reverse
    ok12 = (
        ~rev1[:, :, None] & rev2[:, None, :]
        & (p1 <= p2)                        # FR: forward end on the left
        & (span12 >= max(min_isize, 1)) & (span12 <= max_isize)
    )
    ok21 = (
        rev1[:, :, None] & ~rev2[:, None, :]
        & (p2 <= p1)
        & (span21 >= max(min_isize, 1)) & (span21 <= max_isize)
    )
    proper_mat = (ok12 | ok21) & (ids1 >= 0)[:, :, None] & (
        ids2 >= 0
    )[:, None, :]
    if dense_off is not None:
        r1 = np.searchsorted(dense_off, pos1, side="right") - 1
        r2 = np.searchsorted(dense_off, pos2, side="right") - 1
        proper_mat &= r1[:, :, None] == r2[:, None, :]

    score = np.where(proper_mat, d1[:, :, None] + d2[:, None, :], np.inf)
    flat = score.reshape(n, k1 * k2)
    best_flat = np.argmin(flat, axis=1)
    best_score = flat[np.arange(n), best_flat]
    bi = best_flat // k2
    bj = best_flat % k2
    proper = np.isfinite(best_score)

    a_id = np.where(proper, ids1[np.arange(n), bi], ids1[:, 0])
    b_id = np.where(proper, ids2[np.arange(n), bj], ids2[:, 0])

    # signed TLEN from R1's perspective (0 when improper)
    ap = a_id >> 1
    bp = b_id >> 1
    a_rev = (a_id & 1).astype(bool)
    tlen_abs = np.where(a_rev, ap + l1 - bp, bp + l2 - ap)
    tlen = np.where(proper, np.where(a_rev, -tlen_abs, tlen_abs), 0)

    # per-end pair MAPQ: margin to the best proper pair that places THIS
    # end at a DIFFERENT locus (same-locus test mirrors compute_mapq:
    # strand + record + ref_len window)
    same1 = _end_same_locus(ids1, a_id, ref_len, dense_off)
    same2 = _end_same_locus(ids2, b_id, ref_len, dense_off)
    for key, same_mask, axis_expand in (
        ("mapq1", same1, 2),
        ("mapq2", same2, 1),
    ):
        diff = ~same_mask
        comp = np.where(
            np.expand_dims(diff, axis_expand) & proper_mat, score, np.inf
        )
        second = comp.reshape(n, k1 * k2).min(axis=1)
        fin = np.isfinite(second) & proper
        ssafe = np.where(fin, second, 1.0)
        bsafe = np.where(proper, best_score, 0.0)
        margin = (ssafe - bsafe) / np.maximum(np.abs(ssafe), 1e-9)
        q = np.where(fin, np.clip(np.rint(60.0 * margin), 0, 60), 60.0)
        out[key][base: base + n] = np.where(proper, q, 0).astype(np.int32)

    out["a_id"][base: base + n] = a_id
    out["b_id"][base: base + n] = b_id
    out["proper"][base: base + n] = proper
    out["tlen"][base: base + n] = tlen.astype(np.int64)
