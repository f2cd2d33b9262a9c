# Copied from deepreadmapper_tpu/io/fasta.py, the JAX-free host layer; kept in step with it.
"""FASTA parsing + genome windowing, vectorized with numpy.

Replicates the behaviour of the reference's FASTA layer
(src/utils/parse_inputs.cpp):

* ``parse_fasta_records`` — per-record cleaned byte streams: only A/T/C/G/N
  survive, lowercase is uppercased, whitespace dropped; bytes before the first
  '>' header are discarded (format_fasta, parse_inputs.cpp:223-277).
* ``extract_fasta_sequence`` — skip ONLY the first line, then keep every
  [ACGTN] byte of the rest — including bytes inside later headers, a reference
  wart kept for parity (extract_FASTA_sequence, parse_inputs.cpp:174-220).
* windowing — per record with len >= ref_len, (len - ref_len)//stride + 1
  windows; each emits forward then reverse complement; label =
  (global_position << 1) | is_reverse with global_position advancing by
  ``stride`` per window and never resetting between records
  (format_fasta, parse_inputs.cpp:314-358).

Instead of materializing window strings, the hot path builds the byte matrix
consumed by the tokenizer directly from the genome array with a gather —
O(windows x 124) bytes, no string objects.
"""

from __future__ import annotations

import numpy as np

from deepreadmapper_tpu_torch.io.fileio import read_bytes, read_bytes_arr

_ACGTN = b"ACGTN"

# byte -> cleaned byte (uppercased) if in [ACGTNacgtn], else 0.
_CLEAN = np.zeros(256, dtype=np.uint8)
for _b in _ACGTN:
    _CLEAN[_b] = _b
    _CLEAN[_b + 32] = _b  # lowercase

# byte -> complement (A<->T, C<->G, N->N); other bytes -> 0, matching the
# reference comp_table which zero-initializes unknown entries
# (parse_inputs.cpp:5-14).
COMP = np.zeros(256, dtype=np.uint8)
for _a, _b in zip(b"ATCGN", b"TAGCN"):
    COMP[_a] = _b


def reverse_complement(seq: bytes | np.ndarray) -> np.ndarray:
    arr = np.frombuffer(seq, dtype=np.uint8) if isinstance(seq, bytes) else seq
    return COMP[arr[::-1]]


def _clean(arr: np.ndarray) -> np.ndarray:
    c = _CLEAN[arr]
    return c[c != 0]


def parse_fasta_records(path: str) -> list[np.ndarray]:
    """Cleaned per-record byte arrays (uint8, uppercase ACGTN only).

    The raw file rides a read-only memmap (read_bytes_arr) so parsing a
    3 Gbp reference peaks at ~1x genome host RAM (the cleaned copies),
    not 2x — the reference's mmap reader recast
    (src/utils/parse_inputs.cpp:117-162)."""
    data = read_bytes_arr(path)
    # Line starts: offset 0 plus every byte after a newline.
    nl = np.flatnonzero(data == ord("\n"))
    line_starts = np.concatenate(([0], nl + 1))
    line_starts = line_starts[line_starts < data.size]
    header_starts = line_starts[data[line_starts] == ord(">")]
    if header_starts.size == 0:
        return []  # reference yields nothing until the first '>' is seen
    # Header line extents.
    header_ends = np.searchsorted(nl, header_starts)
    records: list[np.ndarray] = []
    for i, hs in enumerate(header_starts):
        body_start = (nl[header_ends[i]] + 1) if header_ends[i] < nl.size else data.size
        body_end = header_starts[i + 1] if i + 1 < header_starts.size else data.size
        records.append(_clean(data[body_start:body_end]))
    return records


def parse_fasta_names(path: str) -> list[str]:
    """Record names (first token after '>') in file order, paired with
    parse_fasta_records — for multi-record SAM RNAME/@SQ emission."""
    names = []
    for line in read_bytes(path).split(b"\n"):
        if line.startswith(b">"):
            tok = line[1:].strip().split()
            names.append(tok[0].decode() if tok else f"ref{len(names)}")
    return names


def record_window_table(records, ref_len: int, stride: int = 1):
    """Per-record cumulative tables for the GLOBAL window-id space:
    (win_offsets [R+1] = cumulative window counts at this stride,
     base_offsets [R+1] = cumulative base counts).

    Window ids are assigned record-by-record (build order), so window index
    w belongs to record r = searchsorted(win_offsets, w, 'right')-1 and sits
    at concatenated-stream position base_offsets[r] +
    (w - win_offsets[r]) * stride.  For a single record this is the identity
    mapping the single-genome code paths assume.
    """
    wins = [num_windows(len(r), ref_len, stride) for r in records]
    lens = [len(r) for r in records]
    win_off = np.concatenate(([0], np.cumsum(wins))).astype(np.int64)
    base_off = np.concatenate(([0], np.cumsum(lens))).astype(np.int64)
    return win_off, base_off


def record_of(wid: np.ndarray, win_off: np.ndarray):
    """Global window index -> (record index r, record-local window index).
    The single id->record mapping shared by id translation, sparse
    expansion and SAM emission (negative wids clamp to record 0; callers
    mask invalid ids themselves)."""
    wid = np.asarray(wid, dtype=np.int64)
    r = np.searchsorted(win_off, np.maximum(wid, 0), side="right") - 1
    r = np.clip(r, 0, len(win_off) - 2)
    return r, wid - win_off[r]


def translate_window_ids(
    ids: np.ndarray,
    win_off: np.ndarray,
    base_off: np.ndarray,
    stride: int = 1,
) -> np.ndarray:
    """Dense ids (2*global_window_index | strand) -> ids addressed by
    CONCATENATED-record-stream position (2*pos | strand), so the
    single-array window fetchers work on multi-record references.
    Negative (invalid) ids pass through unchanged."""
    ids = np.asarray(ids, dtype=np.int64)
    r, loc = record_of(ids >> 1, win_off)
    pos = base_off[r] + loc * stride
    return np.where(ids >= 0, (pos << 1) | (ids & 1), ids)


def extract_fasta_sequence(path: str) -> np.ndarray:
    """Whole-file clean stream after skipping only the first line (the
    reference's dynamic-mode genome loader, parse_inputs.cpp:174-220)."""
    data = read_bytes_arr(path)
    nl = np.flatnonzero(data == ord("\n"))
    start = nl[0] + 1 if nl.size else data.size
    return _clean(data[start:])


def num_windows(record_len: int, ref_len: int, stride: int) -> int:
    if record_len < ref_len:
        return 0
    return (record_len - ref_len) // stride + 1


def window_positions(records: list[np.ndarray], ref_len: int, stride: int):
    """Per-record window start offsets + interleaved fwd/rev labels.

    Returns (per_record_positions, labels) where labels is the full
    interleaved [2 * total_windows] label array, label = (gpos<<1)|strand,
    gpos advancing by stride per window across ALL records.
    """
    per_record = []
    total = 0
    for rec in records:
        nw = num_windows(len(rec), ref_len, stride)
        per_record.append(np.arange(nw, dtype=np.int64) * stride)
        total += nw
    gpos = np.arange(total, dtype=np.int64) * stride
    labels = np.empty(2 * total, dtype=np.int64)
    labels[0::2] = gpos << 1
    labels[1::2] = (gpos << 1) | 1
    return per_record, labels


def window_byte_matrix(
    genome: np.ndarray,
    positions: np.ndarray,
    ref_len: int,
    max_len: int = 123,
    wrap: bool = True,
) -> tuple[np.ndarray, np.ndarray]:
    """Byte matrix of interleaved (forward, revcomp) windows, tokenizer-ready.

    Row layout matches the reference emission order: [w0 fwd, w0 rev, w1 fwd,
    w1 rev, ...] (parse_inputs.cpp:351-352).  Only the first max_len+1 chars of
    each (optionally '<'-wrapped) window are materialized — the tokenizer never
    reads further.

    Returns (mat [2*n, width], lengths [2*n]).
    """
    genome = np.ascontiguousarray(genome)
    n = positions.size
    glen = genome.size
    rc = COMP[genome[::-1]]  # full reverse-complemented genome
    rc_positions = glen - ref_len - positions  # rc of window p starts here in rc

    body = min(ref_len, max_len + 1 if not wrap else max_len)
    # Gather window bodies: [n, body]
    idx = positions[:, None] + np.arange(body, dtype=np.int64)[None, :]
    fwd_body = genome[idx]
    rc_idx = rc_positions[:, None] + np.arange(body, dtype=np.int64)[None, :]
    rev_body = rc[rc_idx]

    if wrap:
        width = min(ref_len + 2, max_len + 1)
        mat = np.zeros((2 * n, width), dtype=np.uint8)
        mat[:, 0] = ord("<")
        take = min(body, width - 1)
        mat[0::2, 1 : 1 + take] = fwd_body[:, :take]
        mat[1::2, 1 : 1 + take] = rev_body[:, :take]
        if ref_len + 2 <= max_len + 1:
            mat[:, ref_len + 1] = ord(">")
        lengths = np.full(2 * n, ref_len + 2, dtype=np.int64)
    else:
        width = min(ref_len, max_len + 1)
        mat = np.empty((2 * n, width), dtype=np.uint8)
        mat[0::2] = fwd_body[:, :width]
        mat[1::2] = rev_body[:, :width]
        lengths = np.full(2 * n, ref_len, dtype=np.int64)
    return mat, lengths


def fetch_windows_by_id(
    genome: np.ndarray,
    ids: np.ndarray,
    ref_len: int,
    max_len: int = 123,
    wrap: bool = False,
) -> tuple[np.ndarray, np.ndarray]:
    """Byte matrix for arbitrary dense window ids (2*pos | strand).

    The candidate-fetch primitive behind the reference's find_sequence
    (post_processor.cpp:47-66): id//2 is the genome position, odd ids are the
    reverse complement.  Default unwrapped (lookup-mode), matching how the
    reference re-embeds candidates.  Ids whose window would run past the
    genome end are returned as all-zero rows (the reference returns "" and
    later hits UB tokenizing it; callers should mask such ids beforehand).
    """
    genome = np.ascontiguousarray(genome)
    glen = genome.size
    ids = np.asarray(ids, dtype=np.int64)
    pos = ids >> 1
    strand = (ids & 1).astype(bool)
    ok = (pos >= 0) & (pos + ref_len <= glen)
    safe_pos = np.where(ok, pos, 0)
    rc = COMP[genome[::-1]]
    body = min(ref_len, max_len if wrap else max_len + 1)
    offs = np.arange(body, dtype=np.int64)[None, :]
    fwd = genome[safe_pos[:, None] + offs]
    rcp = glen - ref_len - safe_pos
    rev = rc[rcp[:, None] + offs]
    sel = np.where(strand[:, None], rev, fwd)
    sel[~ok] = 0
    if wrap:
        width = min(ref_len + 2, max_len + 1)
        mat = np.zeros((ids.size, width), dtype=np.uint8)
        mat[:, 0] = ord("<")
        take = min(body, width - 1)
        mat[:, 1 : 1 + take] = sel[:, :take]
        if ref_len + 2 <= max_len + 1:
            mat[:, ref_len + 1] = ord(">")
        mat[~ok] = 0
        lengths = np.full(ids.size, ref_len + 2, dtype=np.int64)
    else:
        mat = sel[:, : min(ref_len, max_len + 1)]
        lengths = np.full(ids.size, ref_len, dtype=np.int64)
    return mat, lengths


def windows_as_strings(
    records: list[np.ndarray], ref_len: int, stride: int, lookup_mode: bool = False
) -> tuple[list[str], np.ndarray]:
    """Materialize window strings in reference order (format_fasta parity).

    With lookup_mode=True windows are unwrapped (the pipeline's static
    reference lookup, main.cpp:190); otherwise '<'-wrapped.
    """
    out: list[str] = []
    for rec in records:
        nw = num_windows(len(rec), ref_len, stride)
        b = rec.tobytes()
        for i in range(nw):
            p = i * stride
            w = b[p : p + ref_len]
            r = COMP[rec[p : p + ref_len]][::-1].tobytes()
            if lookup_mode:
                out.append(w.decode())
                out.append(r.decode())
            else:
                out.append("<" + w.decode() + ">")
                out.append("<" + r.decode() + ">")
    _, labels = window_positions(records, ref_len, stride)
    return out, labels
