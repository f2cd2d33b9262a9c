# Copied from deepreadmapper_tpu/native.py, the JAX-free host layer; kept in step with it.
"""ctypes bindings for the native C++ data loader (native/drm_native.cpp).

Self-bootstrapping: compiles the shared library with g++ on first use if the
.so is missing (the repo ships source, not binaries).  Every entry point has
a pure-numpy fallback in io/fasta.py + tokenizer.py; `available()` gates use.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile

import numpy as np

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "native", "drm_native.cpp")
# The ABI version is part of the filename: dlopen caches by path, so
# rebuilding over an already-loaded path silently returns the stale handle
# (glibc never unloads it).  A version bump makes the old binary invisible.
_ABI_VERSION = 5

_lib = None
_tried = False


_SRC_HNSW = os.path.join(os.path.dirname(_SRC), "drm_hnsw.cpp")
_CXX_FLAGS = ("-O3", "-march=native", "-fopenmp", "-shared", "-fPIC")


def _so_path() -> str:
    """The port's own library, in its git-ignored _build/ directory; the
    name carries the ABI version and a hash of the sources and flags."""
    h = hashlib.sha256(" ".join(_CXX_FLAGS).encode())
    for src in (_SRC, _SRC_HNSW):
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build",
                        f"drm_native_v{_ABI_VERSION}-{h.hexdigest()[:16]}.so")


def _build(so: str) -> bool:
    os.makedirs(os.path.dirname(so), exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(so))
    os.close(fd)
    cmd = ["g++", *_CXX_FLAGS, _SRC, _SRC_HNSW, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=300)
        os.replace(tmp, so)  # atomic: a concurrent loader never sees half a file
        return True
    except Exception:
        return False
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _load():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not os.path.exists(_SRC):
        return None
    so = _so_path()
    if not os.path.exists(so) and not _build(so):
        return None
    try:
        lib = ctypes.CDLL(so)
    except OSError:
        return None
    lib.drm_version.restype = ctypes.c_int32
    if lib.drm_version() != _ABI_VERSION:
        # Shouldn't happen (version is in the filename); numpy fallback.
        return None
    c_i64 = ctypes.c_int64
    c_i32 = ctypes.c_int32
    p_u8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    p_i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    p_i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    lib.drm_clean_fasta.restype = c_i64
    lib.drm_clean_fasta.argtypes = [p_u8, c_i64, p_u8, p_i64, c_i64]
    lib.drm_tokenize_windows.restype = None
    lib.drm_tokenize_windows.argtypes = [p_u8, c_i64, c_i64, c_i64, c_i64, c_i64, p_i32, c_i32]
    lib.drm_tokenize_seqs.restype = None
    lib.drm_tokenize_seqs.argtypes = [p_u8, c_i64, c_i64, p_i64, p_i32, c_i32]
    lib.drm_tokenize_windows_by_id.restype = None
    lib.drm_tokenize_windows_by_id.argtypes = [p_u8, c_i64, c_i64, p_i64, c_i64, c_i32, p_i32, c_i32]
    p_f32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    lib.drm_hnsw_build.restype = c_i32
    lib.drm_hnsw_build.argtypes = [
        p_f32, c_i64, c_i64, p_i32, c_i32, c_i32, c_i32, c_i32, p_i32, p_i32,
    ]
    lib.drm_pack_wrapped.restype = None
    lib.drm_pack_wrapped.argtypes = [p_u8, c_i64, c_i64, p_i64, p_u8]
    lib.drm_pack_windows.restype = None
    lib.drm_pack_windows.argtypes = [p_u8, c_i64, c_i64, c_i64, c_i64, c_i64, p_u8]
    lib.drm_unpack_ids.restype = None
    lib.drm_unpack_ids.argtypes = [p_u8, c_i64, c_i64, c_i64, c_i32, p_i64]
    lib.drm_sw_cigar.restype = None
    lib.drm_sw_cigar.argtypes = [
        p_u8, p_i64, c_i64,       # a_mat, a_lens, a_width
        p_u8, p_i64, c_i64,       # b_mat, b_lens, b_width
        c_i64,                    # n
        p_i32, p_i32, p_i32, p_i32, p_i32,  # scores, a_start/end, b_start/end
        p_u8, p_i32, p_i32,       # cigar_ops, cigar_lens, n_ops
        c_i64,                    # max_ops
    ]
    lib.drm_pack_windows_by_id.restype = None
    lib.drm_pack_windows_by_id.argtypes = [p_u8, c_i64, c_i64, p_i64, c_i64, p_u8]
    lib.drm_banded_cigar.argtypes = [
        p_u8, p_i64, c_i64,       # a_mat, a_lens, a_width
        p_u8, p_i64, c_i64,       # b_mat, b_lens, b_width
        c_i64, c_i32,             # n, band
        p_i32, p_i32, p_i32, p_i32, p_i32,  # scores, a_start/end, b_start/end
        p_u8, p_i32, p_i32,       # cigar_ops, cigar_lens, n_ops
        c_i64,                    # max_ops
    ]
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def clean_fasta(data: np.ndarray, max_records: int = 1 << 20):
    """Returns list of cleaned record byte arrays."""
    lib = _load()
    out = np.empty(data.size, dtype=np.uint8)
    ends = np.empty(max_records, dtype=np.int64)
    n = lib.drm_clean_fasta(np.ascontiguousarray(data), data.size, out, ends, max_records)
    if n < 0:
        raise ValueError("too many FASTA records")
    recs = []
    start = 0
    for i in range(n):
        recs.append(out[start : ends[i]].copy())
        start = ends[i]
    return recs


def tokenize_windows(
    genome: np.ndarray, ref_len: int, stride: int, first: int, n: int,
    max_len: int = 123,
) -> np.ndarray:
    """Interleaved (fwd, rev) token rows [2n, max_len] for windows
    [first, first+n) — fused windowing+revcomp+tokenize, OpenMP-parallel."""
    lib = _load()
    out = np.empty((2 * n, max_len), dtype=np.int32)
    lib.drm_tokenize_windows(
        np.ascontiguousarray(genome), genome.size, ref_len, stride, first, n,
        out, max_len,
    )
    return out


def tokenize_seqs(mat: np.ndarray, lengths: np.ndarray, max_len: int = 123) -> np.ndarray:
    lib = _load()
    mat = np.ascontiguousarray(mat)
    out = np.empty((mat.shape[0], max_len), dtype=np.int32)
    lib.drm_tokenize_seqs(
        mat, mat.shape[0], mat.shape[1],
        np.ascontiguousarray(lengths, dtype=np.int64), out, max_len,
    )
    return out


def hnsw_build(
    vectors: np.ndarray,
    levels: np.ndarray,
    m: int,
    efc: int,
    threads: int | None = None,
):
    """Native HNSW construction.  Returns (neighbors0 [n,2m] int32,
    upper [sum nl, m] int32 global ids, entry_gid)."""
    lib = _load()
    v = np.ascontiguousarray(vectors, dtype=np.float32)
    lv = np.ascontiguousarray(levels, dtype=np.int32)
    n = v.shape[0]
    max_level = int(lv.max(initial=0))
    n_upper = int(sum((lv >= l).sum() for l in range(1, max_level + 1)))
    neighbors0 = np.full((n, 2 * m), -1, dtype=np.int32)
    upper = np.full((max(n_upper, 1), m), -1, dtype=np.int32)
    if threads is None:
        threads = os.cpu_count() or 1
    entry = lib.drm_hnsw_build(
        v, n, v.shape[1], lv, max_level, m, efc, threads, neighbors0, upper
    )
    return neighbors0, upper, int(entry)


def pack_wrapped(mat: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """Wrapped byte rows -> 48-byte wire rows (tokenizer_device format)."""
    lib = _load()
    mat = np.ascontiguousarray(mat)
    wire = np.empty((mat.shape[0], 48), dtype=np.uint8)
    lib.drm_pack_wrapped(
        mat, mat.shape[0], mat.shape[1],
        np.ascontiguousarray(lengths, dtype=np.int64), wire,
    )
    return wire


def pack_windows(
    genome: np.ndarray, ref_len: int, stride: int, first: int, n: int
) -> np.ndarray:
    """Interleaved (fwd, rev) wire rows [2n, 48] for genome windows
    [first, first+n) — fused windowing+revcomp+2-bit packing."""
    lib = _load()
    wire = np.empty((2 * n, 48), dtype=np.uint8)
    lib.drm_pack_windows(
        np.ascontiguousarray(genome), genome.size, ref_len, stride, first, n,
        wire,
    )
    return wire


def pack_windows_by_id(
    genome: np.ndarray, ref_len: int, ids: np.ndarray
) -> np.ndarray:
    """Dense-id window fetch -> wire rows [n, 48] (2*pos|strand ids)."""
    lib = _load()
    ids = np.ascontiguousarray(ids, dtype=np.int64)
    wire = np.empty((ids.size, 48), dtype=np.uint8)
    lib.drm_pack_windows_by_id(
        np.ascontiguousarray(genome), genome.size, ref_len, ids, ids.size, wire
    )
    return wire


def unpack_ids(packed: np.ndarray, k: int, nbits: int) -> np.ndarray:
    """Nibble-packed id rows -> int64 [n, k] (ops/pack wire format)."""
    lib = _load()
    packed = np.ascontiguousarray(packed, dtype=np.uint8)
    out = np.empty((packed.shape[0], k), dtype=np.int64)
    lib.drm_unpack_ids(packed, packed.shape[0], packed.shape[1], k, nbits, out)
    return out


def tokenize_windows_by_id(
    genome: np.ndarray, ref_len: int, ids: np.ndarray, wrap: bool = False,
    max_len: int = 123,
) -> np.ndarray:
    lib = _load()
    ids = np.ascontiguousarray(ids, dtype=np.int64)
    out = np.empty((ids.size, max_len), dtype=np.int32)
    lib.drm_tokenize_windows_by_id(
        np.ascontiguousarray(genome), genome.size, ref_len, ids, ids.size,
        1 if wrap else 0, out, max_len,
    )
    return out


_CIGAR_CHARS = "MID"


def sw_cigar(
    a_mat: np.ndarray,
    a_lens: np.ndarray,
    b_mat: np.ndarray,
    b_lens: np.ndarray,
    max_ops: int = 64,
):
    """Batched local Smith-Waterman WITH traceback (match +1 / mismatch -1 /
    gap -1, the reference scoring) — beyond-reference: real SAM CIGARs.

    a = reads (as sequenced), b = candidate windows, row-paired.  Returns
    (scores [n] int32, a_span [n, 2], b_span [n, 2] half-open aligned spans,
    cigars: list of M/I/D run strings over the aligned region, '' when the
    op list overflowed max_ops).
    """
    lib = _load()
    a_mat = np.ascontiguousarray(a_mat, dtype=np.uint8)
    b_mat = np.ascontiguousarray(b_mat, dtype=np.uint8)
    n = a_mat.shape[0]
    scores = np.empty(n, np.int32)
    a0 = np.empty(n, np.int32)
    a1 = np.empty(n, np.int32)
    b0 = np.empty(n, np.int32)
    b1 = np.empty(n, np.int32)
    ops = np.empty((n, max_ops), np.uint8)
    lens = np.empty((n, max_ops), np.int32)
    n_ops = np.empty(n, np.int32)
    lib.drm_sw_cigar(
        a_mat, np.ascontiguousarray(a_lens, np.int64), a_mat.shape[1],
        b_mat, np.ascontiguousarray(b_lens, np.int64), b_mat.shape[1],
        n, scores, a0, a1, b0, b1, ops, lens, n_ops, max_ops,
    )
    cigars = []
    for i in range(n):
        k = int(n_ops[i])
        cigars.append(
            "".join(f"{int(lens[i, j])}{_CIGAR_CHARS[ops[i, j]]}"
                    for j in range(k))
        )
    return scores, np.stack([a0, a1], 1), np.stack([b0, b1], 1), cigars


def banded_cigar(
    a_mat: np.ndarray,
    a_lens: np.ndarray,
    b_mat: np.ndarray,
    b_lens: np.ndarray,
    band: int,
    max_ops: int = 4096,
):
    """Banded local alignment WITH traceback for LONG reads (same +1/-1/-1
    scoring as sw_cigar).  b rows are genome segments starting ~`band`
    bases before each read's chained start, so the true diagonal sits
    mid-band and the DP is O(len * band) instead of O(len^2).

    Returns (scores, a_span, b_span, cigars) like sw_cigar; b_span is
    relative to the segment row."""
    lib = _load()
    a_mat = np.ascontiguousarray(a_mat, dtype=np.uint8)
    b_mat = np.ascontiguousarray(b_mat, dtype=np.uint8)
    n = a_mat.shape[0]
    scores = np.empty(n, np.int32)
    a0 = np.empty(n, np.int32)
    a1 = np.empty(n, np.int32)
    b0 = np.empty(n, np.int32)
    b1 = np.empty(n, np.int32)
    ops = np.empty((n, max_ops), np.uint8)
    lens = np.empty((n, max_ops), np.int32)
    n_ops = np.empty(n, np.int32)
    lib.drm_banded_cigar(
        a_mat, np.ascontiguousarray(a_lens, np.int64), a_mat.shape[1],
        b_mat, np.ascontiguousarray(b_lens, np.int64), b_mat.shape[1],
        n, band, scores, a0, a1, b0, b1, ops, lens, n_ops, max_ops,
    )
    cigars = []
    for i in range(n):
        k = int(n_ops[i])
        cigars.append(
            "".join(f"{int(lens[i, j])}{_CIGAR_CHARS[ops[i, j]]}"
                    for j in range(k))
        )
    return scores, np.stack([a0, a1], 1), np.stack([b0, b1], 1), cigars
