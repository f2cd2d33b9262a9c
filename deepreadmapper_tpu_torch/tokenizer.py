# Copied from deepreadmapper_tpu/tokenizer.py, the JAX-free host layer; kept in step with it.
"""Vectorized 3-mer tokenizer with exact parity to the reference.

The reference tokenizes a (usually ``<``-wrapped) DNA string into at most
``max_len`` = 123 token ids drawn from a 96-entry vocabulary at word2vec ids
7542-7637 (reference: src/inference/preprocess.cpp:20-42,
includes/inference/preprocess.hpp:10-49, src/utils/tok2index.cpp:3-99).

Exact semantics reproduced here:

* ``char2Val``: a/c/g/t (either case) -> 0..3, every other byte -> 7.
* ``hashToken(c0,c1,c2)``:
    - c0 == '<'       -> (v1<<2) + v2                (prefix tokens, hash 0-15)
    - c2 == '>'       -> 16 + (v0<<2) + v1           (suffix tokens, hash 16-31)
    - otherwise       -> 32 + (v0<<4) + (v1<<2) + v2 (interior, hash 32-95)
* ``preprocess(seq, maxLen)`` with ``len = min(maxLen, |seq|)``:
    - result[0]       = id[hash('<', seq[0], seq[1])].  For wrapped input
      seq[0] is itself '<' (val 7), so result[0] = id[28 + val(seq[1])] — a
      deterministic quirk of the reference that we reproduce bit-for-bit.
    - result[t]       = id[hash(seq[t-1], seq[t], seq[t+1])] for t in 1..len-2.
    - result[len-1]   = id[hash(seq[len-2], seq[len-1], c2)] where c2 is
      seq[len] if the sequence extends past the truncation point, else '>'.

Divergence from the reference (documented, unavoidable): when a 3-mer contains
a byte with val 7 (e.g. 'N'), the interior hash exceeds 95 and the reference
indexes past the end of its 96-entry table — undefined behaviour in C++.  We
map every hash >= 96 to token id 0 instead.

Everything is vectorized numpy over a byte matrix; no per-sequence Python loop.
"""

from __future__ import annotations

import numpy as np

MAX_LEN = 123
VOCAB_SIZE = 7638  # encoder embedding table rows; token ids live in 7542..7637

_LT = ord("<")
_GT = ord(">")

# char -> 2-bit value (a/c/g/t either case -> 0..3, everything else -> 7).
CHAR_VAL = np.full(256, 7, dtype=np.int32)
for _i, _c in enumerate("acgt"):
    CHAR_VAL[ord(_c)] = _i
    CHAR_VAL[ord(_c.upper())] = _i


def _build_hash_to_id() -> np.ndarray:
    """hash value (0..95) -> vocab id; out-of-table hashes -> 0.

    Mirrors the ordering of src/utils/tok2index.cpp:3-99 / models/tok2index.txt:
    prefix ids are sequential from 7542; suffix ``xy>`` ids are 7558 + 5*(4*x+y);
    interior ``xyz`` ids are 7559 + 5*(4*x+y) + z.
    """
    table = np.zeros(256, dtype=np.int32)
    for h in range(16):
        table[h] = 7542 + h
    for xy in range(16):
        table[16 + xy] = 7558 + 5 * xy
    for xy in range(16):
        for z in range(4):
            table[32 + 4 * xy + z] = 7559 + 5 * xy + z
    return table


HASH_TO_ID = _build_hash_to_id()


def tokenize_bytes(
    mat: np.ndarray,
    lengths: np.ndarray,
    max_len: int = MAX_LEN,
) -> np.ndarray:
    """Tokenize a batch of byte sequences.

    Args:
      mat: uint8 array [N, M]; row i holds the first min(M, lengths[i]) bytes of
        sequence i (anything past the row's length is ignored / may be 0-pad).
        M may be smaller than max_len + 1; missing columns are treated as pad.
      lengths: int array [N], the TRUE length of each sequence (pre-truncation).
      max_len: truncation length (reference MAX_LEN = 123).

    Returns:
      int32 array [N, max_len] of vocab ids, zero-padded past each row's
      min(max_len, length) tokens.
    """
    n, m = mat.shape
    lengths = np.asarray(lengths, dtype=np.int64)
    if m < max_len + 1:
        mat = np.pad(mat, ((0, 0), (0, max_len + 1 - m)))
    else:
        mat = mat[:, : max_len + 1]

    lens = np.minimum(lengths, max_len)  # tokens per row
    v = CHAR_VAL[mat]

    # Positions t = 1 .. max_len-1 use the generic triple (t-1, t, t+1).
    c0 = mat[:, 0 : max_len - 1]
    c1 = mat[:, 1:max_len]
    c2 = mat[:, 2 : max_len + 1].copy()
    # Final-token rule: at t = len-1, c2 is '>' when the sequence does not
    # extend past the truncation point (len == true length).
    ts = np.arange(1, max_len, dtype=np.int64)[None, :]
    force_gt = (ts + 1 == lens[:, None]) & (lens == lengths)[:, None]
    c2[force_gt] = _GT

    v0 = v[:, 0 : max_len - 1]
    v1 = v[:, 1:max_len]
    v2 = CHAR_VAL[c2]

    h_prefix = (v1 << 2) + v2
    h_suffix = 16 + (v0 << 2) + v1
    h_inner = 32 + (v0 << 4) + (v1 << 2) + v2
    h = np.where(c0 == _LT, h_prefix, np.where(c2 == _GT, h_suffix, h_inner))

    out = np.zeros((n, max_len), dtype=np.int32)
    out[:, 1:] = HASH_TO_ID[h]
    # result[0] = hash('<', seq[0], seq[1]) — always takes the '<' branch.
    out[:, 0] = HASH_TO_ID[(v[:, 0] << 2) + v[:, 1]]
    # Zero-pad past each row's token count.
    valid = np.arange(max_len, dtype=np.int64)[None, :] < lens[:, None]
    out *= valid
    return out


def tokenize_bytes_fast(
    mat: np.ndarray,
    lengths: np.ndarray,
    max_len: int = MAX_LEN,
) -> np.ndarray:
    """tokenize_bytes via the native C++ loader when available (identical
    output, parity-tested in tests/test_native.py); numpy fallback."""
    from deepreadmapper_tpu_torch import native

    if native.available():
        m = mat.shape[1]
        if m > max_len + 1:
            mat = np.ascontiguousarray(mat[:, : max_len + 1])
        return native.tokenize_seqs(mat, np.asarray(lengths, np.int64), max_len)
    return tokenize_bytes(mat, lengths, max_len)


def strings_to_bytes(seqs: list[str] | list[bytes], width: int | None = None):
    """Pack a list of sequences into a 0-padded uint8 matrix + lengths."""
    raw = [s.encode() if isinstance(s, str) else s for s in seqs]
    lengths = np.array([len(s) for s in raw], dtype=np.int64)
    if width is None:
        width = int(lengths.max(initial=1))
    mat = np.zeros((len(raw), width), dtype=np.uint8)
    for i, s in enumerate(raw):
        b = np.frombuffer(s[:width], dtype=np.uint8)
        mat[i, : len(b)] = b
    return mat, lengths


def tokenize_strings(
    seqs: list[str] | list[bytes], max_len: int = MAX_LEN
) -> np.ndarray:
    """Tokenize python strings (parity with Preprocessor::preprocessBatch)."""
    mat, lengths = strings_to_bytes(seqs, width=max_len + 1)
    return tokenize_bytes(mat, lengths, max_len)


def tokenize_reference(seq: str, max_len: int = MAX_LEN) -> list[int]:
    """Scalar transliteration of Preprocessor::preprocess — the parity oracle
    for tests (reference: src/inference/preprocess.cpp:20-42)."""

    def char2val(c: str) -> int:
        return {"a": 0, "c": 1, "g": 2, "t": 3}.get(c, 7)

    def hash_token(t0: str, t1: str, t2: str) -> int:
        if t0 == "<":
            return (char2val(t1) << 2) + char2val(t2)
        if t2 == ">":
            return 16 + (char2val(t0) << 2) + char2val(t1)
        return 32 + (char2val(t0) << 4) + (char2val(t1) << 2) + char2val(t2)

    def tok_id(h: int) -> int:
        return int(HASH_TO_ID[h]) if h < 256 else 0

    length = min(max_len, len(seq))
    result = [0] * length
    result[0] = tok_id(hash_token("<", seq[0].lower(), seq[1].lower()))
    i = 0
    while i < length - 2:
        result[i + 1] = tok_id(
            hash_token(seq[i].lower(), seq[i + 1].lower(), seq[i + 2].lower())
        )
        i += 1
    t0 = seq[i].lower()
    i += 1
    t1 = seq[i].lower()
    i += 1
    t2 = seq[i].lower() if i < len(seq) else ">"
    result[length - 1] = tok_id(hash_token(t0, t1, t2))
    return result
