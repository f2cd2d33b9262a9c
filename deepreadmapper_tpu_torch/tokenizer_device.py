"""Device tokenizer from the 2-bit wire format, as torch integer ops.

Counterpart of ``deepreadmapper_tpu/tokenizer_device.py``.  The host packs
every '<'-wrapped sequence into one 48-byte wire row (2-bit bases, an N-mask
bitmap and the base count); the tokenizer runs on the device as shifts,
masks and a 256-entry gather.  Wire format and semantics are those of the
JAX package (bit-identical to ``tokenizer.tokenize_bytes`` on wrapped input):

  bytes  0..30  packed bases 0..122, 4 per byte, little-endian 2-bit lanes
  bytes 31..46  N-mask bitmap: bit i set when base i is not acgt
  byte  47      base count, clamped to 255
"""

from __future__ import annotations

import numpy as np
import torch

from deepreadmapper_tpu_torch.tokenizer import CHAR_VAL, HASH_TO_ID, MAX_LEN

N_BASES_MAX = MAX_LEN  # bases 0..122 can influence the 123 tokens
PACKED_WIDTH = (N_BASES_MAX + 3) // 4    # 31
NMASK_WIDTH = (N_BASES_MAX + 7) // 8     # 16
WIRE_WIDTH = PACKED_WIDTH + NMASK_WIDTH + 1  # 48


def pack_wrapped(mat: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """Pack a wrapped byte matrix into wire rows: native C++ when the
    library builds, else the numpy version.  Returns uint8 [N, 48]."""
    from deepreadmapper_tpu_torch import native

    if native.available():
        return native.pack_wrapped(mat, lengths)
    return pack_wrapped_numpy(mat, lengths)


# Copied from deepreadmapper_tpu/tokenizer_device.py::pack_wrapped_numpy
# (that module imports jax at its top).
def pack_wrapped_numpy(mat: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """Pack a wrapped byte matrix ('<'+seq+'>', as parse_fastq_bytes emits)
    into the single-buffer 2-bit wire format.  Returns uint8 [N, 48]."""
    lengths = np.asarray(lengths, dtype=np.int64)
    nb = np.maximum(lengths - 2, 0)
    n, w = mat.shape
    take = min(max(w - 1, 0), N_BASES_MAX)
    v = np.full((n, N_BASES_MAX), 7, dtype=np.uint8)
    if take:
        v[:, :take] = CHAR_VAL[mat[:, 1 : 1 + take]].astype(np.uint8)
    # zero out beyond each row's base count so pad lanes are deterministic
    valid = np.arange(N_BASES_MAX)[None, :] < nb[:, None]
    code = np.where(valid, v & 3, 0).astype(np.uint8)
    isn = np.where(valid, v >= 4, False)

    wire = np.zeros((n, WIRE_WIDTH), dtype=np.uint8)
    code4 = np.zeros((n, PACKED_WIDTH * 4), dtype=np.uint8)
    code4[:, :N_BASES_MAX] = code
    code4 = code4.reshape(n, PACKED_WIDTH, 4)
    wire[:, :PACKED_WIDTH] = (
        code4[:, :, 0]
        | (code4[:, :, 1] << 2)
        | (code4[:, :, 2] << 4)
        | (code4[:, :, 3] << 6)
    )
    bits = np.zeros((n, NMASK_WIDTH * 8), dtype=np.uint8)
    bits[:, :N_BASES_MAX] = isn.astype(np.uint8)
    wire[:, PACKED_WIDTH : PACKED_WIDTH + NMASK_WIDTH] = np.packbits(
        bits.reshape(n, NMASK_WIDTH, 8), axis=2, bitorder="little"
    )[:, :, 0]
    wire[:, WIRE_WIDTH - 1] = np.minimum(nb, 255).astype(np.uint8)
    return wire


def tokens_from_packed(wire: torch.Tensor) -> torch.Tensor:
    """[B, 48] uint8 wire rows -> [B, 123] int64 vocab ids, on wire's device."""
    dev = wire.device
    w = wire.to(torch.int32)
    packed = w[:, :PACKED_WIDTH]
    nmask = w[:, PACKED_WIDTH : PACKED_WIDTH + NMASK_WIDTH]
    nb = w[:, WIRE_WIDTH - 1 : WIRE_WIDTH]                   # [B, 1]
    pos = torch.arange(N_BASES_MAX, dtype=torch.int32, device=dev)
    code = (packed[:, pos // 4] >> (2 * (pos % 4))) & 3
    isn = (nmask[:, pos // 8] >> (pos % 8)) & 1
    vb = torch.where(isn == 1, 7, code)                      # [B, 123]

    lw = nb + 2                                              # wrapped length
    ltok = torch.clamp(lw, max=MAX_LEN)                      # tokens per row

    # wrapped-position values w[i], i in 0..123: '<' and everything past the
    # last base (including '>') has value 7, as CHAR_VAL of those bytes
    wpos = torch.arange(N_BASES_MAX + 1, dtype=torch.int32, device=dev)[None, :]
    vw = torch.where(
        (wpos == 0) | (wpos > nb), 7, torch.nn.functional.pad(vb, (1, 0))
    )
    # tokens t = 1..122 use wrapped chars (t-1, t, t+1)
    t = torch.arange(1, MAX_LEN, dtype=torch.int32, device=dev)[None, :]
    v0 = vw[:, 0 : MAX_LEN - 1]
    v1 = vw[:, 1:MAX_LEN]
    v2 = vw[:, 2 : MAX_LEN + 1]
    # c2 is '>' when it sits at wrapped index nb+1, or at the final token of
    # an untruncated row (tokenizer.tokenize_bytes force_gt rule)
    force_gt = (t + 1 == ltok) & (ltok == lw)
    c2_gt = (t + 1 == nb + 1) | force_gt
    v2 = torch.where(c2_gt, 7, v2)

    h_prefix = (v1 << 2) + v2
    h_suffix = 16 + (v0 << 2) + v1
    h_inner = 32 + (v0 << 4) + (v1 << 2) + v2
    h = torch.where(t == 1, h_prefix, torch.where(c2_gt, h_suffix, h_inner))

    table = torch.as_tensor(HASH_TO_ID, dtype=torch.int64, device=dev)
    toks = table[h.clamp(0, 255).long()]
    tok0 = table[(28 + vw[:, 1]).long()]
    out = torch.cat([tok0[:, None], toks], dim=1)
    valid = torch.arange(MAX_LEN, device=dev)[None, :] < ltok
    return torch.where(valid, out, 0)
