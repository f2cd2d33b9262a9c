"""Compact device->host wire format for search results.

Counterpart of ``deepreadmapper_tpu/ops/pack.py``.  Top-k ids into an
N-vector index need only ceil(log2(N)) bits each; packing them on the
device before the download cuts the bytes that cross the link.  Packing is
nibble-aligned (bits rounded up to a multiple of 4), little-endian in its
nibbles; an odd nibble count per row is padded with one zero nibble.  The
pack is a handful of torch integer ops on the ids' device (no kernel of its
own); the unpack runs on the host, in the native library when it builds.
"""

from __future__ import annotations

import numpy as np
import torch


def bits_needed(n: int) -> int:
    """Nibble-aligned bits to represent ids 0..n-1 (4, 8, 12, ...)."""
    raw = max(int(n - 1).bit_length(), 1)
    return (raw + 3) // 4 * 4


def pack_ids_device(ids: torch.Tensor, nbits: int) -> torch.Tensor:
    """[B, K] non-negative int ids (< 2^nbits, nbits a multiple of 4) ->
    [B, ceil(K*nbits/8)] uint8 on the ids' device."""
    assert nbits % 4 == 0, "nbits must be nibble-aligned (use bits_needed)"
    b, k = ids.shape
    nnib = nbits // 4
    shifts = 4 * torch.arange(nnib, dtype=torch.int32, device=ids.device)
    nib = (ids.to(torch.int32)[:, :, None] >> shifts) & 0xF  # [B, K, nnib]
    nib = nib.reshape(b, k * nnib)
    if (k * nnib) % 2:
        nib = torch.nn.functional.pad(nib, (0, 1))
    nib = nib.reshape(b, -1, 2)
    return (nib[:, :, 0] | (nib[:, :, 1] << 4)).to(torch.uint8)


def unpack_ids_host(packed: np.ndarray, k: int, nbits: int) -> np.ndarray:
    """Inverse of pack_ids_device: [B, nbytes] uint8 -> [B, k] int64.  The
    native library when it builds, else :func:`unpack_ids_numpy`."""
    assert nbits % 4 == 0
    from deepreadmapper_tpu_torch import native

    if native.available():
        return native.unpack_ids(packed, k, nbits)
    return unpack_ids_numpy(packed, k, nbits)


def unpack_ids_numpy(packed: np.ndarray, k: int, nbits: int) -> np.ndarray:
    """The plain version of the unpack, in numpy."""
    assert nbits % 4 == 0
    packed = np.asarray(packed, dtype=np.uint8)
    b = packed.shape[0]
    nnib = nbits // 4
    nib = np.empty((b, packed.shape[1] * 2), dtype=np.int64)
    nib[:, 0::2] = packed & 0xF
    nib[:, 1::2] = packed >> 4
    nib = nib[:, : k * nnib].reshape(b, k, nnib)
    out = nib[:, :, 0].copy()
    for j in range(1, nnib):
        out |= nib[:, :, j] << (4 * j)
    return out
