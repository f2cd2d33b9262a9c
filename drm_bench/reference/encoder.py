"""Plain reference of the read encoder: the reference mapper's 3-mer
tokenizer and its 2-layer bidirectional GRU, in plain PyTorch.

The tokenizer is a frozen copy of the vectorised one the repository's host
layer carries (``tokenizer.tokenize_bytes``: the reference's
``Preprocessor::preprocess``, src/inference/preprocess.cpp:20-42), written
in torch so it runs where the tokens are used.  The GRU is ``torch.nn.GRU``
(cuDNN on a card) over the shipped weights, read from their npz file by
path; the gate order of the file (z, r, n; linear-before-reset) is mapped
onto torch's (r, z, n) as ``tests/test_encoder.py`` does.  The precision is
fp32 with TF32 off unless ``tf32=True`` (the control).  Nothing of the
port is imported.
"""

from __future__ import annotations

import contextlib
import os

import numpy as np
import torch

MAX_LEN = 123
HIDDEN = 64
WEIGHTS = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "deepreadmapper_tpu", "models", "data", "finetuned_sgn33.npz",
)

_LT, _GT = ord("<"), ord(">")

CHAR_VAL = np.full(256, 7, dtype=np.int64)
for _i, _c in enumerate("acgt"):
    CHAR_VAL[ord(_c)] = _i
    CHAR_VAL[ord(_c.upper())] = _i


def _hash_to_id() -> np.ndarray:
    table = np.zeros(256, dtype=np.int64)
    for h in range(16):
        table[h] = 7542 + h
    for xy in range(16):
        table[16 + xy] = 7558 + 5 * xy
    for xy in range(16):
        for z in range(4):
            table[32 + 4 * xy + z] = 7559 + 5 * xy + z
    return table


HASH_TO_ID = _hash_to_id()


@contextlib.contextmanager
def precision(tf32: bool):
    """fp32 matmuls and cuDNN with TF32 off (tf32=False), or both in TF32."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def tokenize(mat: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """uint8 [N, M] byte rows ('<'-wrapped) with true lengths [N] -> int64
    token ids [N, 123], zero past each row's min(123, length) tokens."""
    dev = mat.device
    n, m = mat.shape
    if m < MAX_LEN + 1:
        mat = torch.nn.functional.pad(mat, (0, MAX_LEN + 1 - m))
    mat = mat[:, : MAX_LEN + 1].long()
    lengths = lengths.to(dev).long()
    lens = torch.clamp(lengths, max=MAX_LEN)
    cval = torch.from_numpy(CHAR_VAL).to(dev)
    h2id = torch.from_numpy(HASH_TO_ID).to(dev)
    v = cval[mat]
    c0 = mat[:, : MAX_LEN - 1]
    c2 = mat[:, 2 : MAX_LEN + 1].clone()
    ts = torch.arange(1, MAX_LEN, device=dev)[None, :]
    force_gt = (ts + 1 == lens[:, None]) & (lens == lengths)[:, None]
    c2[force_gt] = _GT
    v0, v1, v2 = v[:, : MAX_LEN - 1], v[:, 1:MAX_LEN], cval[c2]
    h = torch.where(c0 == _LT, (v1 << 2) + v2,
                    torch.where(c2 == _GT, 16 + (v0 << 2) + v1,
                                32 + (v0 << 4) + (v1 << 2) + v2))
    out = torch.zeros((n, MAX_LEN), dtype=torch.int64, device=dev)
    out[:, 1:] = h2id[h]
    out[:, 0] = h2id[(v[:, 0] << 2) + v[:, 1]]
    valid = torch.arange(MAX_LEN, device=dev)[None, :] < lens[:, None]
    return out * valid


class Encoder:
    """tokens [N, 123] -> fp32 embeddings [N, 128]: the layer-2 final hidden
    states, forward then backward."""

    def __init__(self, device, path: str = WEIGHTS):
        z = np.load(path)
        self.device = torch.device(device)
        self.emb = torch.tensor(z["embedding"].astype(np.float32), device=self.device)
        gru = torch.nn.GRU(HIDDEN, HIDDEN, num_layers=2, bidirectional=True)
        perm = torch.cat([torch.arange(64, 128), torch.arange(0, 64), torch.arange(128, 192)])
        for layer, key in ((0, "gru1"), (1, "gru2")):
            w = torch.tensor(z[key + "_W"].astype(np.float32))
            r = torch.tensor(z[key + "_R"].astype(np.float32))
            b = torch.tensor(z[key + "_B"].astype(np.float32))
            for d, suffix in enumerate(("", "_reverse")):
                getattr(gru, f"weight_ih_l{layer}{suffix}").data = w[d][perm]
                getattr(gru, f"weight_hh_l{layer}{suffix}").data = r[d][perm]
                # file bias [bz, br, Wbh, Rbh]: z/r summed on ih, Rbh on hh's n
                getattr(gru, f"bias_ih_l{layer}{suffix}").data = torch.cat(
                    [b[d, 64:128], b[d, 0:64], b[d, 128:192]])
                getattr(gru, f"bias_hh_l{layer}{suffix}").data = torch.cat(
                    [torch.zeros(128), b[d, 192:256]])
        self.gru = gru.to(self.device).eval()

    @torch.no_grad()
    def __call__(self, tokens: torch.Tensor) -> torch.Tensor:
        x = self.emb[tokens.to(self.device).T]  # [T, N, 64]
        _, h_n = self.gru(x)
        return torch.cat([h_n[2], h_n[3]], dim=-1)


def wrap_reads(reads: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Reads as sequenced, uint8 [N, L] -> ('<' + read + '>' bytes, lengths)."""
    n, length = reads.shape
    mat = np.concatenate([np.full((n, 1), _LT, np.uint8), reads,
                          np.full((n, 1), _GT, np.uint8)], axis=1)
    return mat, np.full(n, length + 2, np.int64)


def embed_reads(enc: Encoder, reads: np.ndarray, batch: int = 32768) -> torch.Tensor:
    """Embeddings [N, 128] of reads as sequenced, on the encoder's device,
    in batches of one size (the last one padded): one cuDNN plan."""
    mat, lens = wrap_reads(reads)
    n = mat.shape[0]
    outs = []
    for s in range(0, n, batch):
        m = mat[s : s + batch]
        ln = lens[s : s + batch]
        if m.shape[0] < batch and n > batch:
            m = np.concatenate([m, np.repeat(m[:1], batch - m.shape[0], axis=0)])
            ln = np.concatenate([ln, np.repeat(ln[:1], batch - ln.shape[0])])
        e = enc(tokenize(torch.from_numpy(m).to(enc.device), torch.from_numpy(ln)))
        outs.append(e[: min(batch, n - s)])
    if not outs:
        return torch.zeros((0, 2 * HIDDEN), device=enc.device)
    return torch.cat(outs)
