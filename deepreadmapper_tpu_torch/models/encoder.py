"""2-layer bidirectional GRU read encoder in PyTorch.

Counterpart of ``deepreadmapper_tpu/models/encoder.py``.  Math (ONNX/OpenVINO
GRU, gate order z, r, n, linear_before_reset):

    z = sigmoid(x Wz^T + h Rz^T + bz)
    r = sigmoid(x Wr^T + h Rr^T + br)
    n = tanh(x Wh^T + Wbh + r * (h Rh^T + Rbh))
    h' = (1 - z) * n + z * h

tokens [B, 123] -> embedding gather (time-major) -> layer 1 fwd/bwd over all
steps -> layer 2 fwd/bwd final hidden -> [B, 128] fp32.  The four GRU calls
go through ``models.gru`` (the CUDA kernels on a GPU).

:func:`encode_tokens_impl` is the differentiable body, over a params dict of
tensors (``{'embedding', 'layers': [{'w', 'r', 'bzr', 'rbh'}, ...]}``, the
layout of :func:`load_params`).  Training owns such a dict
(:func:`torch_params`): it mirrors the JAX package's EncoderParams pytree
leaf for leaf, so the optimizer, the train-state file and the tests walk one
structure in both packages.  :class:`Encoder` is the serving form: its
weights are buffers and ``encode_tokens`` runs under ``no_grad``.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from deepreadmapper_tpu_torch import resolve_device
from deepreadmapper_tpu_torch.models.gru import gru_proj_last, gru_proj_seq
from deepreadmapper_tpu_torch.models.ir_loader import DEFAULT_NPZ
from deepreadmapper_tpu_torch.tokenizer_device import tokens_from_packed

HIDDEN = 64
OUT_SIZE = 2 * HIDDEN
MAX_LEN = 123

_LAYER_KEYS = ("w", "r", "bzr", "rbh")


def _layer_from_ir(w: np.ndarray, r: np.ndarray, b: np.ndarray) -> dict:
    """IR layout w [2,192,in], r [2,192,64], b [2,256] -> the layout of
    encoder._layer_from_ir: w/r transposed for x @ w, bzr = [bz, br, Wbh],
    rbh separate."""
    w = w.astype(np.float32)
    r = r.astype(np.float32)
    b = b.astype(np.float32)
    return {
        "w": np.ascontiguousarray(np.swapaxes(w, 1, 2)),   # [2, in, 192]
        "r": np.ascontiguousarray(np.swapaxes(r, 1, 2)),   # [2, 64, 192]
        "bzr": np.concatenate([b[:, :128], b[:, 128:192]], axis=1),  # [2,192]
        "rbh": np.ascontiguousarray(b[:, 192:256]),         # [2, 64]
    }


def load_params(npz_path: str = DEFAULT_NPZ) -> dict:
    """Encoder weights npz (IR roles) -> {'embedding', 'layers': [l1, l2]}
    of fp32 numpy arrays."""
    with np.load(npz_path) as z:
        return {
            "embedding": z["embedding"].astype(np.float32),
            "layers": [
                _layer_from_ir(z["gru1_W"], z["gru1_R"], z["gru1_B"]),
                _layer_from_ir(z["gru2_W"], z["gru2_R"], z["gru2_B"]),
            ],
        }


def params_from_jax(params) -> dict:
    """The JAX package's parameters -> the port's.  Takes an EncoderParams
    (whose leaves convert with np.asarray) or a dict of the same fields."""
    if isinstance(params, dict):
        emb, layers = params["embedding"], params["layers"]
    else:
        emb, layers = params.embedding, params.layers
    out_layers = []
    for lp in layers:
        get = lp.get if isinstance(lp, dict) else lambda k, lp=lp: getattr(lp, k)
        out_layers.append(
            {k: np.asarray(get(k), dtype=np.float32) for k in _LAYER_KEYS}
        )
    return {"embedding": np.asarray(emb, np.float32), "layers": out_layers}


def named_leaves(params: dict) -> list[tuple[str, object]]:
    """The params dict's leaves with their names, in the one fixed order:
    the embedding, then each layer's w, r, bzr, rbh.  The optimizer's
    parameter order, the train-state file and Encoder's buffers follow it."""
    return [("embedding", params["embedding"])] + [
        (f"l{li}_{k}", lp[k]) for li, lp in enumerate(params["layers"]) for k in _LAYER_KEYS
    ]


def params_from_named(named) -> dict:
    """Inverse of :func:`named_leaves`: a mapping of leaf names -> a params
    dict of the same values."""
    layers = []
    while f"l{len(layers)}_w" in named:
        layers.append({k: named[f"l{len(layers)}_{k}"] for k in _LAYER_KEYS})
    return {"embedding": named["embedding"], "layers": layers}


def torch_params(params: dict, device=None, requires_grad: bool = False) -> dict:
    """A params dict of numpy arrays (or tensors) -> fp32 tensors on device,
    each a leaf that requires grad when asked."""
    def leaf(a):
        t = a.detach() if torch.is_tensor(a) else torch.from_numpy(np.asarray(a, np.float32))
        return t.to(device, torch.float32).clone().requires_grad_(requires_grad)

    return {"embedding": leaf(params["embedding"]),
            "layers": [{k: leaf(lp[k]) for k in _LAYER_KEYS} for lp in params["layers"]]}


def numpy_params(params: dict) -> dict:
    """A params dict of tensors -> fp32 numpy arrays on the host."""
    def arr(a):
        return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a, np.float32)

    return {"embedding": arr(params["embedding"]),
            "layers": [{k: arr(lp[k]) for k in _LAYER_KEYS} for lp in params["layers"]]}


def encode_tokens_impl(params: dict, tokens: torch.Tensor,
                       dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Differentiable encode: tokens [B, T] -> embeddings [B, 128] fp32, on
    the params' device; counterpart of encoder.encode_tokens_impl."""
    # Gather through the transposed tokens: x lands time-major [T, B, 64]
    # with no activation transpose.
    x = params["embedding"].to(dtype)[tokens.long().T]
    w, r, bzr, rbh = (params["layers"][0][k].to(dtype) for k in _LAYER_KEYS)
    hf = gru_proj_seq(x, w[0], bzr[0], r[0], rbh[0], False)
    hb = gru_proj_seq(x, w[1], bzr[1], r[1], rbh[1], True)
    out1 = torch.cat([hf, hb], dim=-1)  # [T, B, 128]
    del x, hf, hb
    w, r, bzr, rbh = (params["layers"][1][k].to(dtype) for k in _LAYER_KEYS)
    hf_t = gru_proj_last(out1, w[0], bzr[0], r[0], rbh[0], False)
    hb_t = gru_proj_last(out1, w[1], bzr[1], r[1], rbh[1], True)
    return torch.cat([hf_t, hb_t], dim=-1).to(torch.float32)


class Encoder(nn.Module):
    """tokens [B, T] or wire rows [B, 48] -> embeddings [B, 128] fp32."""

    def __init__(self, params: dict | None = None):
        super().__init__()
        params = params if params is not None else load_params()
        for name, a in named_leaves(params):
            self.register_buffer(name, torch.tensor(a))

    def params(self) -> dict:
        """The buffers as a params dict (no copies)."""
        return params_from_named(dict(self.named_buffers()))

    @torch.no_grad()
    def encode_tokens(self, tokens: torch.Tensor,
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
        return encode_tokens_impl(self.params(), tokens, dtype)

    def encode_packed(self, wire: torch.Tensor,
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """48-byte wire rows -> fp32 embeddings; tokenization runs on wire's
        device."""
        return self.encode_tokens(tokens_from_packed(wire), dtype)

    forward = encode_tokens


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class Vectorizer:
    """Strings / bytes / wire rows -> fp32 embeddings, in device batches.

    dtype ("float32" or "bfloat16") is the GRU's input dtype, as the JAX
    Vectorizer's; the gates, the carry and the output stay fp32.  max_len
    is the token count per sequence: the 48-byte wire and the device
    tokenizer hold exactly MAX_LEN tokens, so any other max_len tokenizes
    on the host."""

    def __init__(self, params: dict | None = None, device_batch: int = 8192,
                 device: torch.device | str | None = None, max_len: int = MAX_LEN,
                 dtype: str = "float32"):
        if dtype not in _DTYPES:
            raise ValueError(f"dtype {dtype!r}: one of {sorted(_DTYPES)}")
        self.device = resolve_device(device)
        self.encoder = Encoder(params).to(self.device)
        self.device_batch = device_batch
        self.max_len = max_len
        self.dtype = dtype

    def _dispatch_batches(self, rows: np.ndarray, encode_one, device_out: bool):
        """Encode rows in device batches of at most device_batch (the last
        one ragged: nothing here needs fixed shapes).  Launches are
        asynchronous on a GPU; device_out=True keeps the result there."""
        n = rows.shape[0]
        bs = self.device_batch
        outs = []
        for start in range(0, n, bs):
            chunk = np.ascontiguousarray(rows[start : start + bs])
            outs.append(encode_one(torch.from_numpy(chunk).to(self.device)))
        if not outs:
            out = torch.zeros((0, OUT_SIZE), dtype=torch.float32, device=self.device)
        else:
            out = torch.cat(outs) if len(outs) > 1 else outs[0]
        return out if device_out else out.cpu().numpy()

    def vectorize_tokens(self, tokens: np.ndarray, device_out: bool = False):
        """tokens int [N, T] -> fp32 [N, 128].  Tokens travel as int16."""
        dt = _DTYPES[self.dtype]
        return self._dispatch_batches(
            np.asarray(tokens).astype(np.int16),
            lambda t: self.encoder.encode_tokens(t, dt), device_out,
        )

    def vectorize(self, seqs: list[str]) -> np.ndarray:
        from deepreadmapper_tpu_torch import tokenizer as tok

        return self.vectorize_tokens(tok.tokenize_strings(seqs, self.max_len))

    def vectorize_wrapped_bytes(self, mat: np.ndarray, lengths: np.ndarray):
        """'<'-wrapped byte matrix -> embeddings: the 48-byte wire upload and
        the device tokenizer at MAX_LEN, host tokenization otherwise."""
        if self.max_len != MAX_LEN:
            from deepreadmapper_tpu_torch import tokenizer as tok

            return self.vectorize_tokens(
                tok.tokenize_bytes_fast(mat, lengths, self.max_len))
        from deepreadmapper_tpu_torch.tokenizer_device import pack_wrapped

        return self.vectorize_wire(pack_wrapped(mat, lengths))

    def vectorize_wire(self, wire: np.ndarray, device_out: bool = False):
        """Pre-packed 48-byte wire rows -> embeddings (tokenized on device)."""
        dt = _DTYPES[self.dtype]
        return self._dispatch_batches(
            wire, lambda w: self.encoder.encode_packed(w, dt), device_out)
