# Copied from deepreadmapper_tpu/models/ir_loader.py, the JAX-free host layer; the shipped npz is read by path.
"""OpenVINO IR -> framework weight conversion.

The shipped encoder (models/finetuned_sgn33-new-a-Apr6.{xml,bin} in the
reference) is a 2-layer bidirectional GRU:

  input int64 [123, 100] (seq-major tokens)
  -> embedding table 7638x64 (fp16 in the IR)
  -> GRUSequence layer 1: bidirectional, hidden 64, linear_before_reset=true,
     W [2,192,64], R [2,192,64], B [2,256]
  -> GRUSequence layer 2: input 128 (fwd||bwd), W [2,192,128], R [2,192,64],
     B [2,256]
  -> output [100, 128] = concat(final fwd hidden, final bwd hidden)

The IR's length/sort machinery (TopK/ScatterElementsUpdate, a
pack_padded_sequence export artifact) computes CONSTANT full lengths from the
input shape — it contains no content-dependent ops — so the model is exactly a
full-length 123-step bi-GRU over zero-padded tokens and the sort is the
identity permutation.  (Reference IR: models/finetuned_sgn33-new-a-Apr6.xml;
gate order z,r,h; B layout [Wbz+Rbz, Wbr+Rbr, Wbh, Rbh] per the OpenVINO
GRUSequence spec with linear_before_reset.)

This module parses the xml for Const offsets/shapes and slices the bin.  Run
once to produce the framework-native npz (see convert_ir_to_npz / __main__).
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET

import numpy as np

_DTYPES = {"f16": np.float16, "f32": np.float32, "i64": np.int64}

# Const layer names in the IR and their roles.
_WEIGHT_NAMES = {
    "emb.weight_compressed": "embedding",
    "onnx::GRU_397_compressed": "gru1_W",
    "onnx::GRU_398_compressed": "gru1_R",
    "Concat_153_compressed": "gru1_B",
    "onnx::GRU_440_compressed": "gru2_W",
    "onnx::GRU_441_compressed": "gru2_R",
    "Concat_197_compressed": "gru2_B",
}


def load_ir_weights(xml_path: str, bin_path: str | None = None) -> dict[str, np.ndarray]:
    """Extract the 7 weight tensors from an OpenVINO IR pair (fp16 kept)."""
    if bin_path is None:
        bin_path = os.path.splitext(xml_path)[0] + ".bin"
    blob = np.fromfile(bin_path, dtype=np.uint8)
    out: dict[str, np.ndarray] = {}
    root = ET.parse(xml_path).getroot()
    for layer in root.iter("layer"):
        if layer.get("type") != "Const":
            continue
        role = _WEIGHT_NAMES.get(layer.get("name", ""))
        if role is None:
            continue
        data = layer.find("data")
        shape = tuple(int(s) for s in data.get("shape").split(",") if s.strip())
        dt = _DTYPES[data.get("element_type")]
        off, size = int(data.get("offset")), int(data.get("size"))
        arr = blob[off : off + size].view(dt).reshape(shape)
        out[role] = arr
    missing = set(_WEIGHT_NAMES.values()) - set(out)
    if missing:
        raise ValueError(f"IR missing expected weights: {sorted(missing)}")
    return out


def convert_ir_to_npz(xml_path: str, npz_path: str) -> None:
    weights = load_ir_weights(xml_path)
    np.savez_compressed(npz_path, **weights)


# The shipped weights of the JAX package, read by file path: importing
# deepreadmapper_tpu.models would load jax.
DEFAULT_NPZ = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "deepreadmapper_tpu", "models", "data", "finetuned_sgn33.npz",
)


def load_npz_weights(npz_path: str = DEFAULT_NPZ) -> dict[str, np.ndarray]:
    with np.load(npz_path) as z:
        return {k: z[k] for k in z.files}


if __name__ == "__main__":
    import argparse

    # -o has no default here: the JAX module's default is DEFAULT_NPZ, the
    # shipped weights both packages read, which a conversion must not overwrite.
    p = argparse.ArgumentParser(description="Convert OpenVINO IR to framework npz")
    p.add_argument("xml")
    p.add_argument("-o", "--out", required=True)
    args = p.parse_args()
    if os.path.dirname(args.out):
        os.makedirs(os.path.dirname(args.out), exist_ok=True)
    convert_ir_to_npz(args.xml, args.out)
    print(f"wrote {args.out}")
