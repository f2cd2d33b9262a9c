"""How the JAX package's chunked IVF scan rounds its score, on the CPU.

The Pallas kernel computes ``rn - ratio2 * dot`` with ``dot`` an exact
integer.  This script runs ``ivf_chunk_scan_int8`` in interpret mode on a
seeded plan (multi-chunk visits) and counts the per-visit window minima
(best value of each query and lane window) that differ from two models:
one rounding (a fused multiply-subtract) and two roundings (the product
rounded to fp32, then the difference).  The port's plain versions and
``csrc/ivf_chunk.cu`` follow the model with no differences.

    JAX_PLATFORMS=cpu python scripts/ivf_score_rounding.py
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402

from deepreadmapper_tpu.ops import ivf_kernel as ik  # noqa: E402

CHK, KP, QTK = ik.CHK, ik.KP, ik.QTK
BIG = np.float32(3.4e38)


def main() -> None:
    rng = np.random.default_rng(0)
    n_chunks = 7
    codes = rng.integers(-127, 128, (n_chunks, CHK, 128)).astype(np.int8)
    codes[-1] = 0                                   # the dump chunk
    rn = (codes.astype(np.int64) ** 2).sum(-1).astype(np.float32)
    codes[2, 1700:] = 0                             # a partly filled chunk
    rn[2, 1700:] = rn[-1] = BIG
    # visits of 1-3 consecutive chunks each
    visit_chunks = [(0, 1, 2), (3,), (4, 5), (2,), (1, 2), (5,), (0, 1)]
    sc = np.array([c for v in visit_chunks for c in v], np.int32)
    sv = np.array([i for i, v in enumerate(visit_chunks) for _ in v] + [-1], np.int32)
    nv = len(visit_chunks)
    qsteps = rng.integers(-127, 128, (nv, QTK, 128)).astype(np.int8)
    for ratio in (1.0, 1.3):
        r2 = np.float32(2.0 * float(np.float32(ratio)))
        packed = np.asarray(ik.ivf_chunk_scan_int8(
            jnp.asarray(sc), jnp.asarray(sv), jnp.asarray(qsteps), jnp.asarray(codes),
            jnp.asarray(rn), float(r2), CHK, nv, interpret=True))
        one = two = total = 0
        for v, chunks in enumerate(visit_chunks):
            rows = codes[list(chunks)].reshape(-1, 128).astype(np.int64)
            rnv = rn[list(chunks)].reshape(-1)
            dot = qsteps[v].astype(np.int64) @ rows.T            # exact
            s1 = (rnv.astype(np.float64) - float(r2) * dot).astype(np.float32)
            s2 = rnv - (r2 * dot.astype(np.float32)).astype(np.float32)
            best = packed[v, :, :KP]
            w1 = s1.reshape(QTK, -1, KP).min(1)
            w2 = s2.reshape(QTK, -1, KP).min(1)
            one += int((w1 != best).sum())
            two += int((w2 != best).sum())
            total += best.size
        print(f"ratio {ratio}: window minima off one rounding {one} of {total}, "
              f"off two roundings {two} of {total}")


if __name__ == "__main__":
    main()
