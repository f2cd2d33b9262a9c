"""Id packing (ops/pack) and the bench twin (deepreadmapper_tpu_torch.bench)
against the JAX package's pack and exact L2 top-k, on the CPU."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepreadmapper_tpu.ops import pack as jpack
from deepreadmapper_tpu_torch.ops import pack as tpack

# bench.py's JSON keys (bench.py:151-170)
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "device_qps", "qps_median",
              "device_qps_median", "e2e_trials_s", "device_trials_s", "stage_s"}


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("nbits", [4, 8, 12, 16, 20, 24, 28])
def test_pack_ids_matches_jax_byte_for_byte(nbits):
    """Seeded ids < 2^nbits at k = 1, 3 (odd nibble counts at every odd
    nbits/4) and 128: the packed bytes equal the JAX package's exactly, and
    both unpacks (native and numpy) give the ids back."""
    from deepreadmapper_tpu_torch import native

    rng = np.random.default_rng(nbits)
    for k in (1, 3, 128):
        ids = rng.integers(0, 1 << nbits, (37, k), dtype=np.int64)
        ids[0, 0] = (1 << nbits) - 1
        ids[1, -1] = 0
        want = np.asarray(jpack.pack_ids_device(jnp.asarray(ids.astype(np.int32)), nbits))
        got = tpack.pack_ids_device(torch.from_numpy(ids), nbits).numpy()
        assert got.dtype == np.uint8 and got.shape == want.shape == (37, -(-k * nbits // 8))
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(tpack.unpack_ids_host(got, k, nbits), ids)
        np.testing.assert_array_equal(tpack.unpack_ids_numpy(got, k, nbits), ids)
        if native.available():
            np.testing.assert_array_equal(native.unpack_ids(got, k, nbits), ids)


@pytest.mark.parametrize("n", [1, 2, 16, 17, 1702, 1 << 20, (1 << 20) + 1])
def test_bits_needed_matches_jax(n):
    assert tpack.bits_needed(n) == jpack.bits_needed(n)


def test_bench_twin_line_and_ids_match_jax_l2_topk(ecoli_embeddings, capsys):
    """The twin on the CPU at reps 1 (150 reads): one JSON line with
    bench.py's keys and a positive value; its unpacked ids equal the JAX
    package's exact L2 top-128 of the same reads wherever the JAX distances
    are not tied.  Tolerance: the two encoders agree to ~1e-6 (rule C2), so
    an id is held only where its JAX distance is more than 1e-4 from both
    neighbours' (a closer pair may swap by the encoders' noise)."""
    from deepreadmapper_tpu.ops.topk import l2_topk
    from deepreadmapper_tpu_torch import bench

    assert bench.main(reps=1, device="cpu") == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert set(rec) == BENCH_KEYS
    assert rec["metric"] == "ecoli150_dense_e2e_qps" and rec["value"] > 0
    assert set(rec["stage_s"]) == {"upload", "compute", "fetch"}

    _, ids = bench.bench(reps=1, device="cpu", trials=1)
    ref, q = ecoli_embeddings
    jd, ji = (np.asarray(a) for a in l2_topk(jnp.asarray(q), jnp.asarray(ref), 128))
    assert ids.shape == ji.shape == (150, 128)
    gap = np.diff(jd, axis=1) > 1e-4
    clear = np.concatenate([gap[:, :1], gap[:, :-1] & gap[:, 1:], gap[:, -1:]], 1)
    assert clear.mean() > 0.5
    np.testing.assert_array_equal(ids[clear], ji[clear])
