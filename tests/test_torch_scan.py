"""Port parity: the int8 window-min scan, the fused top-k over chunks and the
exact L2 top-k against the JAX package (Pallas in interpret mode on CPU).

The int8 scan is integer-exact and rounds its score once (an FMA, as XLA
computes the JAX kernel's expression), so vals and args compare exactly at
ratio 1 and ratio != 1.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from deepreadmapper_tpu.ops import scan_kernel as jsk
from deepreadmapper_tpu.ops import topk as jtopk
from deepreadmapper_tpu_torch import kernels
from deepreadmapper_tpu_torch.ops import scan_kernel as tsk
from deepreadmapper_tpu_torch.ops import topk as ttopk

RATIOS = [1.0, 1.3]


@pytest.fixture(scope="module")
def int8_case():
    rng = np.random.default_rng(0)
    np_, qp = 2 * jsk.CT, jsk.QT
    r8 = rng.integers(-127, 128, (np_, 128)).astype(np.int8)
    q8 = rng.integers(-127, 128, (qp, 128)).astype(np.int8)
    # a block of duplicate rows makes in-window ties
    r8[100:140] = r8[99]
    return r8, q8


def _qt_b(q8):
    return jnp.asarray(q8.T.astype(np.float32), jnp.bfloat16)


@pytest.mark.parametrize("w", [128, 512])
@pytest.mark.parametrize("ratio", RATIOS)
def test_int8_winmin_reference_matches_pallas(int8_case, w, ratio):
    r8, q8 = int8_case
    ntotal = r8.shape[0] - 300  # mask part of the last tile
    ratio2 = 2.0 * float(np.float32(ratio))
    vj, aj = jsk._int8_winmin_call(_qt_b(q8), jnp.asarray(r8), ntotal,
                                   jnp.float32(ratio2), w=w, interpret=True)
    before = kernels.INT8_WINMIN.launches
    vt, at = tsk.int8_winmin(torch.from_numpy(q8), torch.from_numpy(r8),
                             ntotal, ratio2, w)
    assert kernels.INT8_WINMIN.launches == before  # CPU: plain version
    assert vt.dtype == torch.float32 and at.dtype == torch.int32
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    np.testing.assert_array_equal(at.numpy(), np.asarray(aj))


def _int8_tie_case(np_=2 * jsk.CT, qp=jsk.QT, seed=5):
    """Tie-heavy int8 inputs: every row one of 16 patterns of values in
    {-2..2}, so each 128-row window holds each pattern ~8 times and most
    window minima are shared by several rows."""
    rng = np.random.default_rng(seed)
    patterns = rng.integers(-2, 3, (16, 128)).astype(np.int8)
    r8 = patterns[rng.integers(0, 16, np_)]
    q8 = rng.integers(-127, 128, (qp, 128)).astype(np.int8)
    return r8, q8


@pytest.mark.parametrize("w", [128, 512])
@pytest.mark.parametrize("ratio", RATIOS)
def test_int8_winmin_reference_matches_pallas_on_ties(w, ratio):
    """The tie-heavy case against the JAX kernel in interpret mode, ntotal
    inside a window: only the lowest-row rule tells most windows' answers
    apart."""
    r8, q8 = _int8_tie_case()
    ntotal = r8.shape[0] - 300
    ratio2 = 2.0 * float(np.float32(ratio))
    vj, aj = jsk._int8_winmin_call(_qt_b(q8), jnp.asarray(r8), ntotal,
                                   jnp.float32(ratio2), w=w, interpret=True)
    vt, at = tsk.int8_winmin(torch.from_numpy(q8), torch.from_numpy(r8),
                             ntotal, ratio2, w)
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    np.testing.assert_array_equal(at.numpy(), np.asarray(aj))
    # the case is tie-heavy: most (window, query) minima are shared by rows
    rows = torch.from_numpy(r8).double()
    s = (rows * rows).sum(1)[:, None] - ratio2 * rows @ torch.from_numpy(q8).double().T
    s3 = s.float()[: ntotal // w * w].reshape(-1, w, q8.shape[0])
    shared = ((s3 == s3.amin(1, keepdim=True)).sum(1) > 1).double().mean()
    assert shared > 0.5, float(shared)


@pytest.mark.parametrize("ratio", RATIOS)
@pytest.mark.parametrize("ntotal_cut", [0, 3000])
def test_fused_scan_topk_matches_jax(int8_case, ratio, ntotal_cut):
    r8, q8 = int8_case
    n = r8.shape[0] - ntotal_cut
    k = 16
    dj, ij = jsk.fused_scan_topk(
        _qt_b(q8), jnp.asarray(r8), n, k, jsk.CT, "int8", ratio=ratio,
        exact=True, interpret=True,
    )
    dt, it = tsk.fused_scan_topk(torch.from_numpy(q8), torch.from_numpy(r8),
                                 n, k, tsk.CT, ratio=ratio)
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
    assert it.dtype == torch.int64 and bool((it < n).all())
    ij = np.asarray(ij)
    for row in range(ij.shape[0]):
        assert set(it[row].tolist()) == set(ij[row].tolist())


@pytest.mark.parametrize("ratio", RATIOS)
@pytest.mark.parametrize("m", [1, 2, 64, 128])
def test_fused_scan_topk_pq_at_every_m_matches_jax(m, ratio):
    """The PQFLAT fused scan (pq_winmin's plain version here) at codebook
    entries of 128, 64, 2 and 1 bytes, against the JAX fused PQ scan in
    interpret mode: distances exact, ids as sets (ties)."""
    rng = np.random.default_rng(m)
    np_, k = 2 * jsk.CT, 16
    codes = rng.integers(0, 256, (np_, m)).astype(np.uint8)
    codes[100:140] = codes[99]  # duplicate rows: in-window ties
    cent8 = rng.integers(-127, 128, (m, 256, 128 // m)).astype(np.int8)
    q8 = rng.integers(-127, 128, (jsk.QT, 128)).astype(np.int8)
    n = np_ - 1000
    cent2d = jnp.asarray(cent8.reshape(-1, 128 // m).astype(np.float32), jnp.bfloat16)
    dj, ij = jsk.fused_scan_topk(_qt_b(q8), jnp.asarray(codes.T.astype(np.int32)), n, k,
                                 jsk.CT, "pq", cent2d=cent2d, ratio=ratio, exact=True,
                                 interpret=True)
    before = kernels.PQ_WINMIN.launches
    dt, it = tsk.fused_scan_topk(torch.from_numpy(q8), torch.from_numpy(codes), n, k,
                                 tsk.CT, ratio=ratio, cent8=torch.from_numpy(cent8))
    assert kernels.PQ_WINMIN.launches == before  # CPU tensors: plain version
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
    assert bool((it < n).all())
    ij = np.asarray(ij)
    for row in range(ij.shape[0]):
        assert set(it[row].tolist()) == set(ij[row].tolist())


@pytest.mark.parametrize("np_units", [1, 8, 9, 12, 16, 41])
def test_choose_chunk_matches_jax(np_units):
    n = np_units * tsk._PAD_BASE
    assert tsk.choose_chunk(n) == jsk.choose_chunk(n)
    assert tsk.pad_rows(n + 5, tsk.CT) == jsk.pad_rows(n + 5, jsk.CT)


def test_can_fuse_only_on_cuda():
    n = tsk.MIN_FUSED_N
    assert not tsk.can_fuse(n, n, 128, torch.device("cpu"))
    assert tsk.can_fuse(n, n, 128, torch.device("cuda"))
    assert not tsk.can_fuse(n - 1, n, 128, torch.device("cuda"))
    assert not tsk.can_fuse(n, n + 1, 128, torch.device("cuda"))
    assert not tsk.can_fuse(n, n, tsk._PAD_BASE // tsk.W + 1, torch.device("cuda"))


def test_int8_winmin_rejects_bad_inputs():
    q8 = torch.zeros((128, 128), dtype=torch.int8)
    r8 = torch.zeros((256, 128), dtype=torch.int8)
    with pytest.raises(TypeError):
        tsk.int8_winmin(q8.float(), r8, 256, 2.0)
    with pytest.raises(ValueError):
        tsk.int8_winmin(q8[:, :64], r8, 256, 2.0)
    with pytest.raises(ValueError):
        tsk.int8_winmin(q8, r8[:200], 200, 2.0)
    with pytest.raises(ValueError):
        tsk.int8_winmin(q8, r8, 256, 2.0, w=100)


@pytest.mark.parametrize("chunk", [262144, 100])  # 100 divides N: no pad rows
def test_l2_topk_matches_jax_with_duplicates(chunk):
    rng = np.random.default_rng(1)
    refs = rng.standard_normal((300, 16)).astype(np.float32)
    refs[200:210] = refs[5]   # exact duplicates: ties must go to the lower id
    refs[250] = refs[7]
    queries = rng.standard_normal((20, 16)).astype(np.float32)
    queries[:5] = refs[[5, 7, 205, 3, 250]]
    k = 24
    dj, ij = jtopk.l2_topk(queries, refs, k, chunk=chunk)
    dt, it = ttopk.l2_topk(queries, refs, k, chunk=chunk)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-5, atol=1e-4)
    # the duplicates of row 5 come out in ascending id order
    assert it[0, :11].tolist() == [5] + list(range(200, 210))


def test_l2_topk_pads_when_k_exceeds_n():
    rng = np.random.default_rng(2)
    refs = rng.standard_normal((5, 8)).astype(np.float32)
    q = rng.standard_normal((3, 8)).astype(np.float32)
    dj, ij = jtopk.l2_topk(q, refs, 9)
    dt, it = ttopk.l2_topk(q, refs, 9)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    assert (it[:, 5:] == -1).all()
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-5, atol=1e-4)


def test_smallest_k_is_stable():
    x = torch.tensor([[3.0, 1.0, 1.0, 0.5, 1.0], [2.0, 2.0, 2.0, 2.0, 2.0]])
    v, p = ttopk.smallest_k(x, 3)
    assert p.tolist() == [[3, 1, 2], [0, 1, 2]]
    assert v.tolist() == [[0.5, 1.0, 1.0], [2.0, 2.0, 2.0]]
