"""Port parity: product quantization, the PQ window-min scan, the fused PQ
top-k and the PQFLAT engine against the JAX package (Pallas in interpret
mode on CPU).

The scan side is integer-exact (int8 reconstructions, exact dot products,
one FMA rounding at ratio != 1), so it compares bit for bit.  k-means sums
in another order than XLA's einsum, so codebooks are held to a tolerance on
clustered data, where the assignments, and therefore the codes, agree.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepreadmapper_tpu.config import BuildConfig
from deepreadmapper_tpu.index import pq_flat as jpqf
from deepreadmapper_tpu.ops import pq as jpq
from deepreadmapper_tpu.ops import scan_kernel as jsk
from deepreadmapper_tpu_torch import kernels
from deepreadmapper_tpu_torch.config import BuildConfig as TBuildConfig
from deepreadmapper_tpu_torch.index import pq_flat as tpqf
from deepreadmapper_tpu_torch.index.int8_flat import query_scale_ratio, search_quantized
from deepreadmapper_tpu_torch.index.registry import load_index
from deepreadmapper_tpu_torch.ops import pq as tpq
from deepreadmapper_tpu_torch.ops import scan_kernel as tsk

RATIOS = [1.0, 1.3]
MN = [(8, 8), (16, 8), (4, 8), (8, 6)]
# the fused scan at every m that divides 128: 2- and 1-byte codebook entries
MN_SCAN = MN + [(64, 8), (128, 8)]


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two torch threads per test process: the suite runs in parallel
    processes, and the plain versions' many small ops slow down badly when
    every process starts a thread per core."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _clustered(seed, n, m=8, ksub=16, noise=0.01):
    """n vectors whose every subspace sits near one of ksub well separated
    centers, in blocks of n/ksub rows, so the evenly spaced k-means init
    takes one point of each cluster and no assignment is near a tie."""
    rng = np.random.default_rng(seed)
    dsub = 128 // m
    centers = rng.standard_normal((m, ksub, dsub)).astype(np.float32)
    labels = np.arange(n) * ksub // n
    x = centers[:, labels].transpose(1, 0, 2).reshape(n, 128)
    return (x + noise * rng.standard_normal((n, 128))).astype(np.float32)


def _embeddings(seed, n):
    rng = np.random.default_rng(seed)
    return np.tanh(rng.standard_normal((n, 128))).astype(np.float32)


def _codebook(seed, m, nbits):
    rng = np.random.default_rng(seed)
    cent = rng.standard_normal((m, 1 << nbits, 128 // m)).astype(np.float32) * 0.3
    return cent


def test_sample_training_set_matches_jax():
    x = _embeddings(0, 1001)
    for rate in (0.5, 0.1, 1.0):
        np.testing.assert_array_equal(tpq.sample_training_set(x, rate),
                                      jpq.sample_training_set(x, rate))


@pytest.mark.parametrize("m,nbits", MN)
def test_int8_codebook_helpers_match_jax(m, nbits):
    cent = _codebook(1, m, nbits)
    jcb = jpq.quantize_codebook(jpq.PQCodebook(jnp.asarray(cent)))
    tcb = tpq.quantize_codebook(tpq.PQCodebook(torch.from_numpy(cent)))
    np.testing.assert_array_equal(tcb.cent8, jcb.cent8)
    np.testing.assert_array_equal(tcb.cent_norms, jcb.cent_norms)
    assert tcb.scale == jcb.scale
    np.testing.assert_array_equal(tpq.cent8_block_diag(tcb.cent8),
                                  jpq.cent8_block_diag(jcb.cent8))
    codes = np.random.default_rng(2).integers(0, 1 << nbits, (500, m)).astype(np.uint8)
    rn = tpq.recon_norms(torch.from_numpy(codes), torch.from_numpy(tcb.cent_norms))
    assert rn.dtype == torch.int32
    np.testing.assert_array_equal(rn.numpy(), jpq.recon_norms(codes, jcb.cent_norms))
    # the int8 rows the scan scores are the block-diagonal decode
    onehot = np.zeros((500, m << nbits), np.float32)
    onehot[np.arange(500)[:, None], codes + (np.arange(m) << nbits)] = 1.0
    r8 = tpq.reconstruct8(torch.from_numpy(codes), torch.from_numpy(tcb.cent8))
    np.testing.assert_array_equal(r8.numpy(), onehot @ jpq.cent8_block_diag(jcb.cent8))


@pytest.mark.parametrize("rot", [False, True])
def test_encode_pq_matches_jax(rot):
    x = _embeddings(3, 3000)
    cent = _codebook(4, 8, 8)
    r = None
    if rot:
        r, _ = np.linalg.qr(np.random.default_rng(5).standard_normal((128, 128)))
        r = r.astype(np.float32)
    want = jpq.encode_pq(x, jpq.PQCodebook(jnp.asarray(cent)), chunk=1000, rot=r)
    got = tpq.encode_pq(x, tpq.PQCodebook(torch.from_numpy(cent)), chunk=1000, rot=r)
    assert got.dtype == np.uint8 and got.shape == (3000, 8)
    np.testing.assert_array_equal(got, want)
    decoded = tpq.pq_reconstruct(got, tpq.PQCodebook(torch.from_numpy(cent)))
    np.testing.assert_array_equal(decoded, jpq.pq_reconstruct(want, jpq.PQCodebook(cent)))


def test_train_pq_matches_jax_on_clustered_data():
    """Same init and Lloyd steps; centroids within 1e-5 (summation order),
    codes equal."""
    x = _clustered(6, 2000)
    jcb = jpq.train_pq(x, m=8, nbits=4, iters=10)
    tcb = tpq.train_pq(x, m=8, nbits=4, iters=10, device="cpu")
    np.testing.assert_allclose(tcb.centroids.numpy(), np.asarray(jcb.centroids),
                               rtol=0, atol=1e-5)
    np.testing.assert_array_equal(tpq.encode_pq(x, tcb), jpq.encode_pq(x, jcb))


def test_train_opq_matches_jax_reconstruction_error():
    """SVD signs may differ across backends, so the rotations are compared
    by what they are for: orthogonality and the PQ reconstruction error,
    within 1% of the JAX package's."""
    x = _clustered(7, 1500, noise=0.05)
    jcb, jrt = jpq.train_opq(x, m=8, nbits=4, iters=3, pq_iters=4)
    tcb, trt = tpq.train_opq(x, m=8, nbits=4, iters=3, pq_iters=4, device="cpu")
    np.testing.assert_allclose(trt @ trt.T, np.eye(128), atol=1e-4)

    def err(cb, rt, mod):
        y = x @ rt
        return float(np.mean((y - mod.pq_reconstruct(mod.encode_pq(y, cb), cb)) ** 2))

    e_jax, e_port = err(jcb, jrt, jpq), err(tcb, trt, tpq)
    assert e_port == pytest.approx(e_jax, rel=0.01), (e_port, e_jax)


def _pq_case(m, nbits, np_=2 * jsk.CT, qp=jsk.QT, seed=8):
    rng = np.random.default_rng(seed)
    ksub = 1 << nbits
    codes = rng.integers(0, ksub, (np_, m)).astype(np.uint8)
    codes[100:140] = codes[99]  # duplicate rows: in-window ties
    cent8 = rng.integers(-127, 128, (m, ksub, 128 // m)).astype(np.int8)
    q8 = rng.integers(-127, 128, (qp, 128)).astype(np.int8)
    return codes, cent8, q8


def _jax_pq_args(q8, codes, cent8):
    qt_b = jnp.asarray(q8.T.astype(np.float32), jnp.bfloat16)
    codes_t = jnp.asarray(codes.T.astype(np.int32))
    cent2d = jnp.asarray(cent8.reshape(-1, cent8.shape[-1]).astype(np.float32),
                         jnp.bfloat16)
    return qt_b, codes_t, cent2d


@pytest.mark.parametrize("m,nbits", MN_SCAN)
@pytest.mark.parametrize("ratio", RATIOS)
def test_pq_winmin_reference_matches_pallas(m, nbits, ratio):
    codes, cent8, q8 = _pq_case(m, nbits)
    ntotal = codes.shape[0] - 300  # mask part of the last tile
    ratio2 = 2.0 * float(np.float32(ratio))
    qt_b, codes_t, cent2d = _jax_pq_args(q8, codes, cent8)
    vj, aj = jsk._pq_winmin_call(qt_b, codes_t, ntotal, cent2d, jnp.float32(ratio2),
                                 interpret=True)
    before = kernels.PQ_WINMIN.launches
    vt, at = tsk.pq_winmin(torch.from_numpy(q8), torch.from_numpy(codes),
                           torch.from_numpy(cent8), ntotal, ratio2)
    assert kernels.PQ_WINMIN.launches == before  # CPU: plain version
    assert vt.dtype == torch.float32 and at.dtype == torch.int32
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    np.testing.assert_array_equal(at.numpy(), np.asarray(aj))


def _tie_case(np_=2 * jsk.CT, qp=jsk.QT, seed=9):
    """Tie-heavy PQ inputs: a codebook of entries in {-1, 0, 1} with 4
    entries a subspace (nbits 2), m = 8, and every row one of 16 code
    patterns, so each 128-row window holds each pattern ~8 times and most
    window minima are shared by several rows."""
    rng = np.random.default_rng(seed)
    patterns = rng.integers(0, 4, (16, 8)).astype(np.uint8)
    codes = patterns[rng.integers(0, 16, np_)]
    cent8 = rng.integers(-1, 2, (8, 4, 16)).astype(np.int8)
    q8 = rng.integers(-127, 128, (qp, 128)).astype(np.int8)
    return codes, cent8, q8


@pytest.mark.parametrize("ratio", RATIOS)
def test_pq_winmin_reference_matches_pallas_on_ties(ratio):
    """The tie-heavy case against the JAX kernel in interpret mode: only the
    lowest-row rule tells most windows' answers apart."""
    codes, cent8, q8 = _tie_case()
    ntotal = codes.shape[0] - 300
    ratio2 = 2.0 * float(np.float32(ratio))
    qt_b, codes_t, cent2d = _jax_pq_args(q8, codes, cent8)
    vj, aj = jsk._pq_winmin_call(qt_b, codes_t, ntotal, cent2d, jnp.float32(ratio2),
                                 interpret=True)
    vt, at = tsk.pq_winmin(torch.from_numpy(q8), torch.from_numpy(codes),
                           torch.from_numpy(cent8), ntotal, ratio2)
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    np.testing.assert_array_equal(at.numpy(), np.asarray(aj))
    # the case is tie-heavy: most (window, query) minima are shared by rows
    rows = tpq.reconstruct8(torch.from_numpy(codes), torch.from_numpy(cent8)).double()
    s = ((rows * rows).sum(1)[:, None] - ratio2 * rows @ torch.from_numpy(q8).double().T)
    s3 = s.float()[: ntotal // tsk.W * tsk.W].reshape(-1, tsk.W, q8.shape[0])
    shared = ((s3 == s3.amin(1, keepdim=True)).sum(1) > 1).double().mean()
    assert shared > 0.5, float(shared)


@pytest.mark.parametrize("ratio", RATIOS)
def test_fused_scan_topk_pq_matches_jax(ratio):
    """Two chunks of the PQ store, plain-driven, against the JAX fused scan
    with its exact top-k."""
    codes, cent8, q8 = _pq_case(8, 8)
    n, k = codes.shape[0] - 3000, 16
    qt_b, codes_t, cent2d = _jax_pq_args(q8, codes, cent8)
    dj, ij = jsk.fused_scan_topk(qt_b, codes_t, n, k, jsk.CT, "pq", cent2d=cent2d,
                                 ratio=ratio, exact=True, interpret=True)
    dt, it = tsk.fused_scan_topk(torch.from_numpy(q8), torch.from_numpy(codes), n, k,
                                 tsk.CT, ratio=ratio, cent8=torch.from_numpy(cent8))
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
    assert it.dtype == torch.int64 and bool((it < n).all())
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))


def test_pq_winmin_rejects_bad_inputs():
    codes, cent8, q8 = (torch.from_numpy(a) for a in _pq_case(8, 8, np_=256, qp=128))
    with pytest.raises(TypeError):
        tsk.pq_winmin(q8, codes.int(), cent8, 256, 2.0)
    with pytest.raises(ValueError):
        tsk.pq_winmin(q8, codes[:, :4], cent8, 256, 2.0)
    with pytest.raises(ValueError):
        tsk.pq_winmin(q8, codes[:200], cent8, 200, 2.0)


def _save_config(path, n):
    from deepreadmapper_tpu.io.configstore import save_config

    save_config({"index_type": "PQFLAT", "stride": 1, "ref_len": 150,
                 "n_vects": n, "dim": 128}, path)


@pytest.mark.parametrize("opq", [False, True])
@pytest.mark.parametrize("query_scale", [1.0, 3.0])  # 3.0: ratio != 1
def test_pqflat_exact_search_matches_jax(tmp_path, opq, query_scale):
    """The same pq.npz searched by both engines' exact scans: ids and
    distances bit for bit (the OPQ rotation of the queries included)."""
    ref = _embeddings(9, 5000)
    q = _embeddings(10, 70) * np.float32(query_scale)
    cfg = BuildConfig(m_pq=8, nbits=6, kmeans_iters=5, opq=opq, opq_iters=2)
    jidx = jpqf.PQFlatIndex.build(ref, cfg)
    jidx.save(str(tmp_path))
    _save_config(str(tmp_path), ref.shape[0])
    tidx, _ = load_index(str(tmp_path), device="cpu")
    assert isinstance(tidx, tpqf.PQFlatIndex) and (tidx.rot is not None) == opq
    ji, jd = jidx.search(q, 64, exact=True)
    ti, td = tidx.search(q, 64, exact=True)
    assert ti.dtype == np.int64 and td.dtype == np.float32
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(td, jd)
    # the default (non-fused on CPU) path is the same scan
    ti2, td2 = tidx.search(q, 64)
    np.testing.assert_array_equal(ti2, ti)
    # k > N pads like the JAX engine
    small = tpqf.PQFlatIndex(jidx.codes[:10], tidx.codebook, 10, tidx.rot, device="cpu")
    si, sd = small.search(q[:3], 16)
    assert (si[:, 10:] == -1).all() and np.isinf(sd[:, 10:]).all()


@pytest.mark.parametrize("m", [8, 64])
def test_pqflat_fused_top1_distance_is_the_exact_scans_at_ratio_one(m):
    """PQFLAT's fused route (pq_winmin's plain version on the CPU) and its
    exact scan score the same int8 rows.  Where the queries fit the
    codebook's scale (query scale ratio exactly 1) every term is an exact
    integer, so the top-1 distances are equal bit for bit; chip_smoke.py
    phase 6 holds the card to this at M_pq 64.  Past that scale each scan
    rounds once, in its own order (at ratio 1.01 a third of these top-1
    distances differ)."""
    rng = np.random.default_rng(m)
    n = 2 * tsk.CT - 1000
    engine = tpqf.PQFlatIndex.build(rng.standard_normal((n, 128)).astype(np.float32),
                                    TBuildConfig(m_pq=m, kmeans_iters=2), device="cpu")
    codes = torch.from_numpy(np.pad(engine.codes, ((0, 2 * tsk.CT - n), (0, 0))))
    cent8 = torch.from_numpy(engine.cb8.cent8)

    def fused(q8, k, ratio):
        return tsk.fused_scan_topk(q8, codes, n, k, tsk.CT, ratio=ratio, cent8=cent8,
                                   winmin=tsk.pq_winmin_reference)

    sc = np.float32(engine.cb8.scale)
    q = rng.standard_normal((tsk.QT, 128)).astype(np.float32)
    q *= np.float32(0.999 * 127.0 * sc / np.abs(q).max())
    assert query_scale_ratio(q, sc)[1] == 1
    _, fd = search_quantized(q, 10, n, sc, engine.device, fused, None)
    _, ed = engine.search(q, 10, exact=True)
    np.testing.assert_array_equal(fd[:, 0], ed[:, 0])


@pytest.mark.parametrize("opq", [False, True])
def test_pq_npz_cross_loads(tmp_path, opq):
    """pq.npz written by either package loads in the other (rot present or
    not) and answers the same queries the same way."""
    from deepreadmapper_tpu.index.registry import load_index as jload

    ref = _embeddings(11, 3000)
    q = _embeddings(12, 40)
    cfg = BuildConfig(m_pq=8, nbits=6, kmeans_iters=4, opq=opq, opq_iters=2)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    jpqf.PQFlatIndex.build(ref, cfg).save(jdir)
    tpqf.PQFlatIndex.build(ref, cfg, device="cpu").save(tdir)
    for d in (jdir, tdir):
        _save_config(d, ref.shape[0])
        z = dict(np.load(os.path.join(d, "pq.npz")))
        assert sorted(z) == sorted(["codes", "centroids", "ntotal"] + (["rot"] if opq else []))
        assert z["codes"].dtype == np.uint8 and z["centroids"].dtype == np.float32
        je, _ = jload(d)
        te, _ = load_index(d, device="cpu")
        np.testing.assert_array_equal(te.codes, je.codes)
        ji, jd = je.search(q, 32, exact=True)
        ti, td = te.search(q, 32, exact=True)
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(td, jd)


def test_pqflat_build_matches_jax_on_clustered_data():
    x = _clustered(13, 3200)  # the half sample's init hits every cluster
    cfg = BuildConfig(m_pq=8, nbits=4, kmeans_iters=8)
    jidx = jpqf.PQFlatIndex.build(x, cfg)
    tidx = tpqf.PQFlatIndex.build(x, cfg, device="cpu")
    assert tidx.ntotal == jidx.ntotal and tidx.rot is None
    np.testing.assert_array_equal(tidx.codes, np.asarray(jidx.codes))
    np.testing.assert_allclose(tidx.codebook.centroids.numpy(),
                               np.asarray(jidx.codebook.centroids), atol=1e-5)


def _int_adc_inputs(seed, q=37, c=300, m=8, ksub=256, dsub=16):
    """Integer-valued queries, centroids and codes: every sum of the ADC
    forms is an exact integer in fp32, whatever order it is summed in."""
    rng = np.random.default_rng(seed)
    queries = rng.integers(-3, 4, (q, m * dsub)).astype(np.float32)
    cent = rng.integers(-3, 4, (m, ksub, dsub)).astype(np.float32)
    codes = rng.integers(0, ksub, (c, m)).astype(np.uint8)
    return queries, cent, codes


@pytest.mark.parametrize("m,ksub", [(8, 256), (16, 256), (4, 64)])
def test_adc_forms_match_jax_exactly_on_integers(m, ksub):
    """adc_tables, adc_distances_gather, codes_to_onehot and
    adc_distances_onehot equal the JAX package's bit for bit on integer
    inputs."""
    queries, cent, codes = _int_adc_inputs(m, m=m, ksub=ksub, dsub=128 // m)
    jt = np.asarray(jpq.adc_tables(jnp.asarray(queries), jnp.asarray(cent)))
    tt = tpq.adc_tables(queries, torch.from_numpy(cent))
    assert tt.shape == (queries.shape[0], m, ksub) and tt.dtype == torch.float32
    np.testing.assert_array_equal(tt.numpy(), jt)
    jg = np.asarray(jpq.adc_distances_gather(jnp.asarray(jt), jnp.asarray(codes)))
    tg = tpq.adc_distances_gather(tt, torch.from_numpy(codes))
    np.testing.assert_array_equal(tg.numpy(), jg)
    joh = np.asarray(jpq.codes_to_onehot(jnp.asarray(codes), ksub=ksub).astype(jnp.float32))
    toh = tpq.codes_to_onehot(torch.from_numpy(codes), ksub=ksub)
    assert toh.dtype == torch.bfloat16 and toh.shape == (codes.shape[0], m * ksub)
    np.testing.assert_array_equal(toh.float().numpy(), joh)
    jo = np.asarray(jpq.adc_distances_onehot(jnp.asarray(jt), jnp.asarray(joh, jnp.bfloat16)))
    to = tpq.adc_distances_onehot(tt, toh)
    assert to.dtype == torch.float32
    np.testing.assert_array_equal(to.numpy(), jo)


def test_adc_forms_match_jax_on_real_codebook():
    """On a trained codebook and tanh-bounded queries: the tables and the
    gather form within fp32 summation noise; the one-hot form rounds the
    table to bf16 as the JAX package does (equal within one fp32 ulp of the
    sum), and sits within bf16 rounding of the gather form."""
    cb = _codebook(5, 8, 8)
    queries = _embeddings(6, 50)
    codes = jpq.encode_pq(_embeddings(7, 400), jpq.PQCodebook(jnp.asarray(cb)))
    jt = np.asarray(jpq.adc_tables(jnp.asarray(queries), jnp.asarray(cb)))
    tt = tpq.adc_tables(queries, torch.from_numpy(cb))
    np.testing.assert_allclose(tt.numpy(), jt, rtol=1e-5, atol=1e-5)
    jg = np.asarray(jpq.adc_distances_gather(jnp.asarray(jt), jnp.asarray(codes)))
    tg = tpq.adc_distances_gather(torch.from_numpy(jt.copy()), torch.from_numpy(codes))
    np.testing.assert_allclose(tg.numpy(), jg, rtol=1e-6, atol=1e-5)
    joh = jpq.codes_to_onehot(jnp.asarray(codes))
    jo = np.asarray(jpq.adc_distances_onehot(jnp.asarray(jt), joh))
    to = tpq.adc_distances_onehot(torch.from_numpy(jt.copy()),
                                  tpq.codes_to_onehot(torch.from_numpy(codes)))
    np.testing.assert_allclose(to.numpy(), jo, rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(to.numpy(), tg.numpy(), rtol=1e-2, atol=1e-2)
