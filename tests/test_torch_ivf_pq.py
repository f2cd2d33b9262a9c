"""Port parity: the chunked IVFPQ scans and the IVFPQ engine against the JAX
package (its Pallas kernels in interpret mode on CPU).

The PQ scans rebuild each row from its byte-packed codes through the int8
codebook (int8-valued, exact), so they hold bit for bit, as the int8 scans
do.  The coarse assignment rounds the centroids to bf16 and sums in fp32
in both packages; the sums run in another order, so a row at a near-equal
distance to two centroids may flip: the test counts the flips.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepreadmapper_tpu.config import BuildConfig
from deepreadmapper_tpu.index import ivf_pq as jivfpq
from deepreadmapper_tpu.ops import ivf_kernel as jik
from deepreadmapper_tpu.ops import pq as jpq
from deepreadmapper_tpu_torch.index import ivf_pq as tivfpq
from deepreadmapper_tpu_torch.index.pq_flat import PQFlatIndex
from deepreadmapper_tpu_torch.ops import ivf_kernel as tik
from deepreadmapper_tpu_torch.ops import pq as tpq

CPU = torch.device("cpu")
ROUTES = {"fused": (8192, 4096), "packed": (0, 4096), "fold": (0, 1)}


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two torch threads per test process (the suite runs in parallel)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def clustered(seed=7, n=6000):
    rng = np.random.default_rng(seed)
    centers = np.tanh(rng.standard_normal((64, 128))).astype(np.float32)
    x = centers[rng.integers(0, 64, n)] + 0.05 * rng.standard_normal((n, 128)).astype(
        np.float32)
    return np.clip(x, -1, 1)


def pq_layout(m, nbits, seed=0, fills=(4429, 3571, 700), cap=5120):
    """An IVFPQ layout in both packages: random codes and codebook, slabs of
    3, 2 and 1 chunks, five clusters on three slabs."""
    rng = np.random.default_rng(seed)
    ksub = 1 << nbits
    cent = (rng.standard_normal((m, ksub, 128 // m)) * 0.3).astype(np.float32)
    s = len(fills)
    codes_cm = np.zeros(((s + 1) * cap, m), np.uint8)
    row_ids = np.full((s + 1) * cap, -1, np.int64)
    perm = rng.permutation(sum(fills))
    o = 0
    for si, f in enumerate(fills):
        codes_cm[si * cap:si * cap + f] = rng.integers(0, ksub, (f, m))
        row_ids[si * cap:si * cap + f] = perm[o:o + f]
        o += f
    slab_of = np.array([0, 1, 2, 0, 2], np.int32)
    coarse = rng.standard_normal((5, 128)).astype(np.float32)
    args = (codes_cm, coarse, row_ids, slab_of)
    tail = (sum(fills), cap, s)
    return (jivfpq.IVFPQIndex(*args, jpq.PQCodebook(jnp.asarray(cent)), *tail),
            tivfpq.IVFPQIndex(*args, tpq.PQCodebook(torch.from_numpy(cent)), *tail,
                              device=CPU))


def test_host_helpers_match_jax():
    je, te = pq_layout(8, 8)
    np.testing.assert_array_equal(tivfpq.pack_codes_t(te.codes_cm),
                                  jivfpq.pack_codes_t(je.codes_cm))
    np.testing.assert_array_equal(
        tivfpq._recon_int8_host(te.codes_cm[:999], te.cb8.cent8),
        jivfpq._recon_int8_host(je.codes_cm[:999], je.cb8.cent8))
    np.testing.assert_array_equal(
        tpq.recon_norms(torch.from_numpy(te.codes_cm),
                        torch.from_numpy(te.cb8.cent_norms)).numpy(),
        jpq.recon_norms(je.codes_cm, je.cb8.cent_norms))
    packed_j, rn_j, rid_j = je._chunk_packed_host()
    packed_t, rn_t, rid_t = te._chunk_packed_host()
    np.testing.assert_array_equal(packed_t, packed_j)
    np.testing.assert_array_equal(rn_t, rn_j)
    np.testing.assert_array_equal(rid_t, rid_j)


@pytest.mark.parametrize("ratio", [1.0, 1.3])
@pytest.mark.parametrize("m,nbits", [(8, 8), (16, 8), (8, 6)])
@pytest.mark.parametrize("mode", ["packed", "fold"])
def test_pq_scan_matches_jax_interpret(mode, m, nbits, ratio):
    """Multi-chunk visits and padding rows (code 0, a real codebook row,
    under a 3.4e38 norm); exact."""
    nq = 60
    je, te = pq_layout(m, nbits, seed=m + nbits)
    rng = np.random.default_rng(3)
    probe = np.stack([rng.permutation(5)[:3] for _ in range(nq)]).astype(np.int32)
    sc, sv, qidx, slot_of = te._build_plan_chunked(probe, tik.QTK)
    (packed, cent2d), rn, _ = te._chunk_store()
    q8 = np.random.default_rng(4).integers(-127, 128, (nq, 128)).astype(np.int8)
    qsteps = np.concatenate([q8, np.zeros((1, 128), np.int8)])[qidx]
    ratio2 = 2.0 * float(np.float32(ratio))
    cent_bf = jnp.asarray(cent2d.numpy().astype(np.float32), jnp.bfloat16)
    j = [jnp.asarray(a) for a in (sc, sv, qidx, qsteps, packed.numpy(), rn.numpy())]
    t = [torch.from_numpy(a) for a in (sc, sv, qidx, qsteps)] + [packed, rn]
    if mode == "packed":
        want = np.asarray(jik.ivf_chunk_scan_pq(
            j[0], j[1], j[3], j[4], j[5], cent_bf, ratio2, jik.CHK, m, qidx.shape[0],
            interpret=True))
        got = tik.ivf_chunk_scan_pq(t[0], t[1], t[3], t[4], t[5], cent2d, ratio2,
                                    m).numpy()
        vis = np.unique(slot_of.ravel() // tik.QTK)
        np.testing.assert_array_equal(got[vis].view(np.int32), want[vis].view(np.int32))
    else:
        want = np.asarray(jik.ivf_chunk_scan_pq_fold(
            j[0], j[1], j[2], j[3], j[4], j[5], cent_bf, ratio2, jik.CHK, m, nq,
            interpret=True))
        got = tik.ivf_chunk_scan_pq_fold(t[0], t[1], t[2], t[3], t[4], t[5], cent2d,
                                         ratio2, m, nq).numpy()
        np.testing.assert_array_equal(got[:nq].view(np.int32), want[:nq].view(np.int32))


def _codes_and_codebook(seed, x, m=8, nbits=8):
    cb = tpq.train_pq(tpq.sample_training_set(x, 0.5), m=m, nbits=nbits, iters=8,
                      seed=seed, device=CPU)
    return tpq.encode_pq(x, cb), cb.centroids.numpy()


def test_assign_nearest_pq_matches_jax():
    """Rows flip between near-equidistant centroids only: none here."""
    x = clustered()
    codes, cent = _codes_and_codebook(1, x)
    cb8 = tpq.quantize_codebook(tpq.PQCodebook(torch.from_numpy(cent)))
    cent0 = np.random.default_rng(2).standard_normal((32, 128)).astype(np.float32) * 40
    want = np.asarray(jivfpq._assign_nearest_pq(
        jnp.asarray(codes), jnp.asarray(cb8.cent8.astype(np.float32), jnp.bfloat16),
        jnp.asarray(cent0, jnp.bfloat16), jnp.asarray((cent0 * cent0).sum(-1)), 1000))
    got = tivfpq._assign_nearest_pq(codes, cb8.cent8, cent0, CPU, chunk=1000)
    flips = int((got != want).sum())
    assert flips == 0, f"{flips} of {len(got)} assignments flip"


def test_build_from_codes_matches_jax():
    """The same codes and codebook build the same index in both packages."""
    x = clustered()
    codes, cent = _codes_and_codebook(3, x)
    je = jivfpq.IVFPQIndex.build_from_codes(codes, jpq.PQCodebook(jnp.asarray(cent)),
                                            BuildConfig(nlist=16))
    te = tivfpq.IVFPQIndex.build_from_codes(codes, tpq.PQCodebook(torch.from_numpy(cent)),
                                            BuildConfig(nlist=16), device=CPU)
    assert (te.cap, te.n_slabs, te.nlist) == (je.cap, je.n_slabs, je.nlist)
    np.testing.assert_array_equal(te.codes_cm, je.codes_cm)
    np.testing.assert_array_equal(te.row_ids, je.row_ids)
    np.testing.assert_array_equal(te.slab_of, je.slab_of)
    np.testing.assert_allclose(te.centroids, je.centroids, rtol=1e-5, atol=1e-4)
    assert te.scale == je.scale


@pytest.fixture(scope="module")
def saved_indexes(tmp_path_factory):
    """IVFPQ indexes built and saved by each package, with and without OPQ."""
    x = clustered(n=4000)
    out = {}
    for opq in (False, True):
        cfg = BuildConfig(nlist=16, opq=opq, opq_iters=3, kmeans_iters=8)
        for tag, cls, kw in (("jax", jivfpq.IVFPQIndex, {}),
                             ("torch", tivfpq.IVFPQIndex, {"device": CPU})):
            d = str(tmp_path_factory.mktemp(f"ivfpq_{tag}_{opq}"))
            cls.build(x, cfg, **kw).save(d)
            out[tag, opq] = d
    return x, out


@pytest.mark.parametrize("opq", [False, True])
@pytest.mark.parametrize("built_by", ["jax", "torch"])
def test_search_matches_jax_on_one_saved_index(saved_indexes, built_by, opq, monkeypatch):
    """ivf_pq.npz (with rot under OPQ) cross-loads both ways; both packages
    return the same ids and distances on the fused, packed and fold routes."""
    x, dirs = saved_indexes
    monkeypatch.setattr(jik, "INTERPRET", True)
    je = jivfpq.IVFPQIndex.load(dirs[built_by, opq])
    te = tivfpq.IVFPQIndex.load(dirs[built_by, opq], device=CPU)
    assert (te.rot is None) == (not opq)
    if opq:
        np.testing.assert_array_equal(te.rot, je.rot)
    q = x[::100][:40] + np.float32(0.01)
    for fused, fold in ROUTES.values():
        for cls in (jivfpq.IVFPQIndex, tivfpq.IVFPQIndex):
            monkeypatch.setattr(cls, "_FUSED_MAX_PAIRS", fused)
            monkeypatch.setattr(cls, "_FOLD_MIN_Q", fold)
        je._fns.clear()  # the JAX engine bakes the route into its cached programs
        ji, jd = je.search(q, 64, ef=8)
        ti, td = te.search(q, 64, ef=8)
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(td, jd)


def test_full_probe_matches_pqflat_exact():
    """Every cluster probed with exact=True scores every row against its
    reconstruction: PQFLAT's exact scan, distances to 1e-5 (the terms sum
    in another order) and ids as sets below the k-th distance."""
    x = clustered(n=3000)
    te = tivfpq.IVFPQIndex.build(x, BuildConfig(nlist=8, kmeans_iters=8, opq=True,
                                                opq_iters=2), device=CPU)
    codes = np.empty((te.ntotal, te.codes_cm.shape[1]), np.uint8)
    codes[te.row_ids[te.row_ids >= 0]] = te.codes_cm[te.row_ids >= 0]
    flat = PQFlatIndex(codes, te.codebook, te.ntotal, te.rot, device=CPU)
    q = x[::100] + np.float32(0.01)
    ii, dd = te.search(q, 20, ef=te.nlist, exact=True)
    oi, od = flat.search(q, 20, exact=True)
    np.testing.assert_allclose(dd, od, rtol=1e-5, atol=1e-5)
    for r in range(len(q)):
        below = dd[r] < dd[r, -1] * (1 - 1e-5)
        assert set(ii[r][below]) <= set(oi[r])
