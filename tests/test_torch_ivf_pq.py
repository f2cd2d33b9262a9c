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
@pytest.mark.parametrize("m,nbits", [(8, 8), (16, 8), (8, 6), (4, 8), (1, 8), (2, 8),
                                     (64, 8), (128, 8)])
@pytest.mark.parametrize("mode", ["packed", "fold"])
def test_pq_scan_matches_jax_interpret(mode, m, nbits, ratio):
    """Multi-chunk visits and padding rows (code 0, a real codebook row,
    under a 3.4e38 norm); exact.  Every m that divides 128: one subspace
    spanning both half rows (1), codebook entries of 2 and 1 bytes (64,
    128)."""
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


@pytest.mark.parametrize("ratio", [1.0, 1.3])
@pytest.mark.parametrize("mode", ["packed", "fold"])
def test_pq_scan_ties_match_jax_interpret(mode, ratio):
    """A tie-heavy layout: m 4 with ksub 2, so every row is one of 16
    rebuilt rows and most lane windows' best and second-best tie; exact."""
    nq, m = 60, 4
    je, te = pq_layout(m, 1, seed=21)
    rng = np.random.default_rng(22)
    probe = np.stack([rng.permutation(5)[:3] for _ in range(nq)]).astype(np.int32)
    sc, sv, qidx, slot_of = te._build_plan_chunked(probe, tik.QTK)
    (packed, cent2d), rn, _ = te._chunk_store()
    q8 = rng.integers(-127, 128, (nq, 128)).astype(np.int8)
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
        live = want[vis, :, :tik.KP] < np.float32(3.4e38)
        ties = want[vis, :, :tik.KP] == want[vis, :, tik.KP:2 * tik.KP]
        assert ties[live].mean() > 0.5  # most windows' best rows tie
        np.testing.assert_array_equal(got[vis].view(np.int32), want[vis].view(np.int32))
    else:
        want = np.asarray(jik.ivf_chunk_scan_pq_fold(
            j[0], j[1], j[2], j[3], j[4], j[5], cent_bf, ratio2, jik.CHK, m, nq,
            interpret=True))
        got = tik.ivf_chunk_scan_pq_fold(t[0], t[1], t[2], t[3], t[4], t[5], cent2d,
                                         ratio2, m, nq).numpy()
        ties = want[:nq, :tik.KP] == want[:nq, tik.KP:2 * tik.KP]
        assert ties.mean() > 0.5
        np.testing.assert_array_equal(got[:nq].view(np.int32), want[:nq].view(np.int32))


def _pq_visit_length_case(m=16, nbits=8, seed=12, nq=40):
    """A hand-made plan over 10 chunks (+ the all-empty dump chunk 10):
    visits 0, 4 and 7 have no steps, visit 1 walks 7 chunks, visit 5 six,
    the others one or two; chunk 4 is half empty (code 0 under a 3.4e38
    norm) and odd chunks take one of 8 code rows (ties).  -> (sc, sv, qidx,
    qsteps, packedC, rnC, cent2d) as numpy, 8 visits."""
    rng = np.random.default_rng(seed)
    n_chunks, ksub = 11, 1 << nbits
    codes = rng.integers(0, ksub, (n_chunks, tik.CHK, m))
    patterns = rng.integers(0, ksub, (8, m))
    codes[1::2] = patterns[rng.integers(0, 8, (n_chunks // 2, tik.CHK))]
    codes[4, 1000:] = codes[10] = 0
    packed = np.zeros((n_chunks, -(-m // 4), tik.CHK), np.uint32)
    for j in range(m):
        packed[:, j // 4] |= codes[..., j].astype(np.uint32) << np.uint32(8 * (j % 4))
    cent = rng.integers(-127, 128, (m, ksub, 128 // m))
    rows = np.concatenate([cent[j][codes[..., j]] for j in range(m)], axis=-1)
    rn = (rows.astype(np.int64) ** 2).sum(-1).astype(np.float32)
    rn[4, 1000:] = rn[10] = np.float32(3.4e38)
    steps = {1: list(range(7)), 2: [7], 3: [8, 9], 5: list(range(1, 7)), 6: [3]}
    sc = np.array([c for v in sorted(steps) for c in steps[v]], np.int32)
    sv = np.array([v for v in sorted(steps) for _ in steps[v]] + [-1], np.int32)
    qidx = np.stack([np.where(rng.random(tik.QTK) < 0.8, rng.permutation(nq)[:tik.QTK], nq)
                     for _ in range(8)]).astype(np.int32)
    q8 = rng.integers(-127, 128, (nq, 128)).astype(np.int8)
    qsteps = np.concatenate([q8, np.zeros((1, 128), np.int8)])[qidx]
    return (sc, sv, qidx, qsteps, packed.view(np.int32), rn,
            cent.reshape(m * ksub, 128 // m).astype(np.int8))


@pytest.mark.parametrize("ratio", [1.0, 1.3])
@pytest.mark.parametrize("mode", ["packed", "fold"])
def test_pq_scan_visit_lengths_match_jax_interpret(mode, ratio):
    """Visits of 0, 1, 2, 6 and 7 chunk steps, tie-heavy chunks, against
    the JAX kernels in interpret mode, exact.  A visit with no steps is
    never written by the JAX kernel; the port writes it as (3.4e38, 0)."""
    nq, m = 40, 16
    sc, sv, qidx, qsteps, packed, rn, cent2d = _pq_visit_length_case(m)
    ratio2 = 2.0 * float(np.float32(ratio))
    cent_bf = jnp.asarray(cent2d.astype(np.float32), jnp.bfloat16)
    j = [jnp.asarray(a) for a in (sc, sv, qidx, qsteps, packed, rn)]
    t = [torch.from_numpy(a) for a in (sc, sv, qidx, qsteps, packed, rn, cent2d)]
    if mode == "packed":
        want = np.asarray(jik.ivf_chunk_scan_pq(
            j[0], j[1], j[3], j[4], j[5], cent_bf, ratio2, jik.CHK, m, qidx.shape[0],
            interpret=True))
        got = tik.ivf_chunk_scan_pq(t[0], t[1], t[3], t[4], t[5], t[6], ratio2, m).numpy()
        stepped = np.unique(sv[:-1])
        np.testing.assert_array_equal(got[stepped].view(np.int32),
                                      want[stepped].view(np.int32))
        empty = got[[0, 4, 7]]
        assert (empty[..., :2 * tik.KP] == np.float32(3.4e38)).all()
        assert (empty[..., 2 * tik.KP:].view(np.int32) == 0).all()
    else:
        want = np.asarray(jik.ivf_chunk_scan_pq_fold(
            j[0], j[1], j[2], j[3], j[4], j[5], cent_bf, ratio2, jik.CHK, m, nq,
            interpret=True))
        got = tik.ivf_chunk_scan_pq_fold(t[0], t[1], t[2], t[3], t[4], t[5], t[6], ratio2,
                                         m, nq).numpy()
        assert got.shape == want.shape
        np.testing.assert_array_equal(got[:nq].view(np.int32), want[:nq].view(np.int32))


def test_fold_pass_alone_matches_fold_scan():
    """ivf_fold over the packed scan's states gives the fold scan's whole
    accumulator (the fold scans are the packed scan, then this pass)."""
    nq, m = 40, 16
    sc, sv, qidx, qsteps, packed, rn, cent2d = (
        torch.from_numpy(a) for a in _pq_visit_length_case(m))
    states = tik.ivf_chunk_scan_pq(sc, sv, qsteps, packed, rn, cent2d, 2.6, m)
    facc = tik.ivf_chunk_scan_pq_fold(sc, sv, qidx, qsteps, packed, rn, cent2d, 2.6, m, nq)
    got = tik.ivf_fold(states, sv, qidx, nq)
    assert torch.equal(got.view(torch.int32), facc.view(torch.int32))


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


@pytest.mark.parametrize("route", ["packed", "fold"])
@pytest.mark.parametrize("m", [2, 64])
def test_search_at_every_m_pq_matches_jax(m, route, monkeypatch, tmp_path):
    """IVFPQ at M_pq outside 4-32 (the scans once took only those): one
    index built by the port, loaded by both packages, searched on the
    packed and the fold route; ids and distances equal."""
    x = clustered(n=3000)
    d = str(tmp_path / "ivfpq")
    tivfpq.IVFPQIndex.build(x, BuildConfig(nlist=8, m_pq=m, kmeans_iters=4),
                            device=CPU).save(d)
    monkeypatch.setattr(jik, "INTERPRET", True)
    je = jivfpq.IVFPQIndex.load(d)
    te = tivfpq.IVFPQIndex.load(d, device=CPU)
    assert te.codebook.m == je.codebook.m == m
    fused, fold = ROUTES[route]
    for cls in (jivfpq.IVFPQIndex, tivfpq.IVFPQIndex):
        monkeypatch.setattr(cls, "_FUSED_MAX_PAIRS", fused)
        monkeypatch.setattr(cls, "_FOLD_MIN_Q", fold)
    je._fns.clear()
    q = x[::100][:30] + np.float32(0.01)
    ji, jd = je.search(q, 32, ef=4)
    ti, td = te.search(q, 32, ef=4)
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
