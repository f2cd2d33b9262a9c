"""Port parity: the chunked IVF scans, the plans, the merges and the IVFINT8
engine against the JAX package (its Pallas kernels in interpret mode on CPU).

The scans are integer-exact (int8 dot products, one FMA rounding of the
score at ratio != 1), so the plain versions hold bit for bit: packed visit
states on every visit the plan references, fold accumulator rows [0, nq).
The plans are the same integer programs and are held exactly.  k-means sums
in another order than XLA's matmuls and is held to 1e-5.  Engine searches
on one saved index hold ids and distances exactly on all three routes
(fused device plan, host plan + packed merge, host plan + fold).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepreadmapper_tpu.config import BuildConfig
from deepreadmapper_tpu.index import ivf_int8 as jivf
from deepreadmapper_tpu.ops import ivf_kernel as jik
from deepreadmapper_tpu_torch.index import ivf_int8 as tivf
from deepreadmapper_tpu_torch.index.int8_flat import Int8FlatIndex
from deepreadmapper_tpu_torch.ops import ivf_kernel as tik

CPU = torch.device("cpu")
RATIOS = [1.0, 1.3]
# routes of IVFInt8Index.search: (_FUSED_MAX_PAIRS, _FOLD_MIN_Q)
ROUTES = {"fused": (8192, 4096), "packed": (0, 4096), "fold": (0, 1)}


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two torch threads per test process (the suite runs in parallel)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def clustered(seed=7, n=8000):
    """Clustered rows, as genome-window embeddings are (the JAX tests' data)."""
    rng = np.random.default_rng(seed)
    centers = np.tanh(rng.standard_normal((64, 128))).astype(np.float32)
    x = centers[rng.integers(0, 64, n)] + 0.05 * rng.standard_normal((n, 128)).astype(
        np.float32)
    return np.clip(x, -1, 1)


def engine_pair(amp, seed=0, fills=(4429, 3571, 700, 2100), cap=5120):
    """The same slab layout in both packages: random int8 rows of amplitude
    amp (2: heavy score ties), slabs of 3, 2, 1 and 2 chunks, and six
    clusters on four slabs, so a query probing clusters 0 and 4 (or 2 and
    5) probes one slab twice."""
    rng = np.random.default_rng(seed)
    s = len(fills)
    codes_cm = np.zeros(((s + 1) * cap, 128), np.int8)
    row_ids = np.full((s + 1) * cap, -1, np.int64)
    perm = rng.permutation(sum(fills))
    o = 0
    for si, f in enumerate(fills):
        codes_cm[si * cap:si * cap + f] = rng.integers(-amp, amp + 1, (f, 128))
        row_ids[si * cap:si * cap + f] = perm[o:o + f]
        o += f
    slab_of = np.array([0, 1, 2, 3, 0, 2], np.int32)
    cent = (rng.standard_normal((6, 128)) * amp).astype(np.float32)
    args = (codes_cm, cent, row_ids, slab_of, 1 / 127, sum(fills), cap, s)
    return jivf.IVFInt8Index(*args), tivf.IVFInt8Index(*args, device=CPU)


def probes(rng, nq, nprobe, nlist=6):
    return np.stack([rng.permutation(nlist)[:nprobe] for _ in range(nq)]).astype(np.int32)


def scan_inputs(te, plan, nq, seed):
    """(step_chunk, step_visit, qidx, qsteps, codesC, rnC) as numpy, the
    queries random int8 (row nq of the padded query table is the dump)."""
    sc, sv, qidx, _ = plan
    store, rn, _ = te._chunk_store()
    q8 = np.random.default_rng(seed).integers(-127, 128, (nq, 128)).astype(np.int8)
    qsteps = np.concatenate([q8, np.zeros((1, 128), np.int8)])[qidx]
    return sc, sv, qidx, qsteps, store.numpy(), rn.numpy()


def test_chunk_layout_matches_jax():
    je, te = engine_pair(127)
    for a, b in zip(je._chunk_meta(), te._chunk_meta()):
        np.testing.assert_array_equal(a, b)
    codes_j, rid_j = je._chunk_rows_host()
    store, rn, rid_t = te._chunk_store()
    np.testing.assert_array_equal(store.numpy().reshape(codes_j.shape), codes_j)
    np.testing.assert_array_equal(rid_t, rid_j)
    live = rid_j >= 0
    want = (codes_j.astype(np.int64) ** 2).sum(1)
    np.testing.assert_array_equal(rn.numpy().ravel()[live], want[live])
    assert (rn.numpy().ravel()[~live] == np.float32(3.4e38)).all()
    assert tik.fold_rows(50) == jik.fold_rows(50) and tik.fold_rows(7) == jik.fold_rows(7)
    assert (tik.QTK, tik.KP, tik.CHK, tik.FS) == (jik.QTK, jik.KP, jik.CHK, jik.FS)


@pytest.mark.parametrize("nq,nprobe", [(50, 2), (300, 4), (7, 6)])
def test_build_plan_chunked_matches_jax(nq, nprobe):
    je, te = engine_pair(127)
    probe = probes(np.random.default_rng(nq), nq, nprobe)
    for a, b in zip(je._build_plan_chunked(probe, jik.QTK),
                    te._build_plan_chunked(probe, tik.QTK)):
        np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("nq,nprobe", [(50, 2), (300, 4), (7, 6)])
def test_device_plan_chunked_matches_jax(nq, nprobe):
    je, te = engine_pair(127)
    slabs = te.slab_of[probes(np.random.default_rng(nq + 1), nq, nprobe)]
    nch, cbase, _ = te._chunk_meta()
    s_static = te._worst_chunks(nq, nprobe)
    assert s_static == je._worst_chunks(nq, nprobe)
    want = jivf.device_plan_chunked(jnp.asarray(slabs), jik.QTK, te.n_slabs,
                                    jnp.asarray(nch), jnp.asarray(cbase), s_static)
    got = tivf.device_plan_chunked(torch.from_numpy(slabs), tik.QTK, te.n_slabs,
                                   torch.from_numpy(nch), torch.from_numpy(cbase), s_static)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


@pytest.mark.parametrize("ratio", RATIOS)
@pytest.mark.parametrize("amp", [127, 2])
@pytest.mark.parametrize("mode", ["packed", "fold"])
def test_int8_scan_matches_jax_interpret(mode, amp, ratio):
    """Multi-chunk visits (slabs of up to 3 chunks), padding rows, the pad
    visit, and at amp 2 a tie-heavy table; exact."""
    nq = 60
    je, te = engine_pair(amp, seed=amp)
    plan = te._build_plan_chunked(probes(np.random.default_rng(3), nq, 3), tik.QTK)
    sc, sv, qidx, qsteps, c3, rn = scan_inputs(te, plan, nq, seed=4)
    ratio2 = 2.0 * float(np.float32(ratio))
    t = [torch.from_numpy(a) for a in (sc, sv, qidx, qsteps, c3, rn)]
    j = [jnp.asarray(a) for a in (sc, sv, qidx, qsteps, c3, rn)]
    if mode == "packed":
        want = np.asarray(jik.ivf_chunk_scan_int8(
            j[0], j[1], j[3], j[4], j[5], ratio2, jik.CHK, qidx.shape[0], interpret=True))
        got = tik.ivf_chunk_scan_int8(t[0], t[1], t[3], t[4], t[5], ratio2).numpy()
        vis = np.unique(plan[3].ravel() // tik.QTK)
        assert np.bincount(sv[:-1])[vis].max() == 3  # a visit spans three chunks
        np.testing.assert_array_equal(got[vis].view(np.int32), want[vis].view(np.int32))
    else:
        want = np.asarray(jik.ivf_chunk_scan_int8_fold(
            j[0], j[1], j[2], j[3], j[4], j[5], ratio2, jik.CHK, nq, interpret=True))
        got = tik.ivf_chunk_scan_int8_fold(t[0], t[1], t[2], t[3], t[4], t[5], ratio2,
                                           nq).numpy()
        assert got.shape == want.shape
        np.testing.assert_array_equal(got[:nq].view(np.int32), want[:nq].view(np.int32))


def _visit_length_case(amp, seed=11, nq=40):
    """A hand-made plan over 10 chunks (+ the all-empty dump chunk 10):
    visits 0, 4 and 7 have no steps, visit 1 walks 7 chunks, visit 5 six,
    the others one or two; chunk 4 is half empty (3.4e38 norms) and odd
    chunks are tie-heavy (16 row patterns of values in {-2..2}) unless amp
    is 2, when every chunk is.  -> (sc, sv, qidx, qsteps, codesC, rnC) as
    numpy, 8 visits."""
    rng = np.random.default_rng(seed)
    n_chunks = 11
    codes = rng.integers(-amp, amp + 1, (n_chunks, tik.CHK, 128)).astype(np.int8)
    patterns = rng.integers(-2, 3, (16, 128)).astype(np.int8)
    for c in range(n_chunks):
        if c % 2 or amp == 2:
            codes[c] = patterns[rng.integers(0, 16, tik.CHK)]
    codes[4, 1000:] = 0
    codes[10] = 0
    rn = (codes.astype(np.int64) ** 2).sum(-1).astype(np.float32)
    rn[4, 1000:] = rn[10] = np.float32(3.4e38)
    steps = {1: list(range(7)), 2: [7], 3: [8, 9], 5: list(range(1, 7)), 6: [3]}
    sc = np.array([c for v in sorted(steps) for c in steps[v]], np.int32)
    sv = np.array([v for v in sorted(steps) for _ in steps[v]] + [-1], np.int32)
    qidx = np.stack([np.where(rng.random(tik.QTK) < 0.8, rng.permutation(nq)[:tik.QTK], nq)
                     for _ in range(8)]).astype(np.int32)
    q8 = rng.integers(-127, 128, (nq, 128)).astype(np.int8)
    qsteps = np.concatenate([q8, np.zeros((1, 128), np.int8)])[qidx]
    return sc, sv, qidx, qsteps, codes, rn


@pytest.mark.parametrize("ratio", RATIOS)
@pytest.mark.parametrize("amp", [127, 2])
@pytest.mark.parametrize("mode", ["packed", "fold"])
def test_int8_scan_visit_lengths_match_jax_interpret(mode, amp, ratio):
    """Visits of 0, 1, 2, 6 and 7 chunk steps and tie-heavy chunks against
    the JAX kernels in interpret mode, exact.  A visit with no steps is
    never written by the JAX kernel; the port writes it as (3.4e38, 0)."""
    nq = 40
    sc, sv, qidx, qsteps, c3, rn = _visit_length_case(amp)
    ratio2 = 2.0 * float(np.float32(ratio))
    t = [torch.from_numpy(a) for a in (sc, sv, qidx, qsteps, c3, rn)]
    j = [jnp.asarray(a) for a in (sc, sv, qidx, qsteps, c3, rn)]
    if mode == "packed":
        want = np.asarray(jik.ivf_chunk_scan_int8(
            j[0], j[1], j[3], j[4], j[5], ratio2, jik.CHK, qidx.shape[0], interpret=True))
        got = tik.ivf_chunk_scan_int8(t[0], t[1], t[3], t[4], t[5], ratio2).numpy()
        stepped = np.unique(sv[:-1])
        np.testing.assert_array_equal(got[stepped].view(np.int32),
                                      want[stepped].view(np.int32))
        empty = got[[0, 4, 7]]
        assert (empty[..., :2 * tik.KP] == np.float32(3.4e38)).all()
        assert (empty[..., 2 * tik.KP:].view(np.int32) == 0).all()
    else:
        want = np.asarray(jik.ivf_chunk_scan_int8_fold(
            j[0], j[1], j[2], j[3], j[4], j[5], ratio2, jik.CHK, nq, interpret=True))
        got = tik.ivf_chunk_scan_int8_fold(t[0], t[1], t[2], t[3], t[4], t[5], ratio2,
                                           nq).numpy()
        assert got.shape == want.shape
        np.testing.assert_array_equal(got[:nq].view(np.int32), want[:nq].view(np.int32))


def _packed_with_ties(rng, v):
    """A packed [v, QTK, 4*KP] scan output whose values come from a small
    set (many ties) and whose ids are distinct per column."""
    vals = rng.integers(0, 6, (v, tik.QTK, 2 * tik.KP)).astype(np.float32)
    vals[rng.random(vals.shape) < 0.05] = np.float32(3.4e38)
    ids = rng.permutation(v * tik.QTK * 2 * tik.KP).astype(np.int32)
    ids = ids.reshape(v, tik.QTK, 2 * tik.KP)
    return np.concatenate([vals, ids.view(np.float32)], axis=2)


@pytest.mark.parametrize("nprobe", [2, 8])
def test_merge_packed_matches_jax(nprobe):
    """At nprobe * KP >= 1024 the JAX merge takes approx_max_k; on the CPU
    it returns exactly what the port's stable exact top-k returns, ties
    included, so the two are compared exactly."""
    rng = np.random.default_rng(nprobe)
    q, v, k = 40, 30, 128
    packed = _packed_with_ties(rng, v)
    slot_of = rng.permutation(v * tik.QTK)[:q * nprobe].reshape(q, nprobe).astype(np.int32)
    jd, ji = jik.merge_packed(jnp.asarray(packed), jnp.asarray(slot_of), nprobe, k)
    td, ti = tik.merge_packed(torch.from_numpy(packed), torch.from_numpy(slot_of), nprobe, k)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_merge_fold_matches_jax():
    rng = np.random.default_rng(5)
    q, k = 37, 200
    vals = rng.integers(0, 9, (tik.fold_rows(q), tik.FS * tik.KP)).astype(np.float32)
    ids = rng.permutation(vals.size).astype(np.int32).reshape(vals.shape)
    facc = np.concatenate([vals, ids.view(np.float32)], axis=1)
    jd, ji = jik.merge_fold(jnp.asarray(facc), q, k)
    td, ti = tik.merge_fold(torch.from_numpy(facc), q, k)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_unpack_scan_matches_jax():
    packed = _packed_with_ties(np.random.default_rng(6), 3)
    for a, b in zip(jik.unpack_scan(jnp.asarray(packed)),
                    tik.unpack_scan(torch.from_numpy(packed))):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_split_and_pack_matches_jax():
    """Oversized clusters split by the seeded 2-means (and a forced halving
    for a cluster of identical rows), then first-fit-decreasing packing."""
    rng = np.random.default_rng(11)
    codes = rng.integers(-127, 128, (3000, 128)).astype(np.int8)
    codes[:400] = codes[0]                     # identical rows: 2-means cannot split
    assign = np.where(np.arange(3000) < 400, 0, rng.integers(0, 12, 3000)).astype(np.int32)
    cent0 = rng.standard_normal((12, 128)).astype(np.float32)
    jc, js, jn = jivf._split_and_pack(codes, assign, cent0, 256, 5)
    tc, ts, tn = tivf._split_and_pack(codes, assign, cent0, 256, 5)
    assert jn == tn and len(jc) == len(tc) > 12
    np.testing.assert_array_equal(ts, js)
    for (jr, jcc), (tr, tcc) in zip(jc, tc):
        np.testing.assert_array_equal(tr, jr)
        np.testing.assert_array_equal(tcc, jcc)


def test_kmeans_coarse_matches_jax():
    x = clustered(n=3000) * 127
    nlist = 16
    rng = np.random.default_rng(2)
    init = x[(np.arange(nlist) * (3000 / nlist)).astype(np.int64)]
    init = init + rng.standard_normal(init.shape).astype(np.float32) * 1e-3
    want = np.asarray(jivf._kmeans_coarse(jnp.asarray(x), jnp.asarray(init), nlist, 15))
    got = tivf._kmeans_coarse(torch.from_numpy(x), torch.from_numpy(init), nlist, 15,
                              chunk=1000).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_auto_nlist_and_cap_match_jax():
    for n in (0, 1, 1000, 5000, 123_456, 2_000_000, 40_000_000, 100_000_000):
        assert tivf.auto_nlist(n) == jivf.auto_nlist(n)
    for n in (10, 1702, 39_999_702):
        nl = tivf.auto_nlist(n)
        assert tivf.ivf_cap(n, nl) == max(-(-int(np.ceil(n / nl * 1.25)) // 128) * 128, 128)


def test_build_matches_jax():
    """The same data builds the same index: k-means to 1e-5 leaves every
    assignment, split and slab as the JAX package has it."""
    x = clustered()
    je = jivf.IVFInt8Index.build(x)
    te = tivf.IVFInt8Index.build(x, device=CPU)
    assert (te.cap, te.n_slabs, te.nlist, te.ntotal) == (je.cap, je.n_slabs, je.nlist,
                                                        je.ntotal)
    np.testing.assert_array_equal(te.codes_cm, je.codes_cm)
    np.testing.assert_array_equal(te.row_ids, je.row_ids)
    np.testing.assert_array_equal(te.slab_of, je.slab_of)
    np.testing.assert_allclose(te.centroids, je.centroids, rtol=1e-5, atol=1e-4)
    assert te.scale == je.scale


def test_layout_invariants():
    te = tivf.IVFInt8Index.build(clustered(), BuildConfig(nlist=4), device=CPU)
    ids = te.row_ids[te.row_ids >= 0]
    assert len(ids) == te.ntotal and len(np.unique(ids)) == te.ntotal
    fill = te._slab_fill_counts()
    assert fill.max() <= te.cap and te.cap % tik.KP == 0
    nch, cbase, ntot = te._chunk_meta()
    assert (nch[:-1] == np.maximum(1, -(-fill[:-1] // tik.CHK))).all() and nch[-1] == 1
    assert nch.max() >= 2  # slabs span several chunks at nlist 4
    store, rn, ridC = te._chunk_store()
    live = ridC >= 0
    assert np.array_equal(np.sort(ridC[live]), np.arange(te.ntotal))
    codes = np.empty_like(te.codes_cm[: te.ntotal])
    codes[te.row_ids[te.row_ids >= 0]] = te.codes_cm[te.row_ids >= 0]
    flat = store.numpy().reshape(-1, 128)
    np.testing.assert_array_equal(flat[live], codes[ridC[live]])
    assert (flat[~live] == 0).all() and (rn.numpy().ravel()[~live] == np.float32(3.4e38)).all()
    assert (flat[cbase[-1] * tik.CHK:] == 0).all()  # the dump chunk


@pytest.fixture(scope="module")
def saved_indexes(tmp_path_factory):
    """One IVFINT8 index built and saved by each package (nlist 16, so the
    slabs hold 640 rows and every probe reads real windows)."""
    x = clustered()
    out = {}
    for tag, cls, kw in (("jax", jivf.IVFInt8Index, {}),
                         ("torch", tivf.IVFInt8Index, {"device": CPU})):
        d = str(tmp_path_factory.mktemp(f"ivf_{tag}"))
        cls.build(x, BuildConfig(nlist=16), **kw).save(d)
        out[tag] = d
    return x, out


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("built_by", ["jax", "torch"])
def test_search_matches_jax_on_one_saved_index(saved_indexes, built_by, route, monkeypatch):
    """ivf_int8.npz cross-loads both ways; on the same index both packages
    return the same ids and distances on each route (k 128 over 8 probes:
    the merge is the JAX package's approx_max_k one)."""
    x, dirs = saved_indexes
    fused, fold = ROUTES[route]
    monkeypatch.setattr(jik, "INTERPRET", True)
    for cls in (jivf.IVFInt8Index, tivf.IVFInt8Index):
        monkeypatch.setattr(cls, "_FUSED_MAX_PAIRS", fused)
        monkeypatch.setattr(cls, "_FOLD_MIN_Q", fold)
    je = jivf.IVFInt8Index.load(dirs[built_by])
    te = tivf.IVFInt8Index.load(dirs[built_by], device=CPU)
    q = x[::200][:40] + np.float32(0.01)
    ji, jd = je.search(q, 128, ef=8)
    ti, td = te.search(q, 128, ef=8)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(td, jd)


def test_full_probe_exact_matches_exhaustive_int8():
    """exact=True with every cluster probed scores every row: the exhaustive
    int8 scan's ids and distances.  The two sum the score's terms in
    another order (fp32), so distances agree to 1e-5 (relative and absolute:
    a distance is a difference of far larger terms) and ids are compared
    as sets below the k-th distance."""
    x = clustered(n=4000)
    te = tivf.IVFInt8Index.build(x, BuildConfig(nlist=8), device=CPU)
    flat = Int8FlatIndex(np.round(x / te.scale).clip(-127, 127).astype(np.int8), te.scale,
                         4000, device=CPU)
    q = x[::100] + np.float32(0.01)
    ii, dd = te.search(q, 20, ef=te.nlist, exact=True)
    oi, od = flat.search(q, 20)
    np.testing.assert_allclose(dd, od, rtol=1e-5, atol=1e-5)
    for r in range(len(q)):
        below = dd[r] < dd[r, -1] * (1 - 1e-5)
        assert set(ii[r][below]) <= set(oi[r])


def test_search_edge_cases_and_stats():
    x = clustered(n=300)
    te = tivf.IVFInt8Index.build(x, BuildConfig(nlist=8), device=CPU)
    ii, dd = te.search(x[:4], 400, ef=8)       # k > ntotal pads with -1 / inf
    assert ii.shape == (4, 400) and (ii[:, 300:] == -1).all() and np.isinf(dd[:, 300:]).all()
    ii, _ = te.search(np.zeros((0, 128), np.float32), 5)
    assert ii.shape == (0, 5)
    ii, _ = te.search(x[:4], 5, ef=10_000)     # ef beyond nlist clamps
    assert (ii[:, 0] == np.arange(4)).all()
    stats, timings = {}, {}
    te.search(x[:16], 5, ef=2, stats=stats, timings=timings)
    assert stats["queries"] == 16 and stats["nprobe"] == 2 and stats["nlist"] == te.nlist
    assert 0 < stats["coverage"] <= 1
    assert timings["plan_visits"] >= 1 and timings["plan_steps"] >= timings["plan_visits"]
    assert 1 <= timings["plan_chunks"] <= timings["plan_steps"]


def test_device_defaults_to_the_card():
    """Without device= the engine asks for the CUDA device and raises
    where there is none; it never carries on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    je, _ = engine_pair(127)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tivf.IVFInt8Index(je.codes_cm, je.centroids, je.row_ids, je.slab_of, je.scale,
                          je.ntotal, je.cap, je.n_slabs)


@pytest.mark.parametrize("route", ["host", "device"])
def test_drop_pad_steps_keeps_every_referenced_visit(route):
    """The engine cuts the plan's padding steps before the scan: only the
    pad visit's steps go, and every visit a slot references scans as
    before."""
    nq, nprobe = 40, 3
    _, te = engine_pair(127)
    probe = probes(np.random.default_rng(9), nq, nprobe)
    if route == "host":
        plan = [torch.from_numpy(a) for a in te._build_plan_chunked(probe, tik.QTK)]
    else:
        nch, cbase, _ = te._chunk_meta()
        plan = tivf.device_plan_chunked(torch.from_numpy(te.slab_of[probe]), tik.QTK,
                                        te.n_slabs, torch.from_numpy(nch),
                                        torch.from_numpy(cbase), te._worst_chunks(nq, nprobe))
    cut = tivf.drop_pad_steps(plan)
    vis = torch.unique(plan[3].reshape(-1).long() // tik.QTK)
    pad_visit = int(plan[1][-2])
    assert pad_visit not in set(vis.tolist())
    assert int((plan[1][:-1] != pad_visit).sum()) == cut[0].shape[0] < plan[0].shape[0]
    assert int(cut[1][-1]) == -1 and not bool((cut[1][:-1] == pad_visit).any())
    store, rn, _ = te._chunk_store()
    q8 = torch.from_numpy(np.random.default_rng(1).integers(-127, 128, (nq + 1, 128))
                          .astype(np.int8))
    qsteps = q8[plan[2].long()]
    full = tik.ivf_chunk_scan_int8(plan[0], plan[1], qsteps, store, rn, 2.0)
    short = tik.ivf_chunk_scan_int8(cut[0], cut[1], qsteps, store, rn, 2.0)
    np.testing.assert_array_equal(short[vis].view(torch.int32).numpy(),
                                  full[vis].view(torch.int32).numpy())
