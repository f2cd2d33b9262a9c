"""Port parity: the HNSW engines (HNSWPQ, HNSWFLAT) against the JAX package.

The level assignments and the deterministic builders (the Python insert
builder; the native one up to 1,024 rows, where it inserts sequentially)
give equal graphs.  The batched beam search is held to the JAX function
exactly on integer-valued vectors and centroids, where every fp32 sum is
exact whatever its order and distances tie often; on the fixture's real
embeddings, within fp32 summation noise.  Index files cross-load.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepreadmapper_tpu import native as jnative
from deepreadmapper_tpu.config import BuildConfig as JBuildConfig
from deepreadmapper_tpu.index import hnsw as jh
from deepreadmapper_tpu.index import hnsw_build as jhb
from deepreadmapper_tpu.index.flat import FlatIndex as JFlatIndex
from deepreadmapper_tpu.index.registry import load_index as jload
from deepreadmapper_tpu.io.configstore import save_config
from deepreadmapper_tpu.ops import pq as jpq
from deepreadmapper_tpu_torch import native as tnative
from deepreadmapper_tpu_torch.config import BuildConfig
from deepreadmapper_tpu_torch.index import hnsw as th
from deepreadmapper_tpu_torch.index import hnsw_build as thb
from deepreadmapper_tpu_torch.index.registry import load_index
from deepreadmapper_tpu_torch.ops import pq as tpq
from jax_native_guard import _jax_native_loaded  # noqa: F401  (module fixture)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two torch threads per test process: the suite runs in parallel
    processes."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _int_vectors(seed, n, d=16, lo=-3, hi=3):
    """Integer-valued fp32 vectors: squared distances are exact integers."""
    return np.random.default_rng(seed).integers(lo, hi + 1, (n, d)).astype(np.float32)


def _assert_graphs_equal(tg, jg):
    np.testing.assert_array_equal(tg.neighbors0, jg.neighbors0)
    assert (tg.entry_gid, tg.max_level, tg.m) == (jg.entry_gid, jg.max_level, jg.m)
    assert len(tg.level_gids) == len(jg.level_gids)
    for a, b in zip(tg.level_gids, jg.level_gids):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tg.level_nbrs, jg.level_nbrs):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n,m,seed", [(1000, 16, 5489), (5000, 8, 1), (37, 4, 9)])
def test_level_assignments_match_jax(n, m, seed):
    np.testing.assert_array_equal(thb.assign_levels(n, m, seed),
                                  jhb.assign_levels(n, m, seed))
    x = np.random.default_rng(seed).standard_normal((n, 32)).astype(np.float32)
    np.testing.assert_array_equal(thb.assign_levels_centroid(x, m),
                                  jhb.assign_levels_centroid(x, m))


@pytest.mark.parametrize("level_mode", ["rng", "centroid"])
def test_python_builder_matches_jax(level_mode):
    x = np.random.default_rng(3).standard_normal((300, 16)).astype(np.float32)
    _assert_graphs_equal(thb.build_hnsw_python(x, m=8, efc=40, level_mode=level_mode),
                         jhb.build_hnsw_python(x, m=8, efc=40, level_mode=level_mode))


@pytest.mark.parametrize("n,level_mode", [(1024, "rng"), (700, "centroid")])
def test_native_builder_matches_jax(n, level_mode):
    """Each package's own native library; up to 1,024 rows the native
    builder inserts sequentially, so the graph is deterministic."""
    assert tnative.available() and jnative.available()
    x = np.random.default_rng(4).standard_normal((n, 32)).astype(np.float32)
    tg = thb.build_hnsw(x, m=8, efc=64, level_mode=level_mode)
    jg = jhb.build_hnsw(x, m=8, efc=64, level_mode=level_mode)
    _assert_graphs_equal(tg, jg)


def test_argmin_takes_the_first_minimum():
    """The descent and the beam rely on argmin returning the first of equal
    minima, as jnp.argmin does (planted ties, inf rows included)."""
    x = torch.tensor([[3.0, 1.0, 1.0, 2.0], [float("inf")] * 4, [0.0, 5.0, 0.0, 0.0]])
    assert torch.argmin(x, dim=1).tolist() == [1, 0, 0]
    assert np.asarray(jnp.argmin(jnp.asarray(x.numpy()), axis=1)).tolist() == [1, 0, 0]


def _graph_tensors(g):
    levels = tuple((torch.from_numpy(np.asarray(a, np.int64)),
                    torch.from_numpy(np.asarray(b, np.int32)))
                   for a, b in zip(g.level_gids, g.level_nbrs))
    return torch.from_numpy(g.neighbors0), levels


@pytest.mark.parametrize("mode", ["flat", "pq"])
@pytest.mark.parametrize("ef,k,d,lo", [(32, 10, 16, -3), (48, 48, 16, -3), (32, 10, 5, -1)])
def test_search_device_matches_jax_exactly(mode, ef, k, d, lo):
    """hnsw_search_device on one graph, integer-valued vectors, queries and
    centroids (entries in lo..-lo): ids and distances equal the JAX
    function's.  Duplicate rows and coarse values plant ties in the
    descent's argmin, the beam's argmin and the merge; at d 5 in -1..1
    (243 distinct points for 900 rows) nearly every choice is a tie."""
    x = _int_vectors(10, 900, d=d, lo=lo, hi=-lo)
    x[450:500] = x[400:450]  # duplicate rows: equal distances to any query
    q = _int_vectors(11, 64, d=d, lo=lo, hi=-lo)
    q[:8] = x[:8]  # queries sitting on indexed points
    g = jhb.build_hnsw(x, m=8, efc=48, level_mode="centroid")
    assert g.max_level >= 1
    neigh0, levels = _graph_tensors(g)
    if mode == "flat":
        storage, jstore = torch.from_numpy(x), jnp.asarray(x)
        tq, jq = torch.from_numpy(q), jnp.asarray(q)
    else:
        cent = _int_vectors(12, 16 * d, d=1, lo=lo, hi=-lo).reshape(1, 16, d)
        codes = np.random.default_rng(13).integers(0, 16, (900, 1)).astype(np.uint8)
        codes[450:500] = codes[400:450]
        storage, jstore = torch.from_numpy(codes), jnp.asarray(codes)
        tq = tpq.adc_tables(q, torch.from_numpy(cent))
        jq = jpq.adc_tables(jnp.asarray(q), jnp.asarray(cent))
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    td, ti = th.hnsw_search_device(neigh0, levels, g.entry_gid, storage, tq,
                                   ef=ef, iters=ef, k=k, mode=mode)
    jneigh0, jlevels, jentry = jh._graph_to_device(g)
    jd, ji = jh.hnsw_search_device(jneigh0, jlevels, jentry, jstore, jq,
                                   ef=ef, iters=ef, k=k, mode=mode)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    dd = td.numpy()
    assert (dd[:, 1:] >= dd[:, :-1]).all()
    # the ties were there: equal distances inside the returned lists
    assert (dd[:, 1:] == dd[:, :-1]).mean() > 0.2


def _index_dir(tmp_path, name, engine, n):
    d = str(tmp_path / name)
    engine.save(d)
    save_config({"index_type": "HNSWPQ" if engine.storage_mode == "pq" else "HNSWFLAT",
                 "stride": 1, "ref_len": 150, "n_vects": n, "dim": 128}, d)
    return d


@pytest.fixture(scope="module")
def jax_fixture_indexes(ecoli_embeddings, tmp_path_factory):
    """HNSWPQ and HNSWFLAT built by the JAX package on the fixture's window
    embeddings (the native builder above 1,024 rows is not deterministic,
    so one graph is built and both packages search it)."""
    ref, _ = ecoli_embeddings
    tmp = tmp_path_factory.mktemp("hnsw_fixture")
    out = {}
    for cls in (jh.HNSWPQIndex, jh.HNSWFlatIndex):
        eng = cls.build(ref)
        out[cls.storage_mode] = (eng, _index_dir(tmp, cls.storage_mode, eng, ref.shape[0]))
    return out


@pytest.mark.parametrize("mode", ["pq", "flat"])
def test_search_matches_jax_on_fixture_embeddings(ecoli_embeddings, jax_fixture_indexes,
                                                  mode):
    """The same saved graph searched by both packages at ef 128: distances
    within 1e-5, ids equal where the gaps around them are clear, recall@10
    against the exact oracle within 0.01, and equal effort counters."""
    ref, q = ecoli_embeddings
    jeng, d = jax_fixture_indexes[mode]
    teng, config = load_index(d, device="cpu")
    assert type(teng) is (th.HNSWPQIndex if mode == "pq" else th.HNSWFlatIndex)
    assert config["index_type"] == ("HNSWPQ" if mode == "pq" else "HNSWFLAT")
    jstats, tstats = {}, {}
    ji, jd = jeng.search(q, 64, ef=128, stats=jstats)
    ti, td = teng.search(q, 64, ef=128, stats=tstats)
    assert ti.dtype == np.int64 and td.dtype == np.float32 and ti.shape == (150, 64)
    assert tstats == jstats
    np.testing.assert_allclose(td, jd, rtol=1e-5, atol=1e-5)
    gap = np.diff(jd, axis=1) > 1e-4
    clear = np.concatenate([gap[:, :1], gap[:, :-1] & gap[:, 1:], gap[:, -1:]], 1)
    assert clear.mean() > 0.5
    np.testing.assert_array_equal(ti[clear], ji[clear])
    oracle, _ = JFlatIndex(ref).search(q, 10)

    def recall(ids):
        return np.mean([len(set(oracle[r]) & set(ids[r, :10])) / 10 for r in range(len(q))])

    assert abs(recall(ti) - recall(ji)) <= 0.01, (recall(ti), recall(ji))


def test_effort_counters_match_jax(jax_fixture_indexes, ecoli_embeddings):
    """Counters accumulate queries over calls and record ef = max(ef, k)."""
    _, q = ecoli_embeddings
    jeng, d = jax_fixture_indexes["flat"]
    teng, _ = load_index(d, device="cpu")
    jstats, tstats = {}, {}
    for eng, st in ((jeng, jstats), (teng, tstats)):
        eng.search(q[:20], 5, ef=32, stats=st)
        eng.search(q[20:52], 40, ef=16, stats=st)
    assert tstats == jstats
    assert tstats["queries"] == 52 and tstats["beam_expansions_per_query"] == 40


@pytest.mark.parametrize("engine", ["HNSWPQ", "HNSWFLAT"])
def test_index_files_cross_load(tmp_path, engine):
    """An index built and saved by either package loads in the other and
    answers the same: the same files, and on integer-valued vectors and
    queries (HNSWFLAT: exact distances) equal ids and distances."""
    x = _int_vectors(20, 2000, d=128, lo=-2, hi=2)
    q = _int_vectors(21, 40, d=128, lo=-2, hi=2)
    jcls = jh.HNSWPQIndex if engine == "HNSWPQ" else jh.HNSWFlatIndex
    tcls = th.HNSWPQIndex if engine == "HNSWPQ" else th.HNSWFlatIndex
    cfg = dict(m_hnsw=8, efc=48)
    jdir = _index_dir(tmp_path, "jax", jcls.build(x, JBuildConfig(**cfg)), 2000)
    tdir = _index_dir(tmp_path, "torch", tcls.build(x, BuildConfig(**cfg), "cpu"), 2000)
    with np.load(os.path.join(jdir, "hnsw.npz")) as a, \
            np.load(os.path.join(tdir, "hnsw.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            assert a[key].dtype == b[key].dtype and a[key].shape == b[key].shape, key
    for d in (jdir, tdir):
        je, _ = jload(d)
        te, _ = load_index(d, device="cpu")
        ji, jd = je.search(q, 16, ef=32)
        ti, td = te.search(q, 16, ef=32)
        if engine == "HNSWFLAT":
            np.testing.assert_array_equal(ti, ji)
            np.testing.assert_array_equal(td, jd)
        else:  # ADC tables of trained (non-integer) centroids: fp32 noise
            np.testing.assert_allclose(td, jd, rtol=1e-5, atol=1e-4)
            assert (ti == ji).mean() > 0.95


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_hnswpq_files_cross_load_exactly(tmp_path, writer):
    """An HNSWPQ index with integer-valued centroids (every ADC table entry
    and sum exact), written by one package and read by the other, answers
    with equal ids and distances; the port's 8192-query device batches
    (here 5) do not change the answer."""
    x = _int_vectors(40, 1000, d=16)
    q = _int_vectors(41, 23, d=16)
    graph = jhb.build_hnsw(x, m=8, efc=48)
    cent = _int_vectors(42, 4 * 16, d=4).reshape(4, 16, 4)
    codes = np.random.default_rng(43).integers(0, 16, (1000, 4)).astype(np.uint8)
    if writer == "jax":
        eng = jh.HNSWPQIndex(graph, codes, jpq.PQCodebook(jnp.asarray(cent)), None, 1000)
    else:
        eng = th.HNSWPQIndex(graph, codes, tpq.PQCodebook(torch.from_numpy(cent)), None,
                             1000, "cpu")
    d = _index_dir(tmp_path, "idx", eng, 1000)
    je, _ = jload(d)
    te, _ = load_index(d, device="cpu")
    ji, jd = je.search(q, 12, ef=24)
    ti, td = te.search(q, 12, ef=24)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(td, jd)
    te._Q_BATCH = 5
    bi, bd = te.search(q, 12, ef=24)
    np.testing.assert_array_equal(bi, ti)
    np.testing.assert_array_equal(bd, td)


def test_search_pads_to_k_and_masks_missing_ids():
    """k above the graph's reach: ef = max(ef, k), -1 ids carry inf."""
    x = _int_vectors(30, 40, d=8)
    eng = th.HNSWFlatIndex.build(x, BuildConfig(m_hnsw=4, efc=16), "cpu")
    jeng = jh.HNSWFlatIndex.build(x, JBuildConfig(m_hnsw=4, efc=16))
    ti, td = eng.search(x[:3], 60, ef=8)
    ji, jd = jeng.search(x[:3], 60, ef=8)
    assert ti.shape == (3, 60)
    assert (ti[:, 40:] == -1).all() and np.isinf(td[ti < 0]).all()
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(td, jd)
