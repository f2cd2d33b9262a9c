"""The port's sharded index (``parallel/``) against the JAX package's on
conftest's 8-device CPU mesh: the same integer-valued inputs from a seed,
so every fp32 sum is exact and answers must be equal, ids and distances.

The JAX package builds and saves each sharded index and both packages
search the saved files (the port through ``ShardedANNIndex.load``); the
reverse direction builds with the port and searches with both.  The rows
(1,001) divide by neither shard count, so the repeated pad rows, the
boundary shard's mask and the queries that tie with the pad rows (the
last row is among them) are all exercised.  The JAX IVF shards run their
Pallas kernels in interpret mode, the port's their plain versions.  The
HNSWPQ shards' trained centroids are rounded to integers before the save
(the codes stay), so their ADC sums are exact too."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepreadmapper_tpu.parallel.sharded_ann as jsa
from deepreadmapper_tpu.config import BuildConfig as JBuildConfig
from deepreadmapper_tpu.ops import ivf_kernel as jik
from deepreadmapper_tpu.ops import pq as jpq
from deepreadmapper_tpu.parallel import distributed as jdist
from deepreadmapper_tpu.parallel import mesh as jmesh
from deepreadmapper_tpu.parallel.sharded_search import sharded_l2_topk as jsharded_l2_topk
import deepreadmapper_tpu_torch.parallel.sharded_ann as tsa
from deepreadmapper_tpu_torch.config import BuildConfig as TBuildConfig
from deepreadmapper_tpu_torch.ops import pq as tpq
from deepreadmapper_tpu_torch.parallel import distributed as tdist
from deepreadmapper_tpu_torch.parallel import mesh as tmesh
from deepreadmapper_tpu_torch.parallel.sharded_search import sharded_l2_topk
from jax_native_guard import _jax_native_loaded  # noqa: F401  (module fixture)

N, D, NQ, K = 1001, 128, 40, 10
KINDS = ("FLAT", "INT8FLAT", "PQFLAT", "IVFINT8", "IVFPQ", "HNSWPQ", "HNSWFLAT")
_CFG = dict(nbits=4, kmeans_iters=5, m_hnsw=8, efc=40)
# ef per kind: the beam width (graph), nprobe (IVF: a partial probe and a
# full one, which probes past the smaller shards' cluster counts)
_EFS = {"IVFINT8": (4, 10**6), "IVFPQ": (4, 10**6), "HNSWPQ": (32,), "HNSWFLAT": (32,)}


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(13)
    x = rng.integers(-8, 9, (N, D)).astype(np.float32)
    rows = np.linspace(0, N - 1, NQ).astype(np.int64)  # every shard, and the last row
    q = np.clip(x[rows] + rng.integers(-1, 2, (NQ, D)), -8, 8).astype(np.float32)
    return x, q


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(jik, "INTERPRET", True)


def _meshes(n_data, n_shard):
    return (jmesh.make_mesh(n_data=n_data, n_shard=n_shard),
            tmesh.make_mesh(n_data=n_data, n_shard=n_shard, devices=["cpu"]))


def _integer_centroids(idx, pq_codebook, rnd):
    """HNSWPQ: round each shard's trained PQ centroids to integers."""
    if idx.index_type == "HNSWPQ":
        for sub in idx.subs:
            sub.codebook = pq_codebook(rnd(sub.codebook.centroids))


def _queries_for(idx, q):
    """IVFPQ: the queries clipped to the shards' smallest codebook range
    (integers), so they quantize at ratio 1 and the conversion to squared
    L2, (score + r^2 qn) s^2, rounds alike whether XLA fuses it into a
    multiply-add or not: the JAX sharded search fuses it in some programs
    and not in others (ROADMAP Queue C)."""
    if idx.index_type != "IVFPQ":
        return q
    m = np.floor(min(float(sub.cb8.scale) * 127 for sub in idx.subs))
    return np.clip(q, -m, m)


def _assert_same(t, j, what):
    np.testing.assert_array_equal(t[0], j[0], err_msg=f"ids {what}")
    np.testing.assert_array_equal(t[1], j[1], err_msg=f"dists {what}")


_CASES = [pytest.param(kind, d, s, False, id=f"{kind}-d{d}s{s}")
          for kind in KINDS for d, s in ((1, 2), (1, 4), (2, 2))]
_CASES += [pytest.param(kind, 1, 2, True, id=f"{kind}-d1s2-fold")
           for kind in ("IVFINT8", "IVFPQ")]


@pytest.mark.parametrize("kind,n_data,n_shard,fold", _CASES)
def test_jax_built_index_searches_alike(kind, n_data, n_shard, fold, data, tmp_path,
                                        interpret, monkeypatch):
    """JAX builds and saves; the port loads; both search: equal ids and
    distances (fold: both packages' fold threshold patched to 1 query)."""
    if fold:
        monkeypatch.setattr(jsa, "IVF_FOLD_MIN_Q", 1)
        monkeypatch.setattr(tsa, "IVF_FOLD_MIN_Q", 1)
    x, q = data
    jm, tm = _meshes(n_data, n_shard)
    jidx = jsa.ShardedANNIndex.build(x, jm, JBuildConfig(**_CFG), index_type=kind)
    _integer_centroids(jidx, jpq.PQCodebook, jnp.round)
    jidx.save(str(tmp_path))
    tidx = tsa.ShardedANNIndex.load(str(tmp_path), tm)
    assert (tidx.kind, tidx.n_local, tidx.ntotal) == (jidx.kind, jidx.n_local, N)
    q = _queries_for(tidx, q)
    for ef in _EFS.get(kind, (0,)):
        want = jidx.search(q, K, ef=ef)
        got = tidx.search(q, K, ef=ef)
        _assert_same(got, want, f"{kind} ef={ef}")
        assert got[0].max() < N and (got[0][:, 0] >= 0).all()


_PORT_CASES = [pytest.param(kind, None, id=kind) for kind in KINDS]
_PORT_CASES += [pytest.param("IVFPQ", 64, id="IVFPQ-m64")]


@pytest.mark.parametrize("kind,m_pq", _PORT_CASES)
def test_port_built_index_searches_alike_in_jax(kind, m_pq, data, tmp_path, interpret):
    """The port builds and saves (2 shards); the JAX package loads the same
    files; both search alike.  The port's shards equal the JAX package's
    engines' on disk too: the JAX search of the port's files equals the
    port's.  IVFPQ also at M_pq 64 (2-byte codebook entries)."""
    x, q = data
    jm, tm = _meshes(1, 2)
    cfg = TBuildConfig(**_CFG) if m_pq is None else TBuildConfig(**_CFG, m_pq=m_pq)
    tidx = tsa.ShardedANNIndex.build(x, tm, cfg, index_type=kind)
    if m_pq is not None:
        assert all(sub.codebook.m == m_pq for sub in tidx.subs)
    _integer_centroids(tidx, tpq.PQCodebook, torch.round)
    tidx.save(str(tmp_path))
    assert jsa.read_manifest(str(tmp_path)) == {"n_shard": "2", "ntotal": str(N),
                                                "inner": kind}
    jidx = jsa.ShardedANNIndex.load(str(tmp_path), jm)
    q = _queries_for(tidx, q)
    for ef in _EFS.get(kind, (0,)):
        _assert_same(tidx.search(q, K, ef=ef), jidx.search(q, K, ef=ef),
                     f"{kind} ef={ef}")


@pytest.mark.parametrize("n_shard", [2, 4])
def test_sharded_l2_topk_equals_jax(n_shard, data):
    x, q = data
    refs = x[:1000]  # divides by both shard counts
    jm, tm = _meshes(2, n_shard)
    jd, ji = jsharded_l2_topk(q, refs, 12, jm)
    td, ti = sharded_l2_topk(q, refs, 12, tm)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    with pytest.raises(ValueError, match="not divisible"):
        sharded_l2_topk(q, x, 12, tm)


def test_compose_global_ids_beyond_int32():
    n_local = 2**30 + 7
    local = np.array([[0, 5, -1, n_local - 1]], np.int32)
    shard = np.array([[0, 3, -1, 7]], np.int32)
    got = tsa.compose_global_ids(local, shard, n_local)
    np.testing.assert_array_equal(got, jsa.compose_global_ids(local, shard, n_local))
    assert got.dtype == np.int64 and got.max() > 2**32


@pytest.mark.parametrize("n,shards", [(1001, 4), (5, 4), (16, 4), (1, 2), (100, 1)])
def test_plan_shards_equals_jax(n, shards):
    assert tdist.plan_shards(n, shards) == jdist.plan_shards(n, shards)


def test_own_shards_and_manifest_equal_jax(tmp_path):
    for n, pid, nproc in ((8, 0, 2), (8, 1, 2), (8, 3, 4), (4, 0, 1), (6, 2, 3)):
        assert (tdist.own_shards(n, pid, nproc) == jdist.own_shards(n, pid, nproc))
    for n, nproc in ((6, 4), (3, 2)):
        with pytest.raises(ValueError) as te:
            tdist.own_shards(n, 0, nproc)
        with pytest.raises(ValueError) as je:
            jdist.own_shards(n, 0, nproc)
        assert str(te.value) == str(je.value)
    # one process: this process owns every shard
    assert tdist.own_shards(3) == [0, 1, 2]
    (tmp_path / "sharded.txt").write_text("n_shard:3\nntotal:17\n\ninner:IVFPQ\nbad line\n")
    assert tsa.read_manifest(str(tmp_path)) == jsa.read_manifest(str(tmp_path))


def test_build_own_shards_layout_equals_jax(data, tmp_path):
    """Per-process builds, one process at a time as each of two ranks:
    the same shard directories and manifest as the JAX package's, each
    shard's codes equal (a tail shard padded with the last row)."""
    x, _ = data
    for tag, mod in (("t", tdist), ("j", jdist)):
        for pid in (0, 1):
            kw = {"device": "cpu"} if tag == "t" else {}
            mine = mod.build_own_shards(lambda s, e: x[s:e], N, 2, str(tmp_path / tag),
                                        index_type="INT8FLAT", process_id=pid,
                                        num_processes=2, codes_scale=8 / 127, **kw)
            assert mine == [pid]
    assert ((tmp_path / "t" / "sharded.txt").read_text()
            == (tmp_path / "j" / "sharded.txt").read_text())
    for si in (0, 1):
        with np.load(tmp_path / "t" / f"shard_{si}" / "int8.npz") as t, \
                np.load(tmp_path / "j" / f"shard_{si}" / "int8.npz") as j:
            for key in ("codes", "scale", "ntotal"):
                np.testing.assert_array_equal(t[key], j[key])
    subs, mine, meta = tdist.load_own_shards(str(tmp_path / "j"), 1, 2, device="cpu")
    assert mine == [1] and len(subs) == 1 and meta["ntotal"] == str(N)


def test_mesh_shapes_and_errors():
    for n_data, n_shard in ((4, 2), (1, 4), (2, 2)):
        m = tmesh.make_mesh(n_data=n_data, n_shard=n_shard, devices=["cpu"])
        assert m.shape == jmesh.make_mesh(n_data=n_data, n_shard=n_shard).shape
    devs = [f"cuda:{i}" for i in range(8)]
    m = tmesh.make_mesh(n_shard=2, devices=devs)
    assert m.shape == {"data": 4, "shard": 2}
    assert [str(d) for d in m.devices[:, 1]] == ["cuda:1", "cuda:3", "cuda:5", "cuda:7"]
    # shared devices: shard s on devices[s % len]
    m = tmesh.make_mesh(n_data=1, n_shard=4, devices=["cuda:0", "cuda:1"])
    assert [str(m.shard_device(s)) for s in range(4)] == ["cuda:0", "cuda:1"] * 2
    # the distributed mesh: contiguous shard columns, as the JAX one
    import jax

    jd = jmesh.make_distributed_mesh(2, jax.devices())
    td = tmesh.make_distributed_mesh(2, devs)
    assert td.shape == jd.shape == {"data": 4, "shard": 2}
    assert [str(d) for d in td.devices[0]] == ["cuda:0", "cuda:4"]
    td = tmesh.make_distributed_mesh(4, ["cuda:0", "cuda:1"])
    assert [str(td.shard_device(s)) for s in range(4)] == ["cuda:0"] * 2 + ["cuda:1"] * 2
    with pytest.raises(ValueError) as te:
        tmesh.make_distributed_mesh(3, devs)
    with pytest.raises(ValueError) as je:
        jmesh.make_distributed_mesh(3, jax.devices())
    assert str(te.value) == str(je.value)
