"""Port parity: quantization, the INT8FLAT and FLAT engines, cross-loading
of index files between the packages, and the L2 post-processing."""

import os

import numpy as np
import pytest
import torch

from deepreadmapper_tpu.index import flat as jflat
from deepreadmapper_tpu.index import int8_flat as jint8
from deepreadmapper_tpu.pipeline import postprocess as jpp
from deepreadmapper_tpu_torch.index import flat as tflat
from deepreadmapper_tpu_torch.index import int8_flat as tint8
from deepreadmapper_tpu_torch.index.registry import load_index
from deepreadmapper_tpu_torch.pipeline import postprocess as tpp


def _embeddings(seed, n, tie_levels=None):
    """tanh-bounded vectors like encoder outputs; tie_levels quantizes the
    values coarsely so int8 scores tie often."""
    rng = np.random.default_rng(seed)
    x = np.tanh(rng.standard_normal((n, 128))).astype(np.float32)
    if tie_levels:
        x = np.round(x * tie_levels) / tie_levels
    return x.astype(np.float32)


def test_quantize_matches_jax():
    x = _embeddings(0, 500) * 1.5  # some values clip
    x[0, :4] = [0.5 / 127, 1.5 / 127, -2.5 / 127, 127.5 / 127]  # half-way cases
    for scale in (1.0 / 127.0, 0.0123):
        want = np.asarray(jint8.quantize(x, scale))
        got = tint8.quantize(torch.from_numpy(x), scale).numpy()
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(tint8.quantize_host(x, scale),
                                      jint8.quantize_host(x, scale))


@pytest.mark.parametrize("query_scale", [1.0, 3.0])  # 3.0: ratio != 1
@pytest.mark.parametrize("tie_levels", [None, 4])
def test_int8flat_search_matches_jax(query_scale, tie_levels):
    ref = _embeddings(1, 5000, tie_levels)
    q = _embeddings(2, 70, tie_levels) * np.float32(query_scale)
    jidx = jint8.Int8FlatIndex.build(ref)
    tidx = tint8.Int8FlatIndex(jidx.codes, jidx.scale, jidx.ntotal, device="cpu")
    ji, jd = jidx.search(q, 64)
    ti, td = tidx.search(q, 64)
    assert ti.dtype == np.int64 and td.dtype == np.float32
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(td, jd)
    # k > N pads like the JAX engine
    small = tint8.Int8FlatIndex(jidx.codes[:10], jidx.scale, 10, device="cpu")
    si, sd = small.search(q[:3], 16)
    assert (si[:, 10:] == -1).all() and np.isinf(sd[:, 10:]).all()


def test_int8flat_build_matches_jax():
    ref = _embeddings(3, 900) * 0.8
    jidx = jint8.Int8FlatIndex.build(ref)
    tidx = tint8.Int8FlatIndex.build(ref, device="cpu")
    assert tidx.scale == jidx.scale and tidx.ntotal == jidx.ntotal
    np.testing.assert_array_equal(tidx.codes, np.asarray(jidx.codes))


@pytest.mark.parametrize("engine", ["INT8FLAT", "FLAT"])
def test_index_files_cross_load(tmp_path, engine):
    """An index saved by either package loads in the other and answers the
    same queries the same way."""
    from deepreadmapper_tpu.index.registry import load_index as jload
    from deepreadmapper_tpu.io.configstore import save_config

    ref = _embeddings(4, 3000)
    q = _embeddings(5, 40)
    config = {"index_type": engine, "stride": 1, "ref_len": 150,
              "n_vects": ref.shape[0], "dim": 128}
    if engine == "INT8FLAT":
        jcls, tcls = jint8.Int8FlatIndex, tint8.Int8FlatIndex
    else:
        jcls, tcls = jflat.FlatIndex, tflat.FlatIndex
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    (jcls.build(ref) if hasattr(jcls, "build") else jcls(ref)).save(jdir)
    tcls.build(ref, device="cpu").save(tdir)
    for d in (jdir, tdir):
        save_config(config, d)
    files = sorted(os.listdir(jdir))
    assert files == sorted(os.listdir(tdir))
    for d in (jdir, tdir):
        je, _ = jload(d)
        te, _ = load_index(d, device="cpu")
        ji, jd = je.search(q, 32)
        ti, td = te.search(q, 32)
        np.testing.assert_array_equal(ti, ji)
        if engine == "INT8FLAT":
            np.testing.assert_array_equal(td, jd)
        else:
            np.testing.assert_allclose(td, jd, rtol=1e-5, atol=1e-5)


def test_load_index_refuses_unported(tmp_path):
    """A JAX-built HNSWPQ index loads (the engine is ported), and so does a
    JAX-built sharded index (sharded.txt): as the port's ShardedANNIndex,
    answering as the JAX registry's engine does.  Nothing is refused any
    more; an unknown index_type is a ValueError, as in the JAX registry."""
    from deepreadmapper_tpu.index.hnsw import HNSWPQIndex as JHNSWPQIndex
    from deepreadmapper_tpu.io.configstore import save_config
    from deepreadmapper_tpu_torch.index.hnsw import HNSWPQIndex

    ref = _embeddings(6, 600)
    JHNSWPQIndex.build(ref).save(str(tmp_path))
    save_config({"index_type": "HNSWPQ", "stride": 1, "ref_len": 150,
                 "n_vects": 600, "dim": 128}, str(tmp_path))
    engine, config = load_index(str(tmp_path), device="cpu")
    assert isinstance(engine, HNSWPQIndex) and engine.ntotal == 600
    ids, d = engine.search(ref[:5], 4, ef=32)
    assert ids.shape == (5, 4) and (ids[:, 0] == np.arange(5)).all()
    from deepreadmapper_tpu.index.registry import load_index as jload
    from deepreadmapper_tpu.parallel.mesh import make_mesh
    from deepreadmapper_tpu.parallel.sharded_ann import ShardedANNIndex as JSharded
    from deepreadmapper_tpu_torch.parallel.sharded_ann import ShardedANNIndex

    sdir = tmp_path / "sharded"
    JSharded.build(ref, make_mesh(n_data=1, n_shard=2), index_type="INT8FLAT").save(str(sdir))
    save_config({"index_type": "INT8FLAT", "stride": 1, "ref_len": 150,
                 "n_vects": 600, "dim": 128}, str(sdir))
    engine, _ = load_index(str(sdir), device="cpu")
    assert isinstance(engine, ShardedANNIndex) and len(engine.subs) == 2
    ids, d = engine.search(ref[:7], 4)
    jids, jd = jload(str(sdir))[0].search(ref[:7], 4)
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_array_equal(d, jd)
    assert (ids[:, 0] == np.arange(7)).all()
    save_config({"index_type": "NOPE", "stride": 1, "ref_len": 150}, str(tmp_path))
    with pytest.raises(ValueError, match="Unknown index_type"):
        load_index(str(tmp_path), device="cpu")


@pytest.mark.parametrize("stride", [1, 4])
@pytest.mark.parametrize("force_rerank", [False, True])
def test_post_process_l2_matches_jax(stride, force_rerank):
    rng = np.random.default_rng(6)
    n_windows, nq, k_clusters = 800, 30, 5
    bound = 2 * n_windows
    table = _embeddings(7, bound)
    q = (table[rng.integers(0, bound, nq)]
         + 0.05 * rng.standard_normal((nq, 128))).astype(np.float32)
    ncols = k_clusters if stride > 1 else 16
    neighbors = rng.integers(0, bound // stride, (nq, ncols)).astype(np.int64)
    neighbors[0, 1] = -1                     # a missing hit
    neighbors[1, 0] = bound // stride - 1    # an expansion clipped at the end
    distances = rng.random((nq, ncols)).astype(np.float32)
    k = 12 if stride > 1 else 8

    def embed_windows(ids):
        return table[ids]

    ji, jd = jpp.post_process_l2(neighbors, distances, q, embed_windows,
                                 stride, k, k_clusters, bound,
                                 force_rerank=force_rerank)
    ti, td = tpp.post_process_l2(neighbors, distances, q, embed_windows,
                                 stride, k, k_clusters, bound,
                                 force_rerank=force_rerank)
    assert ti.dtype == np.int64 and td.dtype == np.float32
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(td, jd, rtol=1e-5, atol=1e-5)
    if stride > 1:
        with pytest.raises(ValueError):
            tpp.post_process_l2(neighbors, distances, q, embed_windows,
                                stride, 100, k_clusters, bound)


def test_expand_and_pool_match_jax():
    rng = np.random.default_rng(8)
    nb = rng.integers(-1, 400, (20, 6)).astype(np.int64)
    for args in ((4, 1000, 5), (3, 500, 6)):
        for a, b in zip(tpp.expand_candidates(nb, *args),
                        jpp.expand_candidates(nb, *args)):
            np.testing.assert_array_equal(a, b)
    cand, _ = tpp.expand_candidates(nb, 4, 1000, 5)
    for a, b in zip(tpp.unique_pool(cand), jpp.unique_pool(cand)):
        np.testing.assert_array_equal(a, b)
