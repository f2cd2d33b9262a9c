"""Port parity: the kNN-graph HNSW builder (index/knn_build.py) against the
JAX package's, exactly, on integer-valued vectors (every squared distance
and pairwise term is an exact integer in fp32, so only the tie rules could
make the graphs differ, and integer data ties often)."""

import functools

import numpy as np
import pytest
import torch

from deepreadmapper_tpu.index import knn_build as jknn
from deepreadmapper_tpu_torch.index import knn_build as tknn
from deepreadmapper_tpu_torch.ops import topk
from jax_native_guard import _jax_native_loaded  # noqa: F401  (module fixture)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _int_vectors(seed, n, d=16, lo=-3, hi=3):
    return np.random.default_rng(seed).integers(lo, hi + 1, (n, d)).astype(np.float32)


@pytest.mark.parametrize("n,k,query_chunk", [(600, 10, None), (600, 48, 128), (5, 10, None)])
def test_exact_knn_matches_jax(n, k, query_chunk):
    """Ids and distances equal the JAX function's; the port's query chunk
    does not change the result.  n=5 < k pads with -1 / BIG."""
    x = _int_vectors(1, n)
    x[100:120] = x[50:70] if n > 120 else x[100:120]  # duplicate rows: tied hits
    jd, ji = jknn.exact_knn(x, k)
    td, ti = tknn.exact_knn(x, k, query_chunk=query_chunk, device="cpu")
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(td, jd)


def test_exact_knn_selects_like_a_full_sort():
    """exact_knn's select-then-sort tiles, on wide rows full of ties: the
    same neighbours as the stable full sort, ties to the lower id."""
    x = _int_vectors(2, 9000, d=4, lo=-1, hi=1)  # 81 distinct points: massive ties
    td, ti = tknn.exact_knn(x[:, :4], 12, query_chunk=64, device="cpu")
    sq = (x * x).sum(1)
    for r in (0, 17, 8999):
        d = sq[r] + sq - 2.0 * (x @ x[r])
        d[r] = np.inf
        want = np.argsort(d, kind="stable")[:12]
        np.testing.assert_array_equal(ti[r], want)
        np.testing.assert_array_equal(td[r], d[want])
    scores = torch.from_numpy(x[:64, :4] @ x[:, :4].T)
    for k in (1, 12, 81, 9000):
        got, want = tknn._select_smallest_k(scores, k), topk.smallest_k(scores, k)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("call", [
    lambda x: tknn.exact_knn(x, 4),
    lambda x: tknn.prune_neighbors(x, np.zeros((8, 4), np.int64),
                                   np.zeros((8, 4), np.float32), 4),
    lambda x: tknn.build_hnsw_knn(x, m=4),
], ids=["exact_knn", "prune_neighbors", "build_hnsw_knn"])
def test_numpy_input_defaults_to_the_card(monkeypatch, call):
    """Given numpy and no device, the builders ask for the card: with none
    visible they raise instead of running on the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call(_int_vectors(3, 8, d=4))


@pytest.mark.parametrize("cap,k", [(8, 24), (16, 48)])
def test_prune_neighbors_matches_jax(cap, k):
    x = _int_vectors(3, 700)
    d, i = jknn.exact_knn(x, k)
    want = jknn.prune_neighbors(x, i, d, cap, slab=256)
    got = tknn.prune_neighbors(x, i, d, cap, slab=256, device="cpu")
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    # the slab does not change the result
    np.testing.assert_array_equal(tknn.prune_neighbors(x, i, d, cap, slab=100,
                                                       device="cpu"), want)


def test_reverse_edges_and_dedup_match_jax():
    rng = np.random.default_rng(4)
    fwd = rng.integers(-1, 300, (300, 12)).astype(np.int64)
    fwd[:5] = 7  # a hub whose in-degree hits the 4*cap limit
    rev_j = jknn._add_reverse_edges(fwd, 300, 4)
    rev_t = tknn._add_reverse_edges(fwd, 300, 4)
    np.testing.assert_array_equal(rev_t, rev_j)
    np.testing.assert_array_equal(tknn._dedup_rows(rev_t), jknn._dedup_rows(rev_j))


@pytest.mark.parametrize("level_mode", ["rng", "centroid"])
def test_build_hnsw_knn_matches_jax(monkeypatch, level_mode):
    """Just over 4,096 rows, so level 0 takes the device path (exact_knn,
    the device prune, _edge_dists) and the upper levels the host path.
    The JAX prune's slab is set to 1,024 rows: its default pads a slab to
    ~16k rows, heavy for a test worker on the CPU, and the slab does not
    change the result."""
    monkeypatch.setattr(jknn, "prune_neighbors",
                        functools.partial(jknn.prune_neighbors, slab=1024))
    x = _int_vectors(5, 4200)
    x[3000:3100] = x[1000:1100]
    jg = jknn.build_hnsw_knn(x, m=8, level_mode=level_mode)
    timings = {}
    tg = tknn.build_hnsw_knn(x, m=8, level_mode=level_mode, device="cpu", timings=timings)
    np.testing.assert_array_equal(tg.neighbors0, jg.neighbors0)
    assert (tg.entry_gid, tg.max_level, tg.m) == (jg.entry_gid, jg.max_level, jg.m)
    assert tg.max_level >= 1
    for a, b in zip(tg.level_gids, jg.level_gids):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tg.level_nbrs, jg.level_nbrs):
        np.testing.assert_array_equal(a, b)
    assert set(timings) == {"levels", "exact_knn", "prune", "reverse_rank", "upper_levels"}
