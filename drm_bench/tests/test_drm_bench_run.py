"""A whole run of the harness on the CPU at a tiny size: the result line's
format, the run's refusal without a card, and `correct` coming out false
with the timed path broken underneath."""

import contextlib
import json
import time
from unittest import mock

import numpy as np
import pytest

from drm_bench import harness, run
from drm_bench.tests.conftest import SPARSE_CELL


def _run(tiny_root, tmp_path, cell, trace=False):
    return harness.run_cell(cell, 2**31 + 99, 1.0, trace, "cpu", time.monotonic(),
                            root=tiny_root, tmp=str(tmp_path))


def _on_engine(change):
    """A fault: the engine the set-up builds, changed by change(engine)
    before it is served."""
    orig = harness.build_engine

    def build(*a, **kw):
        engine, config = orig(*a, **kw)
        change(engine)
        return engine, config

    return mock.patch.object(harness, "build_engine", build)


def _on_build(**changed):
    """A fault of the set-up's build: the configuration's keys changed as
    the port's build path receives them."""
    orig = harness.build_engine
    return mock.patch.object(harness, "build_engine",
                             lambda ref, prefix, cfg, dev: orig(ref, prefix, {**cfg, **changed}, dev))


def test_result_line(tiny_root, tmp_path):
    res, info = _run(tiny_root, tmp_path, "ecoli_int8flat.npy8k")
    assert list(res) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] >= 1
    assert set(res["metrics"]) == {"reads_per_s", "setup_s"}  # no card: no memory reading
    assert all(set(m) == {"value", "unit"} for m in res["metrics"].values())
    assert set(res["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(res["checks"]) == {"index_gap", "reads_wrong"}
    assert all(set(c) == {"value", "limit"} for c in res["checks"].values())
    json.dumps(res)
    assert info["reads_checked"] == 100


def test_per_layer_metrics_of_a_traced_run(tiny_root, tmp_path):
    res, _ = _run(tiny_root, tmp_path, "ecoli_int8flat.sam_mixed", trace=True)
    # without a card there is no device trace: the spans alone are read
    assert set(res["metrics"]) == {"post_ms.serve"}
    assert res["correct"] is True


def test_no_card_no_result(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "ecoli_int8flat.npy8k", "--seed", "1", "--seconds", "1"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == "" and "no CUDA device" in out.err


def _patch_search(fn):
    def search_of(engine):
        orig = engine.search

        def search(q, k, ef=0, **kw):
            ids, d = orig(q, k, ef, **kw)
            return fn(ids.copy(), d.copy(), engine)

        engine.search = search

    return lambda: _on_engine(search_of)


def _alter_one(ids, d, engine):
    ids[0, 0] = (ids[0, 0] + 2 * 97) % engine.ntotal
    return ids, d


def _half_left_out(ids, d, engine):
    half = ids.shape[0] // 2
    ids[half:] = ids[: ids.shape[0] - half]
    d[half:] = d[: d.shape[0] - half]
    return ids, d


def _bad_code():
    def flip(engine):
        engine.codes[6] = -engine.codes[6]

    return _on_engine(flip)


@contextlib.contextmanager
def _sw_order_altered():
    from deepreadmapper_tpu_torch.pipeline import postprocess as pp

    orig = pp.post_process_sw

    def post(*a, **kw):
        ids, s = orig(*a, **kw)
        ids[0, [0, 1]] = ids[0, [1, 0]]
        return ids, s

    with mock.patch.object(pp, "post_process_sw", post):
        yield


@pytest.mark.parametrize("cell,fault,broken", [
    ("ecoli_int8flat.npy8k", _patch_search(_alter_one), "reads_wrong"),
    ("ecoli_int8flat.sam_mixed", _patch_search(_alter_one), "reads_wrong"),
    ("ecoli_pqflat.sw_sam8k", _patch_search(_alter_one), "reads_wrong"),
    ("ecoli_int8flat.npy8k", _patch_search(_half_left_out), "reads_wrong"),
    ("ecoli_int8flat.npy8k", _bad_code, "index_gap"),
    ("ecoli_pqflat.sw_sam8k", _sw_order_altered, "reads_wrong"),
    ("ecoli_pqflat.sw_sam8k", lambda: _on_build(kmeans_iters=5), "kmeans_excess"),
    ("ecoli_pqflat.sw_sam8k", lambda: _on_build(sample_rate=0.05), "kmeans_excess"),
])
def test_a_broken_path_is_not_correct(tiny_root, tmp_path, cell, fault, broken):
    with fault():
        res, _ = _run(tiny_root, tmp_path, cell)
    assert res["correct"] is False
    c = res["checks"][broken]
    assert c["value"] > c["limit"]


def test_checks_are_the_last_lines(tiny_root, tmp_path, monkeypatch, capsys):
    """run.main's output on a card, with the run itself faked."""
    import torch

    res, info = _run(tiny_root, tmp_path, "ecoli_int8flat.npy8k")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(harness, "run_cell", lambda *a, **kw: (res, info))
    rc = run.main(["--workload", "ecoli_int8flat.npy8k", "--seed", "1", "--seconds", "1"])
    out = capsys.readouterr()
    lines = out.out.strip().splitlines()
    assert rc == 0 and json.loads(lines[-1]) == res
    assert lines[-2].startswith("bytes_written ")
    err = out.err.strip().splitlines()
    assert [ln.split(":")[0] for ln in err[-2:]] == ["check index_gap", "check reads_wrong"]


def test_a_sparse_run_is_correct(sparse_root, tmp_path):
    """Stride 4 with the L2 rerank: the npy rows hold the k_clusters sparse
    hits, the SAM lines the reranked dense ids, and the rerank adds l2_gap."""
    res, info = _run(sparse_root, tmp_path, SPARSE_CELL)
    assert res["correct"] is True, (res["checks"], info)
    assert set(res["checks"]) == {"index_gap", "reads_wrong", "l2_gap"}
    assert info["reads_checked"] >= 64 and info["sam_reads_unequal"] == 0


@contextlib.contextmanager
def _on_l2(change):
    """A fault of the L2 rerank: its result changed by change(ids, call's
    arguments) where it is produced."""
    from deepreadmapper_tpu_torch.pipeline import postprocess as pp

    orig = pp.post_process_l2

    def post(*a, **kw):
        ids, d = orig(*a, **kw)
        return change(ids.copy(), a), d

    with mock.patch.object(pp, "post_process_l2", post):
        yield


def _rerank_skipped(ids, a):
    from deepreadmapper_tpu_torch.pipeline import postprocess as pp

    neighbors, _, _, _, stride, k, k_clusters, bound = a[:8]
    cand, _ = pp.expand_candidates(neighbors, stride, bound, k_clusters)
    return cand[:, :k]


def _shifted(ids, a):
    return np.where(ids >= 0, ids + 1, ids)


@contextlib.contextmanager
def _one_sided_expansion():
    from deepreadmapper_tpu_torch.pipeline import postprocess as pp

    def expand(neighbors, stride, bound, k_clusters, sparse_off=None, dense_off=None):
        sparse = neighbors[:, :k_clusters].astype(np.int64)
        cand = sparse[:, :, None] * stride + np.arange(stride)
        ok = (sparse[:, :, None] >= 0) & (cand < bound)
        return (np.where(ok, cand, -1).reshape(len(sparse), -1),
                ok.reshape(len(sparse), -1))

    with mock.patch.object(pp, "expand_candidates", expand):
        yield


@contextlib.contextmanager
def _npy_of_k_columns():
    from deepreadmapper_tpu_torch.pipeline import search

    orig = search.save_results

    def save(n, d, fi, fd, k):
        orig(np.tile(n, 2), np.tile(d, 2), fi, fd, 2 * k)

    with mock.patch.object(search, "save_results", save):
        yield


@pytest.mark.parametrize("fault", [
    lambda: _on_l2(_rerank_skipped),
    _one_sided_expansion,
    lambda: _on_l2(_shifted),
    _npy_of_k_columns,
], ids=["rerank_skipped", "one_sided_expansion", "ids_shifted", "npy_of_k_columns"])
def test_a_broken_sparse_path_is_not_correct(sparse_root, tmp_path, fault):
    with fault():
        res, _ = _run(sparse_root, tmp_path, SPARSE_CELL)
    assert res["correct"] is False
    c = res["checks"]["reads_wrong"]
    assert c["value"] > c["limit"]
