"""Shared fixtures of the benchmark's own tests (run from the repository
root: ``python -m pytest drm_bench/tests -q``; the card's tests with
``-m gpu`` on the H100).  They need no JAX and import none of it."""

import json
import os
import shutil

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
TINY_BP = 3000


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA device (skips without one)")


def make_tiny_root(dst: str, code: bool = False, genome_bp: int = TINY_BP,
                   reads: int = 64) -> str:
    """A root with BENCHMARK.json and drm_bench's data files at a small size:
    by default a 3 kbp genome, three requests of 64 reads (16-128 in the
    mixed cell).
    code=True copies the whole drm_bench folder (a checkout of its own)."""
    src = os.path.join(REPO, "drm_bench")
    dd = os.path.join(dst, "drm_bench")
    if code:
        shutil.copytree(src, dd, ignore=shutil.ignore_patterns("__pycache__"))
        w = os.path.join(dst, "deepreadmapper_tpu", "models", "data")
        os.makedirs(w, exist_ok=True)
        shutil.copy(os.path.join(REPO, "deepreadmapper_tpu", "models", "data",
                                 "finetuned_sgn33.npz"), w)
    else:
        for sub in ("configs", "traffic", "metrics", "roofline"):
            shutil.copytree(os.path.join(src, sub), os.path.join(dd, sub),
                            ignore=shutil.ignore_patterns("__pycache__"))
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for c in bench["configs"]:
        path = os.path.join(dst, c["file"])
        with open(path) as f:
            cfg = json.load(f)
        cfg["genome_bp"] = genome_bp
        with open(path, "w") as f:
            json.dump(cfg, f)
    tdir = os.path.join(dd, "traffic")
    for name in os.listdir(tdir):
        path = os.path.join(tdir, name)
        with open(path) as f:
            tr = json.load(f)
        rr = tr["request_reads"]
        # a log-uniform pool holds a power of two of requests
        tr["pool_requests"], tr["check_reads"] = (3 if rr["kind"] == "fixed" else 4), 100
        if rr["kind"] == "fixed":
            rr["reads"] = reads
        else:
            rr["low"], rr["high"] = reads // 4, 2 * reads
        with open(path, "w") as f:
            json.dump(tr, f)
    with open(os.path.join(dst, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return dst


SPARSE_CELL = "sparse4.l2_sam"


def add_sparse_cell(root: str, reads: int = 64) -> str:
    """Add to a root, as data files only, a stride-4 INT8FLAT configuration
    (k 10, k_clusters 5; the genome of the root's ecoli_int8flat) and an
    L2-rerank SAM traffic file (three requests of `reads`), and the cell
    sparse4.l2_sam in its BENCHMARK.json."""
    dd = os.path.join(root, "drm_bench")
    with open(os.path.join(dd, "configs", "ecoli_int8flat.json")) as f:
        cfg = json.load(f)
    cfg.update(name="sparse4", stride=4, k=10, k_clusters=5)
    with open(os.path.join(dd, "configs", "sparse4.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(dd, "traffic", "l2_sam.json"), "w") as f:
        json.dump({"name": "l2_sam", "read_len": 150, "sub_rate": 0.01,
                   "request_reads": {"kind": "fixed", "reads": reads}, "pool_requests": 3,
                   "request": {"k": 10, "write_sam": True}, "check_reads": 100}, f)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "sparse4", "source": "a test", "reduced": [],
                             "file": "drm_bench/configs/sparse4.json", "why": "a test"})
    bench["workloads"].append({"name": SPARSE_CELL, "config": "sparse4", "traffic": "l2_sam",
                               "chips": 1, "why": "a test"})
    next(m for m in bench["end_to_end"] if m["name"] == "sam_reads_per_s")[
        "workloads"].append(SPARSE_CELL)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return root


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return make_tiny_root(str(tmp_path_factory.mktemp("tiny")))


@pytest.fixture(scope="session")
def sparse_root(tmp_path_factory):
    """A tiny root with the stride-4 cell sparse4.l2_sam added."""
    return add_sparse_cell(make_tiny_root(str(tmp_path_factory.mktemp("sparse"))))


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
