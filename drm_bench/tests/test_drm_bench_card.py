"""On the card (the H100): a run is correct and its control is not, at a
size a test run holds (300 kbp: 599,702 rows, past the 2^18 rows from
which the scan keeps window minima; 512-read requests)."""

import time

import pytest

from drm_bench import control, harness
from drm_bench.tests.conftest import make_tiny_root

pytestmark = pytest.mark.gpu
CELLS = ("ecoli_int8flat.npy8k", "ecoli_pqflat.sw_sam8k", "ecoli_int8flat.sam_mixed")


@pytest.fixture(scope="module")
def small_root(tmp_path_factory):
    return make_tiny_root(str(tmp_path_factory.mktemp("small")), genome_bp=300_000, reads=512)


@pytest.mark.parametrize("cell", CELLS)
def test_a_run_is_correct(cuda, small_root, tmp_path, cell):
    res, info = harness.run_cell(cell, 2**31 + 5, 2.0, False, "cuda", time.monotonic(),
                                 root=small_root, tmp=str(tmp_path))
    assert res["correct"] is True, (res["checks"], info)
    assert res["device"]["platform"] == "gpu"


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [11, 12, 13])
def test_the_control_is_not_correct(cuda, small_root, tmp_path, cell, seed):
    r = control.run_control(cell, seed, "cuda", 2, root=small_root, tmp=str(tmp_path))
    assert r["correct"] is False, r


def test_the_kmeans_stage_on_the_card(cuda):
    """The port's train_pq on the card equals reference/pq.kmeans where no
    near tie can split them: data with clear clusters (the start's evenly
    spaced rows fall one to a cluster).  On a random genome the two part
    ways, and a run compares their k-means objectives instead."""

    import numpy as np
    import torch

    from deepreadmapper_tpu_torch.ops import pq as ppq
    from drm_bench.reference import pq as ref_pq

    rng = np.random.default_rng(3)
    centers = rng.uniform(-0.9, 0.9, (256, 128)).astype(np.float32)
    x = np.repeat(centers, 16, axis=0) + rng.normal(0, 0.01, (4096, 128)).astype(np.float32)
    cb = ppq.train_pq(x, m=8, nbits=8, iters=25, seed=1234, device=cuda)
    own = ref_pq.kmeans(torch.from_numpy(x).to(cuda), 8, 8, 25, 1234)
    assert float((own - cb.centroids).abs().max()) < 1e-5
