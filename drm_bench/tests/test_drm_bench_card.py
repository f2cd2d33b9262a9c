"""On the card (the H100): a run is correct and its control is not, at a
size a test run holds (300 kbp: 599,702 rows, past the 2^18 rows from
which the scan keeps window minima; 512-read requests), and at stride 4
with the L2 rerank (149,926 sparse rows; SAM lines of the reranked dense
ids)."""

import time

import pytest

from drm_bench import control, harness
from drm_bench.tests.conftest import SPARSE_CELL, add_sparse_cell, make_tiny_root

pytestmark = pytest.mark.gpu
CELLS = ("ecoli_int8flat.npy8k", "ecoli_pqflat.sw_sam8k", "ecoli_int8flat.sam_mixed",
         "ecoli_pqflat.npy8k", SPARSE_CELL)


@pytest.fixture(scope="module")
def small_root(tmp_path_factory):
    root = make_tiny_root(str(tmp_path_factory.mktemp("small")), genome_bp=300_000, reads=512)
    return add_sparse_cell(root, reads=512)


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


@pytest.mark.parametrize("seed", [31, 32, 33])
def test_the_l2_tolerance_on_the_card(cuda, seed):
    """rerank_l2.TOL against the card, at the timed request's size (8,192
    reads, 5 sparse hits each, stride 4): the widest gap between the
    distances #1 (the port's encoder) and the reference give the same
    reads and windows, and the l2_gap of the port's own rerank
    (post_process_l2), lie under it; the order of a TF32 re-embed reads
    over it."""
    import numpy as np
    import torch

    from deepreadmapper_tpu_torch.models.encoder import Vectorizer
    from deepreadmapper_tpu_torch.pipeline import postprocess as pp
    from drm_bench import gen
    from drm_bench.reference import encoder as ref_enc
    from drm_bench.reference import judge, rerank_l2, sam
    from drm_bench.reference import scan as ref_scan

    genome = gen.make_genome(300_000, seed)
    stride, ref_len, n = 4, 150, 8192
    rng = np.random.default_rng([seed, 5])
    reads, starts, strands = gen.make_reads(genome, n, 150, 0.01, rng)
    hits = rng.integers(0, 2 * ((genome.size - ref_len) // stride + 1), (n, 5))
    hits[:, 0] = 2 * (starts // stride) + strands
    enc = ref_enc.Encoder(cuda)
    g = torch.from_numpy(genome).to(cuda)
    env = judge.rerank_env({"ref_len": ref_len, "stride": stride}, {"k": 10}, enc, g)
    cand = ref_scan.candidates(hits, stride, 10, env["bound"])
    with ref_enc.precision(tf32=False):
        emb = ref_enc.embed_reads(enc, reads).cpu().numpy()
        d_ref = rerank_l2.distances(env, cand, emb)
    vec = Vectorizer(device=cuda)
    mat, lens = ref_enc.wrap_reads(reads)
    emb_p = vec.vectorize_wrapped_bytes(mat, lens)

    def embed_windows(ids):
        wm, wl = ref_scan.window_rows(g, torch.from_numpy(ids >> 1).to(cuda), ref_len)
        pick = torch.from_numpy(2 * np.arange(ids.size) + (ids & 1)).to(cuda)
        return vec.vectorize_wrapped_bytes(wm[pick].cpu().numpy(), wl[pick].cpu().numpy())

    uniq = np.unique(cand[cand >= 0])
    pool = embed_windows(uniq)
    where = np.searchsorted(uniq, np.maximum(cand, 0))
    d_prog = np.linalg.norm(pool[where].astype(np.float64) - emb_p[:, None, :], axis=-1)
    gap = float(np.abs(np.where(cand >= 0, d_prog - d_ref, 0.0)).max())
    names = [str(i) for i in range(n)]
    seqs = [r.tobytes().decode() for r in reads]

    def l2_gap(final):
        lines = [sam.read_lines(a, b, c) for a, b, c in zip(names, seqs, final)]
        with ref_enc.precision(tf32=False):
            wrong, numbers, _ = rerank_l2.judge_sam(env, hits, reads, emb, names, seqs, lines)
        return numbers["l2_gap"], int(wrong.sum())

    prog, _ = pp.post_process_l2(hits, np.zeros(hits.shape, np.float32), emb_p, embed_windows,
                                 stride, 10, 5, env["bound"])
    with ref_enc.precision(tf32=True):
        emb32 = ref_enc.embed_reads(enc, reads).cpu().numpy()
        order32 = rerank_l2.order(env, hits, reads, emb32)
    sound, tf32 = l2_gap(prog), l2_gap(order32)
    print(f"seed {seed}: distance gap #1 / reference {gap!r}; l2_gap (wrong reads) of the "
          f"port's rerank {sound}, of a TF32 re-embed {tf32}; TOL {rerank_l2.TOL}")
    assert gap < rerank_l2.TOL and sound[0] < rerank_l2.TOL and sound[1] == 0
    assert tf32[0] > rerank_l2.TOL and tf32[1] > 0
