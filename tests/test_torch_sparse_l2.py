"""The port's L2 rerank past stride 1, served, held to the benchmark's plain
reference.

The port's ``serve()`` answers one request of 256 reads of 150 bp with 1%
substitutions (``drm_bench.gen``) against an INT8FLAT index at stride 4
over a seeded 20 kbp genome, ``rerank`` "l2", SAM on: each read's 5
sparse hits expand to 7 windows each, re-embedded through the encoder and
ordered by sqrt-L2.  The plain PyTorch reference in ``drm_bench/reference``
(``rerank_l2.judge_sam``, which expands the request's own npy rows with
``scan.candidates`` and embeds the candidates with ``encoder``; it imports
no JAX and nothing of the port) judges the SAM lines: no read wrong and
``l2_gap`` within ``rerank_l2.TOL``.  Both sides run the shipped encoder
weights, ``deepreadmapper_tpu/models/data/finetuned_sgn33.npz``, which the
benchmark's configuration chr21_int8flat_s4 names: the reference encoder
reads only that file, by path, and the reference is used as it stands.

Two planted faults must not pass: the re-embed skipped (every window's
embedding zero, so the rerank keeps the expansion's order) and the
expansion shifted by one window.  The child spans of ``post.l2`` change
no number: ``post_process_l2`` gives the same ids and distances, bit for
bit, with the spans recorded and without, and as its steps composed by
hand.
"""

import io
import json
import os
from unittest import mock

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from deepreadmapper_tpu_torch.pipeline import postprocess as pp
from deepreadmapper_tpu_torch.pipeline.build import build_index
from deepreadmapper_tpu_torch.pipeline.serve import serve
from deepreadmapper_tpu_torch.utils import trace
from drm_bench import gen
from drm_bench.reference import encoder as ref_enc
from drm_bench.reference import judge as ref_judge
from drm_bench.reference import rerank_l2
from drm_bench.reference import sam as ref_sam
from drm_bench.reference import scan as ref_scan

GENOME_BP, READS, STRIDE, K, K_CLUSTERS, REF_LEN = 20_000, 256, 4, 10, 5, 150
SEED = 2**31 + 7


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The genome, its stride-4 index, one request's reads and the
    reference encoder."""
    work = tmp_path_factory.mktemp("sparse_l2")
    genome = gen.make_genome(GENOME_BP, SEED)
    ref = str(work / "ref.fna")
    gen.write_fasta(ref, genome)
    (pool,) = gen.make_pool(str(work), genome, {
        "read_len": REF_LEN, "sub_rate": 0.01, "pool_requests": 1,
        "request_reads": {"kind": "fixed", "reads": READS}}, SEED)
    prefix = str(work / "idx")
    build_index(ref, prefix, REF_LEN, STRIDE, "INT8FLAT", device="cpu")
    enc = ref_enc.Encoder(torch.device("cpu"))
    with ref_enc.precision(tf32=False):
        emb = ref_enc.embed_reads(enc, pool["reads"]).numpy()
    return {"genome": genome, "ref": ref, "prefix": prefix, "pool": pool, "enc": enc,
            "emb": emb, "work": work}


def _serve(setup, name, **extra):
    out_dir = str(setup["work"] / name)
    req = {"id": name, "fastq": setup["pool"]["fastq"], "output_dir": out_dir, "k": K,
           "k_clusters": K_CLUSTERS, "rerank": "l2", "write_sam": True, **extra}
    out = io.StringIO()
    serve(setup["prefix"], setup["ref"], out_stream=out, device="cpu",
          in_stream=io.StringIO(json.dumps(req) + "\n"))
    reply = json.loads(out.getvalue().splitlines()[1])
    assert reply["ok"], reply
    return out_dir


def _judged(setup, out_dir, rows_dir=None):
    """(reads wrong [n] bool, the reference's numbers) of the request's SAM
    lines in out_dir, the candidates expanded from the npy rows in rows_dir
    (default: out_dir's own)."""
    pool = setup["pool"]
    env = ref_judge.rerank_env({"ref_len": REF_LEN, "stride": STRIDE}, {"k": K},
                               setup["enc"], torch.from_numpy(setup["genome"]))
    raw = ref_scan.load_ids(rows_dir or out_dir)
    assert raw.shape == (READS, K_CLUSTERS)
    sams = ref_sam.lines_by_read(os.path.join(out_dir, "results.sam"))
    names = pool["names"]
    with ref_enc.precision(tf32=False):
        wrong, numbers, _ = rerank_l2.judge_sam(
            env, raw, pool["reads"], setup["emb"], names,
            [r.tobytes().decode() for r in pool["reads"]], [sams.get(n) for n in names])
    return wrong, numbers


@pytest.fixture(scope="module")
def one_shot(setup):
    return _serve(setup, "one_shot")


@pytest.mark.parametrize("streaming", [False, True], ids=["one_shot", "streaming"])
def test_sparse_l2_serve_is_correct(setup, one_shot, streaming):
    """A streamed run writes its SAM alone: its lines are judged on the
    one-shot run's npy rows (the same search)."""
    out_dir = _serve(setup, "streaming", use_streaming=True) if streaming else one_shot
    wrong, numbers = _judged(setup, out_dir, rows_dir=one_shot)
    assert int(wrong.sum()) == 0
    assert numbers["l2_gap"] <= rerank_l2.TOL
    # most reads find their own start, within 2 bp, among their k lines
    # (244 of 256 at this seed)
    starts = dict(zip(setup["pool"]["names"], setup["pool"]["starts"]))
    lines = ref_sam.lines_by_read(os.path.join(out_dir, "results.sam"))
    hits = sum(any(abs(int(ln.split("\t")[3]) - 1 - int(s)) <= 2 for ln in lines[n])
               for n, s in starts.items())
    assert hits >= 0.9 * READS


@pytest.fixture
def zero_embeddings():
    """The re-embed skipped: every window's embedding comes back zero, so
    each read's candidates tie and keep the expansion's order."""
    orig = pp.post_process_l2

    def post(neighbors, distances, query_emb, embed_windows, *a, **kw):
        return orig(neighbors, distances, query_emb,
                    lambda ids: torch.zeros((len(ids), 128)), *a, **kw)

    with mock.patch.object(pp, "post_process_l2", post):
        yield


@pytest.fixture
def shifted_expansion():
    """The expansion shifted by one window: every valid candidate id plus
    one, inside the bound."""
    orig = pp.expand_candidates

    def expand(neighbors, stride, bound, *a, **kw):
        cand, valid = orig(neighbors, stride, bound, *a, **kw)
        ok = valid & (cand + 1 < bound)
        return np.where(ok, cand + 1, -1), ok

    with mock.patch.object(pp, "expand_candidates", expand):
        yield


@pytest.mark.parametrize("fault", ["zero_embeddings", "shifted_expansion"])
def test_a_planted_fault_is_caught(setup, request, fault):
    request.getfixturevalue(fault)
    wrong, numbers = _judged(setup, _serve(setup, fault))
    assert int(wrong.sum()) > 0


def _embed(uniq):
    """A stand-in embedder: fixed, distinct rows a window id."""
    t = torch.from_numpy(np.asarray(uniq, np.float64))
    return torch.sin(0.001 * (t[:, None] + 1) * torch.arange(1, 129)).float()


def test_post_process_l2_is_the_same_with_and_without_its_spans(setup, one_shot):
    ids = ref_scan.load_ids(one_shot)
    d = np.load(os.path.join(one_shot, "distances.npy"))
    q = setup["emb"]
    bound = 2 * (GENOME_BP - REF_LEN + 1)
    args = (ids, d, q, _embed, STRIDE, K, K_CLUSTERS, bound)
    plain = pp.post_process_l2(*args)
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        traced = pp.post_process_l2(*args)
    names = [s.name for s in trace.recorded()]
    trace.clear()
    assert names == ["post.l2.expand", "post.l2.rank"]
    cand, _ = pp.expand_candidates(ids, STRIDE, bound, K_CLUSTERS)
    uniq, pool_idx = pp.unique_pool(cand)
    dd, ii = pp.rerank_l2(torch.as_tensor(q), _embed(uniq), torch.from_numpy(pool_idx),
                          torch.from_numpy(cand), K)
    by_hand = (ii.numpy().astype(np.int64), dd.numpy().astype(np.float32))
    for got in (traced, by_hand):
        for a, b in zip(plain, got):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
