"""The plain reference against the port run with device="cpu" (the
port's plain versions of its kernels), at small sizes."""

import json
import os

import numpy as np
import pytest
import torch

from drm_bench import gen, harness
from drm_bench.reference import encoder as ref_enc
from drm_bench.reference import pq as ref_pq
from drm_bench.reference import sam as ref_sam
from drm_bench.reference import scan as ref_scan
from drm_bench.reference import sw as ref_sw


with open(os.path.join(harness.ROOT, "drm_bench", "configs", "ecoli_pqflat.json")) as _f:
    PQ_CONFIG = json.load(_f)


@pytest.fixture(scope="module")
def genome():
    return gen.make_genome(2000, 11)


@pytest.fixture(scope="module")
def reads(genome):
    r, _, _ = gen.make_reads(genome, 40, 150, 0.01, np.random.default_rng(4))
    return r


def test_tokens_equal_the_ports(reads, genome):
    from deepreadmapper_tpu_torch import tokenizer as tok
    from deepreadmapper_tpu_torch.io import fasta

    mat, lens = ref_enc.wrap_reads(reads)
    got = ref_enc.tokenize(torch.from_numpy(mat), torch.from_numpy(lens)).numpy()
    assert np.array_equal(got, tok.tokenize_bytes(mat, lens))
    wm, wl = ref_scan.window_rows(torch.from_numpy(genome), torch.arange(50), 150)
    pm, pl = fasta.window_byte_matrix(genome, np.arange(50), 150, 123)
    assert np.array_equal(wm.numpy(), pm) and np.array_equal(wl.numpy(), pl)


def test_encoder_matches_the_ports(reads, genome):
    from deepreadmapper_tpu_torch.io import fasta
    from deepreadmapper_tpu_torch.models.encoder import Vectorizer
    from deepreadmapper_tpu_torch.pipeline.build import embed_fasta_windows

    enc = ref_enc.Encoder("cpu")
    vec = Vectorizer(device="cpu")
    mat, lens = ref_enc.wrap_reads(reads)
    want = vec.vectorize_wrapped_bytes(mat, lens)
    got = ref_enc.embed_reads(enc, reads).numpy()
    assert np.max(np.abs(got - want)) < 1e-5
    g = torch.from_numpy(genome)
    got = torch.cat([e for _, e in ref_scan.window_embeddings(enc, g, 150, np.arange(300))])
    want = embed_fasta_windows([genome], 150, 1, vec)[:600]
    assert np.max(np.abs(got.numpy() - want)) < 1e-5


@pytest.mark.parametrize("windowed", [False, True])
def test_scan_equals_the_ports(windowed):
    from deepreadmapper_tpu_torch.index.int8_flat import Int8FlatIndex
    from deepreadmapper_tpu_torch.ops import scan_kernel as sk

    rng = np.random.default_rng(5)
    n = 4096 + 77
    codes = rng.integers(-30, 31, (n, 128)).astype(np.int8)
    codes[100] = codes[7]  # ties go to the lower row
    q = rng.uniform(-0.2, 0.2, (33, 128)).astype(np.float32)
    eng = Int8FlatIndex(codes, ref_scan.INT8_SCALE, n, "cpu")
    q8 = ref_scan.quantize_host(q, ref_scan.INT8_SCALE)
    rows = lambda s, e: torch.from_numpy(codes[s:e])  # noqa: E731
    s, ids = ref_scan.scan(torch.from_numpy(q8), rows, n, n, 1.0, 16, windowed, chunk=1024)
    if windowed:
        pad = np.pad(codes, ((0, (-n) % 1024), (0, 0)))
        ws, wi = sk.fused_scan_topk(torch.from_numpy(q8), torch.from_numpy(pad), n, 16, 1024,
                                    winmin=sk.int8_winmin_reference)
        assert np.array_equal(ids.numpy(), wi.numpy())
        assert np.array_equal(s.numpy(), ws.numpy())
    else:
        pi, pd = eng.search(q, 16)
        d = ref_scan.distances(s.numpy(), q8, np.ones(len(q8), np.float32),
                               ref_scan.INT8_SCALE, False)
        assert np.array_equal(ids.numpy(), pi) and np.array_equal(d, pd)


def test_scan_at_a_query_scale_past_the_codes():
    """ratio != 1: the score rounds once, as the program's does."""
    from deepreadmapper_tpu_torch.ops import scan_kernel as sk

    rng = np.random.default_rng(6)
    codes = rng.integers(-60, 61, (2048, 128)).astype(np.int8)
    q8 = rng.integers(-127, 128, (16, 128)).astype(np.int8)
    ratio = np.float32(1.0371)
    rows = lambda s, e: torch.from_numpy(codes[s:e])  # noqa: E731
    s, ids = ref_scan.scan(torch.from_numpy(q8), rows, 2048, 2000, ratio, 8, True, chunk=512)
    ws, wi = sk.fused_scan_topk(torch.from_numpy(q8), torch.from_numpy(codes), 2000, 8, 512,
                                ratio=ratio, winmin=sk.int8_winmin_reference)
    assert np.array_equal(ids.numpy(), wi.numpy()) and np.array_equal(s.numpy(), ws.numpy())
    r8 = torch.from_numpy(codes)[ids]
    assert np.array_equal(ref_scan.score_rows(torch.from_numpy(q8), r8, ratio, True).numpy(),
                          s.numpy())


def test_pq_matches_the_ports():
    from deepreadmapper_tpu_torch.ops import pq as ppq

    rng = np.random.default_rng(8)
    x = np.tanh(rng.normal(0, 0.6, (3000, 128))).astype(np.float32)
    cb = ppq.train_pq(x, m=8, nbits=8, iters=5, seed=1234, device="cpu")
    own = ref_pq.kmeans(torch.from_numpy(x), 8, 8, 5, 1234)
    assert float((own - cb.centroids).abs().max()) < 1e-4
    c8, scale = ref_pq.int8_codebook(cb.centroids.numpy())
    q = ppq.quantize_codebook(cb)
    assert np.array_equal(c8, q.cent8) and scale == q.scale
    codes = ppq.encode_pq(x, cb)
    ref, gap = ref_pq.code_gap(torch.from_numpy(x), cb.centroids, torch.from_numpy(codes))
    assert float(gap.max()) < 1e-3
    assert np.array_equal(ref_pq.reconstruct8(torch.from_numpy(codes), torch.from_numpy(c8)).numpy(),
                          ppq.reconstruct8(torch.from_numpy(codes), torch.from_numpy(c8)).numpy())
    # a wrong code is a whole cell away
    bad = codes.copy()
    bad[0, 0] = (int(bad[0, 0]) + 1) % 256
    _, gap = ref_pq.code_gap(torch.from_numpy(x[:1]), cb.centroids, torch.from_numpy(bad[:1]))
    assert float(gap.max()) > 0.01


def test_rounding_gap_and_choices():
    x = torch.tensor([[0.5 / 127, 1.5 / 127 + 1e-9, -3.2 / 127]])
    assert float(ref_scan.rounding_gap(x, ref_scan.INT8_SCALE, torch.tensor([[0, 2, -3]])).max()) < 1e-5
    assert float(ref_scan.rounding_gap(x, ref_scan.INT8_SCALE, torch.tensor([[0, 2, -4]])).max()) > 0.2
    alt, near = ref_scan.alternative_codes(x.numpy()[0], ref_scan.INT8_SCALE, 1e-3)
    assert near.tolist() == [True, True, False]


def test_sw_equals_the_ports():
    from deepreadmapper_tpu_torch.ops.sw import sw_scores_reference

    rng = np.random.default_rng(9)
    acgt = np.frombuffer(b"ACGT<>", np.uint8)
    a = torch.from_numpy(rng.choice(acgt[:4], (200, 150)))
    b = torch.from_numpy(rng.choice(acgt, (200, 152)))
    b[:40, 1:151] = a[:40]
    al = torch.from_numpy(rng.integers(90, 151, 200))
    bl = torch.from_numpy(rng.integers(90, 153, 200))
    assert torch.equal(ref_sw.sw_scores(a, al, b, bl), sw_scores_reference(a, al, b, bl))


def test_sam_lines_equal_the_ports():
    from deepreadmapper_tpu_torch.io.sam import format_sam_records

    ids = np.array([[8, 3, -1, 41], [-1, 5, 6, 7]])
    seqs = ["<" + "ACGT" * 37 + "AC>", "<" + "T" * 150 + ">"]
    want = list(format_sam_records(seqs, ["r1", "r2"], ids.ravel(), 4, "ref"))
    got = ref_sam.read_lines("r1", seqs[0][1:-1], ids[0]) + ref_sam.read_lines(
        "r2", seqs[1][1:-1], ids[1])
    assert got == want


def test_pq_training_sample_is_the_builds(monkeypatch):
    """The training windows the reference embeds are those the port's PQ
    build embeds: every step-th window of the genome, the sample capped at
    the configuration's train_rows (which the full genome reaches)."""
    from deepreadmapper_tpu_torch.config import BuildConfig
    from deepreadmapper_tpu_torch.pipeline import build

    seen = []

    def fake_embed(records, ref_len, stride, vectorizer, **kw):
        seen.append(stride)
        raise StopIteration

    monkeypatch.setattr(build, "embed_fasta_windows", fake_embed)
    for bp in (3000, 4_641_652):
        with pytest.raises(StopIteration):
            build._pq_stream_encode([np.zeros(bp, np.uint8)], 150, 1, BuildConfig(), None)
        pos = ref_pq.sample_positions(bp, 150, 1, 0.5, PQ_CONFIG["train_rows"])
        assert pos[1] == seen[-1] and pos[-1] + seen[-1] > bp - 150
