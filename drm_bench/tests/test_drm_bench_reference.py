"""The plain reference against the port run with device="cpu" (the
port's plain versions of its kernels), at small sizes."""

import json
import os

import numpy as np
import pytest
import torch

from drm_bench import gen, harness
from drm_bench.reference import encoder as ref_enc
from drm_bench.reference import judge as ref_judge
from drm_bench.reference import pq as ref_pq
from drm_bench.reference import rerank_l2
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


def test_rerank_l2_equals_the_ports_at_stride_4(genome, reads):
    """reference/rerank_l2's order of a stride-4 index's sparse hits is the
    port's post_process_l2 (expansion, dedup, re-embed, sqrt-L2 rerank),
    hits past the genome's end and missing hits too."""
    from deepreadmapper_tpu_torch import tokenizer as tok
    from deepreadmapper_tpu_torch.io import fasta
    from deepreadmapper_tpu_torch.models.encoder import Vectorizer
    from deepreadmapper_tpu_torch.pipeline import postprocess as pp

    stride, ref_len = 4, 150
    nsparse = (genome.size - ref_len) // stride + 1
    bound = 2 * (genome.size - ref_len + 1)
    rng = np.random.default_rng(12)
    r, starts, strands = gen.make_reads(genome, 40, 150, 0.01, rng)
    hits = rng.integers(0, 2 * nsparse, (40, 5))
    hits[:, 0] = 2 * (starts // stride) + strands  # the read's own sparse window first
    hits[0, 1], hits[1, 1], hits[2, 2] = 2 * nsparse - 1, -1, hits[2, 1] + 1
    vec = Vectorizer(device="cpu")
    mat, lens = ref_enc.wrap_reads(r)
    q = vec.vectorize_wrapped_bytes(mat, lens)

    def embed_windows(ids):
        m, ln = fasta.fetch_windows_by_id(genome, ids, ref_len, tok.MAX_LEN, wrap=True)
        return vec.vectorize_wrapped_bytes(m, ln)

    want, _ = pp.post_process_l2(hits, np.zeros(hits.shape, np.float32), q, embed_windows,
                                 stride, 10, 5, bound)
    enc = ref_enc.Encoder("cpu")
    env = ref_judge.rerank_env({"ref_len": ref_len, "stride": stride}, {"k": 10}, enc,
                               torch.from_numpy(genome))
    emb = ref_enc.embed_reads(enc, r).numpy()
    got = rerank_l2.order(env, hits, r, emb)
    assert np.array_equal(got, want)
    # the judge reads the port's order as right
    names = [f"r{i}" for i in range(len(r))]
    seqs = [x.tobytes().decode() for x in r]
    lines = [ref_sam.read_lines(nm, sq, row) for nm, sq, row in zip(names, seqs, want)]
    wrong, numbers, _ = rerank_l2.judge_sam(env, hits, r, emb, names, seqs, lines)
    assert not wrong.any() and numbers["l2_gap"] <= rerank_l2.TOL
    # a swap of two ranks whose distances lie apart, or an id that is no
    # candidate of the read, is wrong
    bad = [list(x) for x in lines]
    bad[3] = ref_sam.read_lines(names[3], seqs[3], want[3][[1, 0, *range(2, 10)]])
    bad[4] = ref_sam.read_lines(names[4], seqs[4], np.r_[want[4][:9], 2 * nsparse + 7])
    wrong, numbers, _ = rerank_l2.judge_sam(env, hits, r, emb, names, seqs, bad)
    assert wrong.tolist() == [i in (3, 4) for i in range(len(r))]
    assert numbers["l2_gap"] > rerank_l2.TOL


@pytest.mark.parametrize("index_type", ["INT8FLAT", "PQFLAT"])
def test_the_index_judges_read_the_ports_stride_4_build(index_type, tmp_path):
    """The reference embeds the windows at positions 0, 4, 8, ... on both
    strands, the rows of the port's stride-4 build."""
    cfg = dict(PQ_CONFIG, index_type=index_type, stride=4, genome_bp=3000)
    genome = gen.make_genome(3000, 21)
    ref = str(tmp_path / "ref.fna")
    gen.write_fasta(ref, genome)
    engine, _ = harness.build_engine(ref, str(tmp_path / "index"), cfg, torch.device("cpu"))
    assert engine.ntotal == 2 * ((3000 - 150) // 4 + 1)
    kind = ref_judge.index_kind(cfg)
    numbers, info = {}, {}
    idx = kind.judge(ref_enc.Encoder("cpu"), torch.from_numpy(genome), cfg,
                     kind.program_state(engine), 0.01, numbers, info)
    assert idx.ntotal == engine.ntotal
    # the two CPU encoders agree to 1e-5 (test_encoder_matches_the_ports), so
    # a code may sit a rounding apart, within 1e-3 code steps of its cell
    assert numbers["index_gap"] < 1e-3, info
    if index_type == "PQFLAT":
        assert abs(numbers["kmeans_excess"]) < cfg["limits"]["kmeans_excess"]
    with pytest.raises(AssertionError, match="at stride 1"):  # the stride is read
        kind.judge(ref_enc.Encoder("cpu"), torch.from_numpy(genome), dict(cfg, stride=1),
                   kind.program_state(engine), 0.01, {}, {})


def test_the_query_scale_is_read_from_whole_rows():
    """A request whose largest |value| / 127 equals the code scale to the
    bit: an ulp of the encoder moves the program's query scale past it.
    Error-free reads' top distances read alike at both scales, so only the
    rows' other columns tell them apart."""
    rng = np.random.default_rng(14)
    codes = rng.integers(-100, 101, (4096, 128)).astype(np.int8)
    idx = ref_scan.Index(torch.from_numpy(codes), ref_scan.INT8_SCALE)
    emb = codes[:64].astype(np.float32) / np.float32(127.0)  # each read a row of the index
    emb[0, 0] = np.float32(1.0)  # its largest |value| / 127: the code scale, to the bit
    codes[0, 0] = 127
    assert np.float32(1.0) / np.float32(127.0) == np.float32(ref_scan.INT8_SCALE)
    up = np.nextafter(np.float32(1.0), np.float32(2.0))
    sq, ratio = ref_scan.query_scale_ratio(up, ref_scan.INT8_SCALE)  # the program's
    assert ratio != 1

    def rows_at(scale, r):
        q8 = ref_scan.quantize_host(emb, scale)
        s, ids = ref_scan.scan(torch.from_numpy(q8), idx.rows, 4096, 4096, r, 10, True,
                               chunk=1024)
        return ids.numpy(), ref_scan.distances(s.numpy(), q8, np.full(64, r), idx.scale, True)

    prog_ids, prog_d = rows_at(sq, ratio)
    _, own_d = rows_at(np.float32(ref_scan.INT8_SCALE), np.float32(1.0))
    assert np.array_equal(own_d[:, 0], prog_d[:, 0])  # the top distances alone: a tie
    got = ref_judge._infer_scale(emb, idx.scale, idx, prog_ids, prog_d, True, 0.01)
    assert got == sq
