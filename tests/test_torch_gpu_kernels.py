"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

Marked ``gpu``; every test skips without a CUDA device (decided in the
``cuda`` fixture, never at import).  Run on a machine with an H100:

    python -m pytest tests/test_torch_gpu_kernels.py -m gpu -q
"""

import os

import numpy as np
import pytest
import torch

from deepreadmapper_tpu.io import fastq
from deepreadmapper_tpu_torch import kernels
from deepreadmapper_tpu_torch.models import gru
from deepreadmapper_tpu_torch.ops import scan_kernel as sk
from deepreadmapper_tpu_torch.ops import sw

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _gru_args(din, dtype, dev, b=1001, t_steps=123, seed=0):
    rng = np.random.default_rng(seed)
    arrs = [rng.uniform(-1, 1, (t_steps, b, din)),
            rng.standard_normal((din, gru.G)) * 0.2,
            rng.standard_normal(gru.G) * 0.1,
            rng.standard_normal((gru.H, gru.G)) * 0.2,
            rng.standard_normal(gru.H) * 0.1]
    return [torch.tensor(a, dtype=torch.float32).to(dev, dtype) for a in arrs]


# (T, B): B = 1001 is not a multiple of the kernel's 16-sequence tile (ragged
# edge); T = 1 is one step, the tensor-core fragment mapping and the gate
# math alone; B = 16 is exactly one tile and B = 17 one row over
@pytest.mark.parametrize("t_steps,b", [(123, 1001), (1, 1001), (123, 16), (123, 17)])
@pytest.mark.parametrize("din", [64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("last", [False, True])
def test_gru_kernel_matches_plain(cuda, din, dtype, reverse, last, t_steps, b):
    args = _gru_args(din, dtype, cuda, b=b, t_steps=t_steps)
    before = kernels.GRU_FWD.launches
    fn = gru.gru_proj_last if last else gru.gru_proj_seq
    got = fn(*args, reverse)
    assert kernels.GRU_FWD.launches == before + 1
    want = gru.gru_reference(*args, reverse, last)
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == want.dtype
    # fp32: three TF32 passes, another summation order and the fast exp and
    # divide of the gates (up to 2.6e-6 after 123 steps); bf16 per-step
    # outputs: one bf16 ulp
    tol = 1e-2 if (dtype == torch.bfloat16 and not last) else 1e-4
    assert (got.float() - want.float()).abs().max().item() <= tol


@pytest.mark.parametrize("din,limit", [(64, 1.3e-7), (128, 2.0e-7)])
def test_gru_kernel_fp32_sums(cuda, din, limit):
    """The kernel carries each gate's running sum in fp32 adds, flushing the
    tensor-core partials every two k-slices.  Summed inside mma.sync's own
    accumulator instead, the fp32 error after 123 steps still passes the
    1e-4 above, and its largest value here comes close to the kernel's
    (2.1e-6-4.9e-6 against 1.2e-6-1.8e-6), but its mean over the four calls'
    outputs is twice the kernel's or more: 1.9e-7-2.4e-7 against 9.1e-8 at
    din 64, 3.5e-7-4.3e-7 against 1.2e-7 at din 128 (H100;
    scripts/time_gru_fwd.py reads both on these inputs).  The limit sits
    between them."""
    args = _gru_args(din, torch.float32, cuda)
    err = torch.cat([(fn(*args, reverse)
                      - gru.gru_reference(*args, reverse, fn is gru.gru_proj_last)).abs().flatten()
                     for fn in (gru.gru_proj_seq, gru.gru_proj_last) for reverse in (False, True)])
    assert err.mean().item() <= limit


# (rows, queries, w, ntotal): the main layout with part of the last window
# masked, at w 128 and 512; one block (128 queries x 32 windows), which
# pins the fragment layout; a tail block (45 windows: 32 + 13); two slabs a
# window; and an ntotal that masks the last window whole, (3.4e38, its
# first row)
INT8_LAYOUTS = {"8192x640": (8192, 640, 128, 8192 - 333),
                "w512": (8192, 640, 512, 8192 - 333),
                "one block": (4096, 128, 128, 4096 - 77),
                "tail block": (45 * 128, 256, 128, 45 * 128 - 200),
                "w256": (8192, 640, 256, 8192 - 333),
                "masked window": (8192, 256, 128, 8192 - 128 - 77)}


@pytest.mark.parametrize("layout", list(INT8_LAYOUTS))
@pytest.mark.parametrize("ratio", [1.0, 1.3])
# amp 2: many exact ties; "ties": every row one of 16 patterns of values in
# {-2..2}, so most window minima are shared and only the lowest-row rule
# decides
@pytest.mark.parametrize("amp", [127, 2, "ties"])
def test_int8_winmin_kernel_matches_plain(cuda, layout, ratio, amp):
    np_, qp, w, ntotal = INT8_LAYOUTS[layout]
    rng = np.random.default_rng(1)
    q8 = torch.tensor(rng.integers(-127, 128, (qp, 128)), dtype=torch.int8).to(cuda)
    if amp == "ties":
        r8 = rng.integers(-2, 3, (16, 128))[rng.integers(0, 16, np_)]
    else:
        r8 = rng.integers(-amp, amp + 1, (np_, 128))
    r8 = torch.tensor(r8, dtype=torch.int8).to(cuda)
    ratio2 = 2.0 * float(np.float32(ratio))
    before = kernels.INT8_WINMIN.launches
    v, a = sk.int8_winmin(q8, r8, ntotal, ratio2, w)
    assert kernels.INT8_WINMIN.launches == before + 1
    vr, ar = sk.int8_winmin_reference(q8, r8, ntotal, ratio2, w)
    assert torch.equal(v, vr) and torch.equal(a, ar)
    if layout == "masked window":
        assert bool((v[-1] == 3.4e38).all()) and bool((a[-1] == np_ - 128).all())


def test_fused_scan_topk_kernel_matches_plain(cuda):
    rng = np.random.default_rng(2)
    q8 = torch.tensor(rng.integers(-127, 128, (512, 128)), dtype=torch.int8).to(cuda)
    r8 = torch.tensor(rng.integers(-127, 128, (4 * sk.CT, 128)),
                      dtype=torch.int8).to(cuda)
    args = (q8, r8, 4 * sk.CT - 1000, 64, sk.CT)
    d, i = sk.fused_scan_topk(*args, ratio=1.1)
    dr, ir = sk.fused_scan_topk(*args, ratio=1.1, winmin=sk.int8_winmin_reference)
    assert torch.equal(d, dr) and torch.equal(i, ir)


def _sw_pairs(p, seed=4):
    """Random ACGTN windows [p, 150] and '<'-wrapped reads [p, 152] with
    lengths that differ within warps, zero lengths and exact copies."""
    rng = np.random.default_rng(seed)
    acgtn = np.frombuffer(b"ACGTN", np.uint8)
    a = acgtn[rng.choice(5, (p, 150), p=[0.24, 0.24, 0.24, 0.24, 0.04])]
    b = acgtn[rng.choice(5, (p, 152), p=[0.24, 0.24, 0.24, 0.24, 0.04])]
    b[:, 0], b[:, -1] = ord("<"), ord(">")
    b[::3, 1:151] = a[::3]  # the read of its own window
    la = np.full(p, 150)
    lb = np.full(p, 152)
    la[::7] = rng.integers(0, 151, la[::7].shape)
    lb[::5] = rng.integers(0, 153, lb[::5].shape)
    la[11], lb[12] = 0, 0
    return [torch.from_numpy(x) for x in (a, la, b, lb)]


def test_sw_kernel_matches_plain(cuda):
    # P = 1000 is not a multiple of the kernel's 128 pairs per block
    a, la, b, lb = (x.to(cuda) for x in _sw_pairs(1000))
    before = kernels.SW_SCORE.launches
    got = sw.sw_scores(a, la, b, lb)
    assert kernels.SW_SCORE.launches == before + 1
    want = sw.sw_scores_reference(a, la, b, lb)
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and torch.equal(got, want)
    assert int(got.max()) >= 150
    empty = sw.sw_scores(a[:0], la[:0], b[:0], lb[:0])
    assert empty.shape == (0,)


def _sw_check(cuda, a, la, b, lb, group=None):
    """The kernel's scores (one launch) equal the plain version's."""
    args = [torch.as_tensor(np.ascontiguousarray(x)).to(cuda) for x in (a, la, b, lb)]
    before = kernels.SW_SCORE.launches
    got = sw.sw_scores(*args, group=group)
    assert kernels.SW_SCORE.launches == before + (1 if len(a) else 0)
    want = sw.sw_scores_reference(*args)
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and torch.equal(got, want)
    return got


@pytest.mark.parametrize("p", [0, 1, 2, 3, 1000])
def test_sw_kernel_batch_sizes(cuda, p):
    # an odd P takes a pad pair of length 0
    _sw_check(cuda, *(x[:p] for x in _sw_pairs(16, seed=p)))


def test_sw_kernel_register_pairs_differ(cuda):
    """The two pairs of one register apart in la and in lb, one of them of
    length 0, and la = 0 or lb = 0 alone."""
    a, la, b, lb = (x[:8] for x in _sw_pairs(16, seed=6))
    la[:] = torch.tensor([150, 37, 0, 150, 150, 150, 12, 150])
    lb[:] = torch.tensor([152, 152, 152, 0, 91, 0, 152, 3])
    got = _sw_check(cuda, a, la, b, lb)
    assert int(got[2]) == 0 and int(got[3]) == 0 and int(got[5]) == 0


def test_sw_kernel_lr_512_identical(cuda):
    rng = np.random.default_rng(7)
    x = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, (5, 512))]
    got = _sw_check(cuda, x, np.full(5, 512), x.copy(), np.full(5, 512))
    assert (got == 512).all()


@pytest.mark.parametrize("lc", [600, 2000])  # 2000 > 32 lanes x 40 columns: two passes
def test_sw_kernel_lc_above_lr(cuda, lc):
    rng = np.random.default_rng(lc)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    a = acgt[rng.integers(0, 4, (77, 100))]
    b = acgt[rng.integers(0, 4, (77, lc))]
    b[:, 250:350] = a
    la, lb = rng.integers(0, 101, 77), rng.integers(0, lc + 1, 77)
    la[0], lb[0] = 100, lc
    got = _sw_check(cuda, a, la, b, lb)
    assert int(got[0]) == 100


@pytest.mark.parametrize("lr,lc", [(600, 150), (2000, 150), (600, 600), (2000, 2000),
                                   (4842, 5000)])
def test_sw_kernel_wide_rows(cuda, lr, lc):
    """Rows past the old 512-byte cap: wide a rows against reads (the
    wrapper makes the reads the rows), and wide rows on both sides (one
    pass, and passes with their edges in shared memory); a read planted in
    every second window scores its length."""
    rng = np.random.default_rng(lr + lc)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    p, n = 33, min(lr, lc) // 2
    a = acgt[rng.integers(0, 4, (p, lr))]
    b = acgt[rng.integers(0, 4, (p, lc))]
    b[::2, lc - n:] = a[::2, lr - n:]
    la, lb = np.full(p, lr), np.full(p, lc)
    la[1::4], lb[3::4] = rng.integers(0, lr + 1, la[1::4].shape), 0
    got = _sw_check(cuda, a, la, b, lb)
    assert (got[::2].cpu().numpy() >= n).all()


def _sw_wide(lr, lc, p, seed):
    """p ACGT pairs lr x lc wide: the narrower side planted in the wider one
    in every second pair, ragged lengths in pair 1 and a zero length in
    pair p - 1 (p >= 3)."""
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    a = acgt[rng.integers(0, 4, (p, lr))]
    b = acgt[rng.integers(0, 4, (p, lc))]
    a[::2] = b[::2, lc - lr:]
    la, lb = np.full(p, lr), np.full(p, lc)
    la[1], lb[1] = rng.integers(lr // 2, lr), rng.integers(lc // 2, lc)
    lb[p - 1] = 0
    return a, la, b, lb


@pytest.mark.parametrize("lr,lc", [(4843, 5000), (5000, 5000), (14600, 14600),
                                   (32767, 32767), (32768, 32800), (32800, 32800)])
def test_sw_kernel_past_shared_memory(cuda, lr, lc):
    """Rows past the 4,842 bytes shared memory holds: the "global" tier (one
    pass and several, its rows and pass edges in a global scratch) up to
    32,767 bytes, the "int32" tier past them.  One launch each, bit for bit
    the plain version; a planted pair scores its narrower width, so
    32,768 and 32,800 show that no score wraps at 16 bits."""
    tier = "global" if lr <= 32767 else "int32"
    assert sw.sw_layout(3, lr, lc)[3] == tier and sw.sw_scratch_bytes(3, lr, lc) > 0
    got = _sw_check(cuda, *_sw_wide(lr, lc, 3, seed=lr + lc))
    assert int(got[0]) == lr and int(got[2]) == 0


@pytest.mark.parametrize("lr,tier", [(4842, "shared"), (4843, "global"), (32767, "global"),
                                     (32768, "int32")])
def test_sw_kernel_tier_boundaries(cuda, lr, tier):
    """Each side of the tiers' boundaries, rows lr against lr + 1 columns
    and an odd P (a pad pair in the 16-bit tiers): the tier sw_layout
    picks, one launch, bit for bit; the planted pairs score lr."""
    assert sw.sw_layout(5, lr, lr + 1)[3] == tier
    got = _sw_check(cuda, *_sw_wide(lr, lr + 1, 5, seed=lr))
    assert int(got[0]) == int(got[2]) == lr and int(got[3]) < lr and int(got[4]) == 0


@pytest.mark.parametrize("p", [5120, 17920, 65536])
def test_sw_kernel_main_path_shapes(cuda, p):
    """The SW rerank's launches at stride 1 / k_clusters 10 and stride 4 /
    k_clusters 5 (512 reads each), and 65,536 pairs."""
    _sw_check(cuda, *_sw_pairs(p, seed=p))


@pytest.mark.parametrize("group,lc", [(1, 40), (2, 40), (4, 152), (8, 152), (16, 152),
                                      (32, 152)])
def test_sw_kernel_each_group(cuda, group, lc):
    # rows no wider than the lc columns, so the wrapper keeps a as the rows
    a, la, b, lb = _sw_pairs(999, seed=group)
    _sw_check(cuda, a[:, :lc], la.clamp(max=lc), b[:, :lc], lb.clamp(max=lc), group=group)


def _pq_tie_book(rng, np_):
    """Tie-heavy PQ inputs (m 8, nbits 2): codebook entries in {-1, 0, 1}
    and every row one of 16 code patterns, so most window minima are
    shared by several rows and only the lowest-row rule decides."""
    patterns = rng.integers(0, 4, (16, 8))
    return patterns[rng.integers(0, 16, np_)], rng.integers(-1, 2, (8, 4, 16))


# (rows, queries, w, ntotal): the main layout with part of the last window
# masked; one block over one slab (the fragment layouts alone); two slabs a
# window; and an ntotal that masks the last window whole, (3.4e38, its
# first row)
PQ_LAYOUTS = {"8192x640": (8192, 640, 128, 8192 - 333), "one block": (128, 128, 128, 123),
              "w256": (8192, 640, 256, 8192 - 333),
              "masked window": (8192, 256, 128, 8192 - 128 - 77)}


@pytest.mark.parametrize("layout", list(PQ_LAYOUTS))
@pytest.mark.parametrize("m,nbits", [(8, 8), (16, 8), (4, 8), (8, 6), (8, "ties"),
                                     (1, 8), (2, 8), (32, 8), (64, 8), (128, 8), (64, 6)])
@pytest.mark.parametrize("ratio", [1.0, 1.3])
def test_pq_winmin_kernel_matches_plain(cuda, m, nbits, ratio, layout):
    np_, qp, w, ntotal = PQ_LAYOUTS[layout]
    rng = np.random.default_rng(5)
    if nbits == "ties":
        codes, cent8 = _pq_tie_book(rng, np_)
    else:
        codes = rng.integers(0, 1 << nbits, (np_, m))
        cent8 = rng.integers(-127, 128, (m, 1 << nbits, 128 // m))
    codes = torch.tensor(codes, dtype=torch.uint8).to(cuda)
    cent8 = torch.tensor(cent8, dtype=torch.int8).to(cuda)
    q8 = torch.tensor(rng.integers(-127, 128, (qp, 128)), dtype=torch.int8).to(cuda)
    ratio2 = 2.0 * float(np.float32(ratio))
    before = kernels.PQ_WINMIN.launches
    v, a = sk.pq_winmin(q8, codes, cent8, ntotal, ratio2, w)
    assert kernels.PQ_WINMIN.launches == before + 1
    vr, ar = sk.pq_winmin_reference(q8, codes, cent8, ntotal, ratio2, w)
    assert torch.equal(v, vr) and torch.equal(a, ar)
    if layout == "masked window":
        assert bool((v[-1] == 3.4e38).all()) and bool((a[-1] == np_ - 128).all())


def test_fused_scan_topk_pq_kernel_matches_plain(cuda):
    rng = np.random.default_rng(6)
    q8 = torch.tensor(rng.integers(-127, 128, (512, 128)), dtype=torch.int8).to(cuda)
    codes = torch.tensor(rng.integers(0, 256, (4 * sk.CT, 8)), dtype=torch.uint8).to(cuda)
    cent8 = torch.tensor(rng.integers(-127, 128, (8, 256, 16)), dtype=torch.int8).to(cuda)
    args = (q8, codes, 4 * sk.CT - 1000, 64, sk.CT)
    d, i = sk.fused_scan_topk(*args, ratio=1.1, cent8=cent8)
    dr, ir = sk.fused_scan_topk(*args, ratio=1.1, cent8=cent8,
                                winmin=sk.pq_winmin_reference)
    assert torch.equal(d, dr) and torch.equal(i, ir)


def test_pqflat_fused_search_matches_exact_top1(cuda):
    from deepreadmapper_tpu_torch.index.pq_flat import PQFlatIndex
    from deepreadmapper_tpu_torch.ops.pq import PQCodebook

    rng = np.random.default_rng(7)
    n = sk.MIN_FUSED_N + 5000
    codes = rng.integers(0, 256, (n, 8)).astype(np.uint8)
    cent = torch.tensor(rng.standard_normal((8, 256, 16)) * 0.3, dtype=torch.float32)
    q = np.tanh(rng.standard_normal((300, 128))).astype(np.float32)
    idx = PQFlatIndex(codes, PQCodebook(cent.to(cuda)), n, device=cuda)
    before = kernels.PQ_WINMIN.launches
    fi, fd = idx.search(q, 32)
    assert kernels.PQ_WINMIN.launches > before  # the fused path ran
    ei, ed = idx.search(q, 32, exact=True)
    np.testing.assert_array_equal(fd[:, 0], ed[:, 0])
    assert (fi < n).all()


def test_kernel_wrappers_reject_bad_inputs(cuda):
    q8 = torch.zeros((100, 128), dtype=torch.int8, device=cuda)  # Qp % 128 != 0
    r8 = torch.zeros((256, 128), dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError):
        sk.int8_winmin(q8, r8, 256, 2.0)
    codes = torch.zeros((256, 8), dtype=torch.uint8, device=cuda)
    cent8 = torch.zeros((8, 256, 16), dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError):
        sk.pq_winmin(q8, codes, cent8, 256, 2.0)
    wide = torch.zeros((4, 600), dtype=torch.uint8, device=cuda)  # a rows > 512
    n = torch.full((4,), 600, device=cuda)
    with pytest.raises(ValueError):
        sw.sw_scores(wide, n, wide, n)
    x, w, bzr, r, rbh = _gru_args(64, torch.float32, cuda, b=8, t_steps=3)
    with pytest.raises(TypeError):
        gru.gru_proj_seq(x.half(), w, bzr, r, rbh, False)


def test_encoder_on_cuda_matches_cpu(cuda, data_dir):
    from deepreadmapper_tpu.io.fastq import parse_fastq_bytes
    from deepreadmapper_tpu_torch.models.encoder import Vectorizer, load_params

    mat, lengths, _ = parse_fastq_bytes(str(data_dir / "test_data.fastq"))
    params = load_params()
    got = Vectorizer(params, device=cuda).vectorize_wrapped_bytes(mat, lengths)
    want = Vectorizer(params, device="cpu").vectorize_wrapped_bytes(mat, lengths)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_int8flat_fused_search_matches_exact_top1(cuda):
    from deepreadmapper_tpu_torch.index.int8_flat import Int8FlatIndex

    rng = np.random.default_rng(3)
    n = sk.MIN_FUSED_N + 5000
    codes = rng.integers(-127, 128, (n, 128)).astype(np.int8)
    q = np.tanh(rng.standard_normal((300, 128))).astype(np.float32)
    idx = Int8FlatIndex(codes, 1.0 / 127.0, n, device=cuda)
    before = kernels.INT8_WINMIN.launches
    fi, fd = idx.search(q, 32)
    assert kernels.INT8_WINMIN.launches > before  # the fused path ran
    ei, ed = idx.search(q, 32, exact=True)
    np.testing.assert_array_equal(fd[:, 0], ed[:, 0])
    assert (fi < n).all()


def test_pipeline_cli_on_cuda(cuda, data_dir, tmp_path):
    from deepreadmapper_tpu_torch import cli

    fna = str(data_dir / "ecoli_150.fna")
    fq = str(data_dir / "test_data.fastq")
    idx, out = str(tmp_path / "idx"), str(tmp_path / "out")
    before = kernels.GRU_FWD.launches
    assert cli.main(["build-index", fna, idx, "150"]) == 0
    assert cli.main(["pipeline", idx, fq, fna, "128", "128", "5", out]) == 0
    assert kernels.GRU_FWD.launches > before
    ids = np.load(os.path.join(out, "indices.npy")).astype(np.int64)
    _, names = fastq.parse_fastq(fq)
    hits = sum(
        bool(np.any(np.abs(row // 2 - (int(nm.split("_")[1]) - 1)) <= 2))
        for row, nm in zip(ids, names)
    )
    assert hits >= 135


def test_pqflat_sw_pipeline_cli_on_cuda(cuda, data_dir, tmp_path):
    from deepreadmapper_tpu_torch import cli

    fna = str(data_dir / "ecoli_150.fna")
    fq = str(data_dir / "test_data.fastq")
    idx, out = str(tmp_path / "idx"), str(tmp_path / "out")
    assert cli.main(["build-index", fna, idx, "150", "--index-type", "PQFLAT",
                     "--opq"]) == 0
    before = kernels.SW_SCORE_BY_ID.launches
    assert cli.main(["pipeline", idx, fq, fna, "128", "10", "128", out,
                     "--rerank", "sw"]) == 0
    assert kernels.SW_SCORE_BY_ID.launches == before + 1  # the request's pairs by id
    with open(os.path.join(out, "results.sam")) as f:
        prim = [ln.split("\t") for ln in f if not ln.startswith("@")][::10]
    _, names = fastq.parse_fastq(fq)
    top1 = sum(abs(int(r[3]) - int(nm.split("_")[1])) <= 2 for r, nm in zip(prim, names))
    assert top1 >= 135


def _ivf_plan(rng, visit_chunks, n_chunks, n_visits, nq):
    """A chunk-step plan: visit v scans len visit_chunks[v] consecutive
    chunks (visits past the list get no steps); qidx rows are distinct
    queries per visit, 20% padding to the dump row nq."""
    sc, sv = [], []
    for v, nc in enumerate(visit_chunks):
        c0 = int(rng.integers(0, n_chunks - nc))
        sc += list(range(c0, c0 + nc))
        sv += [v] * nc
    qidx = np.stack([np.where(rng.random(32) < 0.8, rng.permutation(nq)[:32], nq)
                     for _ in range(n_visits)])
    return (np.array(sc, np.int32), np.array(sv + [-1], np.int32),
            qidx.astype(np.int32))


def _ivf_inputs(cuda, amp, seed=8, n_chunks=6, visit_chunks=(1, 3, 2, 1, 2), n_visits=7):
    """Random int8 chunks of amplitude amp ("ties": every row one of 16
    patterns of values in {-2..2}), chunk 1 half empty, the last chunk the
    all-empty dump chunk, and a plan from _ivf_plan."""
    from deepreadmapper_tpu_torch.ops import ivf_kernel as ik

    rng = np.random.default_rng(seed)
    if amp == "ties":
        codes = rng.integers(-2, 3, (16, 128))[rng.integers(0, 16, (n_chunks, ik.CHK))]
        codes = codes.astype(np.int8)
    else:
        codes = rng.integers(-amp, amp + 1, (n_chunks, ik.CHK, 128)).astype(np.int8)
    codes[-1] = 0
    codes[1, 1500:] = 0
    rn = (codes.astype(np.int64) ** 2).sum(-1).astype(np.float32)
    rn[1, 1500:] = rn[-1] = np.float32(3.4e38)
    sc, sv, qidx = _ivf_plan(rng, list(visit_chunks), n_chunks, n_visits, 50)
    q = rng.integers(-127, 128, (n_visits, 32, 128)).astype(np.int8)
    return rng, [torch.from_numpy(a).to(cuda) for a in (sc, sv, qidx, q, codes, rn)]


# plans: _ivf_inputs' default (visits of 1-3 steps, two of none), and
# visits of 0, 1, 2, 3 and 7 steps over 10 chunks (the kernel's slab ring
# crosses step boundaries)
IVF_PLANS = {"default": {},
             "visit lengths": dict(seed=13, n_chunks=10, visit_chunks=(0, 1, 7, 2, 0, 3, 1),
                                   n_visits=8)}


@pytest.mark.parametrize("plan", list(IVF_PLANS))
@pytest.mark.parametrize("ratio", [1.0, 1.3])
# amp 2: many exact ties; "ties": every row one of 16 patterns of values in
# {-2..2}, so most lane windows' best rows tie
@pytest.mark.parametrize("amp", [127, 2, "ties"])
def test_ivf_chunk_int8_kernels_match_plain(cuda, ratio, amp, plan):
    """Packed and fold, bit for bit against the plain versions; a visit
    with no steps writes (3.4e38, 0) everywhere."""
    from deepreadmapper_tpu_torch.ops import ivf_kernel as ik

    _, (sc, sv, qidx, q, codes, rn) = _ivf_inputs(cuda, amp, **IVF_PLANS[plan])
    ratio2 = 2.0 * float(np.float32(ratio))
    before = kernels.IVF_CHUNK_INT8.launches
    got = ik.ivf_chunk_scan_int8(sc, sv, q, codes, rn, ratio2)
    assert kernels.IVF_CHUNK_INT8.launches == before + 1
    want = ik.ivf_chunk_scan_int8_reference(sc, sv, q, codes, rn, ratio2)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    empty = got[ik.visit_steps(sv, q.shape[0])[1] == 0]
    assert empty.shape[0] >= 2
    assert bool((empty[..., :2 * ik.KP] == 3.4e38).all())
    assert bool((empty[..., 2 * ik.KP:].view(torch.int32) == 0).all())
    before = kernels.IVF_CHUNK_INT8_FOLD.launches
    got = ik.ivf_chunk_scan_int8_fold(sc, sv, qidx, q, codes, rn, ratio2, 50)
    assert kernels.IVF_CHUNK_INT8_FOLD.launches == before + 1
    want = ik.ivf_chunk_scan_int8_fold_reference(sc, sv, qidx, q, codes, rn, ratio2, 50)
    torch.cuda.synchronize()
    assert torch.equal(got[:50].view(torch.int32), want[:50].view(torch.int32))


def _pq_tables(rng, m, nbits, rn, codes, cuda):
    """Byte-packed codes [n_chunks, ceil(m/4), CHK] int32, an int8 codebook
    [m*ksub, 128/m] and the rebuilt rows' norms (3.4e38 where rn has it);
    codes "ties": every row one of 8 code patterns, so most lane windows'
    best rows tie."""
    from deepreadmapper_tpu_torch.ops import ivf_kernel as ik

    ksub = 1 << nbits
    n_chunks = rn.shape[0]
    if codes == "ties":
        c8 = rng.integers(0, ksub, (8, m))[rng.integers(0, 8, (n_chunks, ik.CHK))]
    else:
        c8 = rng.integers(0, ksub, (n_chunks, ik.CHK, m))
    words = np.zeros((n_chunks, -(-m // 4), ik.CHK), np.uint32)
    for j in range(m):
        words[:, j // 4] |= c8[..., j].astype(np.uint32) << np.uint32(8 * (j % 4))
    cent = rng.integers(-127, 128, (m, ksub, 128 // m))
    rows = np.concatenate([cent[j][c8[..., j]] for j in range(m)], axis=-1)
    norms = (rows.astype(np.int64) ** 2).sum(-1).astype(np.float32)
    norms[rn.cpu().numpy() == np.float32(3.4e38)] = np.float32(3.4e38)
    return (torch.from_numpy(words.view(np.int32)).to(cuda),
            torch.tensor(cent.reshape(m * ksub, 128 // m), dtype=torch.int8).to(cuda),
            torch.from_numpy(norms).to(cuda))


@pytest.mark.parametrize("plan", list(IVF_PLANS))
@pytest.mark.parametrize("codes", ["random", "ties"])
@pytest.mark.parametrize("m,nbits", [(8, 8), (16, 8), (8, 6), (4, 8), (32, 8), (32, 6),
                                     (1, 8), (2, 8), (64, 8), (128, 8), (128, 6)])
@pytest.mark.parametrize("ratio", [1.0, 1.3])
def test_ivf_chunk_pq_kernels_match_plain(cuda, m, nbits, ratio, codes, plan):
    """Packed and fold, bit for bit against the plain versions, at every m;
    a visit with no steps writes (3.4e38, 0) everywhere; the fold pass
    alone over the packed states gives the fold scan's accumulator."""
    from deepreadmapper_tpu_torch.ops import ivf_kernel as ik

    rng, (sc, sv, qidx, q, _codes, rn8) = _ivf_inputs(cuda, 127, **IVF_PLANS[plan])
    packed, cent2d, rn = _pq_tables(rng, m, nbits, rn8, codes, cuda)
    ratio2 = 2.0 * float(np.float32(ratio))
    before = kernels.IVF_CHUNK_PQ.launches
    got = ik.ivf_chunk_scan_pq(sc, sv, q, packed, rn, cent2d, ratio2, m)
    assert kernels.IVF_CHUNK_PQ.launches == before + 1
    want = ik.ivf_chunk_scan_pq_reference(sc, sv, q, packed, rn, cent2d, ratio2, m)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    empty = got[ik.visit_steps(sv, q.shape[0])[1] == 0]
    assert empty.shape[0] >= 2
    assert bool((empty[..., :2 * ik.KP] == 3.4e38).all())
    assert bool((empty[..., 2 * ik.KP:].view(torch.int32) == 0).all())
    if codes == "ties":  # the best and second-best of most stepped windows tie
        stepped = got[ik.visit_steps(sv, q.shape[0])[1] > 0]
        assert (stepped[..., :ik.KP] == stepped[..., ik.KP:2 * ik.KP]).float().mean() > 0.5
    before = kernels.IVF_CHUNK_PQ_FOLD.launches
    facc = ik.ivf_chunk_scan_pq_fold(sc, sv, qidx, q, packed, rn, cent2d, ratio2, m, 50)
    assert kernels.IVF_CHUNK_PQ_FOLD.launches == before + 1
    want = ik.ivf_chunk_scan_pq_fold_reference(sc, sv, qidx, q, packed, rn, cent2d,
                                               ratio2, m, 50)
    torch.cuda.synchronize()
    assert torch.equal(facc[:50].view(torch.int32), want[:50].view(torch.int32))
    alone = ik.ivf_fold(got, sv, qidx, 50)
    torch.cuda.synchronize()
    assert torch.equal(alone.view(torch.int32), facc.view(torch.int32))


@pytest.mark.parametrize("index_type", ["IVFINT8", "IVFPQ"])
def test_ivf_search_on_cuda_matches_cpu(cuda, index_type, monkeypatch):
    """All three routes (fused, host packed, host fold) on the card give the
    CPU's ids and distances on the same index."""
    from deepreadmapper_tpu_torch.config import BuildConfig
    from deepreadmapper_tpu_torch.index.ivf_int8 import IVFInt8Index
    from deepreadmapper_tpu_torch.index.ivf_pq import IVFPQIndex

    rng = np.random.default_rng(9)
    centers = np.tanh(rng.standard_normal((64, 128))).astype(np.float32)
    x = np.clip(centers[rng.integers(0, 64, 6000)]
                + 0.05 * rng.standard_normal((6000, 128)).astype(np.float32), -1, 1)
    cls = IVFInt8Index if index_type == "IVFINT8" else IVFPQIndex
    cpu = cls.build(x, BuildConfig(nlist=8), device="cpu")
    gpu_idx = (IVFInt8Index(cpu.codes_cm, cpu.centroids, cpu.row_ids, cpu.slab_of, cpu.scale,
                            cpu.ntotal, cpu.cap, cpu.n_slabs, device=cuda)
               if cls is IVFInt8Index else
               IVFPQIndex(cpu.codes_cm, cpu.centroids, cpu.row_ids, cpu.slab_of,
                          cpu.codebook, cpu.ntotal, cpu.cap, cpu.n_slabs, device=cuda))
    q = x[:40] + np.float32(0.01)
    for fused, fold in ((8192, 4096), (0, 4096), (0, 1)):
        monkeypatch.setattr(cls, "_FUSED_MAX_PAIRS", fused)
        monkeypatch.setattr(cls, "_FOLD_MIN_Q", fold)
        ci, cd = cpu.search(q, 10, ef=4)
        gi, gd = gpu_idx.search(q, 10, ef=4)
        np.testing.assert_array_equal(gi, ci)
        np.testing.assert_array_equal(gd, cd)


# (T, B): the training batch and a ragged one; T = 1 is one step with no
# product (the elementwise part and the stores alone) and T = 2 one product,
# which catch a wrong weight-to-lane mapping before 123 steps blur it;
# B = 1, 2 and 17 leave a block half empty or one sequence over
@pytest.mark.parametrize("t_steps,b", [(123, 512), (123, 1001), (1, 512), (2, 512),
                                       (2, 17), (123, 1), (123, 2), (123, 17)])
@pytest.mark.parametrize("reverse", [False, True])
def test_gru_bwd_kernel_matches_plain(cuda, t_steps, b, reverse):
    """The cotangent recurrence (#9) against its plain version: (dgx
    [T,B,192], dghn [T,B,64]), max abs error within 1e-5 of the largest
    value (fp32, the 192-deep product summed in another order)."""
    rng = np.random.default_rng(11)
    shape = (t_steps, b, gru.H)
    arrs = [rng.uniform(-1, 1, shape), rng.uniform(0, 1, shape), rng.uniform(0, 1, shape),
            rng.uniform(-1, 1, shape), rng.standard_normal(shape), rng.standard_normal(shape),
            rng.standard_normal((gru.G, gru.H)) * 0.2]
    ins = [torch.tensor(a, dtype=torch.float32).to(cuda) for a in arrs]
    before = kernels.GRU_BWD.launches
    got = gru.gru_bwd(*ins, reverse)
    assert kernels.GRU_BWD.launches == before + 1
    want = gru.gru_bwd_reference(*ins, reverse)
    torch.cuda.synchronize()
    for g, w, width in zip(got, want, (gru.G, gru.H)):
        assert g.shape == w.shape == (t_steps, b, width)
        assert float((g - w).abs().max() / w.abs().max()) <= 1e-5


def test_train_step_gradients_on_cuda_match_cpu(cuda, data_dir):
    """One training step's gradients on the card (kernels #1 and #9) against
    the same step on the CPU (plain versions): each tensor within 1e-4 of
    its largest value (the embedding gradient is an atomic scatter-add on
    the card)."""
    from deepreadmapper_tpu_torch.io.fasta import extract_fasta_sequence
    from deepreadmapper_tpu_torch.models import encoder as enc
    from deepreadmapper_tpu_torch.parallel import train
    from deepreadmapper_tpu_torch.pipeline.finetune import sample_pairs

    genome = extract_fasta_sequence(str(data_dir / "ecoli_150.fna"))
    rt, wt = sample_pairs(genome, 150, 64, np.random.default_rng(0))
    grads = {}
    for dev in (cuda, torch.device("cpu")):
        params = enc.torch_params(enc.load_params(), dev, requires_grad=True)
        before = kernels.GRU_BWD.launches
        train.loss_fn(params, torch.from_numpy(rt).to(dev),
                      torch.from_numpy(wt).to(dev)).backward()
        assert kernels.GRU_BWD.launches == before + (8 if dev.type == "cuda" else 0)
        grads[dev.type] = [p.grad.cpu() for p in train.leaves(params)]
    for g, c in zip(grads["cuda"], grads["cpu"]):
        assert float((g - c).abs().max() / c.abs().max()) <= 1e-4
