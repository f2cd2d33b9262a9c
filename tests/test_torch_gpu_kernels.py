"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

Marked ``gpu``; every test skips without a CUDA device (decided in the
``cuda`` fixture, never at import).  Run on a machine with an H100:

    python -m pytest tests/test_torch_gpu_kernels.py -m gpu -q
"""

import os

import numpy as np
import pytest
import torch

from deepreadmapper_tpu_torch import kernels
from deepreadmapper_tpu_torch.models import gru
from deepreadmapper_tpu_torch.ops import scan_kernel as sk

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


@pytest.mark.parametrize("din", [64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("last", [False, True])
def test_gru_kernel_matches_plain(cuda, din, dtype, reverse, last):
    # B = 1001 is not a multiple of the kernel's sequence tile: ragged edge
    args = _gru_args(din, dtype, cuda)
    before = kernels.GRU_FWD.launches
    fn = gru.gru_proj_last if last else gru.gru_proj_seq
    got = fn(*args, reverse)
    assert kernels.GRU_FWD.launches == before + 1
    want = gru.gru_reference(*args, reverse, last)
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == want.dtype
    # fp32: accumulation order only; bf16 per-step outputs: one bf16 ulp
    tol = 1e-2 if (dtype == torch.bfloat16 and not last) else 1e-4
    assert (got.float() - want.float()).abs().max().item() <= tol


@pytest.mark.parametrize("w", [128, 512])
@pytest.mark.parametrize("ratio", [1.0, 1.3])
@pytest.mark.parametrize("amp", [127, 2])  # amp 2: many exact ties
def test_int8_winmin_kernel_matches_plain(cuda, w, ratio, amp):
    rng = np.random.default_rng(1)
    q8 = torch.tensor(rng.integers(-127, 128, (640, 128)), dtype=torch.int8).to(cuda)
    r8 = torch.tensor(rng.integers(-amp, amp + 1, (8192, 128)),
                      dtype=torch.int8).to(cuda)
    ratio2 = 2.0 * float(np.float32(ratio))
    ntotal = 8192 - 333
    before = kernels.INT8_WINMIN.launches
    v, a = sk.int8_winmin(q8, r8, ntotal, ratio2, w)
    assert kernels.INT8_WINMIN.launches == before + 1
    vr, ar = sk.int8_winmin_reference(q8, r8, ntotal, ratio2, w)
    assert torch.equal(v, vr) and torch.equal(a, ar)


def test_fused_scan_topk_kernel_matches_plain(cuda):
    rng = np.random.default_rng(2)
    q8 = torch.tensor(rng.integers(-127, 128, (512, 128)), dtype=torch.int8).to(cuda)
    r8 = torch.tensor(rng.integers(-127, 128, (4 * sk.CT, 128)),
                      dtype=torch.int8).to(cuda)
    args = (q8, r8, 4 * sk.CT - 1000, 64, sk.CT)
    d, i = sk.fused_scan_topk(*args, ratio=1.1)
    dr, ir = sk.fused_scan_topk(*args, ratio=1.1, winmin=sk.int8_winmin_reference)
    assert torch.equal(d, dr) and torch.equal(i, ir)


def test_kernel_wrappers_reject_bad_inputs(cuda):
    q8 = torch.zeros((100, 128), dtype=torch.int8, device=cuda)  # Qp % 128 != 0
    r8 = torch.zeros((256, 128), dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError):
        sk.int8_winmin(q8, r8, 256, 2.0)
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
    from deepreadmapper_tpu.io import fastq
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
