"""Port parity: the GRU plain version and the full encoder against the JAX
package (which resolves gru_proj_* to its lax.scan reference on the CPU).

Tolerances: fp32 atol 1e-5 (op order differs, both fp32); bf16 per-step
outputs within one bf16 ulp of values below 1 (2^-8 = 3.9e-3, taken as
4e-3); the encoder at the bound of tests/test_encoder.py.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from deepreadmapper_tpu import tokenizer as tok
from deepreadmapper_tpu.models import encoder as jenc
from deepreadmapper_tpu.models import gru_pallas as gp
from deepreadmapper_tpu_torch import kernels
from deepreadmapper_tpu_torch.models import encoder as tenc
from deepreadmapper_tpu_torch.models import gru


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two torch threads per test process: the suite runs in parallel
    processes, and the plain GRU's 123-step loop of small ops slows down
    badly when every process starts a thread per core."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _gru_case(din, seed=0, t_steps=17, b=11):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (t_steps, b, din)).astype(np.float32)
    w = (rng.standard_normal((din, gru.G)) * 0.2).astype(np.float32)
    bzr = (rng.standard_normal(gru.G) * 0.1).astype(np.float32)
    r = (rng.standard_normal((gru.H, gru.G)) * 0.2).astype(np.float32)
    rbh = (rng.standard_normal(gru.H) * 0.1).astype(np.float32)
    return x, w, bzr, r, rbh


@pytest.mark.parametrize("din", [64, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("last", [False, True])
def test_gru_matches_jax(din, dtype, reverse, last):
    arrs = _gru_case(din)
    jfn = gp.gru_proj_last if last else gp.gru_proj_seq
    tfn = gru.gru_proj_last if last else gru.gru_proj_seq
    want = jfn(*(jnp.asarray(a, dtype) for a in arrs), reverse)
    tdt = getattr(torch, dtype)
    before = kernels.GRU_FWD.launches
    got = tfn(*(torch.from_numpy(a).to(tdt) for a in arrs), reverse)
    assert kernels.GRU_FWD.launches == before  # CPU tensors: plain version
    assert tuple(got.shape) == tuple(want.shape)
    # last-step output is fp32; per-step output keeps the input dtype
    assert got.dtype == (torch.float32 if last else tdt)
    want = np.asarray(want.astype(jnp.float32))
    atol = 4e-3 if (dtype == "bfloat16" and not last) else 1e-5
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=atol)


def test_gru_rejects_bad_shapes():
    x, w, bzr, r, rbh = (torch.from_numpy(a) for a in _gru_case(64))
    with pytest.raises(ValueError):
        gru.gru_proj_seq(x, w[:32], bzr, r, rbh, False)
    with pytest.raises(ValueError):
        gru.gru_proj_last(x[0], w, bzr, r, rbh, False)


def _fixture_tokens(data_dir, n):
    from deepreadmapper_tpu.io import fastq

    seqs, _ = fastq.parse_fastq(str(data_dir / "test_data.fastq"))
    return tok.tokenize_strings(seqs[:n])


def _random_params(seed):
    rng = np.random.default_rng(seed)
    layers = []
    for din in (64, 128):
        layers.append(jenc.GRULayerParams(
            w=jnp.asarray(rng.standard_normal((2, din, 192)) * 0.3, jnp.float32),
            r=jnp.asarray(rng.standard_normal((2, 64, 192)) * 0.3, jnp.float32),
            bzr=jnp.asarray(rng.standard_normal((2, 192)) * 0.1, jnp.float32),
            rbh=jnp.asarray(rng.standard_normal((2, 64)) * 0.1, jnp.float32),
        ))
    emb = jnp.asarray(rng.standard_normal((tok.VOCAB_SIZE, 64)), jnp.float32)
    return jenc.EncoderParams(embedding=emb, layers=tuple(layers))


@pytest.mark.parametrize("weights", ["shipped", "random"])
def test_encoder_matches_jax(data_dir, weights):
    tokens = _fixture_tokens(data_dir, 24)
    tokens[-4:, 90:] = 0  # zero padding as short reads produce
    if weights == "shipped":
        jparams = jenc.load_params()
        tparams = tenc.load_params()
    else:
        jparams = _random_params(3)
        tparams = tenc.params_from_jax(jparams)
    want = np.asarray(jenc.encode_tokens(jparams, tokens))
    got = tenc.Encoder(tparams).encode_tokens(torch.from_numpy(tokens)).numpy()
    assert got.shape == (24, 128) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_encoder_bf16_matches_jax(data_dir):
    """bf16 mode: bf16 gather, weights and layer-1 outputs, fp32 gate math
    in both packages.  Bound: a layer-1 output may round to the other bf16
    neighbour where the fp32 values differ in the last bits (measured
    5.4e-5 on these reads; 1e-3 leaves room, far below the 5.9e-3 gap
    between bf16 and fp32 mode)."""
    tokens = _fixture_tokens(data_dir, 24)
    want = np.asarray(jenc.encode_tokens(jenc.load_params(), tokens,
                                         dtype="bfloat16"))
    got = tenc.Encoder().encode_tokens(torch.from_numpy(tokens), torch.bfloat16)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-3)


def test_load_params_matches_jax_layout():
    jp = jenc.load_params()
    tp = tenc.load_params()
    np.testing.assert_array_equal(tp["embedding"], np.asarray(jp.embedding))
    for jl, tl in zip(jp.layers, tp["layers"]):
        for k in ("w", "r", "bzr", "rbh"):
            np.testing.assert_array_equal(tl[k], np.asarray(getattr(jl, k)))
    conv = tenc.params_from_jax(jp)
    for tl, cl in zip(tp["layers"], conv["layers"]):
        for k in ("w", "r", "bzr", "rbh"):
            np.testing.assert_array_equal(tl[k], cl[k])


def test_vectorizer_top1_agrees_on_fixture(data_dir, ecoli_embeddings):
    """Port embeddings of the fixture windows and reads vs the JAX ones:
    same values (encoder bound) and the same exact top-1 window for every
    read whose JAX top-2 distances are not a near tie."""
    from deepreadmapper_tpu.io import fasta as fio
    from deepreadmapper_tpu.io.fastq import parse_fastq_bytes
    from deepreadmapper_tpu_torch.pipeline.build import embed_fasta_windows

    jref, jq = ecoli_embeddings
    vec = tenc.Vectorizer(device_batch=1024, device="cpu")
    recs = fio.parse_fasta_records(str(data_dir / "ecoli_150.fna"))
    tref = embed_fasta_windows(recs, 150, 1, vec)
    mat, lengths, _ = parse_fastq_bytes(str(data_dir / "test_data.fastq"))
    tq = vec.vectorize_wrapped_bytes(mat, lengths)
    np.testing.assert_allclose(tref, jref, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tq, jq, rtol=1e-4, atol=1e-5)

    def dists(q, r):
        return ((q[:, None, :] - r[None, :, :]) ** 2).sum(-1)

    jd, td = dists(jq, jref), dists(tq, tref)
    jorder = np.argsort(jd, axis=1, kind="stable")
    gap = np.take_along_axis(jd, jorder[:, 1:2], 1) - np.take_along_axis(
        jd, jorder[:, :1], 1)
    clear = gap[:, 0] > 1e-4
    assert clear.sum() > 100
    np.testing.assert_array_equal(td.argmin(1)[clear], jorder[clear, 0])


def test_vectorizer_batching_consistency(data_dir):
    tokens = _fixture_tokens(data_dir, 40)
    params = tenc.load_params()
    a = tenc.Vectorizer(params, device_batch=16, device="cpu").vectorize_tokens(tokens)
    b = tenc.Vectorizer(params, device_batch=64, device="cpu").vectorize_tokens(tokens)
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    empty = tenc.Vectorizer(params, device="cpu").vectorize_tokens(tokens[:0])
    assert empty.shape == (0, 128)
