"""Port parity: the GRU plain version, its gradient and the full encoder
against the JAX package (which resolves gru_proj_* to its lax.scan
reference on the CPU).

Tolerances: fp32 atol 1e-5 (op order differs, both fp32); bf16 per-step
outputs within one bf16 ulp of values below 1 (2^-8 = 3.9e-3, taken as
4e-3); the encoder at the bound of tests/test_encoder.py.
"""

import numpy as np
import jax
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
    gates = [torch.from_numpy(a) for a in _bwd_case(3, 4)]
    with pytest.raises(ValueError):  # rT must be [192, 64]
        gru.gru_bwd(*gates[:6], gates[6].T)
    with pytest.raises(TypeError):
        gru.gru_bwd(*gates[:5], gates[5].double(), gates[6])


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


# ------------------------------------------------------------ the backward


def _bwd_case(t_steps, b, seed=5):
    """Gate-recurrence inputs in their ranges: h_prev, n in (-1, 1), z, r in
    (0, 1), gnb and ct normal; rT [192, 64]."""
    rng = np.random.default_rng(seed)
    hp, n = (rng.uniform(-1, 1, (t_steps, b, gru.H)) for _ in range(2))
    z, r = (rng.uniform(0, 1, (t_steps, b, gru.H)) for _ in range(2))
    gnb, ct = (rng.standard_normal((t_steps, b, gru.H)) for _ in range(2))
    rT = rng.standard_normal((gru.G, gru.H)) * 0.2
    return [a.astype(np.float32) for a in (hp, z, r, n, gnb, ct, rT)]


@pytest.mark.parametrize("reverse", [False, True])
def test_gru_bwd_reference_matches_pallas_interpret(reverse):
    """The plain cotangent recurrence against the JAX Pallas kernel in
    interpret mode, T = 11, B = 20 with a batch tile of 16 (the pad path).
    The JAX kernel only walks t = T-1 .. 0, so the reverse walk is held to it
    on time-flipped inputs.  The port returns (dgx, dghn): dghn is the JAX
    dgh's last 64 columns, and the JAX dgh's first 128 columns equal its
    dgx's (exactly: the kernel stores the same values), which is why the
    port can drop them.  Tolerance rtol/atol 1e-5 (fp32, the 192-deep
    product summed in another order)."""
    hp, z, r, n, gnb, ct, rT = _bwd_case(11, 20)
    flip = (lambda a: a[::-1].copy()) if reverse else (lambda a: a)
    seq = [flip(a) for a in (hp, z, r, n, gnb, ct)]
    jdgx, jdgh = (flip(np.asarray(a)) for a in gp._pallas_bwd_scan(
        jnp.asarray(rT), *map(jnp.asarray, seq), bt=16, interpret=True))
    np.testing.assert_array_equal(jdgh[..., :2 * gru.H], jdgx[..., :2 * gru.H])
    before = kernels.GRU_BWD.launches
    dgx, dghn = gru.gru_bwd(*(torch.from_numpy(a) for a in (hp, z, r, n, gnb, ct, rT)),
                            reverse=reverse)
    assert kernels.GRU_BWD.launches == before  # CPU tensors: plain version
    assert dgx.shape == (11, 20, gru.G) and dghn.shape == (11, 20, gru.H)
    assert dgx.dtype == dghn.dtype == torch.float32
    for got, want in ((dgx, jdgx), (dghn, jdgh[..., 2 * gru.H:])):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def _grad_inputs(arrs, dtype):
    return [torch.from_numpy(a).to(dtype).requires_grad_(True) for a in arrs]


def _rel_err(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# bf16 inputs: both packages run the backward in fp32 from the same bf16
# values and round each gradient to bf16 at the end, so a gradient may sit
# one bf16 step (2^-8 of its value) from the other's where the fp32 sums
# differ in the last bits; measured at most 1.9e-3 of the largest gradient
# here, bound 8e-3.  fp32: measured at most 8.7e-7, bound 1e-5.
_GRAD_RTOL = {"float32": 1e-5, "bfloat16": 8e-3}


@pytest.mark.parametrize("last", [False, True])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gru_grads_match_jax_vjp(last, reverse, dtype):
    """Grads of x, w, bzr, r, rbh through the autograd Functions against
    jax.vjp of the JAX custom_vjp (its manual backward, lax.scan branch),
    each as max abs error over the JAX gradient's max abs value."""
    din = 128 if last else 64  # the encoder's layer 2 and layer 1 inputs
    arrs = _gru_case(din, seed=7)
    jfn = gp.gru_proj_last if last else gp.gru_proj_seq
    jin = [jnp.asarray(a, dtype) for a in arrs]
    out, vjp = jax.vjp(lambda *a: jfn(*a, reverse), *jin)
    ct = np.random.default_rng(8).standard_normal(out.shape).astype(np.float32)
    want = vjp(jnp.asarray(ct, out.dtype))
    tdt = getattr(torch, dtype)
    tin = _grad_inputs(arrs, tdt)
    tfn = gru.gru_proj_last if last else gru.gru_proj_seq
    got = tfn(*tin, reverse)
    assert got.grad_fn is not None
    got.backward(torch.from_numpy(ct).to(got.dtype))
    for name, t, w in zip(("x", "w", "bzr", "r", "rbh"), tin, want):
        assert t.grad.dtype == tdt and tuple(t.grad.shape) == tuple(w.shape)
        err = _rel_err(t.grad.float().numpy(), np.asarray(w.astype(jnp.float32)))
        assert err <= _GRAD_RTOL[dtype], (name, err)


@pytest.mark.parametrize("last", [False, True])
@pytest.mark.parametrize("reverse", [False, True])
def test_gru_grads_match_autograd_of_plain_loop(last, reverse):
    """The manual backward against torch autograd through gru_reference's
    Python loop, fp32: rel 1e-5 (the same math, summed in another order)."""
    din = 128 if last else 64
    arrs = _gru_case(din, seed=9)
    ct = torch.from_numpy(np.random.default_rng(10).standard_normal(
        (11, gru.H) if last else (17, 11, gru.H)).astype(np.float32))
    tin = _grad_inputs(arrs, torch.float32)
    (gru.gru_proj_last if last else gru.gru_proj_seq)(*tin, reverse).backward(ct)
    ref = _grad_inputs(arrs, torch.float32)
    gru.gru_reference(*ref, reverse, last).backward(ct)
    for t, w in zip(tin, ref):
        assert _rel_err(t.grad.numpy(), w.grad.numpy()) <= 1e-5


# ------------------------------------- the kernel's TF32 products, emulated


def _tf32(v):
    """fp32 -> TF32 (10 mantissa bits), to nearest with ties away from zero,
    as cvt.rna.tf32.f32 rounds."""
    return ((v.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _tf32_trunc(v):
    """fp32 -> TF32 by dropping the 13 low bits, as mma.sync reads an fp32
    register."""
    return (v.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def _tf32_matmul(a, b, passes):
    """a @ b as csrc/gru_fwd.cu forms it on the tensor cores: TF32 operands
    (their products are exact in fp32), fp32 sums; three passes add the
    products with each operand's remainder lo = v - hi, which the kernel
    hands to mma.sync unrounded."""
    ah, bh = _tf32(a), _tf32(b)
    if passes == 1:
        return ah @ bh
    al, bl = _tf32_trunc(a - ah), _tf32_trunc(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _gru_tf32(x, w, bzr, r, rbh, reverse, last_only, passes):
    """gru_reference with every product through _tf32_matmul."""
    t_steps, b, din = x.shape
    gx = _tf32_matmul(x.reshape(-1, din), w, passes).reshape(t_steps, b, gru.G) + bzr
    h = torch.zeros((b, gru.H))
    hs = torch.empty((t_steps, b, gru.H))
    for t in (range(t_steps - 1, -1, -1) if reverse else range(t_steps)):
        gh = _tf32_matmul(h, r, passes)
        z = torch.sigmoid(gx[t, :, :gru.H] + gh[:, :gru.H])
        rg = torch.sigmoid(gx[t, :, gru.H:2 * gru.H] + gh[:, gru.H:2 * gru.H])
        n = torch.tanh(gx[t, :, 2 * gru.H:] + rg * (gh[:, 2 * gru.H:] + rbh))
        h = (1.0 - z) * n + z * h
        hs[t] = h
    return h if last_only else hs


@pytest.mark.parametrize("weights", ["shipped", "random"])
def test_gru_kernel_needs_three_tf32_passes(monkeypatch, weights):
    """The precision of the kernel's step products, pinned on the CPU: the
    two-layer encoder over seeded 150 bp reads (T = 123, B = 32) with every
    product in three TF32 passes stays within 1e-5 of the fp32 plain
    version on layer 1's outputs and on the embedding; with one TF32 pass it
    is off by more than 1e-4, the tolerance the kernel is held to on the
    card.  The shipped weights come from fp16 and are exact in TF32, so
    random fp32 weights also exercise the weights' split.  Measured (layer 1,
    embedding): shipped 1.1e-6, 6.7e-7 against 3.9e-4, 3.4e-4 for one pass;
    random 3.2e-6, 4.7e-6 against 4.2e-3, 6.0e-3."""
    rng = np.random.default_rng(12)
    seqs = ["".join(rng.choice(list("ACGT"), 150)) for _ in range(32)]
    tokens = torch.from_numpy(tok.tokenize_strings(seqs))
    assert tokens.shape == (32, tenc.MAX_LEN)
    params = tenc.torch_params(
        tenc.load_params() if weights == "shipped"
        else jax.tree_util.tree_map(np.array, tenc.params_from_jax(_random_params(3))), "cpu")
    outs = {}
    for passes in (None, 3, 1):  # None: the plain version, fp32 products
        layer1 = []

        def seq(*a, passes=passes, layer1=layer1):
            hs = (gru.gru_proj_seq(*a) if passes is None
                  else _gru_tf32(*a, last_only=False, passes=passes))
            layer1.append(hs)
            return hs

        def last(*a, passes=passes):
            return (gru.gru_proj_last(*a) if passes is None
                    else _gru_tf32(*a, last_only=True, passes=passes))

        with monkeypatch.context() as m:
            m.setattr(tenc, "gru_proj_seq", seq)
            m.setattr(tenc, "gru_proj_last", last)
            emb = tenc.encode_tokens_impl(params, tokens)
        outs[passes] = (torch.cat(layer1, -1), emb)
    errs = {p: tuple((a - b).abs().max().item() for a, b in zip(outs[p], outs[None]))
            for p in (3, 1)}
    assert max(errs[3]) <= 1e-5, errs
    assert min(errs[1]) > 1e-4, errs


def test_gru_serving_path_saves_nothing():
    """Under no_grad, or with no input that requires grad, the entries call
    the forward directly: no autograd node, nothing saved."""
    arrs = _gru_case(64)
    tin = _grad_inputs(arrs, torch.float32)
    with torch.no_grad():
        assert gru.gru_proj_seq(*tin, False).grad_fn is None
        assert gru.gru_proj_last(*tin, True).grad_fn is None
    plain = [torch.from_numpy(a) for a in arrs]
    assert gru.gru_proj_seq(*plain, False).grad_fn is None
