"""Port parity for fine-tuning: the InfoNCE loss and its gradient, pair
sampling, a few Adam steps, exact resume, the weights npz, and the chain
finetune -> build-index --weights -> pipeline through the port's CLI, all on
the CPU against the JAX package.

Tolerances: the loss and one step's gradients are held tightly (rtol 1e-5
on the loss, each gradient within 1e-5 of its largest value; measured 0 and
at most 1.2e-6).  After several Adam steps each weight's update is held
against JAX's at an atol of 5e-6 (the updates reach 3e-4; measured at most
6.3e-7 after 3 steps at lr 1e-4).  Adam moves each weight by about lr per
step whatever the size of its gradient, so a gradient near zero that the two
packages round differently can move a weight the other way, by up to 2 lr
per step.  Only the weights whose first JAX gradient is non-zero but within
1e-4 of its tensor's largest (4,349 of 612,736) are held at steps x 2 x lr
instead (measured at most 1.6e-5 there).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepreadmapper_tpu.io.fasta import extract_fasta_sequence
from deepreadmapper_tpu.models import encoder as jenc
from deepreadmapper_tpu.parallel import train as jtrain
from deepreadmapper_tpu.pipeline import finetune as jft
from deepreadmapper_tpu_torch import kernels
from deepreadmapper_tpu_torch.models import encoder as tenc
from deepreadmapper_tpu_torch.parallel import train as ttrain
from deepreadmapper_tpu_torch.pipeline import finetune as tft

LR = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two torch threads per test process: the suite runs in parallel
    processes, and the plain GRU's 123-step loops of small ops slow down
    badly when every process starts a thread per core."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def genome(data_dir):
    return extract_fasta_sequence(str(data_dir / "ecoli_150.fna"))


def _rel_err(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _jax_leaves(p):
    """EncoderParams (or grads of it) -> numpy arrays in the port's leaf order."""
    return ttrain.leaves(tenc.params_from_jax(p))


def test_loss_and_grad_match_jax(genome):
    """loss_fn and its gradient at T = 123, batch 16, the shipped weights,
    against jax.value_and_grad(train.loss_fn)."""
    rt, wt = tft.sample_pairs(genome, 150, 16, np.random.default_rng(11), sub_rate=0.05)
    jloss, jgrad = jax.value_and_grad(jtrain.loss_fn)(jenc.load_params(), rt, wt)
    params = tenc.torch_params(tenc.load_params(), requires_grad=True)
    before = kernels.GRU_BWD.launches
    loss = ttrain.loss_fn(params, torch.from_numpy(rt), torch.from_numpy(wt))
    loss.backward()
    assert kernels.GRU_BWD.launches == before  # CPU tensors: plain versions
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    for got, want in zip(ttrain.leaves(params), _jax_leaves(jgrad)):
        assert tuple(got.grad.shape) == tuple(want.shape)
        assert _rel_err(got.grad.numpy(), np.asarray(want)) <= 1e-5


@pytest.mark.parametrize("kw", [
    {"sub_rate": 0.05},
    {"sub_rate": 0.01, "max_shift": 3},
    {"sub_rate": 0.01, "indel_rate": 0.02},
], ids=["substitutions", "max_shift", "indel_rate"])
def test_sample_pairs_match_jax_bit_for_bit(genome, kw):
    """The same tokens, and the generator left at the same position."""
    jr, tr = np.random.default_rng(4), np.random.default_rng(4)
    for _ in range(2):
        jt = jft.sample_pairs(genome, 150, 64, jr, **kw)
        tt = tft.sample_pairs(genome, 150, 64, tr, **kw)
        for a, b in zip(tt, jt):
            assert a.dtype == b.dtype and a.shape == b.shape == (64, 123)
            np.testing.assert_array_equal(a, b)
    assert tr.bit_generator.state == jr.bit_generator.state
    assert np.any(tt[0] != tt[1])  # the noise reached the reads


def test_finetune_matches_jax(data_dir, genome):
    """Three steps at batch 16 from the shipped weights with the same seed:
    losses rtol 1e-4; each weight's update against JAX's at atol 5e-6, or
    3 x 2 x lr = 6e-4 where the first JAX gradient is near zero (module
    docstring)."""
    fna = str(data_dir / "ecoli_150.fna")
    steps = 3
    jparams, jlosses = jft.finetune(fna, 150, steps=steps, batch=16, lr=LR, seed=2)
    tparams, tlosses = tft.finetune(fna, 150, steps=steps, batch=16, lr=LR, seed=2,
                                    device="cpu")
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-4)
    # the first step's batch and JAX gradient, as finetune draws them
    rt, wt = jft.sample_pairs(genome, 150, 16, np.random.default_rng(2))
    jgrad = jax.grad(jtrain.loss_fn)(jenc.load_params(), rt, wt)
    start = tenc.load_params()
    moved, n_near, n_all = 0.0, 0, 0
    for got, ref, init, g in zip(ttrain.leaves(tparams), _jax_leaves(jparams),
                                 ttrain.leaves(start), _jax_leaves(jgrad)):
        ag = np.abs(g)
        near = (ag > 0) & (ag <= 1e-4 * ag.max())
        diff = np.abs((got - init) - (ref - init))
        assert diff[~near].max() <= 5e-6
        assert not near.any() or diff[near].max() <= steps * 2 * LR
        n_near, n_all = n_near + int(near.sum()), n_all + near.size
        moved = max(moved, float(np.abs(got - init).max()))
    assert n_near <= 0.01 * n_all  # only a few weights get the loose bound
    assert moved > 2 * LR  # the steps did move the weights


def test_exact_resume(data_dir, tmp_path):
    """Two 2-step runs through a state file equal one 4-step run: params,
    Adam moments and step, and the data generator all restored.  Held at
    the JAX package's own resume bounds (losses rtol 1e-5, weights atol
    1e-6): two identical 4-step runs on the CPU already differ by up to
    1.2e-7 (the CPU matmuls are not bit-reproducible from run to run)."""
    fna = str(data_dir / "ecoli_150.fna")
    state = str(tmp_path / "state")  # extensionless: .npz is added
    _, l1 = tft.finetune(fna, 150, steps=2, batch=8, seed=3, state_path=state,
                         device="cpu")
    p_split, l2 = tft.finetune(fna, 150, steps=2, batch=8, seed=3, state_path=state,
                               device="cpu")
    p_full, lf = tft.finetune(fna, 150, steps=4, batch=8, seed=3, device="cpu")
    assert os.path.exists(state + ".npz")
    np.testing.assert_allclose(l1 + l2, lf, rtol=1e-5)
    for a, b in zip(ttrain.leaves(p_split), ttrain.leaves(p_full)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)


def test_save_params_npz_read_by_both_packages(tmp_path):
    params = tenc.load_params()
    rng = np.random.default_rng(0)
    params["layers"][1]["bzr"] = params["layers"][1]["bzr"] + rng.standard_normal(
        params["layers"][1]["bzr"].shape).astype(np.float32)
    path = str(tmp_path / "tuned.npz")
    tft.save_params_npz(params, path)
    tl = tenc.load_params(path)
    jl = tenc.params_from_jax(jenc.load_params(path))
    for a, b, orig in zip(ttrain.leaves(tl), ttrain.leaves(jl), ttrain.leaves(params)):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, orig.astype(np.float16).astype(np.float32))
    # the JAX package's own writer gives the same file contents
    jpath = str(tmp_path / "jax.npz")
    jft.save_params_npz(jenc.load_params(path), jpath)
    with np.load(path) as t, np.load(jpath) as j:
        assert sorted(t.files) == sorted(j.files)
        for k in t.files:
            np.testing.assert_array_equal(t[k], j[k])


def test_finetune_build_weights_pipeline_cli(data_dir, tmp_path, capsys):
    """finetune -> build-index --weights -> pipeline through the port's CLI:
    the index records the weights, the pipeline loads them, its distances
    equal those of an explicit --weights and differ from the shipped
    encoder's; a vectorizer= that is not the weights= encoder raises."""
    from deepreadmapper_tpu_torch import cli
    from deepreadmapper_tpu_torch.pipeline import build

    fna = str(data_dir / "ecoli_150.fna")
    fq = str(data_dir / "test_data.fastq")
    dev = ["--device", "cpu"]
    tuned = str(tmp_path / "tuned.npz")
    assert cli.main(["finetune", fna, "150", "-o", tuned, "--steps", "2", "--batch", "8",
                     "--lr", "1e-3", "--state", str(tmp_path / "st.npz"), *dev]) == 0
    assert "[FINETUNE] 2 steps, loss" in capsys.readouterr().out
    idx = str(tmp_path / "idx")
    assert cli.main(["build-index", fna, idx, "150", "--weights", tuned, *dev]) == 0
    with open(os.path.join(idx, "config.txt")) as f:
        assert "encoder.npz" in f.read()
    dists = {}
    for tag, extra in (("auto", []), ("explicit", ["--weights", tuned]),
                       ("shipped", ["--weights", tenc.DEFAULT_NPZ])):
        out = str(tmp_path / tag)
        assert cli.main(["pipeline", idx, fq, fna, "128", "8", "5", out, "--no-sam",
                         *extra, *dev]) == 0
        printed = capsys.readouterr().out
        assert ("index-matched encoder weights" in printed) == (tag == "auto")
        dists[tag] = np.load(os.path.join(out, "distances.npy"))
    np.testing.assert_array_equal(dists["auto"], dists["explicit"])
    assert not np.allclose(dists["auto"], dists["shipped"])

    shipped = tenc.Vectorizer(device="cpu")
    with pytest.raises(ValueError, match="do not match"):
        build.build_index(fna, str(tmp_path / "bad"), 150, device="cpu",
                          weights=tuned, vectorizer=shipped)
    assert not os.path.exists(tmp_path / "bad")
    same = tenc.Vectorizer(tenc.load_params(tuned), device="cpu")
    assert build._resolve_weights(tuned, same, torch.device("cpu")) is same

