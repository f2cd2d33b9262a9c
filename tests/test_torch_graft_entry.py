"""The port's twin of ``__graft_entry__.py`` (``deepreadmapper_tpu_torch/graft_entry.py``)
against ``__graft_entry__.py`` on the CPU.

``entry()``'s forward is the encoder: rule C2 holds it to the JAX forward
on the same tokens at fp32 tolerance, rtol 1e-4 and atol 1e-5 (the GRU's
sums run in another order).  ``dryrun_multichip(n)`` applies the JAX dry
run's asserts itself; its training loss is held to the JAX training step's
on the same 4 n reads and windows at rtol 1e-4 (rule C7)."""

import numpy as np
import pytest
import torch

from deepreadmapper_tpu_torch import graft_entry


@pytest.fixture(autouse=True, scope="module")
def _threads():
    """One torch and one BLAS thread per test process: the suite runs in
    parallel processes, and the dry run's many small builds slow down
    badly when every process starts a thread per core."""
    from threadpoolctl import threadpool_limits

    before = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):
        yield
    torch.set_num_threads(before)


@pytest.fixture
def small_builds(monkeypatch):
    """The dry run's engines with fewer training rounds (k-means 4, OPQ 2,
    efConstruction 40): its asserts compare each engine with oracles built
    from the same engine, so the rounds change no assert, only the time."""
    import functools

    from deepreadmapper_tpu_torch import config

    monkeypatch.setattr(config, "BuildConfig", functools.partial(
        config.BuildConfig, kmeans_iters=4, opq_iters=2, efc=40))


def test_entry_forward_matches_jax():
    import __graft_entry__ as jge

    fwd, (tokens,) = graft_entry.entry(device="cpu")
    jfwd, (jtokens,) = jge.entry()
    assert tokens.dtype == torch.int32 and tokens.device.type == "cpu"
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(jtokens))
    got = fwd(tokens)
    assert got.shape == (256, 128) and got.dtype == torch.float32
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), np.asarray(jfwd(jtokens)), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("n,n_shard", [(2, 2), (4, 4)])
def test_dryrun_multichip_on_the_cpu(n, n_shard, capsys, small_builds):
    """The dry run's asserts pass at n 2 and 4, every shard on the CPU;
    its readings and summary line are the JAX function's."""
    got = graft_entry.dryrun_multichip(n, device="cpu")
    assert (got["n_data"], got["n_shard"], got["devices"]) == (1, n_shard, ["cpu"])
    assert np.isfinite(got["loss"]) and got["hits"] >= 135 and got["n_proper"] == 4
    assert min(got[k] for k in ("int8_top1", "ivfint8_top1", "ivfpq_top1",
                                "pqflat_opq_top1", "pqflat_opq_overlap")) >= 0.9
    out = capsys.readouterr().out
    assert f"dryrun_multichip({n}): mesh data=1 x shard={n_shard}; train loss" in out
    assert f"{got['hits']}/150 truth hits" in out


@pytest.mark.parametrize("n", [3, 6, 16])
def test_shard_count_matches_jax_rule(n):
    """8, then 4, then 2, then 1 shards, as the JAX dry run picks them."""
    want = 8 if n % 8 == 0 else 4 if n % 4 == 0 else 2 if n % 2 == 0 else 1
    assert graft_entry._shard_count(n) == want


def test_dryrun_loss_matches_jax_step():
    """The n = 4 dry run's loss against the JAX training step on the JAX
    dry run's 1 x 4 mesh, on the same rng(0) reads and windows."""
    import jax.numpy as jnp

    from deepreadmapper_tpu.models.encoder import load_params
    from deepreadmapper_tpu.parallel.mesh import make_mesh
    from deepreadmapper_tpu.parallel.train import make_optimizer, make_train_step

    rng = np.random.default_rng(0)
    reads = jnp.asarray(rng.integers(7542, 7638, size=(16, 123)).astype(np.int32))
    wins = jnp.asarray(rng.integers(7542, 7638, size=(16, 123)).astype(np.int32))
    params = load_params()
    opt = make_optimizer()
    step = make_train_step(opt, make_mesh(n_data=1, n_shard=4))
    _, _, jloss = step(params, opt.init(params), reads, wins)
    got = graft_entry._train_step(4, torch.device("cpu"), np.random.default_rng(0))
    np.testing.assert_allclose(got, float(jloss), rtol=1e-4)


def test_entry_and_dryrun_need_a_card_unless_asked(monkeypatch):
    """Without device= both raise when no card is visible."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.dryrun_multichip(2)
