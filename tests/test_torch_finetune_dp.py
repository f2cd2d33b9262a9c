"""Data-parallel fine-tuning on the CPU: two gloo ranks in subprocesses
(``torch.distributed`` over tcp on a free local port), each training on its
half of the global batch, against the port's one-process ``finetune`` and
the JAX ``finetune`` on its 8-device CPU mesh and on a 2-device data mesh.

The fixture genome, batch 16, 3 steps and seed 2 are those of
``tests/test_torch_finetune.py::test_finetune_matches_jax``, and the
bounds are rule C7's (ROADMAP Queue C): losses at rtol 1e-4, each weight's
update at atol 5e-6, or steps x 2 x lr for weights whose first gradient
is non-zero but within 1e-4 of its tensor's largest (at most 1% of them).
One step's summed gradients are held within 1e-4 of each tensor's largest
one-process value, which a step that scaled the gradients by the world
size would miss by its whole size.

Every process here runs torch on one thread: the CPU kernels then give the
same bytes from run to run (on more threads a reduction's order varies by
~1e-7), so the ranks, the world-size-1 path and the resume are held bit
for bit.  Each subprocess has its own timeout."""

import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from deepreadmapper_tpu.models import encoder as jenc
from deepreadmapper_tpu.parallel import train as jtrain
from deepreadmapper_tpu.parallel.mesh import make_mesh
from deepreadmapper_tpu.pipeline import finetune as jft
from deepreadmapper_tpu_torch.io.fasta import extract_fasta_sequence
from deepreadmapper_tpu_torch.models import encoder as tenc
from deepreadmapper_tpu_torch.parallel import train as ttrain
from deepreadmapper_tpu_torch.pipeline import finetune as tft

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FNA = os.path.join(ROOT, "tests", "data", "ecoli_150.fna")
LR, STEPS, BATCH, SEED = 1e-4, 3, 16, 2
_TIMEOUT = 240  # seconds a rank may take, rendezvous included

_RANKS_BODY = r"""
import os
import sys

sys.path.insert(0, os.getcwd())
port, rank, work, fna = sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4]
import numpy as np
import torch

torch.set_num_threads(1)
from deepreadmapper_tpu_torch.io.fasta import extract_fasta_sequence
from deepreadmapper_tpu_torch.models import encoder as tenc
from deepreadmapper_tpu_torch.parallel import distributed as dist
from deepreadmapper_tpu_torch.parallel import train as ttrain
from deepreadmapper_tpu_torch.pipeline import finetune as tft

saves = []
save = tft.save_train_state


def counted_save(*a, **kw):
    saves.append(a[0])
    return save(*a, **kw)


tft.save_train_state = counted_save
dev = dist.init_distributed("gloo", device="cpu", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=2, rank=rank)
assert dist.world_size() == 2 and dist.rank() == rank

# the global batch of 16 split in two: 3 steps from the shipped weights
p, losses = tft.finetune(fna, 150, steps=3, batch=16, lr=1e-4, seed=2, device="cpu")
np.savez(os.path.join(work, f"run{rank}.npz"), np.asarray(losses), *ttrain.leaves(p))

# one step's gradients, summed over the ranks, on finetune's first batch
rt, wt = tft.sample_pairs(extract_fasta_sequence(fna), 150, 16, np.random.default_rng(2))
params = tenc.torch_params(tenc.load_params(), "cpu", requires_grad=True)
rows = slice(8 * rank, 8 * rank + 8)
loss = ttrain.loss_fn(params, torch.from_numpy(rt[rows]), torch.from_numpy(wt[rows]))
loss.backward()
grads = [q.grad for q in ttrain.leaves(params)]
dist.all_reduce_sum_(grads)
np.savez(os.path.join(work, f"grad{rank}.npz"), np.asarray(loss.item()), *grads)

try:
    tft.finetune(fna, 150, steps=1, batch=15, device="cpu")
except ValueError as e:
    assert "world size 2" in str(e), e
    print("INDIVISIBLE-RAISES", flush=True)

# --state resume: 2 + 2 steps through one state file against 4 straight
state = os.path.join(work, "state", "st.npz")
_, l1 = tft.finetune(fna, 150, steps=2, batch=8, seed=3, state_path=state, device="cpu")
p_split, l2 = tft.finetune(fna, 150, steps=2, batch=8, seed=3, state_path=state,
                           device="cpu")
p_full, lf = tft.finetune(fna, 150, steps=4, batch=8, seed=3, device="cpu")
np.savez(os.path.join(work, f"resume{rank}.npz"), np.asarray(l1 + l2), np.asarray(lf),
         *ttrain.leaves(p_split), *ttrain.leaves(p_full))
print(f"SAVES {len(saves)}", flush=True)
print(f"RANK{rank}-OK", flush=True)
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_two(cmds, envs) -> list[str]:
    """Start both ranks' commands together; each must exit 0 within
    _TIMEOUT.  Returns their outputs."""
    procs = [subprocess.Popen(c, cwd=ROOT, env=e, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c, e in zip(cmds, envs)]
    outs = []
    try:
        for r, p in enumerate(procs):
            out, _ = p.communicate(timeout=_TIMEOUT)
            assert p.returncode == 0, f"rank {r} failed:\n{out}"
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def _arrays(path: str) -> list[np.ndarray]:
    with np.load(path) as z:
        return [z[f"arr_{i}"] for i in range(len(z.files))]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The two ranks' run of _RANKS_BODY: {name: [rank 0's arrays, rank
    1's]}, the outputs and the work directory."""
    work = tmp_path_factory.mktemp("dp")
    child = work / "child.py"
    child.write_text(_RANKS_BODY)
    port = str(_free_port())
    env = dict(os.environ, OMP_NUM_THREADS="1")
    outs = _run_two([[sys.executable, str(child), port, str(r), str(work), FNA]
                     for r in range(2)], [env, env])
    for r, out in enumerate(outs):
        assert f"RANK{r}-OK" in out, out
    got = {name: [_arrays(str(work / f"{name}{r}.npz")) for r in range(2)]
           for name in ("run", "grad", "resume")}
    return got, outs, work


@pytest.fixture(scope="module")
def one_process():
    """The port's one-process run of the same steps, and its first step's
    gradient (the reference for C7's near-zero weights)."""
    p, losses = tft.finetune(FNA, 150, steps=STEPS, batch=BATCH, lr=LR, seed=SEED,
                             device="cpu")
    rt, wt = tft.sample_pairs(extract_fasta_sequence(FNA), 150, BATCH,
                              np.random.default_rng(SEED))
    params = tenc.torch_params(tenc.load_params(), "cpu", requires_grad=True)
    loss = ttrain.loss_fn(params, torch.from_numpy(rt), torch.from_numpy(wt))
    loss.backward()
    grads = [q.grad.numpy().copy() for q in ttrain.leaves(params)]
    return ttrain.leaves(p), losses, loss.item(), grads


def _hold_c7(got_leaves, want_leaves, grads):
    """Rule C7 on each weight's update after STEPS steps from the shipped
    weights; returns the largest update (the steps must move weights)."""
    start = ttrain.leaves(tenc.load_params())
    moved, n_near, n_all = 0.0, 0, 0
    for got, want, init, g in zip(got_leaves, want_leaves, start, grads):
        ag = np.abs(np.asarray(g))
        near = (ag > 0) & (ag <= 1e-4 * ag.max())
        diff = np.abs((got - init) - (np.asarray(want) - init))
        assert diff[~near].max() <= 5e-6
        assert not near.any() or diff[near].max() <= STEPS * 2 * LR
        n_near, n_all = n_near + int(near.sum()), n_all + near.size
        moved = max(moved, float(np.abs(got - init).max()))
    assert n_near <= 0.01 * n_all
    assert moved > 2 * LR


def test_two_ranks_match_one_process(ranks, one_process):
    """Two ranks at 8 rows each against one process at 16: the global
    losses at rtol 1e-4 and every update within C7."""
    got, _, _ = ranks
    run0 = got["run"][0]
    leaves, losses, _, grads = one_process
    np.testing.assert_allclose(run0[0], losses, rtol=1e-4)
    _hold_c7(run0[1:], leaves, grads)


@pytest.mark.parametrize("mesh", ["all8", "data2"])
def test_two_ranks_match_jax(ranks, one_process, mesh):
    """Against the JAX finetune with its batch sharded over conftest's 8
    CPU devices (its default mesh) and over a 2 x 1 data mesh, the JAX
    package's data parallelism: losses at rtol 1e-4, updates within C7
    (near-zero weights from the JAX first-step gradient)."""
    got, _, _ = ranks
    run0 = got["run"][0]
    jmesh = None if mesh == "all8" else make_mesh(n_data=2)
    if jmesh is None:
        assert len(jax.devices()) == 8
    jparams, jlosses = jft.finetune(FNA, 150, steps=STEPS, batch=BATCH, lr=LR, seed=SEED,
                                    mesh=jmesh)
    np.testing.assert_allclose(run0[0], jlosses, rtol=1e-4)
    rt, wt = jft.sample_pairs(extract_fasta_sequence(FNA), 150, BATCH,
                              np.random.default_rng(SEED))
    jgrad = jax.grad(jtrain.loss_fn)(jenc.load_params(), rt, wt)
    _hold_c7(run0[1:], ttrain.leaves(tenc.params_from_jax(jparams)),
             ttrain.leaves(tenc.params_from_jax(jgrad)))


def test_summed_gradients_match_one_process(ranks, one_process):
    """One step: each rank's backward of the global loss reaches only its
    own rows, and the all_reduce sums them to the one-process gradient,
    within 1e-4 of each tensor's largest value (a W-times gradient misses
    by the whole largest value); the global loss at rtol 1e-5."""
    got, _, _ = ranks
    g0 = got["grad"][0]
    _, _, loss, grads = one_process
    np.testing.assert_allclose(float(g0[0]), loss, rtol=1e-5)
    for mine, want in zip(g0[1:], grads):
        assert mine.shape == want.shape
        assert np.abs(mine - want).max() <= 1e-4 * np.abs(want).max()


def test_ranks_stay_byte_equal(ranks):
    """The same gradient bytes go into the same Adam on both ranks: the
    weights, the losses and the summed gradients are equal byte for byte."""
    got, _, _ = ranks
    for name in ("run", "grad", "resume"):
        a, b = got[name]
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), name


def _one_device_step(params, opt, rt, wt):
    """The one-device step written out: the whole batch's loss on its own
    embeddings, no gather and no gradient sum."""
    opt.zero_grad(set_to_none=True)
    re = tenc.encode_tokens_impl(params, rt)
    we = tenc.encode_tokens_impl(params, wt)
    re_n = re / (torch.linalg.vector_norm(re, dim=-1, keepdim=True) + 1e-6)
    we_n = we / (torch.linalg.vector_norm(we, dim=-1, keepdim=True) + 1e-6)
    logits = re_n @ we_n.T / 0.07
    nce = torch.nn.functional.cross_entropy(logits, torch.arange(logits.shape[0]))
    loss = nce + 0.1 * torch.mean(torch.sum((re - we) ** 2, dim=-1))
    loss.backward()
    opt.step()
    return loss.detach()


def test_world_size_one_is_train_step(tmp_path):
    """Without a process group the data-parallel train_step is the
    one-device step, and finetune trains each step on the whole batch,
    bit for bit."""
    from deepreadmapper_tpu_torch.parallel import distributed as dist

    assert dist.world_size() == 1
    genome = extract_fasta_sequence(FNA)
    rng = np.random.default_rng(4)
    batches = [tuple(map(torch.from_numpy, tft.sample_pairs(genome, 150, 8, rng)))
               for _ in range(2)]
    out = []
    for step in (ttrain.train_step, _one_device_step):
        params = tenc.torch_params(tenc.load_params(), "cpu", requires_grad=True)
        opt = ttrain.make_optimizer(params)
        losses = [step(params, opt, rt, wt).item() for rt, wt in batches]
        out.append((losses, [t.detach().numpy().copy() for t in ttrain.leaves(params)]))
    p, losses = tft.finetune(FNA, 150, steps=2, batch=8, seed=4, device="cpu")
    out.append((losses, ttrain.leaves(p)))
    (la, pa), *rest = out
    for lb, pb in rest:
        assert la == lb
        assert all(a.tobytes() == b.tobytes() for a, b in zip(pa, pb))


def test_indivisible_batch_raises(ranks):
    """A global batch of 15 over two ranks raises ValueError on both,
    before any step."""
    _, outs, _ = ranks
    assert all("INDIVISIBLE-RAISES" in out for out in outs)


def test_state_resume_under_two_ranks(ranks):
    """2 + 2 steps through a --state file equal 4 steps straight, bit for
    bit, on both ranks; rank 0 alone wrote the state (its two saves, none
    on rank 1: one file, no temporary left)."""
    got, outs, work = ranks
    assert "SAVES 2" in outs[0] and "SAVES 0" in outs[1]
    for r in range(2):
        res = got["resume"][r]
        n = (len(res) - 2) // 2
        assert res[0].tobytes() == res[1].tobytes()
        for a, b in zip(res[2:2 + n], res[2 + n:]):
            assert a.tobytes() == b.tobytes()
    assert sorted(os.listdir(work / "state")) == ["st.npz"]


def test_cli_finetune_distributed_two_ranks(ranks, tmp_path):
    """finetune --distributed --device cpu under two ranks (torchrun's
    environment set by hand), each given an -o of its own: one npz,
    written by rank 0, which alone prints the [FINETUNE] line; both
    packages' load_params read it, and it holds the API run's weights."""
    got, _, _ = ranks
    out = tmp_path / "out"
    out.mkdir()
    port = str(_free_port())
    envs = [dict(os.environ, OMP_NUM_THREADS="1", RANK=str(r), LOCAL_RANK=str(r),
                 WORLD_SIZE="2", MASTER_ADDR="127.0.0.1", MASTER_PORT=port)
            for r in range(2)]
    cmds = [[sys.executable, "-m", "deepreadmapper_tpu_torch.cli", "finetune", FNA, "150",
             "-o", str(out / f"tuned{r}.npz"), "--steps", str(STEPS), "--batch", str(BATCH),
             "--lr", str(LR), "--seed", str(SEED), "--distributed", "--device", "cpu"]
            for r in range(2)]
    outs = _run_two(cmds, envs)
    assert "[DIST] rank 0 of 2, backend gloo" in outs[0]
    assert "[DIST] rank 1 of 2, backend gloo" in outs[1]
    assert "[FINETUNE] 3 steps" in outs[0] and "[FINETUNE]" not in outs[1]
    assert os.listdir(out) == ["tuned0.npz"]
    npz = str(out / "tuned0.npz")
    api = str(tmp_path / "api.npz")
    tft.save_params_npz(tenc.params_from_named(dict(zip(
        [n for n, _ in tenc.named_leaves(tenc.load_params())], got["run"][0][1:]))), api)
    want = ttrain.leaves(tenc.load_params(api))
    for loaded in (tenc.load_params(npz), tenc.params_from_jax(jenc.load_params(npz))):
        for a, b in zip(ttrain.leaves(loaded), want):
            np.testing.assert_array_equal(a, b)
