"""The port's multi-process path on the CPU: two gloo ranks in subprocesses
(``torch.distributed`` over tcp on a free local port), mirroring the JAX
package's ``tests/test_distributed.py``: per-rank shard builds and a
cross-rank search, the FASTQ -> SAM pipeline, paired ends, and the serve
daemon.  Each answer must be byte-identical to the port's one-process run
on the same shards, and rank 1 must write no file.  Every subprocess has
its own timeout, so a hung rendezvous fails the test instead of the suite.

Last, ``build-index --shards 2`` -> ``pipeline`` through both packages'
CLIs on integer-valued embeddings (.npy reference and queries), where
indices.npy and distances.npy must be equal."""

import io
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from deepreadmapper_tpu_torch.parallel.mesh import make_mesh
from deepreadmapper_tpu_torch.parallel.sharded_ann import ShardedANNIndex
from jax_native_guard import _jax_native_loaded  # noqa: F401  (module fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FNA = os.path.join(ROOT, "tests", "data", "ecoli_150.fna")
FQ = os.path.join(ROOT, "tests", "data", "test_data.fastq")
_TIMEOUT = 240  # seconds a rank may take, rendezvous included

_PRELUDE = r"""
import os
import sys

sys.path.insert(0, os.getcwd())
port, rank, work = sys.argv[1], int(sys.argv[2]), sys.argv[3]
import numpy as np
import torch

torch.set_num_threads(2)
from deepreadmapper_tpu_torch.parallel import distributed as dist

dev = dist.init_distributed("gloo", device="cpu",
                            init_method=f"tcp://127.0.0.1:{port}",
                            world_size=2, rank=rank)
assert dist.world_size() == 2 and dist.rank() == rank and str(dev) == "cpu"
"""


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_ranks(tmp_path, body: str, work: str, *args: str) -> None:
    """Run PRELUDE + body as ranks 0 and 1 (argv: port, rank, work, *args);
    each must exit 0 and print RANK<r>-OK within _TIMEOUT."""
    child = tmp_path / "child.py"
    child.write_text(_PRELUDE + body + '\nprint(f"RANK{rank}-OK", flush=True)\n')
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="2")
    procs = [subprocess.Popen([sys.executable, str(child), str(port), str(r), work, *args],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    try:
        for r, p in enumerate(procs):
            out, _ = p.communicate(timeout=_TIMEOUT)
            assert p.returncode == 0 and f"RANK{r}-OK" in out, f"rank {r} failed:\n{out}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def _same_files(a: str, b: str, names):
    for name in names:
        with open(os.path.join(a, name), "rb") as f, open(os.path.join(b, name), "rb") as g:
            assert f.read() == g.read(), name


_SHARDS_BODY = r"""
from deepreadmapper_tpu_torch.config import BuildConfig
from deepreadmapper_tpu_torch.parallel.sharded_ann import ShardedANNIndex

X = np.random.default_rng(7).integers(-8, 9, (1001, 128)).astype(np.float32)
q = X[::50]
for kind, ef in (("INT8FLAT", 0), ("IVFINT8", 10**6), ("PQFLAT", 0), ("FLAT", 0),
                 ("HNSWFLAT", 32)):
    prefix = os.path.join(work, kind)
    mine = dist.build_own_shards(lambda s, e: X[s:e], len(X), 2, prefix,
                                 cfg=BuildConfig(nbits=4, kmeans_iters=5, m_hnsw=8,
                                                 efc=40),
                                 index_type=kind, device="cpu")
    assert mine == [rank], mine
    dist.barrier()
    idx = ShardedANNIndex.load_distributed(prefix, "cpu")
    assert idx._local_only and idx.shard_ids == [rank] and len(idx.subs) == 1
    ids, d = idx.search(q, 10, ef=ef)
    np.save(os.path.join(work, f"{kind}_ids{rank}.npy"), ids)
    np.save(os.path.join(work, f"{kind}_d{rank}.npy"), d)
"""


def test_two_rank_build_and_reload(tmp_path):
    """Each rank builds and saves ONLY its shard (rank 0 the manifest),
    loads only its shard and searches; the all_gather merge gives both
    ranks the one-process answer over the same shard files, for five
    engines (IVFINT8 at a full probe, exhaustive)."""
    work = str(tmp_path / "w")
    _run_ranks(tmp_path, _SHARDS_BODY, work)
    X = np.random.default_rng(7).integers(-8, 9, (1001, 128)).astype(np.float32)
    q = X[::50]
    for kind, ef in (("INT8FLAT", 0), ("IVFINT8", 10**6), ("PQFLAT", 0), ("FLAT", 0),
                     ("HNSWFLAT", 32)):
        prefix = os.path.join(work, kind)
        assert sorted(os.listdir(prefix)) == ["shard_0", "shard_1", "sharded.txt"]
        one = ShardedANNIndex.load(prefix, make_mesh(n_data=1, n_shard=2, devices=["cpu"]))
        ids, d = one.search(q, 10, ef=ef)
        for r in (0, 1):
            np.testing.assert_array_equal(np.load(os.path.join(work, f"{kind}_ids{r}.npy")), ids)
            np.testing.assert_array_equal(np.load(os.path.join(work, f"{kind}_d{r}.npy")), d)
        if kind in ("INT8FLAT", "IVFINT8", "FLAT"):
            assert (ids[:, 0] == np.arange(0, 1001, 50)).all(), (kind, ids[:, 0])


_PIPELINE_BODY = r"""
from deepreadmapper_tpu_torch.pipeline.build import build_index_distributed
from deepreadmapper_tpu_torch.pipeline.search import run_pipeline

fna, fq = sys.argv[4], sys.argv[5]
prefix = os.path.join(work, "idx")
build_index_distributed(fna, prefix, 150, index_type="INT8FLAT", n_shards=2,
                        device="cpu")
res = run_pipeline(prefix, fq, fna, ef=128, k=16,
                   output_dir=os.path.join(work, f"out{rank}"), device="cpu")
assert res["neighbors"].shape == (150, 16)
np.save(os.path.join(work, f"nb{rank}.npy"), res["neighbors"])
"""


def test_two_rank_pipeline_fastq_to_sam(tmp_path):
    """build_index_distributed (each rank embeds its half of the windows)
    -> run_pipeline on both ranks: rank 0's indices.npy, distances.npy and
    results.sam equal the one-process pipeline's over the same shards byte
    for byte; rank 1 holds the same neighbours and writes no file."""
    from deepreadmapper_tpu_torch.pipeline.search import run_pipeline

    work = str(tmp_path / "w")
    _run_ranks(tmp_path, _PIPELINE_BODY, work, FNA, FQ)
    prefix = os.path.join(work, "idx")
    with open(os.path.join(prefix, "sharded.txt")) as f:
        assert f.read() == "n_shard:2\nntotal:1702\ninner:INT8FLAT\n"
    ref = str(tmp_path / "ref")
    run_pipeline(prefix, FQ, FNA, ef=128, k=16, output_dir=ref, device="cpu")
    _same_files(os.path.join(work, "out0"), ref,
                ("indices.npy", "distances.npy", "results.sam"))
    assert os.listdir(os.path.join(work, "out1")) == []
    np.testing.assert_array_equal(np.load(os.path.join(work, "nb1.npy")),
                                  np.load(os.path.join(ref, "indices.npy")))


_PAIRED_BODY = r"""
from deepreadmapper_tpu_torch.pipeline.build import build_index_distributed
from deepreadmapper_tpu_torch.pipeline.search import run_pipeline_paired

fna, f1, f2 = sys.argv[4], sys.argv[5], sys.argv[6]
prefix = os.path.join(work, "idx")
build_index_distributed(fna, prefix, 150, index_type="INT8FLAT", n_shards=2,
                        device="cpu")
res = run_pipeline_paired(prefix, f1, f2, fna, k=8,
                          output_dir=os.path.join(work, f"out{rank}"), device="cpu")
assert res["n_proper"] == 8, res["n_proper"]
"""


def test_two_rank_paired_pipeline(tmp_path):
    """Paired ends across two ranks (JAX test's 8 FR pairs from the
    fixture genome): every pair proper, rank 0's outputs equal the
    one-process run's byte for byte, rank 1 writes nothing."""
    from deepreadmapper_tpu_torch.io import fasta as fasta_io
    from deepreadmapper_tpu_torch.pipeline.search import run_pipeline_paired

    genome = fasta_io.parse_fasta_records(FNA)[0].tobytes().decode()
    comp = str.maketrans("ACGT", "TGCA")
    f1, f2 = str(tmp_path / "r1.fastq"), str(tmp_path / "r2.fastq")
    with open(f1, "w") as a, open(f2, "w") as b:
        for i, s in enumerate([0, 50, 100, 150, 200, 250, 300, 400]):
            a.write(f"@p{i}\n{genome[s:s + 150]}\n+\n{'I' * 150}\n")
            m = genome[s + 400 - 150:s + 400].translate(comp)[::-1]
            b.write(f"@p{i}\n{m}\n+\n{'I' * 150}\n")
    work = str(tmp_path / "w")
    _run_ranks(tmp_path, _PAIRED_BODY, work, FNA, f1, f2)
    ref = str(tmp_path / "ref")
    res = run_pipeline_paired(os.path.join(work, "idx"), f1, f2, FNA, k=8,
                              output_dir=ref, device="cpu")
    assert res["n_proper"] == 8
    _same_files(os.path.join(work, "out0"), ref,
                ("indices.npy", "distances.npy", "results.sam"))
    assert os.listdir(os.path.join(work, "out1")) == []
    sam = [ln.split("\t") for ln in open(os.path.join(ref, "results.sam"))
           if not ln.startswith("@")]
    prim = [f for f in sam if int(f[1]) & 0x900 == 0]
    assert len(prim) == 16 and all(int(f[1]) & 0x2 for f in prim)


_SERVE_BODY = r"""
import io
import json

from deepreadmapper_tpu_torch.pipeline.build import build_index_distributed
from deepreadmapper_tpu_torch.pipeline.serve import serve

fna, fq = sys.argv[4], sys.argv[5]
prefix = os.path.join(work, "idx")
build_index_distributed(fna, prefix, 150, index_type="INT8FLAT", n_shards=2,
                        device="cpu")
reqs = "".join(json.dumps(r) + "\n" for r in [
    {"id": "r1", "fastq": fq, "output_dir": os.path.join(work, f"a{rank}"), "k": 8},
    {"id": "r2", "fastq": fq, "output_dir": os.path.join(work, f"b{rank}"), "k": 4,
     "write_sam": False},
    {"cmd": "quit"},
])
out = io.StringIO()
n = serve(prefix, fna, in_stream=io.StringIO(reqs), out_stream=out, device="cpu")
lines = [json.loads(ln) for ln in out.getvalue().splitlines()]
assert n == 2 and lines[0]["ready"] and lines[1]["ok"] and lines[2]["ok"], lines
assert lines[1]["num_queries"] == 150 and lines[3]["quit"]
"""


def test_two_rank_serve_daemon(tmp_path):
    """One daemon per rank on the same request stream: every request runs
    the sharded search across both ranks; rank 0's outputs equal a
    one-process daemon's byte for byte, rank 1 writes nothing, and the
    write_sam=False request writes npy only."""
    from deepreadmapper_tpu_torch.pipeline.serve import serve

    work = str(tmp_path / "w")
    _run_ranks(tmp_path, _SERVE_BODY, work, FNA, FQ)
    ref_a, ref_b = str(tmp_path / "ra"), str(tmp_path / "rb")
    reqs = "".join(json.dumps(r) + "\n" for r in [
        {"fastq": FQ, "output_dir": ref_a, "k": 8},
        {"fastq": FQ, "output_dir": ref_b, "k": 4, "write_sam": False},
        {"cmd": "quit"},
    ])
    assert serve(os.path.join(work, "idx"), FNA, in_stream=io.StringIO(reqs),
                 out_stream=io.StringIO(), device="cpu") == 2
    _same_files(os.path.join(work, "a0"), ref_a,
                ("indices.npy", "distances.npy", "results.sam"))
    _same_files(os.path.join(work, "b0"), ref_b, ("indices.npy", "distances.npy"))
    assert np.load(os.path.join(ref_a, "indices.npy")).shape == (150, 8)
    assert not os.path.exists(os.path.join(work, "b0", "results.sam"))
    assert os.listdir(os.path.join(work, "a1")) == os.listdir(os.path.join(work, "b1")) == []


@pytest.mark.parametrize("kind", ["INT8FLAT", "FLAT", "IVFINT8"])
def test_sharded_cli_matches_jax_cli(kind, tmp_path, monkeypatch):
    """build-index --shards 2 -> pipeline through both CLIs on integer-
    valued embeddings (1,001 reference rows: a padded boundary shard; 40
    queries): indices.npy and distances.npy equal.  The JAX registry lays
    its mesh over conftest's 8 CPU devices (4 data rows), the port over the
    one CPU device (1): the answers do not depend on it here.  The JAX IVF
    kernels run in interpret mode."""
    from deepreadmapper_tpu import cli as jcli
    from deepreadmapper_tpu.ops import ivf_kernel as jik
    from deepreadmapper_tpu_torch import cli as tcli

    monkeypatch.setattr(jik, "INTERPRET", True)
    rng = np.random.default_rng(17)
    x = rng.integers(-8, 9, (1001, 128)).astype(np.float32)
    q = np.clip(x[::25] + rng.integers(-1, 2, (41, 128)), -8, 8).astype(np.float32)
    ref, qry = str(tmp_path / "ref.npy"), str(tmp_path / "q.npy")
    np.save(ref, x)
    np.save(qry, q)
    out = {}
    for tag, cli, dev in (("jax", jcli, ()), ("torch", tcli, ("--device", "cpu"))):
        idx, res = str(tmp_path / f"{tag}_idx"), str(tmp_path / f"{tag}_out")
        assert cli.main(["build-index", ref, idx, "150", "--index-type", kind,
                         "--shards", "2", *dev]) == 0
        assert cli.main(["pipeline", idx, qry, FNA, "8", "10", "10", res, *dev]) == 0
        out[tag] = [np.load(os.path.join(res, f)) for f in ("indices.npy", "distances.npy")]
    assert os.path.exists(tmp_path / "torch_idx" / "shard_1")
    np.testing.assert_array_equal(out["torch"][0], out["jax"][0])
    np.testing.assert_array_equal(out["torch"][1], out["jax"][1])
    assert out["torch"][0].shape == (41, 10)
    assert (out["torch"][0][:, 0] != -1).all()


def test_sharded_fixture_cli_matches_jax_cli(tmp_path):
    """build-index --shards 2 -> pipeline on the fixture through both CLIs.
    The two encoders embed with fp32 noise (rule C2), so this is held as
    tests/test_torch_pipeline.py::test_slice_matches_jax_cli holds the
    unsharded slice: truth hits within 1, top-1 equal wherever the JAX
    result is no tie, every candidate within the JAX k-th distance."""
    from deepreadmapper_tpu import cli as jcli
    from deepreadmapper_tpu.io import fastq
    from deepreadmapper_tpu_torch import cli as tcli

    out = {}
    for tag, cli, dev in (("jax", jcli, ()), ("torch", tcli, ("--device", "cpu"))):
        idx, res = str(tmp_path / f"{tag}_idx"), str(tmp_path / f"{tag}_out")
        assert cli.main(["build-index", FNA, idx, "150", "--shards", "2", *dev]) == 0
        assert cli.main(["pipeline", idx, FQ, FNA, "128", "16", "5", res, *dev]) == 0
        out[tag] = [np.load(os.path.join(res, f)) for f in ("indices.npy", "distances.npy")]
    (ji, jd), (ti, td) = out["jax"], out["torch"]
    assert ti.shape == ji.shape == (150, 16)
    _, names = fastq.parse_fastq(FQ)
    truth = np.array([int(n.split("_")[1]) - 1 for n in names])

    def hits(ids):
        return int(np.sum(np.any(np.abs(ids.astype(np.int64) // 2 - truth[:, None]) <= 2, 1)))

    assert hits(ti) >= 135 and abs(hits(ti) - hits(ji)) <= 1, (hits(ti), hits(ji))
    clear = jd[:, 0] != jd[:, 1]
    np.testing.assert_array_equal(ti[clear, 0], ji[clear, 0])
    assert np.mean(td <= jd[:, -1:] * (1 + 1e-6)) == 1.0
