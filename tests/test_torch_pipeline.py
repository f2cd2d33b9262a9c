"""The whole slice on the fixture: the port's CLI (build-index -> pipeline)
against the JAX package's CLI, and the port's freedom from jax."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from deepreadmapper_tpu.io import fastq
from jax_native_guard import _jax_native_loaded  # noqa: F401  (module fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two torch threads per test process: the suite runs in parallel
    processes, and the plain GRU's 123-step loop of small ops slows down
    badly when every process starts a thread per core."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _truth_hits(indices, names, slack=2):
    hits = 0
    for row, name in zip(indices.astype(np.int64), names):
        pos = int(name.split("_")[1]) - 1
        hits += bool(np.any(np.abs(row // 2 - pos) <= slack))
    return hits


def _run_both(data_dir, tmp_path, build_extra=(), pipe_extra=(),
              pipe_args=("128", "128", "5")):
    from deepreadmapper_tpu import cli as jcli
    from deepreadmapper_tpu_torch import cli as tcli

    fna = str(data_dir / "ecoli_150.fna")
    fq = str(data_dir / "test_data.fastq")
    out = {}
    for tag, cli, dev in (("jax", jcli, ()), ("torch", tcli, ("--device", "cpu"))):
        idx, res = str(tmp_path / f"{tag}_idx"), str(tmp_path / f"{tag}_out")
        assert cli.main(["build-index", fna, idx, "150", *build_extra, *dev]) == 0
        assert cli.main(["pipeline", idx, fq, fna, *pipe_args, res,
                         *pipe_extra, *dev]) == 0
        out[tag] = (np.load(os.path.join(res, "indices.npy")).astype(np.int64),
                    np.load(os.path.join(res, "distances.npy")),
                    res)
    _, names = fastq.parse_fastq(fq)
    return out, names


def test_slice_matches_jax_cli(data_dir, tmp_path):
    out, names = _run_both(data_dir, tmp_path)
    (ji, jd, jres), (ti, td, tres) = out["jax"], out["torch"]
    assert ti.shape == ji.shape == (150, 128)
    assert td.dtype == jd.dtype == np.float32
    hj, ht = _truth_hits(ji, names), _truth_hits(ti, names)
    assert ht >= 135 and abs(ht - hj) <= 1, (ht, hj)
    # top-1 agrees wherever the JAX result is not a tie at the top
    clear = jd[:, 0] != jd[:, 1]
    np.testing.assert_array_equal(ti[clear, 0], ji[clear, 0])
    # tie-aware recall@128: every returned candidate is within the JAX
    # k-th distance (int8 scores tie in classes; set overlap is not a test)
    assert np.mean(td <= jd[:, -1:] * (1 + 1e-6)) == 1.0
    with open(os.path.join(tres, "results.sam")) as f:
        sam = [ln for ln in f if not ln.startswith("@")]
    assert len(sam) == 150 * 128


def test_dense_rerank_matches_jax_cli(data_dir, tmp_path):
    out, _ = _run_both(data_dir, tmp_path, ("--index-type", "FLAT"),
                       ("--dense-rerank",))
    (ji, jd, _), (ti, td, _) = out["jax"], out["torch"]
    np.testing.assert_allclose(td, jd, rtol=1e-4, atol=1e-4)
    gap = np.diff(jd, axis=1) > 1e-4  # order is decided where neighbours differ
    clear = np.concatenate([gap[:, :1], gap[:, :-1] & gap[:, 1:], gap[:, -1:]], 1)
    np.testing.assert_array_equal(ti[clear], ji[clear])


def test_port_cli_never_imports_jax(data_dir, tmp_path):
    """build-index -> pipeline through the port's CLI in a fresh process
    (INT8FLAT, PQFLAT + OPQ with the SW rerank, IVFINT8, finetune ->
    build-index --weights -> pipeline, the SAM options, inference,
    --paired2, --long-reads --cigar, HNSWPQ at stride 4, HNSWFLAT
    --build-mode knn --level-mode centroid, IVFINT8 --shards 2, info,
    finetune --distributed in one process under utils.trace's stage and
    device_trace, graft_entry's entry) with graft_entry's dry run's modules,
    serve, bench, io.bam, io.npy_stream, ops.pack,
    models.ir_loader, io.idmap and utils.logging imported, then assert that
    neither jax nor any module of the JAX package was imported."""
    code = (
        "import sys\n"
        "from deepreadmapper_tpu_torch import cli\n"
        f"fna, fq, d = {str(data_dir / 'ecoli_150.fna')!r}, "
        f"{str(data_dir / 'test_data.fastq')!r}, {str(tmp_path)!r}\n"
        "dev = ['--device', 'cpu']\n"
        "assert cli.main(['build-index', fna, d + '/idx', '150', *dev]) == 0\n"
        "assert cli.main(['pipeline', d + '/idx', fq, fna, '128', '128', '5',"
        " d + '/out', *dev]) == 0\n"
        "assert cli.main(['build-index', fna, d + '/pq', '150', '--index-type',"
        " 'PQFLAT', '--opq', *dev]) == 0\n"
        "assert cli.main(['pipeline', d + '/pq', fq, fna, '128', '10', '128',"
        " d + '/pq_out', '--rerank', 'sw', *dev]) == 0\n"
        "assert cli.main(['build-index', fna, d + '/ivf', '150', '--index-type',"
        " 'IVFINT8', *dev]) == 0\n"
        "assert cli.main(['pipeline', d + '/ivf', fq, fna, '32', '16', '16',"
        " d + '/ivf_out', *dev]) == 0\n"
        "assert cli.main(['finetune', fna, '150', '-o', d + '/tuned.npz', '--steps', '1',"
        " '--batch', '4', *dev]) == 0\n"
        "assert cli.main(['build-index', fna, d + '/tidx', '150', '--weights',"
        " d + '/tuned.npz', *dev]) == 0\n"
        "assert cli.main(['pipeline', d + '/tidx', fq, fna, '128', '8', '5',"
        " d + '/tuned_out', '--no-sam', *dev]) == 0\n"
        "import deepreadmapper_tpu_torch.bench, deepreadmapper_tpu_torch.io.bam\n"
        "import deepreadmapper_tpu_torch.io.npy_stream, deepreadmapper_tpu_torch.ops.pack\n"
        "import deepreadmapper_tpu_torch.pipeline.serve\n"
        "import deepreadmapper_tpu_torch.models.ir_loader, deepreadmapper_tpu_torch.io.idmap\n"
        "import deepreadmapper_tpu_torch.utils.logging\n"
        "from deepreadmapper_tpu_torch.utils.trace import device_trace, stage\n"
        "with stage('finetune'), device_trace(d + '/ft_prof', cuda=False):\n"
        "    assert cli.main(['finetune', fna, '150', '-o', d + '/tuned_dp.npz', '--steps',"
        " '1', '--batch', '4', '--distributed', *dev]) == 0\n"
        "assert cli.main(['pipeline', d + '/idx', fq, fna, '128', '8', '5', d + '/sam_out',"
        " '--mapq', '--cigar', '--qual', '--sort', '--bam', '--mark-duplicates', *dev]) == 0\n"
        "assert cli.main(['inference', fq, '150', d + '/emb.npy', *dev]) == 0\n"
        "assert cli.main(['pipeline', d + '/idx', fq, fna, '128', '4', '5', d + '/pe_out',"
        " '--paired2', fq, '--mapq', *dev]) == 0\n"
        "assert cli.main(['pipeline', d + '/idx', fq, fna, '128', '4', '5', d + '/lr_out',"
        " '--long-reads', '--cigar', *dev]) == 0\n"
        "assert cli.main(['build-index', fna, d + '/hpq', '150', '4', '--index-type',"
        " 'HNSWPQ', *dev]) == 0\n"
        "assert cli.main(['pipeline', d + '/hpq', fq, fna, '64', '10', '5', d + '/hpq_out',"
        " *dev]) == 0\n"
        "assert cli.main(['build-index', fna, d + '/hflat', '150', '--index-type', 'HNSWFLAT',"
        " '--build-mode', 'knn', '--level-mode', 'centroid', *dev]) == 0\n"
        "assert cli.main(['pipeline', d + '/hflat', fq, fna, '64', '16', '5', d + '/hflat_out',"
        " '--no-sam', *dev]) == 0\n"
        "assert cli.main(['build-index', fna, d + '/sh', '150', '--shards', '2',"
        " '--index-type', 'IVFINT8', *dev]) == 0\n"
        "assert cli.main(['pipeline', d + '/sh', fq, fna, '16', '8', '5', d + '/sh_out',"
        " *dev]) == 0\n"
        "assert cli.main(['info', d + '/idx']) == 0\n"
        "from deepreadmapper_tpu_torch import graft_entry\n"
        "fwd, (tok,) = graft_entry.entry(device='cpu')\n"
        "assert tuple(fwd(tok).shape) == (256, 128)\n"
        "import deepreadmapper_tpu_torch.parallel.sharded_search\n"
        "import deepreadmapper_tpu_torch.parallel.train, deepreadmapper_tpu_torch.ops.topk\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "bad = sorted(m for m in sys.modules if m == 'deepreadmapper_tpu'"
        " or m.startswith('deepreadmapper_tpu.'))\n"
        "assert not bad, f'the JAX package was imported: {bad}'\n"
        "print('NO-JAX-OK')\n"
    )
    env = dict(os.environ, OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "NO-JAX-OK" in proc.stdout
    assert os.path.exists(tmp_path / "out" / "indices.npy")
    assert os.path.exists(tmp_path / "pq_out" / "results.sam")
    assert os.path.exists(tmp_path / "ivf_out" / "indices.npy")
    assert os.path.exists(tmp_path / "tidx" / "encoder.npz")
    assert os.path.exists(tmp_path / "tuned_out" / "indices.npy")
    assert os.path.exists(tmp_path / "tuned_dp.npz")
    assert os.path.exists(tmp_path / "ft_prof" / "device.pt.trace.json")
    assert os.path.exists(tmp_path / "sam_out" / "results.bam")
    assert os.path.exists(tmp_path / "emb.npy")
    assert os.path.exists(tmp_path / "pe_out" / "results.sam")
    assert os.path.exists(tmp_path / "lr_out" / "results.sam")
    assert os.path.exists(tmp_path / "hpq_out" / "results.sam")
    assert os.path.exists(tmp_path / "hflat_out" / "indices.npy")
    assert os.path.exists(tmp_path / "sh" / "shard_1" / "ivf_int8.npz")
    assert os.path.exists(tmp_path / "sh_out" / "results.sam")


@pytest.mark.parametrize("cmd", ["build-index", "pipeline", "finetune", "inference",
                                 "serve"])
def test_cli_without_a_card_fails_and_writes_nothing(data_dir, tmp_path, cmd):
    """Without --device cpu and with no CUDA device visible, each command
    exits with status 2 and the device error, and writes no output."""
    fna = str(data_dir / "ecoli_150.fna")
    fq = str(data_dir / "test_data.fastq")
    out = tmp_path / "out"
    argv = {"build-index": ["build-index", fna, str(out), "150"],
            "pipeline": ["pipeline", str(tmp_path / "idx"), fq, fna, "128", "128", "5",
                         str(out)],
            "finetune": ["finetune", fna, "150", "-o", str(out)],
            "inference": ["inference", fq, "150", str(out)],
            "serve": ["serve", str(tmp_path / "idx"), fna]}[cmd]
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-m", "deepreadmapper_tpu_torch", *argv],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 2
    assert "no CUDA device is visible" in proc.stderr
    assert "--device cpu" in proc.stderr
    assert not out.exists() and proc.stdout == ""


def _sam_ids(res, n_reads, k):
    """Window ids (2*pos | strand, -1 unmapped) of each read's SAM records
    in order, [n_reads, k] padded with -1, and the record count per read."""
    groups, prev = [], None
    with open(os.path.join(res, "results.sam")) as f:
        for ln in f:
            if ln.startswith("@"):
                continue
            rec = ln.split("\t")
            if rec[0] != prev:
                groups.append([])
                prev = rec[0]
            flag = int(rec[1])
            groups[-1].append(-1 if flag & 4 else 2 * (int(rec[3]) - 1) + bool(flag & 16))
    assert len(groups) == n_reads
    ids = np.full((n_reads, k), -1, np.int64)
    for i, g in enumerate(groups):
        ids[i, : len(g)] = g
    return ids, np.array([len(g) for g in groups])


@pytest.mark.parametrize("build_extra,pipe_args", [
    (("1", "--index-type", "PQFLAT"), ("128", "10", "128")),
    (("4", "--index-type", "PQFLAT"), ("128", "10", "5")),
])
def test_pqflat_sw_rerank_matches_jax_cli(data_dir, tmp_path, build_extra, pipe_args):
    """build-index PQFLAT -> pipeline --rerank sw through both CLIs, dense
    and sparse: truth hits within one, the same SAM records per read, and
    the same primary wherever the JAX package's top SW score is not tied.

    Reads whose candidates include invalid (clipped) slots are the
    exception: the JAX package sorts those slots first (an int32 overflow,
    ROADMAP Queue C), writes them as an unmapped primary and drops them as
    secondaries, so it has fewer records there; the port ranks them last."""
    from deepreadmapper_tpu.io import fasta as fasta_io
    from deepreadmapper_tpu.ops import sw as jsw
    from deepreadmapper_tpu.tokenizer import strings_to_bytes

    out, names = _run_both(data_dir, tmp_path, build_extra, ("--rerank", "sw"),
                           pipe_args)
    k = int(pipe_args[1])
    jids, jcount = _sam_ids(out["jax"][2], 150, k)
    tids, tcount = _sam_ids(out["torch"][2], 150, k)
    assert (tcount == k).all() and (tids >= 0).all()
    affected = jcount != k
    assert affected.sum() <= (0 if build_extra[0] == "1" else 5), affected.sum()
    pos = np.array([int(nm.split("_")[1]) - 1 for nm in names])

    def hits(ids):
        return int(np.sum(np.any((ids >= 0) & (np.abs((ids >> 1) - pos[:, None]) <= 2),
                                 axis=1)))

    hj, ht = hits(jids), hits(tids)
    assert ht >= 135 and abs(ht - hj) <= 1, (ht, hj)
    # ties at the top: the JAX package's first two records scored again
    genome = fasta_io.parse_fasta_records(str(data_dir / "ecoli_150.fna"))[0]
    seqs, _ = fastq.parse_fastq(str(data_dir / "test_data.fastq"))
    top2 = np.maximum(jids[:, :2], 0).ravel()
    a_mat, a_lens = fasta_io.fetch_windows_by_id(genome, top2, 150, max_len=150)
    b_mat, b_lens = strings_to_bytes(["<" + s + ">" for s in seqs for _ in range(2)])
    sc = jsw.sw_scores(np.ascontiguousarray(a_mat), a_lens, b_mat, b_lens).reshape(150, 2)
    clear = ~affected & (sc[:, 0] != sc[:, 1])
    assert clear.sum() >= 100
    np.testing.assert_array_equal(tids[clear, 0], jids[clear, 0])


@pytest.mark.parametrize("stride", ["1", "4"])
def test_hnswpq_pipeline_matches_jax_cli(data_dir, tmp_path, stride):
    """build-index --index-type HNSWPQ -> pipeline through both CLIs, dense
    and sparse (stride 4: the re-embed + L2 rerank of k_clusters 5 hits).
    Each package builds its own graph, and the native builder inserts in
    parallel above 1,024 rows, so the graphs differ a little from run to
    run: per read, the SAM primary and whether the read's true position is
    among its records agree on at least 97% of the reads (measured: all
    150), and the truth hits are within two."""
    out, names = _run_both(data_dir, tmp_path, (stride, "--index-type", "HNSWPQ"),
                           pipe_args=("128", "10", "5"))
    (ji, jd, jres), (ti, td, tres) = out["jax"], out["torch"]
    assert ti.shape == ji.shape == (150, 10 if stride == "1" else 5)
    assert td.dtype == jd.dtype == np.float32
    jids, _ = _sam_ids(jres, 150, 10)
    tids, tcount = _sam_ids(tres, 150, 10)
    assert (tcount == 10).all()
    pos = np.array([int(nm.split("_")[1]) - 1 for nm in names])
    jhit = np.any((jids >= 0) & (np.abs((jids >> 1) - pos[:, None]) <= 2), axis=1)
    thit = np.any((tids >= 0) & (np.abs((tids >> 1) - pos[:, None]) <= 2), axis=1)
    floor = 135 if stride == "1" else 130  # measured: 141 and 134 in both packages
    assert thit.sum() >= floor and abs(int(thit.sum()) - int(jhit.sum())) <= 2
    assert (thit == jhit).mean() >= 0.97
    assert (tids[:, 0] == jids[:, 0]).mean() >= 0.97


# The JAX CLI in a fresh process, its IVF scans in Pallas interpret mode.
_JAX_CLI_INTERPRET = (
    "import sys\n"
    "import jax\n"
    "jax.config.update('jax_platforms', 'cpu')\n"
    "from deepreadmapper_tpu.ops import ivf_kernel as ik\n"
    "ik.INTERPRET = True\n"
    "from deepreadmapper_tpu import cli\n"
    "raise SystemExit(cli.main(sys.argv[1:]))\n"
)


@pytest.mark.parametrize("index_type,build_extra", [("IVFINT8", ()), ("IVFPQ", ("--opq",))])
def test_ivf_pipeline_matches_jax_cli_on_one_index(data_dir, tmp_path, index_type,
                                                   build_extra):
    """build-index through the port's CLI; pipeline through both CLIs on that
    saved index and the same query embeddings (the port's encoder, saved as
    .npy, so both search identical queries).  indices.npy and distances.npy
    are equal.  From the FASTQ the port's pipeline finds the reads and hands
    back the engine's search-effort counters."""
    from deepreadmapper_tpu_torch import cli as tcli
    from deepreadmapper_tpu_torch.io.fastq import parse_fastq_bytes
    from deepreadmapper_tpu_torch.models.encoder import Vectorizer
    from deepreadmapper_tpu_torch.pipeline.search import run_pipeline

    fna = str(data_dir / "ecoli_150.fna")
    fq = str(data_dir / "test_data.fastq")
    idx = str(tmp_path / "idx")
    assert tcli.main(["build-index", fna, idx, "150", "--index-type", index_type,
                      *build_extra, "--device", "cpu"]) == 0
    mat, lengths, _ = parse_fastq_bytes(fq)
    qfile = str(tmp_path / "queries.npy")
    np.save(qfile, Vectorizer(device="cpu").vectorize_wrapped_bytes(mat, lengths))
    pipe = ["pipeline", idx, qfile, fna, "8", "16", "16"]
    assert tcli.main([*pipe, str(tmp_path / "t_out"), "--device", "cpu"]) == 0
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-c", _JAX_CLI_INTERPRET, *pipe,
                           str(tmp_path / "j_out")], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    for name in ("indices.npy", "distances.npy"):
        np.testing.assert_array_equal(np.load(tmp_path / "t_out" / name),
                                      np.load(tmp_path / "j_out" / name))
    stats = {}
    run_pipeline(idx, fq, fna, 8, 16, 16, str(tmp_path / "fq_out"), write_sam=False,
                 device="cpu", search_stats=stats)
    _, names = fastq.parse_fastq(fq)
    hits = _truth_hits(np.load(tmp_path / "fq_out" / "indices.npy"), names)
    assert hits >= 135, hits
    # the search-effort counters reach the caller, as in the JAX pipeline
    assert stats["queries"] == 150 and stats["nprobe"] == 8
    assert 0 < stats["coverage"] <= 1 and stats["centroid_evals_per_query"] >= 8
