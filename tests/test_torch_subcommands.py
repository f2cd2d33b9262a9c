"""The port's subcommands against the JAX CLI's: inference (FASTA windows,
FASTQ, txt), info, gen-ref and plan; the Vectorizer's bf16 and max_len
modes; --profile.  Embeddings are held at the encoder's tolerance of
tests/test_torch_gru.py (rtol 1e-4, atol 1e-5); text outputs exactly."""

import contextlib
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from jax_native_guard import _jax_native_loaded  # noqa: F401  (module fixture)

RTOL, ATOL = 1e-4, 1e-5
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _run(cli, argv):
    """(exit code, stdout) of one CLI call in this process."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    return rc, buf.getvalue()


@pytest.fixture(scope="module")
def jax_vec():
    """The JAX Vectorizer at a small device batch: the JAX CLI's default of
    8192 pads every streamed chunk to 8192 rows, minutes on the CPU."""
    from deepreadmapper_tpu.models.encoder import Vectorizer

    return Vectorizer(device_batch=256)


@pytest.mark.parametrize("name", ["ecoli_150.fna", "test_data.fastq", "test_data_quer.txt"])
def test_inference_matches_jax(data_dir, tmp_path, jax_vec, name):
    """The port's CLI ``inference <input> 150 <out.npy> 100 [--stride 3]``
    against the JAX functions its CLI dispatches to (FASTA windows:
    stream_embed_fasta_to_npy; FASTQ and txt: stream_embed_seqs_to_npy) at
    the same batch of 100, which splits every input into several chunks."""
    from deepreadmapper_tpu.pipeline import build as jbuild
    from deepreadmapper_tpu_torch import cli as tcli

    src = str(data_dir / name)
    fasta = name.endswith(".fna")
    jpath, tpath = str(tmp_path / "jax.npy"), str(tmp_path / "torch.npy")
    if fasta:
        n = jbuild.stream_embed_fasta_to_npy(src, jpath, 150, 3, jax_vec, window_chunk=100)
    else:
        n = jbuild.stream_embed_seqs_to_npy(src, jpath, jax_vec, batch=100)
    rc, text = _run(tcli, ["inference", src, "150", tpath, "100", "--device", "cpu",
                           *(["--stride", "3"] if fasta else [])])
    assert rc == 0 and text == f"[INFERENCE] streamed ({n}, 128) to {tpath}\n"
    got, want = np.load(tpath), np.load(jpath)
    assert got.shape == want.shape == ({"test_data.fastq": 150,
                                        "test_data_quer.txt": 145}.get(name, 568), 128)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_info_gen_ref_plan_match_jax_cli(data_dir, tmp_path):
    """info on an index, gen-ref (wrapped and lookup) and plan (a FASTA
    and a base count, --hbm-gb 12 as the JAX default) print the JAX CLI's
    output exactly and write the same files; none needs a device."""
    from deepreadmapper_tpu import cli as jcli
    from deepreadmapper_tpu_torch import cli as tcli
    from deepreadmapper_tpu_torch.pipeline.build import build_index

    fna = str(data_dir / "ecoli_150.fna")
    idx = str(tmp_path / "idx")
    build_index(fna, idx, 150, device="cpu")
    runs = [
        (["info", idx], None),
        (["info", str(tmp_path / "missing")], None),
        (["gen-ref", "-i", fna, "-l", "150", "-s", "2", "-o", "{d}/w.txt"], "w.txt"),
        (["gen-ref", "-i", fna, "-l", "150", "-o", "{d}/l.txt", "-L"], "l.txt"),
        (["plan", fna, "--hbm-gb", "12"], None),
        (["plan", "3.1e9", "150", "--hbm-gb", "12"], None),
        (["plan", "2e11", "--stride", "2", "--hbm-gb", "12"], None),
    ]
    for argv, written in runs:
        got = {}
        for tag, cli in (("jax", jcli), ("torch", tcli)):  # one output path, in turns
            got[tag] = _run(cli, [a.format(d=tmp_path) for a in argv])
            if written:
                got[tag] += ((tmp_path / written).read_text(),)
                os.remove(tmp_path / written)
        assert got["torch"] == got["jax"], argv
        if argv == ["info", idx]:
            assert got["torch"][0] == 0 and "disk_total_mb: " in got["torch"][1]


def test_plan_defaults_to_the_card_memory(monkeypatch):
    """Without --hbm-gb, plan sizes against the visible card's memory less
    the search's scan workspace (9.2 GB, measured on the H100), and against
    80 GB (the H100's) less it with no card visible."""
    from deepreadmapper_tpu_torch import cli as tcli

    assert tcli._SCAN_WORKSPACE_GB == 9.2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, text = _run(tcli, ["plan", "3.1e9"])
    assert text == _run(tcli, ["plan", "3.1e9", "--hbm-gb", "70.8"])[1]
    assert text != _run(tcli, ["plan", "3.1e9", "--hbm-gb", "80"])[1]
    # a genome whose dense INT8FLAT index (74.2 GB) fits 80 GB but not 70.8:
    # the default recommends the sparse stride
    assert "vectors at stride 4 " in _run(tcli, ["plan", "2.9e8"])[1]
    assert "vectors at stride 1 " in _run(tcli, ["plan", "2.9e8", "--hbm-gb", "80"])[1]

    class Props:
        total_memory = 40e9

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda i: Props)
    _, text = _run(tcli, ["plan", "3.1e9"])
    assert text == _run(tcli, ["plan", "3.1e9", "--hbm-gb", "30.8"])[1]


@pytest.mark.parametrize("cmd", ["info", "plan", "gen-ref"])
def test_cli_without_a_card_runs_the_host_commands(data_dir, tmp_path, cmd):
    """info, plan and gen-ref touch no device: with no CUDA device visible
    and without --device they run and exit 0."""
    fna = str(data_dir / "ecoli_150.fna")
    idx = tmp_path / "idx"
    idx.mkdir()
    (idx / "config.txt").write_text("index_type: INT8FLAT\nn_vects: 4\n")
    argv = {"info": ["info", str(idx)], "plan": ["plan", fna],
            "gen-ref": ["gen-ref", "-i", fna, "-l", "150", "-o", str(tmp_path / "w.txt")]}[cmd]
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-m", "deepreadmapper_tpu_torch", *argv],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip()


def test_vectorizer_bfloat16_close_to_fp32():
    """Vectorizer(dtype="bfloat16") in both packages stays within the JAX
    test's bound of 0.3 of its fp32 embeddings (tests/test_encoder.py)."""
    from deepreadmapper_tpu.models.encoder import Vectorizer as JVec
    from deepreadmapper_tpu_torch.models.encoder import Vectorizer as TVec

    rng = np.random.default_rng(2)
    seqs = ["<" + "".join(rng.choice(list("acgt"), size=150)) + ">" for _ in range(16)]
    j32 = JVec(device_batch=16).vectorize(seqs)
    jbf = JVec(device_batch=16, dtype="bfloat16").vectorize(seqs)
    t32 = TVec(device_batch=16, device="cpu").vectorize(seqs)
    tbf = TVec(device_batch=16, device="cpu", dtype="bfloat16").vectorize(seqs)
    assert np.abs(j32 - jbf).max() < 0.3
    assert np.abs(t32 - tbf).max() < 0.3
    assert np.abs(tbf - j32).max() < 0.3
    np.testing.assert_allclose(t32, j32, rtol=RTOL, atol=ATOL)
    with pytest.raises(ValueError):
        TVec(device="cpu", dtype="float16")


@pytest.mark.parametrize("max_len", [60, 100])
def test_vectorizer_max_len_matches_jax(data_dir, max_len):
    """A non-default max_len tokenizes on the host in both packages: the
    fixture reads (FASTQ bytes and strings) embed within fp32 tolerance of
    the JAX Vectorizer's, and differ from the default length's."""
    from deepreadmapper_tpu.io.fastq import parse_fastq_bytes
    from deepreadmapper_tpu.models.encoder import Vectorizer as JVec
    from deepreadmapper_tpu.pipeline.search import _load_queries as jload
    from deepreadmapper_tpu_torch.models.encoder import Vectorizer as TVec
    from deepreadmapper_tpu_torch.pipeline.search import _load_queries as tload

    fq = str(data_dir / "test_data.fastq")
    jv = JVec(device_batch=256, max_len=max_len)
    tv = TVec(device_batch=256, device="cpu", max_len=max_len)
    je, jseqs, _ = jload(fq, jv)
    te, tseqs, _ = tload(fq, tv)
    assert tseqs == jseqs
    np.testing.assert_allclose(te, je, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tv.vectorize(tseqs[:20]), jv.vectorize(jseqs[:20]),
                               rtol=RTOL, atol=ATOL)
    mat, lengths, _ = parse_fastq_bytes(fq)
    default = TVec(device_batch=256, device="cpu").vectorize_wrapped_bytes(mat, lengths)
    assert np.abs(default - te).max() > 1e-2


def test_vectorizer_max_len_build_and_rerank_match_jax(data_dir, tmp_path):
    """max_len=100 through a FLAT build at stride 2 (window embeddings
    tokenized on the host) and the sparse L2 rerank (its re-embedded
    candidate windows): the index vectors and the reranked distances are
    within fp32 tolerance of the JAX package's; the ids agree wherever the
    JAX distances are more than 1e-4 apart."""
    from deepreadmapper_tpu.models.encoder import Vectorizer as JVec
    from deepreadmapper_tpu.pipeline.build import build_index as jbuild
    from deepreadmapper_tpu.pipeline.search import run_pipeline as jrun
    from deepreadmapper_tpu_torch.models.encoder import Vectorizer as TVec
    from deepreadmapper_tpu_torch.pipeline.build import build_index as tbuild
    from deepreadmapper_tpu_torch.pipeline.search import run_pipeline as trun

    fna, fq = str(data_dir / "ecoli_150.fna"), str(data_dir / "test_data.fastq")
    jv, tv = JVec(device_batch=256, max_len=100), TVec(device_batch=256, device="cpu",
                                                       max_len=100)
    jidx, tidx = str(tmp_path / "j"), str(tmp_path / "t")
    jbuild(fna, jidx, 150, stride=2, index_type="FLAT", vectorizer=jv)
    tbuild(fna, tidx, 150, stride=2, index_type="FLAT", vectorizer=tv, device="cpu")
    np.testing.assert_allclose(np.load(os.path.join(tidx, "vectors.npy")),
                               np.load(os.path.join(jidx, "vectors.npy")), rtol=RTOL, atol=ATOL)
    opts = dict(k=8, k_clusters=5, write_sam=False)
    j = jrun(jidx, fq, fna, output_dir=str(tmp_path / "jo"), vectorizer=jv, **opts)
    t = trun(jidx, fq, fna, output_dir=str(tmp_path / "to"), vectorizer=tv, device="cpu",
             **opts)
    np.testing.assert_allclose(t["final_d"], j["final_d"], rtol=RTOL, atol=ATOL)
    gap = np.diff(j["final_d"], axis=1) > 1e-4
    clear = np.concatenate([gap[:, :1], gap[:, :-1] & gap[:, 1:], gap[:, -1:]], 1)
    assert clear.mean() > 0.5
    np.testing.assert_array_equal(t["final_ids"][clear], j["final_ids"][clear])


def test_profile_writes_a_trace(data_dir, tmp_path):
    """pipeline --profile DIR on the CPU writes a Chrome trace of the whole
    request (torch.profiler), the tracer's spans through the npy write
    included, and the outputs are unchanged."""
    from deepreadmapper_tpu_torch import cli as tcli

    fna, fq = str(data_dir / "ecoli_150.fna"), str(data_dir / "test_data.fastq")
    idx = str(tmp_path / "idx")
    assert _run(tcli, ["build-index", fna, idx, "150", "--device", "cpu"])[0] == 0
    outs = {}
    for tag, extra in (("plain", []), ("prof", ["--profile", str(tmp_path / "trace")])):
        out = str(tmp_path / tag)
        rc, _ = _run(tcli, ["pipeline", idx, fq, fna, "128", "8", "5", out, "--device", "cpu",
                            *extra])
        assert rc == 0
        outs[tag] = np.load(os.path.join(out, "indices.npy"))
    np.testing.assert_array_equal(outs["prof"], outs["plain"])
    files = os.listdir(tmp_path / "trace")
    assert files == ["pipeline.pt.trace.json"]
    trace = json.load(open(tmp_path / "trace" / files[0]))
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any("aten::" in n for n in names)
    assert {"pipeline.embed", "embed.encode", "pipeline.search", "search.scan",
            "pipeline.post", "post.fasta", "post.sam", "write.npy"} <= names
