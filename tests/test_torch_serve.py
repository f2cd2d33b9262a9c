"""The port's serving daemon (pipeline.serve): the JAX package's JSONL
protocol over one resident engine and encoder, on the CPU.  A request's
outputs are held to the one-shot pipeline's of the same options, byte for
byte (one process, one index, the same encoder: nothing differs)."""

import io
import json
import os

import numpy as np
import pytest
import torch

from deepreadmapper_tpu_torch.pipeline.build import build_index
from deepreadmapper_tpu_torch.pipeline.search import run_pipeline
from deepreadmapper_tpu_torch.pipeline.serve import _REQ_KEYS, serve


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def idx(tmp_path_factory, data_dir):
    prefix = str(tmp_path_factory.mktemp("srv") / "idx")
    build_index(str(data_dir / "ecoli_150.fna"), prefix, 150, device="cpu")
    return prefix


def _run(idx, data_dir, requests, **kw):
    out = io.StringIO()
    n = serve(idx, str(data_dir / "ecoli_150.fna"),
              in_stream=io.StringIO("".join(
                  (r if isinstance(r, str) else json.dumps(r)) + "\n" for r in requests)),
              out_stream=out, device="cpu", **kw)
    return n, [json.loads(ln) for ln in out.getvalue().splitlines()]


def test_serve_answers_requests_equal_to_the_one_shot_pipeline(idx, data_dir, tmp_path):
    """Two requests (the second with mapq + cigar + qual + sort + bam),
    then quit: each request's SAM and npy files equal the one-shot
    run_pipeline's with the same options, byte for byte."""
    fq, fna = str(data_dir / "test_data.fastq"), str(data_dir / "ecoli_150.fna")
    reqs = [
        {"id": "a", "fastq": fq, "output_dir": str(tmp_path / "a"), "k": 8},
        {"id": "b", "fastq": fq, "output_dir": str(tmp_path / "b"), "k": 8, "mapq": True,
         "cigar": True, "qual": True, "sort": True, "bam": True},
    ]
    n, lines = _run(idx, data_dir, [*reqs, {"cmd": "quit"}])
    assert n == 2
    ready, ra, rb, rq = lines
    assert ready["ok"] and ready["ready"] and ready["index_type"] == "INT8FLAT"
    assert ready["n_vects"] == 1702 and ready["stride"] == 1 and ready["t_load"] >= 0
    assert ra["id"] == "a" and ra["ok"] and ra["num_queries"] == 150
    assert rb["id"] == "b" and rb["ok"] and set(rb) >= {"t_embed", "t_search", "t_post"}
    assert rq == {"ok": True, "quit": True}
    for req in reqs:
        one = str(tmp_path / (req["id"] + "_one"))
        opts = {k: v for k, v in req.items() if k in _REQ_KEYS and k != "output_dir"}
        run_pipeline(idx, fq, fna, output_dir=one, device="cpu", **opts)
        names = sorted(os.listdir(one))
        assert names == sorted(os.listdir(req["output_dir"]))
        for name in names:
            a = open(os.path.join(one, name), "rb").read()
            assert a == open(os.path.join(req["output_dir"], name), "rb").read(), name


def test_serve_survives_bad_requests(idx, data_dir, tmp_path):
    """Bad JSON, a request with no fastq and a failing request each get an
    error reply; the daemon stays up and answers the requests after them: a
    paired request (fastq2), a long-read request, a plain one."""
    fq = str(data_dir / "test_data.fastq")
    n, lines = _run(idx, data_dir, [
        "{not json",
        {"id": "nofq", "output_dir": str(tmp_path / "x")},
        {"id": "pair", "fastq": fq, "fastq2": fq, "output_dir": str(tmp_path / "p")},
        {"id": "lr", "fastq": fq, "long_reads": True, "output_dir": str(tmp_path / "l")},
        {"id": "bad", "fastq": str(tmp_path / "missing.fastq"),
         "output_dir": str(tmp_path / "m")},
        {"id": "ok", "fastq": fq, "output_dir": str(tmp_path / "o"), "k": 4},
        {"cmd": "quit"},
        {"id": "after", "fastq": fq},
    ])
    assert n == 3
    ready, bad_json, nofq, pair, lr, missing, ok, quit_ = lines
    assert ready["ready"]
    assert not bad_json["ok"] and "bad request json" in bad_json["error"]
    assert nofq == {"id": "nofq", "ok": False, "error": "missing 'fastq'"}
    assert pair["id"] == "pair" and pair["ok"] and pair["num_queries"] == 300
    assert lr["id"] == "lr" and lr["ok"] and lr["num_queries"] == 150
    assert missing["id"] == "bad" and not missing["ok"]
    assert ok["ok"] and ok["num_queries"] == 150
    assert quit_["quit"]
    assert np.load(tmp_path / "p" / "indices.npy").shape[0] == 300  # R1's rows, then R2's
    assert np.load(tmp_path / "l" / "indices.npy").shape[0] == 150


def test_serve_search_stats_for_an_ivf_index(tmp_path_factory, data_dir, tmp_path):
    """search_stats: true returns the IVF engine's effort counters."""
    prefix = str(tmp_path_factory.mktemp("srv_ivf") / "idx")
    build_index(str(data_dir / "ecoli_150.fna"), prefix, 150, index_type="IVFINT8",
                device="cpu")
    fq = str(data_dir / "test_data.fastq")
    n, lines = _run(prefix, data_dir, [
        {"id": "s", "fastq": fq, "output_dir": str(tmp_path / "o"), "k": 8, "ef": 4,
         "search_stats": True},
        {"id": "t", "fastq": fq, "output_dir": str(tmp_path / "o2"), "k": 8, "ef": 4},
        {"cmd": "quit"},
    ])
    assert n == 2
    st = lines[1]["search_stats"]
    assert st["queries"] == 150 and st["nprobe"] == 4
    assert 0 < st["probed_rows_per_query"] <= st["ntotal"]
    assert 0 < st["coverage"] <= 1.0
    assert st["centroid_evals_per_query"] == st["nlist"]
    assert "search_stats" not in lines[2]
    np.testing.assert_array_equal(np.load(tmp_path / "o" / "indices.npy"),
                                  np.load(tmp_path / "o2" / "indices.npy"))


def test_cli_serve_dispatch(idx, data_dir, monkeypatch, capsys):
    """``serve`` through the port's CLI: the ready line and the answers go
    to stdout, the pipeline's own prints to stderr, the daemon's defaults
    (--k, --mapq) reach the requests."""
    from deepreadmapper_tpu_torch import cli

    fq = str(data_dir / "test_data.fastq")
    tmp = os.path.join(os.path.dirname(idx), "cli_out")
    monkeypatch.setattr("sys.stdin", io.StringIO(
        json.dumps({"fastq": fq, "output_dir": tmp}) + "\n" + '{"cmd": "quit"}\n'))
    rc = cli.main(["serve", idx, str(data_dir / "ecoli_150.fna"), "--k", "4", "--mapq",
                   "--device", "cpu"])
    cap = capsys.readouterr()
    assert rc == 0
    lines = [json.loads(ln) for ln in cap.out.splitlines()]
    assert len(lines) == 3 and lines[0]["ready"] and lines[1]["ok"] and lines[2]["quit"]
    assert "[SERVE] answered 1 requests" in cap.err
    assert np.load(os.path.join(tmp, "indices.npy")).shape == (150, 4)
    pg = next(ln for ln in open(os.path.join(tmp, "results.sam")) if ln.startswith("@PG"))
    assert " k=4 " in pg and pg.rstrip().endswith(" mapq")


def test_serve_search_stats_for_an_hnsw_index(tmp_path_factory, data_dir, tmp_path):
    """serve takes an HNSWPQ index through load_index with no change of its
    own; search_stats: true returns the beam's effort counters, and the
    answer equals the one-shot pipeline's."""
    prefix = str(tmp_path_factory.mktemp("srv_hnsw") / "idx")
    build_index(str(data_dir / "ecoli_150.fna"), prefix, 150, index_type="HNSWPQ",
                device="cpu")
    fq = str(data_dir / "test_data.fastq")
    n, lines = _run(prefix, data_dir, [
        {"id": "s", "fastq": fq, "output_dir": str(tmp_path / "o"), "k": 8, "ef": 32,
         "search_stats": True},
        {"cmd": "quit"},
    ])
    assert n == 1
    st = lines[1]["search_stats"]
    assert st["queries"] == 150 and st["beam_expansions_per_query"] == 32
    assert st["ntotal"] == 1702 and st["graph_degree"] == 32
    run_pipeline(prefix, fq, str(data_dir / "ecoli_150.fna"), 32, 8, 5,
                 str(tmp_path / "one"), write_sam=False, device="cpu")
    np.testing.assert_array_equal(np.load(tmp_path / "o" / "indices.npy"),
                                  np.load(tmp_path / "one" / "indices.npy"))
