"""Crash-resumable streaming builds of the port (build-index --resume), and
its copy of NpyStreamWriter against the JAX package's, on the CPU.  Builds
are deterministic on the CPU, so an interrupted-then-resumed build is held
to the plain build bit for bit."""

import functools
import json
import os

import numpy as np
import pytest
import torch

from deepreadmapper_tpu_torch.index.int8_flat import quantize
from deepreadmapper_tpu_torch.io import fasta as fasta_io
from deepreadmapper_tpu_torch.models.encoder import Vectorizer
from deepreadmapper_tpu_torch.pipeline import build as build_mod
from deepreadmapper_tpu_torch.pipeline.build import build_index, stream_codes_resumable

SCALE = 1.0 / 127.0


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def vec():
    return Vectorizer(device_batch=2048, device="cpu")


@pytest.fixture(scope="module")
def record(data_dir):
    return fasta_io.parse_fasta_records(str(data_dir / "ecoli_150.fna"))[0]


def _q(e):
    return quantize(e, SCALE)


def test_interrupted_stream_resumes_without_reembedding(record, vec, tmp_path):
    """A stream that dies after two chunks, plus a partial row a crash
    mid-write leaves: the rerun embeds only the missing chunks, and the
    result equals an uninterrupted stream's."""
    cache = str(tmp_path / "codes.npy")
    calls = {"n": 0}

    def dying_q(e):
        if calls["n"] == 2:
            raise RuntimeError("simulated crash")
        calls["n"] += 1
        return _q(e)

    with pytest.raises(RuntimeError):
        stream_codes_resumable([record], 150, 1, vec, dying_q, cache, 128, "|i1",
                               window_chunk=64)
    assert os.path.exists(cache)
    with open(cache, "ab") as f:
        f.write(b"\x01" * 37)

    calls2 = {"n": 0}

    def counting_q(e):
        calls2["n"] += 1
        return _q(e)

    got = stream_codes_resumable([record], 150, 1, vec, counting_q, cache, 128, "|i1",
                                 window_chunk=64)
    assert calls2["n"] == -(-851 // 64) - 2  # the first two chunks were skipped
    ref = stream_codes_resumable([record], 150, 1, vec, _q, str(tmp_path / "ref.npy"),
                                 128, "|i1", window_chunk=64)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


_ENGINE_FILE = {"INT8FLAT": "int8.npz", "IVFINT8": "ivf_int8.npz", "PQFLAT": "pq.npz",
                "IVFPQ": "ivf_pq.npz"}


@pytest.mark.parametrize("index_type", ["INT8FLAT", "IVFINT8", "PQFLAT", "IVFPQ"])
def test_interrupted_build_resumes_to_the_plain_build(data_dir, vec, tmp_path,
                                                      monkeypatch, index_type):
    """A build that dies after its first code chunk (chunks of 64 windows
    in the plain and the resumed build alike), then resumed: every array of
    the saved engine equals the plain build's bit for bit, and the cache is
    gone."""
    fna = str(data_dir / "ecoli_150.fna")
    p_plain, p_res = str(tmp_path / "plain"), str(tmp_path / "res")
    for name in ("embed_fasta_windows", "stream_codes_resumable"):
        monkeypatch.setattr(build_mod, name,
                            functools.partial(getattr(build_mod, name), window_chunk=64))
    build_index(fna, p_plain, 150, index_type=index_type, vectorizer=vec, device="cpu")

    real = build_mod._embed_record_windows
    state = {"n": 0}

    def dying(rec, ref_len, stride, *a, **kw):
        if stride == 1:  # a code chunk (the PQ training sample runs at stride 2)
            if state["n"] == 1:
                raise RuntimeError("simulated crash after one code chunk")
            state["n"] += 1
        return real(rec, ref_len, stride, *a, **kw)

    monkeypatch.setattr(build_mod, "_embed_record_windows", dying)
    with pytest.raises(RuntimeError):
        build_index(fna, p_res, 150, index_type=index_type, vectorizer=vec,
                    device="cpu", resume=True)
    monkeypatch.setattr(build_mod, "_embed_record_windows", real)
    # one chunk's rows (64 windows x 2 strands) after the 128-byte npy header
    row_bytes = 8 if "PQ" in index_type else 128
    size = os.path.getsize(os.path.join(p_res, ".build_cache", "codes.npy"))
    assert size == 128 + 128 * row_bytes
    assert not os.path.exists(os.path.join(p_res, "config.txt"))
    build_index(fna, p_res, 150, index_type=index_type, vectorizer=vec, device="cpu",
                resume=True)
    a = np.load(os.path.join(p_plain, _ENGINE_FILE[index_type]))
    b = np.load(os.path.join(p_res, _ENGINE_FILE[index_type]))
    assert a.files == b.files
    for key in a.files:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    assert not os.path.exists(os.path.join(p_res, ".build_cache"))


def test_resume_refuses_changed_params(data_dir, vec, tmp_path):
    fna = str(data_dir / "ecoli_150.fna")
    prefix = str(tmp_path / "idx")
    build_index(fna, prefix, 150, vectorizer=vec, device="cpu", resume=True)
    cache = os.path.join(prefix, ".build_cache")
    os.makedirs(cache)
    with open(os.path.join(cache, "state.json"), "w") as f:
        json.dump({"stride": 999}, f)
    with pytest.raises(ValueError, match="does not match"):
        build_index(fna, prefix, 150, vectorizer=vec, device="cpu", resume=True)
    # the same through the CLI, with a stride that differs from the cache's
    from deepreadmapper_tpu_torch import cli

    prefix2 = str(tmp_path / "idx2")
    build_mod._resume_cache(prefix2, {"stride": 1}, True)
    with pytest.raises(ValueError, match="does not match"):
        cli.main(["build-index", fna, prefix2, "150", "2", "--resume", "--device", "cpu"])


def test_resume_pq_reuses_codebook(data_dir, vec, tmp_path):
    """PQ pass A (codebook training) checkpoints too: a rerun after a crash
    in pass B loads the saved codebook instead of training again, and the
    index equals an uninterrupted build's."""
    fna = str(data_dir / "ecoli_150.fna")
    p_plain, p_res = str(tmp_path / "plain"), str(tmp_path / "res")
    build_index(fna, p_plain, 150, index_type="PQFLAT", vectorizer=vec, device="cpu")

    real_stream, real_train = build_mod.stream_codes_resumable, build_mod.pq_ops.train_pq
    state = {"first": True, "trained": 0}

    def dying_stream(*a, **kw):
        if state["first"]:
            state["first"] = False
            raise RuntimeError("simulated crash after codebook training")
        return real_stream(*a, **kw)

    def counting_train(*a, **kw):
        state["trained"] += 1
        return real_train(*a, **kw)

    build_mod.stream_codes_resumable = dying_stream
    build_mod.pq_ops.train_pq = counting_train
    try:
        with pytest.raises(RuntimeError):
            build_index(fna, p_res, 150, index_type="PQFLAT", vectorizer=vec,
                        device="cpu", resume=True)
        assert os.path.exists(os.path.join(p_res, ".build_cache", "codebook.npz"))
        build_index(fna, p_res, 150, index_type="PQFLAT", vectorizer=vec, device="cpu",
                    resume=True)
    finally:
        build_mod.stream_codes_resumable = real_stream
        build_mod.pq_ops.train_pq = real_train
    assert state["trained"] == 1
    a = np.load(os.path.join(p_plain, "pq.npz"))
    b = np.load(os.path.join(p_res, "pq.npz"))
    np.testing.assert_array_equal(a["codes"], b["codes"])
    np.testing.assert_array_equal(a["centroids"], b["centroids"])
    assert not os.path.exists(os.path.join(p_res, ".build_cache"))


@pytest.mark.parametrize("dtype,n_cols", [("<f4", 128), ("|i1", 128), ("|u1", 8)])
def test_npy_stream_writer_bytes_equal_jax(tmp_path, dtype, n_cols):
    """The copied NpyStreamWriter writes the JAX package's bytes: a whole
    stream, and one resumed after a truncation."""
    from deepreadmapper_tpu.io.npy_stream import NpyStreamWriter as J
    from deepreadmapper_tpu_torch.io.npy_stream import NpyStreamWriter as T

    rng = np.random.default_rng(0)
    rows = (rng.standard_normal((300, n_cols)) * 50).astype(np.dtype(dtype))
    for tag, cls in (("j", J), ("t", T)):
        w = cls(str(tmp_path / f"{tag}.npy"), 300, n_cols, dtype)
        w.append(rows[:100])
        w.append(rows[100:160])
        w.truncate_to(100)
        w._f.close()
        w = cls.resume(str(tmp_path / f"{tag}.npy"), 300, n_cols, dtype)
        assert w.rows_written == 100
        w.append(rows[100:])
        w.close()
    a = open(tmp_path / "j.npy", "rb").read()
    assert a == open(tmp_path / "t.npy", "rb").read()
    np.testing.assert_array_equal(np.load(tmp_path / "t.npy"), rows)
