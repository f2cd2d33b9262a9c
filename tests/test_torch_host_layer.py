"""The port's own copies of the JAX package's host layer (config, tokenizer,
native, io, utils) against their originals on the fixtures: the same token
ids, FASTA windows and reverse complements, FASTQ parse, SAM text, config.txt
round trip and estimates."""

import os

import numpy as np
import pytest
from jax_native_guard import jax_native_available

from deepreadmapper_tpu import config as jconfig
from deepreadmapper_tpu import native as jnative
from deepreadmapper_tpu import tokenizer as jtok
from deepreadmapper_tpu.io import configstore as jcs
from deepreadmapper_tpu.io import fasta as jfasta
from deepreadmapper_tpu.io import fastq as jfastq
from deepreadmapper_tpu.io import readers as jreaders
from deepreadmapper_tpu.io import sam as jsam
from deepreadmapper_tpu.utils import memory as jmem
from deepreadmapper_tpu_torch import config as tconfig
from deepreadmapper_tpu_torch import native as tnative
from deepreadmapper_tpu_torch import tokenizer as ttok
from deepreadmapper_tpu_torch.io import configstore as tcs
from deepreadmapper_tpu_torch.io import fasta as tfasta
from deepreadmapper_tpu_torch.io import fastq as tfastq
from deepreadmapper_tpu_torch.io import readers as treaders
from deepreadmapper_tpu_torch.io import sam as tsam
from deepreadmapper_tpu_torch.utils import memory as tmem


def _arrays_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_config_copies_match(tmp_path):
    for name in ("InferenceConfig", "BuildConfig", "SearchConfig"):
        assert (tconfig.__dict__[name]().__dict__ == jconfig.__dict__[name]().__dict__)
    assert (tconfig.PREFIX, tconfig.POSTFIX) == (jconfig.PREFIX, jconfig.POSTFIX)
    cfg = {"index_type": "IVFPQ", "stride": 1, "ref_len": 150, "n_vects": 1702,
           "m_pq": 8, "nbits": 8, "index_file": "/x/y.index"}
    tcs.save_config(cfg, str(tmp_path / "t"))
    jcs.save_config(cfg, str(tmp_path / "j"))
    with open(tmp_path / "t" / "config.txt", "rb") as f, \
            open(tmp_path / "j" / "config.txt", "rb") as g:
        assert f.read() == g.read()
    path = str(tmp_path / "t" / "config.txt")
    assert tcs.load_config(path) == jcs.load_config(path) == cfg


def test_tokenizer_copy_matches(data_dir):
    seqs, _ = jfastq.parse_fastq(str(data_dir / "test_data.fastq"))
    edge = ["<ACGNNTTACGNA>", "<N>", "<>", "<" + "ACGT" * 40 + ">", "<acgtN>"]
    for batch in (seqs, edge):
        np.testing.assert_array_equal(ttok.tokenize_strings(batch, 123),
                                      jtok.tokenize_strings(batch, 123))
        mat, lengths = ttok.strings_to_bytes(batch)
        jm, jl = jtok.strings_to_bytes(batch)
        np.testing.assert_array_equal(mat, jm)
        np.testing.assert_array_equal(lengths, jl)
        np.testing.assert_array_equal(ttok.tokenize_bytes(mat, lengths),
                                      jtok.tokenize_bytes(jm, jl))
    assert ttok.tokenize_reference(edge[3]) == jtok.tokenize_reference(edge[3])


def test_native_copy_matches(data_dir):
    """The port's native loader builds its own library (under its _build/)
    from the same C++ sources; both answer alike, or both are missing."""
    assert tnative.available() == jax_native_available()
    if not tnative.available():
        pytest.skip("no C++ compiler for the native helpers")
    assert os.path.dirname(tnative._so_path()).endswith(
        os.path.join("deepreadmapper_tpu_torch", "_build"))
    mat, lengths = jtok.strings_to_bytes(["<ACGTNACGT>", "<" + "GATTACA" * 20 + ">"])
    np.testing.assert_array_equal(tnative.pack_wrapped(mat, lengths),
                                  jnative.pack_wrapped(mat, lengths))
    np.testing.assert_array_equal(tnative.tokenize_seqs(mat, lengths),
                                  jnative.tokenize_seqs(mat, lengths))


def test_fasta_and_fastq_copies_match(data_dir):
    fna = str(data_dir / "ecoli_150.fna")
    fq = str(data_dir / "test_data.fastq")
    recs = tfasta.parse_fasta_records(fna)
    _arrays_equal(recs, jfasta.parse_fasta_records(fna))
    assert tfasta.parse_fasta_names(fna) == jfasta.parse_fasta_names(fna)
    np.testing.assert_array_equal(tfasta.reverse_complement(recs[0]),
                                  jfasta.reverse_complement(recs[0]))
    for stride in (1, 3):
        _arrays_equal(tfasta.window_positions(recs, 150, stride),
                      jfasta.window_positions(recs, 150, stride))
    pos = np.arange(0, recs[0].size - 150, 7)
    for wrap in (True, False):
        _arrays_equal(tfasta.window_byte_matrix(recs[0], pos, 150, wrap=wrap),
                      jfasta.window_byte_matrix(recs[0], pos, 150, wrap=wrap))
    ids = np.arange(0, 2 * (recs[0].size - 150), 13)
    _arrays_equal(tfasta.fetch_windows_by_id(recs[0], ids, 150),
                  jfasta.fetch_windows_by_id(recs[0], ids, 150))
    assert tfastq.parse_fastq(fq) == jfastq.parse_fastq(fq)
    assert tfastq.parse_fastq_quals(fq) == jfastq.parse_fastq_quals(fq)
    _arrays_equal(tfastq.parse_fastq_bytes(fq)[:2], jfastq.parse_fastq_bytes(fq)[:2])
    assert tfastq.parse_fastq_bytes(fq)[2] == jfastq.parse_fastq_bytes(fq)[2]
    assert treaders.read_file(fq, 150) == jreaders.read_file(fq, 150)
    assert (tmem.estimate_window_count(fna, 150, 1)
            == jmem.estimate_window_count(fna, 150, 1))
    assert tmem.estimate_windows_ram(10**6, 150) == jmem.estimate_windows_ram(10**6, 150)


def test_sam_copy_matches(data_dir, tmp_path):
    fq = str(data_dir / "test_data.fastq")
    seqs, ids = jfastq.parse_fastq(fq)
    cand = np.random.default_rng(0).integers(0, 2 * 1500, (len(seqs), 3))
    out = {}
    for tag, mod in (("t", tsam), ("j", jsam)):
        path = str(tmp_path / f"{tag}.sam")
        mod.write_sam(seqs, ids, cand.ravel(), "ecoli", 1702, 3, path, pg="x y z",
                      quals=jfastq.parse_fastq_quals(fq))
        with open(path) as f:
            out[tag] = f.read()
    assert out["t"] == out["j"] and out["t"].count("\n") > 3 * len(seqs)
