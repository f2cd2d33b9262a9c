"""MAPQ (compute_mapq, calibrate_mapq) and CIGAR/NM/MD/AS
(_primary_alignment_cigars) of the port against the JAX package's, on the
same inputs, and ``pipeline --cigar`` on planted-indel reads through both
CLIs.  MAPQ and CIGARs are host arithmetic (numpy float64, the native
aligner) in both packages, so on the same arrays they are held exactly."""

import os

import numpy as np
import pytest
import torch

from deepreadmapper_tpu.io import fasta as fasta_io
from deepreadmapper_tpu.io.fastq import parse_fastq_bytes
from deepreadmapper_tpu.pipeline import search as jsearch
from deepreadmapper_tpu_torch import native
from deepreadmapper_tpu_torch.pipeline import search as tsearch
from jax_native_guard import _jax_native_loaded  # noqa: F401  (module fixture)
from jax_native_guard import can_build, jax_native_available

REF_LEN = 150


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _mapq_inputs(seed: int, k: int, higher: bool):
    """Seeded candidate lists: a primary, same-locus neighbours (within
    ref_len, same strand), distant competitors, opposite-strand hits at the
    same spot, invalid slots and primaries, exact ties, and rows with no
    competing locus."""
    rng = np.random.default_rng(seed)
    nq = 400
    base = rng.integers(0, 50_000, nq) * 2 + rng.integers(0, 2, nq)
    off = rng.choice([0, 2, 40, 298, 300, 302, 1, 3, 9000, -9000, 120_000], (nq, k))
    lone = rng.random(nq) < 0.15  # no competing locus among the candidates
    off[lone] = rng.choice([0, 2, 40], (int(lone.sum()), k))
    ids = base[:, None] + off
    ids[:, 0] = base
    ids[rng.random((nq, k)) < 0.05] = -1
    ids[rng.random(nq) < 0.05, 0] = -1
    vals = np.sort(rng.random((nq, k)) * 100, axis=1)
    if higher:
        vals = vals[:, ::-1].copy()
    tie = rng.random(nq) < 0.1
    if k > 1:
        vals[tie, 1:] = vals[tie, :1]
    return ids.astype(np.int64), vals.astype(np.float32)


@pytest.mark.parametrize("k", [1, 2, 16, 128])
@pytest.mark.parametrize("higher", [False, True])
@pytest.mark.parametrize("multi", [False, True])
def test_compute_mapq_equals_jax(k, higher, multi):
    ids, vals = _mapq_inputs(k * 7 + higher, k, higher)
    dense_off = np.array([0, 20_000, 20_310, 80_000, 200_000], np.int64) if multi else None
    want = jsearch.compute_mapq(ids, vals, REF_LEN, higher_is_better=higher,
                                dense_off=dense_off)
    got = tsearch.compute_mapq(ids, vals, REF_LEN, higher_is_better=higher,
                               dense_off=dense_off)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    if k > 1:
        assert 0 < np.sum(got == 60) < len(got) and np.any(got == 0)


def test_calibrate_mapq_equals_jax():
    raw = np.concatenate([np.arange(-3, 65), np.random.default_rng(0).integers(0, 61, 500)])
    np.testing.assert_array_equal(tsearch.calibrate_mapq(raw), jsearch.calibrate_mapq(raw))
    np.testing.assert_array_equal(tsearch._MAPQ_CAL_BINS, jsearch._MAPQ_CAL_BINS)
    np.testing.assert_array_equal(tsearch._MAPQ_CAL_VALS, jsearch._MAPQ_CAL_VALS)


def _fixture_genome(data_dir):
    return fasta_io.parse_fasta_records(str(data_dir / "ecoli_150.fna"))[0]


@pytest.mark.skipif(not native.available(), reason="native library unavailable")
@pytest.mark.parametrize("multi", [False, True])
def test_primary_alignment_cigars_equal_jax(data_dir, multi):
    """The fixture reads against primaries on both strands (their true
    windows), shifted windows (soft clips), random windows, invalid (-1)
    ids; on one record and on the genome cut into three records."""
    _compare_primary_cigars(data_dir, multi)


@pytest.mark.skipif(not (native.available() and can_build()),
                    reason="native library or g++ unavailable")
def test_half_written_jax_library_fails_the_comparison_without_the_guard(
        data_dir, tmp_path, monkeypatch):
    """Why the port's cross-package tests load the JAX library through
    jax_native_guard: a process that loads it while another still writes it
    (g++ writes straight onto the final path) caches the failure, and
    test_primary_alignment_cigars_equal_jax's comparison then fails, even
    after the file is whole.  The guard reloads the finished file, and the
    comparison passes.  The module state comes back with monkeypatch."""
    from deepreadmapper_tpu import native as jnative

    whole = open(jnative._SO, "rb").read()
    so = tmp_path / os.path.basename(jnative._SO)
    so.write_bytes(whole[:64])  # the writer has the ELF header out, no more
    monkeypatch.setattr(jnative, "_SO", str(so))
    monkeypatch.setattr(jnative, "_lib", None)
    monkeypatch.setattr(jnative, "_tried", False)
    assert not jnative.available()
    with pytest.raises(AssertionError):
        _compare_primary_cigars(data_dir, False)
    so.write_bytes(whole)  # the writer finishes; the failed load stays cached
    assert not jnative.available()
    with pytest.raises(AssertionError):
        _compare_primary_cigars(data_dir, False)
    assert jax_native_available(settle_s=0.05)
    _compare_primary_cigars(data_dir, False)


def _compare_primary_cigars(data_dir, multi):
    rec = _fixture_genome(data_dir)
    mat, lengths, names = parse_fastq_bytes(str(data_dir / "test_data.fastq"))
    seqs = [bytes(r[: int(n)]).decode() for r, n in zip(mat, lengths)]
    if multi:
        records = [rec[:600], rec[600:1300], rec[1300:]]
        genome = np.concatenate(records)
        dense_off, base_off = fasta_io.record_window_table(records, REF_LEN, 1)
        n_dense = int(dense_off[-1])
    else:
        genome, dense_off, base_off = rec, None, None
        n_dense = rec.size - REF_LEN + 1
    rng = np.random.default_rng(3)
    ids = rng.integers(0, 2 * n_dense, len(seqs)).astype(np.int64)
    if not multi:  # truth windows (name-encoded 1-based start), both strands
        truth = np.array([int(n.split("_")[1]) - 1 for n in names])
        ids[:100] = 2 * np.clip(truth[:100] + rng.integers(-3, 4, 100), 0, n_dense - 1) \
            + rng.integers(0, 2, 100)
    ids[rng.random(len(seqs)) < 0.1] = -1
    jc, jp, jt = jsearch._primary_alignment_cigars(seqs, ids, genome, REF_LEN, multi,
                                                   dense_off, base_off)
    tc, tp, tt = tsearch._primary_alignment_cigars(seqs, ids, genome, REF_LEN, multi,
                                                   dense_off, base_off)
    assert tc == jc and tt == jt
    np.testing.assert_array_equal(tp, jp)
    assert sum(bool(c) for c in tc) >= 100 and any(c == "" for c in tc)
    assert any("S" in c for c in tc) and any(t.startswith("\tNM:i:") for t in tt)


def _indel_fastq(data_dir, path):
    """test_cigar.py's planted reads: a forward read with 1I + 1D, a
    reverse-complement read, and a reverse read with indels and varying
    qualities."""
    genome = fasta_io.extract_fasta_sequence(str(data_dir / "ecoli_150.fna")).tobytes().decode()
    comp = str.maketrans("ACGT", "TGCA")
    src = genome[100:251]
    ins_del = (src[:30] + "A" + src[30:60] + src[61:150])[:150]
    rev = genome[300:450].translate(comp)[::-1]
    src = genome[300:451]
    rev_indel = (src[:40] + "A" + src[40:80] + src[81:150]).translate(comp)[::-1]
    qual = "".join(chr(33 + i % 40) for i in range(150))
    with open(path, "w") as f:
        for name, read in (("ins_del", ins_del), ("rev", rev), ("rev_indel", rev_indel)):
            f.write(f"@{name}\n{read}\n+\n{qual}\n")
    return genome


def _sam(path):
    """read name -> its SAM lines (fields), in order."""
    out = {}
    for ln in open(path):
        if not ln.startswith("@"):
            f = ln.rstrip("\n").split("\t")
            out.setdefault(f[0], []).append(f)
    return out


@pytest.mark.skipif(not native.available(), reason="native library unavailable")
def test_pipeline_cigar_through_both_clis(data_dir, tmp_path):
    """build-index FLAT -> pipeline --cigar --qual --mapq on the planted
    reads through both CLIs: every SAM line equal (all three primaries
    agree here), the CIGARs test_cigar.py expects."""
    from deepreadmapper_tpu import cli as jcli
    from deepreadmapper_tpu_torch import cli as tcli

    fna = str(data_dir / "ecoli_150.fna")
    fq = str(tmp_path / "r.fastq")
    genome = _indel_fastq(data_dir, fq)
    sams = {}
    for tag, cli, dev in (("jax", jcli, ()), ("torch", tcli, ("--device", "cpu"))):
        idx, out = str(tmp_path / f"{tag}_idx"), str(tmp_path / f"{tag}_out")
        assert cli.main(["build-index", fna, idx, "150", "--index-type", "FLAT", *dev]) == 0
        assert cli.main(["pipeline", idx, fq, fna, "4", "4", "4", out, "--cigar",
                         "--qual", "--mapq", *dev]) == 0
        sams[tag] = _sam(os.path.join(out, "results.sam"))
    assert sams["torch"] == sams["jax"]
    prim = {name: lines[0] for name, lines in sams["torch"].items()}
    assert prim["ins_del"][5] == "30M1I30M1D89M" and prim["ins_del"][3] == "101"
    assert int(prim["rev"][1]) & 16 and prim["rev"][5] == "150M"
    assert prim["rev"][9] == genome[300:450]
    assert "1I" in prim["rev_indel"][5] and "1D" in prim["rev_indel"][5]
    assert all(f[11].startswith("NM:i:") for f in prim.values())
