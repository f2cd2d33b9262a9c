"""The SAM options of the port's pipeline against the JAX package's:
--mapq, --mapq-calibrated, --qual, --sort, --mark-duplicates, --read-group
and --bam through both CLIs on test_mapq.py's planted-repeat genome; BAM
bytes from one SAM; the streamed SAM (use_streaming) against the one-shot
SAM and against the JAX package's streamed SAM.

SAMs are compared per read.  Where the two packages' primaries agree (same
RNAME, POS, strand), every field of the primary line is equal except MAPQ,
which may differ by at most 1: MAPQ is float64 arithmetic on fp32
distances, and the two encoders' distances differ by their fp32 noise
(ROADMAP Queue C, rule C2).  The count of agreeing reads is asserted."""

import os

import numpy as np
import pytest
import torch

from deepreadmapper_tpu_torch.pipeline import search as tsearch
from jax_native_guard import _jax_native_loaded  # noqa: F401  (module fixture)

REF_LEN = 150
RG = "ID:rg1,SM:sampleA,PL:ILLUMINA"


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def repeat_genome(tmp_path_factory):
    """test_mapq.py's genome (3,000 bp, an exact 200 bp repeat planted at
    2000 from 500) with its two reads, one of them twice (a duplicate), and
    20 seeded reads of either strand with varying qualities."""
    rng = np.random.default_rng(11)
    g = rng.choice(list("ACGT"), size=3000)
    g[2000:2200] = g[500:700]
    genome = "".join(g)
    d = tmp_path_factory.mktemp("samopt")
    ref = str(d / "ref.fna")
    with open(ref, "w") as f:
        f.write("> repeatref\n")
        for i in range(0, len(genome), 80):
            f.write(genome[i:i + 80] + "\n")
    comp = str.maketrans("ACGT", "TGCA")
    reads = [("rep", genome[520:670]), ("uniq", genome[1000:1150]),
             ("uniq_dup", genome[1000:1150])]
    rng = np.random.default_rng(12)
    for i in range(20):
        s = int(rng.integers(0, 3000 - REF_LEN))
        r = genome[s:s + REF_LEN]
        reads.append((f"r{i}", r.translate(comp)[::-1] if i % 2 else r))
    fq = str(d / "reads.fastq")
    with open(fq, "w") as f:
        for j, (name, seq) in enumerate(reads):
            qual = "".join(chr(35 + (i * 7 + j) % 38) for i in range(len(seq)))
            f.write(f"@{name}\n{seq}\n+\n{qual}\n")
    return ref, fq, d


def _sam(path):
    """(header lines, read name -> its SAM lines as fields, in order)."""
    header, reads = [], {}
    for ln in open(path):
        if ln.startswith("@"):
            header.append(ln.rstrip("\n"))
        else:
            f = ln.rstrip("\n").split("\t")
            reads.setdefault(f[0], []).append(f)
    return header, reads


def _primary(lines):
    return next(f for f in lines if not int(f[1]) & 0x100)


def _compare_per_read(got, want, min_agree):
    """Primary lines equal field by field (MAPQ within 1) where the two
    primaries agree; returns the number that agree."""
    assert set(got) == set(want)
    agree = 0
    for name in want:
        g, w = _primary(got[name]), _primary(want[name])
        if (g[2], g[3], int(g[1]) & 16) != (w[2], w[3], int(w[1]) & 16):
            continue
        agree += 1
        assert abs(int(g[4]) - int(w[4])) <= 1, (name, g[4], w[4])
        assert g[:4] + g[5:] == w[:4] + w[5:], name
    assert agree >= min_agree, (agree, len(want))
    return agree


def test_sam_options_through_both_clis(repeat_genome):
    """build-index FLAT -> pipeline --mapq --qual --sort --mark-duplicates
    --read-group --bam, and --mapq --mapq-calibrated, through each CLI."""
    from deepreadmapper_tpu import cli as jcli
    from deepreadmapper_tpu_torch import cli as tcli

    ref, fq, d = repeat_genome
    quals = {}
    lines = open(fq).read().splitlines()
    for i in range(0, len(lines), 4):
        quals[lines[i][1:]] = lines[i + 3]
    sams, cal = {}, {}
    for tag, cli, dev in (("jax", jcli, ()), ("torch", tcli, ("--device", "cpu"))):
        idx, out = str(d / f"{tag}_idx"), str(d / f"{tag}_out")
        assert cli.main(["build-index", ref, idx, "150", "--index-type", "FLAT", *dev]) == 0
        assert cli.main(["pipeline", idx, fq, ref, "16", "16", "16", out, "--mapq", "--qual",
                         "--sort", "--mark-duplicates", "--read-group", RG, "--bam", *dev]) == 0
        sams[tag] = _sam(os.path.join(out, "results.sam"))
        assert os.path.exists(os.path.join(out, "results.bam.bai"))
        cal_out = str(d / f"{tag}_cal")
        assert cli.main(["pipeline", idx, fq, ref, "16", "16", "16", cal_out, "--mapq",
                         "--mapq-calibrated", *dev]) == 0
        cal[tag] = _sam(os.path.join(cal_out, "results.sam"))[1]

    (th, tr), (jh, jr) = sams["torch"], sams["jax"]
    n = len(jr)
    _compare_per_read(tr, jr, n - 1)  # "rep" ties two loci exactly
    assert [h for h in th if not h.startswith("@PG")] == \
        [h for h in jh if not h.startswith("@PG")]
    assert "@RG\tID:rg1\tSM:sampleA\tPL:ILLUMINA" in th and "SO:coordinate" in th[0]
    # the port's own SAM: sorted, RG on every line, QUAL from the FASTQ,
    # the repeat read at MAPQ 0, one of the duplicate pair marked
    rows = [f for v in tr.values() for f in v]
    assert all(f[-1] == "RG:Z:rg1" for f in rows)
    assert all(f[10] == quals[f[0]] for f in rows)
    assert _primary(tr["rep"])[4] == "0" and int(_primary(tr["uniq"])[4]) >= 50
    dups = [int(_primary(tr[nm])[1]) & 0x400 for nm in ("uniq", "uniq_dup")]
    assert sorted(dups) == [0, 0x400]
    out = str(repeat_genome[2] / "torch_out" / "results.sam")
    keys = [(int(ln.split("\t")[3])) for ln in open(out) if not ln.startswith("@")]
    assert keys == sorted(keys)
    # --mapq-calibrated: the table applied to the raw margin MAPQ, per read
    _compare_per_read(cal["torch"], cal["jax"], n - 1)
    raw = np.array([int(_primary(tr[nm])[4]) for nm in sorted(tr)])
    got = np.array([int(_primary(cal["torch"][nm])[4]) for nm in sorted(tr)])
    np.testing.assert_array_equal(got, tsearch.calibrate_mapq(raw))


def test_sam_to_bam_bytes_equal_jax(repeat_genome, tmp_path):
    """One sorted SAM with tags, RG and qualities -> BAM and BAI files
    byte-identical in both packages."""
    from deepreadmapper_tpu.io.bam import sam_to_bam as jbam
    from deepreadmapper_tpu_torch.io.bam import sam_to_bam as tbam
    from deepreadmapper_tpu_torch.io import sam as sam_io

    ref, fq, d = repeat_genome
    sam = str(tmp_path / "in.sam")
    lines = [
        "@HD\tVN:1.0\tSO:unsorted", "@SQ\tSN:ref\tLN:3000", "@RG\tID:rg1\tSM:s",
        "a\t0\tref\t101\t60\t30M1I30M1D89M\t*\t0\t0\t" + "A" * 150 + "\t" + "I" * 150
        + "\tNM:i:2\tMD:Z:60^C89\tAS:i:280\tRG:Z:rg1",
        "b\t16\tref\t7\t37\t5S140M5S\t*\t0\t0\t" + "CGTN" * 37 + "AC\t*\tRG:Z:rg1",
        "c\t256\tref\t2500\t0\t150M\t*\t0\t0\t" + "T" * 150 + "\t*\tRG:Z:rg1",
        "d\t4\t*\t0\t0\t*\t*\t0\t0\t" + "G" * 150 + "\t*\tRG:Z:rg1",
    ]
    with open(sam, "w") as f:
        f.write("\n".join(lines) + "\n")
    sam_io.sort_sam_file(sam)
    jbam(sam, str(tmp_path / "j.bam"), bai_path=str(tmp_path / "j.bam.bai"))
    tbam(sam, str(tmp_path / "t.bam"), bai_path=str(tmp_path / "t.bam.bai"))
    for suffix in (".bam", ".bam.bai"):
        a = open(tmp_path / ("j" + suffix), "rb").read()
        b = open(tmp_path / ("t" + suffix), "rb").read()
        assert a == b and len(a) > 28, suffix


@pytest.fixture(scope="module")
def fixture_index(tmp_path_factory, data_dir):
    """One INT8FLAT index of the fixture genome, built by the port; both
    packages' pipelines load it (the on-disk format is shared)."""
    from deepreadmapper_tpu_torch.pipeline.build import build_index

    prefix = str(tmp_path_factory.mktemp("stream") / "idx")
    build_index(str(data_dir / "ecoli_150.fna"), prefix, REF_LEN, device="cpu")
    return prefix


def test_streaming_sam_equals_one_shot_and_jax(fixture_index, data_dir, tmp_path):
    """use_streaming at query_batch_size 64 (three batches of the 150
    reads), with --mapq --cigar --qual --read-group: the port's streamed
    SAM equals its one-shot SAM byte for byte, and the JAX package's
    streamed SAM per read (at least 145 of 150 primaries agree)."""
    from deepreadmapper_tpu.config import SearchConfig as JCfg
    from deepreadmapper_tpu.models.encoder import Vectorizer as JVec
    from deepreadmapper_tpu.pipeline.search import run_pipeline as jrun
    from deepreadmapper_tpu_torch.config import SearchConfig as TCfg

    fq, fna = str(data_dir / "test_data.fastq"), str(data_dir / "ecoli_150.fna")
    opts = dict(k=8, mapq=True, cigar=True, qual=True, read_group=RG)
    outs = {}
    for streaming in (True, False):
        out = str(tmp_path / f"t{int(streaming)}")
        tsearch.run_pipeline(fixture_index, fq, fna, output_dir=out, use_streaming=streaming,
                             search_cfg=TCfg(query_batch_size=64), device="cpu", **opts)
        outs[streaming] = open(os.path.join(out, "results.sam"), "rb").read()
    assert outs[True] == outs[False]
    assert not os.path.exists(tmp_path / "t1" / "indices.npy")  # a streamed run: SAM only
    assert outs[True].count(b"\n") == 150 * 8 + 4

    jout = str(tmp_path / "jax")
    jrun(fixture_index, fq, fna, output_dir=jout, use_streaming=True,
         search_cfg=JCfg(query_batch_size=64), vectorizer=JVec(device_batch=256), **opts)
    _, jr = _sam(os.path.join(jout, "results.sam"))
    _, tr = _sam(str(tmp_path / "t1" / "results.sam"))
    _compare_per_read(tr, jr, 145)
