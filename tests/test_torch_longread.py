"""Long-read mapping in the port (pipeline/longread.py, run_pipeline's
long-read path, pipeline --long-reads) against the JAX package's, on the
same inputs.

chunk_read, chain_votes (and its dict oracle) and banded_primary_cigars
are the same host code in both packages (numpy, the native banded
aligner), so they are held with np.array_equal.  map_long_reads runs each
package's encoder (#1's plain version here) and INT8FLAT engine on one
index: its top-1 ids, MAPQ and supplementary segments must be equal, and
its distances (1 - chunk support) within 1e-6: support sums rank weights
of int8 distances, which the two encoders' fp32 noise could reorder (rules
C2, C3).  The SAMs are compared per read: FLAG, RNAME, POS, CIGAR, RNEXT,
PNEXT and TLEN of each primary equal, MAPQ within 1, supplementary lines
equal; the count of reads that differ is stated, and here it is zero."""

import functools
import os
import re

import numpy as np
import pytest
import torch

from deepreadmapper_tpu.pipeline import longread as jlr
from deepreadmapper_tpu_torch import native
from deepreadmapper_tpu_torch.pipeline import longread as tlr
from jax_native_guard import _jax_native_loaded  # noqa: F401  (module fixture)

REF_LEN = 150
_COMP = str.maketrans("ACGT", "TGCA")


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("ref_len,max_chunks", [(150, 128), (150, 16), (100, 2), (121, 1)])
def test_chunk_read_equals_jax(ref_len, max_chunks):
    for read_len in (1, 99, 100, 121, 150, 151, 225, 226, 400, 1_000, 5_000, 9_700,
                     20_000, 100_003):
        got = tlr.chunk_read(read_len, ref_len, max_chunks)
        assert got == jlr.chunk_read(read_len, ref_len, max_chunks), read_len
        assert got[0] == 0 and got[-1] == max(0, read_len - ref_len)


def _vote_grids(seed, trials):
    """tests/test_longread.py's chain grids: a true start plus jitter on
    either strand, 40% noise hits, 10% pad slots; every third grid has
    distances quantized to three values (exact rank and weight ties); the
    all-pad and single-entry shapes; and a repeat that ties two loci."""
    rng = np.random.default_rng(seed)
    cases = []
    for trial in range(trials):
        n_ch = int(rng.integers(1, 30))
        kc = int(rng.integers(1, 9))
        offs = np.arange(n_ch) * 75
        true_start = int(rng.integers(0, 5000))
        ids = 2 * (true_start + offs[:, None] + rng.integers(-4, 5, (n_ch, kc))) \
            + rng.integers(0, 2, (n_ch, kc))
        noise = rng.random((n_ch, kc)) < 0.4
        ids = np.where(noise, 2 * rng.integers(0, 5000, (n_ch, kc)), ids)
        ids[rng.random((n_ch, kc)) < 0.1] = -1
        if trial % 3 == 0:
            d = rng.integers(0, 3, (n_ch, kc)).astype(np.float64)
        else:
            d = rng.random((n_ch, kc))
        cases.append((ids, d, offs, 150, 150 + 75 * (n_ch - 1), int(rng.integers(1, 5)),
                      int(rng.choice([1, 20, 75]))))
    cases.append((np.full((3, 4), -1), np.ones((3, 4)), np.arange(3) * 75, 150, 300, 4, 75))
    cases.append((np.array([[2000]]), np.array([[0.5]]), np.zeros(1, np.int64), 150, 150, 4, 75))
    cases.append((np.array([[2000, 10000], [2150, 10150]]), np.ones((2, 2)),
                  np.array([0, 75]), 150, 225, 4, 75))
    return cases


@pytest.mark.parametrize("seed", [3, 17])
def test_chain_votes_equals_jax_and_the_oracle(seed):
    """The port's chain_votes equals the JAX package's exactly (ids,
    support, chunk count, coverage), its dict oracle equals the JAX
    oracle exactly, and chain_votes stays within the oracle's documented
    divergence (float summation order: starts within 1 base)."""
    for ids, d, offs, c, L, k, tol in _vote_grids(seed, 60):
        got = tlr.chain_votes(ids, d, offs, c, L, k, tol)
        want = jlr.chain_votes(ids, d, offs, c, L, k, tol)
        ref_got = tlr._chain_votes_ref(ids, d, offs, c, L, k, tol)
        ref_want = jlr._chain_votes_ref(ids, d, offs, c, L, k, tol)
        for a, b in ((got, want), (ref_got, ref_want)):
            assert a[2] == b[2]
            for x, y in zip((a[0], a[1], a[3]), (b[0], b[1], b[3])):
                assert x.dtype == y.dtype
                np.testing.assert_array_equal(x, y)
        pad = got[0] == -1
        np.testing.assert_array_equal(pad, ref_got[0] == -1)
        assert np.all(np.abs((got[0][~pad] >> 1) - (ref_got[0][~pad] >> 1)) <= 1)


def test_int8flat_search_past_one_query_batch_equals_jax():
    """A long-read chunk batch passes the engines' 8192-query slice: both
    packages quantize the whole batch with one scale (here set by a query
    in the second slice that exceeds the code scale, so the ratio is not 1)
    and search it in 8192-query slices; ids and distances equal (rule C1)."""
    from deepreadmapper_tpu.index import int8_flat as jint8
    from deepreadmapper_tpu_torch.index import int8_flat as tint8

    rng = np.random.default_rng(8)
    ref = np.tanh(rng.standard_normal((3_000, 128))).astype(np.float32)
    q = np.tanh(rng.standard_normal((8_192 + 700, 128))).astype(np.float32)
    q[8_500, :3] = 2.5
    jidx = jint8.Int8FlatIndex.build(ref)
    tidx = tint8.Int8FlatIndex(np.asarray(jidx.codes), jidx.scale, jidx.ntotal, device="cpu")
    assert tint8.query_scale_ratio(q, jidx.scale)[1] > 1
    ji, jd = jidx.search(q, 8)
    ti, td = tidx.search(q, 8)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(td, jd)


def _indel_read(genome, s, n, strand):
    """genome[s:s+n] with 2 bases inserted and 3 deleted, on a strand."""
    src = genome[s:s + n]
    read = src[:n // 3] + "TT" + src[n // 3: 2 * n // 3] + src[2 * n // 3 + 3:]
    return read.translate(_COMP)[::-1] if strand else read


@pytest.mark.parametrize("multi", [False, True])
def test_banded_primary_cigars_equal_jax(multi):
    """Planted indels on both strands at the true start and a few bases
    off, one read past a record's end (the segment clips), an invalid
    primary: the same CIGARs, POS offsets and NM/MD/AS tags, on one record
    and on the genome cut into two."""
    from deepreadmapper_tpu.io import fasta as jfasta

    assert native.available()
    rng = np.random.default_rng(2)
    genome = "".join(rng.choice(list("ACGT"), size=12_000))
    g = np.frombuffer(genome.encode(), np.uint8)
    reads, ids = [], []
    for i, (s, n) in enumerate([(500, 1_200), (3_000, 2_000), (7_000, 900), (9_500, 1_500),
                                (5_860, 300)]):
        strand = i % 2
        reads.append(_indel_read(genome, s, n, strand))
        ids.append(2 * (s + (0, 3, -4, 0, 0)[i]) + strand)
    reads.append(_indel_read(genome, 2_000, 600, 0))
    ids.append(-1)
    kw = {}
    if multi:
        records = [g[:6_000], g[6_000:]]
        dense_off, base_off = jfasta.record_window_table(records, REF_LEN, 1)
        kw = dict(dense_off=dense_off, base_off=base_off)
        # dense ids count each record's windows: the second record starts
        # after the first's 5,851
        ids = [i if i < 0 or (i >> 1) < 6_000 else i - 2 * (6_000 - int(dense_off[1]))
               for i in ids]
    ids = np.array(ids, np.int64)
    got = tlr.banded_primary_cigars(reads, ids, g, REF_LEN, **kw)
    want = jlr.banded_primary_cigars(reads, ids, g, REF_LEN, **kw)
    assert got[0] == want[0] and got[2] == want[2]
    np.testing.assert_array_equal(got[1], want[1])
    assert got[0][-1] == ""
    # each read's 2 inserted and 3 deleted bases (the one that runs past a
    # record's end aligns what its clipped segment holds)
    for cigar in got[0][:4 if multi else 5]:
        runs = re.findall(r"(\d+)([MIDS])", cigar)
        assert [sum(int(n) for n, o in runs if o == op) for op in "ID"] == [2, 3], cigar


def _mutate(seq, err, rng, indel_frac=0.4):
    """scripts/eval_longread.py's error model: per base, a deletion, an
    insertion or a substitution, 40% of the error budget on indels."""
    indel, sub = err * indel_frac, err * (1 - indel_frac)
    out = []
    for ch in seq:
        r = rng.random()
        if r < indel / 2:
            continue
        if r < indel:
            out.append(rng.choice(list("ACGT")))
            out.append(ch)
            continue
        out.append(rng.choice([b for b in "ACGT" if b != ch]) if r < indel + sub else ch)
    return "".join(out)


def _write_fasta(path, records):
    with open(path, "w") as f:
        for name, seq in records:
            f.write(f"> {name}\n")
            for i in range(0, len(seq), 80):
                f.write(seq[i:i + 80] + "\n")


def _write_fastq(path, reads):
    with open(path, "w") as f:
        for name, seq in reads:
            f.write(f"@{name}\n{seq}\n+\n{'I' * len(seq)}\n")


@pytest.fixture(scope="module")
def lr_setup(tmp_path_factory):
    """tests/test_longread.py's genome (20 kb, seed 3) as one INT8FLAT
    index built by the port (both packages load it), and long reads of 1.2
    to 5 kb on both strands at 1% error (40% indels), plus one chimera
    (900 bp of one locus, 600 of another)."""
    from deepreadmapper_tpu_torch.pipeline.build import build_index

    rng = np.random.default_rng(3)
    genome = "".join(rng.choice(list("ACGT"), size=20_000))
    d = tmp_path_factory.mktemp("tlr")
    ref = str(d / "ref.fna")
    _write_fasta(ref, [("lr", genome)])
    prefix = str(d / "idx")
    build_index(ref, prefix, REF_LEN, index_type="INT8FLAT", device="cpu")
    rng = np.random.default_rng(5)
    reads, truth = [], []
    for i, (s, n) in enumerate([(200, 1_200), (5_000, 5_000), (11_111, 2_500), (17_000, 1_500),
                                (13_000, 3_000)]):
        seq = _mutate(genome[s:s + n], 0.01, rng)
        reads.append((f"r{i}", seq.translate(_COMP)[::-1] if i % 2 else seq))
        truth.append((s, i % 2))
    reads.append(("chim", _mutate(genome[2_000:2_900] + genome[12_000:12_600], 0.005, rng)))
    fq = str(d / "lr.fastq")
    _write_fastq(fq, reads)
    return {"genome": genome, "ref": ref, "idx": prefix, "fq": fq, "reads": reads,
            "truth": truth, "d": d}


def test_map_long_reads_matches_jax(lr_setup):
    """map_long_reads with each package's Vectorizer and INT8FLAT engine on
    one index: top-1 ids, MAPQ and supplementary segments equal, distances
    within 1e-6; every read at its true locus and strand."""
    from deepreadmapper_tpu.index.registry import load_index as jload
    from deepreadmapper_tpu.models.encoder import Vectorizer as JVec
    from deepreadmapper_tpu_torch.index.registry import load_index as tload
    from deepreadmapper_tpu_torch.models.encoder import Vectorizer as TVec

    seqs = [s for _, s in lr_setup["reads"]]
    jeng, _ = jload(lr_setup["idx"])
    teng, _ = tload(lr_setup["idx"], "cpu")
    timings = {}
    got = tlr.map_long_reads(seqs, TVec(device="cpu"), teng, REF_LEN, k=4, ef=128,
                             timings=timings)
    want = jlr.map_long_reads(seqs, JVec(device_batch=512), jeng, REF_LEN, k=4, ef=128)
    np.testing.assert_array_equal(got[0][:, 0], want[0][:, 0])
    np.testing.assert_array_equal(got[2], want[2])
    assert got[3] == want[3] and list(got[3]) == [len(seqs) - 1]  # the chimera alone
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-6)
    assert set(timings) == {"host_pack", "embed", "search", "chain"}
    for i, (s, strand) in enumerate(lr_setup["truth"]):
        top = int(got[0][i, 0])
        assert top & 1 == strand and abs((top >> 1) - s) <= 5, (i, top)
        assert got[2][i] >= 40


def _sam_reads(path):
    reads = {}
    for ln in open(path):
        if not ln.startswith("@"):
            f = ln.rstrip("\n").split("\t")
            reads.setdefault(f[0], []).append(f)
    return reads


def _differing_reads(got, want):
    """Reads whose primary differs in FLAG, RNAME, POS, CIGAR, RNEXT, PNEXT
    or TLEN, or in MAPQ by more than 1, or whose supplementary lines
    differ."""
    assert set(got) == set(want)
    bad = []
    for name in want:
        g = next(f for f in got[name] if not int(f[1]) & 0x900)
        w = next(f for f in want[name] if not int(f[1]) & 0x900)
        sup = [[f for f in lines if int(f[1]) & 0x800] for lines in (got[name], want[name])]
        if (g[1:4] + g[5:9] != w[1:4] + w[5:9] or abs(int(g[4]) - int(w[4])) > 1
                or sup[0] != sup[1]):
            bad.append(name)
    return bad


@pytest.fixture
def small_jax_batches(monkeypatch):
    """The JAX pipeline embeds with 512-row device batches instead of 8192:
    it pads every batch to that size, and on the CPU the padding is most of
    the time.  Batching does not change what the encoder computes."""
    from deepreadmapper_tpu.models.encoder import Vectorizer
    from deepreadmapper_tpu.pipeline import search as jsearch

    monkeypatch.setattr(jsearch, "Vectorizer", functools.partial(Vectorizer, device_batch=512))


def _reconstruct(seq, cigar, md):
    """SEQ + CIGAR + MD -> the reference bases they align to."""
    aligned, si = [], 0
    for n, op in re.findall(r"(\d+)([MIDS])", cigar):
        n = int(n)
        if op == "M":
            aligned.append(seq[si:si + n])
        if op in "MIS":
            si += n
    qa, out, qi = "".join(aligned), [], 0
    for tok in re.findall(r"(\d+|\^[A-Z]+|[A-Z])", md):
        if tok.isdigit():
            out.append(qa[qi:qi + int(tok)])
            qi += int(tok)
        elif tok.startswith("^"):
            out.append(tok[1:])
        else:
            out.append(tok)
            qi += 1
    return "".join(out)


@pytest.mark.parametrize("extra", [["--cigar", "--mapq"], ["--mapq", "--lr-max-chunks", "8"]])
def test_long_reads_cli_matches_jax_cli(lr_setup, tmp_path, small_jax_batches, extra):
    """pipeline --long-reads through both CLIs on one index, with --cigar
    --mapq and with --lr-max-chunks 8: no read differs, indices.npy and
    distances.npy agree; with --cigar every primary's SEQ + CIGAR + MD
    rebuilds the genome at POS."""
    from deepreadmapper_tpu import cli as jcli
    from deepreadmapper_tpu_torch import cli as tcli

    outs = {}
    for tag, cli, dev in (("jax", jcli, []), ("torch", tcli, ["--device", "cpu"])):
        outs[tag] = str(tmp_path / tag)
        assert cli.main(["pipeline", lr_setup["idx"], lr_setup["fq"], lr_setup["ref"], "64",
                         "4", "5", outs[tag], "--long-reads", *extra, *dev]) == 0
    got, want = (_sam_reads(os.path.join(outs[t], "results.sam")) for t in ("torch", "jax"))
    bad = _differing_reads(got, want)
    assert len(bad) == 0, f"{len(bad)} of {len(want)} reads differ: {bad}"
    ti, ji = (np.load(os.path.join(outs[t], "indices.npy")) for t in ("torch", "jax"))
    np.testing.assert_array_equal(ti[:, 0], ji[:, 0])
    td, jd = (np.load(os.path.join(outs[t], "distances.npy")) for t in ("torch", "jax"))
    np.testing.assert_allclose(td, jd, rtol=0, atol=1e-6)
    assert sum(int(f[1]) & 0x800 != 0 for v in got.values() for f in v) == 1
    if "--cigar" in extra:
        genome = lr_setup["genome"]
        for name, lines in got.items():
            p = next(f for f in lines if not int(f[1]) & 0x900)
            tags = dict(t.split(":", 2)[::2] for t in p[11:])
            if name == "chim":
                continue  # its banded alignment runs past the junction
            pos, rebuilt = int(p[3]), _reconstruct(p[9], p[5], tags["MD"])
            assert rebuilt == genome[pos - 1: pos - 1 + len(rebuilt)], name


def test_long_reads_sparse_multirecord_matches_jax(lr_setup, tmp_path, small_jax_batches):
    """run_pipeline(long_reads=True) on a stride-4 index of the genome cut
    into two records: the sparse hop (window -> base) and the record hops
    (base -> record-local dense id) in both packages; no read differs, and
    each read lands in its record near its start."""
    from deepreadmapper_tpu.pipeline.search import run_pipeline as jrun
    from deepreadmapper_tpu_torch.pipeline.build import build_index
    from deepreadmapper_tpu_torch.pipeline.search import run_pipeline as trun

    genome = lr_setup["genome"][:12_000]
    ref = str(tmp_path / "multi.fna")
    _write_fasta(ref, [("chrA", genome[:5_000]), ("chrB", genome[5_000:])])
    prefix = str(tmp_path / "idx4")
    build_index(ref, prefix, REF_LEN, stride=4, index_type="INT8FLAT", device="cpu")
    rng = np.random.default_rng(13)
    truth = [("chrA", 1_000, 0), ("chrB", 2_000, 1), ("chrB", 5_500, 0)]
    reads = []
    for i, (rec, s, strand) in enumerate(truth):
        g0 = s + (5_000 if rec == "chrB" else 0)
        seq = _mutate(genome[g0:g0 + 1_200], 0.01, rng)
        reads.append((f"m{i}", seq.translate(_COMP)[::-1] if strand else seq))
    fq = str(tmp_path / "m.fastq")
    _write_fastq(fq, reads)
    jrun(prefix, fq, ref, k=4, output_dir=str(tmp_path / "j"), long_reads=True, cigar=True)
    res = trun(prefix, fq, ref, k=4, output_dir=str(tmp_path / "t"), long_reads=True,
               cigar=True, device="cpu")
    assert set(res["t_lr_split"]) == {"host_pack", "embed", "search", "chain"}
    got, want = (_sam_reads(str(tmp_path / t / "results.sam")) for t in ("t", "j"))
    bad = _differing_reads(got, want)
    assert len(bad) == 0, f"{len(bad)} of {len(want)} reads differ: {bad}"
    for i, (rec, s, strand) in enumerate(truth):
        p = next(f for f in got[f"m{i}"] if not int(f[1]) & 0x900)
        assert p[2] == rec and bool(int(p[1]) & 16) == bool(strand)
        assert abs(int(p[3]) - (s + 1)) <= 8, (i, p[3], s)
