"""Paired-end mapping in the port (pipeline/paired.py, run_pipeline_paired,
the paired CLI flags and serve's fastq2 requests) against the JAX
package's, on the same inputs.

resolve_pairs and rescue_mates are exact host arithmetic (numpy, the
native SW scorer) in both packages, so they are held with
np.array_equal.  The paired SAMs come from the two packages' single-end
candidates, so they are compared per read: FLAG, RNAME, POS, CIGAR, RNEXT,
PNEXT and TLEN equal, MAPQ within 1 (rule C2: the encoders' fp32 noise);
every test states the count of reads that differ, and on these fixtures
it is zero."""

import functools
import io
import json
import os

import numpy as np
import pytest
import torch

from deepreadmapper_tpu.pipeline import paired as jpaired
from deepreadmapper_tpu_torch import native
from deepreadmapper_tpu_torch.pipeline import paired as tpaired
from jax_native_guard import _jax_native_loaded  # noqa: F401  (module fixture)

REF_LEN = 150
ISIZE = 500
_COMP = str.maketrans("ACGT", "TGCA")


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _pair_grid(seed, n, k1, k2, multi):
    """Seeded candidate grids: true FR pairs (either end forward), wrong
    orientations, dovetails, pairs beyond max_isize, exact score ties,
    invalid slots, and pairs straddling a record boundary."""
    rng = np.random.default_rng(seed)
    p1 = rng.integers(0, 9_000, n)
    rev1 = rng.integers(0, 2, n)
    isz = rng.integers(200, 1_200, n)
    p2 = np.where(rev1 == 0, p1 + isz - REF_LEN, p1 - isz + REF_LEN)
    ids1 = 2 * (p1[:, None] + rng.choice([0, 0, 3, 400, -5000], (n, k1))) + rev1[:, None]
    ids2 = 2 * (p2[:, None] + rng.choice([0, 0, -2, 300, 6000], (n, k2))) + (1 - rev1)[:, None]
    ids1 ^= (rng.random((n, k1)) < 0.2).astype(np.int64)  # wrong strand
    ids2 ^= (rng.random((n, k2)) < 0.2).astype(np.int64)
    ids1 = np.maximum(ids1, 0)
    ids2 = np.maximum(ids2, 0)
    ids1[rng.random((n, k1)) < 0.08] = -1
    ids2[rng.random((n, k2)) < 0.08] = -1
    d1 = np.round(rng.random((n, k1)) * 4, 1)  # one decimal: exact ties
    d2 = np.round(rng.random((n, k2)) * 4, 1)
    l1 = rng.choice([150, 150, 120], n)
    l2 = rng.choice([150, 150, 101], n)
    dense_off = np.array([0, 4_000, 4_900, 20_000], np.int64) if multi else None
    return ids1, d1, ids2, d2, l1, l2, dense_off


# tests/test_paired.py's cases: (ids1, d1, ids2, d2, max_isize, dense_off)
_NAMED = {
    "proper_fr_over_better_noise": ([[18000, 2000]], [[1.0, 2.0]],
                                    [[2601, 10000]], [[2.0, 1.5]], 1000, None),
    "wrong_orientation_and_distance": ([[2000], [2000]], [[1.0], [1.0]],
                                       [[2600], [180001]], [[1.0], [1.0]], 1000, None),
    "repeat_pair_mapq": ([[2000, 14000]], [[1.0, 1.0]], [[2801]], [[1.0]], 1000, None),
    "dovetail_rf": ([[2000]], [[1.0]], [[1801]], [[1.0]], 1000, None),
    "tandem_repeat_mate": ([[2000]], [[1.0]], [[2601, 3201]], [[1.0, 1.0]], 1000, None),
    "cross_record": ([[2300]], [[1.0]], [[2501]], [[1.0]], 1000, [0, 1200, 3000]),
}


def _assert_pairs_equal(got, want):
    assert set(got) == set(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("name", sorted(_NAMED))
def test_resolve_pairs_named_cases_equal_jax(name):
    ids1, d1, ids2, d2, max_isize, dense_off = _NAMED[name]
    n = len(ids1)
    args = (np.array(ids1), np.array(d1), np.array(ids2), np.array(d2), [150] * n,
            [150] * n, max_isize)
    kw = dict(ref_len=REF_LEN,
              dense_off=None if dense_off is None else np.array(dense_off))
    _assert_pairs_equal(tpaired.resolve_pairs(*args, **kw), jpaired.resolve_pairs(*args, **kw))


@pytest.mark.parametrize("k1,k2,multi,min_isize,sw", [
    (1, 1, False, 0, False), (4, 8, False, 0, False), (16, 16, True, 0, False),
    (8, 4, False, 300, True), (16, 16, True, 250, True),
])
def test_resolve_pairs_random_grids_equal_jax(monkeypatch, k1, k2, multi, min_isize, sw):
    """Random grids at several k, both score senses (SW scores are negated
    into ascending order, as run_pipeline_paired does), min_isize, multiple
    records, and blocks small enough that a grid spans several."""
    ids1, d1, ids2, d2, l1, l2, dense_off = _pair_grid(k1 * 31 + k2 + multi, 600, k1, k2, multi)
    if sw:
        d1, d2 = -np.round(d1 * 40), -np.round(d2 * 40)
    for mod in (jpaired, tpaired):
        monkeypatch.setattr(mod, "_BLOCK_ELEMS", 64 * k1 * k2)  # 64 pairs a block
    args = (ids1, d1, ids2, d2, l1, l2, 1_000, min_isize, REF_LEN, dense_off)
    got, want = tpaired.resolve_pairs(*args), jpaired.resolve_pairs(*args)
    _assert_pairs_equal(got, want)
    assert 0 < want["proper"].sum() < len(ids1)  # both outcomes occur
    if k1 > 1:  # a competing locus for R1 exists only with more than one candidate
        assert 0 < np.sum(want["mapq1"] == 60) < want["proper"].sum()


def test_end_same_locus_equal_jax():
    ids1, _, _, _, _, _, dense_off = _pair_grid(5, 300, 8, 8, True)
    chosen = ids1[:, 0]
    for off in (None, dense_off):
        np.testing.assert_array_equal(tpaired._end_same_locus(ids1, chosen, REF_LEN, off),
                                      jpaired._end_same_locus(ids1, chosen, REF_LEN, off))


@pytest.fixture(scope="module")
def pe_setup(tmp_path_factory):
    """tests/test_paired.py's genome (20 kb, seed 7, a 150 bp repeat of
    2000 planted at 15000) as one FLAT index built by the port (both
    packages load it: the on-disk format is shared), and a FASTQ pair:
    twelve seeded FR pairs (insert 500), two from the repeat, reads of
    either orientation, 1% substitutions, and one pair whose R2 carries
    100 junk bases before the mate, which only the SW rescue places."""
    from deepreadmapper_tpu_torch.pipeline.build import build_index

    rng = np.random.default_rng(7)
    g = rng.choice(list("ACGT"), size=20_000)
    g[15_000:15_150] = g[2_000:2_150]
    genome = "".join(g)
    d = tmp_path_factory.mktemp("tpe")
    ref = str(d / "ref.fna")
    with open(ref, "w") as f:
        f.write("> pe\n")
        for i in range(0, len(genome), 80):
            f.write(genome[i:i + 80] + "\n")
    prefix = str(d / "idx")
    build_index(ref, prefix, REF_LEN, index_type="FLAT", device="cpu")

    rng = np.random.default_rng(11)
    starts = [2_000, 15_000] + [int(s) for s in rng.integers(0, 19_000 - ISIZE, 10)]

    def noisy(s):
        a = np.array(list(s))
        m = rng.random(a.size) < 0.01
        a[m] = rng.choice(list("ACGT"), int(m.sum()))
        return "".join(a)

    r1, r2 = [], []
    for i, s in enumerate(starts):
        a, b = noisy(genome[s:s + REF_LEN]), noisy(genome[s + ISIZE - REF_LEN:s + ISIZE])
        b = b.translate(_COMP)[::-1]
        if i % 3 == 2:  # the reverse end first: R1 reverse, R2 forward
            a, b = b, a
        r1.append((f"p{i}", a))
        r2.append((f"p{i}", b))
    junk = "".join(rng.choice(list("ACGT"), size=100))
    r1.append(("m0", genome[6_000:6_150]))
    r2.append(("m0", junk + genome[6_350:6_500].translate(_COMP)[::-1]))
    f1, f2, inter = str(d / "r1.fastq"), str(d / "r2.fastq"), str(d / "inter.fastq")
    qual = "".join(chr(35 + i % 38) for i in range(250))
    with open(f1, "w") as o1, open(f2, "w") as o2, open(inter, "w") as oi:
        for (n1, s1), (n2, s2) in zip(r1, r2):
            rec1, rec2 = (f"@{n1}/1\n{s1}\n+\n{qual[:len(s1)]}\n",
                          f"@{n2}/2\n{s2}\n+\n{qual[:len(s2)]}\n")
            o1.write(rec1)
            o2.write(rec2)
            oi.write(rec1 + rec2)
    return {"genome": genome, "ref": ref, "idx": prefix, "f1": f1, "f2": f2,
            "inter": inter, "d": d}


@pytest.fixture
def small_jax_batches(monkeypatch):
    """The JAX pipeline embeds with 512-row device batches instead of 8192:
    it pads every batch to that size, and on the CPU the padding is most of
    the time.  Batching does not change what the encoder computes."""
    from deepreadmapper_tpu.models.encoder import Vectorizer
    from deepreadmapper_tpu.pipeline import search as jsearch

    monkeypatch.setattr(jsearch, "Vectorizer", functools.partial(Vectorizer, device_batch=512))


def test_rescue_mates_equals_jax(pe_setup):
    """Anchors on both strands next to true mates, shifted anchors, junk
    mates, invalid anchors, a mate longer than the read, min_isize, record
    bounds that clip the scan, and a scan wider than the window budget:
    the same ids and scores.  The native library must be loaded: without
    it rescue_mates returns nothing, which would pass as nothing found."""
    from deepreadmapper_tpu import native as jnative

    assert native.available() and jnative.available()
    genome = pe_setup["genome"]
    g = np.frombuffer(genome.encode(), np.uint8)
    rng = np.random.default_rng(4)
    anchors, mates, lens, bounds = [], [], [], []
    for i in range(40):
        p = int(rng.integers(1_200, 18_000))
        if i % 2 == 0:  # forward anchor: the mate is reverse, to the right
            anchors.append(2 * (p + int(rng.integers(-3, 4))))
            s = p + ISIZE - REF_LEN
            mate = genome[s:s + REF_LEN].translate(_COMP)[::-1]
        else:           # reverse anchor: the mate is forward, to the left
            anchors.append(2 * p + 1)
            mate = genome[p + REF_LEN - ISIZE:p + 2 * REF_LEN - ISIZE]
        if i % 7 == 3:
            mate = "".join(rng.choice(list("ACGT"), size=REF_LEN))
        if i % 11 == 5:
            mate = mate + "ACGTACGTAC"
        mates.append(mate)
        lens.append(REF_LEN)
        bounds.append((0, g.size) if i % 5 else (p - 100, p + 300))
    anchors[7] = -1
    args = (np.array(anchors), mates, np.array(lens), g, 800)
    for kw in ({}, {"min_isize": 300}, {"rec_bounds": np.array(bounds, np.int64)},
               {"max_windows": 16, "stride": 1}):
        got, want = tpaired.rescue_mates(*args, **kw), jpaired.rescue_mates(*args, **kw)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        assert 0 < np.sum(got[0] >= 0) < len(mates)


def _sam_ends(path):
    """(header lines, (name, second-in-pair) -> that end's SAM lines)."""
    header, ends = [], {}
    for ln in open(path):
        if ln.startswith("@"):
            header.append(ln.rstrip("\n"))
            continue
        f = ln.rstrip("\n").split("\t")
        ends.setdefault((f[0], bool(int(f[1]) & 0x80)), []).append(f)
    return header, ends


def _differing_ends(got, want):
    """Ends whose primary differs in FLAG, RNAME, POS, CIGAR, RNEXT, PNEXT or
    TLEN, or in MAPQ by more than 1, or whose supplementary lines differ."""
    assert set(got) == set(want)
    bad = []
    for key in want:
        g = next(f for f in got[key] if not int(f[1]) & 0x900)
        w = next(f for f in want[key] if not int(f[1]) & 0x900)
        sup = [[f for f in lines if int(f[1]) & 0x800] for lines in (got[key], want[key])]
        if (g[1:4] + g[5:9] != w[1:4] + w[5:9] or abs(int(g[4]) - int(w[4])) > 1
                or sup[0] != sup[1]):
            bad.append(key)
    return bad


def _run_clis(pe, tmp_path, argv_tail, interleaved=False):
    from deepreadmapper_tpu import cli as jcli
    from deepreadmapper_tpu_torch import cli as tcli

    q = [pe["inter"]] if interleaved else [pe["f1"]]
    pair = [] if interleaved else ["--paired2", pe["f2"]]
    outs = {}
    for tag, cli, dev in (("jax", jcli, []), ("torch", tcli, ["--device", "cpu"])):
        out = str(tmp_path / tag)
        assert cli.main(["pipeline", pe["idx"], *q, pe["ref"], "64", "8", "5", out, *pair,
                         *argv_tail, *dev]) == 0
        outs[tag] = out
    return outs


@pytest.mark.parametrize("case", ["mapq", "interleaved", "no_rescue", "sw", "sam_options"])
def test_paired_cli_matches_jax_cli(pe_setup, tmp_path, small_jax_batches, case):
    """pipeline --paired2 through both CLIs on the same index: --mapq (with
    the junk-prefix mate that only the rescue places), --paired-interleaved,
    --no-rescue, --rerank sw, and --qual --read-group --sort
    --mark-duplicates --bam.  No end differs; indices.npy stacks R1's rows,
    then R2's."""
    tail = {"mapq": ["--mapq", "--max-isize", "700"],
            "interleaved": ["--paired-interleaved", "--mapq", "--max-isize", "700"],
            "no_rescue": ["--no-rescue", "--mapq", "--max-isize", "700"],
            "sw": ["--rerank", "sw", "--mapq", "--max-isize", "700"],
            "sam_options": ["--mapq", "--qual", "--read-group", "ID:rg1,SM:s", "--sort",
                            "--mark-duplicates", "--bam"]}[case]
    outs = _run_clis(pe_setup, tmp_path, tail, interleaved=case == "interleaved")
    (jh, jr), (th, tr) = (_sam_ends(os.path.join(outs[t], "results.sam"))
                          for t in ("jax", "torch"))
    bad = _differing_ends(tr, jr)
    assert len(bad) == 0, f"{len(bad)} of {len(jr)} ends differ: {bad}"
    assert [h for h in th if not h.startswith("@PG")] == [h for h in jh if not h.startswith("@PG")]
    n = 13
    ti, ji = (np.load(os.path.join(outs[t], "indices.npy")) for t in ("torch", "jax"))
    assert ti.shape == ji.shape == (2 * n, 8)
    np.testing.assert_array_equal(ti[:, 0], ji[:, 0])
    prim = {key: next(f for f in v if not int(f[1]) & 0x900) for key, v in tr.items()}
    rescued = prim[("m0", True)]
    if case == "no_rescue":
        assert not int(rescued[1]) & 0x2  # the junk-prefix pair stays improper
    else:
        assert int(rescued[1]) & 0x2 and int(rescued[1]) & 0x10
        assert 1 <= int(rescued[4]) <= 40 and abs(int(rescued[3]) - 6_351) <= 110
    n_proper = sum(bool(int(f[1]) & 0x2) for f in prim.values())
    assert n_proper == 2 * n - 2 * (case == "no_rescue")
    # ids.npy: R1's rows then R2's, the primary column = the SAM primaries
    names = [f"p{i}" for i in range(n - 1)] + ["m0"]
    for row, key in enumerate([(nm, False) for nm in names] + [(nm, True) for nm in names]):
        assert int(prim[key][3]) == int(ti[row, 0]) // 2 + 1
    if case == "sam_options":
        assert os.path.exists(os.path.join(outs["torch"], "results.bam.bai"))
        keys = [int(ln.split("\t")[3]) for ln in open(os.path.join(outs["torch"], "results.sam"))
                if not ln.startswith("@")]
        assert keys == sorted(keys)


def test_paired_flags_and_tlen(pe_setup, tmp_path):
    """The port's paired SAM on its own: R1/R2 of each proper pair carry
    0x1/0x2/0x40/0x80 and opposite 0x10/0x20, RNEXT '=', PNEXT = the mate's
    POS, TLEN = +-500 (within 5: a primary may sit a few bases off on noisy
    reads) with the forward end positive; the repeat pairs keep a confident
    MAPQ through their mate."""
    from deepreadmapper_tpu_torch.pipeline.search import run_pipeline_paired

    pe = pe_setup
    out = str(tmp_path / "out")
    res = run_pipeline_paired(pe["idx"], pe["f1"], pe["f2"], pe["ref"], k=8,
                              output_dir=out, mapq=True, max_isize=700, device="cpu")
    assert res["n_proper"] == res["num_pairs"] == 13 and res["n_rescued"] == 1
    _, ends = _sam_ends(os.path.join(out, "results.sam"))
    for i in range(12):
        a = next(f for f in ends[(f"p{i}", False)] if not int(f[1]) & 0x900)
        b = next(f for f in ends[(f"p{i}", True)] if not int(f[1]) & 0x900)
        fa, fb = int(a[1]), int(b[1])
        assert fa & 0x43 == 0x43 and fb & 0x83 == 0x83
        assert bool(fa & 0x10) != bool(fb & 0x10) and bool(fa & 0x20) == bool(fb & 0x10)
        assert a[6] == b[6] == "=" and int(a[7]) == int(b[3]) and int(b[7]) == int(a[3])
        fwd, rev = (a, b) if not fa & 0x10 else (b, a)
        assert abs(int(fwd[8]) - ISIZE) <= 5 and int(rev[8]) == -int(fwd[8])
    assert all(int(next(f for f in ends[(f"p{i}", e)] if not int(f[1]) & 0x900)[4]) >= 40
               for i in (0, 1) for e in (False, True))


def test_serve_paired_and_long_read_requests_equal_one_shot(pe_setup, tmp_path):
    """serve answers a fastq2 request (with max_isize / rescue from the
    request) and a long_reads request with ok: true, and their SAMs and npy
    files equal the one-shot runs' byte for byte."""
    from deepreadmapper_tpu_torch.pipeline.search import run_pipeline, run_pipeline_paired
    from deepreadmapper_tpu_torch.pipeline.serve import serve

    pe = pe_setup
    genome = pe["genome"]
    lr = str(tmp_path / "lr.fastq")
    with open(lr, "w") as f:
        for name, s, e in (("lr0", 1_000, 2_400), ("lr1", 9_000, 11_000)):
            seq = genome[s:e] if name == "lr0" else genome[s:e].translate(_COMP)[::-1]
            f.write(f"@{name}\n{seq}\n+\n{'I' * len(seq)}\n")
    reqs = [{"id": "pe", "fastq": pe["f1"], "fastq2": pe["f2"], "output_dir": str(tmp_path / "pe"),
             "k": 8, "mapq": True, "max_isize": 700, "rescue": True, "qual": True},
            {"id": "lr", "fastq": lr, "long_reads": True, "output_dir": str(tmp_path / "lr"),
             "k": 4, "cigar": True},
            {"cmd": "quit"}]
    out = io.StringIO()
    n = serve(pe["idx"], pe["ref"], in_stream=io.StringIO(
        "".join(json.dumps(r) + "\n" for r in reqs)), out_stream=out, device="cpu")
    replies = [json.loads(ln) for ln in out.getvalue().splitlines()]
    assert n == 2 and [r.get("ok") for r in replies] == [True, True, True, True]
    assert replies[1]["num_queries"] == 26 and replies[2]["num_queries"] == 2
    run_pipeline_paired(pe["idx"], pe["f1"], pe["f2"], pe["ref"], k=8, mapq=True,
                        max_isize=700, qual=True, output_dir=str(tmp_path / "pe_one"),
                        device="cpu")
    run_pipeline(pe["idx"], lr, pe["ref"], k=4, cigar=True, long_reads=True,
                 output_dir=str(tmp_path / "lr_one"), device="cpu")
    for tag in ("pe", "lr"):
        names = sorted(os.listdir(tmp_path / tag))
        assert names == sorted(os.listdir(tmp_path / f"{tag}_one"))
        assert "results.sam" in names and "indices.npy" in names
        for name in names:
            assert (tmp_path / tag / name).read_bytes() == \
                (tmp_path / f"{tag}_one" / name).read_bytes(), (tag, name)
