"""The traffic generator: the same seed gives the same inputs."""

import numpy as np

from drm_bench import gen

TRAFFIC = {"read_len": 150, "sub_rate": 0.01, "pool_requests": 4,
           "request_reads": {"kind": "log_uniform", "low": 16, "high": 128}}


def _pool(tmp, seed):
    g = gen.make_genome(5000, seed)
    return g, gen.make_pool(str(tmp), g, TRAFFIC, seed)


def test_same_seed_same_inputs(tmp_path):
    big = 2**31 + 12345  # the driver's seeds pass 32 signed bits
    (a, b) = (tmp_path / "a", tmp_path / "b")
    a.mkdir(), b.mkdir()
    ga, pa = _pool(a, big)
    gb, pb = _pool(b, big)
    assert np.array_equal(ga, gb)
    for x, y in zip(pa, pb):
        assert open(x["fastq"], "rb").read() == open(y["fastq"], "rb").read()
        assert x["names"] == y["names"]


def test_other_seed_other_inputs_same_sizes(tmp_path):
    (a, b) = (tmp_path / "a", tmp_path / "b")
    a.mkdir(), b.mkdir()
    ga, pa = _pool(a, 1)
    gb, pb = _pool(b, 2)
    assert not np.array_equal(ga, gb)
    # a mix asks every seed for the same sizes, in another order
    assert sorted(len(p["names"]) for p in pa) == sorted(len(p["names"]) for p in pb)
    sizes = gen.request_sizes(TRAFFIC["request_reads"], 64, 3)
    assert min(sizes) >= 16 and max(sizes) <= 128 and len(set(sizes)) > 40
    # balanced: every aligned run of 8 holds one size of each eighth
    srt = sorted(sizes)
    for b in range(0, 64, 8):
        assert sorted(srt.index(x) // 8 for x in sizes[b : b + 8]) == list(range(8))
    assert gen.request_sizes({"kind": "fixed", "reads": 8192}, 4, 9) == [8192] * 4


def test_reads_carry_their_truth(tmp_path):
    g, pool = _pool(tmp_path, 7)
    comp = {ord("A"): ord("T"), ord("C"): ord("G"), ord("G"): ord("C"), ord("T"): ord("A")}
    for p in pool:
        for r, s, t in zip(p["reads"], p["starts"], p["strands"]):
            w = g[s : s + 150]
            if t:
                w = np.array([comp[c] for c in w[::-1]], np.uint8)
            assert np.mean(r != w) < 0.08  # 1% substitutions


def test_fasta_round_trip(tmp_path):
    from deepreadmapper_tpu_torch.io import fasta

    for n in (80, 1000, 1001):
        g = gen.make_genome(n, 3)
        path = str(tmp_path / f"g{n}.fna")
        gen.write_fasta(path, g)
        recs = fasta.parse_fasta_records(path)
        assert len(recs) == 1 and np.array_equal(recs[0], g)
