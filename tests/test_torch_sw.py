"""Port parity: the Smith-Waterman scores and the SW rerank against the JAX
package (lax.scan wavefront, the Pallas kernel in interpret mode, and the
scalar DP).  SW scores are integers, so every comparison is exact."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from deepreadmapper_tpu.io import fasta as fasta_io
from deepreadmapper_tpu.io import fastq
from deepreadmapper_tpu.ops import sw as jsw
from deepreadmapper_tpu.ops.sw_pallas import sw_scores_pallas
from deepreadmapper_tpu.pipeline import postprocess as jpp
from deepreadmapper_tpu.tokenizer import strings_to_bytes
from deepreadmapper_tpu_torch import kernels
from deepreadmapper_tpu_torch.ops import sw as tsw
from deepreadmapper_tpu_torch.pipeline import postprocess as tpp
from deepreadmapper_tpu_torch.utils import trace

_INT32_MIN = np.iinfo(np.int32).min


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two torch threads per test process: the suite runs in parallel
    processes, and the plain versions' many small ops slow down badly when
    every process starts a thread per core."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _port(a_mat, a_lens, b_mat, b_lens):
    before = kernels.SW_SCORE.launches
    out = tsw.sw_scores(torch.from_numpy(a_mat), torch.from_numpy(np.asarray(a_lens)),
                        torch.from_numpy(b_mat), torch.from_numpy(np.asarray(b_lens)))
    assert kernels.SW_SCORE.launches == before  # CPU tensors: plain version
    assert out.dtype == torch.int32
    return out.numpy()


def _fixture_pairs(data_dir, n_reads):
    """(windows, '<'-wrapped reads): each read against its true window, a
    shifted window and a random one, on both strands' ids."""
    genome = fasta_io.parse_fasta_records(str(data_dir / "ecoli_150.fna"))[0]
    seqs, names = fastq.parse_fastq(str(data_dir / "test_data.fastq"))
    rng = np.random.default_rng(0)
    bound = 2 * (genome.size - 150 + 1)
    ids, reads = [], []
    for s, nm in zip(seqs[:n_reads], names[:n_reads]):
        pos = min(int(nm.split("_")[1]) - 1, genome.size - 150)
        for wid in (2 * pos, 2 * pos + 1, 2 * max(pos - 7, 0), int(rng.integers(0, bound))):
            ids.append(wid)
            reads.append("<" + s + ">")
    a_mat, a_lens = fasta_io.fetch_windows_by_id(genome, np.array(ids), 150,
                                                 max_len=150, wrap=False)
    b_mat, b_lens = strings_to_bytes(reads)
    return np.ascontiguousarray(a_mat), a_lens, b_mat, b_lens


def test_fixture_pairs_match_jax(data_dir):
    """Read/window pairs of the fixture: P = 300, not a multiple of 128."""
    a_mat, a_lens, b_mat, b_lens = _fixture_pairs(data_dir, 75)
    got = _port(a_mat, a_lens, b_mat, b_lens)
    np.testing.assert_array_equal(got, jsw.sw_scores(a_mat, a_lens, b_mat, b_lens))
    np.testing.assert_array_equal(
        got, sw_scores_pallas(a_mat, a_lens, b_mat, b_lens, interpret=True))
    assert got.max() >= 140  # true windows align nearly end to end
    for p in (0, 1, 3):
        a = a_mat[p, : a_lens[p]].tobytes().decode()
        b = b_mat[p, : b_lens[p]].tobytes().decode()
        assert got[p] == jsw.sw_score_reference(a, b)


def test_edge_cases_match_scalar_dp():
    """Zero lengths, lengths differing within a batch, '<'/'>' wrap bytes,
    N bytes, lengths beyond the matrix width and below zero."""
    rng = np.random.default_rng(3)
    alphabet = np.array(list("ACGTN"))
    la = [0, 5, 20, 150, 1, 73, 150, 33, 0, 150, 40]
    lb = [7, 0, 3, 152, 99, 73, 152, 2, 0, 12, 152]
    a = ["".join(rng.choice(alphabet, size=n)) for n in la]
    b = ["<" + "".join(rng.choice(alphabet, size=max(n - 2, 0))) + ">" if n >= 2
         else "".join(rng.choice(alphabet, size=n)) for n in lb]
    b[9] = "<" + a[9][40:50] + ">"  # a local match inside a long row
    a_mat, a_lens = strings_to_bytes(a, width=150)
    b_mat, b_lens = strings_to_bytes(b, width=152)
    want = np.array([jsw.sw_score_reference(x, y) for x, y in zip(a, b)])
    got = _port(a_mat, a_lens, b_mat, b_lens)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jsw.sw_scores(a_mat, a_lens, b_mat, b_lens))
    assert got[9] == 10
    # lengths are clipped to [0, width], as the sentinel packing reads them
    clipped = _port(a_mat, a_lens + 1000, b_mat, b_lens - 1000)
    np.testing.assert_array_equal(clipped, np.zeros(len(a), np.int32))


def test_empty_batch():
    a = np.zeros((0, 150), np.uint8)
    b = np.zeros((0, 152), np.uint8)
    got = _port(a, np.zeros(0, np.int64), b, np.zeros(0, np.int64))
    assert got.shape == (0,)
    np.testing.assert_array_equal(got, jsw.sw_scores(a, np.zeros(0), b, np.zeros(0)))


def test_chunking_is_invisible():
    rng = np.random.default_rng(4)
    a = rng.choice(np.frombuffer(b"ACGT", np.uint8), (37, 30))
    b = rng.choice(np.frombuffer(b"ACGT", np.uint8), (37, 33))
    la, lb = rng.integers(0, 31, 37), rng.integers(0, 34, 37)
    args = [torch.from_numpy(x) for x in (a, la, b, lb)]
    whole = tsw.sw_scores_reference(*args)
    np.testing.assert_array_equal(tsw.sw_scores_reference(*args, chunk=5), whole)
    np.testing.assert_array_equal(whole.numpy(), jsw.sw_scores(a, la, b, lb))


def test_sw_scores_rejects_bad_inputs():
    a = torch.zeros((4, 10), dtype=torch.uint8)
    n = torch.full((4,), 10)
    with pytest.raises(TypeError):
        tsw.sw_scores(a.int(), n, a, n)
    with pytest.raises(ValueError):
        tsw.sw_scores(a, n, a[:3], n)
    with pytest.raises(ValueError):
        tsw.sw_scores(a, n[:2], a, n)


# rows 150 wide against reads and windows (one pass, the "shared" tier), and
# both sides wide: passes, in the "global" and the "int32" tiers
@pytest.mark.parametrize("lr,lc", [pytest.param(150, lc, id=str(lc)) for lc in (3, 152, 514)]
                         + [pytest.param(lr, lc, id=f"{lr}x{lc}") for lr, lc in
                            ((4843, 5000), (14600, 14600), (32768, 32800))])
@pytest.mark.parametrize("p", [1, 5120, 17920, 65536, 10**6])
def test_sw_layout_covers_every_column(p, lr, lc):
    """The kernel's lane (q, g) holds columns (q G + g) S .. + S - 1: G x S
    x passes slots cover the lc columns once each, S fits the registers
    (<= 40), G is a power of two <= 32, and a pass takes at most 32 x 40
    columns."""
    g, s, passes, tier = tsw.sw_layout(p, lr, lc)
    assert g in (1, 2, 4, 8, 16, 32) and 1 <= s <= 40
    assert passes == -(-lc // (32 * 40)) and tier == tsw._tier(lr, lc)
    assert tier == ("shared" if lr == 150 else "int32" if lr > 32767 else "global")
    cols = sorted((q * g + lane) * s + k for q in range(passes) for lane in range(g)
                  for k in range(s))
    assert cols == list(range(g * s * passes)) and g * s * passes >= lc
    # the fewest lanes that give 4 warps to each scheduler of 132 SMs, where p
    # and lc allow
    wanted, pairs2 = 132 * 4 * 4 * 32, (p + 1) // 2
    assert g == min(32, 1 << (lc.bit_length() - 1)) or pairs2 * g >= wanted
    try:
        smaller = g > 1 and tsw.sw_layout(p, lr, lc, g // 2)
    except ValueError:
        smaller = False
    assert not smaller or pairs2 * (g // 2) < wanted
    for forced in (g, 32):
        assert tsw.sw_layout(p, lr, lc, forced)[0] == forced
    with pytest.raises(ValueError):
        tsw.sw_layout(p, lr, lc, 3)


def test_sw_layout_passes_and_shared_memory():
    """lc beyond 32 lanes x 40 columns takes passes; lr 512 needs G >= 2
    for the A words of 128 / G groups to fit in shared memory."""
    assert tsw.sw_layout(1, 100, 2000) == (32, 32, 2, "shared")
    assert tsw.sw_layout(10**6, 512, 20)[0] == 2
    assert tsw.sw_layout(10**6, 150, 20)[0] == 1
    with pytest.raises(ValueError):
        tsw.sw_layout(10, 150, 152, 2)  # 76 columns a lane: too many registers


@pytest.mark.parametrize("lr", [600, 1000, 2000])
def test_wide_rows_swap_and_match_jax(lr, monkeypatch):
    """a rows 600-2,000 wide against b rows 150 wide (windows past the
    kernel's old 512-byte cap against reads), ragged lengths: sw_scores
    scores them with the narrower side as the rows, and equals the JAX
    package's sw_scores exactly."""
    rng = np.random.default_rng(lr)
    p, lc = 24, 150
    acgtn = np.frombuffer(b"ACGTN<>", np.uint8)
    a = acgtn[rng.integers(0, 7, (p, lr))]
    b = acgtn[rng.integers(0, 7, (p, lc))]
    for i in range(0, p, 3):  # a read planted in its window
        s = int(rng.integers(0, lr - lc))
        b[i] = a[i, s:s + lc]
    la, lb = np.full(p, lr), np.full(p, lc)
    la[1::4] = rng.integers(0, lr + 1, la[1::4].shape)
    lb[2::4] = rng.integers(0, lc + 1, lb[2::4].shape)
    la[5], lb[6] = 0, 0
    seen = []
    plain = tsw.sw_scores_reference
    monkeypatch.setattr(tsw, "sw_scores_reference",
                        lambda am, al, bm, bl: seen.append((am.shape[1], bm.shape[1]))
                        or plain(am, al, bm, bl))
    got = _port(a, la, b, lb)
    assert seen == [(lc, lr)]  # the reads are the rows
    np.testing.assert_array_equal(got, jsw.sw_scores(a, la, b, lb))
    assert got[0] == lc and got[5] == 0


def test_kernel_holds_the_narrow_side_its_shared_memory_allows():
    """The tier choice.  The rows stay in shared memory, with two edge words
    a row and group when lc takes more than one pass, up to 4,842-byte rows
    at G = 32 (today's G, S and passes; sw_layout counts the edges when it
    picks G); past that the rows and one edge word a row go to a global
    scratch ("global"), and past 32,767-byte rows the lanes are 32 bits
    ("int32").  The scratch of a launch stays at or under 1 GiB."""
    for lr, lc in ((600, 2000), (2000, 2000), (4842, 5000), (1280, 1281), (512, 20),
                   (150, 152), (1280, 1280)):
        for p in (2, 5120):
            g, s, passes, tier = tsw.sw_layout(p, lr, lc)
            assert tier == "shared" and g * s * passes >= lc
            ng = 128 // g
            smem = 4 * (ng * (lr | 1) + (2 * ng * lr if passes > 1 else 0))
            assert smem <= tsw._SMEM, (lr, lc, p, g)
            assert tsw.sw_scratch_bytes(p, lr, lc) == 0
    assert tsw.sw_layout(5120, 150, 152) == (32, 5, 1, "shared")  # the main path
    assert tsw.sw_layout(2, 4842, 5000) == (32, 40, 4, "shared")
    # 5,000-byte rows: their A words alone fit at G 32 (80 KB), not with
    # the edges between passes (240 KB)
    assert 4 * 4 * 5001 <= tsw._SMEM < 4 * (4 * 5001 + 8 * 5000)
    for lr, lc in ((4843, 5000), (5000, 5000), (14600, 14600), (32767, 32767),
                   (32768, 32800)):
        tier = "global" if lr <= 32767 else "int32"
        for p in (1, 2, 4000):
            g, s, passes, got = tsw.sw_layout(p, lr, lc)
            assert (g, got, passes) == (32, tier, -(-lc // 1280)) and s in (32, 40)
            pairs_a_group = 1 if tier == "int32" else 2
            blocks = -(-p // (4 * pairs_a_group))
            assert tsw.sw_scratch_bytes(p, lr, lc) == blocks * 4 * 4 * ((lr | 1) + lr)
    # a launch's scratch is bounded: 4,092 pairs of 32,768 x 32,800 take
    # 1,072,709,616 bytes, so 5,120 of them run in two launches
    assert tsw.sw_scratch_bytes(5120, 32768, 32800) == 1_072_709_616 <= 1 << 30
    assert tsw._launch_split(5120, 32768, 32, "int32") == (4092, 1_072_709_616)
    assert tsw.sw_scratch_bytes(10**6, 5000, 5000) <= 1 << 30
    assert tsw._launch_split(5120, 6000, 32, "global")[0] == 5120  # the 6 kb rerank: one


@pytest.mark.parametrize("lr", [4843, 5000])
def test_wide_both_sides_match_jax(lr):
    """Pairs wider than shared memory holds on both sides (the "global"
    tier on the card): a ragged batch with reads planted in their windows
    (1% substitutions) scores through the port as through the JAX package's
    sw_scores, exactly."""
    rng = np.random.default_rng(lr)
    p, lc = 5, 5000
    acgt = np.frombuffer(b"ACGT", np.uint8)
    a = acgt[rng.integers(0, 4, (p, lr))]
    b = acgt[rng.integers(0, 4, (p, lc))]
    n = lr - 300
    b[::2, 100:100 + n] = a[::2, 200:200 + n]
    mask = rng.random((p, lc)) < 0.01
    b[mask] = acgt[rng.integers(0, 4, int(mask.sum()))]
    la, lb = np.full(p, lr), np.full(p, lc)
    la[1], lb[3], lb[4] = 3000, 4321, 0
    assert tsw.sw_layout(p, lr, lc)[3] == "global"
    got = _port(a, la, b, lb)
    np.testing.assert_array_equal(got, jsw.sw_scores(a, la, b, lb))
    assert got[0] > 0.9 * n and got[4] == 0


def test_post_process_sw_wide_windows_matches_jax():
    """The SW rerank at windows of 4,900 bytes against reads of 4,900
    (wrapped: 4,902): the pairs of the "global" tier on the card.  A seeded
    ~20 kbp genome, reads cut from it on either strand (1% substitutions),
    neighbors given directly (the true window, shifted ones, random ones, a
    missing one), so no encoder runs; against the JAX package's
    post_process_sw under test_post_process_sw_matches_jax's invalid-slot
    rule."""
    rng = np.random.default_rng(11)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    comp = np.zeros(256, np.uint8)
    comp[acgt] = np.frombuffer(b"TGCA", np.uint8)
    glen, ref_len, nq, kc = 20_000, 4_900, 4, 5
    genome = acgt[rng.integers(0, 4, glen)]
    bound = 2 * (glen - ref_len + 1)
    true = rng.integers(0, bound, nq)
    reads = []
    for wid in true:
        r = genome[wid >> 1:(wid >> 1) + ref_len].copy()
        if wid & 1:
            r = comp[r[::-1]]
        mask = rng.random(ref_len) < 0.01
        r[mask] = acgt[rng.integers(0, 4, int(mask.sum()))]
        reads.append("<" + r.tobytes().decode() + ">")
    q_mat, q_lens = strings_to_bytes(reads)
    neighbors = rng.integers(0, bound, (nq, kc)).astype(np.int64)
    neighbors[:, 1] = true
    neighbors[:, 3] = np.clip(true + 2 * 37, 0, bound - 1)  # the true window shifted
    neighbors[0, 4] = -1                                    # a missing hit
    neighbors[2, 0] = neighbors[2, 2]                       # duplicate hits tie

    def fetch(ids):
        return fasta_io.fetch_windows_by_id(genome, ids, ref_len, max_len=ref_len)

    assert tsw.sw_layout(nq * kc, ref_len, ref_len + 2)[3] == "global"
    args = (neighbors, q_mat, q_lens, fetch, 1)
    ji, js = jpp.post_process_sw(*args, kc, kc, bound)
    jinv = js == _INT32_MIN
    assert jinv.any()
    k = kc - 1
    order = np.argsort(jinv, axis=1, kind="stable")[:, :k]
    ti, ts = tpp.post_process_sw(*args, k, kc, bound, device="cpu")
    np.testing.assert_array_equal(ti, np.take_along_axis(ji, order, axis=1))
    np.testing.assert_array_equal(ts, np.take_along_axis(js, order, axis=1))
    # the read's own window wins, scoring near its length
    np.testing.assert_array_equal(ti[:, 0], true)
    assert (ts[:, 0] > 0.9 * ref_len).all()


def test_cli_sw_rerank_at_ref_len_600_matches_jax(data_dir, tmp_path):
    """build-index at ref_len 600 (windows wider than the kernel's old cap)
    -> pipeline --rerank sw through both CLIs: equal indices.npy.  The
    distances the rerank carries are the engines' L2 readings: equal but
    for a few (the encoders' fp32 sums run in other orders)."""
    from deepreadmapper_tpu import cli as jcli
    from deepreadmapper_tpu_torch import cli as tcli

    fna, fq = str(data_dir / "ecoli_150.fna"), str(data_dir / "test_data.fastq")
    out = {}
    for tag, cli, dev in (("jax", jcli, ()), ("torch", tcli, ("--device", "cpu"))):
        idx, res = str(tmp_path / f"{tag}_idx"), str(tmp_path / f"{tag}_out")
        assert cli.main(["build-index", fna, idx, "600", *dev]) == 0
        assert cli.main(["pipeline", idx, fq, fna, "128", "10", "128", res,
                         "--rerank", "sw", *dev]) == 0
        out[tag] = [np.load(str(tmp_path / f"{tag}_out" / f)) for f in
                    ("indices.npy", "distances.npy")]
    assert out["torch"][0].shape == (150, 10)
    np.testing.assert_array_equal(out["torch"][0], out["jax"][0])
    assert np.mean(out["torch"][1] == out["jax"][1]) >= 0.99


def test_kernel_padding_matches_jax():
    """The kernel runs both pairs of a register to the longer one's lengths,
    reading a past la as 254 and b past lb as 255, and pads an odd P with a
    pair of length 0.  Those inputs score through the plain version as the
    JAX package scores the unpadded pairs."""
    rng = np.random.default_rng(5)
    acgtn = np.frombuffer(b"ACGTN<>", np.uint8)
    p, lr, lc = 41, 30, 33
    a = acgtn[rng.integers(0, 7, (p, lr))]
    b = acgtn[rng.integers(0, 7, (p, lc))]
    b[::3, 2:32] = a[::3]
    la, lb = rng.integers(0, lr + 1, p), rng.integers(0, lc + 1, p)
    la[4], lb[7], la[9] = 0, 0, lr
    want = jsw.sw_scores(a, la, b, lb)
    # the pad pair, then each register's two pairs out to the longer lengths
    ap = np.concatenate([a, np.zeros((1, lr), np.uint8)])
    bp = np.concatenate([b, np.zeros((1, lc), np.uint8)])
    lap, lbp = np.append(la, 0), np.append(lb, 0)
    ap[np.arange(lr)[None, :] >= lap[:, None]] = 254
    bp[np.arange(lc)[None, :] >= lbp[:, None]] = 255
    la_max = np.repeat(lap.reshape(-1, 2).max(axis=1), 2)
    lb_max = np.repeat(lbp.reshape(-1, 2).max(axis=1), 2)
    assert (la_max > lap).any() and (lb_max > lbp).any()
    got = tsw.sw_scores_reference(*(torch.from_numpy(x) for x in (ap, la_max, bp, lb_max)))
    np.testing.assert_array_equal(got.numpy()[:p], want)
    assert got[p] == 0


def _sw_rerank_case(data_dir, stride):
    genome = fasta_io.parse_fasta_records(str(data_dir / "ecoli_150.fna"))[0]
    seqs, names = fastq.parse_fastq(str(data_dir / "test_data.fastq"))
    nq, k_clusters, ref_len = 40, 6, 150
    bound = 2 * (genome.size - ref_len + 1)
    rng = np.random.default_rng(stride)
    true = np.array([2 * (int(nm.split("_")[1]) - 1) for nm in names[:nq]])
    neighbors = rng.integers(0, bound // stride, (nq, k_clusters)).astype(np.int64)
    neighbors[:, 2] = true // stride                        # near the truth,
    neighbors[:, 5] = (true + 1) // stride                  # either strand
    neighbors[:, 4] = neighbors[:, 3]                       # duplicate hits tie
    neighbors[0, 1] = -1                                    # a missing hit
    neighbors[1, 0] = bound // stride - 1                   # clipped at the end
    q_mat, q_lens = strings_to_bytes(["<" + s + ">" for s in seqs[:nq]])

    def fetch(ids):
        return fasta_io.fetch_windows_by_id(genome, ids, ref_len, max_len=ref_len)

    return neighbors, q_mat, q_lens, fetch, bound, k_clusters


@pytest.mark.parametrize("stride", [1, 4])
def test_post_process_sw_matches_jax(data_dir, stride):
    neighbors, q_mat, q_lens, fetch, bound, kc = _sw_rerank_case(data_dir, stride)
    n_cand = kc * (2 * stride - 1)
    k = kc if stride == 1 else 12
    args = (neighbors, q_mat, q_lens, fetch, stride)
    # The JAX package negates INT32_MIN in int32 (it wraps), so its invalid
    # slots sort FIRST and push valid candidates out of its top k; the port
    # sorts them last.  The JAX package's full ranking (k = every slot)
    # with its invalid slots moved to the end, stably, must give the port's
    # top k exactly, ties included.
    ji, js = jpp.post_process_sw(*args, n_cand, kc, bound, query_chunk=16)
    jinv = js == _INT32_MIN
    assert jinv.any()
    order = np.argsort(jinv, axis=1, kind="stable")[:, :k]
    # under a profiler the rerank records its fetch / score / sort spans
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        ti, ts = tpp.post_process_sw(*args, k, kc, bound, query_chunk=16, device="cpu")
    assert ti.dtype == np.int64 and ts.dtype == np.int32
    assert {s.name for s in trace.recorded()} == {"post.sw.fetch", "post.sw.score",
                                                  "post.sw.sort"}
    np.testing.assert_array_equal(ti, np.take_along_axis(ji, order, axis=1))
    np.testing.assert_array_equal(ts, np.take_along_axis(js, order, axis=1))
    # where no slot is invalid, the two packages agree as they stand
    clean = ~jinv.any(axis=1)
    assert clean.sum() >= 1
    ji_k, _ = jpp.post_process_sw(*args, k, kc, bound, query_chunk=16)
    np.testing.assert_array_equal(ti[clean], ji_k[clean])
    # the read's own window wins for nearly every read
    _, names = fastq.parse_fastq(str(data_dir / "test_data.fastq"))
    pos = np.array([int(nm.split("_")[1]) - 1 for nm in names[: ti.shape[0]]])
    assert np.mean(np.abs((ti[:, 0] >> 1) - pos) <= 2) > 0.9


def test_post_process_sw_checks_k(data_dir):
    neighbors, q_mat, q_lens, fetch, bound, kc = _sw_rerank_case(data_dir, 1)
    with pytest.raises(ValueError):
        tpp.post_process_sw(neighbors, q_mat, q_lens, fetch, 1, kc + 1, kc, bound,
                            device="cpu")
    with pytest.raises(ValueError):
        tpp.post_process_sw(neighbors, q_mat, q_lens, fetch, 4, 100, kc, bound,
                            device="cpu")


# -- windows by id (ops.sw.sw_scores_by_id, the SW rerank on the card) --------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


_ACGTN = np.frombuffer(b"ACGTN", np.uint8)
_COMP = np.zeros(256, np.uint8)
_COMP[_ACGTN] = np.frombuffer(b"TGCAN", np.uint8)


def _three_records(rng, ref_len, lens=(1_300, 700, 2_100)):
    """Three seeded records (one too short for a window at ref_len 700+)
    and their tables: (records, dense_off, base_off)."""
    from deepreadmapper_tpu_torch.io import fasta as tfa

    records = [_ACGTN[rng.integers(0, 4, n)] for n in lens]
    dense_off, base_off = tfa.record_window_table(records, ref_len, 1)
    return records, dense_off, base_off


def _by_id_case(name):
    """(genome, stream ids [Q, C], ref_len, query rows, lengths) of one
    shape of the by-id source: reads cut from their windows on either strand
    with substitutions, against random windows of both strands."""
    from deepreadmapper_tpu_torch.io import fasta as tfa

    rng = np.random.default_rng(sum(map(ord, name)))
    ref_len, glen, nq, c, width = 150, 3_000, 37, 10, 152
    if name == "columns":
        ref_len = 600
    elif name == "global":
        ref_len, glen, nq, c, width = 4_900, 12_000, 3, 2, 4_902
    genome = _ACGTN[rng.integers(0, 5, glen)]
    ids = rng.integers(0, 2 * (glen - ref_len + 1), (nq, c))
    if name == "three_records":
        records, dense_off, base_off = _three_records(rng, ref_len)
        genome = np.concatenate(records)
        dense = rng.integers(0, 2 * int(dense_off[-1]), (nq, c))
        ids = tfa.translate_window_ids(dense, dense_off, base_off)
    elif name == "past_end":
        ids[:, 1::2] = 2 * rng.integers(glen - ref_len + 1, glen + 20, (nq, 5)) + (
            rng.integers(0, 2, (nq, 5)))
    elif name == "missing":
        ids[::3, 1::3] = -1
    reads = []
    for r in range(nq):
        wid = int(ids[r, 0]) if (ids[r, 0] >> 1) + ref_len <= genome.size else 0
        w = genome[(wid >> 1):(wid >> 1) + ref_len].copy()
        if wid & 1:
            w = _COMP[w[::-1]]
        n = min(ref_len, width - 2) - int(rng.integers(0, 9))
        s = w[:n].copy()
        sub = rng.random(n) < 0.02
        s[sub] = _ACGTN[rng.integers(0, 4, int(sub.sum()))]
        reads.append("<" + s.tobytes().decode() + ">")
    q_mat, q_lens = strings_to_bytes(reads, width=width)
    return genome, ids.astype(np.int64), ref_len, q_mat, q_lens


def _fetched_scores(genome, ids, ref_len, q_mat, q_lens, dev):
    """The host-fetch path's scores: fetch_windows_by_id's windows and the
    repeated queries through the matrix sw_scores, [Q, C]."""
    from deepreadmapper_tpu_torch.io import fasta as tfa

    qn, c = ids.shape
    w_mat, w_lens = tfa.fetch_windows_by_id(genome, ids.ravel(), ref_len, max_len=ref_len)
    args = (np.ascontiguousarray(w_mat), w_lens, np.repeat(q_mat, c, axis=0),
            np.repeat(q_lens, c))
    return tsw.sw_scores(*(torch.from_numpy(x).to(dev) for x in args)).view(qn, c)


_BY_ID_CASES = ["both_strands", "past_end", "missing", "three_records", "columns", "global"]


@pytest.mark.parametrize("name", _BY_ID_CASES)
def test_sw_scores_by_id_plain_matches_jax_fetch(name):
    """The by-id op's plain version (CPU tensors) equals the JAX package's
    window fetch scored by its sw_scores, score for score: both strands,
    windows past the genome's end (zero bytes), -1 slots, a three-record
    stream, windows wider than the queries (the columns), pairs past
    shared memory (the card's "global" tier).  The card test holds the
    kernel to this plain version on the same inputs."""
    genome, ids, ref_len, q_mat, q_lens = _by_id_case(name)
    before = kernels.SW_SCORE_BY_ID.launches
    got = tsw.sw_scores_by_id(torch.from_numpy(genome), torch.from_numpy(ids), ref_len,
                              torch.from_numpy(q_mat), torch.from_numpy(q_lens))
    assert kernels.SW_SCORE_BY_ID.launches == before
    assert got.dtype == torch.int32 and got.shape == ids.shape
    qn, c = ids.shape
    w_mat, w_lens = fasta_io.fetch_windows_by_id(genome, ids.ravel(), ref_len,
                                                 max_len=ref_len)
    want = jsw.sw_scores(np.ascontiguousarray(w_mat), w_lens, np.repeat(q_mat, c, axis=0),
                         np.repeat(q_lens, c)).reshape(qn, c)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[:, 0].max() > 0.8 * min(ref_len, q_mat.shape[1] - 2)  # the reads' windows


def test_sw_scores_by_id_rejects_bad_inputs():
    g = torch.zeros(500, dtype=torch.uint8)
    ids = torch.zeros((4, 3), dtype=torch.int64)
    q = torch.zeros((4, 152), dtype=torch.uint8)
    n = torch.full((4,), 152)
    with pytest.raises(TypeError):
        tsw.sw_scores_by_id(g.int(), ids, 150, q, n)
    with pytest.raises(ValueError):
        tsw.sw_scores_by_id(g, ids[:3], 150, q, n)
    with pytest.raises(ValueError):
        tsw.sw_scores_by_id(g, ids.view(-1), 150, q, n)
    with pytest.raises(ValueError):
        tsw.sw_scores_by_id(g, ids, 150, q, n[:2])
    assert tsw.sw_scores_by_id(g, ids[:0], 150, q[:0], n[:0]).shape == (0, 3)


def _three_record_rerank_case(stride):
    """A three-record reference's SW rerank at a stride: (neighbors at the
    stride's ids, query rows, lengths, genome stream, tables, bound)."""
    from deepreadmapper_tpu_torch.io import fasta as tfa

    rng = np.random.default_rng(30 + stride)
    ref_len, nq, kc = 150, 24, 4
    records, dense_off, base_off = _three_records(rng, ref_len)
    sparse_off, _ = tfa.record_window_table(records, ref_len, stride)
    genome = np.concatenate(records)
    dense = rng.integers(0, 2 * int(dense_off[-1]), nq)
    stream = tfa.translate_window_ids(dense, dense_off, base_off)
    reads = []
    for wid in stream:
        w = genome[wid >> 1:(wid >> 1) + ref_len]
        reads.append("<" + (_COMP[w[::-1]] if wid & 1 else w).tobytes().decode() + ">")
    q_mat, q_lens = strings_to_bytes(reads)
    neighbors = rng.integers(0, 2 * int(sparse_off[-1]), (nq, kc)).astype(np.int64)
    r, loc = tfa.record_of(dense >> 1, dense_off)  # each read's own window, at the stride
    neighbors[:, 1] = 2 * (sparse_off[r] + loc // stride) + (dense & 1)
    neighbors[0, 2] = -1
    tables = dict(sparse_off=sparse_off, dense_off=dense_off, base_off=base_off)
    return neighbors, q_mat, q_lens, genome, tables, 2 * int(dense_off[-1]), kc


def _rerank_args(data_dir, stride, case):
    """post_process_sw's inputs two ways: (positional args with the fetch
    callable, keyword args of the callable's call, keyword args of the
    genome's call)."""
    if case == "fixture":
        neighbors, q_mat, q_lens, fetch, bound, kc = _sw_rerank_case(data_dir, stride)
        genome = fasta_io.parse_fasta_records(str(data_dir / "ecoli_150.fna"))[0]
        k = kc if stride == 1 else 12
        return ((neighbors, q_mat, q_lens, fetch, stride, k, kc, bound), {},
                dict(genome=genome, ref_len=150))
    from deepreadmapper_tpu_torch.io import fasta as tfa

    neighbors, q_mat, q_lens, genome, tables, bound, kc = _three_record_rerank_case(stride)

    def fetch(ids):
        ids = tfa.translate_window_ids(ids, tables["dense_off"], tables["base_off"])
        return tfa.fetch_windows_by_id(genome, ids, 150, max_len=150)

    offs = dict(sparse_off=tables["sparse_off"], dense_off=tables["dense_off"])
    k = kc if stride == 1 else 6
    return ((neighbors, q_mat, q_lens, fetch, stride, k, kc, bound), offs,
            dict(genome=genome, ref_len=150, base_off=tables["base_off"], **offs))


@pytest.mark.parametrize("case", ["fixture", "three_records"])
@pytest.mark.parametrize("stride", [1, 4])
def test_post_process_sw_genome_matches_fetch_callable(data_dir, stride, case):
    """On CPU tensors the genome argument scores query_chunk reads at a
    time through the by-id op's plain version, as the fetch callable does:
    the same ids and scores, the same three spans, and no pairs_by_id (no
    pair is scored by id off the card).  Both equal the JAX package's
    rerank with its invalid slots moved last (test_post_process_sw_matches_jax's
    rule); the card test holds the card to the callable on these inputs."""
    args, offs, by_genome = _rerank_args(data_dir, stride, case)
    want = tpp.post_process_sw(*args, query_chunk=16, device="cpu", **offs)
    n_cand = args[6] * (2 * stride - 1)
    ji, js = jpp.post_process_sw(*args[:5], n_cand, *args[6:], query_chunk=16, **offs)
    order = np.argsort(js == _INT32_MIN, axis=1, kind="stable")[:, :args[5]]
    np.testing.assert_array_equal(want[0], np.take_along_axis(ji, order, axis=1))
    np.testing.assert_array_equal(want[1], np.take_along_axis(js, order, axis=1))
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        got = tpp.post_process_sw(*args[:3], None, *args[4:], query_chunk=16, device="cpu",
                                  **by_genome)
    spans = trace.recorded()
    trace.clear()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert {s.name for s in spans} == {"post.sw.fetch", "post.sw.score", "post.sw.sort"}
    assert all(not (s.attrs or {}).get("pairs_by_id") for s in spans)
    assert (got[1][:, 0] > 100).mean() > 0.9  # the reads' own windows win


@pytest.mark.gpu
def test_sw_comp_table_is_the_hosts(cuda):
    """The complement table the by-id flavour reads is io/fasta.py's COMP."""
    from deepreadmapper_tpu_torch.io import fasta as tfa

    out = np.zeros(256, np.uint8)
    kernels.SW_COMP_TABLE.launch(out.ctypes.data)
    np.testing.assert_array_equal(out, tfa.COMP)


@pytest.mark.gpu
@pytest.mark.parametrize("name", _BY_ID_CASES)
def test_sw_scores_by_id_matches_fetched_windows_on_the_card(cuda, name):
    """The by-id launch equals, score for score, the plain version on the
    CPU (fetch_windows_by_id's windows through sw_scores_reference, which
    test_sw_scores_by_id_plain_matches_jax_fetch holds to the JAX package
    on these inputs) and the same windows through the matrix sw_scores on
    the card, in one launch; the main shape at every G its layout
    allows."""
    genome, ids, ref_len, q_mat, q_lens = _by_id_case(name)
    plain = _fetched_scores(genome, ids, ref_len, q_mat, q_lens, "cpu")
    width = q_mat.shape[1]
    lr, lc = min(ref_len, width), max(ref_len, width)
    tier = tsw.sw_layout(ids.size, lr, lc)[3]
    assert tier == ("global" if name == "global" else "shared")
    want = _fetched_scores(genome, ids, ref_len, q_mat, q_lens, cuda)
    g, i, q, ql = (torch.from_numpy(x).to(cuda) for x in (genome, ids, q_mat, q_lens))
    groups = [None] + ([1 << j for j in range(6) if (1 << j) >= tsw.sw_layout(
        ids.size, lr, lc)[0]] if name == "both_strands" else [])
    for group in groups:
        before = kernels.SW_SCORE_BY_ID.launches
        got = tsw.sw_scores_by_id(g, i, ref_len, q, ql, group=group)
        torch.cuda.synchronize()
        assert kernels.SW_SCORE_BY_ID.launches == before + 1
        assert torch.equal(got, want), (group, int((got != want).sum()))
        assert torch.equal(got.cpu(), plain), (group, int((got.cpu() != plain).sum()))
    assert int(want[:, 0].max()) > 0.8 * (lr - 2)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["fixture", "three_records"])
@pytest.mark.parametrize("stride", [1, 4])
def test_post_process_sw_by_id_on_the_card_equals_the_cpu(cuda, data_dir, stride, case):
    """post_process_sw on the card, given the genome, scores the request's
    Q x C pairs in one by-id launch and gives the CPU path's ids and scores
    exactly (the fetch callable and the plain SW, which
    test_post_process_sw_genome_matches_fetch_callable holds to the JAX
    package on these inputs); its post.sw.score span counts the pairs in
    pairs_by_id."""
    args, offs, by_genome = _rerank_args(data_dir, stride, case)
    want = tpp.post_process_sw(*args, device="cpu", **offs)
    kernels.reset_counts()
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        got = tpp.post_process_sw(*args[:3], None, *args[4:], device=cuda, **by_genome)
    spans = trace.recorded()
    trace.clear()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert kernels.counts()["sw_score_by_id"] == 1 and kernels.counts()["sw_score"] == 0
    pairs = args[0].shape[0] * args[6] * (2 * stride - 1)
    score = [s for s in spans if s.name == "post.sw.score"]
    assert len(score) == 1 and score[0].attrs == {"pairs_by_id": pairs}
    assert {s.name for s in spans} == {"post.sw.fetch", "post.sw.score", "post.sw.sort"}
