"""metrics/_work.py: the least time of a window's work by kernel, the
rerank's share of it counted by the rerank's own file."""

import types

import numpy as np
import pytest

from drm_bench.metrics import _work
from drm_bench.roofline import gru_fwd

NTOTAL = 2 * (4_641_652 - 150 + 1)
INT8 = {"scan_kernel": "int8_winmin", "ref_len": 150, "stride": 1, "genome_bp": 4_641_652}
PQ = {**INT8, "scan_kernel": "pq_winmin", "m_pq": 8, "nbits": 8}

# the three cells' contexts, and what the counting before the rerank files
# (drm_bench at 71e1ea6) gave for them, as float.hex
CELLS = {
    "ecoli_int8flat.npy8k": (INT8, {"k": 10, "write_sam": False}, [8192] * 134, {
        "gru_fwd": "0x1.1293fa7039b83p-4", "int8_winmin": "0x1.5174ce81526aep+0"}),
    "ecoli_pqflat.sw_sam8k": (PQ, {"k": 10, "rerank": "sw", "write_sam": True}, [8192] * 55, {
        "gru_fwd": "0x1.c2ccbd8e388dfp-6", "pq_winmin": "0x1.15042f402144ap-1",
        "sw_score": "0x1.1527d4bc1a9bcp-6"}),
    "ecoli_int8flat.sam_mixed": (INT8, {"k": 10, "write_sam": True},
                                 [128, 2048, 517, 1000] * 82, {
        "gru_fwd": "0x1.2efcb5ded35cfp-6", "int8_winmin": "0x1.745efdab6e075p-2"}),
}


def _ctx(cfg, request, replies, ntotal=NTOTAL):
    return types.SimpleNamespace(replies=replies, ntotal=ntotal, config=cfg,
                                 traffic={"read_len": 150, "request": request})


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_the_existing_cells_count_as_before(cell):
    cfg, request, sizes, want = CELLS[cell]
    replies = [{"ok": True, "reads": n} for n in sizes] + [{"ok": False, "reads": 999}]
    got = _work.least_s(_ctx(cfg, request, replies))
    assert {k: v.hex() for k, v in got.items()} == want


def test_the_l2_rerank_counts_each_requests_unique_pool(tmp_path):
    """Past stride 1 each window a request re-embeds is one more read of
    #1: the distinct valid candidates of the request's own npy rows."""
    cfg = {**INT8, "stride": 4, "genome_bp": 1000}  # bound 2 x 851 = 1702
    rows = np.array([[0, 2],      # 0..3 (-3..-1 dropped) and 5..11
                     [0, 1],      # 0..3 again and 1..7
                     [426, 5]],   # 426 x 4 = 1704 >= the bound: nothing; 17..23
                    np.int64)
    replies = []
    for j, ok in enumerate((True, True, False)):
        out = tmp_path / str(j)
        out.mkdir()
        np.save(out / "indices.npy", rows.astype(np.uint64))
        replies.append({"ok": ok, "reads": 3, "out": str(out)})
    got = _work.least_s(_ctx(cfg, {"k": 10, "write_sam": True}, replies, 2 * 213))
    windows = 2 * (12 + 7)  # two completed requests of 19 distinct windows each
    assert got["gru_fwd"] == gru_fwd.least_s(6) + gru_fwd.least_s(windows)
    assert set(got) == {"gru_fwd", "int8_winmin"}
