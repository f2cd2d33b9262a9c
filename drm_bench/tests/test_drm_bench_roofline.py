"""The roofline files' counts, from shapes alone."""

import pytest

from drm_bench.roofline import gru_fwd, int8_winmin, peaks, pq_winmin, sw_score


def test_gru_flops_a_pass():
    # two bidirectional layers, 123 steps, din 64 then 128, H 64
    assert gru_fwd.flops_per_read() * 8192 == pytest.approx(247.6e9, rel=1e-3)
    assert gru_fwd.least_s(8192) == pytest.approx(247.63e9 / peaks.TF32_FLOPS_S, rel=1e-3)


def test_scan_operations():
    rows = 2 * (4_641_652 - 150 + 1)
    ops = 2 * 128 * 8192 * rows
    assert int8_winmin.least_s(8192, rows) == pytest.approx(ops / peaks.INT8_OPS_S)
    # the PQ codes (8 B a row) are far below the operations' time too
    assert pq_winmin.least_s(8192, rows, 8) == pytest.approx(ops / peaks.INT8_OPS_S)
    # bytes bound a scan of few reads
    assert int8_winmin.least_s(1, rows) == pytest.approx(rows * 129 / peaks.HBM_BYTES_S, rel=1e-2)


def test_sw_cells():
    # a rerank launch: 512 reads x 10 candidates, 150 x 152 cells each
    assert sw_score.least_s(5120, 150, 152) * 1e3 == pytest.approx(0.01922, rel=1e-3)
