"""The chr21_int8flat_s4.l2_sam8k cell's files and the readers of its
per-layer metrics: the program's post.l2 spans and counters faked as the
harness reads them after a traced window, and the port's own counters
from a served stride-4 request on the CPU."""

import importlib.util
import io
import json
import os
import sys
import types
from unittest import mock

import numpy as np
import pytest

from drm_bench import gen, harness
from drm_bench.metrics import _program, _work
from drm_bench.reference import rerank_l2
from drm_bench.reference import scan as ref_scan
from drm_bench.roofline import gru_fwd, int8_winmin
from drm_bench.tests.conftest import REPO

CELL = "chr21_int8flat_s4.l2_sam8k"
SPANS = ["l2_rerank_ms_per_kread.l2sam", "l2_expand_ms_per_kread.l2sam",
         "l2_pack_ms_per_kread.l2sam", "l2_host_bytes_per_read.l2sam"]
DEVICE = ["gru_fwd_roofline.l2sam", "int8_winmin_roofline.l2sam",
          "device_idle_share.l2sam", "map_step_mfu.l2sam"]
T0 = 10**18  # the window's trace start, ns


def _read(name, ctx):
    return harness.load_metric(name).read(ctx)


def _span(name, request, sid, parent, ms, attrs=None, start_ns=T0):
    return types.SimpleNamespace(name=name, request=request, sid=sid, parent=parent,
                                 start_ns=start_ns, end_ns=start_ns + int(ms * 1e6),
                                 ns=int(ms * 1e6), attrs=attrs)


def _request(i, reads, children=True, start_ns=T0):
    """Request i's spans: post.l2 of 100 f ms (f = i + 1) with, when
    children, expand 3 f, pack 7 f (host_bytes 48 x 30 a read), embed 80 f
    and rank 9 f ms."""
    r, f, b = str(i), i + 1, 10 * i
    out = [_span("serve.request", r, b + 1, None, 500 * f, {"reads": reads}, start_ns),
           _span("post.l2", r, b + 2, b + 1, 100 * f, None, start_ns)]
    if children:
        out += [_span("post.l2.expand", r, b + 3, b + 2, 3 * f,
                      {"slots": reads * 35, "windows": reads * 30}, start_ns),
                _span("post.l2.pack", r, b + 4, b + 2, 7 * f,
                      {"host_bytes": 48 * 30 * reads}, start_ns),
                _span("post.l2.embed", r, b + 5, b + 2, 80 * f, None, start_ns),
                _span("post.l2.rank", r, b + 6, b + 2, 9 * f, None, start_ns)]
    return out


def _window(busy_s=12.0, window_s=30.0, kernel_s=None):
    res = types.SimpleNamespace(trace_start_ns=lambda: T0)
    return types.SimpleNamespace(
        prof=types.SimpleNamespace(profiler=types.SimpleNamespace(kineto_results=res)),
        busy_s=busy_s, window_s=window_s, kernel_s=kernel_s or {})


def _context(monkeypatch, children=True, spans=True, trace=True):
    """Completed requests of 8,192 and 4,096 reads and a failed one of 512,
    after an earlier run's request "0" in the same process."""
    recorded = _request(0, 8192, children, T0 - 10**9) if spans else []
    if spans:
        for i, n in enumerate((8192, 4096, 512)):
            recorded += _request(i, n, children)
    fake = types.SimpleNamespace(recorded=lambda: list(recorded))
    monkeypatch.setattr(_program, "_trace_module", lambda: fake)
    return types.SimpleNamespace(
        replies=[{"ok": True, "reads": 8192}, {"ok": True, "reads": 4096},
                 {"ok": False, "reads": 512}],
        trace=_window() if trace else None)


# requests 0 (f = 1) and 1 (f = 2) of 12,288 reads: x ms each is 3x / 12.288
_EXPECT = {
    "l2_rerank_ms_per_kread.l2sam": 3 * 100 / 12.288,
    "l2_expand_ms_per_kread.l2sam": 3 * 3 / 12.288,
    "l2_pack_ms_per_kread.l2sam": 3 * 7 / 12.288,
    "l2_host_bytes_per_read.l2sam": 48.0 * 30,
}


@pytest.mark.parametrize("name", SPANS)
def test_span_readers_read_the_planted_trace(monkeypatch, name):
    assert _read(name, _context(monkeypatch)) == pytest.approx(_EXPECT[name], rel=1e-12)


@pytest.mark.parametrize("name", SPANS)
def test_span_readers_give_none_without_the_spans(monkeypatch, name):
    """No traced window, no recorded span, a tracer without recorded(): None.
    A program with post.l2 but none of its children (the parent of this
    change) gives None for the children's readers, and its post.l2 time
    for l2_rerank_ms_per_kread."""
    assert _read(name, _context(monkeypatch, trace=False)) is None
    assert _read(name, _context(monkeypatch, spans=False)) is None
    ctx = _context(monkeypatch)
    monkeypatch.setattr(_program, "_trace_module", lambda: None)
    assert _read(name, ctx) is None
    parent = _read(name, _context(monkeypatch, children=False))
    if name == "l2_rerank_ms_per_kread.l2sam":
        assert parent == pytest.approx(_EXPECT[name], rel=1e-12)
    else:
        assert parent is None


def _sparse_ctx(tmp_path, trace):
    """Two completed requests at stride 4 whose npy rows hold sparse hits,
    on chr21's index of 23,354,918 rows."""
    cfg = {"scan_kernel": "int8_winmin", "ref_len": 150, "stride": 4,
           "genome_bp": 46_709_983, "k_clusters": 5}
    replies = []
    rng = np.random.default_rng(3)
    for j, n in enumerate((64, 32)):
        out = tmp_path / str(j)
        out.mkdir()
        rows = rng.integers(-1, 23_354_918, (n, 5))
        np.save(out / "indices.npy", rows.astype(np.uint64))
        replies.append({"ok": True, "reads": n, "out": str(out)})
    return types.SimpleNamespace(replies=replies, ntotal=23_354_918, config=cfg,
                                 traffic={"request": {"k": 10, "rerank": "l2",
                                                      "write_sam": True}},
                                 trace=trace)


def test_device_readers_read_the_planted_trace(tmp_path):
    kernel_s = {"void gru_fwd_kernel<...>": 2.0, "int8_winmin_kernel<...>": 4.0}
    ctx = _sparse_ctx(tmp_path, _window(12.0, 30.0, kernel_s))
    least = _work.least_s(ctx)
    assert least["int8_winmin"] == int8_winmin.least_s(96, 23_354_918)
    assert least["gru_fwd"] > gru_fwd.least_s(96)  # the re-embeds count
    assert _read("gru_fwd_roofline.l2sam", ctx) == pytest.approx(
        100 * least["gru_fwd"] / 2.0, rel=1e-12)
    assert _read("int8_winmin_roofline.l2sam", ctx) == pytest.approx(
        100 * least["int8_winmin"] / 4.0, rel=1e-12)
    assert _read("device_idle_share.l2sam", ctx) == pytest.approx(60.0, rel=1e-12)
    assert _read("map_step_mfu.l2sam", ctx) == pytest.approx(
        100 * sum(least.values()) / 30.0, rel=1e-12)


@pytest.mark.parametrize("name", DEVICE)
def test_device_readers_give_none_without_a_traced_window(tmp_path, name):
    assert _read(name, _sparse_ctx(tmp_path, None)) is None


def test_the_programs_windows_are_works_count(tmp_path):
    """The port's windows counter on post.l2.expand, summed over two served
    stride-4 requests, equals the unique windows _work counts (through
    reference/rerank_l2.least_s) from the same requests' indices.npy."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from deepreadmapper_tpu_torch.pipeline.build import build_index
    from deepreadmapper_tpu_torch.pipeline.serve import serve
    from deepreadmapper_tpu_torch.utils import trace

    genome = gen.make_genome(6000, 2**31 + 5)
    ref = str(tmp_path / "ref.fna")
    gen.write_fasta(ref, genome)
    traffic = {"read_len": 150, "sub_rate": 0.01, "pool_requests": 2,
               "request_reads": {"kind": "fixed", "reads": 48},
               "request": {"k": 10, "rerank": "l2", "write_sam": True}}
    pool = gen.make_pool(str(tmp_path), genome, traffic, 2**31 + 5)
    prefix = str(tmp_path / "idx")
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        build_index(ref, prefix, 150, 4, "INT8FLAT", device="cpu")
        lines = "".join(json.dumps({"id": str(j), "fastq": p["fastq"], "k": 10,
                                    "k_clusters": 5, "rerank": "l2",
                                    "output_dir": str(tmp_path / "out" / str(j))}) + "\n"
                        for j, p in enumerate(pool))
        trace.clear()
        out = io.StringIO()
        with profile(activities=[ProfilerActivity.CPU]):
            serve(prefix, ref, in_stream=io.StringIO(lines), out_stream=out, device="cpu")
        spans = trace.recorded()
        trace.clear()
    finally:
        torch.set_num_threads(before)
    assert all(json.loads(ln)["ok"] for ln in out.getvalue().splitlines())
    windows = sum(s.attrs["windows"] for s in spans if s.name == "post.l2.expand")
    replies = [{"ok": True, "reads": 48, "out": str(tmp_path / "out" / str(j))}
               for j in range(2)]
    cfg = {"stride": 4, "genome_bp": 6000, "ref_len": 150}
    ctx = types.SimpleNamespace(replies=replies, config=cfg, traffic=traffic)
    bound = 2 * ref_scan.num_windows(6000, 150)
    by_hand = 0
    for r in replies:
        cand = ref_scan.candidates(ref_scan.load_ids(r["out"]), 4, 10, bound)
        by_hand += np.unique(cand[cand >= 0]).size
    assert windows == by_hand > 0
    assert rerank_l2.least_s(ctx, 96)["gru_fwd"] == gru_fwd.least_s(windows)


def test_the_cell_is_found_by_the_harness():
    bench = harness.load_bench()
    cell, cfg, traffic = harness.cell_spec(bench, CELL)
    assert cell["config"] == "chr21_int8flat_s4" and cell["chips"] == 1
    assert (cfg["index_type"], cfg["scan_kernel"], cfg["stride"], cfg["k"],
            cfg["k_clusters"], cfg["ef"], cfg["genome_bp"]) == (
        "INT8FLAT", "int8_winmin", 4, 10, 5, 128, 46_709_983)
    assert cfg["limits"] == {"index_gap": 0.01, "reads_wrong": 0}
    entry = next(c for c in bench["configs"] if c["name"] == "chr21_int8flat_s4")
    assert entry["reduced"] == cfg["reduced"] == ["genome", "index_type"]
    assert traffic["request"] == {"k": 10, "rerank": "l2", "write_sam": True}
    assert traffic["request_reads"] == {"kind": "fixed", "reads": 8192}
    assert (traffic["pool_requests"], traffic["check_reads"]) == (8, 8192)
    e2e = {m["name"] for m in harness.metrics_of(bench, CELL, False)}
    assert e2e == {"sam_reads_per_s", "peak_mem_gib", "setup_s"}
    layer = harness.metrics_of(bench, CELL, True)
    assert [m["name"] for m in layer] == SPANS + DEVICE
    assert all(m["moves"] == "sam_reads_per_s" for m in layer)
    for m in layer:
        assert callable(harness.load_metric(m["name"]).read)
    from drm_bench.reference import judge
    assert judge.limits(cfg, traffic) == {"index_gap": 0.01, "reads_wrong": 0,
                                          "l2_gap": rerank_l2.TOL}


def test_span_breakdown_without_the_check_fakes_every_limit(monkeypatch):
    """scripts/span_breakdown.py --no-check stands in for the judge with one
    number a limit the verdict compares, the rerank's l2_gap among them."""
    from drm_bench.reference import judge

    path = os.path.join(REPO, "scripts", "span_breakdown.py")
    spec = importlib.util.spec_from_file_location("_span_breakdown", path)
    sb = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sb)
    seen = {}

    def run_cell(cell, seed, seconds, trace, device, t0):
        _, cfg, traffic = harness.cell_spec(harness.load_bench(), cell)
        numbers, _ = judge.judge({"config": cfg, "traffic": traffic}, device, seed, 0.01, 1)
        seen["checks"], _ = judge.verdict(numbers, judge.limits(cfg, traffic))
        harness.Context(replies=[], window_s=1.0, setup_s=1.0, peak_mem_bytes=None,
                        trace=None, config=cfg, traffic=traffic, ntotal=1)
        return {"correct": False, "device": {"kind": "cpu"}, "attempted": 0,
                "metrics": {"map_step_mfu.l2sam": {"value": 1.5, "unit": "%"}}}, {}

    monkeypatch.setattr(harness, "run_cell", run_cell)
    monkeypatch.setitem(sys.modules, "_span_breakdown", sb)
    with mock.patch.object(sb, "ROOT", REPO):
        out = sb.run(CELL, "off", 1, 1.0, check=False)
    assert set(seen["checks"]) == {"index_gap", "reads_wrong", "l2_gap"}
    assert out["correct"] is None and out["cell"] == CELL
    # the harness's own readings are kept: its output files are gone by now
    assert out["metrics"]["map_step_mfu.l2sam"] == 1.5
