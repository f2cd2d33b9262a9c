"""sw_by_id_share.sam on a hand-built context: the program's recorded spans
faked as the harness would read them after a traced window."""

import types

import pytest

from drm_bench import harness
from drm_bench.metrics import _program

T0 = 10**18  # the window's trace start, ns


def _span(name, request, sid, parent, attrs=None, start_ns=T0):
    return types.SimpleNamespace(name=name, request=request, sid=sid, parent=parent,
                                 start_ns=start_ns, end_ns=start_ns + 10**6, ns=10**6,
                                 attrs=attrs)


def _context(monkeypatch, by_id=(81_920, 40_960), trace=True, stride=1):
    """Two completed requests of 8,192 and 4,096 reads and a failed one,
    each with a post.sw.score span carrying pairs_by_id (None: without
    it), after an earlier run's request "0" in the same process."""
    spans = [_span("serve.request", "0", 1, None, {"reads": 8192}, T0 - 10**9),
             _span("post.sw.score", "0", 2, 1, {"pairs_by_id": 81_920}, T0 - 10**9)]
    for i, (reads, pairs) in enumerate(zip((8192, 4096, 512), by_id + (5_120,))):
        r = str(i)
        spans.append(_span("serve.request", r, 10 * i + 1, None, {"reads": reads}))
        spans.append(_span("post.sw.fetch", r, 10 * i + 2, 10 * i + 1))
        spans.append(_span("post.sw.score", r, 10 * i + 3, 10 * i + 1,
                           None if pairs is None else {"pairs_by_id": pairs}))
    fake = types.SimpleNamespace(recorded=lambda: list(spans))
    monkeypatch.setattr(_program, "_trace_module", lambda: fake)
    window = types.SimpleNamespace(prof=types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(trace_start_ns=lambda: T0))))
    return types.SimpleNamespace(
        replies=[{"ok": True, "reads": 8192}, {"ok": True, "reads": 4096},
                 {"ok": False, "reads": 512}],
        trace=window if trace else None,
        config={"stride": stride, "k_clusters": 5}, traffic={"request": {"k": 10}})


def _read(ctx):
    return harness.load_metric("sw_by_id_share.sam").read(ctx)


def test_every_pair_by_id_reads_100(monkeypatch):
    assert _read(_context(monkeypatch)) == pytest.approx(100.0, rel=1e-12)


@pytest.mark.parametrize("by_id,stride,want", [
    ((40_960, 40_960), 1, 100.0 * 81_920 / 122_880),
    ((81_920, None), 1, 100.0 * 81_920 / 122_880),
    # stride 4: 5 x 7 slots a read
    ((286_720, 143_360), 4, 100.0),
])
def test_the_share_counts_the_pairs_of_each_request(monkeypatch, by_id, stride, want):
    assert _read(_context(monkeypatch, by_id, stride=stride)) == pytest.approx(want,
                                                                              rel=1e-12)


def test_nothing_without_a_traced_window_or_the_attribute(monkeypatch):
    """No traced window, a program without the by-id path (no span carries
    pairs_by_id, as the parent's), or a tracer without recorded(): None."""
    assert _read(_context(monkeypatch, trace=False)) is None
    assert _read(_context(monkeypatch, by_id=(None, None))) is None
    ctx = _context(monkeypatch)
    monkeypatch.setattr(_program, "_trace_module", lambda: None)
    assert _read(ctx) is None


def test_the_metric_is_declared_for_the_sw_cell():
    bench = harness.load_bench()
    m = next(m for m in bench["per_layer"] if m["name"] == "sw_by_id_share.sam")
    assert m["workloads"] == ["ecoli_pqflat.sw_sam8k"] and m["moves"] == "sam_reads_per_s"
    layers = {x["layer"] for x in bench["per_layer"] if x["name"] == "sw_score_roofline.sam"}
    assert layers == {m["layer"]}
    assert m in harness.metrics_of(bench, "ecoli_pqflat.sw_sam8k", trace=True)
