"""The port's tracer (utils.trace) and its spans in the served path.

On the CPU: the tracer stores nothing without a profiler; under a CPU
torch.profiler spans nest with their parent and request id; ``serve``
records each layer's span in order inside its parent, with the request's
reads counter, and the responses' t_embed / t_search / t_post are those
spans' durations; each span's ``record_function`` event lies on the program's own
stamps (the shared clock); the benchmark's metric files that read the
spans give the expected values on a hand-built context.

On the card (``-m gpu``; skips without one): on a 2 Mbp index every #1
``gru_fwd`` interval of the profiler lies inside an ``embed.encode`` span,
every #2 / #4 scan inside ``pipeline.search`` and every #3 ``sw_score``
inside ``post.sw.score``:

    python -m pytest tests/test_torch_trace_spans.py -m gpu -q
"""

import importlib.util
import io
import json
import os
import types

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

from deepreadmapper_tpu_torch.pipeline.build import build_index
from deepreadmapper_tpu_torch.pipeline.search import run_pipeline
from deepreadmapper_tpu_torch.pipeline.serve import serve
from deepreadmapper_tpu_torch.utils import trace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _empty_buffer():
    trace.clear()
    yield
    trace.clear()


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def idx(tmp_path_factory, data_dir):
    prefix = str(tmp_path_factory.mktemp("spans") / "idx")
    build_index(str(data_dir / "ecoli_150.fna"), prefix, 150, device="cpu")
    return prefix


def test_no_profiler_records_nothing():
    """Without a profiler a span times its block and stores nothing; the
    counter and device interval go nowhere."""
    assert not trace.recording()
    with trace.span("serve.request", request="r") as root:
        with trace.span("pipeline.embed") as s:
            trace.count("reads", 5)
            trace.device_interval("select_device_ms", None, None)
    assert trace.recorded() == [] and trace.dropped() == 0
    assert root.attrs is None and s.attrs is None
    assert 0 <= s.ns <= root.ns and s.seconds == s.ns / 1e9


def test_spans_nest_with_parent_and_request_under_a_cpu_profiler():
    with profile(activities=[ProfilerActivity.CPU]):
        assert trace.recording()
        for rid in ("a", "b"):
            with trace.span("serve.request", request=rid):
                with trace.span("pipeline.post"):
                    with trace.span("post.sam"):
                        trace.count("reads", 3)
                    trace.count("reads", 4)
                with trace.span("serve.reply"):
                    pass
    assert not trace.recording()
    got = trace.recorded()
    assert [s.name for s in got] == ["post.sam", "pipeline.post", "serve.reply",
                                     "serve.request"] * 2
    by = {s.sid: s for s in got}
    for s in got:
        assert isinstance(s.start_ns, int) and s.start_ns <= s.end_ns
        if s.name == "serve.request":
            assert s.parent is None and s.attrs == {"reads": 7}
        else:
            p = by[s.parent]
            assert p.request == s.request
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
            assert s.attrs is None
    assert {s.request for s in got} == {"a", "b"}
    assert by[got[0].parent].name == "pipeline.post"
    assert by[got[2].parent].name == "serve.request"


def test_buffer_is_bounded_and_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(trace, "BOUND", 3)
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(5):
            with trace.span(f"s{i}"):
                pass
    assert [s.name for s in trace.recorded()] == ["s0", "s1", "s2"]
    assert trace.dropped() == 2


def test_a_tracers_spans_share_the_bound_and_the_drop_count(monkeypatch):
    monkeypatch.setattr(trace, "BOUND", 2)
    t = trace.Tracer()
    for i in range(5):
        with t.span(f"s{i}"):
            pass
    assert [s.name for s in t.spans] == ["s0", "s1"] and trace.dropped() == 3
    assert trace.recorded() == []  # no profiler: the module's buffer stays empty


# the children each span should have, in order, for the two request kinds
_L2 = {
    "serve.request": ["serve.parse", "pipeline.index", "pipeline.embed", "pipeline.search",
                      "pipeline.post", "write.npy", "serve.reply"],
    "pipeline.embed": ["embed.parse", "embed.encode"],
    "pipeline.search": ["search.quantize", "search.scan", "search.fetch"],
    "pipeline.post": ["post.fasta", "post.l2", "post.sam", "post.finish"],
}
_SW = {**_L2, "pipeline.post": ["post.fasta", "post.sw.fetch", "post.sw.fetch",
                                "post.sw.fetch", "post.sw.score", "post.sw.sort",
                                "post.sam"]}
_REQUESTS = {
    "l2": ({"k": 8, "sort": True, "bam": True}, _L2),
    "sw": ({"k": 5, "rerank": "sw"}, _SW),
}


def _served(idx, data_dir, tmp_path, kind):
    """One request of the kind and quit, served under a CPU profiler:
    (reply, the request's spans, the profiler)."""
    extra, _ = _REQUESTS[kind]
    req = {"id": "q1", "fastq": str(data_dir / "test_data.fastq"),
           "output_dir": str(tmp_path / kind), **extra}
    out = io.StringIO()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("warm"):  # the profiler's first annotation is slow
            pass
        serve(idx, str(data_dir / "ecoli_150.fna"), out_stream=out, device="cpu",
              in_stream=io.StringIO(json.dumps(req) + "\n" + '{"cmd": "quit"}\n'))
    reply = json.loads(out.getvalue().splitlines()[1])
    assert reply["ok"], reply
    return reply, [s for s in trace.recorded() if s.request == "q1"], prof


def _children(spans):
    kids = {}
    for s in sorted(spans, key=lambda s: s.start_ns):
        kids.setdefault(s.parent, []).append(s)
    return kids


@pytest.mark.parametrize("kind", ["l2", "sw"])
def test_serve_records_each_layer_in_order_inside_its_parent(idx, data_dir, tmp_path,
                                                             kind):
    reply, spans, _ = _served(idx, data_dir, tmp_path, kind)
    want = _REQUESTS[kind][1]
    kids = _children(spans)
    (root,) = kids[None]
    assert root.name == "serve.request"
    for s in spans:
        if s.name in want:
            got = kids.get(s.sid, [])
            assert [c.name for c in got] == want[s.name], s.name
            for a, b in zip(got, got[1:]):
                assert a.end_ns <= b.start_ns
            assert all(s.start_ns <= c.start_ns and c.end_ns <= s.end_ns for c in got)
        elif s is not root:
            assert s.sid not in kids, s.name  # the rest are leaves
    # the reply's timings are the pipeline spans' seconds, rounded as sent
    by_name = {s.name: s for s in spans}
    for key, name in (("t_embed", "pipeline.embed"), ("t_search", "pipeline.search"),
                      ("t_post", "pipeline.post")):
        assert reply[key] == round(by_name[name].seconds, 3), key


@pytest.mark.parametrize("kind", ["l2", "sw"])
def test_serve_counters_match_the_request(idx, data_dir, tmp_path, kind):
    """The request's one counter, reads, on its root; no other span
    carries an attribute on the CPU (the device intervals need a card)."""
    reply, spans, _ = _served(idx, data_dir, tmp_path, kind)
    root = next(s for s in spans if s.name == "serve.request")
    assert reply["num_queries"] == 150 and root.attrs == {"reads": 150}
    assert all(s.attrs is None for s in spans if s is not root)


def test_run_pipeline_timings_are_its_span_durations(idx, data_dir, tmp_path):
    with profile(activities=[ProfilerActivity.CPU]):
        res = run_pipeline(idx, str(data_dir / "test_data.fastq"),
                           str(data_dir / "ecoli_150.fna"), k=4,
                           output_dir=str(tmp_path / "o"), device="cpu")
    by = {s.name: s for s in trace.recorded()}
    assert res["t_index"] == by["pipeline.index"].seconds
    assert res["t_embed"] == by["pipeline.embed"].seconds
    assert res["t_search"] == by["pipeline.search"].seconds
    assert res["t_post"] == by["pipeline.post"].seconds
    assert by["pipeline.embed"].parent is None and by["pipeline.embed"].request is None


@pytest.mark.parametrize("kind", ["l2", "sw"])
def test_record_function_events_lie_on_the_program_stamps(idx, data_dir, tmp_path, kind):
    """The shared clock on the CPU: each span's record_function event in
    the kineto results starts and ends within 200 us of the span's own
    now_ns stamps."""
    _, _, prof = _served(idx, data_dir, tmp_path, kind)
    spans = {}
    for s in trace.recorded():  # the request's and the quit line's
        spans.setdefault(s.name, []).append((s.start_ns, s.end_ns))
    events = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CPU and e.name() in spans:
            a = e.start_ns()
            events.setdefault(e.name(), []).append((a, a + e.duration_ns()))
    assert set(events) == set(spans)
    for name, stamps in spans.items():
        assert len(events[name]) == len(stamps), name
        for (a, b), (s, f) in zip(sorted(events[name]), sorted(stamps)):
            assert abs(a - s) < 200_000 and abs(b - f) < 200_000, (name, a - s, b - f)


# -- the benchmark's metric files on a hand-built context --------------------

def _metric(name):
    path = os.path.join(ROOT, "drm_bench", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("_m_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


T0 = 10**18  # the window's trace start, ns


def _span(name, request, sid, parent, ms, attrs=None, start_ns=T0):
    return types.SimpleNamespace(name=name, request=request, sid=sid, parent=parent,
                                 start_ns=start_ns, end_ns=start_ns + int(ms * 1e6),
                                 ns=int(ms * 1e6), attrs=attrs)


def _window(t0=T0):
    """A finished window trace as the harness keeps it: its profiler's
    trace start."""
    res = types.SimpleNamespace(trace_start_ns=lambda: t0)
    return types.SimpleNamespace(prof=types.SimpleNamespace(
        profiler=types.SimpleNamespace(kineto_results=res)))


def _request_spans(i, n, start_ns=T0):
    r = str(i)
    f = i + 1  # request i's spans last f ms each
    return [
        _span("serve.request", r, 10 * i + 1, None, 100 * f, {"reads": n}, start_ns),
        _span("embed.parse", r, 10 * i + 2, 10 * i + 1, 2 * f, None, start_ns),
        _span("search.scan", r, 10 * i + 3, 10 * i + 1, 9 * f,
              {"select_device_ms": 3.0 * f}, start_ns),
        _span("post.fasta", r, 10 * i + 4, 10 * i + 1, 7 * f, None, start_ns),
        _span("post.sw.fetch", r, 10 * i + 5, 10 * i + 1, 4 * f, None, start_ns),
        _span("post.sw.fetch", r, 10 * i + 6, 10 * i + 1, 1 * f, None, start_ns),
        _span("post.sam", r, 10 * i + 7, 10 * i + 1, 6 * f, None, start_ns),
        _span("write.npy", r, 10 * i + 8, 10 * i + 1, 5 * f, None, start_ns),
    ]


def _context(monkeypatch, reads=(1000, 3000), extra=()):
    """Two completed requests of 1,000 and 3,000 reads and a failed one,
    each with every span the metrics read, after an earlier run's
    requests "0" and "1" in the same process; neither the failed
    request's spans nor the earlier run's may count."""
    from drm_bench.metrics import _program

    spans = _request_spans(0, 7, T0 - 10**9) + _request_spans(1, 9, T0 - 10**9)
    for i, n in enumerate(reads + (500,)):
        spans += _request_spans(i, n)
    spans += list(extra)
    fake = types.SimpleNamespace(recorded=lambda: list(spans))
    monkeypatch.setattr(_program, "_trace_module", lambda: fake)
    replies = [{"ok": True, "reads": reads[0]}, {"ok": True, "reads": reads[1]},
               {"ok": False, "reads": 500}]
    return types.SimpleNamespace(replies=replies, trace=_window())


# (metric, value): sums over requests 0 (f = 1) and 1 (f = 2) of 4,000
# reads, so a span of x ms each gives 3x ms / 4 kreads; medians of 1x, 2x
_EXPECT = [
    ("fastq_parse_ms_per_kread.batch", 3 * 2 / 4),
    ("npy_write_ms_per_kread.batch", 3 * 5 / 4),
    ("select_ms_per_kread.batch", 3 * 3.0 / 4),
    ("sw_fetch_ms_per_kread.sam", 3 * (4 + 1) / 4),
    ("sam_write_ms_per_kread.sam", 3 * 6 / 4),
    ("fasta_reparse_ms.serve", 1.5 * 7),
    ("sam_write_ms.serve", 1.5 * 6),
]


@pytest.mark.parametrize("name,want", _EXPECT)
def test_span_metric_files_read_the_program_spans(monkeypatch, name, want):
    ctx = _context(monkeypatch)
    assert _metric(name).read(ctx) == pytest.approx(want, rel=1e-9)


def test_span_metrics_need_the_reads_counter_to_match_the_replies(monkeypatch):
    ctx = _context(monkeypatch, reads=(1000, 2999))
    ctx.replies[1]["reads"] = 3000
    with pytest.raises(ValueError, match="reads counter 2999"):
        _metric("npy_write_ms_per_kread.batch").read(ctx)


def test_span_metrics_refuse_a_request_with_two_roots(monkeypatch):
    twin = _span("serve.request", "1", 99, None, 5, {"reads": 3000})
    ctx = _context(monkeypatch, extra=[twin])
    with pytest.raises(ValueError, match="request 1: 2 serve.request spans"):
        _metric("sam_write_ms.serve").read(ctx)


def test_span_metrics_give_nothing_without_the_tracer(monkeypatch):
    """A program whose tracer has no recorded() (the parent's) or recorded
    nothing, or a run with no traced window: every new metric reads None."""
    from drm_bench.metrics import _program

    ctx = types.SimpleNamespace(replies=[{"ok": True, "reads": 10}], trace=_window())
    for fake in (None, types.SimpleNamespace(recorded=lambda: [])):
        monkeypatch.setattr(_program, "_trace_module", lambda fake=fake: fake)
        for name, _ in _EXPECT:
            assert _metric(name).read(ctx) is None, name
    ctx = _context(monkeypatch)
    ctx.trace = None
    for name, _ in _EXPECT:
        assert _metric(name).read(ctx) is None, name


def test_idle_breakdown_puts_each_idle_gap_under_the_deepest_span():
    """The breakdown the PERF tables come from, on hand-built spans and
    device events: idle time under a leaf or the root's self time is
    named; a parent's self time and the time between requests are not."""
    from drm_bench.metrics import _program

    def sp(name, sid, parent, a, b):
        return types.SimpleNamespace(name=name, sid=sid, parent=parent, start_ns=a,
                                     end_ns=b, ns=b - a, request="r", attrs=None)

    spans = [sp("serve.request", 1, None, 0, 100), sp("serve.parse", 2, 1, 0, 10),
             sp("pipeline.embed", 3, 1, 10, 50), sp("embed.encode", 4, 3, 15, 50),
             sp("post.sam", 5, 1, 50, 90),
             sp("serve.request", 6, None, 120, 150), sp("write.npy", 7, 6, 120, 150)]

    def ev(a, b, dev=DeviceType.CUDA):
        return types.SimpleNamespace(device_type=lambda: dev, start_ns=lambda: a,
                                     duration_ns=lambda: b - a, name=lambda: "k")

    events = [ev(20, 30), ev(25, 40), ev(130, 140), ev(0, 150, DeviceType.CPU)]
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: events)))
    got = _program.idle_breakdown(spans, prof)
    assert got["window_ns"] == 150 and got["busy_ns"] == 30 and got["idle_ns"] == 120
    assert got["by_span_s"] == {k: v / 1e9 for k, v in {
        "post.sam": 40, "between requests": 20, "write.npy": 20, "embed.encode": 15,
        "serve.parse": 10, "serve.request (self)": 10, "pipeline.embed (self)": 5}.items()}
    assert got["uncovered_share"] == pytest.approx(25 / 120)
    assert _program.child_cover(spans) == {"pipeline.embed": 35 / 40}


# -- on the card --------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _genome_and_reads(work, bp=2_000_000, n_reads=2048, seed=7):
    rng = np.random.default_rng(seed)
    genome = rng.choice(np.frombuffer(b"ACGT", np.uint8), bp)
    ref = os.path.join(work, "ref.fna")
    with open(ref, "w") as f:
        f.write(">chr\n")
        seq = genome.tobytes().decode()
        f.writelines(seq[i:i + 80] + "\n" for i in range(0, bp, 80))
    starts = rng.integers(0, bp - 150, n_reads)
    fq = os.path.join(work, "reads.fastq")
    with open(fq, "w") as f:
        for i, s in enumerate(starts):
            f.write(f"@r{i}_{s + 1}\n{genome[s:s + 150].tobytes().decode()}\n+\n{'I' * 150}\n")
    return ref, fq


@pytest.mark.gpu
@pytest.mark.parametrize("index_type,scan", [("INT8FLAT", "int8_winmin"),
                                             ("PQFLAT", "pq_winmin")])
def test_card_kernels_lie_inside_their_layer_spans(cuda, tmp_path, index_type, scan):
    ref, fq = _genome_and_reads(str(tmp_path))
    prefix = str(tmp_path / "idx")
    build_index(ref, prefix, 150, index_type=index_type, device=cuda)
    reqs = [{"id": "l2", "fastq": fq, "output_dir": str(tmp_path / "l2"), "k": 10},
            {"id": "sw", "fastq": fq, "output_dir": str(tmp_path / "sw"), "k": 10,
             "rerank": "sw"}]
    lines = "".join(json.dumps(r) + "\n" for r in reqs) + '{"cmd": "quit"}\n'
    out = io.StringIO()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        serve(prefix, ref, in_stream=io.StringIO(lines), out_stream=out, device=cuda)
    assert all(json.loads(ln)["ok"] for ln in out.getvalue().splitlines())
    spans = trace.recorded()
    homes = {"gru_fwd": "embed.encode", scan: "pipeline.search", "sw_score": "post.sw.score"}
    inside = {name: [(s.start_ns, s.end_ns) for s in spans if s.name == home]
              for name, home in homes.items()}
    seen = dict.fromkeys(homes, 0)
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        name = next((n for n in homes if n in e.name()), None)
        if name is None:
            continue
        a = e.start_ns()
        b = a + e.duration_ns()
        assert any(s <= a and b <= f for s, f in inside[name]), (e.name(), a, b)
        seen[name] += 1
    assert min(seen.values()) > 0, seen
    # the selection's CUDA events, on the span open at the scan's call
    scans = [s for s in spans if s.name == "search.scan"]
    assert len(scans) == 2
    for s in scans:
        assert s.attrs["select_device_ms"] > 0
