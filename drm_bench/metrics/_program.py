"""The program's own spans and counters (``deepreadmapper_tpu_torch.utils.
trace``: recorded while the traced window's profiler runs, on the clock of
the profiler's trace), shared by the metric files that read them.

A program without the tracer's ``recorded()`` gives nothing: every reader
here returns None.  The device's intervals come from the profiler's own
event times (``kineto_results``, in ns), never from the window trace's
``intervals``, which are put on the host clock by an unmeasured offset.
"""

from __future__ import annotations

import bisect

import numpy as np

ROOT = "serve.request"


def _trace_module():
    try:
        from deepreadmapper_tpu_torch.utils import trace
    except ImportError:
        return None
    return trace if hasattr(trace, "recorded") else None


def requests(ctx) -> dict | None:
    """{request id: its recorded spans} for the window's completed
    requests (the harness sends request i with the id str(i)), or None.
    Only spans that start in this window's trace count: an earlier run in
    the same process used the same ids.  Each request has one root."""
    trace = _trace_module()
    if trace is None or ctx.trace is None:
        return None
    t0 = ctx.trace.prof.profiler.kineto_results.trace_start_ns()
    ok = {str(i) for i, r in enumerate(ctx.replies) if r["ok"]}
    by: dict = {}
    for s in trace.recorded():
        if s.request in ok and s.start_ns >= t0:
            by.setdefault(s.request, []).append(s)
    for rid, spans in by.items():
        n = sum(s.name == ROOT for s in spans)
        if n != 1:
            raise ValueError(f"request {rid}: {n} {ROOT} spans in the window")
    return by or None


def root(spans: list):
    return next(s for s in spans if s.name == ROOT)


def reads(ctx, by: dict) -> int:
    """The reads counter summed over the requests; each request's must
    equal its reply's read count."""
    n = 0
    for rid, spans in by.items():
        got = (root(spans).attrs or {}).get("reads", 0)
        want = ctx.replies[int(rid)]["reads"]
        if got != want:
            raise ValueError(f"request {rid}: reads counter {got}, reply {want} reads")
        n += got
    return n


def ms_per_kread(ctx, name: str):
    """The seconds of every span `name`, summed over the window's requests,
    in ms a 1,000 reads; None without such a span."""
    by = requests(ctx)
    if by is None:
        return None
    ns = [s.ns for spans in by.values() for s in spans if s.name == name]
    if not ns:
        return None
    return sum(ns) / 1e6 / (reads(ctx, by) / 1e3)


def attr_ms_per_kread(ctx, span: str, key: str):
    """A number the program attached to every span `span` (ms), summed over
    the window's requests, in ms a 1,000 reads; None where none has it."""
    by = requests(ctx)
    if by is None:
        return None
    ms = [s.attrs[key] for spans in by.values() for s in spans
          if s.name == span and s.attrs and key in s.attrs]
    if not ms:
        return None
    return sum(ms) / (reads(ctx, by) / 1e3)


def median_ms(ctx, name: str):
    """The median over requests of a request's seconds in spans `name`, in
    ms; None without such a span."""
    by = requests(ctx)
    if by is None:
        return None
    per = [sum(s.ns for s in spans if s.name == name) for spans in by.values()
           if any(s.name == name for s in spans)]
    return float(np.median(per)) / 1e6 if per else None


# -- the idle breakdown (scripts/span_breakdown.py; no metric reads it) --

def device_intervals(prof) -> list[tuple[int, int, str]]:
    """(start, end, name) of every device event of a finished
    torch.profiler run, in ns on the tracer's clock."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA or e.duration_ns() <= 0:
            continue
        s = e.start_ns()
        out.append((s, s + e.duration_ns(), e.name()))
    return sorted(out)


def _union(iv) -> list[list[int]]:
    merged: list[list[int]] = []
    for s, f in sorted((a, b) for a, b, *_ in iv):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], f)
        else:
            merged.append([s, f])
    return merged


def _leaf_timeline(spans: list) -> list[tuple[int, int, str]]:
    """The deepest span at each moment of each root, as disjoint (start,
    end, label) pieces: a leaf's name, "serve.request (self)", or
    "<name> (self)" for a span with children, outside them."""
    kids: dict = {}
    for s in spans:
        kids.setdefault(s.parent, []).append(s)

    def walk(s, out):
        t = s.start_ns
        for c in sorted(kids.get(s.sid, []), key=lambda c: c.start_ns):
            if c.start_ns > t:
                out.append((t, c.start_ns, f"{s.name} (self)"))
            walk(c, out)
            t = max(t, c.end_ns)
        if s.sid not in kids:
            out.append((s.start_ns, s.end_ns, s.name))
        elif s.end_ns > t:
            out.append((t, s.end_ns, f"{s.name} (self)"))

    out: list = []
    for r in sorted(kids.get(None, []), key=lambda s: s.start_ns):
        walk(r, out)
    return out


def idle_breakdown(spans: list, prof) -> dict:
    """The device's idle ns in the window (first root's start to the last
    root's end) by the deepest span then open; "covered" counts leaves and
    serve.request's self time, the rest (a parent's self time, the time
    between requests) is uncovered."""
    roots = [s for s in spans if s.parent is None]
    t0, t1 = min(s.start_ns for s in roots), max(s.end_ns for s in roots)
    busy = [(max(a, t0), min(b, t1)) for a, b in _union(device_intervals(prof))
            if b > t0 and a < t1]
    edges = [t0] + [x for iv in busy for x in iv] + [t1]
    gaps = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    pieces = _leaf_timeline(spans)
    starts = [p[0] for p in pieces]
    by: dict = {}
    for a, b in gaps:
        covered = 0
        i = max(bisect.bisect_right(starts, a) - 1, 0)
        while i < len(pieces) and pieces[i][0] < b:
            s, f, label = pieces[i]
            lo, hi = max(a, s), min(b, f)
            if hi > lo:
                by[label] = by.get(label, 0) + hi - lo
                covered += hi - lo
            i += 1
        if b - a > covered:
            by["between requests"] = by.get("between requests", 0) + b - a - covered
    idle = sum(b - a for a, b in gaps)
    named = sum(v for k, v in by.items()
                if k == f"{ROOT} (self)" or not (k.endswith("(self)") or k == "between requests"))
    return {"window_ns": t1 - t0, "busy_ns": sum(b - a for a, b in busy), "idle_ns": idle,
            "uncovered_share": 1.0 - named / idle if idle else 0.0,
            "by_span_s": {k: v / 1e9 for k, v in sorted(by.items(), key=lambda kv: -kv[1])}}


def child_cover(spans: list, parents=("pipeline.embed", "pipeline.search",
                                      "pipeline.post")) -> dict:
    """For each parent name, the share of its summed duration that its
    direct children cover."""
    kids: dict = {}
    for s in spans:
        kids.setdefault(s.parent, []).append(s)
    out = {}
    for name in parents:
        ps = [s for s in spans if s.name == name]
        tot = sum(p.ns for p in ps)
        cov = sum(sum(b - a for a, b in _union((c.start_ns, c.end_ns) for c in kids.get(p.sid, [])))
                  for p in ps)
        if tot:
            out[name] = cov / tot
    return out
