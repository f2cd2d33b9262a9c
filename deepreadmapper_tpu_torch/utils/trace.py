# Copied from deepreadmapper_tpu/utils/trace.py, with device_trace on torch.profiler in place of jax.profiler and spans of its own.
"""Tracing / profiling.

The reference wraps every stage in std::chrono spans with printed prefixes
(main.cpp:88-421) and counts distance computations in hnswm
(enableProfiling/getCountDistCalc, hnsw.cpp:18-39).  Here:

  * ``span`` — the port's tracer: a span at each layer boundary of a
    served request, with its name, start and end in integer ns on
    ``now_ns`` (the clock of the torch profiler's trace), its parent span
    and its request id; ``count`` adds per-request counters to the
    request's root span, ``device_interval`` the card's time between two
    CUDA events to the span open at the call.  A span is recorded only while a
    torch profiler runs (``device_trace``, the CLI's ``--profile``, a
    benchmark's traced window); it then also enters
    ``torch.profiler.record_function``, so a Chrome trace with CPU
    activity shows it on the kernels' timeline.  Otherwise a span only
    times its block for its caller and stores nothing.  ``recorded()``
    reads the bounded buffer of closed spans.
  * ``stage``/``Tracer`` — named spans with a summary table.
  * ``device_trace`` — context manager around torch.profiler: a Chrome
    trace of host and card activity, the deep-profiling analog.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import itertools
import os
import time

from torch.autograd import profiler as _profiler
from torch.profiler import record_function

BOUND = 1 << 17  # closed spans kept in the buffer; later ones are dropped and counted

_OPEN: contextvars.ContextVar = contextvars.ContextVar("deepreadmapper_span", default=None)
_SIDS = itertools.count(1)
_SPANS: list = []
_DROPPED = 0


def now_ns() -> int:
    """The tracer's clock: Unix-epoch ns, the clock of the torch profiler's
    trace (``kineto_results.trace_start_ns()``, each event's
    ``start_ns()``)."""
    return time.time_ns()


def recording() -> bool:
    """True while a torch profiler runs: spans are then recorded."""
    return _profiler._is_profiler_enabled


class span:
    """``with span("pipeline.embed") as s:`` times the block (``s.ns``,
    ``s.seconds``) and, while recording, keeps it: ``sid``, ``parent`` (the
    enclosing span's sid, None at a root), ``request`` (the root's),
    ``attrs`` (counters and device times, or None)."""

    __slots__ = ("name", "request", "start_ns", "end_ns", "sid", "parent", "attrs",
                 "_root", "_token", "_rf", "_pending")

    def __init__(self, name: str, request: str | None = None):
        self.name = name
        self.request = request
        self.attrs = self._token = self._pending = None

    # while recording, the stamps sit next to record_function's own enter
    # and exit, so that its event and the span agree to a few us; the
    # Python bookkeeping around them falls outside the stamps
    def __enter__(self) -> "span":
        if _profiler._is_profiler_enabled:
            self._open()
            self.start_ns = now_ns()
            self._rf.__enter__()
        else:
            self.start_ns = now_ns()
        return self

    def __exit__(self, *exc) -> bool:
        if self._token is None:
            self.end_ns = now_ns()
        else:
            self._rf.__exit__(None, None, None)
            self.end_ns = now_ns()
            self._close()
        return False

    @property
    def ns(self) -> int:
        return self.end_ns - self.start_ns

    @property
    def seconds(self) -> float:
        return self.ns / 1e9

    def add(self, key: str, value) -> None:
        if self.attrs is None:
            self.attrs = {}
        self.attrs[key] = self.attrs.get(key, 0) + value

    def _open(self) -> None:
        up = _OPEN.get()
        self._root = self if up is None else up._root
        self.parent = None if up is None else up.sid
        self.sid = next(_SIDS)
        self._token = _OPEN.set(self)
        self._rf = record_function(self.name)

    def _close(self) -> None:
        _OPEN.reset(self._token)
        self.request = self._root.request
        self._token = self._rf = self._root = None
        _keep(_SPANS, self)

    def _resolve(self) -> None:
        for key, start, end in self._pending:
            end.synchronize()
            self.add(key, start.elapsed_time(end))
        self._pending = None


def _keep(buf: list, s: span) -> None:
    """Appends s to buf while buf holds fewer than BOUND spans; otherwise
    counts it in ``dropped()``."""
    global _DROPPED
    if len(buf) < BOUND:
        buf.append(s)
    else:
        _DROPPED += 1


def count(name: str, n: int = 1) -> None:
    """Adds n to counter `name` of the current request's root span (while
    recording; otherwise nothing)."""
    s = _OPEN.get()
    if s is not None:
        s._root.add(name, n)


def device_interval(key: str, start, end) -> None:
    """Adds the card's ms between two recorded CUDA events to `key` of the
    open span, resolved when ``recorded()`` reads it (no CUDA call on the
    request's path).  Without an open span, nothing."""
    s = _OPEN.get()
    if s is not None:
        if s._pending is None:
            s._pending = []
        s._pending.append((key, start, end))


def recorded() -> list:
    """The closed spans recorded so far, in closing order, their device
    intervals resolved."""
    for s in _SPANS:
        if s._pending:
            s._resolve()
    return list(_SPANS)


def dropped() -> int:
    """Spans not kept: closed while their buffer (the module's or a
    Tracer's) held BOUND."""
    return _DROPPED


def clear() -> None:
    global _DROPPED
    _SPANS.clear()
    _DROPPED = 0


class Tracer:
    """Its own named spans (at most BOUND; the rest counted in
    ``dropped()``) and counters, with a summary table."""

    def __init__(self):
        self.spans: list[span] = []
        self.counters = collections.Counter()

    @contextlib.contextmanager
    def span(self, name: str):
        s = span(name)
        try:
            with s:
                yield s
        finally:
            _keep(self.spans, s)

    def count(self, name: str, n: int = 1) -> None:
        self.counters[name] += n

    def summary(self) -> str:
        total = sum(s.seconds for s in self.spans)
        lines = [f"{'stage':<24}{'seconds':>10}{'share':>8}"]
        for s in self.spans:
            d = s.seconds
            share = (d / total * 100) if total else 0.0
            lines.append(f"{s.name:<24}{d:>10.3f}{share:>7.1f}%")
        for name, v in sorted(self.counters.items()):
            lines.append(f"{name:<24}{v:>10}")
        return "\n".join(lines)


_GLOBAL = Tracer()


@contextlib.contextmanager
def stage(name: str, tracer: Tracer | None = None):
    with (tracer or _GLOBAL).span(name):
        yield


def global_tracer() -> Tracer:
    return _GLOBAL


@contextlib.contextmanager
def device_trace(logdir: str, filename: str = "device.pt.trace.json",
                 cuda: bool | None = None):
    """torch.profiler trace of the block, written as a Chrome trace
    (chrome://tracing, Perfetto) to logdir/filename when the block ends;
    yields that path.  It records the card's kernels and copies when cuda
    is true, by default when a card is present, and the spans the block
    runs."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if cuda is None:
        cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, filename)
    with profile(activities=acts, on_trace_ready=lambda prof: prof.export_chrome_trace(path)):
        yield path
