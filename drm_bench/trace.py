"""The device trace of a run's window (`--trace 1`): torch.profiler's CUDA
activity, reduced to the seconds each kernel ran, the device's busy time
(the union of its activity) and the idle gaps, each named by what the host
was doing then (the request phases the responses time)."""

from __future__ import annotations

import re
import time


class WindowTrace:
    """Start at the window's first request, stop at its close."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.t0 = self.t1 = None
        self.kernel_s: dict[str, float] = {}
        self.intervals: list[tuple[float, float]] = []

    def start(self) -> None:
        self.prof.start()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        import torch
        from torch.autograd import DeviceType

        torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.prof.stop()
        spans = []
        for e in self.prof.events():
            if e.device_type != DeviceType.CUDA:
                continue
            s, f = e.time_range.start * 1e-6, e.time_range.end * 1e-6
            if f <= s:
                continue
            spans.append((s, f))
            self.kernel_s[e.name] = self.kernel_s.get(e.name, 0.0) + (f - s)
        spans.sort()
        merged: list[list[float]] = []
        for s, f in spans:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], f)
            else:
                merged.append([s, f])
        # profiler times are relative to its start: put them on the host clock
        self.intervals = [(self.t0 + s, self.t0 + f) for s, f in merged]

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    @property
    def busy_s(self) -> float:
        return sum(f - s for s, f in self.intervals)

    def device_ops(self, top: int = 10) -> list:
        named: dict[str, float] = {}
        for name, sec in self.kernel_s.items():
            short = re.sub(r"<.*", "", name)[:80]
            named[short] = named.get(short, 0.0) + sec
        return [[n, s] for n, s in sorted(named.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, phases: list[tuple[float, float, str]], top: int = 10) -> list:
        """Idle seconds of the window by the host phase each gap's middle
        falls in; phases are (start, end, name) on the host clock."""
        edges = [self.t0] + [x for iv in self.intervals for x in iv] + [self.t1]
        out: dict[str, float] = {}
        for a, b in zip(edges[0::2], edges[1::2]):
            if b <= a:
                continue
            mid = 0.5 * (a + b)
            name = next((n for s, f, n in phases if s <= mid < f), "between requests")
            out[name] = out.get(name, 0.0) + (b - a)
        return [[n, s] for n, s in sorted(out.items(), key=lambda kv: -kv[1])[:top]]


def request_phases(replies: list[dict]) -> list[tuple[float, float, str]]:
    """Host phases of each request from its send and reply times and the
    spans its response reports (each ends in a host fetch)."""
    out = []
    for r in replies:
        t = r["sent"]
        for key, name in (("t_embed", "embed: FASTQ parse, tokenize, #1"),
                          ("t_search", "search: quantize, scan, top-k"),
                          ("t_post", "post: FASTA re-parse, rerank, SAM")):
            out.append((t, t + r[key], name))
            t += r[key]
        out.append((t, r["replied"], "npy write, reply"))
    return out
