# Copied from deepreadmapper_tpu/utils/progress.py, the JAX-free host layer; kept in step with it.
"""Host-side progress reporting for long build/stream loops.

The reference vendors progressbar.h and ticks it from its window-embed and
graph-insert loops (src/hnswpq/index.cpp, src/inference/vectorize.cpp); this
is the same affordance without a vendored dep.  Renders a single
carriage-return line on stderr — count, percent, rate, ETA — throttled so
the tick itself never shows up in a profile.

Off by default when stderr is not a TTY (pytest, batch jobs, piped logs);
force with DRM_PROGRESS=1 / suppress with DRM_PROGRESS=0.
"""

from __future__ import annotations

import os
import sys
import time


def _enabled_default() -> bool:
    env = os.environ.get("DRM_PROGRESS")
    if env is not None:
        return env not in ("", "0", "false", "no")
    try:
        return sys.stderr.isatty()
    except Exception:
        return False


class Progress:
    """tick()-driven progress line: `label  12.3M/40.0M 31%  393k/s  ETA 71s`.

    Usage:
        p = Progress(total_windows, "embed")
        for chunk in chunks:
            ...
            p.update(len(chunk))
        p.close()
    """

    def __init__(self, total: int, label: str = "", *,
                 enabled: bool | None = None, min_interval: float = 0.5):
        self.total = max(int(total), 0)
        self.label = label
        self.n = 0
        self.enabled = _enabled_default() if enabled is None else enabled
        self.min_interval = min_interval
        self._t0 = time.time()
        self._last = 0.0
        self._drawn = False

    @staticmethod
    def _fmt(n: float) -> str:
        for div, suf in ((1e9, "G"), (1e6, "M"), (1e3, "k")):
            if abs(n) >= div:
                return f"{n / div:.1f}{suf}"
        return f"{n:.0f}"

    def update(self, inc: int = 1) -> None:
        self.n += inc
        if not self.enabled:
            return
        now = time.time()
        if now - self._last < self.min_interval and self.n < self.total:
            return
        self._last = now
        dt = max(now - self._t0, 1e-9)
        rate = self.n / dt
        pct = 100.0 * self.n / self.total if self.total else 0.0
        eta = (self.total - self.n) / rate if rate > 0 and self.total else 0.0
        sys.stderr.write(
            f"\r{self.label}  {self._fmt(self.n)}/{self._fmt(self.total)} "
            f"{pct:3.0f}%  {self._fmt(rate)}/s  ETA {eta:4.0f}s "
        )
        sys.stderr.flush()
        self._drawn = True

    def close(self) -> None:
        if self._drawn:
            sys.stderr.write("\n")
            sys.stderr.flush()
            self._drawn = False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
