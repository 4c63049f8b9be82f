"""Metric readers, found by name: ``perfbench/metrics/<name>.py`` holds
``read(run) -> float | None``. A reader that finds nothing to read (no
device trace, no request of the kind it needs) returns None and the
metric is left out of the result line.

``Run`` is what a reader may read: the cell's spec, the configuration's
numbers (``mc``), the window (the serve's result and the trace of
requests), the set-up seconds, and with ``--trace 1`` the device trace
of the window up to the drain (``wall_s`` leaves out the serve's wait
while the profiler stopped).
"""

from __future__ import annotations

import dataclasses
import importlib
import math


@dataclasses.dataclass
class Run:
    spec: dict
    mc: dict
    window: object                      # serve.Window
    setup_s: float
    trace: object | None = None         # trace.Trace
    pause_s: float = 0.0                # the serve's wait for the profiler

    @property
    def result(self):
        return self.window.result

    @property
    def wall_s(self) -> float:
        """The window's wall time without the profiler's pause."""
        return self.window.result.wall_s - self.pause_s

    def request(self, c):
        """The generated request of a finished one."""
        return self.window.trace[c.index]


def p95(values) -> float | None:
    """Nearest-rank 95th percentile, or None of nothing."""
    v = sorted(values)
    if not v:
        return None
    return v[max(math.ceil(0.95 * len(v)) - 1, 0)]


def read(name: str, run: Run):
    mod = importlib.import_module(f"perfbench.metrics.{name}")
    value = mod.read(run)
    return None if value is None else float(value)
