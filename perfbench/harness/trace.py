"""The device trace of a served window: ``torch.profiler`` with CUDA
activity only (host op records would cost more than the run), reduced
from the profiler's raw records (``key_averages()`` over millions of
kernels takes minutes), never exported to disk. The kernels inside
CUDA-graph replays are recorded one by one.

``Trace`` holds, over the profiled span: device seconds by kernel name,
the busy seconds (the union of all device intervals: kernels, copies,
sets), the span's host wall seconds, and the idle gaps summed by the
pair of operations around them.
"""

from __future__ import annotations

import dataclasses
import re
import time

import numpy as np
import torch


def short(name: str) -> str:
    """A kernel's name without its template and argument lists."""
    name = re.sub(r"^void\s+", "", name.replace("(anonymous namespace)::",
                                               ""))
    cut = min((i for i in (name.find("<"), name.find("(")) if i > 0),
              default=len(name))
    return name[:cut][:80].strip()


@dataclasses.dataclass
class Trace:
    kernels: dict           # short name -> device seconds
    full_names: dict        # short name -> one full name seen
    launches: int
    busy_s: float
    window_s: float
    gaps: dict              # "after X / before Y" -> idle seconds
    cost_s: dict = dataclasses.field(default_factory=dict)

    def seconds(self, pattern: str, full: bool = True) -> float:
        """Device seconds of the kernels whose name matches ``pattern``."""
        rx = re.compile(pattern, re.IGNORECASE)
        return sum(s for k, s in self.kernels.items()
                   if rx.search(self.full_names[k] if full else k))

    @property
    def device_s(self) -> float:
        return sum(self.kernels.values())

    def breakdown(self, n: int = 10) -> dict:
        top = sorted(self.kernels.items(), key=lambda kv: -kv[1])[:n]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:n]
        return {"device_ops": [[k, s] for k, s in top],
                "idle_gaps": [[k, s] for k, s in gaps]}


def reduce(events, window_s: float) -> Trace:
    """``Trace`` of the profiler's raw records ``events``, reduced with
    numpy (a window records millions of kernels)."""
    cuda = torch.autograd.DeviceType.CUDA
    rows = [(e.name(), e.start_ns(), e.duration_ns()) for e in events
            if e.device_type() == cuda]
    n = len(rows)
    raw = {}
    if n:
        names_col, start_col, dur_col = zip(*rows)
    else:
        names_col, start_col, dur_col = (), (), ()
    del rows
    ids = np.fromiter(map(lambda r: raw.setdefault(r, len(raw)), names_col),
                      np.int64, n)
    start = np.fromiter(start_col, np.int64, n)
    end = start + np.fromiter(dur_col, np.int64, n)
    names = list(raw)
    keys = {}
    key_of = np.array([keys.setdefault(short(r), len(keys)) for r in names],
                      np.int64)
    key_names = list(keys)
    per_raw = np.bincount(ids, weights=(end - start) * 1e-9,
                          minlength=len(names))
    kernels, full = {}, {}
    for r, s in zip(names, per_raw, strict=True):
        k = key_names[key_of[raw[r]]]
        kernels[k] = kernels.get(k, 0.0) + float(s)
        full.setdefault(k, r)
    gaps, busy = {}, 0.0
    if n:
        order = np.argsort(start, kind="stable")
        start, end, key = start[order], end[order], key_of[ids[order]]
        run_end = np.maximum.accumulate(end)
        at_max = np.maximum.accumulate(
            np.where(end == run_end, np.arange(n), 0))
        new = np.nonzero(start[1:] > run_end[:-1])[0] + 1
        idle = (start[new] - run_end[new - 1]) * 1e-9
        busy = (run_end[-1] - start[0]) * 1e-9 - float(idle.sum())
        m = len(key_names)
        pair = key[at_max[new - 1]] * m + key[new]
        sums = np.bincount(pair, weights=idle, minlength=1)
        for p in np.nonzero(sums)[0]:
            gaps[f"after {key_names[p // m]} / before {key_names[p % m]}"] = \
                float(sums[p])
    return Trace(kernels=kernels, full_names=full, launches=n,
                 busy_s=busy, window_s=window_s, gaps=gaps)


def profiled_drain(device):
    """A ``ServeDrain`` that profiles the serve's device work from its
    creation to the first segment boundary after the drain is requested,
    the part of the window before the drain's tail, and there stops the
    profiler and reduces its records (``trace``). The serve waits
    meanwhile; ``pause_s`` holds how long, for the window's wall time to
    leave it out."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.runtime.journal import ServeDrain

    class ProfiledDrain(ServeDrain):
        def __init__(self):
            super().__init__()
            self.trace, self.pause_s = None, 0.0
            self._prof = profile(activities=[ProfilerActivity.CUDA])
            self._prof.start()
            torch.cuda.synchronize(device)
            self._t0 = time.perf_counter()

        def poll(self, step: int) -> bool:
            draining = super().poll(step)
            if draining:
                self.stop()
            return draining

        def stop(self):
            """Stop profiling (once) and reduce the records."""
            if self.trace is not None:
                return
            t = time.perf_counter()
            torch.cuda.synchronize(device)
            window = time.perf_counter() - self._t0
            self._prof.stop()
            t1 = time.perf_counter()
            events = self._prof.profiler.kineto_results.events()
            t2 = time.perf_counter()
            self.trace = reduce(events, window)
            t3 = time.perf_counter()
            # millions of records: free them now, not at exit
            del events
            self._prof.profiler.kineto_results = None
            t4 = time.perf_counter()
            self.trace.cost_s = {"stop_s": t1 - t, "events_s": t2 - t1,
                                 "reduce_s": t3 - t2, "free_s": t4 - t3}
            self.pause_s = t4 - t

    return ProfiledDrain()
