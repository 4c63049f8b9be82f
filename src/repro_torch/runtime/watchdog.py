"""Straggler watchdog (``repro.runtime.watchdog``): robust moving-median
timing of steps or serve segments.

``serve_continuous`` runs it over its segment wall times
(``ServeResult.straggler_segments``; the fault plan's injected sleeps
must trip it). The trigger points are the reference's:

- keep the last ``window`` observations;
- flag nothing until ``min_samples`` observations exist (the first
  segments pay kernel builds and graph captures);
- the reference is the median of the window without the newest sample,
  so a straggler does not dilute its own reference;
- ``dt > factor * median`` flags a straggler; ``streak_threshold``
  consecutive flags also report ``persistent`` (the cue for a protective
  action) and reset the streak.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class WatchdogVerdict:
    straggler: bool              # this observation exceeded factor * median
    persistent: bool             # streak_threshold consecutive stragglers
    median: float                # the reference median (0.0 during warm-up)


class StragglerWatchdog:
    """Moving-median straggler detector (module docstring)."""

    def __init__(self, factor: float = 2.0, window: int = 32,
                 min_samples: int = 8, streak_threshold: int = 3):
        if window < 2 or min_samples < 2:
            raise ValueError("watchdog needs >= 2 samples of history to "
                             "form a median reference")
        self.factor = float(factor)
        self.window = int(window)
        self.min_samples = int(min_samples)
        self.streak_threshold = int(streak_threshold)
        self.times: list[float] = []
        self.events = 0              # total straggler observations
        self._streak = 0

    def observe(self, dt: float) -> WatchdogVerdict:
        """Record one step or segment duration; returns the verdict."""
        self.times.append(float(dt))
        hist = self.times[-self.window:]
        if len(hist) < self.min_samples:
            return WatchdogVerdict(False, False, 0.0)
        med = float(np.median(hist[:-1]))
        if dt > self.factor * med:
            self.events += 1
            self._streak += 1
            persistent = self._streak >= self.streak_threshold
            if persistent:
                self._streak = 0
            return WatchdogVerdict(True, persistent, med)
        self._streak = 0
        return WatchdogVerdict(False, False, med)
