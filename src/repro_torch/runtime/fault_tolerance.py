"""Seeded fault injection for ``serve_continuous``
(``repro.runtime.fault_tolerance``, its serving half; the training
driver comes with the training slice, ROADMAP "Training").

A ``ServeFaultPlan`` says which faults to force and when, on the
scheduler's virtual clock (decode steps); the serve loop polls a
``ServeFaultInjector`` once per scheduling round, and the injector
counts what it injected so a test can check that the faults fired.
"""

from __future__ import annotations

import dataclasses

import numpy as np


class SimulatedCrash(RuntimeError):
    """Raised by ``serve_continuous`` at an injected crash point: the
    process "dies" and all in-memory serve state is abandoned, as a
    SIGKILL would abandon it. Recovering from it takes the journal
    (ROADMAP, "Journal, snapshot, recovery and drain")."""

    def __init__(self, step: int, where: str):
        super().__init__(f"simulated crash at step {step} ({where})")
        self.step = step
        self.where = where


@dataclasses.dataclass(frozen=True)
class ServeFaultPlan:
    """Seeded fault plan: each family has a step list (``kill_steps=(12,)``
    fires at the first round at or past step 12) and an independent
    per-round probability.

    - **kills**: force-preempt one live resumable slot; the victim
      resumes through chunked re-prefill of its prompt and generated
      prefix, even with priority preemption off.
    - **page pressure**: subtract ``pressure_pages`` phantom pages from
      one round's admission budget.
    - **stragglers**: sleep ``straggle_s`` before a segment, for the
      segment watchdog to flag.
    - **crashes**: raise ``SimulatedCrash``: ``crash_steps`` at the top
      of a scheduling round, ``crash_after_steps`` after a segment's
      readback, before its tokens are recorded. Each listed step fires
      once per injector.
    """

    seed: int = 0
    kill_prob: float = 0.0
    kill_steps: tuple = ()
    pressure_prob: float = 0.0
    pressure_pages: int = 0
    pressure_steps: tuple = ()
    straggle_prob: float = 0.0
    straggle_s: float = 0.0
    straggle_steps: tuple = ()
    crash_steps: tuple = ()
    crash_after_steps: tuple = ()

    @property
    def may_kill(self) -> bool:
        return self.kill_prob > 0.0 or bool(self.kill_steps)

    @property
    def may_crash(self) -> bool:
        return bool(self.crash_steps) or bool(self.crash_after_steps)


class ServeFaultInjector:
    """The runtime side of a ``ServeFaultPlan``: one seeded numpy RNG and
    one cursor per step list, with counts of what was injected."""

    def __init__(self, plan: ServeFaultPlan):
        self.plan = plan
        self.rng = np.random.default_rng(plan.seed)
        self._kills = sorted(plan.kill_steps)
        self._pressure = sorted(plan.pressure_steps)
        self._straggles = sorted(plan.straggle_steps)
        self._crashes = sorted(plan.crash_steps)
        self._crashes_after = sorted(plan.crash_after_steps)
        self.kills_requested = 0
        self.pressure_events = 0
        self.straggle_events = 0
        self.crashes_fired = 0

    @staticmethod
    def _due(pending: list, step: int) -> bool:
        hit = False
        while pending and pending[0] <= step:
            pending.pop(0)
            hit = True
        return hit

    def want_kill(self, step: int) -> bool:
        hit = self._due(self._kills, step)
        if self.plan.kill_prob > 0.0 \
                and self.rng.random() < self.plan.kill_prob:
            hit = True
        self.kills_requested += hit
        return hit

    def phantom_pages(self, step: int) -> int:
        """Pages to subtract from this round's admission budget."""
        hit = self._due(self._pressure, step)
        if self.plan.pressure_prob > 0.0 \
                and self.rng.random() < self.plan.pressure_prob:
            hit = True
        if not hit:
            return 0
        self.pressure_events += 1
        return int(self.plan.pressure_pages)

    def want_crash(self, step: int) -> bool:
        """True when a crash at the top of this round is due."""
        hit = self._due(self._crashes, step)
        self.crashes_fired += hit
        return hit

    def want_crash_after(self, step: int) -> bool:
        """True when a crash after this segment's readback is due."""
        hit = self._due(self._crashes_after, step)
        self.crashes_fired += hit
        return hit

    def straggle(self, step: int) -> float:
        """Seconds to stall before the next segment."""
        hit = self._due(self._straggles, step)
        if self.plan.straggle_prob > 0.0 \
                and self.rng.random() < self.plan.straggle_prob:
            hit = True
        if not hit:
            return 0.0
        self.straggle_events += 1
        return float(self.plan.straggle_s)
