"""Fault tolerance (``repro.runtime.fault_tolerance``): the training
driver with checkpoint/restart, and seeded fault injection for
``serve_continuous``.

``TrainDriver`` runs a train step over a ``DataPipeline``:

- **Checkpoint/restart**: asynchronous checkpoints every ``ckpt_every``
  steps of ``{"params": the model's parameters by name, "opt":
  OptState}`` with the pipeline's state in ``extra`` (the ``step_%08d``
  family of ``checkpoint.Checkpointer``); ``maybe_restore`` loads the
  newest into the model in place and replays the pipeline to its step,
  so training continues bit for bit. Under a mesh the checkpoint holds
  whole tensors, and ``param_shardings``/``opt_shardings`` place them
  onto the TrainDriver's mesh, which may differ from the one that saved it
  (the elastic re-mesh).
- **Stragglers**: the shared ``runtime.watchdog.StragglerWatchdog``
  (also run by the serve loop over its segments) flags steps slower than
  ``straggler_factor`` times the moving median; a persistent straggler
  triggers a protective checkpoint.
- **Preemption** is simulated with ``inject_failure_at``.

A ``ServeFaultPlan`` says which faults to force in a serve and when, on
the scheduler's virtual clock (decode steps); the serve loop polls a
``ServeFaultInjector`` once per scheduling round, and the injector
counts what it injected so a test can check that the faults fired.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.checkpoint.checkpointing import Checkpointer
from repro_torch.runtime.watchdog import StragglerWatchdog


@dataclasses.dataclass
class FTConfig:
    ckpt_dir: str
    ckpt_every: int = 50
    keep: int = 3
    straggler_factor: float = 2.0
    straggler_ckpt_threshold: int = 3     # consecutive slow steps
    inject_failure_at: int | None = None  # simulate preemption (tests)


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


class TrainDriver:
    """Runs ``train_step(model, opt_state, batch) -> (opt_state,
    metrics)`` (``launch.steps.make_train_step``) over ``pipeline``,
    checkpointing and restoring as the module docstring says. The model
    is trained in place; this object holds ``opt_state``.
    ``param_shardings``/``opt_shardings`` (``launch.sharding``): where a
    restore places the parameters and the optimizer state."""

    def __init__(self, ft: FTConfig, train_step, model, opt_state,
                 pipeline, param_shardings=None, opt_shardings=None):
        self.ft = ft
        self.p_sh, self.o_sh = param_shardings, opt_shardings
        self.step_fn = train_step
        self.model = model
        self.opt_state = opt_state
        self.pipeline = pipeline
        self.ckpt = Checkpointer(ft.ckpt_dir, keep=ft.keep)
        self.step = 0
        self.wd = StragglerWatchdog(
            factor=ft.straggler_factor,
            streak_threshold=ft.straggler_ckpt_threshold)
        self.step_times = self.wd.times        # same list, shared in place
        self._last_saved = None

    def _state(self) -> dict:
        return {"params": {n: p.detach()
                           for n, p in self.model.named_parameters()},
                "opt": self.opt_state}

    # -- restart ------------------------------------------------------------

    def maybe_restore(self) -> bool:
        latest = self.ckpt.latest_step()
        if latest is None:
            return False
        shards = ({"params": self.p_sh, "opt": self.o_sh}
                  if self.p_sh is not None else None)
        restored, meta = self.ckpt.restore(self._state(), step=latest,
                                           shardings=shards)
        with torch.no_grad():
            for n, p in self.model.named_parameters():
                p.copy_(restored["params"][n])
        self.opt_state = restored["opt"]
        self.pipeline.load_state_dict(meta["extra"]["pipeline"])
        self.step = meta["step"]
        return True

    # -- main loop ----------------------------------------------------------

    @property
    def straggler_events(self) -> int:
        return self.wd.events

    def _watchdog(self, dt: float):
        verdict = self.wd.observe(dt)
        if verdict.straggler:
            print(f"[ft] straggler: step {self.step} took {dt:.3f}s "
                  f"(median {verdict.median:.3f}s)", flush=True)
            if verdict.persistent:
                print("[ft] persistent straggler -> protective "
                      "checkpoint", flush=True)
                self._save()

    def _save(self, blocking: bool = False):
        if self._last_saved == self.step:
            if blocking:
                self.ckpt.wait()
            return
        self._last_saved = self.step
        self.ckpt.save(self.step, self._state(),
                       extra={"pipeline": self.pipeline.state_dict()},
                       blocking=blocking)

    def run(self, num_steps: int, log_every: int = 10):
        metrics = {}
        while self.step < num_steps:
            if self.ft.inject_failure_at is not None \
                    and self.step == self.ft.inject_failure_at:
                self.ckpt.wait()
                raise RuntimeError(f"injected node failure at step "
                                   f"{self.step}")
            batch = self.pipeline.next()
            t0 = time.time()
            self.opt_state, metrics = self.step_fn(
                self.model, self.opt_state, batch)
            if metrics["loss"].is_cuda:          # block_until_ready
                torch.cuda.synchronize(metrics["loss"].device)
            self._watchdog(time.time() - t0)
            self.step += 1
            if self.step % self.ft.ckpt_every == 0:
                self._save()
            if log_every and self.step % log_every == 0:
                print(f"[train] step {self.step} "
                      f"loss {float(metrics['loss']):.4f} "
                      f"({self.step_times[-1]:.2f}s)", flush=True)
        self._save(blocking=True)
        self.ckpt.wait()
        return metrics
