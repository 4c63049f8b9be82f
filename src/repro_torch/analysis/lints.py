"""Capture-hygiene lints for the port's served and fused loops
(``repro.analysis.lints``, recast for CUDA graphs).

The reference guards its jitted loops against recompilation and unused
donation. The port's loops replay CUDA graphs (``launch.steps.
CapturedSteps``), so the same contracts read:

- **pow2-variant-contract** (anywhere): ``serve_continuous`` keys its
  segment on ``mixed_steps = min(segment, _next_pow2(n_steps))``, so
  any trace builds at most ``floor(log2(segment)) + 2`` variants: a
  closed form over every per-segment step count.
- **serve-variant-bound** (anywhere): the ``seg_fns`` variants a serve
  of the reference's lint trace builds stay within that bound.
- **capture-once** (card): every ``CapturedSteps`` graph is captured
  exactly once over a serve and two fused ``generate()`` calls.
- **preemption-no-recapture** (card): the reference's overload trace,
  served twice with preemption, evicts a victim at least once a run
  (``launch.steps.preempt_rows``), and no step is captured again.
- **carries-in-place** (card): the counterpart of ``donation-used``.
  Every step of one ``CapturedSteps`` returns the same static carry (the
  KV rings, the page pool, the slot state keep their ``data_ptr``
  across segments): nothing is copied to a new buffer.
- **no-host-sync-in-replay** (card): ``torch.cuda.set_sync_debug_mode
  ("error")`` holds across every replay: nothing in a replayed step
  reads the card from the host.

The card lints drive the real loops at a tiny config on the card; on a
machine without one they are reported as not run (``"ran": False``),
never as passed.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

LINT_CONFIG = dict(
    d_model=32, n_heads=2, n_kv_heads=2, head_dim=16, d_ff=64,
    vocab_size=64, n_layers=1)

SERVE_SEGMENT = 8
CARD_LINTS = ("capture-once", "preemption-no-recapture", "carries-in-place",
              "no-host-sync-in-replay")


def expected_variant_bound(segment: int) -> int:
    """Max distinct ``mixed_steps`` values: the powers of two up to
    ``segment`` plus ``segment`` itself (when not a power of two) plus
    the pure decode segment — the pow2-rounding contract."""
    return int(math.floor(math.log2(segment))) + 2


def lint_pow2_contract(segment: int = SERVE_SEGMENT,
                       max_steps: int = 1024) -> dict:
    """Closed-form check: the variant key is bounded over *every*
    possible per-segment step count, not just the ones a sample trace
    happens to produce."""
    from repro_torch.runtime.generate import _next_pow2
    variants = {min(segment, _next_pow2(n)) for n in range(1, max_steps + 1)}
    bound = expected_variant_bound(segment)
    return {
        "name": "pow2-variant-contract", "ran": True,
        "ok": len(variants) <= bound,
        "detail": f"{len(variants)} distinct mixed_steps variants over "
                  f"n_steps in [1, {max_steps}] at segment={segment} "
                  f"(bound {bound}): {sorted(variants)}",
    }


def _tiny_cfg():
    from repro_torch.configs.base import ModelConfig
    c = LINT_CONFIG
    return ModelConfig(
        name="analysis-lint", family="dense", d_model=c["d_model"],
        n_heads=c["n_heads"], n_kv_heads=c["n_kv_heads"],
        head_dim=c["head_dim"], d_ff=c["d_ff"],
        vocab_size=c["vocab_size"],
        layer_groups=((("attn",), c["n_layers"]),), dtype="float32",
        attention_impl="ita", attention_backend="ita_onepass_pallas")


def _lint_trace(n_requests: int, vocab: int, seed: int = 7):
    from repro_torch.runtime.generate import ServeRequest
    prng = np.random.default_rng(seed)
    reqs, step = [], 0
    for _ in range(n_requests):
        plen = int(prng.integers(3, 14))
        reqs.append(ServeRequest(
            prompt=prng.integers(0, vocab, plen).astype(np.int32),
            gen=int(prng.integers(1, 10)), arrival=step))
        step += int(prng.integers(0, 4))
    return reqs


def _overload_trace(vocab: int):
    """A low-class request holds 2 of the pool's 3 allocatable pages when
    a high-class arrival needs 2: victim eviction, page release,
    re-admission with the longer resumed prompt."""
    from repro_torch.runtime.generate import ServeRequest
    prng = np.random.default_rng(11)

    def req(arrival, priority):
        return ServeRequest(
            prompt=prng.integers(0, vocab, 130).astype(np.int32),
            gen=20, arrival=arrival, priority=priority)
    return [req(0, 0), req(2, 1)]


def _serve(model, cfg, reqs, device, **kw):
    from repro_torch.runtime.generate import serve_continuous
    return serve_continuous(model, cfg, reqs, slots=2,
                            segment=SERVE_SEGMENT, page_size=128,
                            admission="chunked", device=device, **kw)


def lint_serve_variants(model, cfg, n_requests: int, device) -> dict:
    """The serve's segment variants over the reference's lint trace
    (``make_serve_segment`` is wrapped to record each ``mixed_steps``)."""
    from repro_torch.launch import steps as STEPS
    seen = []
    orig = STEPS.make_serve_segment

    def recording(*args, **kw):
        seen.append(kw.get("mixed_steps") or 0)
        return orig(*args, **kw)

    STEPS.make_serve_segment = recording
    try:
        _serve(model, cfg, _lint_trace(n_requests, cfg.vocab_size), device,
               max_len=128, chunk_size=5)
    finally:
        STEPS.make_serve_segment = orig
    bound = expected_variant_bound(SERVE_SEGMENT)
    return {
        "name": "serve-variant-bound", "ran": True,
        "ok": len(seen) <= bound and len(set(seen)) == len(seen),
        "detail": f"{len(seen)} serve-segment variants built over the "
                  f"trace (bound {bound} at segment={SERVE_SEGMENT}): "
                  f"mixed_steps={sorted(seen)}",
    }


class _CaptureLog:
    """``CapturedSteps`` instrumented: captures per (object, step name),
    the carry's data pointers at every step, and the replays run under
    ``set_sync_debug_mode("error")`` (a sync raises; the error is
    kept). The log holds the objects it meets: a freed one's ``id`` could
    name the next."""

    def __init__(self):
        self.captures: dict = {}
        self.ptrs: dict = {}
        self.replays = 0
        self.sync_errors: list[str] = []

    @contextlib.contextmanager
    def installed(self):
        from repro_torch.launch import steps as STEPS
        cls = STEPS.CapturedSteps
        capture, run = cls._warm_up_and_capture, cls.run
        log = self

        def counted_capture(obj, name, body, carry):
            key = (obj, name)
            log.captures[key] = log.captures.get(key, 0) + 1
            return capture(obj, name, body, carry)

        def watched_run(obj, name, body, carry):
            replay = name in obj.graphs
            mode = torch.cuda.get_sync_debug_mode()
            if replay:
                torch.cuda.set_sync_debug_mode("error")
                log.replays += 1
            try:
                out, outs = run(obj, name, body, carry)
            except RuntimeError as e:
                if not replay:
                    raise
                log.sync_errors.append(f"{name}: {e}".splitlines()[0])
                raise
            finally:
                torch.cuda.set_sync_debug_mode(mode)
            ptrs = tuple(t.data_ptr() for t in STEPS.tree_leaves(out))
            log.ptrs.setdefault(obj, set()).add(ptrs)
            return out, outs

        cls._warm_up_and_capture, cls.run = counted_capture, watched_run
        try:
            yield self
        finally:
            cls._warm_up_and_capture, cls.run = capture, run


def card_lints(model, cfg, n_requests: int) -> list:
    """The four card lints on one card (module docstring)."""
    from repro_torch.runtime.generate import generate
    log = _CaptureLog()
    preempts, overload_captures = [], []
    with log.installed():
        _serve(model, cfg, _lint_trace(n_requests, cfg.vocab_size), "cuda",
               max_len=128, chunk_size=5)
        prompts = torch.as_tensor(
            np.arange(2 * 6, dtype=np.int64).reshape(2, 6) % cfg.vocab_size)
        for _ in range(2):
            generate(model, cfg, prompts, 5, max_len=64, device="cuda")
        steady = dict(log.captures)
        for _ in range(2):
            before = dict(log.captures)
            res = _serve(model, cfg, _overload_trace(cfg.vocab_size), "cuda",
                         max_len=256, num_pages=4, chunk_size=64,
                         preemption=True)
            preempts.append(res.preemptions)
            overload_captures.append({k: n for k, n in log.captures.items()
                                      if before.get(k) != n})
    twice = {name: n for (_, name), n in steady.items() if n != 1}
    recaptured = [{name: n for (_, name), n in caps.items()}
                  for caps in overload_captures]
    moved = [len(p) for p in log.ptrs.values() if len(p) > 1]
    return [
        {"name": "capture-once", "ran": True,
         "ok": bool(steady) and not twice,
         "detail": f"{len(steady)} graphs captured over a serve and two "
                   f"fused generate() calls, each once"
                   if not twice else f"graphs captured more than once: "
                   f"{twice}"},
        {"name": "preemption-no-recapture", "ran": True,
         "ok": min(preempts) >= 1
         and all(all(n == 1 for n in r.values()) for r in recaptured),
         "detail": f"victim eviction fired {preempts} times over two "
                   f"identical overload serves; captures per serve "
                   f"{recaptured} (each step once: no recapture)"},
        {"name": "carries-in-place", "ran": True, "ok": not moved,
         "detail": f"every step of {len(log.ptrs)} CapturedSteps returned "
                   f"its static carry (pools and rings at one data_ptr)"
                   if not moved else f"carries moved to new buffers: "
                   f"{moved} distinct carries"},
        {"name": "no-host-sync-in-replay", "ran": True,
         "ok": log.replays > 0 and not log.sync_errors,
         "detail": f"{log.replays} replays under set_sync_debug_mode"
                   f"('error'), no synchronizing call"
                   if not log.sync_errors else
                   f"replays synchronized: {log.sync_errors[:3]}"},
    ]


def run_lints(*, smoke: bool = False, device="cuda") -> dict:
    """Run every lint; returns ``{"ok", "lints"}``. ``device`` runs the
    serve: the card by default (``resolve_device`` raises without one),
    the CPU only when the caller asks. The card lints run only on the
    card and are reported with ``"ran": False`` on the CPU. ``ok``
    covers the lints that ran. ``smoke`` shortens the serve trace; the
    contracts checked are identical."""
    from repro_torch.device import resolve_device
    from repro_torch.kernels.common import exact_float32_matmul
    from repro_torch.models import init_model
    device = resolve_device(device)
    cfg = _tiny_cfg()
    if device.type == "cuda":
        exact_float32_matmul()
    model = init_model(cfg, seed=0, device=device)
    n_requests = 6 if smoke else 12
    results = [lint_pow2_contract(),
               lint_serve_variants(model, cfg, n_requests, device)]
    if device.type == "cuda":
        try:
            results += card_lints(model, cfg, n_requests)
        except RuntimeError as e:        # a sync under replay, or worse
            results += [{"name": name, "ran": True, "ok": False,
                         "detail": f"{type(e).__name__}: {e}"}
                        for name in CARD_LINTS]
    else:
        results += [{"name": name, "ran": False, "ok": None,
                     "detail": "needs a CUDA card: not run"}
                    for name in CARD_LINTS]
    return {"ok": all(r["ok"] for r in results if r["ran"]),
            "lints": results}
