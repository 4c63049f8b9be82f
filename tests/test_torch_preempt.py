"""Overload survival in the port — priority preemption with exact resume,
SLO classes with starvation aging, seeded fault injection and the
segment straggler watchdog — against the JAX package, on the CPU.

- State level: ``tests/test_paged.py``'s preempt / re-admit / evict
  cycles with pins run on both packages (``PagedKVState`` and
  ``PrefixIndex``) from the same inputs; after every op the allocator
  state and the index's answers are equal, ``check_invariants(pins=)``
  holds and no pinned page is free.
- Serve level, on the ``serveloop-smoke`` config (weights made by the
  JAX package): greedy serves under page-pressure preemption (pinned
  and unpinned serve), with prefix sharing, and with forced kills and
  phantom page pressure equal the JAX package's serve token for token
  and in every scheduler counter (steps, segments, admission rounds,
  prefill and shared-prefix tokens, prefix hits, preemptions; per
  request the admitted and finished step, preemptions and class), and
  solo ``generate()``. Sampled serving draws from per-request torch
  generators, not JAX keys, so a preempted sampled request is held to
  the same trace served without preemption and to solo ``generate()``
  with its ``request_generator``.
- Aging bounds the low class's admission delay as in
  ``tests/test_recovery.py`` (and equals the JAX serve); ``aged_priority``
  equals the JAX helper; the port's ``StragglerWatchdog`` keeps the
  trigger points of ``tests/test_runtime.py`` and the JAX detector's
  verdicts; ``ServeFaultInjector`` draws what the JAX injector draws;
  injected crashes raise ``SimulatedCrash`` at both points.

The reference runs with an exact ``exp2`` (``tests/test_torch_kernels.py``,
ROADMAP §C).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.attention import PrefixIndex as JIndex
from repro.configs.base import ModelConfig as JConfig
from repro.models import init_model as j_init_model
from repro.runtime.generate import ServeRequest as JRequest
from repro.runtime.generate import serve_continuous as j_serve
from repro_torch.attention import PrefixIndex
from repro_torch.configs.base import ModelConfig as TConfig
from repro_torch.launch.steps import (ServeSlotState, aged_priority,
                                      preempt_rows, request_generator)
from repro_torch.models import from_jax_params
from repro_torch.runtime.fault_tolerance import (ServeFaultInjector,
                                                 ServeFaultPlan,
                                                 SimulatedCrash)
from repro_torch.runtime.generate import (ServeRequest, generate,
                                          serve_continuous)
from repro_torch.runtime.watchdog import StragglerWatchdog, WatchdogVerdict

_CFG = dict(name="serveloop-smoke", family="dense", d_model=64, n_heads=4,
            n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=128,
            layer_groups=((("attn",), 2),), dtype="float32",
            attention_impl="ita", attention_backend="ita_onepass_pallas")
JCFG, CFG = JConfig(**_CFG), TConfig(**_CFG)
UNPINNED = dataclasses.replace(CFG, attention_backend="")
COUNTERS = ("steps", "segments", "admission_rounds", "prefill_tokens",
            "shared_prefix_tokens", "prefix_hits", "preemptions")
PER_REQUEST = ("admitted_step", "finished_step", "preemptions", "priority")
OVERLOAD_KW = dict(slots=3, segment=4, max_len=256, page_size=128,
                   num_pages=5, admission="chunked", chunk_size=48,
                   preemption=True, debug_invariants=True)


@pytest.fixture(scope="module", autouse=True)
def exact_exp2():
    """Run the reference with exact powers of two (module docstring)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnp, "exp2", lambda x: jnp.ldexp(
            jnp.ones(jnp.shape(x), jnp.float32),
            jnp.asarray(x).astype(jnp.int32)))
        jax.clear_caches()
        yield
    jax.clear_caches()


@pytest.fixture(scope="module")
def weights(exact_exp2):
    params = j_init_model(jax.random.PRNGKey(0), JCFG)
    model = from_jax_params(jax.tree.map(np.asarray, params), CFG,
                            device="cpu")
    return params, model


def serve_both(weights, reqs, cfg=CFG, **kw):
    """The port's serve of ``reqs`` held to the JAX package's serve with
    the same options and pin: tokens, counters and each request's
    schedule. Returns the port's result."""
    params, model = weights
    jkw = dict(kw)
    if "faults" in jkw:
        from repro.runtime.fault_tolerance import ServeFaultPlan as JPlan
        jkw["faults"] = JPlan(**vars(kw["faults"]))
    jcfg = dataclasses.replace(JCFG,
                               attention_backend=cfg.attention_backend)
    jres = j_serve(params, jcfg, [JRequest(r.prompt, r.gen, r.arrival,
                                           r.priority) for r in reqs], **jkw)
    res = serve_continuous(model, cfg, reqs, device="cpu", **kw)
    assert len(res.completed) == len(jres.completed) == len(reqs)
    for name in COUNTERS:
        assert getattr(res, name) == getattr(jres, name), name
    want = {c.index: c for c in jres.completed}
    for c in res.completed:
        j = want[c.index]
        np.testing.assert_array_equal(c.tokens, np.asarray(j.tokens),
                                      err_msg=f"request {c.index}")
        for name in PER_REQUEST:
            assert getattr(c, name) == getattr(j, name), (c.index, name)
    return res


def solo(model, r, **kw):
    return generate(model, CFG, torch.as_tensor(r.prompt)[None], r.gen,
                    max_len=256, device="cpu", **kw).tokens[0].numpy()


def assert_solo(model, res, reqs):
    for c in res.completed:
        np.testing.assert_array_equal(
            c.tokens, solo(model, reqs[c.index]),
            err_msg=f"request {c.index} ({c.preemptions} preemptions)")


def overload_trace(prng, n=6, plen_lo=110, plen_hi=141, gen_lo=10,
                   gen_hi=17):
    """``tests/test_serve_loop.py``'s overload trace: four low-class
    two-page requests fill an undersized pool, then two high-class ones
    arrive."""
    return [ServeRequest(
        prompt=prng.integers(0, CFG.vocab_size, int(prng.integers(
            plen_lo, plen_hi))).astype(np.int32),
        gen=int(prng.integers(gen_lo, gen_hi)), arrival=2 * i,
        priority=1 if i >= n - 2 else 0) for i in range(n)]


# ---------------------------------------------------------------------------
# State level
# ---------------------------------------------------------------------------

def test_preempt_readmit_evict_cycles_match_jax_seeded():
    """``tests/test_paged.py``'s preemption cycle: admit (adopting
    registered prefixes), register and pin full prompt pages, preempt
    (release a victim whose pages are pinned: decref, never free), ragged
    decode appends, re-admit adopting the pages back, LRU-evict and
    unpin, on both packages. After every op the allocators and the
    indexes agree, the invariants hold with the pins and no pinned page
    is free; draining leaves the pool whole."""
    from test_torch_prefix import Both

    b, g, hd, page, cap = 3, 1, 4, 4, 16
    prng = np.random.default_rng(13)
    s = Both(b, cap, g, hd, page_size=page, num_pages=11)
    index, jindex = PrefixIndex(page), JIndex(page)
    pins = {}
    fams = [prng.integers(0, 100, 2 * page).astype(np.int32)
            for _ in range(3)]
    tokens = [None] * b
    adopted = [[] for _ in range(b)]

    def kv(n):
        return prng.integers(-127, 128, (b, n, g, hd)).astype(np.int8)

    def checked(op):
        assert not bool(s.t.oversubscribed()), f"op {op}: pool overdrawn"
        s.t.check_invariants(pins=pins)
        free = set(s.col("free_stack")[:int(s.t.free_top)].tolist())
        assert not free & set(pins), f"op {op}: pinned page free"
        assert index.state_dict() == jindex.state_dict(), op

    for op in range(120):
        kind = int(prng.integers(0, 5))
        live = [r for r in range(b) if tokens[r] is not None]
        what = f"op {op}"
        if kind == 0:                              # admit, adopting hits
            free_rows = [r for r in range(b) if tokens[r] is None]
            if not free_rows:
                continue
            row = int(prng.choice(free_rows))
            fam = fams[int(prng.integers(len(fams)))]
            tail = prng.integers(0, 100,
                                 int(prng.integers(1, 8))).astype(np.int32)
            stream = np.concatenate([fam, tail])
            sh = index.lookup(stream, max_tokens=stream.size - 1)
            assert sh == jindex.lookup(stream, max_tokens=stream.size - 1)
            rest = stream.size - len(sh) * page
            if -(-stream.size // page) - len(sh) > int(s.t.free_top):
                continue                           # admission would wait
            if sh:
                pad = np.full((1, cap // page), -1, np.int32)
                pad[0, :len(sh)] = sh
                s.op("adopt_prefix", np.asarray([row], np.int32), pad,
                     np.asarray([len(sh)], np.int32),
                     np.asarray([len(sh) * page], np.int32), what=what)
            n_new = np.zeros(b, np.int32)
            n_new[row] = rest
            k = kv(rest)
            s.op("append_chunk", k, k, n_new, what=what)
            tokens[row], adopted[row] = stream, list(sh)
        elif kind == 1 and live:                   # register + pin
            row = int(prng.choice(live))
            full = int(s.col("pos")[row]) // page
            table = s.col("page_table")[row, :full]
            got = index.register(tokens[row], table)
            assert got == jindex.register(tokens[row], table)
            if got:
                pins.update((pg, 1) for pg in got)
                s.op("incref_pages", np.asarray(got, np.int32), what=what)
        elif kind == 2 and live:                   # preempt a victim
            row = int(prng.choice(live))
            mask = np.zeros(b, bool)
            mask[row] = True
            s.op("release", mask, what=what)
            tokens[row], adopted[row] = None, []
        elif kind == 3 and live:                   # ragged decode append
            row = int(prng.choice(live))
            ln = int(s.col("pos")[row])
            if ln >= cap or (ln % page == 0 and int(s.t.free_top) < 1):
                continue
            n_new = np.zeros(b, np.int32)
            n_new[row] = 1
            k = kv(1)
            s.op("append_chunk", k, k, n_new, what=what)
            tokens[row] = np.concatenate(
                [tokens[row], prng.integers(0, 100, 1).astype(np.int32)])
        elif kind == 4 and len(index):             # LRU evict + unpin
            protected = {pg for lst in adopted for pg in lst}
            n = int(prng.integers(1, 3))
            evicted = index.evict_lru(n, protected)
            assert evicted == jindex.evict_lru(n, protected)
            for pg in evicted:
                pins.pop(pg, None)
            if evicted:
                s.op("decref_pages", np.asarray(evicted, np.int32),
                     what=what)
        checked(op)
    s.op("release", np.asarray([t is not None for t in tokens]))
    evicted = index.evict_lru(len(index))
    assert evicted == jindex.evict_lru(len(jindex))
    for pg in evicted:
        pins.pop(pg, None)
    if evicted:
        s.op("decref_pages", np.asarray(evicted, np.int32))
    checked("drain")
    assert not pins and int(s.t.free_top) == 10, "pages leaked"


def test_preempt_rows_clears_victims_and_bumps_pgen():
    """``preempt_rows`` zeroes the victims' phase state, raises ``done``
    and ``pgen`` and leaves every other row (and the generators) as it
    was, as the JAX package's does."""
    from repro.launch.steps import ServeSlotState as JState
    from repro.launch.steps import preempt_rows as j_preempt
    prng = np.random.default_rng(0)
    fields = ("tok", "pos", "rem", "cursor", "plen", "prio", "pgen")
    vals = {f: prng.integers(1, 50, (4, 1) if f == "tok" else 4)
            .astype(np.int32) for f in fields}
    done = np.asarray([False, True, False, False])
    t = dataclasses.replace(
        ServeSlotState.init(4, 8, device="cpu"), done=torch.from_numpy(done),
        **{f: torch.from_numpy(v) for f, v in vals.items()})
    j = dataclasses.replace(JState.init(4, 8), done=jnp.asarray(done),
                            **{f: jnp.asarray(v) for f, v in vals.items()})
    mask = np.asarray([False, False, True, True])
    t2, j2 = preempt_rows(t, mask), j_preempt(j, jnp.asarray(mask))
    for f in fields + ("done",):
        np.testing.assert_array_equal(getattr(t2, f).numpy(),
                                      np.asarray(getattr(j2, f)), f)
    assert t2.pgen.tolist() == (vals["pgen"] + mask).tolist()
    assert t2.done.tolist() == [False, True, True, True]
    assert t2.gens == t.gens


# ---------------------------------------------------------------------------
# Serve level
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cfg", [CFG, UNPINNED], ids=["pinned", "unpinned"])
def test_preemption_resume_matches_jax_and_solo(weights, cfg):
    """``tests/test_serve_loop.py``'s overload parity: page-pressure
    preemption evicts live low-class victims mid-stream; every request,
    preempted and resumed ones included, equals the JAX serve (the same
    pin) and solo ``generate()``, with invariants checked every round;
    victims are strictly lower class, and the high class is admitted
    sooner."""
    _, model = weights
    reqs = overload_trace(np.random.default_rng(17))
    res = serve_both(weights, reqs, cfg=cfg, **OVERLOAD_KW)
    assert res.preemptions >= 1
    preempted = {c.index for c in res.completed if c.preemptions}
    assert preempted and all(reqs[i].priority == 0 for i in preempted)
    assert_solo(model, res, reqs)
    cs = res.class_summary()
    assert set(cs) == {0, 1}
    assert cs[0]["preemptions"] == res.preemptions
    assert cs[1]["preemptions"] == 0
    assert cs[1]["p95_admit_delay_steps"] < cs[0]["p95_admit_delay_steps"]
    assert res.max_class == 1 and "aging_bound_steps" not in cs[0]


def test_preemption_sampled_resume_equals_unpreempted_and_solo(weights):
    """Sampled overload serving: a victim's generator state is kept at
    eviction and restored at re-admission (a row mid re-prefill draws
    nothing), so each preempted request's draws equal the same trace
    served without preemption and solo ``generate()`` with the request's
    generator."""
    _, model = weights
    reqs = overload_trace(np.random.default_rng(17))
    kw = dict(OVERLOAD_KW, temperature=0.8, seed=42, device="cpu")
    res = serve_continuous(model, CFG, reqs, **kw)
    calm = serve_continuous(model, CFG, reqs,
                            **dict(kw, preemption=False, num_pages=None))
    assert res.preemptions >= 1 and calm.preemptions == 0
    assert any(c.preemptions for c in res.completed)
    want = {c.index: c.tokens for c in calm.completed}
    for c in res.completed:
        np.testing.assert_array_equal(c.tokens, want[c.index],
                                      err_msg=f"request {c.index}")
        np.testing.assert_array_equal(
            c.tokens, solo(model, reqs[c.index], temperature=0.8,
                           generator=request_generator(42, c.index, "cpu")),
            err_msg=f"request {c.index} ({c.preemptions} preemptions)")


def test_preemption_with_prefix_sharing_decrefs_not_frees(weights):
    """Victims whose prompt pages are pinned in the index release their
    rows by decref, never a free; the resumed admission adopts them back.
    Tokens and counters equal the JAX serve, tokens solo
    ``generate()``."""
    _, model = weights
    prng = np.random.default_rng(31)
    fam = prng.integers(0, CFG.vocab_size, 128).astype(np.int32)
    reqs = []
    for i in range(6):
        if i < 4:
            tail = prng.integers(0, CFG.vocab_size,
                                 int(prng.integers(4, 13))).astype(np.int32)
            p, prio = np.concatenate([fam, tail]), 0
        else:
            p, prio = prng.integers(0, CFG.vocab_size,
                                    130 + i).astype(np.int32), 1
        reqs.append(ServeRequest(prompt=p, gen=int(prng.integers(10, 17)),
                                 arrival=2 * i, priority=prio))
    res = serve_both(weights, reqs, **dict(OVERLOAD_KW, num_pages=6,
                                           prefix_sharing=True))
    assert res.preemptions >= 1 and res.prefix_hits >= 1
    assert_solo(model, res, reqs)


class VirtualClock:
    """Stands in for the serve's ``time`` module: each reading advances 10
    ms and ``sleep`` advances the clock by its argument, so segment times
    do not depend on the machine's load."""

    def __init__(self):
        self.now = 0.0

    def perf_counter(self):
        self.now += 0.01
        return self.now

    def sleep(self, seconds):
        self.now += seconds


def test_fault_injection_kill_mid_prompt_pressure_and_straggler(weights,
                                                                monkeypatch):
    """A forced kill lands while the victim is mid-prompt (it resumes its
    prompt from scratch), phantom page pressure delays a round and an
    injected sleep is flagged by the watchdog (segment times on a virtual
    clock); tokens and counters equal the JAX serve and solo
    ``generate()``."""
    from repro_torch.runtime import generate as G
    _, model = weights
    prng = np.random.default_rng(7)
    reqs = [ServeRequest(prompt=prng.integers(0, CFG.vocab_size,
                                              200).astype(np.int32),
                         gen=32, arrival=0),
            ServeRequest(prompt=prng.integers(0, CFG.vocab_size,
                                              40).astype(np.int32),
                         gen=24, arrival=8)]
    plan = ServeFaultPlan(seed=3, kill_steps=(4,), pressure_steps=(8,),
                          pressure_pages=4, straggle_steps=(40,),
                          straggle_s=0.25)
    monkeypatch.setattr(G, "time", VirtualClock())
    res = serve_both(weights, reqs, slots=2, segment=4, max_len=256,
                     page_size=128, admission="chunked", chunk_size=16,
                     faults=plan, debug_invariants=True)
    killed = {c.index: c.preemptions for c in res.completed}
    assert res.preemptions >= 1 and killed[0] >= 1
    assert res.straggler_segments == 1, "the injected sleep was not flagged"
    assert_solo(model, res, reqs)


def test_kills_and_pressure_with_priority_preemption_match_jax(weights):
    """Kills, page pressure and priority preemption with prefix sharing in
    one serve: tokens and counters equal the JAX serve."""
    _, model = weights
    prng = np.random.default_rng(5)
    system = prng.integers(0, CFG.vocab_size, 128).astype(np.int32)
    reqs = [ServeRequest(
        prompt=np.concatenate([system, prng.integers(
            0, CFG.vocab_size, int(prng.integers(3, 40))).astype(np.int32)]),
        gen=int(prng.integers(6, 14)), arrival=3 * i,
        priority=int(i % 3 == 2)) for i in range(6)]
    plan = ServeFaultPlan(seed=1, kill_steps=(8, 20), pressure_steps=(12,),
                          pressure_pages=2)
    res = serve_both(weights, reqs, **dict(OVERLOAD_KW, num_pages=7,
                                           prefix_sharing=True, faults=plan,
                                           aging_steps=16))
    assert res.preemptions >= 2
    assert_solo(model, res, reqs)


def test_preemption_and_faults_require_chunked_admission(weights):
    _, model = weights
    reqs = [ServeRequest(prompt=np.zeros(4, np.int32), gen=2)]
    kw = dict(slots=2, segment=4, max_len=128, admission="stall",
              device="cpu")
    with pytest.raises(ValueError, match="chunked"):
        serve_continuous(model, CFG, reqs, preemption=True, **kw)
    with pytest.raises(ValueError, match="chunked"):
        serve_continuous(model, CFG, reqs,
                         faults=ServeFaultPlan(kill_steps=(1,)), **kw)


@pytest.mark.parametrize("where", ["crash_steps", "crash_after_steps"])
def test_injected_crash_raises(weights, where):
    """``crash_steps`` raises at the top of a round, ``crash_after_steps``
    after a segment's readback (``tests/test_torch_recovery.py`` recovers
    from both through the journal)."""
    _, model = weights
    reqs = [ServeRequest(prompt=np.arange(6, dtype=np.int32), gen=12)]
    with pytest.raises(SimulatedCrash) as err:
        serve_continuous(model, CFG, reqs, slots=2, segment=4, max_len=128,
                         faults=ServeFaultPlan(**{where: (5,)}),
                         device="cpu")
    assert err.value.step == 8
    assert err.value.where == ("round-boundary" if where == "crash_steps"
                               else "mid-segment")


# ---------------------------------------------------------------------------
# Aging, the watchdog and the injector
# ---------------------------------------------------------------------------

def starvation_trace():
    prng = np.random.default_rng(0)
    highs = [ServeRequest(prompt=prng.integers(0, 128, 6).astype(np.int32),
                          gen=8, arrival=i, priority=1) for i in range(14)]
    low = ServeRequest(prompt=prng.integers(0, 128, 6).astype(np.int32),
                       gen=4, arrival=4, priority=0)
    return highs + [low], len(highs)


def test_aging_bounds_low_class_admission_delay(weights):
    """``tests/test_recovery.py``'s high-class flood: without aging the low
    class starves; with ``aging_steps`` its admission delay stays within
    ``aging_bound_steps`` plus one residency. Both serves equal the JAX
    package's, and aging changes no token."""
    reqs, li = starvation_trace()
    kw = dict(slots=2, segment=4, max_len=128, page_size=128, chunk_size=5,
              debug_invariants=True)
    off = serve_both(weights, reqs, **kw)
    on = serve_both(weights, reqs, aging_steps=8, **kw)
    c_off = next(c for c in off.completed if c.index == li)
    c_on = next(c for c in on.completed if c.index == li)
    d_off = c_off.admitted_step - c_off.arrival
    d_on = c_on.admitted_step - c_on.arrival
    bound = on.class_summary()[0]["aging_bound_steps"]
    assert bound == 8 * (1 + 1 - 0)
    residency = 4 * -(-(2 + 8) // 4) + 4
    assert d_on <= bound + residency, (d_on, bound)
    assert d_off > d_on + residency, (d_off, d_on)
    assert "aging_bound_steps" not in off.class_summary()[0]
    assert off.class_summary()[0]["max_admit_delay_steps"] == d_off
    want = {c.index: c.tokens for c in off.completed}
    for c in on.completed:
        np.testing.assert_array_equal(c.tokens, want[c.index])


def test_aged_priority_properties():
    """Identity when off, +1 per ``aging_steps``, capped at max_class + 1,
    monotone in the wait, never below the class, a pre-arrival wait
    clamped; equal to the JAX helper."""
    from repro.launch.steps import aged_priority as j_aged
    prng = np.random.default_rng(0)
    for _ in range(200):
        prio = int(prng.integers(0, 4))
        max_class = int(prng.integers(prio, 5))
        aging = int(prng.integers(1, 20))
        w = int(prng.integers(-10, 200))
        eff = aged_priority(prio, w, aging, max_class)
        assert eff == j_aged(prio, w, aging, max_class)
        assert aged_priority(prio, w, None, max_class) == prio
        assert aged_priority(prio, w, 0, max_class) == prio
        assert eff == min(prio + max(w, 0) // aging, max_class + 1)
        assert prio <= eff <= max_class + 1
        assert aged_priority(prio, w + aging, aging, max_class) >= eff
        assert aged_priority(prio, aging * (max_class + 1 - prio), aging,
                             max_class) == max_class + 1


def test_aging_requires_positive_steps(weights):
    _, model = weights
    reqs, _ = starvation_trace()
    with pytest.raises(ValueError, match="aging_steps"):
        serve_continuous(model, CFG, reqs, aging_steps=-1, slots=2,
                         segment=4, max_len=128, device="cpu")


def test_straggler_watchdog_trigger_semantics():
    """``tests/test_runtime.py``'s trigger points: silent through warm-up,
    the reference is the window's median without the newest sample,
    persistent at ``streak_threshold`` consecutive flags with the streak
    reset after, a normal sample resets the streak."""
    wd = StragglerWatchdog(factor=2.0, window=8, min_samples=4,
                           streak_threshold=3)
    assert wd.observe(100.0) == WatchdogVerdict(False, False, 0.0)
    wd = StragglerWatchdog(factor=2.0, window=8, min_samples=4,
                           streak_threshold=3)
    for _ in range(6):
        v = wd.observe(1.0)
        assert not v.straggler
    assert v.median == 1.0 and wd.events == 0
    assert wd.observe(10.0) == WatchdogVerdict(True, False, 1.0)
    v = wd.observe(10.0)
    assert v.straggler and not v.persistent
    v = wd.observe(10.0)
    assert v.straggler and v.persistent
    v = wd.observe(10.0)
    assert v.straggler and not v.persistent
    assert wd.events == 4
    assert not wd.observe(1.0).straggler
    v = wd.observe(50.0)
    assert v.straggler and not v.persistent
    with pytest.raises(ValueError, match="history"):
        StragglerWatchdog(window=1)
    with pytest.raises(ValueError, match="history"):
        StragglerWatchdog(min_samples=1)


def test_watchdog_and_injector_equal_jax():
    """On one seeded stream of segment times the port's watchdog gives the
    JAX detector's verdicts; on one seeded plan the port's injector fires
    the JAX injector's kills, pressure, sleeps and crashes round by
    round, its RNG drawing the same numbers."""
    from repro.runtime.fault_tolerance import ServeFaultInjector as JInj
    from repro.runtime.fault_tolerance import ServeFaultPlan as JPlan
    from repro.runtime.watchdog import StragglerWatchdog as JWatchdog
    prng = np.random.default_rng(4)
    kw = dict(factor=1.5, window=6, min_samples=4)
    t, j = StragglerWatchdog(**kw), JWatchdog(**kw)
    for dt in prng.gamma(2.0, 0.05, 80) * (1 + 5 * (prng.random(80) < 0.1)):
        assert vars(t.observe(dt)) == vars(j.observe(dt))
    assert t.events == j.events > 0
    fields = dict(seed=9, kill_prob=0.3, kill_steps=(4, 4, 30),
                  pressure_prob=0.2, pressure_pages=3, pressure_steps=(8,),
                  straggle_prob=0.1, straggle_s=0.01, straggle_steps=(12,),
                  crash_steps=(40,), crash_after_steps=(44,))
    ti, ji = ServeFaultInjector(ServeFaultPlan(**fields)), JInj(
        JPlan(**fields))
    assert ti.plan.may_kill and ti.plan.may_crash
    for step in range(0, 64, 4):
        for name in ("want_crash", "want_kill", "phantom_pages", "straggle",
                     "want_crash_after"):
            assert getattr(ti, name)(step) == getattr(ji, name)(step), \
                (step, name)
        assert ti.rng.integers(1000) == ji.rng.integers(1000)
    for name in ("kills_requested", "pressure_events", "straggle_events",
                 "crashes_fired"):
        assert getattr(ti, name) == getattr(ji, name), name
