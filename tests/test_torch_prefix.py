"""Prefix sharing in the port (``PagedKVState.adopt_prefix``,
``incref_pages``/``decref_pages``, copy-on-write, ``PrefixIndex`` and
``serve_continuous(prefix_sharing=True)``) against the JAX package, on
the CPU.

- State level: the op sequences of ``tests/test_paged.py`` (a ragged
  ``append_chunk`` straddling pages while a neighbour copies the same
  shared pages on write; the seeded refcount-partition property over
  admit, adopt, pin, unpin, append and repeated release) run on both
  packages from the same inputs. After every op ``page_table``,
  ``ref_count``, ``free_stack[:free_top]``, ``free_top`` and ``pos`` are
  equal (and the K/V bytes where the op writes them), and
  ``check_invariants(pins=)`` holds.
- ``PrefixIndex``: the host semantics of ``tests/test_paged.py``, and
  chain keys, lookups, registrations, evictions and ``state_dict`` equal
  to the JAX package's index for the same tokens.
- Serve level, on the ``serveloop-smoke`` config of
  ``tests/test_serve_loop.py`` (weights made by the JAX package, loaded
  with ``from_jax_params``): greedy serves with prefix sharing equal the
  JAX package's serve token for token and in every scheduler counter
  (steps, segments, admission rounds, prefill and shared-prefix tokens,
  prefix hits, preemptions; per request the admitted and finished step,
  preemptions and class), the serve without sharing and solo
  ``generate()``, with the allocator invariants checked every round;
  also under LRU eviction of the index. Stall admission refuses
  sharing. (The reference's mixed ``attn``/``swa`` geometry case needs
  the ``swa`` block, which the port does not build yet.)

The reference runs with an exact ``exp2`` (``tests/test_torch_kernels.py``,
ROADMAP §C).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.attention import PagedKVState as JPaged
from repro.attention import PrefixIndex as JIndex
from repro.configs.base import ModelConfig as JConfig
from repro.models import init_model as j_init_model
from repro.runtime.generate import ServeRequest as JRequest
from repro.runtime.generate import serve_continuous as j_serve
from repro_torch.attention import PagedKVState as TPaged
from repro_torch.attention import PrefixIndex
from repro_torch.configs.base import ModelConfig as TConfig
from repro_torch.models import from_jax_params
from repro_torch.runtime.generate import (ServeRequest, generate,
                                          serve_continuous)

FIELDS = ("page_table", "pos", "free_top", "ref_count")
_CFG = dict(name="serveloop-smoke", family="dense", d_model=64, n_heads=4,
            n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=128,
            layer_groups=((("attn",), 2),), dtype="float32",
            attention_impl="ita", attention_backend="ita_onepass_pallas")
JCFG, CFG = JConfig(**_CFG), TConfig(**_CFG)
COUNTERS = ("steps", "segments", "admission_rounds", "prefill_tokens",
            "shared_prefix_tokens", "prefix_hits", "preemptions")
PER_REQUEST = ("admitted_step", "finished_step", "preemptions", "priority")


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


# ---------------------------------------------------------------------------
# State level: both packages driven with the same op sequence
# ---------------------------------------------------------------------------

_JITTED = {}


def _jax_op(name, kw_names):
    key = (name, kw_names)
    if key not in _JITTED:
        def call(state, arrays, kw):
            return getattr(state, name)(*arrays, **kw)
        _JITTED[key] = jax.jit(call)
    return _JITTED[key]


class Both:
    """One JAX and one port ``PagedKVState`` fed the same inputs; after
    every op the allocator state (and K/V bytes, ``kv=True``) is equal."""

    def __init__(self, *args, **kw):
        self.j = JPaged.init(*args, **kw)
        self.t = TPaged.init(*args, device="cpu", **kw)

    def op(self, name, *arrays, what="", kv=False, **kw):
        kw = {k: v for k, v in kw.items() if v is not None}
        self.j = _jax_op(name, tuple(sorted(kw)))(
            self.j, tuple(jnp.asarray(a) for a in arrays),
            {k: jnp.asarray(v) for k, v in kw.items()})
        self.t = getattr(self.t, name)(
            *(torch.from_numpy(np.array(a)) for a in arrays),
            **{k: torch.from_numpy(np.array(v)) for k, v in kw.items()})
        self.same(f"{what} {name}", kv)

    def same(self, what, kv=False):
        j, t = self.j, self.t
        for f in FIELDS:
            np.testing.assert_array_equal(np.asarray(getattr(j, f)),
                                          getattr(t, f).numpy(),
                                          err_msg=f"{what}: {f}")
        top = int(t.free_top)
        np.testing.assert_array_equal(np.asarray(j.free_stack)[:top],
                                      t.free_stack[:top].numpy(),
                                      err_msg=f"{what}: free stack")
        if kv:
            p = t.num_pages
            np.testing.assert_array_equal(np.asarray(j.k), t.k[:p].numpy(),
                                          err_msg=f"{what}: k")
            np.testing.assert_array_equal(np.asarray(j.v), t.v[:p].numpy(),
                                          err_msg=f"{what}: v")

    def col(self, field):
        return getattr(self.t, field).numpy()


def _logical_view(p):
    """(B, capacity, G, hd) K bytes of each row through its page table."""
    pt = p.page_table.numpy()
    k = p.k.numpy()
    return np.stack([np.concatenate([k[pg] for pg in row]) for row in pt])


def test_append_chunk_straddling_pages_during_neighbor_cow():
    """``tests/test_paged.py``'s chunk that straddles three page boundaries
    and wraps onto its shared prefix pages while the neighbour copies the
    same shared pages on write in one call: the port equals the JAX
    package after every op, bytes included; a shared page abandoned by
    both rows at once returns to the free stack once; the logical bytes
    equal sequential masked appends and an unshared pool."""
    b, g, hd, page, npps = 2, 2, 4, 4, 4
    cap = page * npps
    prng = np.random.default_rng(21)
    P = 2 * npps + 3

    def mk():
        return Both(b, cap, g, hd, page_size=page, num_pages=P)

    pre = prng.integers(-128, 128, (1, 8, g, hd)).astype(np.int8)
    s = mk()
    s.op("write_prompts", pre, pre, lengths=np.asarray([8], np.int32),
         slots=np.asarray([0], np.int32), kv=True)
    donor = s.col("page_table")[0, :2]
    s.op("adopt_prefix", np.asarray([1], np.int32), donor[None, :],
         np.asarray([2], np.int32), np.asarray([8], np.int32))
    np.testing.assert_array_equal(s.col("ref_count")[donor], [2, 2])
    s.t.check_invariants()
    # the port writes K/V in place: the sequential path gets its own arena
    shared = dataclasses.replace(s.t, k=s.t.k.clone(), v=s.t.v.clone())

    toks = prng.integers(-128, 128, (b, 13, g, hd)).astype(np.int8)
    n_new = np.asarray([13, 9], np.int32)
    s.op("append_chunk", toks, toks, n_new, kv=True, what="straddle+COW")
    s.t.check_invariants()
    chunked = s.t
    ref = shared
    for t in range(13):
        one = torch.from_numpy(toks[:, t:t + 1])
        ref = ref.decode_append(one, one, live=torch.from_numpy(t < n_new))
    unshared = TPaged.init(b, cap, g, hd, page_size=page, num_pages=P,
                           device="cpu")
    both_pre = torch.from_numpy(np.ascontiguousarray(
        np.broadcast_to(pre, (b, 8, g, hd))))
    unshared = unshared.write_prompts(both_pre, both_pre)
    unshared = unshared.append_chunk(torch.from_numpy(toks),
                                     torch.from_numpy(toks),
                                     torch.from_numpy(n_new))
    assert torch.equal(chunked.pos, ref.pos)
    assert int(chunked.free_top) == int(ref.free_top)
    views = [_logical_view(x) for x in (chunked, ref, unshared)]
    for row in range(b):
        pos = int(chunked.pos[row])
        for t in range(pos - int(chunked.valid_len()[row]), pos):
            for other in views[1:]:
                np.testing.assert_array_equal(views[0][row, t % cap],
                                              other[row, t % cap],
                                              err_msg=f"row {row} token {t}")


def test_shared_refcount_partition_matches_jax_seeded():
    """``tests/test_paged.py``'s seeded property over admit, adopt, pin,
    unpin (with a stray decref of a free page), ragged appends that copy
    on write when they wrap, and repeated releases: the port's allocator
    equals the JAX package's after every op and its invariants hold with
    the pin ledger."""
    b, g, hd, page, npps = 3, 1, 4, 4, 3
    cap = page * npps
    max_pins = 4
    P = b * npps + max_pins + 2
    prng = np.random.default_rng(17)
    s = Both(b, cap, g, hd, page_size=page, num_pages=P)
    active = np.zeros(b, bool)
    pins = {}

    def i8(*shape):
        return prng.integers(-128, 128, shape).astype(np.int8)

    for op in range(120):
        kind = prng.integers(0, 6)
        what = f"op {op}"
        pos = s.col("pos")
        if kind == 0:                              # admit a fresh row
            free = np.flatnonzero(~active)
            if free.size:
                row = int(prng.choice(free))
                ln = int(prng.integers(1, cap + 1))
                tok = i8(1, ln, g, hd)
                s.op("write_prompts", tok, tok,
                     lengths=np.asarray([ln], np.int32),
                     slots=np.asarray([row], np.int32), what=what)
                active[row] = True
        elif kind == 1:                            # adopt a donor's prefix
            free = np.flatnonzero(~active)
            donors = [r for r in np.flatnonzero(active) if pos[r] >= page]
            if free.size and donors:
                row = int(prng.choice(free))
                donor = int(prng.choice(donors))
                full = min(int(pos[donor]) // page, npps)
                n_pg = int(prng.integers(1, full + 1))
                pages = s.col("page_table")[donor, :n_pg]
                s.op("adopt_prefix", np.asarray([row], np.int32),
                     pages[None, :], np.asarray([n_pg], np.int32),
                     np.asarray([n_pg * page], np.int32), what=what)
                active[row] = True
        elif kind == 2 and active.any():           # ragged append, may COW
            live = active & (prng.random(b) < 0.8)
            width = int(prng.integers(1, page + 2))
            n_new = np.where(live, prng.integers(0, width + 1, b),
                             0).astype(np.int32)
            tok = i8(b, width, g, hd)
            s.op("append_chunk", tok, tok, n_new, what=what, kv=True)
        elif kind == 3 and active.any():           # release, maybe twice
            fin = active & (prng.random(b) < 0.4)
            if fin.any():
                s.op("release", fin, what=what)
                active &= ~fin
                if prng.random() < 0.5:
                    s.op("release", fin, what=what + " again")
        elif kind == 4 and len(pins) < max_pins:   # pin a held page
            pt, held = s.col("page_table"), s.t.pages_held().numpy()
            cand = set()
            for r in np.flatnonzero(active):
                cand.update(pt[r, :held[r]].tolist())
            cand -= set(pins)
            if cand:
                pg = int(prng.choice(sorted(cand)))
                s.op("incref_pages", np.asarray([pg], np.int32), what=what)
                pins[pg] = 1
        elif kind == 5 and pins:                   # unpin (+ stray decref)
            pg = int(prng.choice(sorted(pins)))
            s.op("decref_pages", np.asarray([pg], np.int32), what=what)
            del pins[pg]
            if s.col("ref_count")[pg] == 0 and prng.random() < 0.5:
                s.op("decref_pages", np.asarray([pg], np.int32),
                     what=what + " stray")
        assert not bool(s.t.oversubscribed()), f"{what}: pool overdrawn"
        try:
            s.t.check_invariants(pins=pins)
        except AssertionError as e:
            raise AssertionError(f"{what}: {e}") from e


def test_prefix_index_lookup_register_evict():
    """``tests/test_paged.py``'s host semantics: the longest registered
    page-aligned prefix, partial pages never match, registration skips
    known chunks and stops at conflicts and the parking page, LRU
    eviction spares the protected set and orphaned tails stay
    evictable."""
    idx = PrefixIndex(page_size=4)
    a = np.arange(12, dtype=np.int32)
    assert idx.register(a, [5, 6, 7]) == [5, 6, 7]
    assert len(idx) == 3
    assert idx.lookup(a) == [5, 6, 7]
    assert idx.lookup(a[:11]) == [5, 6]
    assert idx.lookup(a, max_tokens=9) == [5, 6]
    b2 = np.concatenate([a[:8], 90 + np.arange(4)]).astype(np.int32)
    assert idx.lookup(b2) == [5, 6]
    c = np.concatenate([[99], a[1:]]).astype(np.int32)
    assert idx.lookup(c) == []
    assert idx.register(a, [5, 6, 7]) == []
    assert idx.register(b2, [5, 6, 9]) == [9]
    assert idx.register(c, [0, 11]) == []
    idx.lookup(b2)
    ev = idx.evict_lru(2, protected={7})
    assert ev == [5, 6] and 7 not in ev
    assert idx.lookup(b2) == []
    assert 9 in idx.pinned_pages
    assert sorted(idx.evict_lru(5)) == [7, 9]
    assert len(idx) == 0 and idx.pinned_pages == []
    with pytest.raises(ValueError, match="page_size"):
        idx.load_state_dict(PrefixIndex(page_size=8).state_dict())


@pytest.mark.parametrize("page", [4, 128])
def test_prefix_index_equals_jax_index(page):
    """The port's index against the JAX package's on one seeded sequence
    of registrations, lookups and evictions over prompt families: the
    same chain keys (blake2b hex digests, stable across processes), the
    same returned pages, the same LRU order and the same
    ``state_dict``, which each side restores from the other's."""
    prng = np.random.default_rng(page)
    t, j = PrefixIndex(page), JIndex(page)
    fams = [prng.integers(0, 1000, 3 * page).astype(np.int32)
            for _ in range(3)]
    keys_t = t._chain_keys(fams[0], 3)
    assert keys_t == j._chain_keys(fams[0], 3)
    assert len(set(keys_t)) == 3 and all(len(k) == 32 for k in keys_t)
    next_page = 1
    for op in range(60):
        fam = fams[int(prng.integers(len(fams)))]
        tail = prng.integers(0, 1000, int(prng.integers(0, 2 * page)))
        toks = np.concatenate([fam[:int(prng.integers(1, 3 * page + 1))],
                               tail]).astype(np.int32)
        kind = prng.integers(0, 3)
        if kind == 0:
            n = toks.size // page
            ids = list(range(next_page, next_page + n))
            next_page += n
            assert t.register(toks, ids) == j.register(toks, ids), op
        elif kind == 1:
            cap = int(prng.integers(1, toks.size + 1))
            assert t.lookup(toks, max_tokens=cap) == \
                j.lookup(toks, max_tokens=cap), op
        else:
            prot = set(prng.choice(np.arange(1, next_page + 1), 2).tolist())
            n = int(prng.integers(0, 3))
            assert t.evict_lru(n, prot) == j.evict_lru(n, prot), op
        assert t.state_dict() == j.state_dict(), op
    back = PrefixIndex(page)
    back.load_state_dict(j.state_dict())
    assert back.state_dict() == t.state_dict()
    assert sorted(back.pinned_pages) == sorted(j.pinned_pages)


# ---------------------------------------------------------------------------
# Serve level: the port's serve against the JAX package's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def weights(exact_exp2):
    params = j_init_model(jax.random.PRNGKey(0), JCFG)
    model = from_jax_params(jax.tree.map(np.asarray, params), CFG,
                            device="cpu")
    return params, model


def serve_both(weights, reqs, **kw):
    """The port's and the JAX package's serve of ``reqs`` with the same
    options; returns the port's result after holding its tokens, counters
    and per-request schedule to the JAX serve's."""
    params, model = weights
    jkw = {k: v for k, v in kw.items() if k != "audit"}   # port caches
    if "faults" in jkw:
        from repro.runtime.fault_tolerance import ServeFaultPlan as JPlan
        jkw["faults"] = JPlan(**vars(kw["faults"]))
    jres = j_serve(params, JCFG, [JRequest(r.prompt, r.gen, r.arrival,
                                           r.priority) for r in reqs], **jkw)
    res = serve_continuous(model, CFG, reqs, device="cpu", **kw)
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
    assert [c.index for c in res.completed] == \
        [c.index for c in jres.completed]
    return res


def solo(model, r, max_len, **kw):
    return generate(model, CFG, torch.as_tensor(r.prompt)[None], r.gen,
                    max_len=max_len, device="cpu", **kw).tokens[0].numpy()


def assert_solo(model, res, reqs, max_len):
    for c in res.completed:
        np.testing.assert_array_equal(c.tokens,
                                      solo(model, reqs[c.index], max_len),
                                      err_msg=f"request {c.index}")


def audited(pins_seen):
    """An ``audit`` hook: every layer's invariants with the pin ledger,
    no request in two slots."""
    def audit(caches, slot_req, pins):
        pins_seen.append(dict(pins))
        for c in caches:
            c["mix"].check_invariants(pins=pins)
        live = [i for i in slot_req if i is not None]
        assert len(set(live)) == len(live), slot_req
    return audit


def test_prefix_sharing_matches_jax_and_solo(weights):
    """``tests/test_serve_loop.py``'s shared 128-token system prompt:
    sharing on equals the JAX package's serve (tokens and counters),
    sharing off and solo ``generate()``, and prefills fewer tokens."""
    _, model = weights
    prng = np.random.default_rng(23)
    system = prng.integers(0, CFG.vocab_size, 128).astype(np.int32)
    reqs = []
    for i in range(5):
        tail = prng.integers(0, CFG.vocab_size,
                             int(prng.integers(4, 20))).astype(np.int32)
        reqs.append(ServeRequest(prompt=np.concatenate([system, tail]),
                                 gen=int(prng.integers(3, 8)),
                                 arrival=6 * i))
    kw = dict(slots=3, segment=4, max_len=256, page_size=128,
              admission="chunked", chunk_size=48)
    pins_seen = []
    on = serve_both(weights, reqs, prefix_sharing=True,
                    debug_invariants=True, audit=audited(pins_seen), **kw)
    off = serve_continuous(model, CFG, reqs, device="cpu", **kw)
    assert pins_seen and any(pins_seen), "no page was ever pinned"
    assert off.prefix_hits == 0 and off.shared_prefix_tokens == 0
    assert on.prefix_hits >= 1 and on.shared_prefix_tokens >= 128
    assert on.prefix_hit_rate == on.prefix_hits / len(reqs)
    assert on.prefill_tokens < off.prefill_tokens
    want = {c.index: c.tokens for c in off.completed}
    for c in on.completed:
        np.testing.assert_array_equal(c.tokens, want[c.index])
    assert_solo(model, on, reqs, 256)


def test_prefix_sharing_eviction_under_page_pressure(weights):
    """A pool with room for two pinned prefix families: the third family
    makes the index evict LRU pins; every request equals the JAX serve
    and solo ``generate()``, and each family's second request hits."""
    _, model = weights
    prng = np.random.default_rng(29)
    fams = [prng.integers(0, CFG.vocab_size, 128).astype(np.int32)
            for _ in range(3)]
    reqs, t = [], 0
    for fam in fams:
        for _ in range(2):
            tail = prng.integers(0, CFG.vocab_size,
                                 int(prng.integers(3, 10))).astype(np.int32)
            reqs.append(ServeRequest(prompt=np.concatenate([fam, tail]),
                                     gen=3, arrival=t))
            t += 8
    res = serve_both(weights, reqs, slots=1, segment=4, max_len=256,
                     page_size=128, num_pages=4, admission="chunked",
                     chunk_size=48, prefix_sharing=True,
                     debug_invariants=True)
    assert res.prefix_hits >= 3
    assert_solo(model, res, reqs, 256)


def test_prefix_sharing_requires_chunked_admission(weights):
    _, model = weights
    reqs = [ServeRequest(prompt=np.zeros(4, np.int32), gen=2)]
    with pytest.raises(ValueError, match="prefix_sharing"):
        serve_continuous(model, CFG, reqs, slots=2, segment=4, max_len=128,
                         admission="stall", prefix_sharing=True,
                         device="cpu")
