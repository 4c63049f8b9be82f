"""The port's continuous-batching server (``serve_continuous``, chunked
and stall admission over the paged int8 pool) against the JAX package
and against itself, on the CPU, on the ``serveloop-smoke`` config of
``tests/test_serve_loop.py`` (weights made by the JAX package and loaded
with ``from_jax_params``). On the CPU a greedy serve runs its steps
through ``CapturedSteps`` without a graph (the static buffers, copy-in
and copy-back of the card's captured steps).

- Greedy tokens of every served request equal the JAX package's
  ``serve_continuous`` on the same seeded trace (the JAX serves run once,
  module-scoped), and equal the port's solo ``generate()`` with the
  ``ita_onepass_pallas`` pin — with the serve pinned too, and unpinned
  (decode steps through the paged decode kernel); under stall admission
  (pinned, as the JAX package's tests run it) too, with chunked ≡ stall
  ≡ solo over prompts that span several chunks, and over pages smaller
  than the scratch ring's block. The unpinned stall serve equals the
  JAX package's unpinned stall serve (its prefill is another exactness
  family than solo ``generate()``, so it is not held to that).
- The mixed step's logits are within 5e-2 of the JAX package's (float
  projections round differently in XLA and torch, which can move an int8
  step of 0.05: the bound of ``tests/test_torch_generate.py``).
- EOS cuts sequences; the decode-maximal budget is never exceeded and the
  head prefilling slot progresses; no page or slot is double-booked
  (either admission); sampled outputs do not depend on arrival order and
  equal solo ``generate()`` with the request's generator (either
  admission); ``generate(paged=True)`` equals the ring path; the entry
  points refuse to drop to the CPU; the options of later slices raise
  ``NotImplementedError``.

The reference runs with an exact ``exp2`` (``tests/test_torch_kernels.py``,
ROADMAP §C).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.base import ModelConfig as JConfig
from repro.models import forward as j_forward
from repro.models import init_caches as j_init_caches
from repro.models import init_model as j_init_model
from repro.runtime.generate import ServeRequest as JRequest
from repro.runtime.generate import serve_continuous as j_serve
from repro_torch.configs.base import ModelConfig as TConfig
from repro_torch.launch.steps import (ServeSlotState, admit_chunked,
                                      admit_stall, make_serve_segment,
                                      request_generator)
from repro_torch.models import forward as t_forward
from repro_torch.models import from_jax_params, init_caches
from repro_torch.runtime.generate import (ServeRequest, generate,
                                          serve_continuous)

_FIELDS = dict(name="serveloop-smoke", family="dense", d_model=64,
               n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
               vocab_size=128, layer_groups=((("attn",), 2),),
               dtype="float32", attention_impl="ita",
               attention_backend="ita_onepass_pallas")
JCFG, CFG = JConfig(**_FIELDS), TConfig(**_FIELDS)
UNPINNED = dataclasses.replace(CFG, attention_backend="")
MAX_LEN = 128                   # one 128-page per slot: ring bkv == page
SERVE = dict(slots=3, segment=4, max_len=MAX_LEN, page_size=128,
             chunk_size=5)


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


def _trace(n, prng, max_prompt=12, max_gen=9, spread=3):
    """The arrival trace of ``tests/test_serve_loop.py`` (port requests)."""
    reqs, step = [], 0
    for _ in range(n):
        plen = int(prng.integers(3, max_prompt + 1))
        reqs.append(ServeRequest(
            prompt=prng.integers(0, CFG.vocab_size, plen).astype(np.int32),
            gen=int(prng.integers(1, max_gen + 1)), arrival=step))
        step += int(prng.integers(0, spread + 1))
    return reqs


def _serve(model, reqs, cfg=CFG, **kw):
    return serve_continuous(model, cfg, reqs, device="cpu",
                            **{**SERVE, **kw})


def _solo(model, r, cfg=CFG, **kw):
    return generate(model, cfg, torch.as_tensor(r.prompt)[None], r.gen,
                    max_len=MAX_LEN, device="cpu", **kw).tokens[0].numpy()


def _j_serve(params, reqs, cfg=JCFG, **kw):
    res = j_serve(params, cfg, [JRequest(r.prompt, r.gen, r.arrival)
                                for r in reqs], **{**SERVE, **kw})
    return {c.index: np.asarray(c.tokens) for c in res.completed}


@pytest.fixture(scope="module")
def jax_serve(weights):
    """The JAX package's serve of the 7-request trace (run once)."""
    params, _ = weights
    reqs = _trace(7, np.random.default_rng(3))
    return reqs, _j_serve(params, reqs)


@pytest.fixture(scope="module")
def jax_stall_serve(weights, jax_serve):
    """The JAX package's stall serve of the same trace (run once)."""
    params, _ = weights
    reqs, _ = jax_serve
    return _j_serve(params, reqs, admission="stall")


@pytest.mark.parametrize("cfg", [CFG, UNPINNED], ids=["pinned", "unpinned"])
def test_serve_matches_jax_serve_and_solo_generate(weights, jax_serve, cfg):
    _, model = weights
    reqs, want = jax_serve
    res = _serve(model, reqs, cfg=cfg)
    assert len(res.completed) == len(reqs) == len(want)
    assert res.total_tokens == sum(r.gen for r in reqs)
    assert res.prefill_stall_s == 0.0 and res.steps > 0
    for c in res.completed:
        assert c.first_token_s >= c.arrived_s
        np.testing.assert_array_equal(
            c.tokens, want[c.index],
            err_msg=f"request {c.index} differs from the JAX serve")
        np.testing.assert_array_equal(
            c.tokens, _solo(model, reqs[c.index]),
            err_msg=f"request {c.index} differs from solo generate()")


def test_stall_serve_matches_jax_stall_serve_and_solo(weights, jax_serve,
                                                      jax_stall_serve):
    _, model = weights
    reqs, _ = jax_serve
    res = _serve(model, reqs, admission="stall")
    assert len(res.completed) == len(reqs) == len(jax_stall_serve)
    assert res.total_tokens == sum(r.gen for r in reqs)
    assert res.prefill_stall_s > 0.0 and res.steps > 0
    assert res.prefill_tokens == sum(r.prompt.size for r in reqs)
    for c in res.completed:
        assert c.first_token_s >= c.arrived_s
        np.testing.assert_array_equal(
            c.tokens, jax_stall_serve[c.index],
            err_msg=f"request {c.index} differs from the JAX stall serve")
        np.testing.assert_array_equal(
            c.tokens, _solo(model, reqs[c.index]),
            err_msg=f"request {c.index} differs from solo generate()")


def test_unpinned_stall_serve_matches_jax_unpinned_stall_serve(weights,
                                                              jax_serve):
    """Stall admission without the onepass pin: the admission prefill takes
    the config's own prefill path into the scratch ring (not the onepass
    kernel that solo ``generate()`` decodes against), so the port is held
    to the JAX package's unpinned stall serve, token for token, and not
    to solo ``generate()``."""
    params, model = weights
    reqs, _ = jax_serve
    want = _j_serve(params, reqs, dataclasses.replace(JCFG,
                                                      attention_backend=""),
                    admission="stall")
    res = _serve(model, reqs, cfg=UNPINNED, admission="stall")
    assert len(res.completed) == len(reqs) == len(want)
    assert res.prefill_stall_s > 0.0
    for c in res.completed:
        np.testing.assert_array_equal(
            c.tokens, want[c.index],
            err_msg=f"request {c.index} differs from the JAX stall serve")


def test_chunked_equals_stall_equals_solo(weights):
    """The parity sweep of ``tests/test_serve_loop.py`` (causal GQA): prompt
    chunks narrower than the page and prompts spanning several chunks,
    served chunked and stalled, equal solo ``generate()`` and the JAX
    package's stall serve."""
    params, model = weights
    prng = np.random.default_rng(11)
    reqs = [ServeRequest(
        prompt=prng.integers(0, CFG.vocab_size, n).astype(np.int32),
        gen=4, arrival=2 * i) for i, n in enumerate((9, 60, 33))]
    kw = dict(slots=2, segment=5, max_len=256, chunk_size=16)
    want = _j_serve(params, reqs, admission="stall", **kw)
    for admission in ("chunked", "stall"):
        res = _serve(model, reqs, admission=admission, **kw)
        assert len(res.completed) == len(reqs)
        assert (res.prefill_stall_s > 0) == (admission == "stall")
        for c in res.completed:
            np.testing.assert_array_equal(c.tokens, want[c.index],
                                          err_msg=f"{admission} {c.index}")
            solo = generate(model, CFG,
                            torch.as_tensor(reqs[c.index].prompt)[None], 4,
                            max_len=256, device="cpu").tokens[0].numpy()
            np.testing.assert_array_equal(c.tokens, solo,
                                          err_msg=f"{admission} {c.index}")


def test_stall_serve_small_pages_wide_scratch(weights):
    """Stall admission with pages smaller than the ring block: the scratch
    ring is block-aligned wider than the prompt pad and the pool's
    window, and the adoption bounds the lengths, not the scratch width —
    prompts over several small pages equal solo paged ``generate()`` on
    the same page size."""
    _, model = weights
    prng = np.random.default_rng(9)
    reqs = [ServeRequest(prompt=prng.integers(0, CFG.vocab_size,
                                              130 + 8 * i).astype(np.int32),
                         gen=3) for i in range(3)]
    res = serve_continuous(model, CFG, reqs, slots=2, segment=4,
                           max_len=192, page_size=64, admission="stall",
                           debug_invariants=True, device="cpu")
    assert len(res.completed) == len(reqs)
    for c in res.completed:
        solo = generate(model, CFG, torch.as_tensor(reqs[c.index].prompt)
                        [None], 3, max_len=192, paged=True, page_size=64,
                        device="cpu")
        np.testing.assert_array_equal(c.tokens, solo.tokens[0].numpy(),
                                      err_msg=f"request {c.index}")


def test_admit_stall_enters_the_decode_phase():
    """``admit_stall`` writes the admitted rows in the decode phase
    (cursor == plen == pos == length, the sampled first token, done and
    rem as given) and drops padding rows."""
    state = ServeSlotState.init(3, 8)
    state = admit_stall(state, [2, -1, 0], [5, 1, 7], [[11], [99], [13]],
                        [False, True, True], [3, 9, 0])
    assert state.pos.tolist() == state.plen.tolist() \
        == state.cursor.tolist() == [7, 0, 5]
    assert state.tok[:, 0].tolist() == [13, 0, 11]
    assert state.done.tolist() == [True, True, False]
    assert state.rem.tolist() == [0, 0, 3]


def test_mixed_step_logits_match_jax(weights):
    params, model = weights
    rng = np.random.default_rng(5)
    b, chunk = 3, 6
    jc = j_init_caches(JCFG, b, MAX_LEN, paged=True, page_size=128)
    tc = init_caches(CFG, b, MAX_LEN, paged=True, page_size=128,
                     device="cpu")
    pos = np.zeros(b, np.int32)
    # a prefill chunk, a short chunk and a dead row; then a mixed step of
    # a decode row, a chunk and the same dead row
    for q_lens in ([6, 2, 0], [1, 6, 0]):
        q_lens = np.asarray(q_lens, np.int32)
        tokens = rng.integers(0, CFG.vocab_size, (b, chunk)).astype(np.int32)
        jl, jc, _ = j_forward(params, jnp.asarray(tokens), JCFG,
                              mode="decode", caches=jc, pos0=jnp.asarray(pos),
                              q_lens=jnp.asarray(q_lens))
        with torch.inference_mode():
            tl, tc = t_forward(model, torch.from_numpy(tokens), CFG,
                               mode="decode", caches=tc,
                               pos0=torch.from_numpy(pos),
                               q_lens=torch.from_numpy(q_lens))
        jl, tl = np.asarray(jl), tl.numpy()
        for row in range(b):
            n = int(q_lens[row])
            np.testing.assert_allclose(tl[row, :n], jl[row, :n], atol=5e-2,
                                       err_msg=f"row {row}")
        pos = pos + q_lens
        np.testing.assert_array_equal(tc[0]["mix"].pos.numpy(), pos)


def test_serve_eos_cuts_sequences(weights):
    _, model = weights
    reqs = _trace(4, np.random.default_rng(4), max_gen=8)
    base = _serve(model, reqs, slots=2)
    all_toks = np.concatenate([c.tokens for c in base.completed])
    eos = int(all_toks[len(all_toks) // 2])
    res = _serve(model, reqs, slots=2, eos_id=eos)
    for c in res.completed:
        solo = _solo(model, reqs[c.index])
        hits = np.flatnonzero(solo == eos)
        want = solo[:hits[0] + 1] if hits.size else solo
        np.testing.assert_array_equal(c.tokens, want,
                                      err_msg=f"request {c.index}")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mixed_scheduler_budget_and_progress(weights, seed):
    """Per-step grants never exceed the budget, give every decoding slot
    at most one token, advance the head prefilling slot every step, and
    drain every prompt."""
    _, model = weights
    prng = np.random.default_rng(seed)
    slots, chunk, segment = 4, 5, 6
    budget = slots - 1 + chunk
    prompt_pad = 24
    plens = prng.integers(1, prompt_pad + 1, slots).astype(np.int32)
    gens = prng.integers(1, 6, slots).astype(np.int32)
    prompts = prng.integers(0, CFG.vocab_size,
                            (slots, prompt_pad)).astype(np.int32)
    caches = init_caches(CFG, slots, MAX_LEN, paged=True, page_size=128,
                         device="cpu")
    state = admit_chunked(ServeSlotState.init(slots, prompt_pad),
                          np.arange(slots), prompts, plens, gens)
    seg = make_serve_segment(CFG, segment=segment, sample=False,
                             eos_id=None, pad_id=0, chunk=chunk,
                             budget=budget)
    cursor = np.zeros(slots, np.int64)
    with torch.inference_mode():
        for _ in range(6):
            done_before = state.done.numpy().copy()
            _, _, grants, state, caches, _ = seg(model, state, caches, 1.0)
            grants = grants.numpy()
            for t in range(segment):
                g = grants[:, t]
                assert g.sum() <= budget, (t, g, budget)
                pre = cursor < plens
                if pre.any() and not done_before.all():
                    assert g[pre].sum() >= 1, (t, g, cursor, plens)
                decoding = (cursor >= plens) & ~done_before
                assert np.all(g[decoding] <= 1)
                cursor = np.minimum(cursor + np.where(pre, g, 0), plens)
            if state.done.all():
                break
    assert state.done.all(), "segments did not drain the batch"
    np.testing.assert_array_equal(state.cursor.numpy(), plens,
                                  err_msg="a prefilling slot starved")


def _audited_serve(model, seed, admission="chunked"):
    """The double-booking audit of ``tests/test_serve_loop.py``: every
    admission round's pools hold no page in two slots' held prefixes and
    no request in two slots; every request equals solo ``generate()``."""
    reqs = _trace(8, np.random.default_rng(seed), max_gen=7, spread=4)
    audits = []

    def audit(caches, slot_req, pins):
        audits.append(1)
        for c in caches:
            p = c["mix"]
            p.check_invariants(pins=pins)
            pt, held = p.page_table.numpy(), p.pages_held().numpy()
            pages = [x for r in range(p.batch) for x in pt[r, :held[r]]]
            assert len(set(pages)) == len(pages), \
                f"page double-booked across slots: {pages}"
        live = [i for i in slot_req if i is not None]
        assert len(set(live)) == len(live), f"request in two slots: {slot_req}"

    # page_size 32 -> up to 4 pages per sequence; the pool holds 3 slots'
    # worth + 1, so admission waits on pages
    res = _serve(model, reqs, page_size=32, num_pages=3 * 4 + 2,
                 chunk_size=8, audit=audit, debug_invariants=True,
                 admission=admission)
    assert audits and len(res.completed) == len(reqs)
    for c in res.completed:
        np.testing.assert_array_equal(c.tokens, _solo(model, reqs[c.index]))


@pytest.mark.parametrize("seed", [0, 1])
def test_scheduler_never_double_books_page_or_slot(weights, seed):
    _, model = weights
    _audited_serve(model, seed)


def test_stall_scheduler_never_double_books_page_or_slot(weights):
    _, model = weights
    _audited_serve(model, 2, admission="stall")


def _sampled_arrival_order(model, admission):
    """Sampled serving draws each request from its own generator: the
    tokens do not depend on arrival order and equal solo ``generate()``
    given the request's generator."""
    prng = np.random.default_rng(5)
    prompts = [prng.integers(0, CFG.vocab_size,
                             int(prng.integers(3, 12))).astype(np.int32)
               for _ in range(5)]
    gens = [int(prng.integers(2, 7)) for _ in range(5)]

    def run(arrivals):
        reqs = [ServeRequest(prompt=prompts[i], gen=gens[i],
                             arrival=arrivals[i]) for i in range(5)]
        res = _serve(model, reqs, slots=2, chunk_size=6, temperature=0.8,
                     seed=42, admission=admission)
        return {c.index: c.tokens for c in res.completed}

    a, b = run([0, 0, 1, 5, 9]), run([9, 4, 0, 0, 2])
    for i in range(5):
        np.testing.assert_array_equal(a[i], b[i], err_msg=f"request {i}")
        solo = _solo(model, ServeRequest(prompts[i], gens[i]),
                     temperature=0.8,
                     generator=request_generator(42, i, "cpu"))
        np.testing.assert_array_equal(a[i], solo, err_msg=f"request {i}")


def test_sampled_serving_independent_of_arrival_order(weights):
    _, model = weights
    _sampled_arrival_order(model, "chunked")


def test_sampled_stall_serving_independent_of_arrival_order(weights):
    _, model = weights
    _sampled_arrival_order(model, "stall")


@pytest.mark.parametrize("cfg", [CFG, UNPINNED], ids=["pinned", "unpinned"])
def test_paged_generate_equals_ring(weights, cfg):
    _, model = weights
    prompts = torch.from_numpy(np.random.default_rng(6).integers(
        0, CFG.vocab_size, (3, 20)).astype(np.int32))
    lengths = torch.tensor([20, 7, 13])
    kw = dict(max_len=160, prompt_lengths=lengths, device="cpu")
    ring = generate(model, cfg, prompts, 12, **kw)
    paged = generate(model, cfg, prompts, 12, paged=True, **kw)
    assert torch.equal(ring.tokens, paged.tokens)
    with pytest.raises(ValueError, match="undersized"):
        generate(model, cfg, prompts, 12, paged=True, num_pages=3, **kw)
    caches = init_caches(cfg, 3, 160, paged=True, page_size=64,
                         device="cpu")
    with pytest.raises(ValueError, match="page_table"):
        generate(model, cfg, prompts, 12, caches=caches, max_len=300,
                 device="cpu")


def test_serve_does_not_fall_back_to_cpu(weights, monkeypatch):
    _, model = weights
    reqs = _trace(2, np.random.default_rng(0))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve_continuous(model, CFG, reqs, slots=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        generate(model, CFG, torch.zeros((1, 4), dtype=torch.int32), 2,
                 paged=True)
    from repro_torch.launch import serve
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--smoke", "--continuous", "--requests", "2"])


@pytest.mark.parametrize("option", [
    dict(prefix_sharing=True), dict(preemption=True), dict(faults=object()),
    dict(aging_steps=4), dict(journal_dir="journal"),
    dict(snapshot_every=2), dict(resume=True), dict(drain=object()),
    dict(drain_timeout=1.0)],
    ids=lambda o: next(iter(o)))
def test_unported_serve_options_raise(weights, option):
    _, model = weights
    with pytest.raises(NotImplementedError, match="ROADMAP|not ported"):
        _serve(model, _trace(2, np.random.default_rng(0)), **option)


def test_serve_cli_continuous_on_cpu():
    from repro_torch.launch import serve
    res = serve.main(["--smoke", "--device", "cpu", "--continuous",
                      "--requests", "4", "--prompt-len", "12", "--gen", "4",
                      "--segment", "4", "--chunk-size", "8", "--batch", "2"])
    assert len(res.completed) == 4
    assert all(2 <= c.tokens.size <= 4 for c in res.completed)


def test_serve_cli_stall_and_stepwise_on_cpu():
    from repro_torch.launch import serve
    # pinned: unpinned, the stall prefill streams in torch ops, another
    # exactness family than the mixed step's onepass kernel
    args = ["--smoke", "--device", "cpu", "--prompt-len", "12", "--gen",
            "4", "--batch", "2", "--attention-backend", "ita_onepass_pallas"]
    stall = serve.main(args + ["--continuous", "--requests", "4",
                               "--segment", "4", "--admission", "stall"])
    chunked = serve.main(args + ["--continuous", "--requests", "4",
                                 "--segment", "4"])
    assert stall.prefill_stall_s > 0 and len(stall.completed) == 4
    want = {c.index: c.tokens for c in chunked.completed}
    for c in stall.completed:
        np.testing.assert_array_equal(c.tokens, want[c.index])
    fused = serve.main(args)
    stepwise = serve.main(args + ["--loop", "stepwise"])
    assert torch.equal(fused.tokens, stepwise.tokens)
