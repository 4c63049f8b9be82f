"""The port's RG-LRU block (``repro_torch.models.rglru``) and the hybrid
recurrentgemma-smoke (RG-LRU, RG-LRU, local attention; GeGLU, scaled
embeddings, local window 16) against the JAX package, on the CPU
(float32), with the JAX package's weights through ``from_jax_params``.

- ``_rglru_scan``, with and without a carried ``h0``, at odd and even
  lengths, against the jitted reference: within ``atol=1e-6``, not bit
  for bit. The port runs the reference's odd/even recursion of
  ``jax.lax.associative_scan``, so every ``h_t`` is the same products
  and sums; XLA:CPU fuses the jitted scan and contracts its
  multiply-adds (``bl * ar + br``, ``1 - a²``) into fused multiply-adds
  with one rounding where torch rounds twice (up to 6e-7 seen).
- ``apply_rglru``'s output and new state (prefill from no state, decode
  from a carried one) within ``rtol=atol=1e-5``.
- The model: decode after a prefill against the teacher-forced logits,
  as ``tests/test_models_smoke.py`` checks the reference (``float``,
  ``atol=2e-3``); prefill logits under ``ita`` within ``1e-4`` of JAX's;
  greedy ``generate()`` tokens (rings and ``paged=True``, fused and
  stepwise; 2 × 12 prompt, 8 tokens: the 16-entry local rings wrap)
  equal to JAX's; ``generate(caches=...)`` over caches holding a nonzero
  recurrent state, twice, equal to JAX's (the reference starts each call
  from the state the caller passes and leaves the caller's caches as
  they were; so does the port); ``param_dtype="bfloat16"`` (the full
  config's) loads, keeps ``lam`` in bfloat16 and the gates in float32.
- Ragged prompts are refused with the reference's message.

The reference runs with an exact ``exp2`` (ROADMAP §C).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.registry import get_config as j_config
from repro.models import forward as j_forward
from repro.models import init_caches as j_init_caches
from repro.models import init_model as j_init_model
from repro.models import rglru as JG
from repro.runtime.generate import generate as j_generate
from repro_torch.configs.registry import get_config as t_config
from repro_torch.models import forward as t_forward
from repro_torch.models import from_jax_params, init_caches
from repro_torch.models import rglru as TG
from repro_torch.runtime.generate import generate as t_generate

ARCH = "recurrentgemma-2b"
B, S, GEN = 2, 12, 8


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
def weights():
    jcfg = j_config(ARCH, smoke=True, attention_impl="ita")
    tcfg = t_config(ARCH, smoke=True, attention_impl="ita")
    params = j_init_model(jax.random.PRNGKey(0), jcfg)
    model = from_jax_params(jax.tree.map(np.asarray, params), tcfg,
                            device="cpu")
    return jcfg, tcfg, params, model


def _prompts(seed, s=S, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, (B, s)
                                                ).astype(np.int32)


@pytest.mark.parametrize("carried", [False, True], ids=["no-h0", "h0"])
@pytest.mark.parametrize("t", [1, 2, 7, 33])
def test_rglru_scan_matches_jax(t, carried):
    rng = np.random.default_rng(t)
    a = rng.uniform(0.3, 1.0, (B, t, 64)).astype(np.float32)
    x = rng.normal(size=(B, t, 64)).astype(np.float32)
    h0 = rng.normal(size=(B, 64)).astype(np.float32) if carried else None
    want = np.asarray(jax.jit(JG._rglru_scan)(
        jnp.asarray(x), jnp.asarray(a),
        None if h0 is None else jnp.asarray(h0)))
    got = TG._rglru_scan(torch.from_numpy(x), torch.from_numpy(a),
                         None if h0 is None else torch.from_numpy(h0))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    # and the recurrence itself, step by step in float64
    h = np.zeros((B, 64)) if h0 is None else h0.astype(np.float64)
    for i in range(t):
        ai = a[:, i].astype(np.float64)
        h = ai * h + np.sqrt(1 - ai * ai) * x[:, i]
        np.testing.assert_allclose(got[:, i].numpy(), h, rtol=0, atol=1e-5)


def _rglru_params(jcfg, seed=0):
    p = jax.tree.map(np.asarray, JG.init_rglru(jax.random.PRNGKey(seed),
                                               jcfg))
    rng = np.random.default_rng(seed)
    for k in ("conv_b", "b_a", "b_x"):          # zeros at init
        p[k] = rng.normal(0, 0.3, p[k].shape).astype(np.float32)
    return p


def test_apply_rglru_matches_jax(weights):
    jcfg, tcfg = weights[:2]
    p = _rglru_params(jcfg)
    mod = TG.RGLRU(tcfg, device="cpu")
    with torch.no_grad():
        for k, v in p.items():
            getattr(mod, k).copy_(torch.from_numpy(v))
    rng = np.random.default_rng(4)
    x = rng.normal(size=(B, 20, 64)).astype(np.float32)
    x1 = rng.normal(size=(B, 1, 64)).astype(np.float32)
    jp = jax.tree.map(jnp.asarray, p)
    run = jax.jit(lambda pp, xx, st: JG.apply_rglru(pp, xx, jcfg, st))
    jy, jst = run(jp, jnp.asarray(x), None)
    jy1, jst1 = run(jp, jnp.asarray(x1), jst)
    with torch.no_grad():
        ty, tst = TG.apply_rglru(mod, torch.from_numpy(x), tcfg)
        ty1, tst1 = TG.apply_rglru(mod, torch.from_numpy(x1), tcfg, tst)
    for got, want in ((ty, jy), (tst["h"], jst["h"]),
                      (tst["conv"], jst["conv"]), (ty1, jy1),
                      (tst1["h"], jst1["h"]), (tst1["conv"], jst1["conv"])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)
    assert tst1["h"].dtype == torch.float32 and tst1["conv"].shape == (
        B, 3, 64)


def test_decode_matches_teacher_forcing(weights):
    """Prefill of s - 1 tokens, one decode step: the teacher-forced
    logits of the last two positions, as the reference's smoke test
    (``float``; the port refuses the QAT train forward)."""
    _, tcfg, _, model = weights
    cfg = dataclasses.replace(tcfg, attention_impl="float")
    s = 24
    tokens = torch.from_numpy(_prompts(7, s))
    with torch.inference_mode():
        full, _ = t_forward(model, tokens, cfg, mode="train")
        caches = init_caches(cfg, B, s + 4, device="cpu")
        lp, caches = t_forward(model, tokens[:, :s - 1], cfg,
                               mode="prefill", caches=caches)
        ld, _ = t_forward(model, tokens[:, s - 1:], cfg, mode="decode",
                          caches=caches, pos0=s - 1)
    np.testing.assert_allclose(ld[:, 0].numpy(), full[:, -1].numpy(),
                               atol=2e-3)
    np.testing.assert_allclose(lp[:, -1].numpy(), full[:, -2].numpy(),
                               atol=2e-3)


def test_prefill_logits_match_jax(weights):
    jcfg, tcfg, params, model = weights
    tokens = _prompts(1, 20)
    jl, jc, _ = j_forward(params, jnp.asarray(tokens), jcfg, mode="prefill",
                          caches=j_init_caches(jcfg, B, 24))
    with torch.inference_mode():
        tl, tc = t_forward(model, torch.from_numpy(tokens), tcfg,
                           mode="prefill",
                           caches=init_caches(tcfg, B, 24, device="cpu"))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    # layer 0's RG-LRU state and layer 2's local ring (16 of 24)
    np.testing.assert_allclose(tc[0]["mix"]["h"].numpy(),
                               np.asarray(jc[0][0]["mix"]["h"][0]),
                               rtol=1e-5, atol=1e-5)
    assert tc[2]["mix"].capacity == 16


def test_greedy_tokens_match_jax(weights):
    jcfg, tcfg, params, model = weights
    prompts = _prompts(2)
    want = np.asarray(j_generate(params, jcfg, jnp.asarray(prompts), GEN,
                                 loop="fused").tokens)
    for kw in (dict(), dict(loop="stepwise"),
               dict(paged=True, page_size=16),
               dict(paged=True, page_size=16, loop="stepwise")):
        got = t_generate(model, tcfg, torch.from_numpy(prompts), GEN,
                         device="cpu", **kw)
        np.testing.assert_array_equal(got.tokens.numpy(), want, str(kw))


def _stateful_caches(jcfg, tcfg, seed=9):
    """The JAX package's and the port's caches with the same random
    nonzero recurrent state (attention rings empty)."""
    rng = np.random.default_rng(seed)
    jc = j_init_caches(jcfg, B, S + GEN)
    tc = init_caches(tcfg, B, S + GEN, device="cpu")
    layer = 0
    jc = [list(g) for g in jc]
    for g, (pattern, n) in enumerate(jcfg.layer_groups):
        for period in range(n):
            for pos, kind in enumerate(pattern):
                if kind != "attn" and kind != "local":
                    for mod, leaves in jc[g][pos].items():
                        for leaf, a in leaves.items():
                            v = (0.5 * rng.normal(size=a.shape[1:])
                                 ).astype(np.float32)
                            a = a.at[period].set(v.astype(a.dtype))
                            jc[g][pos] = dict(jc[g][pos], **{mod: dict(
                                jc[g][pos][mod], **{leaf: a})})
                            tc[layer][mod][leaf].copy_(torch.from_numpy(v))
                layer += 1
    return tuple(tuple(g) for g in jc), tc


def test_reused_caches_match_jax(weights):
    jcfg, tcfg, params, model = weights
    prompts = _prompts(3)
    jc, tc = _stateful_caches(jcfg, tcfg)
    held = [{k: v.clone() for k, v in c["mix"].items()}
            for c in tc if isinstance(c["mix"], dict)]
    for call in range(2):
        want = np.asarray(j_generate(params, jcfg, jnp.asarray(prompts),
                                     GEN, caches=jc).tokens)
        got = t_generate(model, tcfg, torch.from_numpy(prompts), GEN,
                         caches=tc, device="cpu")
        np.testing.assert_array_equal(got.tokens.numpy(), want,
                                      f"call {call}")
    for c, h in zip((c for c in tc if isinstance(c["mix"], dict)), held,
                    strict=True):
        for k, v in h.items():
            assert torch.equal(c["mix"][k], v)


def test_bfloat16_params_load_as_the_reference_uses_them():
    jcfg = j_config(ARCH, smoke=True, param_dtype="bfloat16")
    tcfg = t_config(ARCH, smoke=True, param_dtype="bfloat16")
    params = j_init_model(jax.random.PRNGKey(0), jcfg)
    model = from_jax_params(jax.tree.map(np.asarray, params), tcfg,
                            device="cpu")
    mix = model.blocks[0].mixer
    assert mix.lam.dtype == torch.bfloat16
    assert mix.w_a.dtype == mix.b_a.dtype == torch.float32
    assert mix.w_in.dtype == torch.float32          # the compute dtype
    np.testing.assert_array_equal(
        mix.lam.float().numpy(),
        np.asarray(params["groups"][0][0]["mixer"]["lam"][0],
                   np.float32))
    tokens = _prompts(5, 16)
    jl, _, _ = j_forward(params, jnp.asarray(tokens), jcfg, mode="train")
    with torch.inference_mode():
        tl, _ = t_forward(model, torch.from_numpy(tokens), tcfg,
                          mode="train")
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)


def test_ragged_prompts_are_refused(weights):
    jcfg, tcfg, params, model = weights
    prompts = _prompts(4)
    lengths = np.array([12, 7], np.int32)
    msg = r"ragged prompts are attention-only \(recurrent blocks \['rglru'\]"
    with pytest.raises(ValueError, match=msg):
        j_generate(params, jcfg, jnp.asarray(prompts), 4,
                   prompt_lengths=lengths)
    with pytest.raises(ValueError, match=msg):
        t_generate(model, tcfg, torch.from_numpy(prompts), 4,
                   prompt_lengths=lengths, device="cpu")


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "rwkv6-7b"])
def test_serve_cli_generates_and_refuses_continuous(arch):
    """``--arch`` takes both recurrent archs for ``generate()`` (rings and
    ``--paged``); ``--continuous`` refuses them as the JAX package's
    serve does."""
    from repro_torch.launch import serve
    base = ["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2",
            "--prompt-len", "12", "--gen", "4"]
    for extra in ([], ["--paged", "--page-size", "16"]):
        res = serve.main(base + extra)
        assert res.tokens.shape == (2, 4)
    with pytest.raises(ValueError, match="continuous batching serves "
                       "decoder-only attention stacks"):
        serve.main(base + ["--continuous", "--requests", "2"])
