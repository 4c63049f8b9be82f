"""The port's RWKV6 blocks (``repro_torch.models.rwkv6``) and the
attention-free rwkv6-smoke (2 layers of time mix and channel mix) against
the JAX package, on the CPU (float32), with the JAX package's weights
through ``from_jax_params``.

- ``_wkv_scan`` from a zero and a carried state; ``apply_time_mix`` and
  ``apply_channel_mix`` outputs and new states (from no state, then one
  decode step from the carried one): within ``rtol=atol=1e-5``.
- The model: decode after a prefill against the teacher-forced logits,
  as ``tests/test_models_smoke.py`` checks the reference
  (``atol=2e-3``); prefill logits within ``1e-3`` of JAX's, not the
  ``1e-4`` of recurrentgemma-smoke. XLA:CPU contracts the wkv step's
  ``r · (S + u·kv)`` as one chain of fused multiply-adds over the key
  index, torch's matmul sums in another order, and at t = 0 (zero
  state) the sum cancels to ~1e-3 from terms near 1: a head whose output
  row then has a variance near 1e-7 goes through the per-head group norm
  ``(o - μ) / sqrt(var + 1e-5)``, which multiplies the difference by
  ~300 (7e-4 seen on the logits; the same layer's output is within 2e-6
  on inputs whose rows do not cancel so).
- Greedy ``generate()`` tokens (fused and stepwise; 2 × 12 prompt, 8
  tokens) equal to JAX's; ``generate(caches=...)`` over caches holding a
  nonzero state, twice, equal to JAX's, and the caller's caches left as
  they were, as the reference leaves them.
- Ragged prompts are refused with the reference's message.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.registry import get_config as j_config
from repro.models import forward as j_forward
from repro.models import init_caches as j_init_caches
from repro.models import init_model as j_init_model
from repro.models import rwkv6 as JW
from repro.runtime.generate import generate as j_generate
from repro_torch.configs.registry import get_config as t_config
from repro_torch.models import forward as t_forward
from repro_torch.models import from_jax_params, init_caches
from repro_torch.models import rwkv6 as TW
from repro_torch.runtime.generate import generate as t_generate

ARCH = "rwkv6-7b"
B, S, GEN = 2, 12, 8


@pytest.fixture(scope="module")
def weights():
    jcfg = j_config(ARCH, smoke=True)
    tcfg = t_config(ARCH, smoke=True)
    params = j_init_model(jax.random.PRNGKey(0), jcfg)
    model = from_jax_params(jax.tree.map(np.asarray, params), tcfg,
                            device="cpu")
    return jcfg, tcfg, params, model


def _prompts(seed, s=S):
    return np.random.default_rng(seed).integers(0, 512, (B, s)
                                                ).astype(np.int32)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("carried", [False, True], ids=["s0", "carried"])
def test_wkv_scan_matches_jax(carried):
    rng = np.random.default_rng(int(carried))
    r, k, v = (rng.normal(size=(B, 16, 2, 32)).astype(np.float32)
               for _ in range(3))
    w = rng.uniform(0.8, 1.0, (B, 16, 2, 32)).astype(np.float32)
    u = rng.normal(size=(2, 32)).astype(np.float32)
    s0 = rng.normal(size=(B, 2, 32, 32)).astype(np.float32) if carried \
        else np.zeros((B, 2, 32, 32), np.float32)
    jo, js = jax.jit(JW._wkv_scan)(*map(jnp.asarray, (r, k, v, w, u, s0)))
    to, ts = TW._wkv_scan(*map(_t, (r, k, v, w, u, s0)))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5,
                               atol=1e-5)


def _block_params(init, jcfg, seed):
    p = jax.tree.map(np.asarray, init(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed)
    for k in ("ln_scale", "ln_bias"):                # ones / zeros at init
        if k in p:
            p[k] = (p[k] + rng.normal(0, 0.3, p[k].shape)
                    ).astype(np.float32)
    return p


@pytest.mark.parametrize("which", ["time_mix", "channel_mix"])
def test_block_outputs_and_states_match_jax(weights, which):
    jcfg, tcfg = weights[:2]
    init, apply, cls, t_apply = {
        "time_mix": (JW.init_time_mix, JW.apply_time_mix, TW.TimeMix,
                     TW.apply_time_mix),
        "channel_mix": (JW.init_channel_mix, JW.apply_channel_mix,
                        TW.ChannelMix, TW.apply_channel_mix)}[which]
    p = _block_params(init, jcfg, 3)
    mod = cls(tcfg, device="cpu")
    with torch.no_grad():
        for k, v in p.items():
            getattr(mod, k).copy_(_t(v))
    rng = np.random.default_rng(5)
    x = rng.normal(size=(B, 20, 64)).astype(np.float32)
    x1 = rng.normal(size=(B, 1, 64)).astype(np.float32)
    run = jax.jit(lambda pp, xx, st: apply(pp, xx, jcfg, st))
    jp = jax.tree.map(jnp.asarray, p)
    jy, jst = run(jp, jnp.asarray(x), None)
    jy1, jst1 = run(jp, jnp.asarray(x1), jst)
    with torch.no_grad():
        ty, tst = t_apply(mod, _t(x), tcfg)
        ty1, tst1 = t_apply(mod, _t(x1), tcfg, tst)
    pairs = [(ty, jy), (ty1, jy1)] + [
        (st[k], jt[k]) for st, jt in ((tst, jst), (tst1, jst1)) for k in jt]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)
    assert all(v.dtype == torch.float32 for v in tst1.values())


def test_decode_matches_teacher_forcing(weights):
    _, tcfg, _, model = weights
    s = 24
    tokens = torch.from_numpy(_prompts(7, s))
    with torch.inference_mode():
        full, _ = t_forward(model, tokens, tcfg, mode="train")
        caches = init_caches(tcfg, B, s + 4, device="cpu")
        lp, caches = t_forward(model, tokens[:, :s - 1], tcfg,
                               mode="prefill", caches=caches)
        ld, _ = t_forward(model, tokens[:, s - 1:], tcfg, mode="decode",
                          caches=caches, pos0=s - 1)
    np.testing.assert_allclose(ld[:, 0].numpy(), full[:, -1].numpy(),
                               atol=2e-3)
    np.testing.assert_allclose(lp[:, -1].numpy(), full[:, -2].numpy(),
                               atol=2e-3)


def test_prefill_logits_and_state_match_jax(weights):
    jcfg, tcfg, params, model = weights
    tokens = _prompts(1, 24)
    jl, jc, _ = j_forward(params, jnp.asarray(tokens), jcfg, mode="prefill",
                          caches=j_init_caches(jcfg, B, 24))
    with torch.inference_mode():
        tl, tc = t_forward(model, torch.from_numpy(tokens), tcfg,
                           mode="prefill",
                           caches=init_caches(tcfg, B, 24, device="cpu"))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-3)
    for layer in range(2):
        for mod, leaf in (("mix", "shift"), ("mix", "s"), ("mlp", "shift")):
            np.testing.assert_allclose(
                tc[layer][mod][leaf].numpy(),
                np.asarray(jc[0][0][mod][leaf][layer]), rtol=1e-4,
                atol=1e-4)


def test_greedy_tokens_match_jax(weights):
    jcfg, tcfg, params, model = weights
    prompts = _prompts(2)
    want = np.asarray(j_generate(params, jcfg, jnp.asarray(prompts), GEN,
                                 loop="fused").tokens)
    for loop in ("fused", "stepwise"):
        got = t_generate(model, tcfg, torch.from_numpy(prompts), GEN,
                         loop=loop, device="cpu")
        np.testing.assert_array_equal(got.tokens.numpy(), want, loop)


def test_reused_caches_match_jax(weights):
    jcfg, tcfg, params, model = weights
    prompts = _prompts(3)
    rng = np.random.default_rng(9)
    jc = j_init_caches(jcfg, B, S + GEN)
    tc = init_caches(tcfg, B, S + GEN, device="cpu")
    layers = {}
    for mod, leaves in jc[0][0].items():
        for leaf, a in leaves.items():
            v = (0.5 * rng.normal(size=a.shape)).astype(np.float32)
            layers.setdefault(mod, {})[leaf] = jnp.asarray(v)
            for i in range(a.shape[0]):
                tc[i][mod][leaf].copy_(torch.from_numpy(v[i]))
    jc = ((layers,),)
    held = [{m: {k: t.clone() for k, t in c[m].items()} for m in c}
            for c in tc]
    fresh = np.asarray(j_generate(params, jcfg, jnp.asarray(prompts),
                                  GEN).tokens)
    for call in range(2):
        want = np.asarray(j_generate(params, jcfg, jnp.asarray(prompts),
                                     GEN, caches=jc).tokens)
        got = t_generate(model, tcfg, torch.from_numpy(prompts), GEN,
                         caches=tc, device="cpu")
        np.testing.assert_array_equal(got.tokens.numpy(), want,
                                      f"call {call}")
    assert not np.array_equal(want, fresh)       # the state is used
    for c, h in zip(tc, held, strict=True):
        for m in h:
            for k, t in h[m].items():
                assert torch.equal(c[m][k], t)


def test_ragged_prompts_are_refused(weights):
    jcfg, tcfg, params, model = weights
    prompts = _prompts(4)
    lengths = np.array([12, 7], np.int32)
    msg = r"ragged prompts are attention-only \(recurrent blocks \['rwkv'\]"
    with pytest.raises(ValueError, match=msg):
        j_generate(params, jcfg, jnp.asarray(prompts), 4,
                   prompt_lengths=lengths)
    with pytest.raises(ValueError, match=msg):
        t_generate(model, tcfg, torch.from_numpy(prompts), 4,
                   prompt_lengths=lengths, device="cpu")
