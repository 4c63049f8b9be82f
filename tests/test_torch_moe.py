"""The port's mixture of experts (``repro_torch.models.moe``) and the MoE
decoders olmoe-smoke (8 experts top-2) and mixtral-smoke (4 experts
top-2, sliding window 16) against the JAX package, on the CPU, with the
JAX package's weights loaded through ``from_jax_params``.

- The layer: in the exact regime (``t·k <= 4096``) the routing (``top_i``,
  the keep mask, the slots, the source tokens) equals the reference's
  ``_dispatch_group`` and the output is within 1e-5 (float32 products
  sum in another order); in the dropping regime (``t·k > 4096``) with a
  router skewed so that two experts take every token, some assignments
  drop and the keep mask equals the reference's; ``moe_aux_loss`` within
  1e-6.
- The models under ``attention_impl="ita"``: prefill logits within 5e-2
  (the bound of ``tests/test_torch_gemma2.py``: a float projection that
  rounds otherwise can move an int8 step of 0.05), greedy tokens equal
  to JAX's, the fused loop's equal to the stepwise loop's; a chunked
  serve pinned to ``ita_onepass_pallas`` equal to the JAX serve and to
  solo ``generate()``.
- ``param_dtype="bfloat16"`` (olmoe-1b-7b's own setting, under which the
  reference casts every leaf, QAT scales included): the pytree loads,
  the scales are the reference's bfloat16 values, layer 0's int8 K/V
  cache equals the reference's byte for byte and the logits stay within
  5e-2; ``s_q * s_k * scale`` is formed in bfloat16 as JAX forms it.

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
from repro.models import moe as JM
from repro.runtime.generate import ServeRequest as JRequest
from repro.runtime.generate import generate as j_generate
from repro.runtime.generate import serve_continuous as j_serve
from repro_torch.attention.xla import scale_product
from repro_torch.configs.registry import get_config as t_config
from repro_torch.models import forward as t_forward
from repro_torch.models import from_jax_params, init_caches, init_model
from repro_torch.models import moe as TM
from repro_torch.models import moe_aux_loss as t_moe_aux_loss
from repro_torch.runtime.generate import (ServeRequest, generate,
                                          serve_continuous)

B, S, GEN = 2, 40, 8
ARCHS = ("olmoe-1b-7b", "mixtral-8x7b")


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


def _moe_params(arch, seed=0):
    cfg = j_config(arch, smoke=True)
    p = jax.tree.map(np.asarray, JM.init_moe(jax.random.PRNGKey(seed), cfg))
    return cfg, p


def _torch(p):
    return {k: torch.from_numpy(np.array(v)) for k, v in p.items()}


def _jax_routing(p, x2, cfg, cap):
    probs = jax.nn.softmax(jnp.asarray(x2) @ jnp.asarray(p["router"]), -1)
    _, top_i = jax.lax.top_k(probs, cfg.n_experts_active)
    _, (slot, src_tok, keep, _) = JM._dispatch_group(
        jnp.asarray(x2), probs, cfg.n_experts, cfg.n_experts_active, cap)
    return [np.asarray(a) for a in (top_i, slot, src_tok, keep)]


def _check_layer(cfg, p, x):
    b, s, d = x.shape
    k = cfg.n_experts_active
    cap = TM.capacity(b * s, k, cfg.n_experts)
    tp = _torch(p)
    x2 = torch.from_numpy(x.reshape(-1, d))
    r = TM.route(TM.router_probs(x2, tp["router"]), k, cap)
    top_i, slot, src_tok, keep = _jax_routing(p, x.reshape(-1, d), cfg, cap)
    np.testing.assert_array_equal(r.top_i.numpy(), top_i)
    np.testing.assert_array_equal(r.keep.numpy(), keep)
    np.testing.assert_array_equal(r.slot.numpy(), slot)
    np.testing.assert_array_equal(r.src_tok.numpy(), src_tok)
    want = np.asarray(JM.apply_moe(jax.tree.map(jnp.asarray, p),
                                   jnp.asarray(x), cfg))
    got = TM.apply_moe(torch.from_numpy(x), tp["router"], tp["w_gate"],
                       tp["w_up"], tp["w_down"], k)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    return r


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_layer_matches_jax_exact_capacity(arch):
    cfg, p = _moe_params(arch)
    x = np.random.default_rng(0).normal(size=(3, 40, cfg.d_model)) \
        .astype(np.float32)
    r = _check_layer(cfg, p, x)
    assert r.cap == 3 * 40 * cfg.n_experts_active and bool(r.keep.all())


@pytest.mark.parametrize("arch", ARCHS)
def test_capacity_buffer_covers_the_call_tokens_not_cap(arch):
    """A token's experts are distinct, so an expert takes at most ``t``
    of the ``cap = t·k`` slots: the buffer holds ``ceil(t/128)`` blocks,
    each expert's sorted tokens in order, zeros past its count, and the
    layer still equals the reference."""
    cfg, p = _moe_params(arch, seed=2)
    t, d = 300, cfg.d_model
    x = np.random.default_rng(2).normal(size=(1, t, d)).astype(np.float32)
    r = _check_layer(cfg, p, x)
    assert r.cap == t * cfg.n_experts_active > t
    x2 = torch.from_numpy(x.reshape(t, d))
    buf = TM.dispatch(x2, r)
    assert buf.shape == (-(-t // TM.ROW_BLOCK), cfg.n_experts,
                         TM.ROW_BLOCK, d)
    rows = buf.transpose(0, 1).reshape(cfg.n_experts, -1, d)
    ends = list(r.starts[1:].tolist()) + [r.order.shape[0]]
    for e, (a, z) in enumerate(zip(r.starts.tolist(), ends)):
        assert torch.equal(rows[e, :z - a], x2[r.src_tok[a:z]])
        assert not rows[e, z - a:].any()


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_layer_drops_past_capacity_like_jax(arch):
    """``t·k = 4200 > 4096``: capacity ``int(1.25·t·k/E)``; the router
    sends every token to experts 0 and 1, so both overflow."""
    cfg, p = _moe_params(arch, seed=1)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(1, 2100, cfg.d_model)).astype(np.float32)
    x[..., 0] = 3.0
    p = dict(p, router=p["router"].copy())
    p["router"][0, :2] = 4.0
    assert 2100 * cfg.n_experts_active > TM.EXACT_LIMIT
    r = _check_layer(cfg, p, x)
    assert r.cap == int(1.25 * 4200 / cfg.n_experts)
    assert set(np.unique(r.top_i.numpy())) == {0, 1}
    assert int((~r.keep).sum()) == 4200 - 2 * r.cap


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_aux_loss_matches_jax(arch):
    cfg, p = _moe_params(arch)
    x = np.random.default_rng(2).normal(size=(2, 24, cfg.d_model)) \
        .astype(np.float32)
    want = float(JM.moe_aux_loss(jax.tree.map(jnp.asarray, p),
                                 jnp.asarray(x), cfg))
    got = TM.moe_aux_loss(torch.from_numpy(x), _torch(p)["router"],
                          cfg.n_experts_active)
    assert abs(float(got) - want) <= 1e-6


def test_model_aux_loss_matches_jax_train_forward():
    """The summed aux loss of the JAX package's train-mode ``forward``
    (float attention: the ITA train forward is the QAT path of the
    training slice)."""
    jcfg = j_config("olmoe-1b-7b", smoke=True)
    tcfg = t_config("olmoe-1b-7b", smoke=True)
    params = j_init_model(jax.random.PRNGKey(3), jcfg)
    model = from_jax_params(jax.tree.map(np.asarray, params), tcfg,
                            device="cpu")
    tokens = np.random.default_rng(4).integers(0, 512, (2, 16)) \
        .astype(np.int32)
    _, _, want = j_forward(params, jnp.asarray(tokens), jcfg, mode="train")
    with torch.inference_mode():
        got = t_moe_aux_loss(model, torch.from_numpy(tokens), tcfg)
    assert abs(float(got) - float(want)) <= 1e-5
    assert float(got) > 0


def test_top_k_breaks_ties_toward_the_lower_expert():
    probs = torch.tensor([[0.1, 0.3, 0.3, 0.3], [0.25, 0.25, 0.25, 0.25]])
    w, i = TM.top_k(probs, 2)
    jw, ji = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(w.numpy(), np.asarray(jw))


# ---------------------------------------------------------------------------
# The models
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=ARCHS)
def model_case(request):
    jcfg = j_config(request.param, smoke=True, attention_impl="ita")
    tcfg = t_config(request.param, smoke=True, attention_impl="ita")
    params = j_init_model(jax.random.PRNGKey(0), jcfg)
    model = from_jax_params(jax.tree.map(np.asarray, params), tcfg,
                            device="cpu")
    return jcfg, tcfg, params, model


def _prompts(seed):
    return np.random.default_rng(seed).integers(0, 512, (B, S)) \
        .astype(np.int32)


def test_moe_prefill_logits_match_jax(model_case):
    jcfg, tcfg, params, model = model_case
    tokens = _prompts(1)
    jl, _, _ = j_forward(params, jnp.asarray(tokens), jcfg, mode="prefill",
                         caches=j_init_caches(jcfg, B, S + GEN))
    with torch.inference_mode():
        tl, tc = t_forward(model, torch.from_numpy(tokens), tcfg,
                           mode="prefill",
                           caches=init_caches(tcfg, B, S + GEN,
                                              device="cpu"))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=5e-2)
    if tcfg.window:
        assert tc[0]["mix"].capacity == tcfg.window


def test_moe_greedy_tokens_match_jax_fused_equals_stepwise(model_case):
    jcfg, tcfg, params, model = model_case
    prompts = _prompts(2)
    jres = j_generate(params, jcfg, jnp.asarray(prompts), GEN, loop="fused")
    fused = generate(model, tcfg, torch.from_numpy(prompts), GEN,
                     device="cpu")
    stepwise = generate(model, tcfg, torch.from_numpy(prompts), GEN,
                        device="cpu", loop="stepwise")
    np.testing.assert_array_equal(fused.tokens.numpy(),
                                  np.asarray(jres.tokens))
    assert torch.equal(fused.tokens, stepwise.tokens)


def test_olmoe_pinned_chunked_serve_matches_jax_and_solo():
    """Under the onepass pin the reference's serve equals solo
    ``generate()`` for MoE as for dense models; so does the port's."""
    pin = dict(attention_impl="ita", attention_backend="ita_onepass_pallas")
    jcfg = j_config("olmoe-1b-7b", smoke=True, **pin)
    tcfg = t_config("olmoe-1b-7b", smoke=True, **pin)
    params = j_init_model(jax.random.PRNGKey(0), jcfg)
    model = from_jax_params(jax.tree.map(np.asarray, params), tcfg,
                            device="cpu")
    prng = np.random.default_rng(3)
    reqs, step = [], 0
    for _ in range(4):
        plen = int(prng.integers(3, 13))
        reqs.append(ServeRequest(
            prompt=prng.integers(0, 512, plen).astype(np.int32),
            gen=int(prng.integers(2, 7)), arrival=step))
        step += int(prng.integers(0, 3))
    kw = dict(slots=3, segment=4, max_len=128, page_size=128, chunk_size=5)
    jres = j_serve(params, jcfg, [JRequest(r.prompt, r.gen, r.arrival)
                                  for r in reqs], **kw)
    want = {c.index: np.asarray(c.tokens) for c in jres.completed}
    got = serve_continuous(model, tcfg, reqs, device="cpu", **kw)
    assert len(got.completed) == len(reqs)
    for c in got.completed:
        solo = generate(model, tcfg,
                        torch.as_tensor(reqs[c.index].prompt)[None],
                        reqs[c.index].gen, max_len=128, device="cpu")
        np.testing.assert_array_equal(np.asarray(c.tokens), want[c.index])
        np.testing.assert_array_equal(np.asarray(c.tokens),
                                      solo.tokens[0].numpy())


# ---------------------------------------------------------------------------
# param_dtype="bfloat16"
# ---------------------------------------------------------------------------

def test_olmoe_bf16_params_load_and_match_jax():
    jcfg = j_config("olmoe-1b-7b", smoke=True, attention_impl="ita",
                    param_dtype="bfloat16")
    tcfg = t_config("olmoe-1b-7b", smoke=True, attention_impl="ita",
                    param_dtype="bfloat16")
    params = j_init_model(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree.map(np.asarray, params)
    assert tree["groups"][0][0]["attn"]["s_q"].dtype.name == "bfloat16"
    model = from_jax_params(tree, tcfg, device="cpu")
    attn = model.blocks[0].attn
    for name in ("s_q", "s_k", "s_v", "s_out"):
        leaf = getattr(attn, name)
        assert leaf.dtype == torch.bfloat16
        assert float(leaf) == float(tree["groups"][0][0]["attn"][name][0]) \
            == 0.050048828125
    assert model.blocks[0].mlp.router.dtype == torch.float32
    tokens = _prompts(4)
    jl, jc, _ = j_forward(params, jnp.asarray(tokens), jcfg, mode="prefill",
                          caches=j_init_caches(jcfg, B, S + GEN))
    with torch.inference_mode():
        tl, tc = t_forward(model, torch.from_numpy(tokens), tcfg,
                           mode="prefill",
                           caches=init_caches(tcfg, B, S + GEN,
                                              device="cpu"))
    for kv in ("k", "v"):
        np.testing.assert_array_equal(
            getattr(tc[0]["mix"], kv).numpy()[:, :S],
            np.asarray(getattr(jc[0][0]["mix"], kv))[0, :, :S])
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=5e-2)


def test_bf16_init_rounds_through_param_dtype():
    cfg = t_config("olmoe-1b-7b", smoke=True, attention_impl="ita",
                   param_dtype="bfloat16")
    model = init_model(cfg, seed=0, device="cpu")
    w = model.blocks[0].mlp.w_gate
    assert w.dtype == torch.float32
    assert torch.equal(w, w.to(torch.bfloat16).float())
    assert model.blocks[0].norm1.dtype == torch.bfloat16


@pytest.mark.parametrize("scale", [8 ** -0.5, 16 ** -0.5, 96 ** -0.5,
                                   128 ** -0.5, 144 ** -0.5])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_scale_product_promotes_like_jax(scale, dtype):
    """``s_q * s_k * scale`` of the streaming and direct paths, for the
    0.05 QAT scales in either param dtype and the configs' query
    scales."""
    s = jnp.asarray(0.05, jnp.float32).astype(dtype)
    want = np.asarray(jnp.asarray(s * s * scale, jnp.float32))
    ts = torch.tensor(0.05).to(getattr(torch, dtype))
    got = scale_product(ts, ts, scale, "cpu")
    assert got.dtype == torch.float32
    assert float(got) == float(want)
    model_cfg = dataclasses.replace(t_config("olmoe-1b-7b", smoke=True),
                                    param_dtype=dtype)
    assert model_cfg.param_torch_dtype() == getattr(torch, dtype)
