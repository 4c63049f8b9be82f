"""gemma2 and the paper's baselines end to end against the JAX package, on
the CPU: the port's ``gemma2-smoke`` (alternating local/global blocks,
local window 16, GeGLU, post-norms, scaled embeddings, attention softcap
50, final logit softcap 30, query scale 16^-0.5) and ``qwen2-smoke``
under ``attention_impl="float"`` and ``"ibert"``, with the JAX package's
weights (norm gains perturbed, so that every norm, post-norms included,
must load) through ``from_jax_params``.

A 40-token prompt wraps gemma2's 16-entry local rings in prefill, and
decode runs over the wrapped rings. Its ITA prefill goes through
``ita_chunked_xla`` and its decode through ``ita_direct_xla`` (the fused
kernels refuse the softcap and the query scale).

Bars: greedy tokens identical; the port's fused loop equal to its
stepwise loop; prefill logits within ``atol=5e-2`` on the integer paths
(float projections round differently in XLA and torch, which can move an
int8 quantization by one step, 0.05 at the QAT scales; with the
softcap, torch's and XLA's ``tanh`` also differ by an ulp, which can move
a logit lying within one ulp of a .5 tie onto the other int8 value, see
``tests/test_torch_backends.py``) and within ``1e-4`` under ``float``.
The reference runs with an exact ``exp2`` (ROADMAP §C).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import attention as JA
from repro.configs.registry import get_config as j_config
from repro.models import forward as j_forward
from repro.models import init_caches as j_init_caches
from repro.models import init_model as j_init_model
from repro.models.attention import make_spec as j_spec
from repro.runtime.generate import generate as j_generate
from repro_torch import attention as TA
from repro_torch.configs.registry import get_config as t_config
from repro_torch.models import forward as t_forward
from repro_torch.models import from_jax_params, init_caches
from repro_torch.models.attention import make_spec as t_spec
from repro_torch.models.transformer import embed_scale
from repro_torch.runtime.generate import generate as t_generate

B, S, GEN = 2, 40, 8

CASES = {
    "gemma2-ita": ("gemma2-27b", "ita", 5e-2),
    "qwen2-float": ("qwen2-7b", "float", 1e-4),
    "qwen2-ibert": ("qwen2-7b", "ibert", 5e-2),
}


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


def _perturb_norms(tree, rng):
    """Random norm gains (zeros at init), so a norm left unloaded shows."""
    if isinstance(tree, dict):
        return {k: (rng.normal(0, 0.3, np.shape(v)).astype(np.float32)
                    if k == "scale" else _perturb_norms(v, rng))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_perturb_norms(v, rng) for v in tree)
    return tree


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    arch, impl, atol = CASES[request.param]
    jcfg = j_config(arch, smoke=True, attention_impl=impl)
    tcfg = t_config(arch, smoke=True, attention_impl=impl)
    tree = _perturb_norms(jax.tree.map(
        np.asarray, j_init_model(jax.random.PRNGKey(0), jcfg)),
        np.random.default_rng(1))
    params = jax.tree.map(jnp.asarray, tree)
    model = from_jax_params(tree, tcfg, device="cpu")
    return jcfg, tcfg, params, model, atol


def _prompts(seed=0):
    return np.random.default_rng(seed).integers(0, 512, (B, S)
                                                ).astype(np.int32)


def test_prefill_logits_match_jax(case):
    jcfg, tcfg, params, model, atol = case
    tokens = _prompts(1)
    jl, _, _ = j_forward(params, jnp.asarray(tokens), jcfg, mode="prefill",
                         caches=j_init_caches(jcfg, B, S + GEN))
    with torch.inference_mode():
        tl, tc = t_forward(model, torch.from_numpy(tokens), tcfg,
                           mode="prefill",
                           caches=init_caches(tcfg, B, S + GEN,
                                              device="cpu"))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=atol)
    if tcfg.name.startswith("gemma2"):
        # local rings hold the window, global rings the whole stream
        caps = [c["mix"].capacity for c in tc]
        assert caps == [16, S + GEN]
        assert np.abs(tl.numpy()).max() <= tcfg.logit_softcap
        assert model.blocks[0].post_norm1.abs().max() > 0


def test_greedy_tokens_match_jax_fused_equals_stepwise(case):
    jcfg, tcfg, params, model, _ = case
    prompts = _prompts(2)
    jres = j_generate(params, jcfg, jnp.asarray(prompts), GEN, loop="fused")
    fused = t_generate(model, tcfg, torch.from_numpy(prompts), GEN,
                       device="cpu")
    stepwise = t_generate(model, tcfg, torch.from_numpy(prompts), GEN,
                          device="cpu", loop="stepwise")
    assert np.array_equal(np.asarray(jres.tokens), fused.tokens.numpy())
    assert torch.equal(fused.tokens, stepwise.tokens)


def test_serving_backends_of_each_case(case):
    """Which backend serves prefill and decode for each case (both
    packages agree): gemma2's softcap sends ITA decode to the direct
    path; the baselines run their own backends at both."""
    jcfg, tcfg, _, _, _ = case
    want = {"ita": ("ita_chunked_xla", "ita_direct_xla"),
            "float": ("float_xla", "float_xla"),
            "ibert": ("ibert_xla", "ibert_xla")}[tcfg.attention_impl]
    for (mode, q_len), name in zip((("prefill", S), ("decode", 1)), want):
        kw = dict(mode=mode, causal=True, window=tcfg.local_window,
                  q_len=q_len)
        assert TA.list_backends(t_spec(tcfg, **kw))[0] == name
        assert JA.list_backends(j_spec(jcfg, **kw))[0] == name


def test_embed_scale_rounds_to_the_compute_dtype():
    """sqrt(d) is rounded to the compute dtype first (67.88 -> 68.0 in
    bf16 at gemma2-27b's width), as ``jnp.asarray(np.sqrt(d), dt)``."""
    cfg = t_config("gemma2-27b")
    got = embed_scale(cfg, torch.bfloat16, "cpu")
    assert float(got) == 68.0
    assert float(got) == float(jnp.asarray(np.sqrt(4608), jnp.bfloat16))
    smoke = t_config("gemma2-27b", smoke=True)
    assert float(embed_scale(smoke, torch.float32, "cpu")) == 8.0
