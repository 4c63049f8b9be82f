"""The port's other dense configs and its registry against the JAX
package, on the CPU: phi3-smoke (MHA, 4/4 heads) and deepseek-smoke
(GQA 8/2, head dim 8, no bias, untied) under ``attention_impl="ita"``
with the JAX package's weights through ``from_jax_params``: prefill
logits within 5e-2 (the bound of ``tests/test_torch_gemma2.py``: a float
projection that rounds otherwise can move an int8 step of 0.05) and
greedy tokens equal to JAX's. The registry lists all ten architectures
in the JAX registry's order; every registered config, full and smoke,
is the JAX package's field for field, the four once refused by name
(the recurrent and the encoder–decoder ones) among them.

The reference runs with an exact ``exp2`` (ROADMAP §C).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import registry as JR
from repro.models import forward as j_forward
from repro.models import init_caches as j_init_caches
from repro.models import init_model as j_init_model
from repro.runtime.generate import generate as j_generate
from repro_torch.configs import registry as TR
from repro_torch.models import forward as t_forward
from repro_torch.models import from_jax_params, init_caches
from repro_torch.runtime.generate import generate as t_generate

B, S, GEN = 2, 24, 6


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


@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "deepseek-coder-33b"])
def test_dense_config_logits_and_greedy_tokens_match_jax(arch):
    jcfg = JR.get_config(arch, smoke=True, attention_impl="ita")
    tcfg = TR.get_config(arch, smoke=True, attention_impl="ita")
    params = j_init_model(jax.random.PRNGKey(0), jcfg)
    model = from_jax_params(jax.tree.map(np.asarray, params), tcfg,
                            device="cpu")
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, tcfg.vocab_size, (B, S)).astype(np.int32)
    jl, _, _ = j_forward(params, jnp.asarray(tokens), jcfg, mode="prefill",
                         caches=j_init_caches(jcfg, B, S + GEN))
    with torch.inference_mode():
        tl, _ = t_forward(model, torch.from_numpy(tokens), tcfg,
                          mode="prefill",
                          caches=init_caches(tcfg, B, S + GEN, device="cpu"))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=5e-2)
    jres = j_generate(params, jcfg, jnp.asarray(tokens), GEN, loop="fused")
    got = t_generate(model, tcfg, torch.from_numpy(tokens), GEN,
                     device="cpu")
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(jres.tokens))


def test_registry_lists_the_ported_archs_in_jax_order():
    assert TR.ARCH_IDS == ("recurrentgemma-2b", "whisper-large-v3",
                           "qwen2-7b", "phi3-mini-3.8b",
                           "deepseek-coder-33b", "gemma2-27b",
                           "olmoe-1b-7b", "mixtral-8x7b",
                           "llama-3.2-vision-90b", "rwkv6-7b")
    assert TR.ARCH_IDS == JR.ARCH_IDS
    for arch in TR.ARCH_IDS:
        for smoke in (False, True):
            assert dataclasses.asdict(TR.get_config(arch, smoke=smoke)) \
                == dataclasses.asdict(JR.get_config(arch, smoke=smoke))


@pytest.mark.parametrize("arch, brings", [
    ("recurrentgemma-2b", "rglru"), ("rwkv6-7b", "rwkv6"),
    ("whisper-large-v3", "encoder-decoder"),
    ("llama-3.2-vision-90b", "encoder-decoder")])
def test_registry_refuses_the_unported_archs(arch, brings):
    """The archs the registry once refused, naming the blocks that would
    bring them (``brings``), are all registered now and are the JAX
    package's configs, full and smoke; their blocks build."""
    assert arch in JR.ARCH_IDS and arch in TR.ARCH_IDS
    for smoke in (False, True):
        assert dataclasses.asdict(TR.get_config(arch, smoke=smoke)) \
            == dataclasses.asdict(JR.get_config(arch, smoke=smoke))
    from repro_torch.models import init_model
    model = init_model(TR.get_config(arch, smoke=True), device="cpu")
    assert len(model.blocks) == TR.get_config(arch, smoke=True).n_layers
