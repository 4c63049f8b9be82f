"""The MoE layer's grouped dispatch with G = 2 (``repro_torch.models.moe``)
against the JAX package's, on the CPU.

Both packages take their group count from ``hints.num_data_shards()``;
the test makes it 2 in each (no mesh: every constraint is a no-op) and
feeds 2 × 2100 tokens, so each group of 2100 has ``t·k = 4200 > 4096``
assignments and capacity ``int(1.25·t·k/E)``: with a router skewed onto
experts 0 and 1 both overflow in both groups. The keep masks (and slots,
source tokens, top-k choices) of each group equal the reference's
``_dispatch_group``, and the layer's output is within 1e-5 (float32
products summed in another order).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.registry import get_config as j_config
from repro.launch import hints as JH
from repro.models import moe as JM
from repro_torch.launch import hints as TH
from repro_torch.models import moe as TM

G = 2


@pytest.fixture
def two_groups(monkeypatch):
    monkeypatch.setattr(JH, "num_data_shards", lambda: G)
    monkeypatch.setattr(TH, "num_data_shards", lambda: G)
    jax.clear_caches()
    yield
    jax.clear_caches()


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "mixtral-8x7b"])
def test_grouped_dispatch_matches_jax(two_groups, arch):
    cfg = j_config(arch, smoke=True)
    p = jax.tree.map(np.asarray, JM.init_moe(jax.random.PRNGKey(1), cfg))
    p = dict(p, router=p["router"].copy())
    p["router"][0, :2] = 4.0
    rng = np.random.default_rng(1)
    tg, d, k, e = 2100, cfg.d_model, cfg.n_experts_active, cfg.n_experts
    x = rng.normal(size=(G, tg, d)).astype(np.float32)
    x[..., 0] = 3.0
    assert tg * k > TM.EXACT_LIMIT
    assert TM.groups(G * tg) == (G, tg)
    cap = TM.capacity(tg, k, e)
    assert cap == int(1.25 * tg * k / e)
    tp = {n: torch.from_numpy(np.array(v)) for n, v in p.items()}
    dropped = 0
    for g in range(G):
        xg = x[g]
        probs = jax.nn.softmax(jnp.asarray(xg) @ jnp.asarray(p["router"]), -1)
        _, top_i = jax.lax.top_k(probs, k)
        _, (slot, src, keep, _) = JM._dispatch_group(jnp.asarray(xg), probs,
                                                     e, k, cap)
        r = TM.route(TM.router_probs(torch.from_numpy(xg), tp["router"]), k,
                     cap)
        np.testing.assert_array_equal(r.top_i.numpy(), np.asarray(top_i))
        np.testing.assert_array_equal(r.keep.numpy(), np.asarray(keep))
        np.testing.assert_array_equal(r.slot.numpy(), np.asarray(slot))
        np.testing.assert_array_equal(r.src_tok.numpy(), np.asarray(src))
        dropped += int((~r.keep).sum())
    assert dropped == G * (tg * k - 2 * cap)
    xb = x.reshape(1, G * tg, d)                # one sequence, two groups
    want = np.asarray(JM.apply_moe(jax.tree.map(jnp.asarray, p),
                                   jnp.asarray(xb), cfg))
    got = TM.apply_moe(torch.from_numpy(xb), tp["router"], tp["w_gate"],
                       tp["w_up"], tp["w_down"], k)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    # one group of all 4200 tokens routes otherwise
    one = TM.capacity(G * tg, k, e)
    assert one != cap
