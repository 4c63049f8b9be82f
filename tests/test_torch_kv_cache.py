"""The port's KV-cache engine (``repro_torch.runtime.kv_cache``) against
the JAX package's (``repro.runtime.kv_cache``), on the CPU, bit for bit:
the per-head and fixed-scale quantizers (half-way values round to even
in both), and ``prefill_attend``/``decode_attend`` with per-head scales
on a ring and on a paged pool — the int8 outputs of every step, the
cache bytes, positions and scales — following the reference's
``tests/test_decode.py`` (engine against one-shot) and
``tests/test_paged.py`` (paged engine against the ring engine). The
port's fused kernels run their plain versions here; the reference's run
in Pallas interpret mode.

The reference runs with an exact ``exp2`` (ROADMAP §C).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.runtime import kv_cache as JKV
from repro_torch.runtime import kv_cache as TKV

S_Q, S_OUT = 0.05, 0.04
B, HQ, HKV, D = 2, 4, 2, 32


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


def test_quantizers_match_jax_bit_for_bit():
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (2, 40, 3, 16)).astype(np.float32)
    # half-way values on the fixed grid: round half to even
    x[0, 0, 0, :8] = (np.arange(8) - 3.5) * np.float32(0.05)
    jq, js = JKV.quantize_per_head(jnp.asarray(x))
    tq, ts = TKV.quantize_per_head(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    for axis in (1, 3):
        jq, js = JKV.quantize_per_head(jnp.asarray(x), head_axis=axis)
        tq, ts = TKV.quantize_per_head(torch.from_numpy(x), head_axis=axis)
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    for scale in (0.05, np.asarray([0.03, 0.05, 0.07], np.float32)
                  [None, None, :, None]):
        want = JKV.quantize_with_scale(jnp.asarray(x), jnp.asarray(scale))
        got = TKV.quantize_with_scale(torch.from_numpy(x), scale)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _state(cache):
    out = {"k": cache.k, "v": cache.v, "pos": cache.pos,
           "k_scale": cache.k_scale, "v_scale": cache.v_scale}
    return {n: np.asarray(a) for n, a in out.items()}


def _same_state(t, j, paged):
    tt, jj = _state(t), _state(j)
    if paged:      # the port's arena carries one sink page past the pool
        tt["k"], tt["v"] = tt["k"][:-1], tt["v"][:-1]
        np.testing.assert_array_equal(t.page_table.numpy(),
                                      np.asarray(j.page_table))
    for name, want in jj.items():
        np.testing.assert_array_equal(tt[name], want, err_msg=name)


@pytest.mark.parametrize("paged", [False, True], ids=["ring", "paged"])
def test_attend_steps_match_jax(paged):
    """A 40-token ragged prefill (lengths 40 and 29) and three decode
    steps: every int8 output and the cache after each step equal the
    reference's."""
    cap, prefill, steps = 64, 40, 3
    rng = np.random.default_rng(1)
    s = prefill + steps
    qf = rng.normal(0, 1, (B, HQ, s, D)).astype(np.float32)
    kf = rng.normal(0, 1, (B, s, HKV, D)).astype(np.float32)
    vf = rng.normal(0, 1, (B, s, HKV, D)).astype(np.float32)
    q8 = np.asarray(JKV.quantize_with_scale(jnp.asarray(qf), S_Q))
    lengths = np.asarray([prefill, 29], np.int32)
    if paged:
        jc = JKV.init_paged_cache(B, cap, HKV, D, per_head_scales=True,
                                  page_size=32)
        tc = TKV.init_paged_cache(B, cap, HKV, D, per_head_scales=True,
                                  page_size=32, device="cpu")
    else:
        jc = JKV.init_cache(B, cap, HKV, D, per_head_scales=True)
        tc = TKV.init_cache(B, cap, HKV, D, per_head_scales=True,
                            device="cpu")
    bkv = 32 if paged else 64
    jo, jc = JKV.prefill_attend(jc, jnp.asarray(q8[:, :, :prefill]),
                                jnp.asarray(kf[:, :prefill]),
                                jnp.asarray(vf[:, :prefill]), S_Q, S_OUT,
                                lengths=jnp.asarray(lengths), block_q=32,
                                block_kv=bkv)
    to, tc = TKV.prefill_attend(tc, torch.from_numpy(q8[:, :, :prefill]),
                                torch.from_numpy(kf[:, :prefill]),
                                torch.from_numpy(vf[:, :prefill]), S_Q, S_OUT,
                                lengths=torch.from_numpy(lengths),
                                block_q=32, block_kv=bkv)
    for b, n in enumerate(lengths):     # rows past a length are padding
        np.testing.assert_array_equal(to.numpy()[b, :, :n],
                                      np.asarray(jo)[b, :, :n])
    _same_state(tc, jc, paged)
    for t in range(prefill, s):
        jo, jc = JKV.decode_attend(jc, jnp.asarray(q8[:, :, t:t + 1]),
                                   jnp.asarray(kf[:, t:t + 1]),
                                   jnp.asarray(vf[:, t:t + 1]), S_Q, S_OUT,
                                   block_kv=bkv)
        to, tc = TKV.decode_attend(tc, torch.from_numpy(q8[:, :, t:t + 1]),
                                   torch.from_numpy(kf[:, t:t + 1]),
                                   torch.from_numpy(vf[:, t:t + 1]), S_Q,
                                   S_OUT, block_kv=bkv)
        np.testing.assert_array_equal(to.numpy(), np.asarray(jo),
                                      err_msg=f"decode step {t}")
        _same_state(tc, jc, paged)
