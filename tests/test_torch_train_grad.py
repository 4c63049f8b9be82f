"""The port's training loss and gradients against the JAX package, on the
CPU (float32), with the JAX package's weights through
``from_jax_params``: ``loss_fn`` and ``jax.value_and_grad`` of it against
the port's ``loss_fn`` and ``torch.autograd``, every parameter's gradient
mapped by name (``jax_named_leaves``).

- All ten smoke configs under ITA (the QAT forward of
  ``ita_chunked_xla``: STE rounds and floors, ``2^-k`` weights carrying
  ``exp2``'s gradient, V and the output fake-quantized), and
  phi3-smoke under ``float`` and ``ibert``. llama-vision's cross gates
  are set to 0.5 (the reference initialises them to zero, which would
  hide the cross layer from every gradient).
- ITA is held two ways. With the attention output's ``s_out``
  fake-quant replaced by identity in both packages, loss and every
  gradient within ``GRAD_TOL`` of the leaf's scale. As it is, the loss
  within ``LOSS_BOUND_ITA``: the QAT output often sits exactly on a .5
  tie of the ``s_out`` grid, and XLA:CPU sums ``w·v`` in another order
  than torch, so a tie may round the other way (counted and printed from
  the streaming forward's pre-rounding values; ROADMAP §C). ``float`` and
  ``ibert`` are held tight as they are.
- ``s_v`` and ``s_out`` take the structural zero gradient in both.
- phi3-smoke in bfloat16 compute (``float``, and ``ita`` without the
  output fake-quant) against JAX compiled to round after every bf16 op,
  within ``BF16_LOSS`` and ``BF16_GRAD`` (bf16 noise, not ulps), and
  ``linear``'s bf16 VJP over eight row blocks against ``x @ w``'s: the
  weight's gradient within one bf16 ulp.
- The op-level VJP of ``streaming_attention(impl="ita_ste")`` with both
  fake-quants under one cotangent, tight.
- ``ce_chunks=2`` equals ``ce_chunks=1`` (loss and gradients), remat
  on equals remat off, and the MoE aux of ``loss_fn`` is the one
  ``moe_aux_loss`` returns.

The reference runs with an exact ``exp2`` that keeps its gradient,
``e + stop_gradient(exact - e)``: the int-cast ``ldexp`` of the other
test files cuts the gradient through the exponent, and JAX's gradients of
``wq``, ``wk``, ``s_q`` and ``s_k`` would be exactly 0.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.attention.backends as JB
import repro.attention.chunked as JC
from repro.configs import registry as JR
from repro.models import init_model as j_init_model
from repro.models import loss_fn as j_loss_fn
import repro_torch.attention.backends as TB
import repro_torch.attention.chunked as TC
from repro_torch.configs import registry as TR
from repro_torch.models import (from_jax_params, jax_named_leaves, loss_fn,
                                moe_aux_loss)
from repro_torch.models.layers import linear

B, S = 2, 16
GATE = 0.5
GRAD_TOL = 1e-5       # max |Δ| over a leaf, relative to the leaf's max |g|
# rwkv6's group norm magnifies a cancelling sum (its logits are held to
# 1e-3 in tests/test_torch_rwkv6.py)
GRAD_TOL_OF = {"rwkv6-7b": 2e-3}
# a 0-d QAT scale's gradient is a sum over every Q (K) element of terms
# of ~|q|/s² that cancel to ~1e-2; float32 order moves it by ~1e-6 (the
# op-level test below holds it to 1e-7 of the terms' summed magnitude)
SCALE_ABS = 1e-5
LOSS_TOL = 2e-6       # relative
LOSS_BOUND_ITA = 5e-3  # as it is: flipped s_out ties move it (<= 1.2e-3 seen)
TIE = 1e-4


@pytest.fixture(scope="module", autouse=True)
def exact_exp2_with_gradient():
    """Exact powers of two in the reference, keeping exp2's gradient."""
    exp2 = jnp.exp2

    def exact(x):
        x = jnp.asarray(x)
        e = exp2(x)
        ex = jnp.ldexp(jnp.ones(jnp.shape(x), jnp.float32),
                       x.astype(jnp.int32))
        return e + jax.lax.stop_gradient(ex - e)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnp, "exp2", exact)
        jax.clear_caches()
        yield
    jax.clear_caches()


def _output_fake_quant_off(mp):
    """Replace the attention output's ``s_out`` fake-quant (the second of
    each train call's two; V's is the first) by identity in both
    packages."""
    for mod, name in ((JB, "fake_quant"), (TB, "_fake_quant")):
        real = getattr(mod, name)
        calls = [0]

        def fq(x, scale, real=real, calls=calls):
            calls[0] += 1
            return real(x, scale) if calls[0] % 2 else x
        mp.setattr(mod, name, fq)


def _open_gates(params, cfg):
    groups = []
    for (pattern, _), group in zip(cfg.layer_groups, params["groups"]):
        group = list(group)
        for pos, kind in enumerate(pattern):
            if kind == "cross":
                group[pos] = dict(group[pos], **{
                    g: jnp.full_like(group[pos][g], GATE)
                    for g in ("gate_attn", "gate_mlp")})
        groups.append(tuple(group))
    return dict(params, groups=tuple(groups))


def _case(arch, impl, seq=S, **over):
    jcfg = JR.get_config(arch, smoke=True, attention_impl=impl, **over)
    tcfg = TR.get_config(arch, smoke=True, attention_impl=impl, **over)
    params = _open_gates(j_init_model(jax.random.PRNGKey(0), jcfg), jcfg)
    rng = np.random.default_rng(3)
    batch = {"tokens": rng.integers(0, tcfg.vocab_size, (B, seq + 1))
             .astype(np.int32)}
    if tcfg.frontend_dim:
        batch["frontend"] = rng.normal(
            0, 1, (B, tcfg.n_frontend_tokens, tcfg.frontend_dim)
        ).astype(np.float32)
    return jcfg, tcfg, params, batch


def _jax_loss_and_grads(params, batch, jcfg, compiler_options=None):
    batch = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss, metrics), grads = jax.jit(
        jax.value_and_grad(j_loss_fn, has_aux=True), static_argnums=2
    ).lower(params, batch, jcfg).compile(
        compiler_options=compiler_options)(params, batch)
    return float(loss), jax.tree.map(np.asarray, metrics), \
        jax.tree.map(np.asarray, grads)


def _port_loss_and_grads(params, batch, tcfg):
    model = from_jax_params(jax.tree.map(np.asarray, params), tcfg,
                            device="cpu")
    model.requires_grad_(True)
    loss, metrics = loss_fn(model, {k: torch.from_numpy(v)
                                    for k, v in batch.items()}, tcfg)
    loss.backward()
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
             .float().numpy() for n, p in model.named_parameters()}
    return float(loss.detach()), {k: float(v.detach())
                                  for k, v in metrics.items()}, grads


def _check_grads(jgrads, tgrads, tcfg, tol=GRAD_TOL):
    want = dict(jax_named_leaves(jgrads, tcfg))
    assert set(want) == set(tgrads), set(want) ^ set(tgrads)
    worst = 0.0
    for name, g in tgrads.items():
        w = np.asarray(want[name], np.float32)
        err = float(np.abs(g - w).max())
        if name.endswith(("s_v", "s_out")):
            assert float(np.abs(g).max()) == 0.0 == float(np.abs(w).max())
        elif name.endswith(("s_q", "s_k")):
            assert err <= SCALE_ABS, (name, err, float(w))
        else:
            scale = max(float(np.abs(w).max()), 1e-30)
            assert err <= tol * scale, (name, err, scale)
            worst = max(worst, err / scale)
    return worst


ITA_ARCHS = TR.ARCH_IDS


@pytest.mark.parametrize("arch", ITA_ARCHS)
def test_ita_loss_and_gradients_match_jax_without_output_fake_quant(arch):
    jcfg, tcfg, params, batch = _case(arch, "ita")
    with pytest.MonkeyPatch.context() as mp:
        _output_fake_quant_off(mp)
        jl, jm, jg = _jax_loss_and_grads(params, batch, jcfg)
        tl, tm, tg = _port_loss_and_grads(params, batch, tcfg)
    assert abs(tl - jl) <= LOSS_TOL * abs(jl), (tl, jl)
    assert abs(tm["aux"] - float(jm["aux"])) <= 1e-6 * max(
        1.0, abs(float(jm["aux"])))
    worst = _check_grads(jg, tg, tcfg, GRAD_TOL_OF.get(arch, GRAD_TOL))
    print(f"{arch}: loss {tl:.7f} vs {jl:.7f}, worst tensor gradient "
          f"{worst:.2e} of its leaf's scale")
    # the QAT scales of Q and K learn through the STE rounds
    for name, g in tg.items():
        if name.endswith(("attn.s_q", "attn.s_k")):
            assert np.abs(g).max() > 0, name


@pytest.mark.parametrize("arch", ITA_ARCHS)
def test_ita_loss_as_is_within_bound_of_jax(arch):
    jcfg, tcfg, params, batch = _case(arch, "ita")
    jl = float(jax.jit(lambda p, b: j_loss_fn(p, b, jcfg)[0])(
        params, {k: jnp.asarray(v) for k, v in batch.items()}))
    model = from_jax_params(jax.tree.map(np.asarray, params), tcfg,
                            device="cpu")
    ties = [0, 0]
    real = TC.streaming_attention

    def counting(q, k, v, **kw):
        out = real(q, k, v, **kw)
        if kw.get("impl") == "ita_ste":
            # the port's own pre-rounding output on the s_out grid (0.05)
            pre = out.detach().numpy() / 0.05
            near = np.abs(np.abs(pre - np.floor(pre)) - 0.5) <= TIE
            ties[0] += int(near.sum())
            ties[1] += near.size
        return out
    with pytest.MonkeyPatch.context() as mp, torch.no_grad():
        mp.setattr(TB, "streaming_attention", counting)
        tl = float(loss_fn(model, {k: torch.from_numpy(v)
                                   for k, v in batch.items()}, tcfg)[0])
    print(f"{arch}: loss as is {tl:.7f} vs {jl:.7f}; {ties[0]} of "
          f"{ties[1]} QAT outputs within {TIE} of an s_out tie")
    assert abs(tl - jl) <= LOSS_BOUND_ITA * abs(jl), (tl, jl)


@pytest.mark.parametrize("impl", ["float", "ibert"])
def test_phi3_loss_and_gradients_match_jax(impl):
    jcfg, tcfg, params, batch = _case("phi3-mini-3.8b", impl)
    jl, _, jg = _jax_loss_and_grads(params, batch, jcfg)
    tl, _, tg = _port_loss_and_grads(params, batch, tcfg)
    assert abs(tl - jl) <= LOSS_TOL * abs(jl), (tl, jl)
    _check_grads(jg, tg, tcfg)


# bfloat16 compute (phi3-mini's own): JAX compiled without XLA:CPU's
# excess precision, so that it rounds after every bf16 op as the port
# does. Autograd and JAX's VJPs still round other intermediates (a SiLU's
# derivative in one rounding or several), so the gradients agree to the
# bf16 noise of the products, not to the ulp. Bounds: about twice the
# readings at 2 x 128 tokens (float: loss 3.2e-5, worst leaf 1.5e-2 of
# its norm; ita without the output fake-quant: loss 9e-6, worst leaf
# 8.5e-2, the STE rounds of q/s_q flipping where bf16 moves q by an ulp).
BF16_SEQ = 128
BF16_LOSS = {"float": 2e-4, "ita": 1e-3}      # relative
BF16_GRAD = {"float": 3e-2, "ita": 0.2}       # ||Δ|| / ||g|| per leaf
NO_EXCESS = {"xla_allow_excess_precision": False}


@pytest.mark.parametrize("impl", ["float", "ita"])
def test_phi3_bf16_loss_and_gradients_match_jax(impl):
    jcfg, tcfg, params, batch = _case("phi3-mini-3.8b", impl, seq=BF16_SEQ,
                                      dtype="bfloat16")
    with pytest.MonkeyPatch.context() as mp:
        if impl == "ita":
            _output_fake_quant_off(mp)
        jl, _, jg = _jax_loss_and_grads(params, batch, jcfg, NO_EXCESS)
        tl, _, tg = _port_loss_and_grads(params, batch, tcfg)
    assert abs(tl - jl) <= BF16_LOSS[impl] * abs(jl), (tl, jl)
    want = dict(jax_named_leaves(jg, tcfg))
    assert set(want) == set(tg)
    worst = 0.0
    for name, g in tg.items():
        w = np.asarray(want[name], np.float32)
        if name.endswith(("s_v", "s_out")):
            assert float(np.abs(g).max()) == 0.0 == float(np.abs(w).max())
            continue
        if name.endswith(("s_q", "s_k")):
            assert g != 0, name
            continue
        rel = float(np.linalg.norm(g - w) / np.linalg.norm(w))
        assert rel <= BF16_GRAD[impl], (name, rel)
        worst = max(worst, rel)
    print(f"{impl} bf16: loss {tl:.7f} vs {jl:.7f}, worst leaf {worst:.2e}")


def _bf16_ulps(got, want):
    """|got - want| in units of bf16's last place at ``want``."""
    e = np.floor(np.log2(np.maximum(np.abs(want), 1e-30)))
    return np.abs(got - want) / np.exp2(e - 7)


def test_linear_vjp_matches_jax_in_bf16():
    """``layers.linear`` over eight row blocks against JAX's
    ``x @ w.astype(bf16)``: the weight's gradient is one product over all
    rows, float32-accumulated and rounded once, so it is within one bf16
    ulp of JAX's (a sum of eight rounded block partials is off by up to
    thousands of ulp where the rows cancel); the input's gradient and
    the output too, but for a few elements near zero."""
    rng = np.random.default_rng(4)
    m, k, n = 8 * 128, 64, 96
    x = rng.normal(0, 1, (m, k)).astype(np.float32)
    w = rng.normal(0, 0.05, (k, n)).astype(np.float32)
    ct = rng.normal(0, 1, (m, n)).astype(np.float32)
    bf = jnp.bfloat16
    jout, vjp = jax.vjp(lambda x, w: x @ w.astype(bf),
                        jnp.asarray(x).astype(bf), jnp.asarray(w))
    jgx, jgw = (np.asarray(a.astype(jnp.float32))
                for a in vjp(jnp.asarray(ct).astype(bf)))
    tx = torch.tensor(x).bfloat16().requires_grad_(True)
    tw = torch.tensor(w).bfloat16().requires_grad_(True)
    out = linear(tx, tw)
    out.backward(torch.tensor(ct).bfloat16())
    gw = tw.grad.float().numpy()
    assert _bf16_ulps(gw, jgw).max() <= 1
    assert (gw != jgw).mean() < 1e-3
    for got, want in ((out.detach().float().numpy(),
                       np.asarray(jout.astype(jnp.float32))),
                      (tx.grad.float().numpy(), jgx)):
        assert (got != want).mean() < 1e-3
        assert np.abs(got - want).max() <= 2 ** -7 * np.abs(want).max()


def test_streaming_attention_ste_vjp_matches_jax():
    """``ita_chunked_xla``'s train attention (V and the output
    fake-quantized, ``impl="ita_ste"``) under one cotangent: the
    gradients of q, k, v and the four scales."""
    rng = np.random.default_rng(9)
    b, s, h, g, hd = 2, 40, 4, 2, 8
    q = rng.normal(0, 2, (b, s, h, hd)).astype(np.float32)
    k = rng.normal(0, 2, (b, s, g, hd)).astype(np.float32)
    v = rng.normal(0, 1, (b, s, g, hd)).astype(np.float32)
    ct = rng.normal(0, 1, (b, s, h, hd)).astype(np.float32)
    sc = np.float32(0.05)
    kw = dict(impl="ita_ste", scale=hd ** -0.5, causal=True, q_chunk=16,
              kv_chunk=16)

    def jf(q, k, v, s_q, s_k, s_v, s_out):
        from repro.core.quant import fake_quant
        out = JC.streaming_attention(q, k, fake_quant(v, s_v), s_q=s_q,
                                     s_k=s_k, s_v=s_v, **kw)
        return fake_quant(out, s_out)
    jout, vjp = jax.vjp(jf, *(jnp.asarray(a) for a in (q, k, v)),
                        *(jnp.asarray(sc),) * 4)
    jgrads = vjp(jnp.asarray(ct))

    ts = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    tsc = [torch.tensor(sc, requires_grad=True) for _ in range(4)]
    out = TC.streaming_attention(ts[0], ts[1], TB._fake_quant(ts[2], tsc[2]),
                                 s_q=tsc[0], s_k=tsc[1], s_v=tsc[2], **kw)
    out = TB._fake_quant(out, tsc[3])
    out.backward(torch.from_numpy(ct))
    # outputs: equal but at the s_out ties the w·v order may flip
    diff = np.abs(out.detach().numpy() - np.asarray(jout))
    assert (diff > 1e-6).mean() < 0.01
    for t, want in zip(ts, jgrads):
        want = np.asarray(want)
        np.testing.assert_allclose(t.grad.numpy(), want, rtol=0,
                                   atol=1e-6 * np.abs(want).max())
    # s_q, s_k: sums of terms ~q·∂q/s that cancel (module docstring)
    for t, s, want in zip(ts[:2], tsc[:2], jgrads[3:5]):
        terms = float((t.grad * t / s).detach().abs().sum())
        assert abs(float(s.grad) - float(want)) <= 1e-7 * terms
    assert float(tsc[2].grad) == 0.0 == float(tsc[3].grad)
    assert float(jgrads[5]) == 0.0 == float(jgrads[6])


def _grads_of(tcfg, params, batch):
    return _port_loss_and_grads(params, batch, tcfg)


@pytest.mark.parametrize("change", [dict(ce_chunks=2), dict(remat=False)])
def test_ce_chunks_and_remat_leave_loss_and_gradients(change):
    jcfg, tcfg, params, batch = _case("qwen2-7b", "ita")
    l1, _, g1 = _grads_of(tcfg, params, batch)
    l2, _, g2 = _grads_of(dataclasses.replace(tcfg, **change), params,
                          batch)
    assert abs(l1 - l2) <= 1e-6 * abs(l1)
    for n in g1:
        scale = max(float(np.abs(g1[n]).max()), 1e-30)
        assert np.abs(g1[n] - g2[n]).max() <= 1e-5 * scale, n


def test_loss_fn_takes_moe_aux_from_its_own_forward():
    _, tcfg, params, batch = _case("olmoe-1b-7b", "ita")
    model = from_jax_params(jax.tree.map(np.asarray, params), tcfg,
                            device="cpu")
    tokens = torch.from_numpy(batch["tokens"])
    with torch.no_grad():
        loss, m = loss_fn(model, {"tokens": tokens}, tcfg)
        aux = moe_aux_loss(model, tokens[:, :-1], tcfg)
    assert float(m["aux"]) > 0 and torch.equal(m["aux"], aux)
    assert torch.equal(loss, m["nll"] + 0.01 * m["aux"])
