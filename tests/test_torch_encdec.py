"""The port's encoder–decoder and cross-attention blocks against the JAX
package, on the CPU (float32), with the JAX package's weights through
``from_jax_params``: whisper-smoke (a 2-layer encoder over 16 frames,
``attn_cross`` decoder layers, LayerNorm, the biased GELU MLP,
sinusoidal positions) and llama-vision-smoke (four self-attention layers
and a gated ``cross`` layer over 16 projected patch embeddings; its
gates set to 0.5, because the reference initialises them to zero and a
zero gate hides the cross layer).

- ``layernorm``, ``GeluMLP`` and ``sinusoidal_at`` within ``1e-6`` of
  the reference (XLA:CPU's ``tanh``, ``sin``/``cos`` and ``pow`` differ
  from torch's in the last bit); ``sinusoidal_positions`` equal.
- ``ita_chunked_xla``'s QAT train forward (``ita_ste``): every STE round
  and floor (the int8 Q and K, the logits ``lg``, the shifts ``delta``
  and ``kk``) equal to the reference's bit for bit; the float32 output
  within ``2e-6`` (only the ``w·v`` sums may take another order); after
  the ``s_out`` fake-quant, equal but where the reference's value lies
  within ``TIE`` of a .5 tie, which the test counts.
- The models: the encoder's memory within ``1e-5`` (``float``) and, under
  ITA, each encoder layer fed the reference's input within ``1e-5`` but
  where one of its int8 Q/K/V elements rounded the other way at a .5 tie
  (counted: the QAT forward's output rows move then). Given the
  reference encoder's memory (a flipped tie moves a memory row by a step
  of ``s_out`` through ``wo``), the int8 cross caches ``k8``/``v8``
  equal element for element but where the reference's pre-rounding
  value lies within ``TIE`` of a .5 tie (counted); prefill logits within
  ``LOGIT_TOL``; greedy tokens of ``generate()`` equal to the
  reference's on rings, with ``paged=True`` and with ragged prompts,
  unpinned and pinned to ``ita_onepass_pallas`` (llama-vision end to
  end, its ``frontend_proj`` the port's).
- At 150 frames, the pinned path (the non-causal cross call over a key
  count padded to the 128-key tile, ``kv_len`` masking the pad) equal
  to the reference; the unpinned decode raises the reference's text in
  both packages (a per-step pad-copy of the cross cache).
- A missing frontend raises in both packages (a ``TypeError`` in the
  reference, a ``ValueError`` naming ``frontend=`` in the port);
  ``serve_continuous`` refuses both kinds with the reference's text;
  reused ``caches=`` are validated down to the cross leaves; the serve
  CLI draws a frontend for both archs and refuses ``--continuous``.

The reference runs with an exact ``exp2`` (ROADMAP §C). One JAX
``generate()`` per (model, path) is shared through module fixtures.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.attention.chunked as JC
from repro import attention as JA
from repro.configs.registry import get_config as j_config
from repro.models import forward as j_forward
from repro.models import init_caches as j_init_caches
from repro.models import init_model as j_init_model
from repro.models import layers as JL
from repro.models.transformer import _encode as j_encode
from repro.runtime.generate import ServeRequest as JRequest
from repro.runtime.generate import generate as j_generate
from repro.runtime.generate import serve_continuous as j_serve
import repro_torch.attention.chunked as TC
import repro_torch.models.transformer as TT
from repro_torch import attention as TA
from repro_torch.configs.registry import get_config as t_config
from repro_torch.models import forward as t_forward
from repro_torch.models import from_jax_params, init_caches
from repro_torch.models import layers as TL
from repro_torch.models.transformer import _encode as t_encode
from repro_torch.runtime.generate import ServeRequest, serve_continuous
from repro_torch.runtime.generate import generate as t_generate

WHISPER, VISION = "whisper-large-v3", "llama-3.2-vision-90b"
B, S, GEN = 2, 12, 8
PIN = "ita_onepass_pallas"
TIE = 1e-4            # pre-rounding distance from a .5 tie (int8 steps)
LOGIT_TOL = 1e-4      # float32 order; an int8 tie flip would exceed it
GATE = 0.5


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


def _open_gates(params, cfg):
    """The cross layers' gates set to ``GATE`` (the reference's are 0)."""
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


def _load(arch, **over):
    over = {"attention_impl": "ita", **over}
    jcfg = j_config(arch, smoke=True, **over)
    tcfg = t_config(arch, smoke=True, **over)
    params = _open_gates(j_init_model(jax.random.PRNGKey(0), jcfg), jcfg)
    model = from_jax_params(jax.tree.map(np.asarray, params), tcfg,
                            device="cpu")
    return jcfg, tcfg, params, model


@pytest.fixture(scope="module", params=[WHISPER, VISION])
def weights(request):
    return _load(request.param)


def _prompts(seed, b=B, s=S):
    return np.random.default_rng(seed).integers(0, 512, (b, s)
                                                ).astype(np.int32)


def _frontend(cfg, seed, b=B):
    return np.random.default_rng(seed).normal(
        0, 1, (b, cfg.n_frontend_tokens, cfg.frontend_dim)
    ).astype(np.float32)


def _near_tie(pre):
    return np.abs(np.abs(pre - np.floor(pre)) - 0.5) <= TIE


def _equal_but_ties(got, want, pre, what):
    """int8 ``got`` equal to ``want`` but where the reference's
    pre-rounding value ``pre`` lies within ``TIE`` of a .5 tie, and
    there by one step. Returns the count of such ties."""
    got, want = np.asarray(got), np.asarray(want)
    diff = got != want
    n = int(diff.sum())
    assert _near_tie(pre[diff]).all(), \
        f"{what}: {n} differences, not all at .5 ties"
    assert (np.abs(got.astype(int) - want.astype(int))[diff] == 1).all()
    if n:
        print(f"{what}: {n} of {got.size} differ at .5 ties")
    return n


# --------------------------------------------------------------------------
# Layers
# --------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(3, 7, 64), (130, 32)])
def test_layernorm_matches_jax(shape):
    rng = np.random.default_rng(1)
    x = rng.normal(0.5, 2, shape).astype(np.float32)
    scale = rng.normal(1, 0.1, shape[-1]).astype(np.float32)
    bias = rng.normal(0, 0.1, shape[-1]).astype(np.float32)
    want = JL.apply_norm({"scale": jnp.asarray(scale),
                          "bias": jnp.asarray(bias)}, jnp.asarray(x),
                         "layernorm")
    got = TL.layernorm(torch.from_numpy(scale), torch.from_numpy(bias),
                       torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)


def test_layernorm_rows_do_not_depend_on_neighbours():
    """Each row's bits are the same alone as in a call of 200 rows (the
    fixed row blocks)."""
    x = torch.from_numpy(np.random.default_rng(2).normal(
        0, 1, (200, 48)).astype(np.float32))
    one, zero = torch.ones(48), torch.zeros(48)
    full = TL.layernorm(one, zero, x)
    for i in (0, 127, 128, 199):
        assert torch.equal(TL.layernorm(one, zero, x[i:i + 1])[0], full[i])


def test_gelu_mlp_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.normal(0, 1, (2, 9, 64)).astype(np.float32)
    p = {"w_up": rng.normal(0, 0.1, (64, 128)),
         "b_up": rng.normal(0, 0.1, 128),
         "w_down": rng.normal(0, 0.1, (128, 64)),
         "b_down": rng.normal(0, 0.1, 64)}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    want = JL.apply_mlp({k: jnp.asarray(v) for k, v in p.items()},
                        jnp.asarray(x), "gelu")
    mlp = TL.GeluMLP(64, 128, dtype=torch.float32, device="cpu")
    with torch.no_grad():
        for k, v in p.items():
            getattr(mlp, k).copy_(torch.from_numpy(v))
        got = mlp(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)


def test_sinusoidal_positions_match_jax():
    """The encoder's numpy table is the reference's bit for bit; the
    decoder's, from per-row positions on the device, within 1e-6 of the
    reference ``forward``'s float32 formula (lockstep and per row)."""
    for seq, d in ((16, 64), (1500, 1280)):
        np.testing.assert_array_equal(TL.sinusoidal_positions(seq, d),
                                      JL.sinusoidal_positions(seq, d))
    d = 64
    for pos in (np.arange(12, dtype=np.int32),
                np.array([[3], [447]], np.int32),
                np.array([[0, 1, 2], [5, 6, 7]], np.int32)):
        dim = jnp.arange(0, d, 2, dtype=jnp.float32) / d
        ang = jnp.asarray(pos)[..., None].astype(jnp.float32) \
            / (10000.0 ** dim)
        want = jnp.zeros(ang.shape[:-1] + (d,), jnp.float32) \
            .at[..., 0::2].set(jnp.sin(ang)).at[..., 1::2].set(jnp.cos(ang))
        got = TL.sinusoidal_at(torch.from_numpy(pos), d)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                                   rtol=0)


# --------------------------------------------------------------------------
# The QAT train forward (ita_ste)
# --------------------------------------------------------------------------

def _record_stes(monkeypatch):
    """Record every STE round and floor of both packages' streaming
    attention, in call order: ``{"jax": [...], "torch": [...]}``."""
    seen = {"jax": [], "torch": []}
    for mod, key in ((JC, "jax"), (TC, "torch")):
        for name in ("_ste_round", "_ste_floor"):
            fn = getattr(mod, name)

            def rec(x, fn=fn, key=key, name=name):
                y = fn(x)
                if key == "jax":
                    jax.debug.callback(
                        lambda v, name=name: seen["jax"].append(
                            (name, np.asarray(v))), y)
                else:
                    seen["torch"].append((name, y.detach().numpy().copy()))
                return y
            monkeypatch.setattr(mod, name, rec)
    return seen


@pytest.mark.parametrize("causal, s, q_chunk", [
    (False, 20, 512), (True, 20, 512), (False, 40, 16), (True, 37, 16)])
def test_ita_chunked_train_forward_matches_jax(monkeypatch, causal, s,
                                               q_chunk):
    """The QAT forward through ``dispatch`` (``mode="train"``): its STE
    rounds and floors bit for bit, the streaming output within 2e-6, the
    fake-quantized output equal but for counted .5 ties."""
    rng = np.random.default_rng(4)
    b, h, g, d = 2, 4, 2, 16
    q, k, v = (rng.normal(0, 1.5, (b, s, n, d)).astype(np.float32)
               for n in (h, g, g))
    scales = [np.float32(x) for x in (0.05, 0.04, 0.06, 0.03)]
    spec = dict(mode="train", impl="ita", causal=causal, window=0,
                q_len=s, n_heads=h)
    seen = _record_stes(monkeypatch)
    want = np.asarray(JA.dispatch(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        spec=JA.AttentionSpec(**spec),
        scales=JA.QuantScales(*map(jnp.asarray, scales)),
        q_chunk=q_chunk, kv_chunk=q_chunk))
    got = TA.dispatch(torch.from_numpy(q), torch.from_numpy(k),
                      torch.from_numpy(v), spec=TA.AttentionSpec(**spec),
                      scales=TA.QuantScales(*map(torch.tensor, scales)),
                      q_chunk=q_chunk, kv_chunk=q_chunk).numpy()
    assert len(seen["jax"]) == len(seen["torch"]) > 2
    for (jn, jv), (tn, tv) in zip(seen["jax"], seen["torch"]):
        assert jn == tn and jv.shape == tv.shape
        np.testing.assert_array_equal(tv, jv)
    # the float32 output before the s_out fake-quant
    kw = dict(impl="ita_ste", scale=d ** -0.5, causal=causal,
              q_chunk=q_chunk, kv_chunk=q_chunk)
    vq = (np.clip(np.round(v / scales[2]), -128, 127) * scales[2]
          ).astype(np.float32)
    pre_j = np.asarray(JC.streaming_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(vq),
        s_q=jnp.asarray(scales[0]), s_k=jnp.asarray(scales[1]),
        s_v=jnp.asarray(scales[2]), **kw))
    pre_t = TC.streaming_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(vq),
        s_q=torch.tensor(scales[0]), s_k=torch.tensor(scales[1]),
        s_v=torch.tensor(scales[2]), **kw).numpy()
    np.testing.assert_allclose(pre_t, pre_j, atol=2e-6, rtol=0)
    _equal_but_ties(np.round(got / scales[3]), np.round(want / scales[3]),
                    pre_j / scales[3], f"train forward causal={causal}")


def test_train_forward_bf16_scales_match_jax():
    """Under ``param_dtype="bfloat16"`` (whisper-large-v3's), bfloat16
    activations over bfloat16 scales: V fake-quantized in bfloat16 as
    JAX promotes it; the output within 1e-5 but for counted ties."""
    rng = np.random.default_rng(5)
    b, s, h, d = 2, 24, 2, 32
    q, k, v = (rng.normal(0, 1.5, (b, s, h, d)).astype(np.float32)
               for _ in range(3))
    bf = [jnp.asarray(0.05, jnp.float32).astype(jnp.bfloat16)] * 4
    spec = dict(mode="train", impl="ita", causal=False, window=0, q_len=s,
                n_heads=h)
    want = np.asarray(JA.dispatch(
        *(jnp.asarray(t).astype(jnp.bfloat16) for t in (q, k, v)),
        spec=JA.AttentionSpec(**spec), scales=JA.QuantScales(*bf)),
        np.float32)
    tb = [torch.tensor(0.05).to(torch.bfloat16)] * 4
    got = TA.dispatch(*(torch.from_numpy(t).to(torch.bfloat16)
                        for t in (q, k, v)),
                      spec=TA.AttentionSpec(**spec),
                      scales=TA.QuantScales(*tb)).float().numpy()
    step = float(tb[3])
    diff = np.round(got / step) != np.round(want / step)
    assert diff.mean() < 1e-2, diff.sum()
    np.testing.assert_allclose(got[~diff], want[~diff], atol=1e-5, rtol=0)


# --------------------------------------------------------------------------
# The models
# --------------------------------------------------------------------------

def test_encoder_memory_float_matches_jax():
    """whisper-smoke's encoder (frontend, positions, two bidirectional
    layers of float attention, LayerNorm, GELU) within 1e-5."""
    jcfg, tcfg, params, model = _load(WHISPER, attention_impl="float")
    fr = _frontend(jcfg, 6)
    want = np.asarray(j_encode(params, jcfg, jnp.asarray(fr), "prefill"))
    with torch.inference_mode():
        got = t_encode(model, tcfg, torch.from_numpy(fr)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def _enc_layer_inputs(params, cfg, fr):
    """The reference encoder's input to each layer and its output."""
    from repro.models.transformer import apply_block
    mem = jnp.asarray(fr).astype(jnp.float32) + jnp.asarray(
        JL.sinusoidal_positions(fr.shape[1], cfg.d_model))
    ecfg = dataclasses.replace(cfg, causal=False)
    xs = [mem]
    for i in range(cfg.n_encoder_layers):
        p = jax.tree.map(lambda a: a[i], params["encoder"]["groups"][0][0])
        mem, _, _ = apply_block(p, mem, "enc", ecfg,
                                positions=jnp.arange(fr.shape[1]),
                                mem=None, cache=None, mode="train")
        xs.append(mem)
    return xs


def test_encoder_layers_match_jax_under_ita():
    """Each ITA encoder layer fed the reference's input: its output within
    1e-5 unless one of its int8 Q/K/V elements rounded the other way at a
    .5 tie of the reference's pre-rounding value (counted: such a flip
    moves the QAT forward's output rows)."""
    jcfg, tcfg, params, model = _load(WHISPER)
    fr = _frontend(jcfg, 6)
    xs = _enc_layer_inputs(params, jcfg, fr)
    ties = 0
    for i, blk in enumerate(model.encoder):
        p = jax.tree.map(lambda a: a[i], params["encoder"]["groups"][0][0])
        h = JL.apply_norm(p["norm1"], xs[i], "layernorm")
        x_t = torch.from_numpy(np.array(xs[i]))
        h_t = TL.apply_norm(blk.norm1, x_t)
        flipped = 0
        for w, s in (("wq", "s_q"), ("wk", "s_k"), ("wv", "s_v")):
            pre = np.asarray(h @ p["attn"][w]) / np.asarray(p["attn"][s])
            got = torch.round(TL.linear(h_t, getattr(blk.attn, w))
                              / getattr(blk.attn, s)).numpy()
            flipped += _equal_but_ties(np.clip(got, -128, 127),
                                       np.clip(np.round(pre), -128, 127),
                                       pre, f"encoder layer {i} {w}")
        with torch.inference_mode():
            out, _ = blk(x_t, cfg=dataclasses.replace(tcfg, causal=False),
                         positions=torch.arange(fr.shape[1]), cache=None,
                         mode="train")
        if flipped:
            ties += flipped
            continue
        np.testing.assert_allclose(out.numpy(), np.asarray(xs[i + 1]),
                                   atol=1e-5, rtol=0)
    print(f"encoder layers: {ties} int8 ties flipped")


def _cross_layers(cfg):
    """(flat layer index, group position, attention key) of each cross
    attention."""
    out, idx = [], 0
    for pattern, n in cfg.layer_groups:
        for period in range(n):
            for pos, kind in enumerate(pattern):
                if kind == "attn_cross":
                    out.append((idx, period, pos, "xattn", "cross"))
                elif kind == "cross":
                    out.append((idx, period, pos, "attn", "mix"))
                idx += 1
    return out


def test_prefill_logits_and_cross_caches_match_jax(weights, monkeypatch):
    """Given the reference's memory (the encoder is held layer by layer
    above), prefill logits within ``LOGIT_TOL`` and each cross layer's
    int8 ``k8``/``v8`` equal to the reference's but for counted .5 ties
    of its pre-rounding values (the memory's projection through
    ``wk``/``wv`` over ``s_k``/``s_v``)."""
    jcfg, tcfg, params, model = weights
    toks, fr = _prompts(1), _frontend(jcfg, 2)
    mem = j_encode(params, jcfg, jnp.asarray(fr), "prefill")
    monkeypatch.setattr(TT, "_encode", lambda model, cfg, frontend:
                        torch.from_numpy(np.array(mem)))
    jl, jc, _ = j_forward(params, jnp.asarray(toks), jcfg, mode="prefill",
                          frontend=jnp.asarray(fr),
                          caches=j_init_caches(jcfg, B, S + GEN))
    with torch.inference_mode():
        tl, tc = t_forward(model, torch.from_numpy(toks), tcfg,
                           mode="prefill", frontend=torch.from_numpy(fr),
                           caches=init_caches(tcfg, B, S + GEN,
                                              device="cpu"))
    for idx, period, pos, key, slot in _cross_layers(jcfg):
        p = jax.tree.map(lambda a: a[period], params["groups"][0][pos][key])
        for kv, w, s in (("k8", "wk", "s_k"), ("v8", "wv", "s_v")):
            pre = np.asarray((mem @ p[w]).reshape(tc[idx][slot][kv].shape)
                             / p[s])
            want = np.asarray(jc[0][pos][slot][kv])[period]
            _equal_but_ties(tc[idx][slot][kv].numpy(), want, pre,
                            f"{jcfg.name} layer {idx} {kv}")
    err = float(np.abs(tl.numpy() - np.asarray(jl)).max())
    print(f"{jcfg.name} prefill logits max |d| {err:.3g}")
    assert err <= LOGIT_TOL


# one JAX generate() per (model, path), shared by the port's runs of it
_PATHS = {"rings": {}, "pinned": dict(attention_backend=PIN),
          "ragged": {}, "ragged_pinned": dict(attention_backend=PIN)}


@pytest.fixture(scope="module")
def jax_tokens():
    cache = {}

    def get(arch, path):
        if (arch, path) not in cache:
            jcfg, _, params, _ = _load(arch, **_PATHS[path])
            kw = dict(prompt_lengths=np.array([S, 7], np.int32)) \
                if path.startswith("ragged") else {}
            cache[arch, path] = np.asarray(j_generate(
                params, jcfg, jnp.asarray(_prompts(3)), GEN,
                frontend=jnp.asarray(_frontend(jcfg, 4)), **kw).tokens)
        return cache[arch, path]
    return get


def _reference_memory(monkeypatch, params, jcfg):
    """whisper's decoder fed the reference encoder's memory: its QAT
    forward rounds outputs at .5 ties in another order than XLA:CPU's,
    and one flipped tie moves the memory's row by a step of ``s_out``
    through ``wo`` (the encoder is held layer by layer above, ties
    counted). llama-vision's ``_encode`` (``frontend_proj``) stays the
    port's."""
    if not jcfg.n_encoder_layers:
        return
    monkeypatch.setattr(TT, "_encode", lambda model, cfg, frontend:
                        torch.from_numpy(np.array(j_encode(
                            params, jcfg, jnp.asarray(frontend.numpy()),
                            "prefill"))))


@pytest.mark.parametrize("path, paged, loop", [
    ("rings", False, "fused"), ("rings", False, "stepwise"),
    ("rings", True, "fused"), ("pinned", False, "fused"),
    ("pinned", True, "stepwise"), ("ragged", False, "fused"),
    ("ragged_pinned", False, "fused")])
def test_generate_tokens_match_jax(weights, jax_tokens, monkeypatch, path,
                                   paged, loop):
    """Greedy tokens equal to the reference's ``generate()`` (rings; the
    paged pool's tokens equal the rings' in both packages), whisper's
    given the reference encoder's memory."""
    jcfg, _, params, model = weights
    _reference_memory(monkeypatch, params, jcfg)
    tcfg = t_config(_arch(jcfg), smoke=True, attention_impl="ita",
                    **_PATHS[path])
    kw = dict(prompt_lengths=np.array([S, 7], np.int32)) \
        if path.startswith("ragged") else {}
    got = t_generate(model, tcfg, torch.from_numpy(_prompts(3)), GEN,
                     frontend=torch.from_numpy(_frontend(jcfg, 4)),
                     paged=paged, loop=loop, device="cpu",
                     **kw).tokens
    np.testing.assert_array_equal(got.numpy(),
                                  jax_tokens(_arch(jcfg), path))


def _arch(cfg):
    return WHISPER if cfg.name.startswith("whisper") else VISION


@pytest.mark.parametrize("arch", [WHISPER, VISION])
def test_150_frames_pinned_matches_and_unpinned_raises(arch, monkeypatch):
    """At 150 frames the cross cache is no multiple of the 128-key tile:
    pinned to the onepass backend, both packages pad it each step and
    mask the pad through ``kv_len`` (equal tokens, whisper's given the
    reference encoder's memory); unpinned, the decode kernel refuses the
    pad-copy with the same text in both."""
    jcfg, tcfg, params, model = _load(arch, n_frontend_tokens=150)
    _reference_memory(monkeypatch, params, jcfg)
    toks, fr = _prompts(5), _frontend(jcfg, 6)
    msg = "decode KV ring capacity 150 is not a block_kv=128 multiple"
    with pytest.raises(ValueError, match=msg):
        j_generate(params, jcfg, jnp.asarray(toks), 3,
                   frontend=jnp.asarray(fr))
    with pytest.raises(ValueError, match=msg):
        t_generate(model, tcfg, torch.from_numpy(toks), 3,
                   frontend=torch.from_numpy(fr), device="cpu")
    pin = dict(attention_backend=PIN)
    want = j_generate(params, dataclasses.replace(jcfg, **pin),
                      jnp.asarray(toks), 4, frontend=jnp.asarray(fr))
    got = t_generate(model, dataclasses.replace(tcfg, **pin),
                     torch.from_numpy(toks), 4,
                     frontend=torch.from_numpy(fr), device="cpu")
    np.testing.assert_array_equal(got.tokens.numpy(),
                                  np.asarray(want.tokens))


def test_missing_frontend_raises_in_both(weights):
    jcfg, tcfg, params, model = weights
    toks = _prompts(7)
    with pytest.raises(TypeError):
        j_generate(params, jcfg, jnp.asarray(toks), 2)
    with pytest.raises(ValueError, match="frontend="):
        t_generate(model, tcfg, torch.from_numpy(toks), 2, device="cpu")
    with pytest.raises(ValueError, match="frontend="):
        with torch.inference_mode():
            t_forward(model, torch.from_numpy(toks), tcfg, mode="train")


def test_serve_continuous_refuses_cross_stacks(weights):
    jcfg, tcfg, params, model = weights
    reqs = [(np.zeros(4, np.int32), 2)]
    msg = "continuous batching serves decoder-only attention stacks"
    with pytest.raises(ValueError, match=msg):
        serve_continuous(model, tcfg, [ServeRequest(p, g) for p, g in reqs],
                         slots=2, segment=4, max_len=32, device="cpu")
    with pytest.raises(ValueError, match=msg):
        j_serve(params, jcfg, [JRequest(p, g, 0) for p, g in reqs],
                slots=2, segment=4, max_len=32)


def test_reused_caches_validate_the_cross_leaves(weights):
    """``caches=`` from ``init_caches`` (rings or ``paged=True``) is
    taken and gives the call's tokens; a cross cache of another frame
    count is refused, naming its leaf."""
    jcfg, tcfg, _, model = weights
    toks = torch.from_numpy(_prompts(3))
    fr = torch.from_numpy(_frontend(jcfg, 4))
    want = t_generate(model, tcfg, toks, 4, frontend=fr, device="cpu")
    for paged in (False, True):
        caches = init_caches(tcfg, B, S + 4, paged=paged, device="cpu")
        got = t_generate(model, tcfg, toks, 4, frontend=fr, caches=caches,
                         device="cpu")
        assert torch.equal(got.tokens, want.tokens)
    other = init_caches(dataclasses.replace(tcfg, n_frontend_tokens=24), B,
                        S + 4, device="cpu")
    with pytest.raises(ValueError, match="k8"):
        t_generate(model, tcfg, toks, 4, frontend=fr, caches=other,
                   device="cpu")


@pytest.mark.parametrize("arch", [WHISPER, VISION])
def test_serve_cli_draws_a_frontend_and_refuses_continuous(arch):
    """``--arch`` takes both cross archs on the generate CLI (a random
    frontend from the seed's generator, rings and ``--paged``);
    ``--continuous`` refuses them as the JAX package's serve does."""
    from repro_torch.launch import serve
    base = ["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2",
            "--prompt-len", "12", "--gen", "4", "--attention-impl", "ita"]
    for extra in ([], ["--paged"]):
        assert serve.main(base + extra).tokens.shape == (2, 4)
    with pytest.raises(ValueError, match="continuous batching serves "
                       "decoder-only attention stacks"):
        serve.main(base + ["--continuous", "--requests", "2"])
