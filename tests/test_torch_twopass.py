"""The port's twopass path (the paper's dataflow) against the JAX package,
on the CPU.

Inputs are made with numpy from a seed and go through the JAX package
(the Pallas twopass kernels in interpret mode) and through
``repro_torch`` on the CPU, where the twopass wrapper computes its plain
version. The bar is bit-exact equality of the int8 output and of the
int8 attention matrix A; end to end, identical greedy tokens of
``generate()`` with ``attention_backend="ita_twopass_pallas"``. The
reference runs with an exact ``exp2`` (``jnp.ldexp``; see
``tests/test_torch_kernels.py`` and ROADMAP §C). The CUDA kernels are
held to these plain versions on the card by ``tests/test_torch_cuda.py``.
"""

import zlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import attention as JA
from repro.configs.registry import get_config as j_config
from repro.kernels.ita_attention import kernel as JK
from repro.kernels.ita_attention import ref as JR
from repro.kernels.ita_attention.ops import fused_attention as j_fused
from repro.models import init_model as j_init_model
from repro.runtime.generate import generate as j_generate
from repro_torch import attention as TA
from repro_torch.configs.registry import get_config as t_config
from repro_torch.kernels.ita_attention import kernel as TK
from repro_torch.kernels.ita_attention import ref as TR
from repro_torch.kernels.ita_attention.ops import fused_attention as t_fused
from repro_torch.models import from_jax_params
from repro_torch.runtime.generate import generate as t_generate


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


def _i8(rng, *shape):
    return rng.integers(-128, 128, shape, dtype=np.int8)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _j(x):
    return jnp.asarray(x) if isinstance(x, np.ndarray) else x


# --------------------------------------------------------------------------
# The twopass kernels (plain versions) against the Pallas kernels
# --------------------------------------------------------------------------

TWOPASS_CASES = [
    # id, bh, kv_rep, sq, skv, d, block_q, block_kv, causal, window, ragged
    ("causal-mha-2tiles", 4, 1, 32, 128, 32, 16, 64, True, 0, False),
    ("noncausal-one-tile", 2, 1, 16, 48, 16, 16, 48, False, 0, False),
    ("window-3tiles", 2, 1, 32, 192, 16, 32, 64, True, 40, False),
    ("kvlen-tail-ragged", 4, 1, 16, 256, 16, 16, 128, True, 0, True),
    ("gqa-7to1", 14, 7, 16, 128, 32, 8, 64, True, 0, True),
]


def _twopass_inputs(case):
    _, bh, rep, sq, skv, d, _, _, _, _, ragged = case
    rng = np.random.default_rng(zlib.crc32(case[0].encode()))
    q, k, v = (_i8(rng, bh, sq, d), _i8(rng, bh // rep, skv, d),
               _i8(rng, bh // rep, skv, d))
    lmult = rng.uniform(0.004, 0.03, bh).astype(np.float32)
    omult = rng.uniform(0.5, 2.0, bh).astype(np.float32)
    if ragged:
        kv_len = rng.integers(sq, skv + 1, bh).astype(np.int32)
        q_offset = (kv_len - sq).astype(np.int32)
    else:
        kv_len, q_offset = skv, 0
    return q, k, v, lmult, omult, kv_len, q_offset


@pytest.mark.parametrize("adaptive", [True, False])
@pytest.mark.parametrize("case", TWOPASS_CASES, ids=[c[0] for c in
                                                     TWOPASS_CASES])
def test_twopass_plain_matches_pallas(case, adaptive):
    """``ita_attention_twopass``: out and A bit-exact."""
    _, _, rep, _, _, _, bq, bkv, causal, window, _ = case
    q, k, v, lmult, omult, kv_len, q_offset = _twopass_inputs(case)
    kw = dict(q_offset=q_offset, causal=causal, window=window,
              adaptive=adaptive, block_q=bq, block_kv=bkv, kv_rep=rep)
    want = JK.ita_attention_twopass(
        *(_j(x) for x in (q, k, v, lmult, omult, kv_len)), interpret=True,
        **{n: _j(x) for n, x in kw.items()})
    TK.reset_launches()
    got = TK.ita_attention_twopass(
        *(_t(x) if isinstance(x, np.ndarray) else x
          for x in (q, k, v, lmult, omult, kv_len)),
        **{n: _t(x) if isinstance(x, np.ndarray) else x
           for n, x in kw.items()})
    for w, g, what in zip(want, got, ("out", "A"), strict=True):
        assert np.array_equal(np.asarray(w), g.numpy()), what
    assert not any(TK.LAUNCHES.values())        # plain versions: no launch


def test_twopass_passes_compose():
    """The two passes' plain versions, run one after the other, give the
    wrapper's (out, A); pass 1's adaptive Σ_inv lies in [128, 256]."""
    case = TWOPASS_CASES[3]
    q, k, v, lmult, omult, kv_len, q_offset = (
        _t(x) if isinstance(x, np.ndarray) else x
        for x in _twopass_inputs(case))
    kw = dict(q_offset=q_offset, causal=True, block_kv=case[7])
    a, row_max, inv, e_r = TK.twopass_qk_plain(q, k, lmult, kv_len,
                                               adaptive=True, **kw)
    out = TK.twopass_av_plain(a, row_max, inv, e_r, v, omult, kv_len, **kw)
    want_out, want_a = TK.ita_attention_twopass(q, k, v, lmult, omult,
                                                kv_len, adaptive=True, **kw)
    assert torch.equal(out, want_out) and torch.equal(a, want_a)
    assert row_max.shape == inv.shape == e_r.shape == q.shape[:2]
    assert int(inv.max()) <= 256 and int(inv.min()) >= 128


@pytest.mark.parametrize("adaptive", [False, True])
@pytest.mark.parametrize("case", [c for c in TWOPASS_CASES
                                  if c[8] and not c[10]],
                         ids=[c[0] for c in TWOPASS_CASES
                              if c[8] and not c[10]])
def test_twopass_en_reaches_256_on_causal_calls(case, adaptive):
    """EN's ``p = Σ_inv >> k`` reaches 256 = SIGMA_INV_MAX, one over u8,
    on every causal call: a query that sees a single key has Σ = 256 and
    Σ_inv = 256 under both DIs, and that key has k = 0. The CUDA pass 2
    splits such a p into two u8 products; the bit-exact cases of
    ``tests/test_torch_cuda.py`` and ``chip_smoke.py`` hold it. Here the
    statistics of ``twopass_qk_plain`` are checked against the Pallas
    pass 1 + DI, and p (pass 2's EN, as ``ref.twopass_out`` takes it) is
    at most 256 everywhere, and 256 at the one key of every query that
    sees a single key (query 0 at q_offset 0)."""
    _, bh, rep, sq, skv, _, _, bkv, causal, window, _ = case
    q, k, v, lmult, omult, kv_len, q_offset = _twopass_inputs(case)
    kw = dict(q_offset=q_offset, causal=causal, window=window,
              block_kv=bkv, kv_rep=rep)
    tkw = {n: _t(x) if isinstance(x, np.ndarray) else x
           for n, x in kw.items()}
    a, row_max, inv, e_r = TK.twopass_qk_plain(
        _t(q), _t(k), _t(lmult), _t(kv_len) if isinstance(
            kv_len, np.ndarray) else kv_len, adaptive=adaptive, **tkw)
    # the Pallas pass 1 (its A) and the DI of the JAX package on its Σ
    _, want_a = JK.ita_attention_twopass(
        *(_j(x) for x in (q, k, v, lmult, omult, kv_len)), interpret=True,
        adaptive=adaptive, block_q=sq, **{n: _j(x) for n, x in kw.items()})
    assert np.array_equal(np.asarray(want_a), a.numpy())
    lens = torch.as_tensor(kv_len).reshape(-1).expand(bh)
    offs = torch.as_tensor(q_offset).reshape(-1).expand(bh)
    valid = TK._row_valid(torch.stack([lens, offs, torch.full_like(
        lens, sq)], 1).to(torch.int32), sq, skv, causal, window)
    shift = torch.clamp((row_max[..., None] - a.int()).clamp(min=0) >> 5,
                        max=31)
    p = inv[..., None] >> torch.where(valid, shift, 31)
    assert int(p.max()) == 256 and int(p.min()) >= 0
    first = valid.int().argmax(dim=-1)          # each query's first key
    alone = valid.sum(dim=-1) == 1
    assert alone.any()
    pick = p.gather(-1, first[..., None])[..., 0]
    assert bool((pick[alone] == 256).all())
    assert bool((inv[alone] == 256).all())


@pytest.mark.parametrize("adaptive", [False, True])
def test_twopass_single_tile_equals_paper_oneshot(adaptive):
    """Single KV tile: the twopass kernel equals the one-shot paper-EN
    oracle exactly (the mirror of ``tests/test_kernels.py``'s test), and
    the port's oracle equals the JAX one (out and A)."""
    rng = np.random.default_rng(11)
    bh, s, d = 2, 64, 64
    q, k, v = _i8(rng, bh, s, d), _i8(rng, bh, s, d), _i8(rng, bh, s, d)
    lm, om = np.float32(0.0125), np.float32(2.5)
    want = JR.ita_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), lm, om, s, causal=True,
                                adaptive=adaptive)
    ref = TR.ita_attention_ref(_t(q), _t(k), _t(v), torch.tensor(lm),
                               torch.tensor(om), s, causal=True,
                               adaptive=adaptive)
    for w, g in zip(want, ref, strict=True):
        assert np.array_equal(np.asarray(w), g.numpy())
    out, a = TK.ita_attention_twopass(_t(q), _t(k), _t(v), lm, om, s,
                                      causal=True, adaptive=adaptive,
                                      block_q=64, block_kv=64)
    assert torch.equal(out, ref[0]) and torch.equal(a, ref[1])


@pytest.mark.parametrize("window,kv_len", [(0, 230), (50, 256)])
def test_ita_attention_ref_matches_jax_windowed(window, kv_len):
    rng = np.random.default_rng(window + kv_len)
    q, k, v = _i8(rng, 3, 24, 32), _i8(rng, 3, 256, 32), _i8(rng, 3, 256, 32)
    lm, om = np.float32(0.011), np.float32(1.3)
    want = JR.ita_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), lm, om, kv_len, causal=True,
                                window=window, adaptive=True, q_offset=200)
    got = TR.ita_attention_ref(_t(q), _t(k), _t(v), torch.tensor(lm),
                               torch.tensor(om), kv_len, causal=True,
                               window=window, adaptive=True, q_offset=200)
    for w, g in zip(want, got, strict=True):
        assert np.array_equal(np.asarray(w), g.numpy())


# --------------------------------------------------------------------------
# fused_attention(kind="twopass") and dispatch
# --------------------------------------------------------------------------

FUSED_CASES = [
    # id, b, hq, hkv, sq, skv, d, block_q, causal, window, per_head, ragged
    ("sq40-bq16-skv200", 1, 2, 1, 40, 200, 32, 16, True, 0, False, False),
    ("gqa-per-head", 2, 4, 2, 32, 128, 16, 128, True, 0, True, False),
    ("window-ragged", 2, 2, 2, 16, 160, 16, 16, True, 24, False, True),
    ("short-skv48", 1, 2, 2, 48, 48, 16, 128, False, 0, False, False),
]


@pytest.mark.parametrize("adaptive", [True, False])
@pytest.mark.parametrize("case", FUSED_CASES, ids=[c[0] for c in
                                                   FUSED_CASES])
def test_fused_twopass_matches_jax(case, adaptive):
    """Padding of Sq to block_q and of Skv to the KV tile, GQA, per-head
    scales, ragged kv_len/q_offset."""
    (name, b, hq, hkv, sq, skv, d, bq, causal, window, per_head,
     ragged) = case
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    q = _i8(rng, b, hq, sq, d)
    k, v = _i8(rng, b, hkv, skv, d), _i8(rng, b, hkv, skv, d)
    if per_head:
        s_q = rng.uniform(0.03, 0.08, hq).astype(np.float32)
        s_k = rng.uniform(0.03, 0.08, hkv).astype(np.float32)
        s_v = rng.uniform(0.03, 0.08, hkv).astype(np.float32)
        s_out = rng.uniform(0.01, 0.05, hq).astype(np.float32)
    else:
        s_q, s_k, s_v, s_out = (np.float32(x) for x in
                                rng.uniform(0.02, 0.08, 4))
    kw = dict(causal=causal, window=window, kind="twopass",
              adaptive=adaptive, block_q=bq)
    if ragged:
        kv_len = rng.integers(sq, skv + 1, b).astype(np.int32)
        kw.update(kv_len=kv_len, q_offset=(kv_len - sq).astype(np.int32))
    want = j_fused(*(jnp.asarray(a) for a in (q, k, v, s_q, s_k, s_v,
                                              s_out)),
                   interpret=True, **{n: _j(a) for n, a in kw.items()})
    got = t_fused(*(_t(a) for a in (q, k, v, s_q, s_k, s_v, s_out)),
                  **{n: _t(a) if isinstance(a, np.ndarray) else a
                     for n, a in kw.items()})
    assert np.array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("layout", ["bshd", "bhsd", "bhsd_bsgd"])
def test_dispatch_twopass_float_inputs_match_jax(layout):
    """Float q/k/v through ``dispatch(backend="ita_twopass_pallas")``:
    quantization, the cache-native-to-kernel-layout transpose, and the
    dequantized output."""
    rng = np.random.default_rng(5)
    b, s, h, g, d = 2, 24, 4, 2, 16
    q = rng.normal(0, 1.5, (b, s, h, d)).astype(np.float32)
    k = rng.normal(0, 1.5, (b, s, g, d)).astype(np.float32)
    v = rng.normal(0, 1.5, (b, s, g, d)).astype(np.float32)
    if layout != "bshd":
        q = q.transpose(0, 2, 1, 3).copy()
    if layout == "bhsd":
        k, v = (x.transpose(0, 2, 1, 3).copy() for x in (k, v))
    scales = [np.float32(x) for x in (0.05, 0.04, 0.06, 0.03)]
    spec = dict(mode="prefill", impl="ita", causal=True, window=0, q_len=s,
                n_heads=h, layout=layout, softmax="paper")
    want = JA.dispatch(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       spec=JA.AttentionSpec(**spec),
                       scales=JA.QuantScales(*map(jnp.asarray, scales)),
                       backend="ita_twopass_pallas", interpret=True)
    got = TA.dispatch(_t(q), _t(k), _t(v), spec=TA.AttentionSpec(**spec),
                      scales=TA.QuantScales(*map(_t, scales)),
                      backend="ita_twopass_pallas")
    assert np.array_equal(np.asarray(want), got.numpy())


REFUSALS = [
    ("cache-native", dict(kv_native=True),
     "cache-native KV layout serves the onepass/decode kernels only"),
    ("paged", dict(page_table=np.zeros((1, 1), np.int32)),
     "the paged pool serves the onepass/decode kernels only"),
    ("ragged", dict(q_lens=np.ones(1, np.int32)),
     "ragged q_len serves the onepass/decode kernels only"),
]


@pytest.mark.parametrize("case", REFUSALS, ids=[c[0] for c in REFUSALS])
def test_fused_twopass_refusals_match_jax(case):
    _, kw, reason = case
    x = np.zeros((1, 2, 4, 16), np.int8)
    with pytest.raises(AssertionError, match=reason):
        j_fused(*(jnp.asarray(a) for a in (x, x, x)), 0.05, 0.05, 0.05,
                0.05, kind="twopass", interpret=True,
                **{n: _j(a) for n, a in kw.items()})
    with pytest.raises(ValueError, match=reason):
        t_fused(*(_t(a) for a in (x, x, x)), 0.05, 0.05, 0.05, 0.05,
                kind="twopass",
                **{n: _t(a) if isinstance(a, np.ndarray) else a
                   for n, a in kw.items()})


@pytest.mark.parametrize("spec", [
    dict(mode="decode", q_len=1),
    dict(mode="decode", q_len=4, layout="bhsd_paged"),
    dict(mode="prefill", q_len=16, ragged_q=True),
    dict(mode="train"),
], ids=["decode", "paged", "ragged", "train"])
def test_twopass_refuses_what_jax_refuses(spec):
    """The backend's verdicts and the pinned dispatch's refusal, with the
    JAX package's reasons."""
    jspec = JA.AttentionSpec(impl="ita", **spec)
    tspec = TA.AttentionSpec(impl="ita", **spec)
    want = JA.get_backend("ita_twopass_pallas").supports(jspec)
    got = TA.get_backend("ita_twopass_pallas").supports(tspec)
    assert want is not True and got == want
    x = torch.zeros((1, 4, 2, 16))
    with pytest.raises(TA.BackendUnsupported, match="does not support"):
        TA.dispatch(x, x, x, spec=tspec, backend="ita_twopass_pallas",
                    scales=TA.QuantScales.per_tensor(0.05, s_out=0.05))


# --------------------------------------------------------------------------
# generate() pinned to the twopass backend
# --------------------------------------------------------------------------

B, S, GEN = 2, 20, 8


@pytest.fixture(scope="module")
def weights():
    cfg = j_config("qwen2-7b", smoke=True, attention_impl="ita")
    params = j_init_model(jax.random.PRNGKey(0), cfg)
    tree = jax.tree.map(np.asarray, params)
    return params, from_jax_params(tree, t_config(
        "qwen2-7b", smoke=True, attention_impl="ita"), device="cpu")


GEN_CASES = {
    "adaptive": ("ita_adaptive", {}),
    "paper": ("ita_paper", {}),
    "paper-ragged": ("ita_paper",
                     {"prompt_lengths": np.array([20, 11], np.int32)}),
    "adaptive-ragged-wrap": ("ita_adaptive",
                             {"max_len": 26,
                              "prompt_lengths": np.array([9, 20], np.int32)}),
}


@pytest.mark.parametrize("case", list(GEN_CASES))
def test_twopass_pinned_greedy_tokens_match_jax(weights, case):
    """Prefill through the twopass kernels (decode falls back to the
    decode kernel, as in the JAX package): equal greedy tokens."""
    params, model = weights
    softmax, kw = GEN_CASES[case]
    over = dict(smoke=True, attention_impl="ita",
                attention_backend="ita_twopass_pallas", softmax_impl=softmax)
    jcfg, tcfg = j_config("qwen2-7b", **over), t_config("qwen2-7b", **over)
    prompts = np.random.default_rng(2).integers(0, 512, (B, S)
                                                ).astype(np.int32)
    jres = j_generate(params, jcfg, jnp.asarray(prompts), GEN, loop="fused",
                      **{n: _j(a) for n, a in kw.items()})
    tres = t_generate(model, tcfg, torch.from_numpy(prompts), GEN,
                      device="cpu", **kw)
    assert np.array_equal(np.asarray(jres.tokens), tres.tokens.numpy())
