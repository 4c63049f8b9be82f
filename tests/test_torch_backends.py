"""The port's three direct/baseline attention backends (``ita_direct_xla``,
``ibert_xla``, ``float_xla``) against the JAX package's, on the CPU:
their verdicts and priority order, ``dispatch`` at decode and prefill
(GQA, windows, ragged ``q_offset``/``kv_len``, softcap, a custom query
scale, float and int8 outputs), ``declared_ranges`` and
``float_attention_ref``.

The bars:

- ``ita_direct_xla`` and ``ibert_xla`` without a softcap: bit-exact
  (``np.array_equal``), on the float output and on the int8 ``s_out``
  grid. The reference runs with an exact ``exp2`` (``exact_exp2``; XLA:
  CPU approximates ``2^-n`` beyond 2^-12, ROADMAP §C).
- With a softcap, ``tanh`` comes from XLA in the reference and from
  torch in the port; they differ in the last bit of about half their
  values. The softcapped logit is then rounded onto the int8 grid, so
  one ulp can move a value that lies within one float32 ulp of a .5 tie.
  This is the one place where the integer path may be less than
  bit-exact: every output row is equal except the rows whose logits hold
  such a tie (counted; none at these shapes may differ otherwise).
- ``float_xla``: float32 inputs, within 1e-5 absolute on outputs of
  magnitude <= ~3 (``exp`` and the sums round differently in XLA and
  torch, a few ulps).
"""

import itertools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import attention as JA
from repro.attention import xla as JX
from repro.attention.spec import declared_ranges as j_ranges
from repro.core.quant import EPS_MAX
from repro.kernels.ita_attention.ref import float_attention_ref as j_fref
from repro_torch import attention as TA
from repro_torch.attention import spec as TSPEC
from repro_torch.kernels.ita_attention.ref import (float_attention_ref as
                                                   t_fref)

B, H, G, D = 2, 4, 2, 16
SCALES = (0.05, 0.04, 0.06, 0.03)          # s_q, s_k, s_v, s_out


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


def _t(x):
    return torch.from_numpy(np.asarray(x))


# --------------------------------------------------------------------------
# Verdicts, priority order and the declared contract
# --------------------------------------------------------------------------

def _sweep():
    axes = dict(mode=("train", "prefill", "decode"),
                impl=("float", "ita", "ibert"),
                layout=("bshd", "bhsd", "bhsd_bsgd", "bhsd_paged"),
                softcap=(0.0, 50.0), query_scale=(0.0, 144.0 ** -0.5),
                ragged_q=(False, True), has_s_out=(True, False))
    for values in itertools.product(*axes.values()):
        kw = dict(zip(axes, values, strict=True), q_len=1)
        try:
            JA.AttentionSpec(**kw)
        except ValueError:
            continue
        yield kw


def test_list_backends_order_and_auto_choice_match_jax():
    """For every spec of the sweep the eligible backends, in priority
    order (so the one auto-dispatch runs), and every verdict string are
    the JAX package's."""
    n = 0
    for kw in _sweep():
        jspec, tspec = JA.AttentionSpec(**kw), TA.AttentionSpec(**kw)
        assert TA.list_backends(tspec) == JA.list_backends(jspec), kw
        assert TA.backend_reasons(tspec) == JA.backend_reasons(jspec), kw
        n += 1
    assert n > 300
    assert TA.list_backends() == JA.list_backends()
    assert [b.family for b in TA.all_backends()] == \
        [b.family for b in JA.all_backends()]


def test_no_backend_raises_backend_unsupported():
    spec = dict(mode="decode", impl="float", layout="bhsd_paged", q_len=1)
    x = jnp.zeros((1, 2, 1, 16))
    with pytest.raises(JA.BackendUnsupported, match="no registered"):
        JA.dispatch(x, x, x, spec=JA.AttentionSpec(**spec),
                    page_table=jnp.zeros((1, 1), jnp.int32))
    t = torch.zeros((1, 2, 1, 16))
    with pytest.raises(TA.BackendUnsupported, match="no registered"):
        TA.dispatch(t, t, t, spec=TA.AttentionSpec(**spec),
                    page_table=torch.zeros((1, 1), dtype=torch.int32))


def test_declared_ranges_match_jax():
    for name in ("INT8_RANGE", "SCALE_BOUNDS", "MULT_BOUNDS",
                 "MAX_KV_CAPACITY"):
        from repro.attention import spec as JSPEC
        assert getattr(TSPEC, name) == getattr(JSPEC, name), name
    for impl, cap, pages in itertools.product(
            ("float", "ita", "ibert"), (None, 4096), (None, 37)):
        kw = dict(kv_capacity=cap, num_pages=pages)
        assert TSPEC.declared_ranges(TA.AttentionSpec(impl=impl), **kw) \
            == j_ranges(JA.AttentionSpec(impl=impl), **kw)


@pytest.mark.parametrize("causal,window,kv_len,q_offset", [
    (True, 0, None, 0), (True, 5, 20, 4), (False, 0, 17, 0)])
def test_float_attention_ref_matches_jax(causal, window, kv_len, q_offset):
    rng = np.random.default_rng(2)
    q = rng.normal(0, 1, (3, 12, 16)).astype(np.float32)
    k = rng.normal(0, 1, (3, 24, 16)).astype(np.float32)
    v = rng.normal(0, 1, (3, 24, 16)).astype(np.float32)
    kw = dict(causal=causal, window=window, kv_len=kv_len, q_offset=q_offset)
    want = np.asarray(j_fref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             **kw))
    got = t_fref(_t(q), _t(k), _t(v), **kw).numpy()
    np.testing.assert_allclose(got, want, atol=2e-6, rtol=0)


# --------------------------------------------------------------------------
# dispatch parity
# --------------------------------------------------------------------------

def _qkv(rng, sq, skv, quantized):
    q = rng.normal(0, 2.0, (B, sq, H, D)).astype(np.float32)
    k = rng.normal(0, 2.0, (B, skv, G, D)).astype(np.float32)
    v = rng.normal(0, 1.5, (B, skv, G, D)).astype(np.float32)
    if quantized:   # cache-like int8 K/V, as the model's rings hold them
        k = np.clip(np.round(k / SCALES[1]), -128, 127).astype(np.int8)
        v = np.clip(np.round(v / SCALES[2]), -128, 127).astype(np.int8)
    return q, k, v


def _dispatch(backend, q, k, v, spec, q_offset, kv_len, **opts):
    jscales = JA.QuantScales(*(jnp.asarray(np.float32(s)) for s in SCALES))
    tscales = TA.QuantScales(*(_t(np.float32(s)) for s in SCALES))
    j_pos = [jnp.asarray(p) if isinstance(p, np.ndarray) else p
             for p in (q_offset, kv_len)]
    t_pos = [_t(p) if isinstance(p, np.ndarray) else p
             for p in (q_offset, kv_len)]
    want = JA.dispatch(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       spec=JA.AttentionSpec(**spec), scales=jscales,
                       q_offset=j_pos[0], kv_len=j_pos[1], backend=backend,
                       **opts)
    got = TA.dispatch(_t(q), _t(k), _t(v), spec=TA.AttentionSpec(**spec),
                      scales=tscales, q_offset=t_pos[0], kv_len=t_pos[1],
                      backend=backend, **opts)
    return np.asarray(want), got.numpy()


def _tie_rows(q, k, spec):
    """(B, Sq, H) rows whose requantized logits hold a value within one
    float32 ulp of a .5 tie (the reference's pre-round values)."""
    q8 = jnp.clip(jnp.round(jnp.asarray(q) / np.float32(SCALES[0])),
                  -128, 127).astype(jnp.int32)
    k8 = jnp.asarray(k).astype(jnp.int32)
    acc = JX.gqa_logits(q8, k8).astype(jnp.float32)
    mult = jnp.float32(SCALES[0]) * jnp.float32(SCALES[1]) \
        * (spec["query_scale"] or D ** -0.5)
    pre = np.asarray(JX.softcap(acc * mult, spec["softcap"]) / EPS_MAX)
    frac = np.abs(pre - np.floor(pre) - 0.5)
    tie = (frac <= np.spacing(np.abs(pre).astype(np.float32))).any(-1)
    b, g, m, sq = tie.shape
    return tie.transpose(0, 3, 1, 2).reshape(b, sq, g * m)


DECODE = [
    # (sq, skv, q_offset, kv_len, window): ragged rows, a window, a burst
    # of four queries, scalar positions
    (1, 40, np.array([39, 17], np.int32), np.array([40, 18], np.int32), 8),
    (4, 40, np.array([36, 20], np.int32), np.array([40, 24], np.int32), 0),
    (1, 40, 39, 40, 0),
]


@pytest.mark.parametrize("backend,softmax", [
    ("ita_direct_xla", "adaptive"), ("ita_direct_xla", "paper"),
    ("ibert_xla", "adaptive")])
@pytest.mark.parametrize("softcap,query_scale", [
    (0.0, 0.0), (0.0, 0.3), (50.0, 0.0), (30.0, 0.3)])
def test_direct_int_decode_matches_jax(backend, softmax, softcap,
                                       query_scale):
    rng = np.random.default_rng(hash((backend, softcap, query_scale))
                                % 2 ** 32)
    impl = "ita" if backend == "ita_direct_xla" else "ibert"
    ties = 0
    for case, (sq, skv, q_offset, kv_len, window) in enumerate(DECODE):
        q, k, v = _qkv(rng, sq, skv, quantized=True)
        for out_dtype in ("float", "int8"):
            spec = dict(mode="decode", impl=impl, causal=True,
                        window=window, softcap=softcap,
                        query_scale=query_scale, softmax=softmax,
                        out_dtype=out_dtype, q_len=sq, n_heads=H)
            want, got = _dispatch(backend, q, k, v, spec, q_offset, kv_len)
            assert got.dtype == want.dtype
            if not softcap:
                assert np.array_equal(want, got), (case, out_dtype)
                continue
            rows = _tie_rows(q, k, spec)
            same = (want == got).all(-1)
            assert same[~rows].all(), (case, out_dtype)
            ties += int(rows.sum())
    assert ties <= 4


@pytest.mark.parametrize("softcap,window,kv_len", [
    (0.0, 0, None), (0.0, 7, 21), (30.0, 0, None)])
def test_ibert_prefill_matches_jax(softcap, window, kv_len):
    """I-BERT serves prefill too (one-shot, q_offset 0)."""
    rng = np.random.default_rng(5)
    q, k, v = _qkv(rng, 24, 24, quantized=False)
    spec = dict(mode="prefill", impl="ibert", causal=True, window=window,
                softcap=softcap, q_len=24, n_heads=H)
    want, got = _dispatch("ibert_xla", q, k, v, spec, 0, kv_len)
    if not softcap:
        assert np.array_equal(want, got)
        return
    # the reference quantizes float K here; tie rows as in the decode test
    k8 = np.clip(np.round(k / np.float32(SCALES[1])), -128, 127)
    rows = _tie_rows(q, k8, dict(spec, query_scale=0.0))
    assert (want == got).all(-1)[~rows].all()
    assert rows.sum() <= 4


@pytest.mark.parametrize("mode,sq,skv,q_offset,kv_len,window,softcap,qs", [
    ("decode", 1, 40, np.array([39, 17], np.int32),
     np.array([40, 18], np.int32), 0, 0.0, 0.0),
    ("decode", 2, 40, np.array([38, 10], np.int32),
     np.array([40, 12], np.int32), 6, 50.0, 0.3),
    ("prefill", 24, 24, 0, None, 0, 0.0, 0.0),
    ("prefill", 20, 20, 0, 17, 5, 30.0, 0.3),
])
def test_float_backend_matches_jax(mode, sq, skv, q_offset, kv_len, window,
                                   softcap, qs):
    """Decode runs ``direct_float``; prefill streams in 8-token chunks
    (the online softmax's corrections across chunks)."""
    rng = np.random.default_rng(sq + skv)
    q, k, v = _qkv(rng, sq, skv, quantized=False)
    spec = dict(mode=mode, impl="float", causal=True, window=window,
                softcap=softcap, query_scale=qs, q_len=sq, n_heads=H)
    want, got = _dispatch("float_xla", q, k, v, spec, q_offset, kv_len,
                          q_chunk=8, kv_chunk=8)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    if mode == "decode":
        # a bf16 ring (the model's float cache) keeps its dtype through
        # the products, as in the JAX package
        bf = [np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
              for a in (q, k, v)]
        want, got = _dispatch(
            "float_xla", *[a.astype(np.float32) for a in bf], spec,
            q_offset, kv_len)
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_auto_dispatch_picks_direct_for_softcapped_decode():
    """The fused kernels refuse a softcap or a custom query scale; ITA
    decode of such a spec lands on ``ita_direct_xla``, prefill on
    ``ita_chunked_xla``, in both packages."""
    for mode, q_len in (("decode", 1), ("prefill", 32)):
        kw = dict(mode=mode, impl="ita", softcap=50.0,
                  query_scale=144.0 ** -0.5, q_len=q_len)
        want = "ita_direct_xla" if mode == "decode" else "ita_chunked_xla"
        assert TA.list_backends(TA.AttentionSpec(**kw))[0] == want
        assert JA.list_backends(JA.AttentionSpec(**kw))[0] == want
