"""The port's attention engine against the JAX package, on the CPU:
``fused_attention``, the chunked ``ita_int`` prefill, ``dispatch``,
``KVCacheState`` writes and the backends' verdicts.

Inputs are made with numpy from a seed; integer outputs and cache states
must be equal (``np.array_equal``). The reference runs with an exact
``exp2`` — XLA:CPU approximates ``2^-n`` for n > 12 (ROADMAP §C); see
``tests/test_torch_kernels.py``.
"""

import itertools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import attention as JA
from repro.attention import xla as JX
from repro.core import quant as JQ
from repro.attention.chunked import streaming_attention as j_stream
from repro.kernels.ita_attention.ops import fused_attention as j_fused
from repro_torch import attention as TA
from repro_torch.attention import xla as TX
from repro_torch.core import quant as TQ
from repro_torch.attention.chunked import streaming_attention as t_stream
from repro_torch.kernels.ita_attention.ops import fused_attention as t_fused

# every backend of the JAX package, in its priority order
PORTED = ("ita_decode_pallas", "ita_chunked_xla", "ita_onepass_pallas",
          "ita_twopass_pallas", "ita_direct_xla", "ibert_xla", "float_xla")


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


# --------------------------------------------------------------------------
# Quantization and the direct-path mask
# --------------------------------------------------------------------------

def test_quant_constants_and_rounding_match_jax():
    for name in ("INT8_MIN", "INT8_MAX", "EPS_MAX", "SOFTMAX_SHIFT"):
        assert getattr(TQ, name) == getattr(JQ, name), name
    assert isinstance(TQ.EPS_MAX, np.float64)
    rng = np.random.default_rng(2)
    x = rng.normal(0, 4, 4096).astype(np.float32)
    x[:8] = [0.5, 1.5, 2.5, -0.5, -1.5, 6.35, -6.45, 1e3]   # ties, clips
    scale = np.float32(0.1)
    for jf, tf in ((JQ.quantize, TQ.quantize),
                   (JX.quantize_to_int8, TX.quantize_to_int8)):
        want = np.asarray(jf(jnp.asarray(x), jnp.asarray(scale)))
        assert np.array_equal(want, tf(_t(x), _t(scale)).numpy())
    q = rng.integers(-128, 128, 64, dtype=np.int8)
    assert np.array_equal(np.asarray(JQ.dequantize(jnp.asarray(q), scale)),
                          TQ.dequantize(_t(q), _t(scale)).numpy())


@pytest.mark.parametrize("q_offset,kv_len,causal,window", [
    (0, None, True, 0),
    (5, 12, True, 4),
    (np.array([3, 0, 9], np.int32), np.array([9, 4, 16], np.int32), True,
     0),
    (np.array([1, 2, 3], np.int32), 10, False, 3),
])
def test_direct_mask_matches_jax(q_offset, kv_len, causal, window):
    want = JX.mask(4, 16, q_offset, causal, window, kv_len)
    got = TX.mask(4, 16, _t(q_offset) if isinstance(q_offset, np.ndarray)
                  else q_offset, causal, window,
                  _t(kv_len) if isinstance(kv_len, np.ndarray) else kv_len)
    assert np.array_equal(np.asarray(want), got.numpy())


# --------------------------------------------------------------------------
# fused_attention
# --------------------------------------------------------------------------

FUSED_CASES = [
    # id, kind, b, hq, hkv, sq, skv, d, native, causal, window, per_head,
    # ragged
    ("decode-ring256-native-gqa", "decode", 2, 4, 2, 1, 256, 16, True,
     True, 0, True, True),
    ("decode-ring20", "decode", 2, 2, 2, 2, 20, 16, False, True, 0, False,
     True),
    ("onepass-skv48-window", "onepass", 1, 4, 2, 48, 48, 16, False, True,
     20, False, False),
    ("onepass-skv200-padded", "onepass", 1, 2, 1, 16, 200, 32, False, True,
     0, True, True),
    ("onepass-native-qlens", "onepass", 2, 4, 1, 16, 128, 16, True, True,
     0, False, True),
]


@pytest.mark.parametrize("adaptive", [True, False])
@pytest.mark.parametrize("case", FUSED_CASES, ids=[c[0] for c in
                                                   FUSED_CASES])
def test_fused_attention_matches_jax(case, adaptive):
    (name, kind, b, hq, hkv, sq, skv, d, native, causal, window, per_head,
     ragged) = case
    rng = np.random.default_rng(len(name) * 31 + hq)
    q = _i8(rng, b, hq, sq, d)
    kv_shape = (b, skv, hkv, d) if native else (b, hkv, skv, d)
    k, v = _i8(rng, *kv_shape), _i8(rng, *kv_shape)
    if per_head:
        s_q = rng.uniform(0.03, 0.08, hq).astype(np.float32)
        s_k = rng.uniform(0.03, 0.08, hkv).astype(np.float32)
        s_v = rng.uniform(0.03, 0.08, hkv).astype(np.float32)
        s_out = rng.uniform(0.01, 0.05, hq).astype(np.float32)
    else:
        s_q, s_k, s_v, s_out = (np.float32(x) for x in
                                rng.uniform(0.02, 0.08, 4))
    kw = dict(causal=causal, window=window, kind=kind, adaptive=adaptive,
              kv_native=native)
    if ragged:
        kv_len = rng.integers(sq, skv + 1, b).astype(np.int32)
        kw["kv_len"] = kv_len
        kw["q_offset"] = (kv_len - sq).astype(np.int32)
        if kind == "onepass":
            kw["q_lens"] = rng.integers(1, sq + 1, b).astype(np.int32)
    want = j_fused(*(jnp.asarray(a) for a in (q, k, v, s_q, s_k, s_v,
                                              s_out)),
                   interpret=True, **{n: jnp.asarray(a) if isinstance(
                       a, np.ndarray) else a for n, a in kw.items()})
    got = t_fused(*(_t(a) for a in (q, k, v, s_q, s_k, s_v, s_out)),
                  **{n: _t(a) if isinstance(a, np.ndarray) else a
                     for n, a in kw.items()})
    assert np.array_equal(np.asarray(want), got.numpy())


def test_decode_ring_pad_is_refused():
    with pytest.raises(ValueError, match="block_kv"):
        t_fused(torch.zeros((1, 2, 1, 16), dtype=torch.int8),
                torch.zeros((1, 200, 2, 16), dtype=torch.int8),
                torch.zeros((1, 200, 2, 16), dtype=torch.int8),
                0.05, 0.05, 0.05, 0.05, kind="decode", kv_native=True)


# --------------------------------------------------------------------------
# Chunked ita_int prefill
# --------------------------------------------------------------------------

CHUNK_CASES = [
    # id, b, h, g, s, d, q_chunk, kv_chunk, causal, window, kv_len
    ("padded-16x16", 2, 4, 2, 40, 16, 16, 16, True, 0, None),
    ("window-multi-chunk", 1, 4, 1, 64, 16, 32, 16, True, 24, None),
    ("q64-kv32", 1, 2, 2, 64, 32, 64, 32, True, 0, None),
    ("bidirectional-kvlen", 1, 2, 1, 48, 16, 16, 32, False, 0, 37),
    ("one-chunk-512", 1, 2, 1, 96, 16, 512, 512, True, 0, None),
]


@pytest.mark.parametrize("adaptive", [True, False])
@pytest.mark.parametrize("case", CHUNK_CASES, ids=[c[0] for c in
                                                   CHUNK_CASES])
def test_chunked_ita_int_matches_jax(case, adaptive):
    name, b, h, g, s, d, qc, kc, causal, window, kv_len = case
    rng = np.random.default_rng(len(name) * 7 + s)
    q, k, v = _i8(rng, b, s, h, d), _i8(rng, b, s, g, d), _i8(rng, b, s, g, d)
    s_q, s_k, s_v = (np.float32(x) for x in rng.uniform(0.03, 0.08, 3))
    kw = dict(impl="ita_int", scale=d ** -0.5, causal=causal, window=window,
              kv_len=kv_len, adaptive=adaptive, q_chunk=qc, kv_chunk=kc)
    want = j_stream(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    s_q=jnp.asarray(s_q), s_k=jnp.asarray(s_k),
                    s_v=jnp.asarray(s_v), **kw)
    got = t_stream(_t(q), _t(k), _t(v), s_q=_t(s_q), s_k=_t(s_k),
                   s_v=_t(s_v), **kw)
    assert np.array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("backend", [None, "ita_onepass_pallas"])
def test_dispatch_float_inputs_match_jax(backend):
    """Model-layout float q/k/v through ``dispatch``: quantization, the
    backend and the dequantized float output."""
    rng = np.random.default_rng(5)
    b, s, h, g, d = 2, 24, 4, 2, 16
    q = rng.normal(0, 1.5, (b, s, h, d)).astype(np.float32)
    k = rng.normal(0, 1.5, (b, s, g, d)).astype(np.float32)
    v = rng.normal(0, 1.5, (b, s, g, d)).astype(np.float32)
    scales = [np.float32(x) for x in (0.05, 0.04, 0.06, 0.03)]
    spec = dict(mode="prefill", impl="ita", causal=True, window=0, q_len=s,
                n_heads=h)
    want = JA.dispatch(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       spec=JA.AttentionSpec(**spec),
                       scales=JA.QuantScales(*map(jnp.asarray, scales)),
                       backend=backend, interpret=True)
    got = TA.dispatch(_t(q), _t(k), _t(v), spec=TA.AttentionSpec(**spec),
                      scales=TA.QuantScales(*map(_t, scales)),
                      backend=backend)
    assert np.array_equal(np.asarray(want), got.numpy())


def test_all_backends_registered_and_qat_train_raises():
    """All seven backends are registered, in the JAX package's priority
    order (auto-dispatch depends on it); the QAT train forward, which
    raised until the encoder needed it, is served by ``ita_chunked_xla``
    as in the JAX package and equals its output (the STE forward on
    values whose ``w·v`` sums are exact: V on a power-of-two grid)."""
    assert TA.list_backends() == JA.list_backends() == list(PORTED)
    rng = np.random.default_rng(8)
    q = rng.normal(0, 1.5, (1, 6, 2, 16)).astype(np.float32)
    k = rng.normal(0, 1.5, (1, 6, 2, 16)).astype(np.float32)
    v = rng.integers(-8, 8, (1, 6, 2, 16)).astype(np.float32) * 0.125
    spec = dict(mode="train", impl="ita", q_len=6, n_heads=2)
    assert TA.list_backends(TA.AttentionSpec(**spec))[0] \
        == JA.list_backends(JA.AttentionSpec(**spec))[0] == "ita_chunked_xla"
    want = JA.dispatch(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       spec=JA.AttentionSpec(**spec),
                       scales=JA.QuantScales.per_tensor(0.05, s_out=0.125))
    got = TA.dispatch(_t(q), _t(k), _t(v), spec=TA.AttentionSpec(**spec),
                      scales=TA.QuantScales.per_tensor(0.05, s_out=0.125))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# --------------------------------------------------------------------------
# KVCacheState
# --------------------------------------------------------------------------

def _assert_same_state(js, ts, s_new=1):
    for field in ("k", "v", "pos"):
        assert np.array_equal(np.asarray(getattr(js, field)),
                              getattr(ts, field).numpy()), field
    assert np.array_equal(np.asarray(js.valid_len()), ts.valid_len().numpy())
    assert np.array_equal(np.asarray(js.q_offset(s_new)),
                          ts.q_offset(s_new).numpy())


@pytest.mark.parametrize("capacity,prompt,lengths,bursts", [
    (24, 10, None, [1, 1, 3, 8, 1, 1, 1]),          # fill, then wrap
    (16, 40, None, [1, 2, 1]),                       # prefill rolls (S >= C)
    (200, 130, [130, 77], [1, 5, 1]),                # aligned to 256, ragged
    (8, 8, [8, 3], [1, 9, 1]),                       # burst longer than ring
])
def test_kv_cache_state_writes_match_jax(capacity, prompt, lengths, bursts):
    rng = np.random.default_rng(capacity + prompt)
    b, g, d = 2, 2, 16
    js = JA.KVCacheState.init(b, capacity, g, d)
    ts = TA.KVCacheState.init(b, capacity, g, d, device="cpu")
    assert ts.capacity == js.capacity
    k, v = _i8(rng, b, prompt, g, d), _i8(rng, b, prompt, g, d)
    lj = None if lengths is None else jnp.asarray(lengths, jnp.int32)
    lt = None if lengths is None else torch.tensor(lengths)
    js = js.prefill_write(jnp.asarray(k), jnp.asarray(v), lengths=lj)
    ts = ts.prefill_write(_t(k), _t(v), lengths=lt)
    _assert_same_state(js, ts)
    for n in bursts:
        k, v = _i8(rng, b, n, g, d), _i8(rng, b, n, g, d)
        js = js.decode_append(jnp.asarray(k), jnp.asarray(v))
        ts = ts.decode_append(_t(k), _t(v))
        _assert_same_state(js, ts, n)


def test_decode_append_live_is_refused():
    """``decode_append(live=)`` refuses the writes of dead rows: their
    ring bytes and ``pos`` stay as they were, as in the JAX package,
    while live rows append."""
    rng = np.random.default_rng(9)
    js = JA.KVCacheState.init(2, 8, 1, 16)
    ts = TA.KVCacheState.init(2, 8, 1, 16, device="cpu")
    for live in ([True, False], [False, True], [True, True]):
        k, v = _i8(rng, 2, 1, 1, 16), _i8(rng, 2, 1, 1, 16)
        before = ts.k.clone()
        js = js.decode_append(jnp.asarray(k), jnp.asarray(v),
                              live=jnp.asarray(live))
        ts = ts.decode_append(_t(k), _t(v), live=torch.tensor(live))
        _assert_same_state(js, ts)
        for row, alive in enumerate(live):
            if not alive:
                assert torch.equal(ts.k[row], before[row])


# --------------------------------------------------------------------------
# Backend verdicts
# --------------------------------------------------------------------------

def _spec_grid():
    axes = dict(
        mode=("train", "prefill", "decode"), impl=("float", "ita", "ibert"),
        window=(0, 16), softcap=(0.0, 30.0), query_scale=(0.0, 0.125),
        softmax=("adaptive", "paper"),
        layout=("bshd", "bhsd", "bhsd_bsgd", "bhsd_paged"),
        scale_kind=("per_tensor", "per_head"), out_dtype=("float", "int8"),
        has_s_out=(True, False), q_len=(None, 1, 8, 9),
        ragged_q=(False, True))
    names = list(axes)
    for values in itertools.product(*axes.values()):
        yield dict(zip(names, values, strict=True))


def test_backend_verdicts_match_jax():
    """Every ported backend gives the JAX package's verdict — True or the
    same reason — on every valid spec of the grid, and both packages
    refuse the same invalid ones."""
    n = 0
    for kw in _spec_grid():
        try:
            jspec = JA.AttentionSpec(**kw)
        except ValueError:
            with pytest.raises(ValueError):
                TA.AttentionSpec(**kw)
            continue
        want = JA.backend_reasons(jspec)
        got = TA.backend_reasons(TA.AttentionSpec(**kw))
        assert list(got) == list(want) == list(PORTED)
        assert want == got, kw
        n += 1
    assert n > 1000
