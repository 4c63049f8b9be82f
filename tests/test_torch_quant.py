"""The port's ``core/quant.py`` against ``repro.core.quant``, on the CPU.

Inputs are made with numpy from a seed and go through both packages;
every result must be equal bit for bit (``assert_array_equal``): scales
in float32, int8 values, int32 accumulators, the STE gradient.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as JQ
from repro_torch.core import quant as TQ


def _same(want, got):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


def test_constants_match():
    for name in ("B_BITS", "INT8_MIN", "INT8_MAX", "ACC_BITS", "EPS_MAX",
                 "EPS_PRIME", "SOFTMAX_SHIFT"):
        assert getattr(TQ, name) == getattr(JQ, name), name


@pytest.mark.parametrize("axis", [None, 0, 1, (0, 2)])
@pytest.mark.parametrize("spread", [0.05, 1.0, 30.0])
def test_quantize_tensor_matches_jax(axis, spread):
    """``QTensor``, ``compute_scale`` and ``quantize_tensor`` per tensor
    and per axis: the scale, the int8 values and the dequantized tensor."""
    rng = np.random.default_rng(int(spread * 100))
    x = rng.normal(0, spread, (6, 10, 4)).astype(np.float32)
    x[0, 0, 0] = 0.0
    jq = JQ.quantize_tensor(jnp.asarray(x), axis=axis)
    tq = TQ.quantize_tensor(torch.from_numpy(x), axis=axis)
    assert isinstance(tq, TQ.QTensor)
    _same(jq.values, tq.values)
    _same(jq.scale, tq.scale)
    _same(jq.dequantize(), tq.dequantize())
    for keepdims in (False, True):
        _same(JQ.compute_scale(jnp.asarray(x), axis=axis, keepdims=keepdims),
              TQ.compute_scale(torch.from_numpy(x), axis=axis,
                               keepdims=keepdims))


def test_compute_scale_never_zero():
    z = np.zeros((3, 5), np.float32)
    _same(JQ.compute_scale(jnp.asarray(z), axis=0),
          TQ.compute_scale(torch.from_numpy(z), axis=0))
    assert (TQ.compute_scale(torch.from_numpy(z)) > 0).all()


@pytest.mark.parametrize("ratio", [0.00037, 0.0121, 0.49, 0.97,
                                   np.float32(1.3e-6)])
def test_requantize_matches_jax(ratio):
    """Accumulators beyond 2^24 included, where the float32 conversion
    rounds half to even; also a custom output range and dtype."""
    rng = np.random.default_rng(1)
    acc = np.concatenate([
        rng.integers(-2 ** 23, 2 ** 23, 4096),
        rng.integers(-2 ** 28, 2 ** 28, 4096),
        [2 ** 24 + 1, 2 ** 24 + 3, -(2 ** 25 + 5), 0, 1, -1]]).astype(np.int32)
    _same(JQ.requantize(jnp.asarray(acc), ratio),
          TQ.requantize(torch.from_numpy(acc), ratio))
    _same(JQ.requantize(jnp.asarray(acc), ratio, 0, 255, jnp.int32),
          TQ.requantize(torch.from_numpy(acc), ratio, 0, 255, torch.int32))


def test_requant_matches_fixed_point_oracle():
    """``tests/test_quant.py::test_requant_matches_fixed_point_oracle``
    against the port: the port's fixed-point oracle equals the JAX
    package's bit for bit, and the float32 requant is within 1 LSB."""
    rng = np.random.default_rng(1)
    acc = rng.integers(-2 ** 23, 2 ** 23, (4096,), dtype=np.int32)
    for ratio in (0.00037, 0.0121, 0.49, 0.97):
        assert TQ.quantize_multiplier(ratio) == JQ.quantize_multiplier(ratio)
        b = TQ.requantize_fixedpoint_np(acc, ratio)
        _same(JQ.requantize_fixedpoint_np(acc, ratio), b)
        a = TQ.requantize(torch.from_numpy(acc), ratio).numpy()
        diff = np.abs(a.astype(np.int32) - b.astype(np.int32))
        assert diff.max() <= 1 and (diff != 0).mean() < 0.02


def test_quantize_multiplier_decomposition():
    for r in (1e-4, 0.3, 0.999, 1.7, 0.5, 2.0 ** -31):
        m, shift = TQ.quantize_multiplier(r)
        assert (m, shift) == JQ.quantize_multiplier(r)
        assert 2 ** 30 <= m < 2 ** 31
        np.testing.assert_allclose(m * 2.0 ** -shift, r, rtol=1e-8)
    with pytest.raises(ValueError, match="positive"):
        TQ.quantize_multiplier(0.0)


def test_fake_quant_forward_and_ste_gradient_match_jax():
    """``tests/test_quant.py::test_fake_quant_ste`` against the port, and
    on random inputs: the forward values, the straight-through gradient
    (1 inside the clipping range, 0 outside) and the zero scale gradient,
    each equal to ``jax.grad``'s."""
    rng = np.random.default_rng(2)
    fixed = np.asarray([-10.0, -0.2, 0.0, 0.3, 10.0], np.float32)
    for x, scale in ((fixed, np.float32(0.05)),
                     (rng.normal(0, 4, 64).astype(np.float32),
                      np.float32(0.031))):
        jx, js = jnp.asarray(x), jnp.asarray(scale)
        tx = torch.from_numpy(x).requires_grad_()
        ts = torch.tensor(scale, requires_grad=True)
        ty = TQ.fake_quant(tx, ts)
        _same(JQ.fake_quant(jx, js), ty)
        gx, gs = jax.grad(lambda v, s: (JQ.fake_quant(v, s) * 1.5).sum(),
                          argnums=(0, 1))(jx, js)
        (ty * 1.5).sum().backward()
        _same(gx, tx.grad)
        _same(gs, ts.grad)
    np.testing.assert_allclose(
        TQ.fake_quant(torch.from_numpy(fixed), 0.05).numpy(),
        [-6.4, -0.2, 0.0, 0.3, 6.35], atol=1e-6)


def test_update_running_amax_matches_jax():
    rng = np.random.default_rng(3)
    running = np.float32(1.7)
    for _ in range(5):
        x = rng.normal(0, 3, (8, 16)).astype(np.float32)
        want = JQ.update_running_amax(jnp.asarray(running), jnp.asarray(x))
        got = TQ.update_running_amax(torch.tensor(running), torch.from_numpy(x))
        _same(want, got)
        running = np.asarray(want)
    _same(JQ.update_running_amax(jnp.asarray(running), jnp.asarray(x),
                                 momentum=0.9),
          TQ.update_running_amax(torch.tensor(running), torch.from_numpy(x),
                                 momentum=0.9))


@pytest.mark.parametrize("lead", [(8,), (2, 3)])
def test_int8_matmul_ref_bias_semantics(lead):
    """``tests/test_quant.py::test_int8_matmul_ref_bias_semantics`` against
    the port: the int32 product, with and without a bias, leading dims
    kept."""
    rng = np.random.default_rng(2)
    x = rng.integers(-128, 128, (*lead, 16), dtype=np.int8)
    w = rng.integers(-128, 128, (16, 4), dtype=np.int8)
    b = rng.integers(-100, 100, (4,), dtype=np.int32)
    for bias in (None, b):
        want = JQ.int8_matmul_ref(jnp.asarray(x), jnp.asarray(w),
                                  None if bias is None else jnp.asarray(bias))
        got = TQ.int8_matmul_ref(torch.from_numpy(x), torch.from_numpy(w),
                                 None if bias is None
                                 else torch.from_numpy(bias))
        _same(want, got)
    np.testing.assert_array_equal(
        got.numpy(), x.astype(np.int32) @ w.astype(np.int32) + b)


@pytest.mark.parametrize("per_channel", [False, True])
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("out_scale", [None, 0.04])
def test_quantized_linear_matches_jax(per_channel, with_bias, out_scale):
    """``tests/test_quant.py::test_quantized_linear_end_to_end`` against
    the port: the int8 values, the output scale and the int32 accumulator
    equal JAX's, and the layer tracks the float product."""
    rng = np.random.default_rng(3 + 2 * per_channel + with_bias)
    x = rng.normal(0, 1, (32, 64)).astype(np.float32)
    w = rng.normal(0, 0.05, (64, 32)).astype(np.float32)
    bias = rng.normal(0, 0.3, 32).astype(np.float32) if with_bias else None
    axis = 0 if per_channel else None
    jw = JQ.quantize_tensor(jnp.asarray(w), axis=axis)
    tw = TQ.quantize_tensor(torch.from_numpy(w), axis=axis)
    jout, jacc = JQ.quantized_linear(
        jnp.asarray(x), jw, None if bias is None else jnp.asarray(bias),
        None if out_scale is None else jnp.float32(out_scale))
    tout, tacc = TQ.quantized_linear(
        torch.from_numpy(x), tw, None if bias is None
        else torch.from_numpy(bias),
        None if out_scale is None else torch.tensor(out_scale))
    _same(jout.values, tout.values)
    _same(jout.scale, tout.scale)
    _same(jacc, tacc)
    y_ref = x @ w + (0 if bias is None else bias)
    rel = np.abs(tout.dequantize().numpy() - y_ref).mean() \
        / (np.abs(y_ref).mean() + 1e-9)
    assert rel < (0.05 if out_scale is None else 0.2)


def _bf16_pair(x):
    """``x`` rounded to bf16 once, as a JAX array and a torch tensor with
    the same bits."""
    jx = jnp.asarray(x, dtype=jnp.bfloat16)
    bits = np.asarray(jax.lax.bitcast_convert_type(jx, jnp.uint16))
    tx = torch.from_numpy(bits.astype(np.int16)).view(torch.bfloat16)
    return jx, tx


BF16_INPUTS = {
    # the failing input of the port's bf16 quantization fault: JAX's
    # scale 0.091796875, first differing value at (0, 4)
    "normal3-64x96": lambda: np.random.default_rng(0)
    .standard_normal((64, 96)) * 3,
    "wide-6x10x4": lambda: np.random.default_rng(11)
    .normal(0, 30.0, (6, 10, 4)),
    "small-7x33": lambda: np.random.default_rng(12)
    .normal(0, 0.05, (7, 33)),
}


@pytest.mark.parametrize("axis", [None, 0, 1])
@pytest.mark.parametrize("name", sorted(BF16_INPUTS))
def test_quantize_tensor_bf16_matches_jax(name, axis):
    """A bf16 input is quantized as JAX quantizes it: ``max|x|/127`` and
    ``x / scale`` in bf16, then round half to even and clip. The float32
    scales and the int8 values are equal bit for bit, per tensor and per
    axis; so are ``compute_scale`` (in bf16) and ``quantize`` with a
    bf16 scale and with a Python-float scale."""
    jx, tx = _bf16_pair(BF16_INPUTS[name]())
    jq = JQ.quantize_tensor(jx, axis=axis)
    tq = TQ.quantize_tensor(tx, axis=axis)
    _same(jq.values, tq.values)
    _same(jq.scale, tq.scale)
    js = JQ.compute_scale(jx, axis=axis, keepdims=axis is not None)
    ts = TQ.compute_scale(tx, axis=axis, keepdims=axis is not None)
    assert ts.dtype == torch.bfloat16
    _same(np.asarray(js.astype(jnp.float32)), ts.float())
    _same(JQ.quantize(jx, js), TQ.quantize(tx, ts))
    _same(JQ.quantize(jx, 0.0173), TQ.quantize(tx, 0.0173))
    _same(JQ.quantize(jx, jnp.float32(0.0173)),
          TQ.quantize(tx, torch.tensor(0.0173)))


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("per_channel", [False, True])
def test_quantized_linear_bf16_matches_jax(per_channel, with_bias):
    """``quantized_linear`` on a bf16 activation (the failing input of the
    bf16 quantization fault) with a float32 weight: the int8 values, the
    output scale and the int32 accumulator equal JAX's."""
    jx, tx = _bf16_pair(BF16_INPUTS["normal3-64x96"]())
    rng = np.random.default_rng(1)
    w = rng.normal(0, 0.05, (96, 32)).astype(np.float32)
    bias = rng.normal(0, 0.3, 32).astype(np.float32) if with_bias else None
    axis = 0 if per_channel else None
    jw = JQ.quantize_tensor(jnp.asarray(w), axis=axis)
    tw = TQ.quantize_tensor(torch.from_numpy(w), axis=axis)
    jout, jacc = JQ.quantized_linear(
        jx, jw, None if bias is None else jnp.asarray(bias))
    tout, tacc = TQ.quantized_linear(
        tx, tw, None if bias is None else torch.from_numpy(bias))
    _same(jout.values, tout.values)
    _same(jout.scale, tout.scale)
    _same(jacc, tacc)
