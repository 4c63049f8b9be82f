"""Symmetric int8 quantization and integer requantization
(``repro.core.quant``): the constants, per-tensor and per-channel
quantization, ITA's ReQuant, the fixed-point requant oracle, QAT
fake-quantization with a straight-through estimator, and the paper's
quantized linear layer (int8 x int8 -> int32, then requant).

Scale convention: ``x_real ~= scale * x_q`` with ``x_q`` int8 in
[-128, 127]. ITA's softmax input uses the *maximum meaningful scale*
``EPS_MAX = B / (2**B * log2(e))`` (paper eq. 3), so the softmax exponent
becomes a pure right shift by ``SOFTMAX_SHIFT`` bits.

``EPS_MAX`` stays a float64 numpy scalar, as in the JAX package: the
requant multipliers round the float64 products that contain it to
float32 exactly once, and the port must round at the same place.

Every scalar that meets a tensor in a multiply or divide enters as a
float32 tensor: torch divides by a Python scalar through a reciprocal
multiply on the card, which can differ from the true quotient in the
last bit.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

B_BITS = 8
INT8_MIN = -(2 ** (B_BITS - 1))          # -128
INT8_MAX = 2 ** (B_BITS - 1) - 1         # 127
ACC_BITS = 24                            # ITA's D (dot-product accumulator)

# eps = B / (2**B * log2 e); eps' = log2(e) * eps = B / 2**B = 2**-5.
EPS_MAX = B_BITS / (2.0 ** B_BITS * np.log2(np.e))
EPS_PRIME = B_BITS / 2.0 ** B_BITS       # = 1/32; exponent shift = 5 bits
SOFTMAX_SHIFT = B_BITS - int(np.log2(B_BITS))  # = 5


def _f32(x, device) -> torch.Tensor:
    """``x`` as a float32 tensor on ``device`` (a Python or numpy float is
    rounded to float32 once, as JAX rounds a weakly typed scalar)."""
    return torch.as_tensor(x, dtype=torch.float32, device=device)


class QTensor(NamedTuple):
    """An int8 tensor plus its float32 dequantization scale (a scalar for
    per-tensor quantization, broadcastable to the quantized axis for
    per-channel quantization)."""

    values: torch.Tensor   # int8
    scale: torch.Tensor    # f32, x_real ~= scale * values

    def dequantize(self) -> torch.Tensor:
        return self.values.float() * self.scale


_HALF = (torch.bfloat16, torch.float16)


def _work_dtype(x: torch.Tensor, scale=None) -> torch.dtype:
    """The dtype JAX computes ``max|x|/127`` and ``x / scale`` in: a bf16
    or f16 ``x`` keeps its dtype against a Python number or a scale of
    its own dtype; anything else is float32."""
    dt = x.dtype if x.dtype in _HALF else torch.float32
    if scale is None or type(scale) in (int, float):
        return dt
    return dt if torch.is_tensor(scale) and scale.dtype == dt \
        else torch.float32


def compute_scale(x: torch.Tensor, axis=None,
                  keepdims: bool = False) -> torch.Tensor:
    """Symmetric calibration scale: max(|x|)/127 (never zero), in x's
    dtype when x is bf16 or f16 (as the JAX package computes it), else in
    float32."""
    dt = _work_dtype(x)
    a = x.to(dt).abs()
    amax = a.amax() if axis is None else a.amax(dim=axis, keepdim=keepdims)
    if axis is None and keepdims:
        amax = amax.reshape((1,) * x.ndim)
    floor = torch.tensor(1e-8, dtype=dt, device=x.device)
    return torch.maximum(amax, floor) / torch.tensor(INT8_MAX, dtype=dt,
                                                     device=x.device)


def quantize(x: torch.Tensor, scale) -> torch.Tensor:
    """Real -> int8: divide by the scale, round half to even
    (``torch.round``, like ``jnp.round``), saturate. The quotient is taken
    in the dtype JAX would use (``_work_dtype``: bf16 for a bf16 x and
    its bf16 scale) and the scale enters as a tensor (torch divides by a
    Python scalar as a reciprocal multiply on the card)."""
    dt = _work_dtype(x, scale)
    s = torch.as_tensor(scale, device=x.device).to(dt) \
        if torch.is_tensor(scale) else torch.as_tensor(scale, dtype=dt,
                                                       device=x.device)
    q = torch.round(x.to(dt) / s)
    return torch.clamp(q, INT8_MIN, INT8_MAX).to(torch.int8)


def quantize_tensor(x: torch.Tensor, axis=None) -> QTensor:
    """Per-tensor (``axis=None``) or per-channel quantization; a
    per-channel scale keeps the reduced axes as size 1. A (K, N) weight
    quantized per output channel (``axis=0``) is stored K-major, as the
    (K, N) view of an (N, K) buffer (``w.t().contiguous().t()``, the same
    values): the layout the int8 GEMM kernels read, made here once rather
    than on every call."""
    scale = compute_scale(x, axis=axis, keepdims=axis is not None)
    q = quantize(x, scale)
    if x.ndim == 2 and axis in (0, -2):
        q = q.t().contiguous().t()
    return QTensor(q, scale.float())


def dequantize(q: torch.Tensor, scale) -> torch.Tensor:
    return q.float() * scale


def requantize(acc: torch.Tensor, scale_ratio, out_min: int = INT8_MIN,
               out_max: int = INT8_MAX,
               out_dtype=torch.int8) -> torch.Tensor:
    """ITA ReQuant: int32 accumulator -> int8 at a new scale.

    ``scale_ratio = s_in / s_out`` (for a matmul: ``s_x * s_w / s_y``),
    rounded to float32 once. The accumulator is converted to float32
    (round half to even above 2^24), multiplied, rounded half to even
    and saturated."""
    y = torch.round(acc.float() * _f32(scale_ratio, acc.device))
    return torch.clamp(y, out_min, out_max).to(out_dtype)


# ---------------------------------------------------------------------------
# ASIC-style fixed-point requant oracle (numpy, int64)
# ---------------------------------------------------------------------------

def quantize_multiplier(scale_ratio: float) -> tuple[int, int]:
    """Decompose ``scale_ratio`` as ``M * 2**-shift`` with M in [2^30, 2^31)."""
    if scale_ratio <= 0:
        raise ValueError("scale_ratio must be positive")
    mant, exp = np.frexp(scale_ratio)           # mant in [0.5, 1)
    m = int(np.round(mant * (1 << 31)))
    if m == (1 << 31):
        m //= 2
        exp += 1
    return m, 31 - exp                           # right-shift amount


def requantize_fixedpoint_np(acc: np.ndarray, scale_ratio: float) -> np.ndarray:
    """Bit-accurate ASIC requant: (acc * M + rnd) >> shift, saturated.
    ``quantize_multiplier`` returns the *total* right shift (31 - exp)."""
    m, shift = quantize_multiplier(scale_ratio)
    if shift <= 0:
        raise ValueError(f"scale_ratio {scale_ratio} needs a left shift "
                         f"({m}, {shift})")
    prod = acc.astype(np.int64) * np.int64(m)
    rnd = np.int64(1) << np.int64(shift - 1)
    y = (prod + rnd) >> np.int64(shift)
    return np.clip(y, INT8_MIN, INT8_MAX).astype(np.int8)


# ---------------------------------------------------------------------------
# QAT fake quantization (straight-through estimator)
# ---------------------------------------------------------------------------

class FakeQuant(torch.autograd.Function):
    """Quantize-dequantize; the backward passes the gradient inside the
    clipping range and zeroes it outside (the deployed saturation). The
    scale's gradient is zero: scales are calibration-updated."""

    @staticmethod
    def forward(ctx, x, scale):
        q = torch.clamp(torch.round(x / scale), INT8_MIN, INT8_MAX)
        ctx.save_for_backward((x >= scale * INT8_MIN)
                              & (x <= scale * INT8_MAX))
        ctx.scale_shape = scale.shape
        return q * scale

    @staticmethod
    def backward(ctx, g):
        (in_range,) = ctx.saved_tensors
        return (torch.where(in_range, g, torch.zeros_like(g)),
                g.new_zeros(ctx.scale_shape))


def fake_quant(x: torch.Tensor, scale) -> torch.Tensor:
    """Quantize-dequantize ``x`` at ``scale`` with the STE backward."""
    return FakeQuant.apply(x, _f32(scale, x.device))


def update_running_amax(running: torch.Tensor, x: torch.Tensor,
                        momentum: float = 0.99) -> torch.Tensor:
    """EMA absolute-max tracker used for QAT calibration of ReQuant clips."""
    return momentum * running + (1.0 - momentum) * x.abs().amax()


# ---------------------------------------------------------------------------
# The quantized linear layer
# ---------------------------------------------------------------------------

def int8_matmul_ref(x_q: torch.Tensor, w_q: torch.Tensor,
                    bias_q: torch.Tensor | None = None) -> torch.Tensor:
    """int8 (..., K) x int8 (K, N) -> exact int32 (..., N) (the PE-array
    contract), plus ``bias_q`` in accumulator units if given.

    CUDA has no integer matmul in torch, and a float32 product is exact
    only while every partial sum stays below 2^24 (K ~ 1024 at full-range
    operands). The product is taken in float64, exact below 2^53: every
    term and partial sum is an integer below 2^31 for K < 2^17."""
    acc = torch.matmul(x_q.double(), w_q.double()).to(torch.int32)
    if bias_q is not None:
        acc = acc + bias_q.to(torch.int32)
    return acc


def quantized_linear(x: torch.Tensor, w_q: QTensor,
                     bias: torch.Tensor | None = None,
                     out_scale: torch.Tensor | None = None):
    """Full quantized linear layer: quantize the activation per tensor ->
    int8 matmul -> requant. Returns ``(QTensor out, int32 acc)``; if
    ``out_scale`` is None the output scale is calibrated from the
    accumulator (post-training quantization mode)."""
    xq = quantize_tensor(x)
    acc = int8_matmul_ref(xq.values, w_q.values)
    acc_scale = xq.scale * w_q.scale
    if bias is not None:
        acc = acc + torch.round(bias.float() / acc_scale).to(torch.int32)
    if out_scale is None:
        out_scale = compute_scale(acc.float() * acc_scale)
    else:
        out_scale = _f32(out_scale, x.device)
    out = requantize(acc, acc_scale / out_scale)
    return QTensor(out, out_scale), acc
