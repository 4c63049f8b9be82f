"""ITA integer softmax (``repro.core.softmax``, the ITA family).

With the maximum meaningful quantization scale ``eps = B/(2**B * log2
e)`` (B = 8) the softmax exponent in base 2 is a pure right shift: each
denominator term is ``256 >> k`` with ``k = (max - x_q) >> 5``, and
normalization is a shift of the inverted denominator, ``p_i = sigma_inv
>> k_i`` (paper eq. 5). Three phases:

- **DA** (denominator accumulation): running row max and sum; a late max
  update corrects the accumulated sum with ``sigma >>= (delta_max >> 5)``.
- **DI** (denominator inversion): once per row, ``sigma_inv = 2^16 //
  sigma`` (paper) or ``2^(e_r+8) // sigma`` with a per-row power-of-two
  output scale ``2^-e_r`` (adaptive).
- **EN** (element normalization): pure shifts.

Baselines, as in the JAX module: ``softmax_float`` (the float oracle),
I-BERT's integer softmax (the paper's accuracy baseline; integers held in
float32 as the reference implementation holds them, and an exact int64
copy for MAE tables), Softermax (base-2 fixed point) and the QAT forward
``ita_softmax_ste`` with straight-through floors. Their host constants
(I-BERT's ``x0``, ``b``, ``c``, the scales) are computed from the same
Python floats as the JAX module's, in float64, and every division by a
non-power-of-two constant divides by a tensor: torch divides by a Python
scalar as a multiply by its reciprocal on the card.

Integer hazards, as in ``kernels/common.py``: JAX shifts with
``shift_right_logical``, torch ``>>`` on int32 is arithmetic; every shift
here takes a non-negative operand. ``_k_of`` clamps ``max - x`` at 0,
which changes only masked lanes (where ``x`` may exceed the max of the
valid ones), and every caller replaces those lanes' shift by
``_MASK_K``. torch has no count-leading-zeros: ``floor_log2`` takes
``floor(log2 x)`` from the exact float64 exponent of ``x``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.quant import B_BITS, EPS_MAX, SOFTMAX_SHIFT

# 2**8 — the unit in which denominator terms are accumulated.
_UNIT = 1 << B_BITS
# Paper's denominator-inversion width: sigma_inv = 2**16 // sigma.
_W_INV = 2 * B_BITS
# Shift amount for masked-out elements: forces the term/probability to 0.
_MASK_K = 31
# Sentinel below any int8 value; (max - sentinel) cannot overflow int32.
_NEG_SENTINEL = -(2 ** B_BITS)


def floor_log2(x: torch.Tensor) -> torch.Tensor:
    """Exact ``floor(log2 x)`` of a positive int32 tensor (``31 - clz``):
    the binary exponent of ``x`` in float64, which holds every int32
    exactly (``x = m·2^e`` with ``m`` in [0.5, 1), so ``floor(log2 x) =
    e - 1``). One monotone op, as ``clz`` is for the reference's range
    verifier (``analysis/ranges.py``)."""
    _, e = torch.frexp(x.to(torch.float64))
    return (e - 1).to(x.dtype)


def pow2_neg(n: torch.Tensor) -> torch.Tensor:
    """Exact float32 ``2^-n`` of an integer-valued tensor with ``-127 < n
    <= 126``, built from its exponent bits (never an approximate
    ``exp2``: XLA:CPU's is approximate beyond 2^12, and the JAX reference
    runs with an exact one in the tests)."""
    return ((127 - n.to(torch.int32)) << 23).view(torch.float32)


def _floor_div(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.div(a, b, rounding_mode="floor")


def _k_of(x_q: torch.Tensor, row_max: torch.Tensor) -> torch.Tensor:
    """Exponent shift k = (max - x) >> 5 (top 3 bits of the 8-bit diff)."""
    diff = row_max.to(torch.int32) - x_q.to(torch.int32)
    return diff.clamp(min=0) >> SOFTMAX_SHIFT


def _apply_mask_k(k: torch.Tensor, mask) -> torch.Tensor:
    if mask is None:
        return k
    return torch.where(mask, k, _MASK_K)


def _masked_max(x_q: torch.Tensor, mask, axis: int) -> torch.Tensor:
    x = x_q.to(torch.int32)
    if mask is not None:
        x = torch.where(mask, x, _NEG_SENTINEL)
    return x.amax(dim=axis, keepdim=True)


def _shift_terms(value, k: torch.Tensor) -> torch.Tensor:
    """``value >> min(k, 31)`` with ``value`` a non-negative int or int32
    tensor broadcast against ``k``."""
    if not torch.is_tensor(value):
        value = torch.full_like(k, value)
    return value >> torch.clamp(k, max=31)


def ita_softmax_int(x_q: torch.Tensor, mask=None, axis: int = -1):
    """One-shot ITA softmax. Returns ``(p, sigma, row_max)`` where ``p`` is
    the int32 probability in units of 2^-8 (``p/256 ~= softmax``)."""
    row_max = _masked_max(x_q, mask, axis)
    k = _apply_mask_k(_k_of(x_q, row_max), mask)
    terms = _shift_terms(_UNIT, k)
    sigma = terms.sum(dim=axis, keepdim=True, dtype=torch.int32)   # DA
    sigma = torch.clamp(sigma, min=1)
    sigma_inv = _floor_div(torch.full_like(sigma, 1 << _W_INV), sigma)  # DI
    p = _shift_terms(sigma_inv, k)                                   # EN
    # identity on every reachable value (the JAX module states it for its
    # range verifier)
    p = torch.clamp(p, max=_UNIT)
    return p, sigma, row_max


def ita_softmax(x_q: torch.Tensor, mask=None, axis: int = -1) -> torch.Tensor:
    """ITA softmax as float probabilities (p * 2^-8)."""
    p, _, _ = ita_softmax_int(x_q, mask=mask, axis=axis)
    return p.float() * (2.0 ** -B_BITS)


# ---------------------------------------------------------------------------
# Streaming (DA across row parts) — the paper's multi-part update
# ---------------------------------------------------------------------------

def ita_da_update(carry_max: torch.Tensor, carry_sigma: torch.Tensor,
                  part_q: torch.Tensor, part_mask=None, axis: int = -1):
    """One DA step: fold a new row part into (running max, running sigma).
    When the max grows, the already accumulated sigma is corrected with
    one shift ``(delta_max >> 5)``, as in silicon."""
    part_max = _masked_max(part_q, part_mask, axis)
    new_max = torch.maximum(carry_max, part_max)
    delta = (new_max - carry_max).to(torch.int32) >> SOFTMAX_SHIFT
    corrected = _shift_terms(carry_sigma, delta)
    k = _apply_mask_k(_k_of(part_q, new_max), part_mask)
    terms = _shift_terms(_UNIT, k)
    part_sigma = terms.sum(dim=axis, keepdim=True, dtype=torch.int32)
    return new_max, corrected + part_sigma


def streaming_stats(x_q, num_parts, mask, saturate=None):
    """DA over ``num_parts`` equal parts of the last axis: ``(run_max,
    sigma)`` with sigma clamped to >= 1 for the DI; ``saturate`` clips the
    running sigma after every part (the 15-bit silicon mode)."""
    *lead, n = x_q.shape
    part = n // num_parts
    run_max = torch.full((*lead, 1), _NEG_SENTINEL, dtype=torch.int32,
                         device=x_q.device)
    run_sigma = torch.zeros((*lead, 1), dtype=torch.int32, device=x_q.device)
    for i in range(num_parts):
        sl = slice(i * part, (i + 1) * part)
        m = None if mask is None else mask[..., sl]
        run_max, run_sigma = ita_da_update(run_max, run_sigma, x_q[..., sl],
                                           m)
        if saturate is not None:
            run_sigma = torch.clamp(run_sigma, max=saturate)
    return run_max, torch.clamp(run_sigma, min=1)


def ita_softmax_streaming(x_q: torch.Tensor, num_parts: int,
                          mask=None) -> torch.Tensor:
    """Full DA -> DI -> EN over ``num_parts`` chunks of the last axis."""
    if x_q.shape[-1] % num_parts:
        raise ValueError(f"{x_q.shape[-1]} columns in {num_parts} parts")
    run_max, sigma = streaming_stats(x_q, num_parts, mask)
    sigma_inv = _floor_div(torch.full_like(sigma, 1 << _W_INV), sigma)  # DI
    k = _apply_mask_k(_k_of(x_q, run_max), mask)                     # EN
    p = _shift_terms(sigma_inv, k)
    return p.float() * (2.0 ** -B_BITS)


# ---------------------------------------------------------------------------
# Bit-exact silicon mode (15-bit sigma, 16-bit sigma_inv)
# ---------------------------------------------------------------------------

def ita_softmax_bitexact(x_q: torch.Tensor, num_parts: int = 1,
                         mask=None) -> torch.Tensor:
    """Paper-silicon semantics: sigma saturates at 2^15-1 after every
    part, sigma_inv at 2^16-1."""
    run_max, sigma = streaming_stats(x_q, num_parts, mask,
                                     saturate=(1 << 15) - 1)
    sigma_inv = torch.clamp(
        _floor_div(torch.full_like(sigma, 1 << _W_INV), sigma),
        max=(1 << 16) - 1)
    k = _apply_mask_k(_k_of(x_q, run_max), mask)
    p = _shift_terms(sigma_inv, k)
    return p.float() * (2.0 ** -B_BITS)


# ---------------------------------------------------------------------------
# Beyond-paper: adaptive per-row power-of-two scale (still shift-only)
# ---------------------------------------------------------------------------

def adaptive_sigma_inv(sigma: torch.Tensor):
    """``(sigma_inv, e_r)``: ``e_r = floor(log2 sigma)`` and ``sigma_inv =
    2^(e_r+8) // sigma`` in (128, 256], without 64-bit: sigma is pre-
    shifted so the dividend fits. ``sigma`` >= 1."""
    e_r = floor_log2(sigma)
    pre = torch.clamp(e_r + B_BITS - 30, min=0)
    num = torch.ones_like(sigma) << torch.clamp(e_r + B_BITS - pre, max=30)
    sigma_inv = _floor_div(num, sigma >> pre)
    return torch.clamp(sigma_inv, max=_UNIT), e_r


def ita_softmax_adaptive_int(x_q: torch.Tensor, mask=None, axis: int = -1):
    """ITA softmax with a per-row power-of-two output scale: ``softmax ~=
    p * 2^-e_r``. Returns ``(p, e_r, row_max)``."""
    row_max = _masked_max(x_q, mask, axis)
    k = _apply_mask_k(_k_of(x_q, row_max), mask)
    terms = _shift_terms(_UNIT, k)
    sigma = torch.clamp(terms.sum(dim=axis, keepdim=True, dtype=torch.int32),
                        min=1)
    sigma_inv, e_r = adaptive_sigma_inv(sigma)
    p = _shift_terms(sigma_inv, k)
    return p, e_r, row_max


def ita_softmax_adaptive(x_q: torch.Tensor, mask=None,
                         axis: int = -1) -> torch.Tensor:
    p, e_r, _ = ita_softmax_adaptive_int(x_q, mask=mask, axis=axis)
    return p.float() * pow2_neg(e_r)


# ---------------------------------------------------------------------------
# Baselines
# ---------------------------------------------------------------------------

def _f32(value, like: torch.Tensor) -> torch.Tensor:
    """A float32 0-d tensor on ``like``'s device, filled there."""
    return torch.full((), value, dtype=torch.float32, device=like.device)


def softmax_float(x_q: torch.Tensor, eps: float = EPS_MAX, mask=None,
                  axis: int = -1) -> torch.Tensor:
    """Float oracle: softmax of the dequantized inputs."""
    x = x_q.float() * _f32(eps, x_q)
    if mask is not None:
        x = torch.where(mask, x, -torch.inf)
    return torch.softmax(x, dim=axis)


# I-BERT (Kim et al., ICML'21) integer softmax — the paper's accuracy
# baseline (MAE 0.35% vs ITA's 0.46%). Integer values in float tensors,
# as in the reference implementation.
_IBERT_COEF = (0.35815147, 0.96963238, 1.0)   # a(x+b)^2 + c, normalized
_IBERT_N = 30
_IBERT_X0 = -0.6931471805599453               # -ln 2


def ibert_constants(eps: float = EPS_MAX) -> tuple[float, float, float]:
    """``(x0_int, b_int, c_int)`` of I-BERT's exp for scale ``eps``,
    floored in float64 on the host exactly as the JAX module does (-32,
    124 and 5950 at ``EPS_MAX``; ``x0_int`` sits on an integer, so a
    differently rounded quotient would floor to -33)."""
    return (float(np.floor(_IBERT_X0 / eps)),
            float(np.floor(_IBERT_COEF[1] / _IBERT_COEF[0] / eps)),
            float(np.floor(_IBERT_COEF[2] / _IBERT_COEF[0] / eps ** 2)))


def _ibert_int_polynomial(x_int, scale):
    _, b_int, c_int = ibert_constants(scale)
    z = (x_int + b_int) * x_int + c_int
    return z, _IBERT_COEF[0] * scale ** 2


def _ibert_int_exp(x_int, scale):
    x0_int, _, _ = ibert_constants(scale)
    x_int = torch.clamp(x_int, min=_IBERT_N * x0_int)
    q = torch.div(x_int, _f32(x0_int, x_int), rounding_mode="floor")
    r = x_int - x0_int * q
    exp_int, exp_scale = _ibert_int_polynomial(r, scale)
    exp_int = torch.clamp(torch.floor(exp_int * pow2_neg(q - _IBERT_N)),
                          min=0)
    return exp_int, exp_scale / 2 ** _IBERT_N


def ibert_softmax(x_q: torch.Tensor, eps: float = EPS_MAX, mask=None,
                  axis: int = -1, output_bit: int = 8) -> torch.Tensor:
    """I-BERT IntSoftmax. Inputs int8 (cast up); internals 32-bit integers
    held in float32 (as in the reference implementation), with its 16-bit
    ``QuantAct`` requantization of the exponent before summation (scale
    ``1/(2^15 - 1)``, since ``exp(x - max) <= 1``).

    The row sum is taken exactly (in float64) and rounded once to
    float32: the reference's float32 sum is exact, and then equal, while
    it stays below 2^24 (every row of up to 512 columns); beyond that its
    bits depend on the order of the sum."""
    x_int = x_q.float()
    if mask is not None:
        x_int = torch.where(mask, x_int, x_int.min() - _f32(1e4, x_int))
    x_int = x_int - x_int.amax(dim=axis, keepdim=True)
    exp_int, exp_scale = _ibert_int_exp(x_int, eps)
    # QuantAct(16): requantize exp to 16-bit symmetric (max real value 1)
    exp16 = torch.floor(exp_int * _f32(exp_scale, x_int)
                        * _f32(2.0 ** 15 - 1, x_int))
    if mask is not None:
        exp16 = torch.where(mask, exp16, 0.0)
    exp_sum = exp16.double().sum(dim=axis, keepdim=True).float()
    factor = torch.floor(_f32(2.0 ** 32, x_int)
                         / torch.clamp(exp_sum, min=1.0))
    out = torch.floor(exp16 * factor * 2.0 ** -(32 - output_bit))
    return out * 2.0 ** -output_bit


def ibert_softmax_np(x_q, eps: float = EPS_MAX,
                     output_bit: int = 8) -> torch.Tensor:
    """Exact int64 version of I-BERT softmax for MAE tables (float64
    probabilities; the JAX module's numpy copy)."""
    x_int = torch.as_tensor(x_q).to(torch.int64)
    x_int = x_int - x_int.amax(dim=-1, keepdim=True)
    x0_int, b_int, c_int = (int(c) for c in ibert_constants(eps))
    x_int = torch.clamp(x_int, min=_IBERT_N * x0_int)
    q = torch.div(x_int, x0_int, rounding_mode="floor")
    r = x_int - x0_int * q
    poly = (r + b_int) * r + c_int
    exp_int = torch.clamp(poly * (torch.ones_like(q) << (_IBERT_N - q)),
                          min=0)
    # QuantAct(16) requant; exact integer arithmetic elsewhere
    exp_scale = _IBERT_COEF[0] * eps ** 2 / 2 ** _IBERT_N
    exp16 = torch.floor(exp_int.double() * exp_scale * (2.0 ** 15 - 1)
                        ).to(torch.int64)
    exp_sum = exp16.sum(dim=-1, keepdim=True)
    factor = torch.div(torch.full_like(exp_sum, 1 << 32),
                       torch.clamp(exp_sum, min=1), rounding_mode="floor")
    out = (exp16 * factor) >> (32 - output_bit)
    return out.double() / 2.0 ** output_bit


def softermax(x_q: torch.Tensor, eps: float = EPS_MAX, frac_bits: int = 8,
              mask=None, axis: int = -1) -> torch.Tensor:
    """Softermax (Stevens et al., DAC'21): base-2 softmax with running max
    in fixed point; the exponent ``2^(eps' * (x - max))`` evaluated in
    Q(frac_bits). ``torch.exp2`` and XLA's round differently in the last
    bit, so a numerator ``floor(2^z · 2^frac_bits)`` may differ from the
    JAX module's by one where ``2^z · 2^frac_bits`` lies that close to an
    integer."""
    eps_p = eps * np.log2(np.e)
    x = x_q.float()
    if mask is not None:
        x = torch.where(mask, x, -torch.inf)
    z = (x - x.amax(dim=axis, keepdim=True)) * _f32(eps_p, x)
    pow2 = torch.floor(torch.exp2(z) * 2.0 ** frac_bits)
    denom = torch.clamp(pow2.sum(dim=axis, keepdim=True), min=1.0)
    return pow2 / denom


# ---------------------------------------------------------------------------
# Differentiable QAT forward (straight-through floors)
# ---------------------------------------------------------------------------

def _clip(x, lo, hi):
    """``jnp.clip``: on a tie with a bound, half the gradient, as
    ``lax.max``/``lax.min`` give it (``torch.clamp`` passes all of it)."""
    return torch.minimum(torch.maximum(x, _f32(lo, x)), _f32(hi, x))


def _ste_round(x):
    return x + (torch.round(x) - x).detach()


def _ste_floor(x):
    return x + (torch.floor(x) - x).detach()


def ita_softmax_ste(logits: torch.Tensor, eps: float = EPS_MAX, mask=None,
                    axis: int = -1) -> torch.Tensor:
    """QAT forward matching the deployed integer pipeline: logits
    quantized onto the int8 grid (STE round + clip), the exponent shift
    floored (STE), normalization in float. ``torch.autograd`` gives the
    straight-through gradient the JAX module's ``stop_gradient`` gives.
    The weights ``2^-k`` are exact powers of two in the forward, carrying
    ``exp2``'s gradient."""
    q = _clip(_ste_round(logits / _f32(eps, logits)), -128, 127)
    if mask is not None:
        # finite everywhere for clean STE gradients; masked elements are
        # zeroed multiplicatively below
        qm = torch.where(mask, q, q.amin(dim=axis, keepdim=True).detach())
    else:
        qm = q
    kf = _ste_floor((qm.amax(dim=axis, keepdim=True) - qm)
                    / 2.0 ** SOFTMAX_SHIFT)
    kc = _clip(kf, 0.0, 30.0)
    e = torch.exp2(-kc)
    w = e + (pow2_neg(kc.detach()) - e).detach()
    if mask is not None:
        w = w * mask.to(w.dtype)
    return w / torch.maximum(w.sum(dim=axis, keepdim=True), _f32(1e-9, w))
