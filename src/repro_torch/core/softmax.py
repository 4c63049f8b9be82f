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

The baselines of the JAX module (``softmax_float``, I-BERT, Softermax and
the QAT STE forward) come with the dispatch backends that use them.

Integer hazards, as in ``kernels/common.py``: JAX shifts with
``shift_right_logical``, torch ``>>`` on int32 is arithmetic; every shift
here takes a non-negative operand. ``_k_of`` clamps ``max - x`` at 0,
which changes only masked lanes (where ``x`` may exceed the max of the
valid ones), and every caller replaces those lanes' shift by
``_MASK_K``. torch has no count-leading-zeros: ``floor_log2`` finds
``floor(log2 x)`` with integer compares.
"""

from __future__ import annotations

import torch

from repro_torch.core.quant import B_BITS, SOFTMAX_SHIFT

# 2**8 — the unit in which denominator terms are accumulated.
_UNIT = 1 << B_BITS
# Paper's denominator-inversion width: sigma_inv = 2**16 // sigma.
_W_INV = 2 * B_BITS
# Shift amount for masked-out elements: forces the term/probability to 0.
_MASK_K = 31
# Sentinel below any int8 value; (max - sentinel) cannot overflow int32.
_NEG_SENTINEL = -(2 ** B_BITS)


def floor_log2(x: torch.Tensor) -> torch.Tensor:
    """Exact ``floor(log2 x)`` of a positive int32 tensor (``31 - clz``)."""
    e = torch.zeros_like(x)
    for s in (16, 8, 4, 2, 1):
        hit = x >= (1 << s)
        e = torch.where(hit, e + s, e)
        x = torch.where(hit, x >> s, x)
    return e


def pow2_neg(n: torch.Tensor) -> torch.Tensor:
    """Exact float32 ``2^-n`` of an int32 tensor with ``0 <= n <= 126``,
    built from its exponent bits (never an approximate ``exp2``)."""
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
