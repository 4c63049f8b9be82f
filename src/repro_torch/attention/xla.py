"""Quantization onto a fixed scale and the validity mask of the direct
attention paths (the part of ``repro.attention.xla`` this slice uses;
``direct_float``/``direct_int`` come with the direct backends)."""

from __future__ import annotations

import torch

from repro_torch.core.quant import INT8_MAX, INT8_MIN
from repro_torch.kernels.common import device_tensor


def quantize_to_int8(x, scale):
    """Quantize onto a fixed (per-tensor or broadcastable) scale: divide,
    round half to even, saturate. The scale is made a tensor first: torch
    divides by a Python scalar as a multiply by its reciprocal on the
    card, which rounds differently from the JAX package's division."""
    scale = device_tensor(scale, torch.float32, x.device)
    q = torch.round(x.float() / scale)
    return torch.clamp(q, INT8_MIN, INT8_MAX).to(torch.int8)


def mask(sq, skv, q_offset, causal, window, kv_len, device=None):
    """Validity mask. ``q_offset``/``kv_len`` may be scalars (dense) or
    (B,) per-sequence vectors (ragged batch); the result is (sq, skv) or
    (B, sq, skv) accordingly."""
    q_off = torch.as_tensor(q_offset, dtype=torch.int32, device=device)
    kvl = None if kv_len is None else torch.as_tensor(
        kv_len, dtype=torch.int32, device=device)
    if q_off.ndim or (kvl is not None and kvl.ndim):
        b = q_off.shape[0] if q_off.ndim else kvl.shape[0]
        q_off = q_off.reshape(-1).expand(b)[:, None, None]
        if kvl is not None:
            kvl = kvl.reshape(-1).expand(b)[:, None, None]
    qi = q_off + torch.arange(sq, dtype=torch.int32, device=device)[:, None]
    kj = torch.arange(skv, dtype=torch.int32, device=device)[None, :]
    m = torch.ones(qi.shape[:-1] + (skv,), dtype=torch.bool, device=device)
    if causal or window > 0:
        m = m & (qi >= kj)
    if window > 0:
        m = m & ((qi - kj) < window)
    if kv_len is not None:
        m = m & (kj < kvl)
    return m
