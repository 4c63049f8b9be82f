"""Direct (one-shot) attention paths in model layout (B,S,H,hd)
(``repro.attention.xla``).

These materialize the (Sq, Skv) logit matrix, so they serve the short-q
cases: decode steps over a KV cache and the integer serve specs the
fused kernels decline (logit softcap, custom query scale, long decode
bursts), and the I-BERT baseline. GQA is native: KV heads are never
broadcast. The JAX package leaves them to XLA; here they are plain torch
ops, behind ``float_xla`` / ``ita_direct_xla`` / ``ibert_xla``
(``repro_torch.attention.backends``); call ``dispatch`` rather than this
module.

Every division by a constant divides by a tensor on the operand's
device: torch divides by a Python scalar as a multiply by its
reciprocal on the card, which rounds differently from the JAX package's
division (and would move int8 logits). Integer products are exact
float32 products (``int_matmul``); ITA's p·V over a whole cache is taken
in 512-key tiles summed in int64 (``exact_pv``), since p <= 256 times
|v| <= 128 passes 2^24 beyond 512 keys.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import softmax as S
from repro_torch.core.quant import EPS_MAX, INT8_MAX, INT8_MIN
from repro_torch.kernels.common import device_tensor, int_matmul, pow2_neg
from repro_torch.kernels.ita_attention.ref import exact_pv

# KV tile of the exact ITA p·V: every partial sum of a tile, in any order,
# is an integer of magnitude <= 256 · 128 · 512 = 2^24, exact in float32
_PV_BLOCK = 512


def softcap(x, cap):
    """``tanh(x / cap) * cap`` in x's dtype (``cap`` 0: x unchanged)."""
    if not cap:
        return x
    c = device_tensor(cap, x.dtype, x.device)
    return torch.tanh(x / c) * c


def quantize_to_int8(x, scale):
    """Quantize onto a fixed (per-tensor or broadcastable) scale: divide,
    round half to even, saturate. The scale is made a tensor first: torch
    divides by a Python scalar as a multiply by its reciprocal on the
    card, which rounds differently from the JAX package's division."""
    scale = device_tensor(scale, torch.float32, x.device)
    q = torch.round(x.float() / scale)
    return torch.clamp(q, INT8_MIN, INT8_MAX).to(torch.int8)


def scale_product(s_q, s_k, scale, device) -> torch.Tensor:
    """``s_q * s_k * scale`` as the JAX package forms it, widened to
    float32: in the scales' own dtype, with the Python ``scale`` taking
    that dtype as a weakly typed JAX scalar does. Float32 scales give the
    float32 product; bfloat16 scales (``param_dtype="bfloat16"``) round
    to bfloat16 after each product."""
    dts = {x.dtype for x in (s_q, s_k) if torch.is_tensor(x)}
    dt = torch.bfloat16 if dts == {torch.bfloat16} else torch.float32
    return (device_tensor(s_q, dt, device) * device_tensor(s_k, dt, device)
            * device_tensor(float(scale), dt, device)).float()


def mask(sq, skv, q_offset, causal, window, kv_len, device=None):
    """Validity mask. ``q_offset``/``kv_len`` may be scalars (dense) or
    (B,) per-sequence vectors (ragged batch); the result is (sq, skv) or
    (B, sq, skv) accordingly."""
    q_off = device_tensor(q_offset, torch.int32, device)
    kvl = None if kv_len is None else device_tensor(kv_len, torch.int32,
                                                    device)
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


def _lift(m):
    """mask -> broadcastable against (B, G, M, Sq, Skv) logits."""
    return m[:, None, None] if m.ndim == 3 else m[None, None, None]


def _gqa_q(q, g):
    """q (B,Sq,H,hd) -> (B,G,H/G,Sq,hd)."""
    b, sq, h, hd = q.shape
    return q.reshape(b, sq, g, h // g, hd).permute(0, 2, 3, 1, 4)


def gqa_logits(q, k, matmul=torch.matmul):
    """q (B,Sq,H,hd), k (B,Skv,G,hd) -> logits (B,G,H/G,Sq,Skv) without
    materializing broadcast KV heads."""
    return matmul(_gqa_q(q, k.shape[2]), k.permute(0, 2, 3, 1)[:, :, None])


def _bqhd(out):
    """(B,G,M,Sq,hd) -> (B,Sq,H,hd)."""
    b, g, m, sq, hd = out.shape
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, g * m, hd)


def _kv_rows(v):
    """v (B,Skv,G,hd) -> (B,G,1,Skv,hd), broadcast over the query heads
    of each KV head."""
    return v.permute(0, 2, 1, 3)[:, :, None]


def gqa_out(p, v):
    """p (B,G,M,Sq,Skv), v (B,Skv,G,hd) -> (B,Sq,H,hd)."""
    return _bqhd(torch.matmul(p, _kv_rows(v)))


def direct_float(q, k, v, *, scale, cap=0.0, causal=True, window=0,
                 q_offset=0, kv_len=None):
    """Float softmax attention; q (B,Sq,H,hd), k/v (B,Skv,G,hd) float.
    Returns (B,Sq,H,hd) in v's dtype."""
    m = _lift(mask(q.shape[1], k.shape[1], q_offset, causal, window,
                   kv_len, q.device))
    logits = gqa_logits(q, k) * device_tensor(scale, q.dtype, q.device)
    logits = softcap(logits, cap)
    logits = torch.where(m, logits, -torch.inf)
    p = torch.softmax(logits.float(), dim=-1)
    p = torch.where(m, p, 0.0).to(v.dtype)
    return gqa_out(p, v)


def direct_int(q8, k8, v8, *, s_q, s_k, s_v, scale, impl="ita",
               softmax="adaptive", cap=0.0, causal=True, window=0,
               q_offset=0, kv_len=None):
    """Integer serve path: int8 Q·Kᵀ (exact), requant onto the ITA logit
    grid (with the optional float-side softcap), shift-only or I-BERT
    softmax, integer A·V. q8 (B,Sq,H,hd), k8/v8 (B,Skv,G,hd) int8; the
    scales 0-d tensors of the model's ``param_dtype`` (``scale_product``).
    Returns (B,Sq,H,hd) float32 (dequantized through s_v)."""
    dev = q8.device
    m = _lift(mask(q8.shape[1], k8.shape[1], q_offset, causal, window,
                   kv_len, dev))

    def f32(x):
        return device_tensor(x, torch.float32, dev)

    acc = gqa_logits(q8, k8, matmul=int_matmul)     # exact, |acc| < 2^24
    logits_f = acc * scale_product(s_q, s_k, scale, dev)
    logits_f = softcap(logits_f, cap)
    lq = torch.clamp(torch.round(logits_f / f32(np.float32(EPS_MAX))),
                     INT8_MIN, INT8_MAX).to(torch.int32)
    bmask = m.expand(lq.shape)

    if impl == "ibert":
        p = S.ibert_softmax(lq, mask=bmask)                 # f32 probs
        # p is a multiple of 2^-8 with Σp <= 1: every partial sum of p·v
        # is exact in float32, in any order
        return _bqhd(torch.matmul(p, _kv_rows(v8).float())) * f32(s_v)
    if softmax == "paper":
        p_int, sigma, _ = S.ita_softmax_int(lq, mask=bmask)
        e_r = torch.full_like(sigma, 8)
    else:                                                   # adaptive
        p_int, e_r, _ = S.ita_softmax_adaptive_int(lq, mask=bmask)
    acc_o = exact_pv(p_int, _kv_rows(v8), _PV_BLOCK)        # int64
    return _bqhd(acc_o.float() * pow2_neg(e_r)) * f32(s_v)
