"""Plain-PyTorch oracles of the fused ITA attention kernels
(``repro.kernels.ita_attention.ref``).

- ``ita_attention_ref``        one-shot, paper EN semantics (p = Σ_inv >> k
                               then p·V) — the twopass kernels' single-
                               tile oracle; returns (out, A).
- ``ita_attention_fused_ref``  one-shot, fused semantics (u = 128>>k, u·V,
                               Σ_inv folded into the output requant) — the
                               onepass kernel's single-tile oracle.
- ``ita_attention_stream_ref`` tile-by-tile mirror of the kernels'
                               streaming DA and accumulator corrections,
                               for exact equality at any tiling.
- ``float_attention_ref``      float32 attention, the accuracy oracle.

``stream_rows`` is the tile loop itself over per-row logits, masks and
values; the kernels' plain versions (``kernel.py``) feed it per-row
GQA/ragged inputs, and the twopass ones its two halves
(``twopass_stats``, ``twopass_out``). Integer products are exact float32
products (``int_matmul``); p·V (p <= 256, ``exact_pv``) is taken one
KV tile at a time and summed in int64, exact at any length; powers of
two are built exactly (``pow2_neg``).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.quant import INT8_MAX, INT8_MIN, SOFTMAX_SHIFT
from repro_torch.kernels.common import (MASK_K, NEG_SENTINEL,
                                        SIGMA_INV_MAX, adaptive_inverse,
                                        da_update, int_matmul, paper_inverse,
                                        pow2_neg)


def _full_mask(sq, skv, causal, window, kv_len, q_offset=0, device=None):
    qi = q_offset + torch.arange(sq, dtype=torch.int32,
                                 device=device)[:, None]
    kj = torch.arange(skv, dtype=torch.int32, device=device)[None, :]
    valid = torch.ones((sq, skv), dtype=torch.bool, device=device)
    if causal or window > 0:
        valid = valid & (qi >= kj)
    if window > 0:
        valid = valid & ((qi - kj) < window)
    return valid & (kj < kv_len)


def requant_logits(q_q, k_q, lmult):
    """int8 Q (R,sq,d) x int8 K (R,skv,d)ᵀ -> int32 -> requant onto the
    int8 logit grid (returned as int32). ``lmult`` broadcasts against
    (R, sq, skv)."""
    acc = int_matmul(q_q, k_q.transpose(-1, -2))
    y = torch.round(acc * lmult)
    return torch.clamp(y, INT8_MIN, INT8_MAX).to(torch.int32)


def _k_and_sigma(logits, valid):
    """One-shot DA: the shifts k (masked lanes MASK_K), Σ and the row max."""
    x = torch.where(valid, logits, NEG_SENTINEL)
    row_max = x.amax(dim=-1, keepdim=True)
    k = torch.clamp((row_max - logits).clamp(min=0) >> SOFTMAX_SHIFT,
                    max=31)
    k = torch.where(valid, k, MASK_K)
    sigma = (2 * (torch.full_like(k, 128) >> k)).sum(dim=-1, keepdim=True,
                                                      dtype=torch.int32)
    return k, sigma, row_max


def _inverse(sigma, adaptive):
    if adaptive:
        return adaptive_inverse(sigma)
    inv = paper_inverse(sigma)
    return inv, torch.full_like(inv, 8)


def _requant_out(acc, inv, e_r, omult):
    """``round(acc · ((2·inv)·2^-(e_r+8))·omult)`` clipped to int8 — the
    multiply order of the kernels' finalize."""
    scale = 2.0 * inv.float() * pow2_neg(e_r + 8) * omult
    y = torch.round(acc * scale)
    return torch.clamp(y, INT8_MIN, INT8_MAX).to(torch.int8)


def exact_pv(p, v_rows, block_kv):
    """Exact p·V of int32 p (..., sq, skv), 0 <= p <= 256, and int8
    v_rows (..., skv, d) (leading dims broadcast): float32 products per
    KV tile of ``block_kv`` <= 512 keys (each partial sum an integer of
    magnitude <= 2^24, exact), summed across tiles in int64. Returns
    int64 (..., sq, d)."""
    skv = p.shape[-1]
    acc = None
    for j0 in range(0, skv, block_kv):
        sl = slice(j0, min(j0 + block_kv, skv))
        part = int_matmul(p[..., sl], v_rows[..., sl, :]).to(torch.int64)
        acc = part if acc is None else acc + part
    return acc


def _requant_twopass(acc, e_r, omult):
    """``round((f32(acc) · 2^-e_r) · omult)`` clipped to int8 — the
    multiply order of the twopass finalize (no factor 2, no +8)."""
    y = torch.round(acc.float() * pow2_neg(e_r) * omult)
    return torch.clamp(y, INT8_MIN, INT8_MAX).to(torch.int8)


def twopass_stats(logits, valid, *, adaptive, block_kv):
    """Twopass pass 1's statistics: the streaming DA over KV tiles of
    ``block_kv``, then DI. ``logits`` (R, sq, skv) int32, ``valid``
    broadcastable to it. Returns ``(row_max, sigma_inv, e_r)``, each
    (R, sq, 1) int32."""
    r, sq, skv = logits.shape
    valid = valid.expand(r, sq, skv)
    m = torch.full((r, sq, 1), NEG_SENTINEL, dtype=torch.int32,
                   device=logits.device)
    sigma = torch.zeros((r, sq, 1), dtype=torch.int32, device=logits.device)
    for j0 in range(0, skv, block_kv):
        sl = slice(j0, min(j0 + block_kv, skv))
        _, _, m, sigma = da_update(m, sigma, logits[..., sl], valid[..., sl])
    inv, e_r = _inverse(sigma, adaptive)
    return m, inv, e_r


def twopass_out(a, valid, row_max, sigma_inv, e_r, v_rows, omult, *,
                block_kv):
    """Twopass pass 2: EN ``p = Σ_inv >> k`` on the logits ``a`` (R, sq,
    skv) with the final streamed statistics (R, sq, 1), p·V, and the
    finalize. Returns (R, sq, d) int8."""
    k = torch.clamp((row_max - a).clamp(min=0) >> SOFTMAX_SHIFT, max=31)
    k = torch.where(valid, k, MASK_K)
    # an identity on every reachable value (a live row's Σ >= 256, a dead
    # row's shifts are 31), stated so that exact_pv's p <= 256 is proven
    # by the range certificate (analysis/verify.py)
    p = torch.clamp(sigma_inv >> k, max=SIGMA_INV_MAX)
    acc = exact_pv(p, v_rows, block_kv)
    return _requant_twopass(acc, e_r, omult)


def stream_rows(logits, valid, v_rows, omult, *, adaptive, block_kv,
                kind="onepass"):
    """The kernels' streaming dataflow over per-row inputs.

    ``logits`` (R, sq, skv) int32 on the int8 grid; ``valid`` bool,
    broadcastable to it; ``v_rows`` (R, skv, d) int8; ``omult``
    broadcastable to (R, sq, 1). KV tiles of ``block_kv`` run in order
    (the last one may be short). Returns (R, sq, d) int8."""
    if kind == "twopass":
        stats = twopass_stats(logits, valid, adaptive=adaptive,
                              block_kv=block_kv)
        return twopass_out(logits, valid, *stats, v_rows, omult,
                           block_kv=block_kv)
    r, sq, skv = logits.shape
    d = v_rows.shape[-1]
    dev = logits.device
    valid = valid.expand(r, sq, skv)
    m = torch.full((r, sq, 1), NEG_SENTINEL, dtype=torch.int32, device=dev)
    sigma = torch.zeros((r, sq, 1), dtype=torch.int32, device=dev)
    acc = torch.zeros((r, sq, d), dtype=torch.float32, device=dev)
    for j0 in range(0, skv, block_kv):
        sl = slice(j0, min(j0 + block_kv, skv))
        u, delta, m, sigma = da_update(m, sigma, logits[..., sl],
                                       valid[..., sl])
        pv = int_matmul(u, v_rows[:, sl])
        acc = acc * pow2_neg(delta) + pv
    inv, e_r = _inverse(sigma, adaptive)
    return _requant_out(acc, inv, e_r, omult)


def ita_attention_ref(q_q, k_q, v_q, lmult, omult, kv_len, *, causal,
                      window=0, adaptive=False, q_offset=0):
    """One-shot paper-EN reference. q (BH,sq,d), k/v (BH,skv,d) int8;
    scalar multipliers and positions. Returns (out int8, a int8)."""
    sq, skv = q_q.shape[1], k_q.shape[1]
    valid = _full_mask(sq, skv, causal, window, kv_len, q_offset,
                       q_q.device)[None]
    logits = requant_logits(q_q, k_q, lmult)
    k, sigma, _ = _k_and_sigma(logits, valid)
    inv, e_r = _inverse(sigma, adaptive)
    out = _requant_twopass(exact_pv(inv >> k, v_q, 128), e_r, omult)
    return out, logits.to(torch.int8)


def ita_attention_fused_ref(q_q, k_q, v_q, lmult, omult, kv_len, *, causal,
                            window=0, adaptive=True, q_offset=0):
    """One-shot fused-EN reference (u = 128>>k numerators). q (BH,sq,d),
    k/v (BH,skv,d) int8; scalar multipliers and positions."""
    sq, skv = q_q.shape[1], k_q.shape[1]
    valid = _full_mask(sq, skv, causal, window, kv_len, q_offset,
                       q_q.device)[None]
    logits = requant_logits(q_q, k_q, lmult)
    k, sigma, _ = _k_and_sigma(logits, valid)
    inv, e_r = _inverse(sigma, adaptive)
    acc = int_matmul(torch.full_like(k, 128) >> k, v_q)
    return _requant_out(acc, inv, e_r, omult)


def ita_attention_stream_ref(q_q, k_q, v_q, lmult, omult, kv_len, *, causal,
                             window=0, adaptive=True, block_kv=128,
                             kind="onepass", q_offset=0):
    """Tile-by-tile mirror of the kernels (exact-match oracle)."""
    sq, skv = q_q.shape[1], k_q.shape[1]
    valid = _full_mask(sq, skv, causal, window, kv_len, q_offset,
                       q_q.device)[None]
    logits = requant_logits(q_q, k_q, lmult)
    return stream_rows(logits, valid, v_q, omult, adaptive=adaptive,
                       block_kv=block_kv, kind=kind)


def float_attention_ref(q, k, v, *, causal, window=0, kv_len=None,
                        q_offset=0):
    """f32 attention oracle for end-to-end accuracy comparisons. q
    (BH,sq,d), k/v (BH,skv,d) float."""
    d = q.shape[-1]
    kv_len = k.shape[1] if kv_len is None else kv_len
    valid = _full_mask(q.shape[1], k.shape[1], causal, window, kv_len,
                       q_offset, q.device)[None]
    s = torch.matmul(q, k.transpose(1, 2)) / torch.full(
        (), np.sqrt(d), dtype=torch.float32, device=q.device)
    s = torch.where(valid, s, -torch.inf)
    p = torch.where(valid, torch.softmax(s, dim=-1), 0.0)
    return torch.matmul(p, v)
