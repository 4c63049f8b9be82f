"""Streaming (chunked) ITA integer attention — the ``impl="ita_int"``
arithmetic of ``repro.attention.chunked.streaming_attention``.

The paper's DA/DI/EN dataflow at chunk granularity, so the S×S matrix
never materializes: int8 Q·Kᵀ chunks requantized onto the ITA logit grid,
integer DA (Σ >>= Δmax >> 5), numerators ``u = min(128 >> k, 127)`` (the
JAX package clips them to int8 here so the A·V product rides int8
operands; Σ uses the same clipped numerators), adaptive or paper DI.

This is the unpinned ITA prefill of the serving path. The JAX package
computes it outside any Pallas kernel, and so does the port: plain torch
ops, with the integer products taken as exact float32 products
(``int_matmul``). The chunk schedule (q chunks, the causally reachable kv
chunks of each, their order) is the JAX package's, because the integer Σ
shifts make the result depend on it.

The float and QAT (``ita_ste``) arithmetics come with the ``float_xla``
backend and the training slice.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.quant import EPS_MAX, SOFTMAX_SHIFT
from repro_torch.kernels.common import (device_tensor, floor_log2,
                                        int_matmul, pow2_neg)

Q_CHUNK = 512
KV_CHUNK = 512


def _f32(x, device):
    return device_tensor(x, torch.float32, device)


def _chunk_mask(cq, ckv, q0, k0, causal, window, kv_len, device):
    qi = q0 + torch.arange(cq, dtype=torch.int32, device=device)[:, None]
    kj = k0 + torch.arange(ckv, dtype=torch.int32, device=device)[None, :]
    valid = torch.ones((cq, ckv), dtype=torch.bool, device=device)
    if causal or window > 0:
        valid = valid & (qi >= kj)
    if window > 0:
        valid = valid & ((qi - kj) < window)
    if kv_len is not None:
        valid = valid & (kj < kv_len)
    return valid


def _pad_axis1(x, pad):
    if not pad:
        return x
    shape = list(x.shape)
    shape[1] = pad
    return torch.cat([x, x.new_zeros(shape)], dim=1)


def streaming_attention(q, k, v, *, impl, scale, s_q=None, s_k=None,
                        s_v=None, causal=True, window=0, kv_len=None,
                        softcap=0.0, adaptive=True, q_chunk=Q_CHUNK,
                        kv_chunk=KV_CHUNK):
    """q (B,Sq,H,hd) int8; k/v (B,Skv,G,hd) int8. Returns (B,Sq,H,hd)
    float32: the ITA attention output dequantized through ``s_v``. The
    scales are float32 (0-d tensors in the model); ``kv_len`` a scalar.
    Queries start at position 0."""
    if impl != "ita_int":
        raise NotImplementedError(
            f"impl={impl!r}: this slice ports the ita_int serve arithmetic; "
            f"float and ita_ste come with float_xla and the training slice")
    dev = q.device
    b, sq_in, h, hd = q.shape
    skv_in, g = k.shape[1], k.shape[2]
    m_ = h // g
    cq = min(q_chunk, sq_in)
    ckv = min(kv_chunk, skv_in)
    pad_q, pad_kv = (-sq_in) % cq, (-skv_in) % ckv
    if pad_kv and kv_len is None:
        kv_len = skv_in
    q = _pad_axis1(q, pad_q)
    k = _pad_axis1(k, pad_kv)
    v = _pad_axis1(v, pad_kv)
    sq, skv = sq_in + pad_q, skv_in + pad_kv
    n_q = sq // cq

    # (B, G, M, S, hd) queries; (B, G, hd, S) keys; (B, G, S, hd) values
    q_i = q.to(torch.int8).reshape(b, sq, g, m_, hd).permute(0, 2, 3, 1, 4)
    k_t = k.to(torch.int8).permute(0, 2, 3, 1)
    v_i = v.to(torch.int8).permute(0, 2, 1, 3)
    qk = _f32(s_q, dev) * _f32(s_k, dev)
    fmult = qk * _f32(np.float32(scale), dev)
    lmult = fmult / _f32(np.float32(EPS_MAX), dev)
    eps = _f32(np.float32(EPS_MAX), dev)

    outs = []
    for iq in range(n_q):
        q0 = iq * cq
        # causally reachable kv chunk range
        hi = (min(q0 + cq, skv) + ckv - 1) // ckv if causal else skv // ckv
        lo = max(0, (q0 - window + 1) // ckv) if window > 0 else 0
        n_steps = max(hi - lo, 1)
        qc = q_i[:, :, :, q0:q0 + cq]                    # (B,G,M,cq,hd)
        m = torch.full((b, g, m_, cq, 1), -256, dtype=torch.int32,
                       device=dev)
        sig = torch.zeros((b, g, m_, cq, 1), dtype=torch.int32, device=dev)
        acc = torch.zeros((b, g, m_, cq, hd), dtype=torch.float32,
                          device=dev)
        for step in range(n_steps):
            k0 = (lo + step) * ckv
            ks = min(k0, skv - ckv)             # dynamic_slice clamps
            kc = k_t[..., ks:ks + ckv].unsqueeze(2)      # (B,G,1,hd,ckv)
            vc = v_i[:, :, ks:ks + ckv].unsqueeze(2)     # (B,G,1,ckv,hd)
            valid = _chunk_mask(cq, ckv, q0, k0, causal, window, kv_len, dev)
            acc32 = int_matmul(qc, kc)                   # (B,G,M,cq,ckv)
            if not softcap:
                lf = acc32 * lmult
            else:
                lf = torch.tanh(acc32 * fmult / softcap) * softcap / eps
            lg = torch.clamp(torch.round(lf), -128, 127).to(torch.int32)
            x = torch.where(valid, lg, -256)
            new_m = torch.maximum(m, x.amax(dim=-1, keepdim=True))
            delta = torch.clamp((new_m - m) >> SOFTMAX_SHIFT, max=31)
            kk = torch.clamp((new_m - lg).clamp(min=0) >> SOFTMAX_SHIFT,
                             max=31)
            kk = torch.where(valid, kk, 31)
            u = torch.clamp(torch.full_like(kk, 128) >> kk, max=127)
            sig = (sig >> delta) + 2 * u.sum(dim=-1, keepdim=True,
                                             dtype=torch.int32)
            pv = int_matmul(u, vc)
            acc = acc * pow2_neg(delta) + pv
            m = new_m

        sig = torch.clamp(sig, min=1)
        e_r = floor_log2(sig) if adaptive else torch.full_like(sig, 8)
        pre = torch.clamp(e_r + 8 - 30, min=0)
        num = torch.ones_like(sig) << torch.clamp(e_r + 8 - pre, max=30)
        inv = torch.div(num, sig >> pre, rounding_mode="floor")
        o = acc * (2.0 * inv.float() * pow2_neg(e_r + 8)) * _f32(s_v, dev)
        outs.append(o)                                   # (B,G,M,cq,hd)

    out = torch.cat(outs, dim=3) if n_q > 1 else outs[0]
    out = out.permute(0, 3, 1, 2, 4)                     # (B,Sq,G,M,hd)
    return out.reshape(b, sq, h, hd)[:, :sq_in]
