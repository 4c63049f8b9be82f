"""Streaming (chunked) attention (``repro.attention.chunked``): the
three arithmetics of ``streaming_attention``, so the S×S matrix never
materializes.

- ``ita_int`` — the paper's DA/DI/EN dataflow at chunk granularity: int8
  Q·Kᵀ chunks requantized onto the ITA logit grid, integer DA (Σ >>=
  Δmax >> 5), numerators ``u = min(128 >> k, 127)`` (the JAX package
  clips them to int8 here so the A·V product rides int8 operands; Σ uses
  the same clipped numerators), adaptive or paper DI. The unpinned ITA
  prefill of the serving path.
- ``ita_ste`` — the QAT forward: Q and K rounded onto the int8 grid with
  straight-through rounds, base-2 weights ``2^-k`` with straight-through
  floored shifts, and the same shift-based running-max correction as the
  integer path, in float32. The reference's encoder runs it even when it
  serves (``ita_chunked_xla`` in train mode). Integer-valued operands
  keep the logits exact: ``lg`` and ``kk`` are the JAX package's bit for
  bit, and only the float32 ``w·v`` sums may differ in order. The
  weights are exact powers of two carrying ``exp2``'s gradient.
- ``float`` — the classic online softmax (exp rescale corrections), the
  float baseline's prefill (``float_xla``).

On the meta device (the dry-run) ``streaming_attention`` returns an
empty output of its shape and hands its chunk schedule to the cost hook
(``meta_chunks``), with a backward that does the same for its products.

The JAX package computes both outside any Pallas kernel, and so does the
port: plain torch ops, with the integer products taken as exact float32
products (``int_matmul``). The chunk schedule (q chunks, the causally
reachable kv chunks of each, their order) is the JAX package's, because
the integer Σ shifts make the result depend on it.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.attention.xla import scale_product
from repro_torch.attention.xla import softcap as _softcap
from repro_torch.core.cost_hook import counted
from repro_torch.core.quant import EPS_MAX, SOFTMAX_SHIFT
from repro_torch.core.softmax import _clip, _ste_floor, _ste_round
from repro_torch.kernels.common import (device_tensor, floor_log2,
                                        int_matmul, pow2_neg)

NEG = -1e30
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


def _pow2_neg_ste(k):
    """``2^-k`` of an integer-valued float ``k``, exact, with ``exp2``'s
    gradient."""
    e = torch.exp2(-k)
    return e + (pow2_neg(k.detach()) - e).detach()


def streaming_attention(q, k, v, *, impl, scale, s_q=None, s_k=None,
                        s_v=None, causal=True, window=0, kv_len=None,
                        softcap=0.0, adaptive=True, q_chunk=Q_CHUNK,
                        kv_chunk=KV_CHUNK):
    """q (B,Sq,H,hd); k/v (B,Skv,G,hd), int8 for ``ita_int``. Returns
    (B,Sq,H,hd) float32: softmax(QKᵀ)·V in the chosen arithmetic (for
    ``ita_int`` dequantized through ``s_v``; for ``ita_ste`` of float
    Q/K quantized through ``s_q``/``s_k`` and of ``v`` as given; the
    scales 0-d tensors of the model's ``param_dtype``, ``s_q * s_k *
    scale`` formed in it). ``kv_len`` a scalar. Queries start at
    position 0."""
    if impl not in ("ita_int", "ita_ste", "float"):
        raise ValueError(f"impl={impl!r} is not ita_int, ita_ste or float")
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
    if dev.type == "meta":
        steps = sum(max(((min(iq * cq + cq, skv) + ckv - 1) // ckv
                         if causal else skv // ckv)
                        - (max(0, (iq * cq - window + 1) // ckv)
                           if window > 0 else 0), 1) for iq in range(n_q))
        return _MetaStreaming.apply(q, k, v, (steps, cq, ckv))[:, :sq_in]

    # (B, G, M, S, hd) queries; (B, G, hd, S) keys; (B, G, S, hd) values
    is_int, ste = impl == "ita_int", impl == "ita_ste"
    cast = (lambda t: t.to(torch.int8)) if is_int else (lambda t: t.float())
    q, k = cast(q), cast(k)
    if ste:                              # onto the int8 grid, STE rounds
        q = _clip(_ste_round(q / _f32(s_q, dev)), -128, 127)
        k = _clip(_ste_round(k / _f32(s_k, dev)), -128, 127)
    q_i = q.reshape(b, sq, g, m_, hd).permute(0, 2, 3, 1, 4)
    k_t = k.permute(0, 2, 3, 1)
    v_i = cast(v).permute(0, 2, 1, 3)
    scale_t = _f32(np.float32(scale), dev)
    eps = _f32(np.float32(EPS_MAX), dev)
    if is_int or ste:
        fmult = scale_product(s_q, s_k, scale, dev)
        lmult = fmult / eps

    outs = []
    for iq in range(n_q):
        q0 = iq * cq
        # causally reachable kv chunk range
        hi = (min(q0 + cq, skv) + ckv - 1) // ckv if causal else skv // ckv
        lo = max(0, (q0 - window + 1) // ckv) if window > 0 else 0
        n_steps = max(hi - lo, 1)
        qc = q_i[:, :, :, q0:q0 + cq]                    # (B,G,M,cq,hd)
        m = (torch.full((b, g, m_, cq, 1), -256, dtype=torch.int32,
                        device=dev) if is_int else
             torch.full((b, g, m_, cq, 1), NEG, dtype=torch.float32,
                        device=dev))
        sig = torch.zeros((b, g, m_, cq, 1), dtype=m.dtype, device=dev)
        acc = torch.zeros((b, g, m_, cq, hd), dtype=torch.float32,
                          device=dev)
        if ste:
            m, sig, acc = _ste_chunks(qc, k_t, v_i, m, sig, acc, q0=q0,
                                      lo=lo, n_steps=n_steps, cq=cq,
                                      ckv=ckv, skv=skv, causal=causal,
                                      window=window, kv_len=kv_len,
                                      softcap=softcap, lmult=lmult,
                                      fmult=fmult, eps=eps)
            outs.append(acc / torch.clamp(sig, min=1e-9))
            continue
        for step in range(n_steps):
            k0 = (lo + step) * ckv
            ks = min(k0, skv - ckv)             # dynamic_slice clamps
            kc = k_t[..., ks:ks + ckv].unsqueeze(2)      # (B,G,1,hd,ckv)
            vc = v_i[:, :, ks:ks + ckv].unsqueeze(2)     # (B,G,1,ckv,hd)
            valid = _chunk_mask(cq, ckv, q0, k0, causal, window, kv_len, dev)
            if not is_int:                               # online softmax
                sc = _softcap(torch.matmul(qc, kc) * scale_t, softcap)
                x = torch.where(valid, sc, NEG)
                new_m = torch.maximum(m, x.amax(dim=-1, keepdim=True))
                w = torch.where(valid, torch.exp(sc - new_m), 0.0)
                corr = torch.exp(m - new_m)
                sig = sig * corr + w.sum(dim=-1, keepdim=True)
                acc = acc * corr + torch.matmul(w, vc)
                m = new_m
                continue
            acc32 = int_matmul(qc, kc)                   # (B,G,M,cq,ckv)
            if not softcap:
                lf = acc32 * lmult
            else:
                lf = _softcap(acc32 * fmult, softcap) / eps
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

        if not is_int:
            outs.append(acc / torch.clamp(sig, min=1e-9))
            continue
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


@counted("streaming_attention")
def meta_chunks(q, k, steps: int, cq: int, ckv: int, passes: int = 1):
    """The work of ``steps`` chunk pairs of a meta call (each a Q·Kᵀ and a
    weights·V product of ``cq`` queries by ``ckv`` keys), ``passes``
    times: ``roofline.op_costs`` counts it by formula."""
    return q.new_empty(q.shape, dtype=torch.float32)


class _MetaStreaming(torch.autograd.Function):
    """``streaming_attention`` on the meta device: the output's shape, and
    in the backward its two products per chunk pair counted twice."""

    @staticmethod
    def forward(ctx, q, k, v, schedule):
        ctx.schedule = schedule
        ctx.save_for_backward(q, k, v)
        return meta_chunks(q, k, *schedule)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        meta_chunks(q, k, *ctx.schedule, passes=2)
        return (torch.zeros_like(q), torch.zeros_like(k),
                torch.zeros_like(v), None)


def _ste_chunks(qc, k_t, v_i, m, sig, acc, *, q0, lo, n_steps, cq, ckv, skv,
                causal, window, kv_len, softcap, lmult, fmult, eps):
    """The QAT forward's kv loop of one q chunk: the running max ``m``,
    the sum ``sig`` and the accumulator ``acc`` (float32) after the
    chunk's reachable kv chunks, as ``jax.lax.scan`` of the reference's
    ``body`` leaves them."""
    shift = 2.0 ** SOFTMAX_SHIFT
    for step in range(n_steps):
        k0 = (lo + step) * ckv
        ks = min(k0, skv - ckv)                 # dynamic_slice clamps
        kc = k_t[..., ks:ks + ckv].unsqueeze(2)          # (B,G,1,hd,ckv)
        vc = v_i[:, :, ks:ks + ckv].unsqueeze(2)         # (B,G,1,ckv,hd)
        valid = _chunk_mask(cq, ckv, q0, k0, causal, window, kv_len,
                            qc.device)
        s = int_matmul(qc, kc)                  # integer-valued, exact
        lf = s * lmult if not softcap \
            else _softcap(s * fmult, softcap) / eps
        lg = _clip(_ste_round(lf), -128.0, 127.0)
        x = torch.where(valid, lg, NEG)
        new_m = torch.maximum(m, x.amax(dim=-1, keepdim=True))
        delta = _ste_floor(_clip((new_m - m) / shift, 0.0, 1e4))
        kk = _ste_floor((new_m - lg) / shift)
        w = torch.where(valid, _pow2_neg_ste(_clip(kk, 0.0, 30.0)), 0.0)
        corr = _pow2_neg_ste(torch.clamp(delta, max=30.0))
        sig = sig * corr + w.sum(dim=-1, keepdim=True)
        acc = acc * corr + torch.matmul(w, vc)
        m = new_m
    return m, sig, acc
