"""Plumbing behind the fused-kernel attention backends
(``repro.kernels.ita_attention.ops``): layouts, GQA, padding to the KV
tile and the quantization-scale multipliers.

    logit_mult = s_q * s_k / f32(sqrt(d) * EPS_MAX)   (requant onto ITA's grid)
    out_mult   = s_v / s_out

The constant is formed in float64 and rounded to float32 once, as the
JAX package does. Scales are scalars (per-tensor) or per-head vectors —
``s_q``/``s_out`` (Hq,), ``s_k``/``s_v`` (Hkv,) — resolved to one value
per (batch·head) kernel row (rows are batch-major, head-minor).

Kinds: ``onepass`` (flash-style) and ``decode`` (a single query tile
against a KV ring, tiles past the valid prefix skipped), each over a
ring or, with ``page_table=``, over the paged pool (the tile is the
page); ``twopass`` (the paper's dataflow, the A matrix in device memory)
over kernel-layout K/V with uniform query rows.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.quant import EPS_MAX
from repro_torch.kernels.common import device_tensor
from repro_torch.kernels.ita_attention.kernel import (
    ita_attention_decode, ita_attention_decode_paged, ita_attention_onepass,
    ita_attention_onepass_paged, ita_attention_twopass)

KINDS = ("onepass", "twopass", "decode")


def _pad_seq(x, mult, hot: bool = False):
    """Zero-pad the seq axis (axis 1, any rank) to a multiple of ``mult``.

    ``hot=True`` marks the decode KV ring: padding there would copy the
    whole ring every step, so it raises — ``KVCacheState.init``
    block-aligns ring capacities, which keeps the pad a no-op."""
    pad = (-x.shape[1]) % mult
    if pad and hot:
        raise ValueError(
            f"decode KV ring capacity {x.shape[1]} is not a block_kv="
            f"{mult} multiple — a per-step pad-copy of the whole ring; "
            f"allocate through KVCacheState.init (block-aligned) or pass "
            f"a block_kv that divides the capacity")
    if pad:
        shape = list(x.shape)
        shape[1] = pad
        x = torch.cat([x, x.new_zeros(shape)], dim=1)
    return x


def _per_head(s, h, device):
    """Scalar -> (h,); (h,) passes through. float32."""
    s = device_tensor(s, torch.float32, device).reshape(-1)
    if s.shape[0] == 1:
        return s.expand(h)
    if s.shape[0] != h:
        raise ValueError(f"per-head scale of {s.shape[0]} entries for {h} "
                         f"heads")
    return s


def _per_row(x, b, h, device):
    """A position operand -> one value per (batch·head) row: scalars
    broadcast, (B,) per-sequence vectors repeat per head."""
    x = device_tensor(x, torch.int32, device).reshape(-1)
    if x.shape[0] == 1:
        return x.expand(b * h)
    if x.shape[0] != b:
        raise ValueError(f"per-sequence operand of {x.shape[0]} entries for "
                         f"batch {b}")
    return x.repeat_interleave(h)


def row_multipliers(s_q, s_k, s_v, s_out, *, b, hq, hkv, d, device):
    """Per-(batch·head) ``(logit_mult, out_mult)`` float32 (b·hq,)."""
    rep = hq // hkv
    sk_h = _per_head(s_k, hkv, device).repeat_interleave(rep)
    sv_h = _per_head(s_v, hkv, device).repeat_interleave(rep)
    const = device_tensor(np.float32(np.sqrt(d) * EPS_MAX), torch.float32,
                          device)
    lmult = _per_head(s_q, hq, device) * sk_h / const
    omult = sv_h / _per_head(s_out, hq, device)
    return lmult.repeat(b), omult.repeat(b)


def fused_attention(q_q, k_q, v_q, s_q, s_k, s_v, s_out, *, q_offset=0,
                    kv_len=None, q_lens=None, causal: bool = True,
                    window: int = 0, kind: str = "onepass",
                    adaptive: bool = True, block_q: int = 128,
                    block_kv: int = 128, kv_native: bool = False,
                    page_table=None):
    """Quantized multi-head attention with the ITA integer softmax.

    ``q_q``: (B, Hq, Sq, D) int8; ``k_q``/``v_q``: (B, Hkv, Skv, D) int8
    or, with ``kv_native=True`` (onepass, decode), cache-native (B, Skv,
    Hkv, D) rings (read in place by the kernels), or with ``page_table``
    (B, n_pages) int32 (onepass, decode) a shared paged pool (P, page,
    Hkv, D). ``q_lens`` (onepass, decode) marks each row's valid query
    count. GQA: Hkv divides Hq.
    ``q_offset`` / ``kv_len`` / ``q_lens`` accept (B,) per-sequence
    vectors (the ragged batch). The KV tile is ``bkv = min(block_kv,
    max(128, Skv))`` for Skv >= 128, else Skv; over a paged pool it is
    the page. Returns (B, Hq, Sq, D) int8 at scale ``s_out``.
    """
    if kind not in KINDS:
        raise ValueError(f"kind={kind!r} is not one of {KINDS}")
    if kind == "twopass":
        if kv_native:
            raise ValueError("cache-native KV layout serves the "
                             "onepass/decode kernels only")
        if page_table is not None:
            raise ValueError("the paged pool serves the onepass/decode "
                             "kernels only")
        if q_lens is not None:
            raise ValueError("ragged q_len serves the onepass/decode "
                             "kernels only")
    b, hq, sq, d = q_q.shape
    if page_table is not None:              # paged pool (P, page, G, hd)
        hkv = k_q.shape[2]
        skv = page_table.shape[1] * k_q.shape[1]
    elif kv_native:
        skv, hkv = k_q.shape[1], k_q.shape[2]
    else:
        hkv, skv = k_q.shape[1], k_q.shape[2]
    if hq % hkv:
        raise ValueError(f"GQA needs Hkv | Hq, got {hkv}/{hq}")
    rep = hq // hkv
    lmult, omult = row_multipliers(s_q, s_k, s_v, s_out, b=b, hq=hq,
                                   hkv=hkv, d=d, device=q_q.device)
    kv_len = _per_row(skv if kv_len is None else kv_len, b, hq, q_q.device)
    q_offset = _per_row(q_offset, b, hq, q_q.device)
    q_len = None if q_lens is None else _per_row(q_lens, b, hq, q_q.device)
    common = dict(q_offset=q_offset, q_len=q_len, causal=causal,
                  window=window, adaptive=adaptive, kv_rep=rep)
    qf = q_q.reshape(b * hq, sq, d)

    if page_table is not None:
        # pages are the KV tiles (block_kv == page size), read in place
        # through the page table: the pool is never padded or copied
        if kind == "decode":
            out = ita_attention_decode_paged(qf, k_q, v_q, page_table, lmult,
                                             omult, kv_len, hq=hq, **common)
        else:
            out = ita_attention_onepass_paged(
                qf, k_q, v_q, page_table, lmult, omult, kv_len,
                block_q=min(block_q, max(8, sq)), hq=hq, **common)
        return out.reshape(b, hq, sq, d)

    bkv = min(block_kv, max(128, skv)) if skv >= 128 else skv
    hot = kind == "decode"
    if kv_native:
        kf, vf = _pad_seq(k_q, bkv, hot), _pad_seq(v_q, bkv, hot)
    else:
        kf = _pad_seq(k_q.reshape(b * hkv, skv, d), bkv, hot)
        vf = _pad_seq(v_q.reshape(b * hkv, skv, d), bkv, hot)
    common.update(block_kv=bkv, hq=hq if kv_native else None)
    if kind == "decode":
        out = ita_attention_decode(qf, kf, vf, lmult, omult, kv_len,
                                   **common)
    elif kind == "twopass":
        out, _ = ita_attention_twopass(
            qf, kf, vf, lmult, omult, kv_len, q_offset=q_offset,
            causal=causal, window=window, adaptive=adaptive,
            block_kv=bkv, kv_rep=rep)
    else:
        out = ita_attention_onepass(qf, kf, vf, lmult, omult, kv_len,
                                    block_q=min(block_q, max(8, sq)),
                                    **common)
    return out.reshape(b, hq, sq, d)
