"""Int8 KV-cache decode engine (``repro.runtime.kv_cache``): per-head
quantization of the KV stream and the prefill/decode attend steps of one
attention layer over a ``KVCacheState`` ring or a ``PagedKVState`` pool.

    cache = init_cache(B, capacity, G, hd, per_head_scales=True)
    out, cache = prefill_attend(cache, q_q, k, v, s_q, s_out)
    out, cache = decode_attend(cache, q_q1, k1, v1, s_q, s_out)

K/V are stored int8 on per-(kv-)head scales fixed at prefill, so cached
bytes never need rescaling; the attend steps dispatch through the
attention registry with ``scale_kind="per_head"``, where the layouts
``bhsd_bsgd`` (rings read in place) and ``bhsd_paged`` (pools read
through the page table) select the fused kernels. The model path
(``models.attention``) quantizes onto its per-tensor QAT scales instead.

The quantizers compute in float32 as the JAX package does, and
``torch.round`` rounds half to even as ``jnp.round`` does.
"""

from __future__ import annotations

import torch

from repro_torch.attention import (AttentionSpec, KVCacheState, PagedKVState,
                                   QuantScales, dispatch)
from repro_torch.core.quant import INT8_MAX, INT8_MIN
from repro_torch.kernels.common import device_tensor

__all__ = ["KVCacheState", "PagedKVState", "init_cache", "init_paged_cache",
           "quantize_per_head", "quantize_with_scale", "prefill_attend",
           "decode_attend"]


def quantize_per_head(x: torch.Tensor, head_axis: int = 2):
    """Symmetric per-head int8 quantization of ``x`` (..., G, hd) with the
    heads on ``head_axis``. Returns ``(x_q int8, scale (G,) float32)``."""
    red = tuple(i for i in range(x.ndim) if i != head_axis)
    xf = x.float()
    amax = torch.amax(torch.abs(xf), dim=red)
    scale = torch.clamp(amax, min=1e-8) / device_tensor(
        float(INT8_MAX), torch.float32, x.device)
    sh = [1] * x.ndim
    sh[head_axis] = x.shape[head_axis]
    q = torch.round(xf / scale.reshape(sh))
    return torch.clamp(q, INT8_MIN, INT8_MAX).to(torch.int8), scale


def quantize_with_scale(x: torch.Tensor, scale) -> torch.Tensor:
    """Quantize onto a fixed (per-tensor or broadcastable) scale."""
    q = torch.round(x.float() / device_tensor(scale, torch.float32,
                                              x.device))
    return torch.clamp(q, INT8_MIN, INT8_MAX).to(torch.int8)


def init_cache(batch: int, capacity: int, n_kv_heads: int, head_dim: int,
               dtype=torch.int8, per_head_scales: bool = False,
               device="cuda") -> KVCacheState:
    """Fresh (zeroed) ring-buffer cache on ``device`` (default the card)."""
    return KVCacheState.init(batch, capacity, n_kv_heads, head_dim,
                             dtype=dtype, device=device,
                             per_head_scales=per_head_scales)


def init_paged_cache(batch: int, capacity: int, n_kv_heads: int,
                     head_dim: int, dtype=torch.int8,
                     per_head_scales: bool = False, *, page_size: int = 128,
                     num_pages: int | None = None,
                     device="cuda") -> PagedKVState:
    """Fresh paged KV pool (shared arena + per-sequence page tables).
    ``num_pages`` below ``batch * ceil(capacity / page_size)``
    oversubscribes the pool: pair it with an admission scheduler."""
    return PagedKVState.init(batch, capacity, n_kv_heads, head_dim,
                             dtype=dtype, device=device, page_size=page_size,
                             num_pages=num_pages,
                             per_head_scales=per_head_scales)


def prefill_attend(cache, q_q, k_new, v_new, s_q, s_out, *,
                   causal: bool = True, window: int = 0, lengths=None,
                   block_q: int = 128, block_kv: int = 128):
    """Quantized prefill: per-head-quantize and cache K/V, then the fused
    kernel over the prompt. ``q_q`` (B, Hq, S, D) int8 at scale ``s_q``;
    ``k_new``/``v_new`` (B, S, G, D) float; ``lengths`` (B,) a ragged batch
    of right-padded prompts. Ring or pool, the attention reads the fresh
    (B, S, G, D) int8 tensors in place (``bhsd_bsgd``). Returns ``(out
    int8 at s_out, new_cache)``."""
    k_q, k_scale = quantize_per_head(k_new)
    v_q, v_scale = quantize_per_head(v_new)
    cache = cache.prefill_write(k_q, v_q, lengths=lengths) \
        .with_scales(k_scale, v_scale)
    spec = AttentionSpec(mode="prefill", impl="ita", causal=causal,
                         window=window, layout="bhsd_bsgd",
                         scale_kind="per_head", out_dtype="int8",
                         q_len=q_q.shape[2])
    out = dispatch(q_q, k_q, v_q, spec=spec,
                   scales=QuantScales(s_q, k_scale, v_scale, s_out),
                   kv_len=lengths, block_q=block_q, block_kv=block_kv)
    return out, cache


def decode_attend(cache, q_q, k_new, v_new, s_q, s_out, *,
                  causal: bool = True, window: int = 0,
                  block_kv: int = 128):
    """One decode step through the cache: the new token's K/V quantized
    onto the cache's standing per-head scales and appended, then the
    fused decode kernel over the valid prefix, reading a ring in place
    (``bhsd_bsgd``) or a pool through its page table (``bhsd_paged``).
    ``q_q`` (B, Hq, 1, D) int8; ``k_new``/``v_new`` (B, 1, G, D) float.
    Returns ``(out, new_cache)``."""
    k_q = quantize_with_scale(k_new, cache.k_scale[None, None, :, None])
    v_q = quantize_with_scale(v_new, cache.v_scale[None, None, :, None])
    cache = cache.decode_append(k_q, v_q)
    paged = isinstance(cache, PagedKVState)
    spec = AttentionSpec(mode="decode", impl="ita", causal=causal,
                         window=window,
                         layout="bhsd_paged" if paged else "bhsd_bsgd",
                         scale_kind="per_head", out_dtype="int8",
                         q_len=q_q.shape[2])
    out = dispatch(q_q, cache.k, cache.v, spec=spec,
                   scales=QuantScales(s_q, cache.k_scale, cache.v_scale,
                                      s_out),
                   q_offset=cache.q_offset(1), kv_len=cache.valid_len(),
                   page_table=cache.page_table if paged else None,
                   block_kv=block_kv)
    return out, cache
