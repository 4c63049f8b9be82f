"""Model assembly (``repro.models.transformer``) for the dense decoder:
``attn`` blocks in layer groups, run by a Python loop over layers where
the JAX package scans period-stacked parameters.

    model = init_model(cfg, seed=0)                  # on the card
    caches = init_caches(cfg, batch, max_len)        # one ring per layer
                                                     # (paged=True: pools)
    logits, caches = forward(model, tokens, cfg, mode="prefill",
                             caches=caches)

``from_jax_params`` loads a parameter pytree of the JAX package (numpy
arrays, ``groups[g][pattern_pos][leaf]`` stacked over periods) into the
port's modules, which is how the tests hold the two to the same weights.
Other block kinds (MoE, recurrent, cross-attention, encoders) come with
later slices.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.attention import KVCacheState, PagedKVState
from repro_torch.device import resolve_device
from repro_torch.kernels.common import device_tensor
from repro_torch.models.attention import Attention
from repro_torch.models.layers import (SwiGLU, const_param, embed,
                                       normal_param, rmsnorm, unembed)

_PORTED_KINDS = ("attn",)


def _check_ported(cfg):
    kinds = {k for pat, _ in cfg.layer_groups for k in pat}
    if kinds - set(_PORTED_KINDS) or cfg.mlp_type != "swiglu" \
            or cfg.norm_type != "rmsnorm" or cfg.n_encoder_layers \
            or cfg.frontend_dim or cfg.sinusoidal_pos or cfg.attn_softcap \
            or cfg.embed_scale \
            or cfg.name.startswith("gemma2"):
        raise NotImplementedError(
            f"{cfg.name}: this slice of the port builds dense decoders of "
            f"{_PORTED_KINDS} blocks with SwiGLU and RMSNorm; the other "
            f"blocks come with later slices (ROADMAP A6)")


class Block(nn.Module):
    """Pre-norm attention block: x + attn(norm1(x)), then x + mlp(norm2(x))."""

    def __init__(self, cfg, *, device, generator=None):
        super().__init__()
        self.norm1 = const_param((cfg.d_model,), 0.0, dtype=torch.float32,
                                 device=device)
        self.attn = Attention(cfg, device=device, generator=generator)
        self.norm2 = const_param((cfg.d_model,), 0.0, dtype=torch.float32,
                                 device=device)
        self.mlp = SwiGLU(cfg.d_model, cfg.d_ff, dtype=cfg.compute_dtype(),
                          device=device, generator=generator)

    def forward(self, x, *, cfg, positions, cache, mode, lengths=None,
                live=None, q_lens=None):
        h = rmsnorm(self.norm1, x)
        y, new_mix = self.attn(h, cfg=cfg, kind="global",
                               positions=positions,
                               cache=None if cache is None else cache["mix"],
                               mode=mode, lengths=lengths, live=live,
                               q_lens=q_lens)
        x = x + y
        x = x + self.mlp(rmsnorm(self.norm2, x))
        return x, (None if cache is None else dict(cache, mix=new_mix))


class Transformer(nn.Module):
    """Embedding, the blocks in execution order (group-major, then period,
    then pattern position), final norm and unembedding."""

    def __init__(self, cfg, *, device, generator=None):
        super().__init__()
        _check_ported(cfg)
        self.cfg = cfg
        dt = cfg.compute_dtype()
        self.embed = normal_param((cfg.vocab_size, cfg.d_model),
                                  cfg.d_model ** -0.5, dtype=dt,
                                  device=device, generator=generator)
        if not cfg.tie_embeddings:
            self.unembed = normal_param((cfg.d_model, cfg.vocab_size),
                                        cfg.d_model ** -0.5, dtype=dt,
                                        device=device, generator=generator)
        self.blocks = nn.ModuleList(
            Block(cfg, device=device, generator=generator)
            for _ in range(cfg.n_layers))
        self.final_norm = const_param((cfg.d_model,), 0.0,
                                      dtype=torch.float32, device=device)

    def unembed_weight(self) -> torch.Tensor:
        return self.embed.T if self.cfg.tie_embeddings else self.unembed


def init_model(cfg, *, seed: int = 0, device="cuda") -> Transformer:
    """Random weights from ``seed`` at the JAX package's distributions
    (``scale · N(0, 1)`` projections and embeddings, zero biases and norm
    gains, 0.05 quantization scales), in the compute dtype, on ``device``
    (default the card; raises when CUDA is missing)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    with torch.no_grad():
        return Transformer(cfg, device=dev, generator=gen)


def _layer_leaves(tree, cfg):
    """Yield (flat layer index, block param dict of numpy arrays)."""
    idx = 0
    for g, (pattern, n) in enumerate(cfg.layer_groups):
        group = tree["groups"][g]
        for period in range(n):
            for pos in range(len(pattern)):
                blk = group[pos]
                yield idx, {
                    mod: {leaf: np.asarray(a)[period]
                          for leaf, a in blk[mod].items()}
                    for mod in blk}
                idx += 1


def from_jax_params(tree, cfg, *, device="cuda") -> Transformer:
    """Load a JAX-package parameter pytree (numpy arrays; per group, per
    pattern position, leaves stacked over ``n_periods``) into the port's
    modules on ``device``."""
    dev = resolve_device(device)
    with torch.no_grad():
        model = Transformer(cfg, device=dev)

        def put(param, array):
            param.copy_(torch.from_numpy(np.array(array)).to(param.dtype))

        put(model.embed, tree["embed"]["table"])
        if not cfg.tie_embeddings:
            put(model.unembed, tree["embed"]["unembed"])
        put(model.final_norm, tree["final_norm"]["scale"])
        for i, blk in _layer_leaves(tree, cfg):
            mine = model.blocks[i]
            put(mine.norm1, blk["norm1"]["scale"])
            put(mine.norm2, blk["norm2"]["scale"])
            for leaf, a in blk["attn"].items():
                put(getattr(mine.attn, leaf), a)
            for leaf, a in blk["mlp"].items():
                put(getattr(mine.mlp, leaf), a)
    return model


def init_caches(cfg, batch: int, max_len: int, *, paged: bool = False,
                page_size: int = 128, num_pages: int | None = None,
                device="cuda"):
    """One ``{"mix": cache}`` per layer, in execution order: a
    ``KVCacheState`` ring, or with ``paged=True`` a ``PagedKVState`` pool
    (one arena and page table per layer, ``num_pages`` pages each; None
    provisions fully) — int8 for the quantized impls, the compute dtype
    for float."""
    dev = resolve_device(device)
    _check_ported(cfg)
    kv_dt = torch.int8 if cfg.attention_impl != "float" \
        else cfg.compute_dtype()

    def kv_cache():
        if paged:
            return PagedKVState.init(batch, max_len, cfg.n_kv_heads,
                                     cfg.head_dim, dtype=kv_dt, device=dev,
                                     page_size=page_size,
                                     num_pages=num_pages)
        return KVCacheState.init(batch, max_len, cfg.n_kv_heads,
                                 cfg.head_dim, dtype=kv_dt, device=dev)
    return [{"mix": kv_cache()} for _ in range(cfg.n_layers)]


def forward(model: Transformer, tokens, cfg, *, mode="train", caches=None,
            pos0=None, lengths=None, live=None, q_lens=None,
            skip_unembed=False):
    """tokens (B, S) int. Returns ``(logits (B, S, V) float32,
    new_caches)``. ``pos0``: the first token's position, a scalar or a
    (B,) per-sequence vector (ragged decode). ``lengths`` (B,): ragged
    prefill of right-padded prompts. ``live`` (B,) bool: decode-time
    slot mask of continuous batching (dead slots neither write their
    caches nor advance). ``q_lens`` (B,) int32: the mixed chunked-prefill
    step over paged caches (row ``b`` holds ``q_lens[b]`` real tokens).
    ``skip_unembed`` returns the final-norm hidden states (B, S, d) in
    place of the logits (the mixed step unembeds one row per sequence,
    ``unembed(model.unembed_weight(), x)``)."""
    dev = model.embed.device
    tokens = torch.as_tensor(tokens, device=dev).long()
    x = embed(model.embed, tokens)
    s = tokens.shape[1]
    ar = torch.arange(s, dtype=torch.int32, device=dev)
    if pos0 is None:
        positions = ar
    else:
        pos0 = device_tensor(pos0, torch.int32, dev)
        positions = pos0[..., None] + ar if pos0.ndim else pos0 + ar
    new_caches = [] if caches is not None else None
    for i, blk in enumerate(model.blocks):
        x, nc = blk(x, cfg=cfg, positions=positions,
                    cache=None if caches is None else caches[i], mode=mode,
                    lengths=lengths, live=live, q_lens=q_lens)
        if new_caches is not None:
            new_caches.append(nc)
    x = rmsnorm(model.final_norm, x)
    if skip_unembed:
        return x, new_caches
    return unembed(model.unembed_weight(), x, cfg.logit_softcap), new_caches
