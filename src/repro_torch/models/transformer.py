"""Model assembly (``repro.models.transformer``) for decoders of
attention blocks (``attn`` global, ``local``/``swa`` sliding window) and
recurrent blocks (``rglru``: RG-LRU, ``models.rglru``; ``rwkv``: RWKV6
time and channel mix, ``models.rwkv6``) in layer groups, run by a Python
loop over layers where the JAX package scans period-stacked parameters.
The MLP of an attention or RG-LRU block is SwiGLU, GeGLU or, with
``mlp_type="moe"``, the mixture of experts of ``models.moe``; an RWKV
block's is its channel mix. Gemma2's extras are here too: post-norms on
both residual branches, scaled embeddings and the final logit softcap.

    model = init_model(cfg, seed=0)                  # on the card
    caches = init_caches(cfg, batch, max_len)        # one ring per attention
                                                     # layer (paged=True:
                                                     # pools), state per
                                                     # recurrent layer
    logits, caches = forward(model, tokens, cfg, mode="prefill",
                             caches=caches)

``from_jax_params`` loads a parameter pytree of the JAX package (numpy
arrays, ``groups[g][pattern_pos][leaf]`` stacked over periods) into the
port's modules, which is how the tests hold the two to the same weights.
Its leaves may be float32 or, under ``param_dtype="bfloat16"``,
``ml_dtypes.bfloat16``. Other block kinds (cross-attention, encoders)
come with later slices.

``param_dtype`` is honoured as the JAX package honours it, which casts
every leaf: projections and embeddings hold ``param_dtype``-rounded
values in the compute dtype (the reference casts them to it at each
use), the router and the recurrent leaves the reference uses in float32
hold them in float32, and the norm gains, the QAT scales and RG-LRU's
``lam`` are kept in ``param_dtype`` itself, where the reference computes
with them in that dtype (``1 + scale`` of a norm; ``s_q * s_k * scale``
of the streaming and direct attention paths; ``softplus(lam)``).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.attention import KVCacheState, PagedKVState
from repro_torch.device import resolve_device
from repro_torch.kernels.common import device_tensor
from repro_torch.models.attention import Attention
from repro_torch.models import moe as MOE
from repro_torch.models import rglru as RG
from repro_torch.models import rwkv6 as RW
from repro_torch.models.layers import (GeGLU, SwiGLU, const_param, embed,
                                       normal_param, rmsnorm, unembed)

# block kind -> the attention layer's kind (its window)
_ATTN_KINDS = {"attn": "global", "local": "local", "swa": "swa"}
_RECURRENT_KINDS = ("rglru", "rwkv")
_MLPS = {"swiglu": SwiGLU, "geglu": GeGLU}
# "moe": models.moe.MoE, built from cfg; "rwkv": the channel mix of an
# all-rwkv stack
_MLP_KINDS = (*_MLPS, "moe", "rwkv")


def _check_ported(cfg):
    kinds = {k for pat, _ in cfg.layer_groups for k in pat}
    blocks = (*_ATTN_KINDS, *_RECURRENT_KINDS)
    mlp_ok = cfg.mlp_type in _MLPS \
        or (cfg.mlp_type == "moe" and kinds <= set(_ATTN_KINDS)) \
        or (cfg.mlp_type == "rwkv" and kinds == {"rwkv"})
    if kinds - set(blocks) or not mlp_ok or cfg.norm_type != "rmsnorm" \
            or cfg.n_encoder_layers or cfg.frontend_dim \
            or cfg.sinusoidal_pos:
        raise NotImplementedError(
            f"{cfg.name}: this slice of the port builds decoders of "
            f"{blocks} blocks with {_MLP_KINDS} MLPs (moe under attention "
            f"blocks, rwkv for rwkv stacks) and RMSNorm; the other blocks "
            f"come with later slices (ROADMAP, \"Model breadth\")")


def layer_kinds(cfg):
    """Block kinds in execution order (group-major, then period, then
    pattern position)."""
    return [kind for pattern, n in cfg.layer_groups for _ in range(n)
            for kind in pattern]


def _has_post_norms(cfg) -> bool:
    return bool(cfg.attn_softcap) or cfg.name.startswith("gemma2")


def _norm(cfg, device):
    return const_param((cfg.d_model,), 0.0, dtype=cfg.param_torch_dtype(),
                       device=device)


class Block(nn.Module):
    """Pre-norm block: x + mix(norm1(x)), then x + mlp(norm2(x)). The
    mixer is attention (``attn``) for the attention kinds, with post-norms
    (gemma2) normed before each residual add: x + post_norm(branch); an
    RG-LRU (``mixer``, then the cfg's MLP) for ``rglru``; RWKV6's time mix
    (``mixer``) and channel mix (``mlp``) for ``rwkv``. A recurrent
    mixer takes no state in train mode and the cache's state otherwise,
    as the reference's does."""

    def __init__(self, cfg, kind, *, device, generator=None):
        super().__init__()
        self.kind = kind
        kw = dict(device=device, generator=generator)
        self.norm1 = _norm(cfg, device)
        if kind in _ATTN_KINDS:
            self.attn = Attention(cfg, **kw)
        elif kind == "rglru":
            self.mixer = RG.RGLRU(cfg, **kw)
        else:
            self.mixer = RW.TimeMix(cfg, **kw)
        self.norm2 = _norm(cfg, device)
        if kind == "rwkv":
            self.mlp = RW.ChannelMix(cfg, **kw)
        elif cfg.mlp_type == "moe":
            self.mlp = MOE.MoE(cfg, **kw)
        else:
            self.mlp = _MLPS[cfg.mlp_type](
                cfg.d_model, cfg.d_ff, dtype=cfg.compute_dtype(),
                param_dtype=cfg.param_torch_dtype(), **kw)
        if kind in _ATTN_KINDS and _has_post_norms(cfg):
            self.post_norm1 = _norm(cfg, device)
            self.post_norm2 = _norm(cfg, device)

    def _residual(self, x, y, post):
        post = getattr(self, post, None)
        return x + (y if post is None else rmsnorm(post, y))

    def forward(self, x, *, cfg, positions, cache, mode, lengths=None,
                live=None, q_lens=None):
        if self.kind in _RECURRENT_KINDS:
            return self._recurrent(x, cfg, cache, mode)
        h = rmsnorm(self.norm1, x)
        y, new_mix = self.attn(h, cfg=cfg, kind=_ATTN_KINDS[self.kind],
                               positions=positions,
                               cache=None if cache is None else cache["mix"],
                               mode=mode, lengths=lengths, live=live,
                               q_lens=q_lens)
        x = self._residual(x, y, "post_norm1")
        x = self._residual(x, self.mlp(rmsnorm(self.norm2, x)), "post_norm2")
        return x, (None if cache is None else dict(cache, mix=new_mix))

    def _recurrent(self, x, cfg, cache, mode):
        def state(key):
            return None if cache is None or mode == "train" \
                else cache.get(key)
        y, new_mix = self.mixer(rmsnorm(self.norm1, x), cfg, state("mix"))
        x = x + y
        h = rmsnorm(self.norm2, x)
        if self.kind == "rwkv":
            y, new_mlp = self.mlp(h, cfg, state("mlp"))
            x = x + y
            return x, (None if cache is None
                       else dict(cache, mix=new_mix, mlp=new_mlp))
        x = x + self.mlp(h)
        return x, (None if cache is None else dict(cache, mix=new_mix))


class Transformer(nn.Module):
    """Embedding, the blocks in execution order (group-major, then period,
    then pattern position), final norm and unembedding."""

    def __init__(self, cfg, *, device, generator=None):
        super().__init__()
        _check_ported(cfg)
        self.cfg = cfg
        kw = dict(dtype=cfg.compute_dtype(), device=device,
                  generator=generator, param_dtype=cfg.param_torch_dtype())
        self.embed = normal_param((cfg.vocab_size, cfg.d_model),
                                  cfg.d_model ** -0.5, **kw)
        if not cfg.tie_embeddings:
            self.unembed = normal_param((cfg.d_model, cfg.vocab_size),
                                        cfg.d_model ** -0.5, **kw)
        self.blocks = nn.ModuleList(
            Block(cfg, kind, device=device, generator=generator)
            for kind in layer_kinds(cfg))
        self.final_norm = _norm(cfg, device)

    def unembed_weight(self) -> torch.Tensor:
        return self.embed.T if self.cfg.tie_embeddings else self.unembed


def init_model(cfg, *, seed: int = 0, device="cuda") -> Transformer:
    """Random weights from ``seed`` at the JAX package's distributions
    (``scale · N(0, 1)`` projections, experts, routers and embeddings,
    zero biases and norm gains, 0.05 quantization scales), rounded to
    ``param_dtype`` and stored as the module docstring says, on
    ``device`` (default the card; raises when CUDA is missing)."""
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
    modules on ``device``. ``ml_dtypes.bfloat16`` leaves (``param_dtype=
    "bfloat16"``) widen to float32 through numpy, exactly, and then take
    the parameter's dtype."""
    dev = resolve_device(device)
    with torch.no_grad():
        model = Transformer(cfg, device=dev)

        def put(param, array):
            a = np.array(array)
            if a.dtype.name == "bfloat16":      # torch cannot take it
                a = a.astype(np.float32)
            param.copy_(torch.from_numpy(a).to(param.dtype))

        put(model.embed, tree["embed"]["table"])
        if not cfg.tie_embeddings:
            put(model.unembed, tree["embed"]["unembed"])
        put(model.final_norm, tree["final_norm"]["scale"])
        for i, blk in _layer_leaves(tree, cfg):
            mine = model.blocks[i]
            for norm in ("norm1", "norm2", "post_norm1", "post_norm2"):
                if norm in blk:
                    put(getattr(mine, norm), blk[norm]["scale"])
            for mod in ("attn", "mixer", "mlp"):
                for leaf, a in blk.get(mod, {}).items():
                    put(getattr(getattr(mine, mod), leaf), a)
    return model


def init_caches(cfg, batch: int, max_len: int, *, paged: bool = False,
                page_size: int = 128, num_pages: int | None = None,
                device="cuda"):
    """One cache per layer, in execution order. An attention layer's is
    ``{"mix": KVCacheState}``, a ring, or with ``paged=True`` a
    ``PagedKVState`` pool (one arena and page table per layer,
    ``num_pages`` pages each; None provisions fully) — int8 for the
    quantized impls, the compute dtype for float. A ``local``/``swa``
    layer's capacity is ``min(max_len, window)``: its window caps what it
    keeps. A recurrent layer holds its zero state, the reference's
    shapes and dtypes: ``{"mix": {"h" (B, dr) float32, "conv" (B, 3, dr)
    compute dtype}}`` for ``rglru``, ``{"mix": {"shift" (B, d), "s"
    (B, H, dh, dh)}, "mlp": {"shift" (B, d)}}`` in float32 for
    ``rwkv``."""
    dev = resolve_device(device)
    _check_ported(cfg)
    kv_dt = torch.int8 if cfg.attention_impl != "float" \
        else cfg.compute_dtype()
    capacity = {"attn": max_len, "local": min(max_len, cfg.local_window),
                "swa": min(max_len, cfg.window)}

    def kv_cache(size):
        if paged:
            return PagedKVState.init(batch, size, cfg.n_kv_heads,
                                     cfg.head_dim, dtype=kv_dt, device=dev,
                                     page_size=page_size,
                                     num_pages=num_pages)
        return KVCacheState.init(batch, size, cfg.n_kv_heads,
                                 cfg.head_dim, dtype=kv_dt, device=dev)

    def layer(kind):
        if kind == "rglru":
            return {"mix": RG.init_rglru_state(batch, cfg,
                                               cfg.compute_dtype(),
                                               device=dev)}
        if kind == "rwkv":
            st = RW.init_rwkv_state(batch, cfg, device=dev)
            return {"mix": st["tm"], "mlp": st["cm"]}
        return {"mix": kv_cache(capacity[kind])}
    return [layer(kind) for kind in layer_kinds(cfg)]


def embed_scale(cfg, dtype, device) -> torch.Tensor:
    """The embeddings' factor ``sqrt(d_model)``, rounded to the compute
    dtype as the JAX package rounds it (68.0 for gemma2-27b's 67.88 in
    bf16)."""
    return torch.full((), float(np.sqrt(cfg.d_model)), dtype=dtype,
                      device=device)


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
    if cfg.embed_scale:
        x = x * embed_scale(cfg, x.dtype, dev)
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


def moe_aux_loss(model: Transformer, tokens, cfg) -> torch.Tensor:
    """The MoE load-balance loss the JAX package's ``forward`` returns as
    ``aux`` in train mode: ``models.moe.moe_aux_loss`` of each MoE block
    on its normed MLP input, summed over blocks (float32 0-d; 0 without
    MoE blocks). A function only: ``loss_fn`` and training come with a
    later slice."""
    inputs = []
    handles = [blk.mlp.register_forward_pre_hook(
        lambda mod, inp: inputs.append((mod, inp[0])))
        for blk in model.blocks if isinstance(blk.mlp, MOE.MoE)]
    try:
        forward(model, tokens, cfg, mode="train")
    finally:
        for h in handles:
            h.remove()
    total = torch.zeros((), dtype=torch.float32, device=model.embed.device)
    for mod, x in inputs:
        total = total + MOE.moe_aux_loss(x, mod.router, mod.k)
    return total
