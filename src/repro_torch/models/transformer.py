"""Model assembly (``repro.models.transformer``) for decoders of
attention blocks (``attn`` global, ``local``/``swa`` sliding window),
recurrent blocks (``rglru``: RG-LRU, ``models.rglru``; ``rwkv``: RWKV6
time and channel mix, ``models.rwkv6``) and cross-attention blocks
(``cross``: llama-vision's gated cross-attention layer; ``attn_cross``:
whisper's self attention, cross attention and MLP), in layer groups, run
by a Python loop over layers where the JAX package scans period-stacked
parameters. The MLP of a block is SwiGLU, GeGLU, the biased GELU MLP or,
with ``mlp_type="moe"``, the mixture of experts of ``models.moe``; an
RWKV block's is its channel mix. Gemma2's extras are here too: post-norms
on both residual branches, scaled embeddings and the final logit
softcap; whisper's: LayerNorm, sinusoidal positions and an encoder.

An encoder–decoder model takes a ``frontend`` (B, n_frontend_tokens,
frontend_dim): the stubbed frontend's embeddings (whisper's 1500 audio
frames, llama-vision's 1601 patch embeddings). ``_encode`` projects it
(``frontend_proj``, when ``frontend_dim != d_model``) and, with encoder
layers, adds sinusoidal positions and runs the bidirectional ``enc``
stack in train mode, as the reference does even when it serves (its
attention is the QAT forward of ``ita_chunked_xla`` under ITA). The
memory feeds the cross layers at prefill, which write it into their
static int8 caches; a decode step reads only those caches.

    model = init_model(cfg, seed=0)                  # on the card
    caches = init_caches(cfg, batch, max_len)        # one ring per attention
                                                     # layer (paged=True:
                                                     # pools), state per
                                                     # recurrent layer, the
                                                     # static cross caches
    logits, caches = forward(model, tokens, cfg, mode="prefill",
                             caches=caches, frontend=frontend)

``from_jax_params`` loads a parameter pytree of the JAX package (numpy
arrays, ``groups[g][pattern_pos][leaf]`` stacked over periods; the
encoder's ``encoder.groups[0][0]`` over its layers) into the port's
modules, which is how the tests hold the two to the same weights. Its
leaves may be float32 or, under ``param_dtype="bfloat16"``,
``ml_dtypes.bfloat16``.

Under a mesh (``launch.hints``; the parameters are local shards, see
``launch.steps.local_params``) each block's parameters are gathered for
its call (``hints.gathered``; inside the remat function, so the backward
gathers again), the embedding and unembedding keep their vocabulary
split over ``model`` (a vocabulary-parallel lookup and cross entropy;
the logits leave this rank's columns, the reference's ``vocab``
constraint), and the residual stream stays whole on every rank of
``model`` (the reference's ``batch``/``seq`` constraints at the block
boundary and after the final norm move nothing in the port).

``param_dtype`` is honoured as the JAX package honours it, which casts
every leaf: projections, biases and embeddings hold ``param_dtype``-
rounded values in the compute dtype (the reference casts them to it at
each use), the router and the recurrent leaves the reference uses in
float32 hold them in float32, and the norm gains and biases, the QAT
scales, the cross gates and RG-LRU's ``lam`` are kept in ``param_dtype``
itself, where the reference computes with them in that dtype (``1 +
scale`` of a norm; ``s_q * s_k * scale`` of the streaming and direct
attention paths; ``tanh(gate)``; ``softplus(lam)``).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.attention import KVCacheState, PagedKVState
from repro_torch.device import resolve_device
from repro_torch.kernels.common import device_tensor
from repro_torch.launch import hints
from repro_torch.models.attention import Attention
from repro_torch.models import moe as MOE
from repro_torch.models import rglru as RG
from repro_torch.models import rwkv6 as RW
from repro_torch.models.layers import (GeGLU, GeluMLP, LayerNorm, SwiGLU,
                                       apply_norm, const_param, embed,
                                       linear, normal_param,
                                       sinusoidal_at, sinusoidal_positions,
                                       unembed)

# self-attention block kind -> the attention layer's kind (its window);
# "enc" is the encoder's (run non-causally)
_ATTN_KINDS = {"attn": "global", "enc": "global", "local": "local",
               "swa": "swa"}
_CROSS_KINDS = ("cross", "attn_cross")
_RECURRENT_KINDS = ("rglru", "rwkv")
_KINDS = (*_ATTN_KINDS, *_CROSS_KINDS, *_RECURRENT_KINDS)
# a non-gated mlp_type is the biased GELU MLP, as the reference's
# init_mlp/apply_mlp read it
_GATED = {"swiglu": SwiGLU, "geglu": GeGLU}


def _check_ported(cfg):
    """An unknown block kind raises ``ValueError(kind)``, as the
    reference's ``init_block`` does."""
    for pattern, _ in cfg.layer_groups:
        for kind in pattern:
            if kind not in _KINDS:
                raise ValueError(kind)


def has_cross(cfg) -> bool:
    """Whether the stack has cross-attention layers (which need a
    frontend's memory at prefill)."""
    return any(k in _CROSS_KINDS for pat, _ in cfg.layer_groups
               for k in pat)


def layer_kinds(cfg):
    """Block kinds in execution order (group-major, then period, then
    pattern position)."""
    return [kind for pattern, n in cfg.layer_groups for _ in range(n)
            for kind in pattern]


def _has_post_norms(cfg) -> bool:
    return bool(cfg.attn_softcap) or cfg.name.startswith("gemma2")


def _norm(cfg, device):
    """A block's norm: RMSNorm's gain (zeros: ``1 + scale``) or a
    ``LayerNorm`` (scale and bias), in ``param_dtype``."""
    if cfg.norm_type == "rmsnorm":
        return const_param((cfg.d_model,), 0.0,
                           dtype=cfg.param_torch_dtype(), device=device)
    return LayerNorm(cfg.d_model, dtype=cfg.param_torch_dtype(),
                     device=device)


def _mlp(cfg, kind, kw):
    """The block's MLP as the reference builds it: RWKV's channel mix, the
    MoE under self-attention kinds, SwiGLU in a cross block of a MoE
    stack, else the cfg's gated MLP or the biased GELU MLP."""
    if kind == "rwkv":
        return RW.ChannelMix(cfg, **kw)
    mlp_type = cfg.mlp_type
    if mlp_type == "moe":
        if kind in _ATTN_KINDS:
            return MOE.MoE(cfg, **kw)
        if kind == "cross":
            mlp_type = "swiglu"
    cls = _GATED.get(mlp_type, GeluMLP)
    return cls(cfg.d_model, cfg.d_ff, dtype=cfg.compute_dtype(),
               param_dtype=cfg.param_torch_dtype(), **kw)


class Block(nn.Module):
    """Pre-norm block: x + mix(norm1(x)), then x + mlp(norm2(x)). The
    mixer is attention (``attn``) for the self-attention kinds, with
    post-norms (gemma2) normed before each residual add: x +
    post_norm(branch); cross-attention over the memory for ``cross``,
    both branches scaled by ``tanh`` of their gates (``gate_attn``,
    ``gate_mlp``); self attention, then ``norm_x`` and cross attention
    (``xattn``), then the MLP for ``attn_cross``; an RG-LRU (``mixer``,
    then the cfg's MLP) for ``rglru``; RWKV6's time mix (``mixer``) and
    channel mix (``mlp``) for ``rwkv``. A recurrent mixer takes no state
    in train mode and the cache's state otherwise, as the reference's
    does."""

    def __init__(self, cfg, kind, *, device, generator=None):
        super().__init__()
        self.kind = kind
        kw = dict(device=device, generator=generator)
        self.norm1 = _norm(cfg, device)
        if kind in _ATTN_KINDS or kind in _CROSS_KINDS:
            self.attn = Attention(cfg, **kw)
        elif kind == "rglru":
            self.mixer = RG.RGLRU(cfg, **kw)
        else:
            self.mixer = RW.TimeMix(cfg, **kw)
        if kind == "attn_cross":
            self.norm_x = _norm(cfg, device)
            self.xattn = Attention(cfg, **kw)
        self.norm2 = _norm(cfg, device)
        self.mlp = _mlp(cfg, kind, kw)
        if kind == "cross":
            for gate in ("gate_attn", "gate_mlp"):
                setattr(self, gate, const_param(
                    (), 0.0, dtype=cfg.param_torch_dtype(), device=device))
        if kind in _ATTN_KINDS and _has_post_norms(cfg):
            self.post_norm1 = _norm(cfg, device)
            self.post_norm2 = _norm(cfg, device)

    def _residual(self, x, y, post):
        post = getattr(self, post, None)
        return x + (y if post is None else apply_norm(post, y))

    def _gated(self, y, gate):
        gate = getattr(self, gate, None)
        return y if gate is None else y * torch.tanh(gate).to(y.dtype)

    def forward(self, x, *, cfg, positions, cache, mode, mem=None,
                lengths=None, live=None, q_lens=None, aux=None):
        """Returns ``(x, new_cache)``. ``aux``: a list the block appends
        its MoE load-balance loss to (train mode; a MoE block only)."""
        if self.kind in _RECURRENT_KINDS:
            return self._recurrent(x, cfg, cache, mode)
        h = apply_norm(self.norm1, x)
        cross = self.kind == "cross"
        y, new_mix = self.attn(h, cfg=cfg,
                               kind="cross" if cross
                               else _ATTN_KINDS.get(self.kind, "global"),
                               positions=positions, mem=mem,
                               cache=None if cache is None else cache["mix"],
                               mode=mode, lengths=lengths, live=live,
                               q_lens=q_lens)
        x = self._residual(x, self._gated(y, "gate_attn"), "post_norm1")
        new_cross = None
        if self.kind == "attn_cross":
            y, new_cross = self.xattn(
                apply_norm(self.norm_x, x), cfg=cfg, kind="cross", mem=mem,
                cache=None if cache is None else cache["cross"], mode=mode)
            x = x + y
        h = apply_norm(self.norm2, x)
        y = self._gated(self.mlp(h), "gate_mlp")
        x = self._residual(x, y, "post_norm2")
        if aux is not None and isinstance(self.mlp, MOE.MoE):
            aux.append(MOE.moe_aux_loss(h, self.mlp.router, self.mlp.k))
        if cache is None:
            return x, None
        if self.kind == "attn_cross":
            return x, dict(cache, mix=new_mix, cross=new_cross)
        return x, dict(cache, mix=new_mix)

    def _recurrent(self, x, cfg, cache, mode):
        def state(key):
            return None if cache is None or mode == "train" \
                else cache.get(key)
        y, new_mix = self.mixer(apply_norm(self.norm1, x), cfg,
                                state("mix"))
        x = x + y
        h = apply_norm(self.norm2, x)
        if self.kind == "rwkv":
            y, new_mlp = self.mlp(h, cfg, state("mlp"))
            x = x + y
            return x, (None if cache is None
                       else dict(cache, mix=new_mix, mlp=new_mlp))
        x = x + self.mlp(h)
        return x, (None if cache is None else dict(cache, mix=new_mix))


class Transformer(nn.Module):
    """Embedding, the blocks in execution order (group-major, then period,
    then pattern position), final norm and unembedding; with a frontend,
    ``frontend_proj`` (frontend_dim, d_model) when the widths differ, and
    with encoder layers the ``encoder`` blocks and ``encoder_norm``."""

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
        if cfg.n_encoder_layers:
            self.encoder = nn.ModuleList(
                Block(cfg, "enc", device=device, generator=generator)
                for _ in range(cfg.n_encoder_layers))
            self.encoder_norm = _norm(cfg, device)
        if cfg.frontend_dim and cfg.frontend_dim != cfg.d_model:
            self.frontend_proj = normal_param(
                (cfg.frontend_dim, cfg.d_model), cfg.frontend_dim ** -0.5,
                **kw)

    def unembed_weight(self) -> torch.Tensor:
        """The unembedding (d, V) (under a mesh, gathered as
        ``hints.param`` gathers it: vocabulary-parallel columns)."""
        if not self.cfg.tie_embeddings:
            return hints.param(self.unembed)
        table = hints.param(self.embed)
        w = table.T
        if hints.tp_dim(table) is not None:
            w._tp_dim = 1
        return w


def init_model(cfg, *, seed: int = 0, device="cuda") -> Transformer:
    """Random weights from ``seed`` at the JAX package's distributions
    (``scale · N(0, 1)`` projections, experts, routers and embeddings,
    zero biases, norm gains and cross gates, 0.05 quantization scales),
    rounded to ``param_dtype`` and stored as the module docstring says,
    on ``device`` (default the card; raises when CUDA is missing)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    with torch.no_grad():
        return Transformer(cfg, device=dev, generator=gen)


def _layer_leaves(groups, layer_groups):
    """Yield (flat layer index, block param dict of numpy arrays: a dict
    of leaves per module, an array per bare leaf such as a gate)."""
    def at(a, period):
        return np.asarray(a)[period]
    idx = 0
    for g, (pattern, n) in enumerate(layer_groups):
        for period in range(n):
            for pos in range(len(pattern)):
                blk = groups[g][pos]
                yield idx, {
                    mod: ({leaf: at(a, period) for leaf, a in sub.items()}
                          if isinstance(sub, dict) else at(sub, period))
                    for mod, sub in blk.items()}
                idx += 1


def jax_named_leaves(tree, cfg):
    """Yield ``(name, array)``: each leaf of a JAX-package parameter
    pytree (or of a tree of its layout: gradients, Adam's moments, the
    master copy) under the name of the port's parameter it maps to
    (``model.named_parameters()``), one block's slice of the stacked
    leaves at a time."""
    def norm(prefix, leaves):
        if cfg.norm_type == "rmsnorm":
            yield prefix, leaves["scale"]
        else:
            yield f"{prefix}.scale", leaves["scale"]
            yield f"{prefix}.bias", leaves["bias"]

    def blocks(prefix, groups, layer_groups):
        for i, blk in _layer_leaves(groups, layer_groups):
            for mod, leaves in blk.items():
                name = f"{prefix}.{i}.{mod}"
                if mod.startswith(("norm", "post_norm")):
                    yield from norm(name, leaves)
                elif isinstance(leaves, dict):
                    for leaf, a in leaves.items():
                        yield f"{name}.{leaf}", a
                else:                           # a gate
                    yield name, leaves

    yield "embed", tree["embed"]["table"]
    if not cfg.tie_embeddings:
        yield "unembed", tree["embed"]["unembed"]
    yield from norm("final_norm", tree["final_norm"])
    yield from blocks("blocks", tree["groups"], cfg.layer_groups)
    if cfg.n_encoder_layers:
        yield from blocks("encoder", tree["encoder"]["groups"],
                          ((("enc",), cfg.n_encoder_layers),))
        yield from norm("encoder_norm", tree["encoder"]["final_norm"])
    if cfg.frontend_dim and cfg.frontend_dim != cfg.d_model:
        yield "frontend_proj", tree["frontend_proj"]


def host_array(array) -> np.ndarray:
    """A numpy copy; ``ml_dtypes.bfloat16`` widened to float32, exactly
    (torch cannot take it)."""
    a = np.array(array)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def from_jax_params(tree, cfg, *, device="cuda") -> Transformer:
    """Load a JAX-package parameter pytree (numpy arrays; per group, per
    pattern position, leaves stacked over ``n_periods``) into the port's
    modules on ``device``. ``ml_dtypes.bfloat16`` leaves (``param_dtype=
    "bfloat16"``) widen to float32 through numpy, exactly, and then take
    the parameter's dtype."""
    dev = resolve_device(device)
    with torch.no_grad():
        model = Transformer(cfg, device=dev)
        params = dict(model.named_parameters())
        for name, array in jax_named_leaves(tree, cfg):
            param = params[name]
            param.copy_(torch.from_numpy(host_array(array))
                        .to(param.dtype))
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
    ``rwkv``. A ``cross`` layer's is ``{"mix": {"k8", "v8"}}``, its
    static memory cache of (B, n_frontend_tokens, G, hd) zeros in the KV
    dtype (never paged); an ``attn_cross`` layer's ``{"mix": ring or
    pool, "cross": {"k8", "v8"}}``."""
    dev = resolve_device(device)
    _check_ported(cfg)
    kv_dt = torch.int8 if cfg.attention_impl != "float" \
        else cfg.compute_dtype()
    capacity = {"attn": max_len, "enc": max_len,
                "local": min(max_len, cfg.local_window),
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
        if kind == "cross":
            return {"mix": cross_cache()}
        if kind == "attn_cross":
            return {"mix": kv_cache(max_len), "cross": cross_cache()}
        return {"mix": kv_cache(capacity[kind])}

    def cross_cache():
        shape = (batch, cfg.n_frontend_tokens, cfg.n_kv_heads,
                 cfg.head_dim)
        return {"k8": torch.zeros(shape, dtype=kv_dt, device=dev),
                "v8": torch.zeros(shape, dtype=kv_dt, device=dev)}
    return [layer(kind) for kind in layer_kinds(cfg)]


def embed_scale(cfg, dtype, device) -> torch.Tensor:
    """The embeddings' factor ``sqrt(d_model)``, rounded to the compute
    dtype as the JAX package rounds it (68.0 for gemma2-27b's 67.88 in
    bf16)."""
    return torch.full((), float(np.sqrt(cfg.d_model)), dtype=dtype,
                      device=device)


def _encode(model: Transformer, cfg, frontend):
    """The memory the cross layers attend: the frontend (B, S_mem,
    frontend_dim) in the compute dtype, projected by ``frontend_proj``
    when present; with encoder layers, plus the numpy sinusoidal
    positions, through the encoder stack (non-causal, train mode) and its
    final norm."""
    dev, dt = model.embed.device, cfg.compute_dtype()
    mem = torch.as_tensor(frontend, device=dev).to(dt)
    if hasattr(model, "frontend_proj"):
        mem = linear(mem, hints.param(model.frontend_proj))
    if cfg.n_encoder_layers:
        s = mem.shape[1]
        if cfg.sinusoidal_pos:
            pos = sinusoidal_positions(s, cfg.d_model)
            mem = mem + torch.from_numpy(pos).to(device=dev, dtype=dt)
        enc_cfg = dataclasses.replace(cfg, causal=False)   # bidirectional
        positions = torch.arange(s, dtype=torch.int32, device=dev)
        for blk in model.encoder:
            mem, _ = _train_block(blk, mem, enc_cfg, positions, None)
        mem = _final_norm(model.encoder_norm, mem)
    return mem


def _final_norm(norm, x):
    """A norm outside the blocks, its parameters gathered under a mesh."""
    if isinstance(norm, nn.Module):
        with hints.gathered(norm):
            return apply_norm(norm, x)
    return apply_norm(hints.param(norm), x)


# ``remat_policy="dots"``: the products a block's checkpoint keeps from
# its forward, the counterpart of JAX's
# ``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``. A matrix
# product with no batch dimension is an aten ``mm`` or ``addmm`` (the
# 128-row blocks of ``linear``, the router, the cross layers' K/V
# projections of the memory); batched products (``bmm``: the QAT
# attention, the expert FFN), collectives and every other op are
# recomputed in the backward, as JAX recomputes them.
DOTS_SAVED = frozenset({torch.ops.aten.mm.default,
                        torch.ops.aten.addmm.default})
REMAT_POLICIES = ("full", "dots")


def _dots_policy(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in DOTS_SAVED \
        else CheckpointPolicy.PREFER_RECOMPUTE


def remat_kwargs(cfg) -> dict:
    """``torch.utils.checkpoint.checkpoint``'s policy arguments for
    ``cfg.remat_policy``: ``"full"`` recomputes the whole block,
    ``"dots"`` keeps the ``DOTS_SAVED`` outputs (selective activation
    checkpointing). Any other policy raises ``ValueError``."""
    if cfg.remat_policy not in REMAT_POLICIES:
        raise ValueError(f"unknown remat_policy {cfg.remat_policy!r}; "
                         f"expected one of {REMAT_POLICIES}")
    if cfg.remat_policy == "dots":
        return {"context_fn": functools.partial(
            create_selective_checkpoint_contexts, _dots_policy)}
    return {}


def _train_block(blk, x, cfg, positions, mem):
    """One block in train mode: ``(x, its MoE load-balance loss or
    None)``. With ``cfg.remat`` and autograd on, the block runs under
    ``torch.utils.checkpoint`` (``jax.checkpoint`` of the reference's
    scan body) with ``remat_kwargs(cfg)``: ``"full"`` recomputes all of
    its forward in the backward, ``"dots"`` all of it but the products
    ``DOTS_SAVED`` names, whose outputs it keeps. Either changes memory
    and time, never the gradients: a kept output has the bits its
    recompute would have."""
    def run(x, mem):
        got = []
        with hints.gathered(blk):           # per layer, again under remat
            y, _ = blk(x, cfg=cfg, positions=positions, cache=None,
                       mode="train", mem=mem, aux=got)
        return y, (got[0] if got else None)
    if cfg.remat and torch.is_grad_enabled():
        return checkpoint(run, x, mem, use_reentrant=False,
                          **remat_kwargs(cfg))
    return run(x, mem)


def forward(model: Transformer, tokens, cfg, *, mode="train", caches=None,
            frontend=None, pos0=None, lengths=None, live=None, q_lens=None,
            skip_unembed=False, return_aux=False):
    """tokens (B, S) int. Returns ``(logits (B, S, V) float32,
    new_caches)``. ``frontend`` (B, S_mem, frontend_dim): the stubbed
    frontend's embeddings, encoded into the cross layers' memory (needed
    by every mode of a stack with cross layers but decode over filled
    cross caches, which reads the caches alone). ``pos0``: the first
    token's position, a scalar or a (B,) per-sequence vector (ragged
    decode). ``lengths`` (B,): ragged prefill of right-padded prompts.
    ``live`` (B,) bool: decode-time slot mask of continuous batching
    (dead slots neither write their caches nor advance). ``q_lens`` (B,)
    int32: the mixed chunked-prefill step over paged caches (row ``b``
    holds ``q_lens[b]`` real tokens). ``skip_unembed`` returns the
    final-norm hidden states (B, S, d) in place of the logits (the mixed
    step unembeds one row per sequence, ``unembed(model.unembed_weight(),
    x)``). ``return_aux`` appends the MoE load-balance loss of train mode
    (float32 0-d: each MoE block's ``models.moe.moe_aux_loss`` of its
    normed MLP input, summed per layer group and over groups as the
    reference's scans sum it; 0 without MoE blocks or outside train
    mode). Train mode without caches runs each block through
    ``_train_block`` (remat)."""
    dev = model.embed.device
    tokens = torch.as_tensor(tokens, device=dev).long()
    x = embed(hints.param(model.embed), tokens)
    if cfg.embed_scale:
        x = x * embed_scale(cfg, x.dtype, dev)
    s = tokens.shape[1]
    ar = torch.arange(s, dtype=torch.int32, device=dev)
    if pos0 is None:
        positions = ar
    else:
        pos0 = device_tensor(pos0, torch.int32, dev)
        positions = pos0[..., None] + ar if pos0.ndim else pos0 + ar
    if cfg.sinusoidal_pos:
        # from the (possibly per-row) positions on the device, so decode
        # takes them too
        pe = sinusoidal_at(positions, cfg.d_model)
        x = x + (pe if pe.ndim == 3 else pe[None]).to(x.dtype)
    mem = None if frontend is None else _encode(model, cfg, frontend)
    new_caches = [] if caches is not None else None
    train = mode == "train" and caches is None

    def zero():
        return torch.zeros((), dtype=torch.float32, device=dev)
    aux_total = zero() if return_aux else None
    start = 0
    for pattern, n in cfg.layer_groups:
        stop = start + len(pattern) * n
        aux = zero() if return_aux else None
        for i in range(start, stop):
            blk = model.blocks[i]
            if train:
                x, a = _train_block(blk, x, cfg, positions, mem)
                if a is not None and return_aux:
                    aux = aux + a
                continue
            with hints.gathered(blk):
                x, nc = blk(x, cfg=cfg, positions=positions,
                            cache=None if caches is None else caches[i],
                            mode=mode, mem=mem, lengths=lengths, live=live,
                            q_lens=q_lens)
            if new_caches is not None:
                new_caches.append(nc)
        if return_aux:
            aux_total = aux_total + aux
        start = stop
    x = _final_norm(model.final_norm, x)
    out = x if skip_unembed \
        else unembed(model.unembed_weight(), x, cfg.logit_softcap)
    return (out, new_caches, aux_total) if return_aux else (out, new_caches)


def _ce(logits, targets, vocab_parallel=False):
    """Summed cross entropy of float32 ``logits`` (B, S, V) at the int
    ``targets`` (B, S): ``logsumexp - gold logit``. ``vocab_parallel``:
    the logits are this rank's columns of the vocabulary (``hints``),
    and the max, the sum of exponentials and the gold logit are reduced
    over ``model``."""
    if not vocab_parallel:
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
        return (logz - gold).sum()
    n = logits.shape[-1]
    with torch.no_grad():
        top = hints.all_reduce(logits.amax(dim=-1), "model", op="max")
    logz = torch.log(hints.reduce_tp(
        torch.exp(logits - top[..., None]).sum(dim=-1))) + top
    local = targets.long() - hints.tp_rank() * n
    inside = (local >= 0) & (local < n)
    gold = torch.gather(logits, -1, local.clamp(0, n - 1)[..., None])[..., 0]
    gold = hints.reduce_tp(torch.where(inside, gold, gold.new_zeros(())))
    return (logz - gold).sum()


def _chunk_ce(w, x, targets, softcap, vocab_parallel):
    return _ce(unembed(w, x, softcap), targets, vocab_parallel)


def loss_fn(model: Transformer, batch, cfg, aux_weight: float = 0.01):
    """Causal-LM cross entropy of ``batch["tokens"]`` (B, S+1) (shifted
    inside; ``batch["frontend"]`` for a stack with cross layers), plus
    ``aux_weight`` times the MoE load-balance loss of the same forward.
    Returns ``(loss, {"nll", "aux"})``, float32 0-d tensors.

    ``cfg.ce_chunks > 1`` evaluates the unembedding and the cross entropy
    in that many sequence chunks (fewer when the chunks would not divide
    the sequence), each recomputed in the backward, so the (B, S, V)
    float32 logits never exist whole.

    Under a mesh (``hints``) the batch is this rank's chunk: ``nll`` is
    its share of the global mean (the shares sum to it), ``aux`` the
    global value."""
    tokens = torch.as_tensor(batch["tokens"], device=model.embed.device)
    targets = tokens[:, 1:]
    count = targets.numel() * hints.batch_ranks()
    frontend = batch.get("frontend")
    vp = hints.tp_size() > 1 and hints.tp_dim(
        model.embed if cfg.tie_embeddings else model.unembed) is not None
    if cfg.ce_chunks <= 1:
        logits, _, aux = forward(model, tokens[:, :-1], cfg, mode="train",
                                 frontend=frontend, return_aux=True)
        nll = _ce(logits, targets, vp) / count
        return nll + aux_weight * aux, {"nll": nll, "aux": aux}
    x, _, aux = forward(model, tokens[:, :-1], cfg, mode="train",
                        frontend=frontend, skip_unembed=True,
                        return_aux=True)
    s = x.shape[1]
    nc = cfg.ce_chunks
    while s % nc:
        nc -= 1
    c = s // nc
    w = model.unembed_weight()
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(nc):
        part = (w, x[:, i * c:(i + 1) * c], targets[:, i * c:(i + 1) * c],
                cfg.logit_softcap, vp)
        tot = tot + (checkpoint(_chunk_ce, *part, use_reentrant=False)
                     if torch.is_grad_enabled() else _chunk_ce(*part))
    nll = tot / count
    return nll + aux_weight * aux, {"nll": nll, "aux": aux}


def moe_aux_loss(model: Transformer, tokens, cfg) -> torch.Tensor:
    """The MoE load-balance loss the JAX package's ``forward`` returns as
    ``aux`` in train mode (float32 0-d; 0 without MoE blocks): one train
    forward of ``tokens`` with ``return_aux``. ``loss_fn`` takes it from
    its own forward."""
    return forward(model, tokens, cfg, mode="train", return_aux=True)[2]
