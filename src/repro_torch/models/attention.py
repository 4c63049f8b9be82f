"""Multi-head attention layer (``repro.models.attention``): projections,
RoPE and KV-cache bookkeeping around the attention engine.

With ``attention_impl="ita"`` Q/K/V are quantized to int8 and attention is
ITA's integer pipeline; the KV cache stores int8. Which backend serves a
call is the registry's decision (``cfg.attention_backend`` pins one where
it is capable). Branches: no cache (a plain forward), prefill (attend the
prompt, then write the ring), the mixed chunk of the serve step
(``q_lens``: append per-row ragged widths into the paged pool, then
attend through the ragged-q paged kernel) and decode (append, then
attend the ring or, for a ``PagedKVState``, the pool through its page
table; ``live`` masks dead slots). Cross-attention (``kind="cross"``)
takes K/V from the memory ``mem`` (the encoder's output or the projected
patch embeddings), is non-causal and takes no RoPE; its cache is the
static ``{"k8", "v8"}`` pair of (B, n_frontend_tokens, G, hd), written
at every prefill and only read at decode, where the layer projects no
K/V at all.

Under a mesh (``launch.hints``; the parameters are this rank's shards,
gathered per layer) the reference's head constraints are tensor
parallelism when the query heads divide ``model``: ``wq`` (and ``bq``)
hold this rank's heads, so the projection is a local column product, the
kernels run on the local heads (heads are independent: these calls are
bit for bit what the unsharded call computes for those heads), and the
row-parallel ``wo`` product is all-reduced over ``model`` at the
reference's output constraint. K/V heads that divide ``model`` are local
the same way; those that do not stay whole on every rank (as do their
caches), and each rank reads the K/V heads of its query heads. Where the
query heads do not divide ``model`` the reference shards the query over
``seq``; the port gathers the weights and runs the layer whole on every
rank (the kernels' signatures take no per-rank row offset of a prefill).
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch import attention as ATT
from repro_torch.attention.xla import quantize_to_int8
from repro_torch.launch import hints
from repro_torch.models.layers import const_param, linear, normal_param, rope


def make_spec(cfg, *, mode, causal, window, q_len=None, has_s_out=True,
              layout="bshd", ragged_q=False,
              n_heads=None) -> ATT.AttentionSpec:
    """The layer's view of the engine: one spec per (cfg, call site);
    ``n_heads``: the call's query heads (default the config's)."""
    return ATT.AttentionSpec(
        mode=mode, impl=cfg.attention_impl, causal=causal, window=window,
        softcap=cfg.attn_softcap, query_scale=cfg.query_scale,
        softmax="paper" if cfg.softmax_impl == "ita_paper" else "adaptive",
        layout=layout, scale_kind="per_tensor", out_dtype="float",
        has_s_out=has_s_out, q_len=q_len, n_heads=n_heads or cfg.n_heads,
        ragged_q=ragged_q)


class Attention(nn.Module):
    """Weights in the JAX layout: ``wq`` (d, H·hd), ``wk``/``wv``
    (d, G·hd), ``wo`` (H·hd, d); biases; the QAT scales ``s_q``, ``s_k``,
    ``s_v``, ``s_out`` (0-d, in ``param_dtype`` as the reference keeps
    them: under ``"bfloat16"`` 0.05 is 0.050048828125, and the streaming
    and direct paths form ``s_q * s_k * scale`` in bfloat16) of the
    quantized impls."""

    def __init__(self, cfg, *, device, generator=None):
        super().__init__()
        d, h, g, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        kw = dict(dtype=cfg.compute_dtype(), device=device,
                  generator=generator, param_dtype=cfg.param_torch_dtype())
        self.wq = normal_param((d, h * hd), d ** -0.5, **kw)
        self.wk = normal_param((d, g * hd), d ** -0.5, **kw)
        self.wv = normal_param((d, g * hd), d ** -0.5, **kw)
        self.wo = normal_param((h * hd, d), (h * hd) ** -0.5, **kw)
        if cfg.qkv_bias:
            for name, n in (("bq", h * hd), ("bk", g * hd), ("bv", g * hd)):
                setattr(self, name, const_param(
                    (n,), 0.0, dtype=cfg.compute_dtype(), device=device))
        if cfg.attention_impl != "float":
            for name in ("s_q", "s_k", "s_v", "s_out"):
                setattr(self, name, const_param(
                    (), 0.05, dtype=cfg.param_torch_dtype(), device=device))

    def scales(self) -> ATT.QuantScales:
        return ATT.QuantScales(s_q=getattr(self, "s_q", None),
                               s_k=getattr(self, "s_k", None),
                               s_v=getattr(self, "s_v", None),
                               s_out=getattr(self, "s_out", None))

    def forward(self, x, *, cfg, kind="global", positions=None, mem=None,
                cache=None, mode="train", lengths=None, live=None,
                q_lens=None):
        """Returns ``(y, new_cache)``. ``cfg`` is the call's config (its
        ``attention_backend`` pin applies per call, as in the JAX
        package). ``kind``: global | local | swa | cross (K/V from
        ``mem`` (B, S_mem, d)). ``cache``: a ``KVCacheState`` ring or a
        ``PagedKVState`` pool (int8 for quantized impls), or a cross
        layer's ``{"k8", "v8"}``. ``lengths`` (B,): ragged prefill of
        right-padded prompts. ``live`` (B,) bool: decode-time slot mask
        (dead slots write nothing and keep their position). ``q_lens``
        (B,): the mixed chunked-prefill step over a paged pool — row ``b``
        carries ``q_lens[b]`` real tokens of the presented width."""
        hd = cfg.head_dim
        cross = kind == "cross"
        window = {"global": 0, "cross": 0, "local": cfg.local_window,
                  "swa": cfg.window}[kind]
        causal = not cross and cfg.causal
        dt = x.dtype
        # tensor parallelism (module docstring): local query heads, and
        # local K/V heads when they divide too
        tp_q = hints.tp_dim(self.wq) is not None
        tp_kv = hints.tp_dim(self.wk) is not None

        q = linear(hints.to_tp(x) if tp_q else x, self.wq)
        if cfg.qkv_bias:
            q = q + self.bq
        q = q.view(*q.shape[:-1], -1, hd)
        h = q.shape[-2]
        if cross and cache is not None and mode == "decode":
            k = v = None                        # the static cross cache
        else:
            kv_src = mem if cross else x
            if kv_src is None:
                raise ValueError(
                    f"{cfg.name}: a cross-attention layer needs the memory "
                    f"of a frontend (pass frontend=)")
            if tp_kv:
                kv_src = hints.to_tp(kv_src)
            k, v = linear(kv_src, self.wk), linear(kv_src, self.wv)
            if cfg.qkv_bias:
                k, v = k + self.bk, v + self.bv
            k = k.view(*k.shape[:-1], -1, hd)
            v = v.view(*v.shape[:-1], -1, hd)
        if positions is not None and not cross and cfg.rope_theta > 0:
            q = rope(q, positions, cfg.rope_theta)
            k = rope(k, positions, cfg.rope_theta)

        scales = self.scales()
        quant_cache = cfg.attention_impl != "float"

        def run(qq, kk, vv, *, mode, q_offset=0, kv_len=None, layout="bshd",
                page_table=None, q_lens=None):
            q_len = qq.shape[2] if layout == "bhsd_paged" else qq.shape[1]
            if tp_q and not tp_kv:      # this rank's query heads' K/V heads
                first = hints.tp_rank() * h
                group = cfg.n_heads // cfg.n_kv_heads
                kk = hints.select_heads(kk, first, h, group)
                vv = hints.select_heads(vv, first, h, group)
            spec = make_spec(cfg, mode=mode, causal=causal, window=window,
                             q_len=q_len, has_s_out=scales.s_out is not None,
                             layout=layout, ragged_q=q_lens is not None,
                             n_heads=h)
            # a preference: pinned where capable, dispatch fills the rest
            backend = cfg.attention_backend or None
            if backend is not None \
                    and ATT.get_backend(backend).supports(spec) is not True:
                backend = None
            out = ATT.dispatch(qq, kk, vv, spec=spec, scales=scales,
                               q_offset=q_offset, kv_len=kv_len,
                               page_table=page_table, q_lens=q_lens,
                               backend=backend, q_chunk=cfg.attn_q_chunk,
                               kv_chunk=cfg.attn_kv_chunk)
            return out.to(dt)

        def _q(t, s):
            return quantize_to_int8(t, getattr(self, s)) if quant_cache \
                else t

        new_cache = cache
        if cache is None:
            y = run(q, k, v, mode=mode)
        elif cross:
            if mode != "decode":                # (re)written at prefill
                new_cache = dict(cache, k8=_q(k, "s_k"), v8=_q(v, "s_v"))
            y = run(q, new_cache["k8"], new_cache["v8"], mode=mode)
        elif mode == "prefill":
            y = run(q, k, v, mode=mode)
            new_cache = cache.prefill_write(_q(k, "s_k"), _q(v, "s_v"),
                                            lengths=lengths)
        elif q_lens is not None:                        # mixed chunk append
            if not isinstance(cache, ATT.PagedKVState):
                raise ValueError(
                    "q_lens= (mixed chunked prefill) requires paged KV "
                    "caches; ring caches serve uniform decode/prefill only")
            n_new = q_lens.to(torch.int32)
            new_cache = cache.append_chunk(_q(k, "s_k"), _q(v, "s_v"), n_new)
            y = run(q.transpose(1, 2), new_cache.k, new_cache.v, mode=mode,
                    q_offset=new_cache.q_offset(n_new),
                    kv_len=new_cache.valid_len(), layout="bhsd_paged",
                    page_table=new_cache.page_table, q_lens=n_new)
            y = y.transpose(1, 2)
        else:                                           # decode append
            s_new = q.shape[1]
            new_cache = cache.decode_append(_q(k, "s_k"), _q(v, "s_v"),
                                            live=live)
            if isinstance(new_cache, ATT.PagedKVState):
                # q in kernel layout, K/V the shared arena read through
                # this layer's page table
                y = run(q.transpose(1, 2), new_cache.k, new_cache.v,
                        mode=mode, q_offset=new_cache.q_offset(s_new),
                        kv_len=new_cache.valid_len(), layout="bhsd_paged",
                        page_table=new_cache.page_table)
                y = y.transpose(1, 2)
            else:
                y = run(q, new_cache.k, new_cache.v, mode=mode,
                        q_offset=new_cache.q_offset(s_new),
                        kv_len=new_cache.valid_len())
        y = linear(y.reshape(*y.shape[:-2], h * hd), self.wo)
        y = hints.constrain(y, "batch", "seq", None, partial=tp_q)
        return y, new_cache
