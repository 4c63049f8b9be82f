"""RWKV6 "Finch" blocks (``repro.models.rwkv6``; attention-free, with
data-dependent decay).

Time-mix: per-head matrix-valued state S ∈ R^{dh×dh} with
    S_t = diag(w_t) S_{t-1} + k_tᵀ v_t
    o_t = r_t (S_{t-1} + diag(u) k_tᵀ v_t)
where the decay w_t is data-dependent via a low-rank ("ddlerp")
projection, as are the token-shift interpolations. The recurrence runs
as a loop over time in float32, one step as ``lax.scan`` runs it; decode
carries O(1) state: the token-shift tail and the per-head S.

RWKV6 has no softmax attention, so ITA's softmax has no site here.
Leaves are used as the reference uses them: ``mu``, ``ddlerp_*`` and the
``w_r/k/v/g/o`` projections in the compute dtype; the decay's
``w0``/``w_lora_a``/``w_lora_b``, the bonus ``u`` and the per-head group
norm in float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.cost_hook import counted
from repro_torch.models.layers import const_param, linear, normal_param

_LORA = 64        # ddlerp low-rank dim
_LORA_W = 64      # decay low-rank dim


class TimeMix(nn.Module):
    """The parameters of ``init_time_mix``."""

    def __init__(self, cfg, *, device, generator=None):
        super().__init__()
        d, nh = cfg.d_model, cfg.n_heads
        dh = d // nh
        f32, cdt = torch.float32, cfg.compute_dtype()
        kw = dict(device=device, generator=generator,
                  param_dtype=cfg.param_torch_dtype())
        self.mu = normal_param((5, d), 0.1, dtype=cdt, **kw)
        self.ddlerp_a = normal_param((d, 5 * _LORA), d ** -0.5, dtype=cdt,
                                     **kw)
        self.ddlerp_b = normal_param((5, _LORA, d), _LORA ** -0.5,
                                     dtype=cdt, **kw)
        for name in ("w_r", "w_k", "w_v", "w_g", "w_o"):
            setattr(self, name, normal_param((d, d), d ** -0.5, dtype=cdt,
                                             **kw))
        self.w0 = normal_param((d,), 0.5, dtype=f32, shift=-6.0, **kw)
        self.w_lora_a = normal_param((d, _LORA_W), d ** -0.5, dtype=f32,
                                     **kw)
        self.w_lora_b = normal_param((_LORA_W, d), _LORA_W ** -0.5,
                                     dtype=f32, **kw)
        self.u = normal_param((d,), 0.5, dtype=f32, **kw)
        self.ln_scale = const_param((nh, dh), 1.0, dtype=f32, device=device)
        self.ln_bias = const_param((nh, dh), 0.0, dtype=f32, device=device)

    def forward(self, x, cfg, state=None):
        return apply_time_mix(self, x, cfg, state)


class ChannelMix(nn.Module):
    """The parameters of ``init_channel_mix``, all used in the compute
    dtype."""

    def __init__(self, cfg, *, device, generator=None):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        kw = dict(dtype=cfg.compute_dtype(), device=device,
                  generator=generator, param_dtype=cfg.param_torch_dtype())
        self.mu_k = normal_param((d,), 0.1, **kw)
        self.mu_r = normal_param((d,), 0.1, **kw)
        self.w_k = normal_param((d, f), d ** -0.5, **kw)
        self.w_v = normal_param((f, d), f ** -0.5, **kw)
        self.w_r = normal_param((d, d), d ** -0.5, **kw)

    def forward(self, x, cfg, state=None):
        return apply_channel_mix(self, x, cfg, state)


def _token_shift(x, prev):
    """prev: (B, d) last token of the previous chunk (zeros at start)."""
    return torch.cat([prev[:, None], x[:, :-1]], dim=1)


def _prev(x, state):
    if state is None:
        return x.new_zeros((x.shape[0], x.shape[2]))
    return state["shift"].to(x.dtype)


@counted("wkv_scan")
def meta_wkv(r, s0, passes: int = 1):
    """The work of a meta call's ``_wkv_scan`` (its ``T`` products ``r_t ·
    S``), ``passes`` times: ``roofline.op_costs`` counts it by formula.
    Returns the shapes ``(o, sT)``."""
    return r.new_empty(r.shape), s0.new_empty(s0.shape)


class _MetaWKV(torch.autograd.Function):
    """``_wkv_scan`` on the meta device (the dry-run): the outputs'
    shapes, and in the backward the scan's products counted twice."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, s0):
        ctx.save_for_backward(r, k, v, w, u, s0)
        return meta_wkv(r, s0)

    @staticmethod
    def backward(ctx, g_o, g_s):
        saved = ctx.saved_tensors
        meta_wkv(saved[0], saved[5], passes=2)
        return tuple(torch.zeros_like(t) for t in saved)


def _wkv_scan(r, k, v, w, u, s0):
    """r, k, v, w: (B, T, H, dh); u: (H, dh); s0: (B, H, dh, dh).
    Returns (o (B, T, H, dh), sT)."""
    if r.device.type == "meta":
        return _MetaWKV.apply(r, k, v, w, u, s0)
    s, outs = s0, []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]      # (B,H,dh,dh)
        o_t = torch.matmul(r[:, t, :, None, :],
                           s + u[..., None] * kv)[..., 0, :]
        s = w[:, t, :, :, None] * s + kv
        outs.append(o_t)
    return torch.stack(outs, dim=1), s


def apply_time_mix(p, x, cfg, state=None):
    """x: (B, S, d); state: {"shift": (B, d), "s": (B, H, dh, dh)}, both
    float32. Returns (y, new_state)."""
    b, s, d = x.shape
    nh = cfg.n_heads
    dh = d // nh
    dt = x.dtype
    xs = _token_shift(x, _prev(x, state))

    # ddlerp: data-dependent interpolation between x and shifted x
    base = xs - x
    lora = torch.tanh(linear(x, p.ddlerp_a)).reshape(b, s, 5, _LORA)
    dyn = torch.stack([linear(lora[:, :, f], p.ddlerp_b[f])
                       for f in range(5)], dim=2)
    mixed = x[:, :, None] + base[:, :, None] * (p.mu + dyn)
    xr, xk, xv, xw, xg = mixed.unbind(2)

    r = linear(xr, p.w_r).reshape(b, s, nh, dh)
    k = linear(xk, p.w_k).reshape(b, s, nh, dh)
    v = linear(xv, p.w_v).reshape(b, s, nh, dh)
    g = linear(xg, p.w_g)
    g = g * torch.sigmoid(g)                          # jax.nn.silu
    ww = p.w0 + linear(torch.tanh(linear(xw.float(), p.w_lora_a)),
                       p.w_lora_b)
    w = torch.exp(-torch.exp(ww)).reshape(b, s, nh, dh)   # decay in (0,1)

    s0 = x.new_zeros((b, nh, dh, dh), dtype=torch.float32) \
        if state is None else state["s"]
    o, s_t = _wkv_scan(r.float(), k.float(), v.float(), w,
                       p.u.reshape(nh, dh), s0)

    # per-head group norm
    mu = o.mean(-1, keepdim=True)
    c = o - mu
    var = (c * c).mean(-1, keepdim=True)
    o = c * torch.rsqrt(var + 1e-5) * p.ln_scale + p.ln_bias
    y = linear(o.reshape(b, s, d).to(dt) * g, p.w_o)
    return y, {"shift": x[:, -1].to(torch.float32, copy=True), "s": s_t}


def apply_channel_mix(p, x, cfg, state=None):
    xs = _token_shift(x, _prev(x, state))
    xk = x + (xs - x) * p.mu_k
    xr = x + (xs - x) * p.mu_r
    k = torch.square(F.relu(linear(xk, p.w_k)))
    y = torch.sigmoid(linear(xr, p.w_r)) * linear(k, p.w_v)
    return y, {"shift": x[:, -1].to(torch.float32, copy=True)}


def init_rwkv_state(batch, cfg, *, device):
    d, nh = cfg.d_model, cfg.n_heads
    dh = d // nh

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)
    return {"tm": {"shift": zeros(batch, d), "s": zeros(batch, nh, dh, dh)},
            "cm": {"shift": zeros(batch, d)}}
