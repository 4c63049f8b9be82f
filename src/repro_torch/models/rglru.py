"""RG-LRU recurrent block (``repro.models.rglru``; RecurrentGemma /
Griffin).

The temporal mixer of recurrentgemma's 2-of-3 non-attention layers:
gate branch (GeLU) ⊙ (causal conv1d(4) → RG-LRU) → output projection.

RG-LRU (per channel, gates block-diagonal per head as in Griffin):
    r_t = sigmoid(W_a x_t + b_a)          recurrence gate
    i_t = sigmoid(W_x x_t + b_x)          input gate
    a_t = exp(-c * softplus(Λ) * r_t)     data-dependent decay (c = 8)
    h_t = a_t ⊙ h_{t-1} + sqrt(1 - a_t²) ⊙ (i_t ⊙ x_t)

The recurrence runs as the odd/even recursion of
``jax.lax.associative_scan`` (``_associative_scan``), so every ``h_t``
is formed by the reference's own products and sums, in O(log T) torch
ops. Decode keeps O(1) state: ``h`` and the last three conv inputs.

Leaves are used as the reference uses them: the projections and the
conv in the compute dtype, the gates ``w_a``/``w_x``/``b_a``/``b_x`` in
float32, and ``lam`` in ``param_dtype`` (the reference takes its
softplus in that dtype).
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.models.layers import GeGLU, const_param, linear, normal_param

_C = 8.0
_CONV_K = 4


class RGLRU(nn.Module):
    """The parameters of ``init_rglru``: ``w_gate_branch``/``w_in``
    (d, dr), ``conv_w`` (4, dr), ``conv_b`` (dr,), the block-diagonal
    gates ``w_a``/``w_x`` (H, dr/H, dr/H) with biases ``b_a``/``b_x``,
    ``lam`` (dr,) and ``w_out`` (dr, d)."""

    def __init__(self, cfg, *, device, generator=None):
        super().__init__()
        d, dr, nh = cfg.d_model, cfg.rnn_width, cfg.n_heads
        dh = dr // nh
        pdt, cdt = cfg.param_torch_dtype(), cfg.compute_dtype()
        kw = dict(device=device, generator=generator, param_dtype=pdt)
        self.w_gate_branch = normal_param((d, dr), d ** -0.5, dtype=cdt, **kw)
        self.w_in = normal_param((d, dr), d ** -0.5, dtype=cdt, **kw)
        self.conv_w = normal_param((_CONV_K, dr), 0.1, dtype=cdt, **kw)
        self.conv_b = const_param((dr,), 0.0, dtype=cdt, device=device)
        self.w_a = normal_param((nh, dh, dh), dh ** -0.5,
                                dtype=torch.float32, **kw)
        self.b_a = const_param((dr,), 0.0, dtype=torch.float32,
                               device=device)
        self.w_x = normal_param((nh, dh, dh), dh ** -0.5,
                                dtype=torch.float32, **kw)
        self.b_x = const_param((dr,), 0.0, dtype=torch.float32,
                               device=device)
        self.lam = normal_param((dr,), 1.0, dtype=pdt, shift=4.0, **kw)
        self.w_out = normal_param((dr, d), dr ** -0.5, dtype=cdt, **kw)

    def forward(self, x, cfg, state=None):
        return apply_rglru(self, x, cfg, state)


def _blockdiag(x, w, nh):
    b, s, dr = x.shape
    xh = x.reshape(b, s, nh, dr // nh)
    return torch.einsum("bshi,hij->bshj", xh, w.to(x.dtype)).reshape(b, s, dr)


def _conv1d_causal(x, w, bias, state=None):
    """Depthwise causal conv, kernel 4. ``state``: (B, K-1, dr) history.
    Returns ``(out, new_state)``, the state in ``x``'s dtype."""
    if state is None:
        pad = x.new_zeros((x.shape[0], _CONV_K - 1, x.shape[2]))
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    s = x.shape[1]
    out = xp[:, 0:s] * w[0]
    for i in range(1, _CONV_K):
        out = out + xp[:, i:i + s] * w[i]
    return out + bias, xp[:, -(_CONV_K - 1):].clone()


def _combine(left, right):
    al, bl = left
    ar, br = right
    return al * ar, bl * ar + br


def _interleave(even, odd):
    """``even`` at positions 0, 2, ... and ``odd`` at 1, 3, ... of axis 1
    (``len(even)`` is ``len(odd)`` or one more)."""
    out = even.new_empty((even.shape[0], even.shape[1] + odd.shape[1])
                         + even.shape[2:])
    out[:, 0::2] = even
    out[:, 1::2] = odd
    return out


def _associative_scan(a, b):
    """Inclusive scan of ``_combine`` over axis 1 of the pair ``(a, b)``,
    by the recursion of ``jax.lax.associative_scan``: combine adjacent
    pairs, scan the halved sequence, combine its results with the even
    inputs from index 2, put element 0 first and interleave."""
    n = a.shape[1]
    if n < 2:
        return a, b
    ra, rb = _combine((a[:, 0:n - 1:2], b[:, 0:n - 1:2]),
                      (a[:, 1::2], b[:, 1::2]))
    oa, ob = _associative_scan(ra, rb)
    if n % 2 == 0:
        ea, eb = _combine((oa[:, :-1], ob[:, :-1]), (a[:, 2::2], b[:, 2::2]))
    else:
        ea, eb = _combine((oa, ob), (a[:, 2::2], b[:, 2::2]))
    ea = torch.cat([a[:, :1], ea], dim=1)
    eb = torch.cat([b[:, :1], eb], dim=1)
    return _interleave(ea, oa), _interleave(eb, ob)


def _rglru_scan(x, a, h0=None):
    """h_t = a_t h_{t-1} + b_t over time axis 1, ``h0`` (B, dr) the
    carried state folded in as a virtual step 0 with ``a = 0``."""
    b_t = torch.sqrt(torch.clamp(1.0 - a * a, min=0.0)) * x
    if h0 is not None:
        a = torch.cat([torch.zeros_like(a[:, :1]), a], dim=1)
        b_t = torch.cat([h0[:, None].to(b_t.dtype), b_t], dim=1)
    _, h = _associative_scan(a, b_t)
    return h[:, 1:] if h0 is not None else h


def _softplus(x):
    """``jax.nn.softplus``: ``max(x, 0) + log1p(exp(-|x|))``, in ``x``'s
    dtype."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-torch.abs(x)))


def apply_rglru(p, x, cfg, state=None):
    """x: (B, S, d). state (decode): {"h": (B, dr) float32, "conv":
    (B, 3, dr)}. Returns (y, new_state)."""
    nh = cfg.n_heads
    dt = x.dtype
    gate = GeGLU.act(linear(x, p.w_gate_branch))
    u = linear(x, p.w_in)
    u, conv_state = _conv1d_causal(u, p.conv_w, p.conv_b,
                                   None if state is None else state["conv"])
    uf = u.float()
    r = torch.sigmoid(_blockdiag(uf, p.w_a, nh) + p.b_a)
    i = torch.sigmoid(_blockdiag(uf, p.w_x, nh) + p.b_x)
    log_a = (-_C * _softplus(p.lam)) * r
    a = torch.exp(log_a)
    h = _rglru_scan(i * uf, a, None if state is None else state["h"])
    y = linear(h.to(dt) * gate, p.w_out)
    return y, {"h": h[:, -1].clone(), "conv": conv_state}


def init_rglru_state(batch, cfg, dtype=torch.float32, *, device):
    dr = cfg.rnn_width
    return {"h": torch.zeros((batch, dr), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros((batch, _CONV_K - 1, dr), dtype=dtype,
                                device=device)}
