"""Shared layers (``repro.models.layers``): RMSNorm with a ``1 + scale``
gain, RoPE, the SwiGLU MLP, embedding and unembedding.

Weights are stored in the config's compute dtype: the JAX package keeps
float32 weights and casts them at every matmul (``w.astype(dt)``), so
casting once is numerically the same. Norm gains stay float32, as the
norm computes in float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def normal_param(shape, scale, *, dtype, device, generator=None):
    """``scale * N(0, 1)`` drawn in float32 from ``generator`` and cast to
    ``dtype``; uninitialized storage when ``generator`` is None (weights
    about to be loaded)."""
    if generator is None:
        t = torch.empty(shape, dtype=dtype, device=device)
    else:
        t = (scale * torch.randn(shape, generator=generator,
                                 dtype=torch.float32, device=device)
             ).to(dtype)
    return nn.Parameter(t, requires_grad=False)


def const_param(shape, value, *, dtype, device):
    return nn.Parameter(torch.full(shape, value, dtype=dtype, device=device),
                        requires_grad=False)


def rmsnorm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-6):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * (1.0 + scale)
    return y.to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x: (..., S, H, D); positions: broadcastable to (..., S)."""
    d = x.shape[-1]
    half = d // 2
    def f32(value):         # a tensor operand: no reciprocal-multiply
        return torch.full((), value, dtype=torch.float32, device=x.device)
    freq = torch.pow(f32(theta), -torch.arange(
        0, half, dtype=torch.float32, device=x.device) / f32(half))
    ang = positions[..., None].float() * freq              # (..., S, half)
    sin, cos = torch.sin(ang)[..., None, :], torch.cos(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


class SwiGLU(nn.Module):
    def __init__(self, d: int, f: int, *, dtype, device, generator=None):
        super().__init__()
        s_in, s_out = d ** -0.5, f ** -0.5
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.w_gate = normal_param((d, f), s_in, **kw)
        self.w_up = normal_param((d, f), s_in, **kw)
        self.w_down = normal_param((f, d), s_out, **kw)

    def forward(self, x):
        return (F.silu(x @ self.w_gate) * (x @ self.w_up)) @ self.w_down


def embed(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    return table[ids]


def unembed(w: torch.Tensor, x: torch.Tensor, softcap: float = 0.0):
    """x (..., d) @ w (d, V) -> float32 logits (optionally softcapped)."""
    logits = (x @ w).float()
    if softcap > 0:
        logits = torch.tanh(logits / softcap) * softcap
    return logits
