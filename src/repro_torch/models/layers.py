"""Shared layers (``repro.models.layers``): RMSNorm with a ``1 + scale``
gain, RoPE, the SwiGLU MLP, embedding and unembedding.

Every projection goes through ``linear`` and every norm reduces through
the same fixed row blocks: both compute in blocks of exactly
``ROW_BLOCK`` token rows. cuBLAS chooses its GEMM kernel, and with it
the order of the sums, by the number of rows, and torch's row reduction
picks its thread layout by the number of rows too: on an H100 a token
row of a bf16 product or of a mean can come out with other last bits in
a call of 96 rows than alone (``chip_smoke.py`` prints how many rows
differ at each row count).
A served request shares its calls with other slots and meets its prompt
in chunks, so without fixed blocks its tokens could differ from
``generate()`` of the request alone. A row's result in a block does not
depend on the other rows or its position (``chip_smoke.py`` checks
both), so every call gives each token the same bits.
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


ROW_BLOCK = 128


def in_row_blocks(x: torch.Tensor, fn) -> torch.Tensor:
    """``fn`` applied to the rows of ``x (..., K)`` in blocks of exactly
    ``ROW_BLOCK`` rows (the last block zero-padded), so that each row's
    result is independent of how many rows share the call."""
    lead, k = x.shape[:-1], x.shape[-1]
    rows = x.reshape(-1, k)
    m = rows.shape[0]
    pad = (-m) % ROW_BLOCK
    if pad:
        rows = torch.cat([rows, rows.new_zeros((pad, k))])
    out = torch.cat([fn(rows[i:i + ROW_BLOCK])
                     for i in range(0, m + pad, ROW_BLOCK)])
    return out[:m].reshape(*lead, out.shape[-1])


def linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x (..., K) @ w (K, N)``, in fixed row blocks."""
    return in_row_blocks(x, lambda rows: rows @ w)


def rmsnorm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-6):
    xf = x.float()
    var = in_row_blocks(xf * xf,
                        lambda rows: torch.mean(rows, dim=-1, keepdim=True))
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
        return linear(F.silu(linear(x, self.w_gate)) * linear(x, self.w_up),
                      self.w_down)


def embed(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    return table[ids]


def unembed(w: torch.Tensor, x: torch.Tensor, softcap: float = 0.0):
    """x (..., d) @ w (d, V) -> float32 logits (optionally softcapped)."""
    logits = linear(x, w).float()
    if softcap > 0:
        logits = torch.tanh(logits / softcap) * softcap
    return logits
