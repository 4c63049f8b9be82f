"""Shared layers (``repro.models.layers``): RMSNorm with a ``1 + scale``
gain, LayerNorm, RoPE, sinusoidal positions, the SwiGLU and GeGLU MLPs,
the biased GELU MLP, embedding and unembedding.

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

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.cost_hook import counted
from repro_torch.launch import hints


def normal_param(shape, scale, *, dtype, device, generator=None,
                 param_dtype=torch.float32, shift=0.0):
    """``scale * N(0, 1) + shift`` drawn in float32 from ``generator``,
    rounded to ``param_dtype`` (the JAX package's storage) and cast to
    ``dtype``; uninitialized storage when ``generator`` is None (weights
    about to be loaded)."""
    if generator is None:
        t = torch.empty(shape, dtype=dtype, device=device)
    else:
        t = (scale * torch.randn(shape, generator=generator,
                                 dtype=torch.float32, device=device)
             + shift).to(param_dtype).to(dtype)
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
    if x.device.type == "meta":         # shapes only: one call, same rows
        out = fn(rows)
    else:
        out = torch.cat([fn(rows[i:i + ROW_BLOCK])
                         for i in range(0, m + pad, ROW_BLOCK)])
    return out[:m].reshape(*lead, out.shape[-1])


class _Linear(torch.autograd.Function):
    """``linear`` under autograd: the forward in the fixed row blocks, the
    backward as the JAX package differentiates ``x @ w``, one product
    each over all rows. The weight's gradient is then one GEMM whose
    float32 accumulator is rounded once to the compute dtype, not a sum
    of per-block bf16 partials rounded at every add."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return in_row_blocks(x, lambda rows: rows @ w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gx = g @ w.mT if ctx.needs_input_grad[0] else None
        gw = (x.reshape(-1, x.shape[-1]).mT @ g.reshape(-1, g.shape[-1])
              if ctx.needs_input_grad[1] else None)
        return gx, gw


@counted("linear")
def linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x (..., K) @ w (K, N)``, in fixed row blocks (``_Linear`` when
    autograd records it)."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _Linear.apply(x, w)
    return in_row_blocks(x, lambda rows: rows @ w)


def rmsnorm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-6):
    xf = x.float()
    var = in_row_blocks(xf * xf,
                        lambda rows: torch.mean(rows, dim=-1, keepdim=True))
    y = xf * torch.rsqrt(var + eps) * (1.0 + scale)
    return y.to(x.dtype)


class LayerNorm(nn.Module):
    """LayerNorm's parameters: ``scale`` (ones) and ``bias`` (zeros),
    (d,) in ``dtype`` (the reference's ``param_dtype``)."""

    def __init__(self, d: int, *, dtype, device):
        super().__init__()
        self.scale = const_param((d,), 1.0, dtype=dtype, device=device)
        self.bias = const_param((d,), 0.0, dtype=dtype, device=device)

    def forward(self, x):
        return layernorm(self.scale, self.bias, x)


def layernorm(scale, bias, x: torch.Tensor, eps: float = 1e-6):
    """The reference's LayerNorm in float32: the mean, then the mean of
    the centred squares (not ``F.layer_norm``, whose arithmetic differs),
    each reduced in the fixed row blocks."""
    xf = x.float()
    mu = in_row_blocks(xf, lambda rows: torch.mean(rows, dim=-1,
                                                   keepdim=True))
    xc = xf - mu
    var = in_row_blocks(xc * xc,
                        lambda rows: torch.mean(rows, dim=-1, keepdim=True))
    y = xc * torch.rsqrt(var + eps) * scale + bias
    return y.to(x.dtype)


def apply_norm(norm, x: torch.Tensor):
    """A block's norm: a ``LayerNorm`` module, or RMSNorm's gain tensor."""
    return norm(x) if isinstance(norm, LayerNorm) else rmsnorm(norm, x)


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


def sinusoidal_positions(seq: int, d: int) -> np.ndarray:
    """Whisper-style sinusoidal embeddings (seq, d) float32 of positions
    ``0..seq-1`` (the encoder's), computed in numpy as the reference
    computes them: float64 angles, rounded once."""
    pos = np.arange(seq)[:, None]
    dim = np.arange(0, d, 2)[None, :] / d
    ang = pos / (10000.0 ** dim)
    out = np.zeros((seq, d), np.float32)
    out[:, 0::2] = np.sin(ang)
    out[:, 1::2] = np.cos(ang)
    return out


def sinusoidal_at(positions: torch.Tensor, d: int) -> torch.Tensor:
    """Sinusoidal embeddings (..., d) float32 of the (possibly per-row)
    ``positions`` (int, (S,) or (B, S)) on their device, in float32 as
    the reference's decoder computes them (its ``forward``): the angle
    ``p / 10000^(2i/d)``, sines at even and cosines at odd features."""
    def f32(value):          # a tensor operand: no reciprocal-multiply
        return torch.full((), value, dtype=torch.float32,
                          device=positions.device)
    dim = torch.arange(0, d, 2, dtype=torch.float32,
                       device=positions.device) / f32(d)
    ang = positions[..., None].float() / torch.pow(f32(10000.0), dim)
    pe = torch.stack([torch.sin(ang), torch.cos(ang)], dim=-1)
    return pe.reshape(*ang.shape[:-1], d)


class SwiGLU(nn.Module):
    """Gated MLP ``(act(x @ w_gate) * (x @ w_up)) @ w_down`` with SiLU."""

    act = staticmethod(F.silu)

    def __init__(self, d: int, f: int, *, dtype, device, generator=None,
                 param_dtype=torch.float32):
        super().__init__()
        s_in, s_out = d ** -0.5, f ** -0.5
        kw = dict(dtype=dtype, device=device, generator=generator,
                  param_dtype=param_dtype)
        self.w_gate = normal_param((d, f), s_in, **kw)
        self.w_up = normal_param((d, f), s_in, **kw)
        self.w_down = normal_param((f, d), s_out, **kw)

    def forward(self, x):
        if hints.tp_dim(self.w_down) is None:
            return linear(self.act(linear(x, self.w_gate))
                          * linear(x, self.w_up), self.w_down)
        # tensor parallel: this rank's columns of ff, then the row-parallel
        # product all-reduced over ``model``
        x = hints.to_tp(x)
        h = self.act(linear(x, self.w_gate)) * linear(x, self.w_up)
        return hints.constrain(linear(h, self.w_down), "batch", "seq", None,
                               partial=True)


class GeGLU(SwiGLU):
    """The gated MLP with tanh-approximate GELU (gemma2)."""

    @staticmethod
    def act(v):
        return F.gelu(v, approximate="tanh")


class GeluMLP(nn.Module):
    """The biased MLP ``gelu(x @ w_up + b_up) @ w_down + b_down`` with
    tanh-approximate GELU (whisper). The biases hold ``param_dtype``-
    rounded values in the compute dtype, as the reference casts them at
    each use."""

    def __init__(self, d: int, f: int, *, dtype, device, generator=None,
                 param_dtype=torch.float32):
        super().__init__()
        kw = dict(dtype=dtype, device=device, generator=generator,
                  param_dtype=param_dtype)
        self.w_up = normal_param((d, f), d ** -0.5, **kw)
        self.b_up = const_param((f,), 0.0, dtype=dtype, device=device)
        self.w_down = normal_param((f, d), f ** -0.5, **kw)
        self.b_down = const_param((d,), 0.0, dtype=dtype, device=device)

    def forward(self, x):
        tp = hints.tp_dim(self.w_down) is not None
        h = F.gelu(linear(hints.to_tp(x) if tp else x, self.w_up)
                   + self.b_up, approximate="tanh")
        y = linear(h, self.w_down)
        if tp:
            y = hints.constrain(y, "batch", "seq", None, partial=True)
        return y + self.b_down


def embed(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    if hints.tp_dim(table) is None:
        return table[ids]
    # vocabulary parallel: this rank's rows, zeros for the other ids, summed
    # over ``model`` (one non-zero term: exact)
    n = table.shape[0]
    local = ids - hints.tp_rank() * n
    inside = (local >= 0) & (local < n)
    rows = table[local.clamp(0, n - 1)]
    return hints.reduce_tp(torch.where(inside[..., None], rows,
                                       rows.new_zeros(())))


def unembed(w: torch.Tensor, x: torch.Tensor, softcap: float = 0.0):
    """x (..., d) @ w (d, V) -> float32 logits (optionally softcapped);
    under tensor parallelism of the vocabulary, this rank's columns."""
    if hints.tp_dim(w) is not None:
        x = hints.to_tp(x)
    logits = linear(x, w).float()
    if softcap > 0:
        # a tensor divisor: the card divides by a Python scalar as a
        # multiply by its reciprocal
        cap = torch.full((), softcap, dtype=torch.float32,
                         device=logits.device)
        logits = torch.tanh(logits / cap) * cap
    return logits
