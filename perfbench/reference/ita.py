"""ITA's integer attention, frozen here from its definition (the paper's
DA/DI/EN with the adaptive per-row output scale, streamed over 128-key
tiles as the served kernels stream the pages of the pool).

Per query row, over key tiles in order: the tile's logits are the exact
int8 product ``q8 · k8ᵀ`` requantized onto the int8 logit grid by
``lmult = s_q · s_k / (sqrt(hd) · eps)``, ``eps = 8 / (256 · log2 e)``;
DA keeps the running row max ``m`` and denominator ``sigma`` (a larger
max shifts the old ``sigma`` right by ``(m_new - m_old) >> 5``) and the
numerators ``u = 128 >> ((m - x) >> 5)`` accumulate ``u · v`` (the old
accumulator scaled by ``2^-delta``); DI inverts ``sigma`` with a power
of two ``2^-e_r``, ``e_r = floor(log2 sigma)``; the output is requantized
onto the int8 grid of ``s_out`` through ``omult = s_v / s_out``.

Every integer product is taken as a float32 product of small integers,
exact while partial sums stay below 2^24 (|q·k| <= 128·128·hd, |u·v| <=
128·128·128). Divisions by a constant divide by a float32 tensor.
"""

from __future__ import annotations

import numpy as np
import torch

EPS_MAX = 8 / (2.0 ** 8 * np.log2(np.e))
TILE = 128
NEG = -256


def f32(x, device) -> torch.Tensor:
    return torch.full((), float(x), dtype=torch.float32, device=device)


def quantize(x: torch.Tensor, scale: float) -> torch.Tensor:
    """Round half to even onto ``scale``'s int8 grid, saturating."""
    q = torch.round(x.float() / f32(scale, x.device))
    return torch.clamp(q, -128, 127)


def pow2_neg(n: torch.Tensor) -> torch.Tensor:
    """Exact float32 ``2^-n`` of an integer tensor, from exponent bits."""
    return ((127 - n.to(torch.int32)) << 23).view(torch.float32)


def adaptive_inverse(sigma: torch.Tensor):
    """``(inv, e_r)``: ``e_r = floor(log2 sigma)``, ``inv = 2^(e_r+8) //
    sigma`` (the dividend pre-shifted to fit 31 bits), clipped at 256."""
    sigma = torch.clamp(sigma, min=1)
    _, e = torch.frexp(sigma.to(torch.float64))
    e_r = (e - 1).to(torch.int32)
    pre = torch.clamp(e_r + 8 - 30, min=0)
    num = torch.ones_like(sigma) << torch.clamp(e_r + 8 - pre, max=30)
    inv = torch.div(num, sigma >> pre, rounding_mode="floor")
    return torch.clamp(inv, max=256), e_r


def multipliers(s_q, s_k, s_v, s_out, head_dim: int, device):
    """``(lmult, omult)`` float32 0-d tensors."""
    const = f32(np.float32(np.sqrt(head_dim) * EPS_MAX), device)
    lmult = f32(s_q, device) * f32(s_k, device) / const
    return lmult, f32(s_v, device) / f32(s_out, device)


def attention(q8, k8, v8, lmult, omult) -> torch.Tensor:
    """Causal ITA attention of one sequence. ``q8`` (H, S, hd), ``k8``/
    ``v8`` (G, S, hd), integer-valued float32 (G divides H). Returns the
    int8 output values (H, S, hd) as float32 (multiply by ``s_out``)."""
    h, s, hd = q8.shape
    g = k8.shape[0]
    if g != h:
        k8 = k8.repeat_interleave(h // g, dim=0)
        v8 = v8.repeat_interleave(h // g, dim=0)
    dev = q8.device
    qi = torch.arange(s, device=dev)[:, None]
    m = torch.full((h, s, 1), NEG, dtype=torch.int32, device=dev)
    sigma = torch.zeros((h, s, 1), dtype=torch.int32, device=dev)
    acc = torch.zeros((h, s, hd), dtype=torch.float32, device=dev)
    for j0 in range(0, s, TILE):
        sl = slice(j0, min(j0 + TILE, s))
        kj = torch.arange(sl.start, sl.stop, device=dev)[None, :]
        valid = (qi >= kj)[None]
        raw = torch.matmul(q8, k8[:, sl].transpose(1, 2))
        x = torch.clamp(torch.round(raw * lmult), -128, 127).to(torch.int32)
        part_max = torch.where(valid, x, NEG).amax(dim=-1, keepdim=True)
        new_m = torch.maximum(m, part_max)
        delta = torch.clamp((new_m - m) >> 5, max=31)
        k = torch.clamp((new_m - x).clamp(min=0) >> 5, max=31)
        k = torch.where(valid, k, 31)
        u = torch.full_like(k, 128) >> k
        sigma = (sigma >> delta) + 2 * u.sum(dim=-1, keepdim=True,
                                             dtype=torch.int32)
        acc = acc * pow2_neg(delta) + torch.matmul(u.float(), v8[:, sl])
        m = new_m
    inv, e_r = adaptive_inverse(sigma)
    scale = 2.0 * inv.float() * pow2_neg(e_r + 8) * omult
    return torch.clamp(torch.round(acc * scale), -128, 127)
