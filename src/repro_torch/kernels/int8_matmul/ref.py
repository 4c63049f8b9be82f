"""Plain-PyTorch oracle of the int8 matmul kernels
(``repro.kernels.int8_matmul.ref``)."""

from __future__ import annotations

import torch

from repro_torch.core.quant import INT8_MAX, INT8_MIN
from repro_torch.core.quant import int8_matmul_ref as _exact


def requant_epilogue(acc: torch.Tensor, mult: torch.Tensor) -> torch.Tensor:
    """int32 (M, N) -> int8: ``clip(round(f32(acc) · mult))`` with the
    per-channel float32 multipliers ``mult`` (N,); float32 conversion and
    rounding are half to even, as in the kernels."""
    y = torch.round(acc.float() * mult.float()[None, :])
    return torch.clamp(y, INT8_MIN, INT8_MAX).to(torch.int8)


def int8_matmul_ref(x_q: torch.Tensor, w_q: torch.Tensor, bias: torch.Tensor,
                    mult: torch.Tensor) -> torch.Tensor:
    """x (M,K) int8 @ w (K,N) int8 + bias (N,) int32, requantized by the
    per-channel f32 multipliers ``mult`` (N,) -> int8. The product is
    exact (``core.quant.int8_matmul_ref``)."""
    return requant_epilogue(_exact(x_q, w_q, bias[None, :]), mult)
