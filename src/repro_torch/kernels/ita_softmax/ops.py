"""Wrapper of the standalone ITA softmax kernel
(``repro.kernels.ita_softmax.ops``)."""

from __future__ import annotations

import torch

from repro_torch.kernels.ita_softmax.kernel import ita_softmax_kernel


def ita_softmax(x_q: torch.Tensor, mask: torch.Tensor | None = None, *,
                block_r: int = 128, block_c: int = 128,
                adaptive: bool = False) -> torch.Tensor:
    """Streaming integer softmax over the last axis of int8 logits.

    Accepts any leading shape; pads columns to a multiple of ``block_c``
    (the DA part size, which is part of the arithmetic; padded columns
    are masked out and return probability 0). Rows are independent and
    the kernel takes any row count, so rows are not padded: ``block_r``
    is accepted for parity with the JAX wrapper and changes nothing.
    Launches the kernel for CUDA tensors; runs its plain version for CPU
    ones.
    """
    *lead, n = x_q.shape
    x2 = x_q.reshape(-1, n)
    r = x2.shape[0]
    if mask is None:
        m2 = torch.ones((r, n), dtype=torch.int8, device=x_q.device)
    else:
        m2 = mask.reshape(-1, n).to(torch.int8)
    pad_c = (-n) % block_c
    if pad_c:
        x2 = torch.nn.functional.pad(x2, (0, pad_c))
        m2 = torch.nn.functional.pad(m2, (0, pad_c))
    out = ita_softmax_kernel(x2, m2, block_r=block_r,
                             block_c=min(block_c, n + pad_c),
                             adaptive=adaptive)
    return out[:, :n].reshape(*lead, n)
