"""Symmetric int8 quantization constants and helpers (the slice of
``repro.core.quant`` the serving path uses).

Scale convention: ``x_real ~= scale * x_q`` with ``x_q`` int8 in
[-128, 127]. ITA's softmax input uses the *maximum meaningful scale*
``EPS_MAX = B / (2**B * log2(e))`` (paper eq. 3), so the softmax exponent
becomes a pure right shift by ``SOFTMAX_SHIFT`` bits.

``EPS_MAX`` stays a float64 numpy scalar, as in the JAX package: the
requant multipliers round the float64 products that contain it to
float32 exactly once, and the port must round at the same place.
"""

from __future__ import annotations

import numpy as np
import torch

B_BITS = 8
INT8_MIN = -(2 ** (B_BITS - 1))          # -128
INT8_MAX = 2 ** (B_BITS - 1) - 1         # 127

# eps = B / (2**B * log2 e); eps' = log2(e) * eps = B / 2**B = 2**-5.
EPS_MAX = B_BITS / (2.0 ** B_BITS * np.log2(np.e))
SOFTMAX_SHIFT = B_BITS - int(np.log2(B_BITS))  # = 5


def quantize(x: torch.Tensor, scale) -> torch.Tensor:
    """Real -> int8: divide by the scale (a tensor: torch divides by a
    Python scalar as a reciprocal multiply on the card), round half to
    even (``torch.round``, like ``jnp.round``), saturate."""
    q = torch.round(x.float() / torch.as_tensor(scale, dtype=torch.float32,
                                                device=x.device))
    return torch.clamp(q, INT8_MIN, INT8_MAX).to(torch.int8)


def dequantize(q: torch.Tensor, scale) -> torch.Tensor:
    return q.float() * scale
