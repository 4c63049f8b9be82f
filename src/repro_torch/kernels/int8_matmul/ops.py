"""Public wrapper of the int8 matmul kernels
(``repro.kernels.int8_matmul.ops``): batching, padding to block multiples
and the choice between the kernel and the plain reference."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.common import default_matmul_blocks, device_tensor
from repro_torch.kernels.int8_matmul.kernel import int8_matmul_kernel
from repro_torch.kernels.int8_matmul.ref import int8_matmul_ref


def _pad_to(x: torch.Tensor, mult: int, axis: int) -> torch.Tensor:
    pad = (-x.shape[axis]) % mult
    if pad == 0:
        return x
    widths = [0, 0] * x.ndim                 # F.pad: last axis first
    widths[2 * (x.ndim - 1 - axis) + 1] = pad
    return F.pad(x, widths)


def int8_matmul(x_q: torch.Tensor, w_q: torch.Tensor,
                bias: torch.Tensor | None = None, mult=1.0, *,
                block_m: int | None = None, block_n: int | None = None,
                block_k: int | None = None, schedule: str = "tpu",
                use_pallas: bool = True,
                interpret: bool | None = None) -> torch.Tensor:
    """Quantized linear: int8 x int8 -> int32 -> requant int8.

    ``x_q``: (..., K) int8; ``w_q``: (K, N) int8; ``bias``: (N,) int32 in
    accumulator units (None: zeros); ``mult``: per-channel (N,) or scalar
    requant multiplier, rounded to float32 once. Leading dims are
    flattened for the kernel. Block sizes default to
    ``kernels.common.BLOCK_DEFAULTS["int8_matmul"]``; M is padded to
    ``min(block_m, max(8, M))``, K to ``block_k`` and N to ``block_n``
    (zero rows, zero weights, zero bias and multiplier), and the result
    is sliced back. ``schedule`` is ``"tpu"`` (B7a) or
    ``"weight_stationary"`` (B7b). ``use_pallas=False`` computes the plain
    reference on the tensors' device; otherwise CUDA tensors launch the
    kernel and CPU tensors take its plain version. The kernels read w
    K-major: a weight stored so (``w.t().contiguous().t()``, a (K, N)
    view of the same values) is used as it is, any other is transposed
    once per call. ``interpret`` is accepted for parity with the JAX
    wrapper and changes nothing.
    """
    dm, dn, dk = default_matmul_blocks()
    block_m = dm if block_m is None else block_m
    block_n = dn if block_n is None else block_n
    block_k = dk if block_k is None else block_k
    *lead, kdim = x_q.shape
    n = w_q.shape[1]
    dev = x_q.device
    bias = torch.zeros((n,), dtype=torch.int32, device=dev) if bias is None \
        else device_tensor(bias, torch.int32, dev)
    mult = torch.broadcast_to(device_tensor(mult, torch.float32, dev), (n,))

    x2 = x_q.reshape(-1, kdim)
    if not use_pallas:
        return int8_matmul_ref(x2, w_q, bias, mult).reshape(*lead, n)

    m = x2.shape[0]
    bm = min(block_m, max(8, m))
    x2p = _pad_to(_pad_to(x2, bm, 0), block_k, 1)
    w_p = _pad_to(_pad_to(w_q, block_k, 0), block_n, 1)
    out = int8_matmul_kernel(x2p, w_p, _pad_to(bias, block_n, 0),
                             _pad_to(mult, block_n, 0), block_m=bm,
                             block_n=block_n, block_k=block_k,
                             schedule=schedule)
    return out[:m, :n].reshape(*lead, n)
