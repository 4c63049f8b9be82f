"""Standalone ITA softmax kernel for Hopper and its plain version.

``ita_softmax_kernel`` is the port's counterpart of ``ita_softmax_pallas``
(``repro/kernels/ita_softmax/kernel.py:26-88``): x (R, C) int8 logits
and mask (R, C) int8 (0 = masked) -> f32 probabilities ``p · 2^-e_r``.
DA runs over column parts of ``block_c`` in order (Σ depends on the part
size), DI once per row, then EN. ``block_r`` does not change the result.

On a CPU tensor the wrapper computes its plain PyTorch version
(``softmax_plain``, on any device — ``chip_smoke.py`` holds the kernel to
it on the card). On a CUDA tensor it launches the kernel
(``csrc/softmax.cu``) or raises — there is no fallback — checks the
launch status and adds one to ``LAUNCHES["ita_softmax"]``.
"""

from __future__ import annotations

import torch

from repro_torch.core.quant import SOFTMAX_SHIFT
from repro_torch.kernels import build
from repro_torch.kernels.common import (MASK_K, NEG_SENTINEL,
                                        adaptive_inverse, da_update,
                                        paper_inverse, pow2_neg)

# Launches of the CUDA kernel since the last reset (plain versions and CPU
# calls do not count).
LAUNCHES = {"ita_softmax": 0}


def reset_launches() -> None:
    LAUNCHES["ita_softmax"] = 0


def _part(x_q, mask, block_c):
    """Check the operands; the DA part size ``bc`` as the Pallas kernel
    takes it (C must be a multiple of it; any R)."""
    if x_q.dtype != torch.int8 or mask.dtype != torch.int8:
        raise TypeError("x_q and mask must be int8")
    if x_q.ndim != 2 or mask.shape != x_q.shape:
        raise ValueError(f"x_q {tuple(x_q.shape)} and mask "
                         f"{tuple(mask.shape)} must be one (R, C) shape")
    c = x_q.shape[1]
    bc = min(block_c, c)
    if bc <= 0 or c % bc:
        raise ValueError(f"C = {c} is not a multiple of the blocks "
                         f"(block_c {bc})")
    return bc


def softmax_plain(x_q, mask, *, block_r: int = 128, block_c: int = 128,
                  adaptive: bool = False) -> torch.Tensor:
    """The kernel's plain version, on the tensors' device: DA over column
    parts of ``block_c`` with the kernels' ``da_update``, DI, then EN."""
    bc = _part(x_q, mask, block_c)
    r, c = x_q.shape
    x = x_q.to(torch.int32)
    valid = mask != 0
    m = torch.full((r, 1), NEG_SENTINEL, dtype=torch.int32, device=x.device)
    sigma = torch.zeros((r, 1), dtype=torch.int32, device=x.device)
    for c0 in range(0, c, bc):                                       # DA
        _, _, m, sigma = da_update(m, sigma, x[:, c0:c0 + bc],
                                   valid[:, c0:c0 + bc])
    if adaptive:                                                     # DI
        inv, e_r = adaptive_inverse(sigma)
    else:
        inv, e_r = paper_inverse(sigma), torch.full_like(sigma, 8)
    k = torch.clamp((m - x).clamp(min=0) >> SOFTMAX_SHIFT, max=31)   # EN
    k = torch.where(valid, k, MASK_K)
    return (inv >> k).float() * pow2_neg(e_r)


def kernel_launcher(x_q, mask, *, block_r: int = 128, block_c: int = 128,
                    adaptive: bool = False):
    """Check a kernel call's operands and bind them: returns ``(launch,
    out)``, where ``launch()`` enqueues the kernel on the current stream
    writing ``out`` and raises if the launch fails."""
    if x_q.device.type != "cuda":
        raise RuntimeError(f"ita_softmax: tensors on {x_q.device}; the "
                           f"kernel runs on CUDA tensors, the plain version "
                           f"on CPU ones")
    bc = _part(x_q, mask, block_c)
    if mask.device != x_q.device:
        raise ValueError("ita_softmax: x_q and mask on different devices")
    x_q, mask = x_q.contiguous(), mask.contiguous()
    r, c = x_q.shape
    out = torch.empty((r, c), dtype=torch.float32, device=x_q.device)
    fn = build.launcher("ita_softmax_launch")
    args = (x_q.data_ptr(), mask.data_ptr(), out.data_ptr(), r, c, bc,
            int(adaptive))
    keep = (x_q, mask)                       # alive while launch() is

    def launch():
        err = fn(*args, torch.cuda.current_stream(keep[0].device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"ita_softmax: kernel launch failed with "
                               f"CUDA error {err}")
    return launch, out


def ita_softmax_kernel(x_q, mask, *, block_r: int = 128, block_c: int = 128,
                       adaptive: bool = False) -> torch.Tensor:
    """x_q (R, C) int8 logits, mask (R, C) int8 (0 = masked). Returns f32
    probabilities (R, C). C must be a multiple of ``block_c`` (the
    ``ops.ita_softmax`` wrapper pads); any R. ``block_r`` is accepted for
    signature parity and changes nothing."""
    kw = dict(block_r=block_r, block_c=block_c, adaptive=adaptive)
    if x_q.device.type == "cpu":
        return softmax_plain(x_q, mask, **kw)
    launch, out = kernel_launcher(x_q, mask, **kw)
    launch()
    LAUNCHES["ita_softmax"] += 1
    return out
