"""Int8 GEMM kernels for Hopper and their plain versions: ITA's quantized
linear layer, the counterparts of ``int8_matmul_pallas``
(``repro/kernels/int8_matmul/kernel.py``).

x (M, K) int8 @ w (K, N) int8 -> exact int32, + bias (N,) int32, then
``clip(round(f32(acc) · mult))`` with per-channel float32 multipliers
(N,) -> int8 (M, N). Two schedules compute the same function:

- ``"tpu"`` (B7a, ``csrc/matmul.cu`` ``int8_matmul_launch``): one launch;
  a block owns an output tile and walks K in order.
- ``"weight_stationary"`` (B7b, ``int8_matmul_ws_launch``): the paper's
  schedule, one launch per k tile of ``block_k``; a block keeps its
  weight tile in shared memory while every row of x streams past it,
  and the int32 partial sums go to device memory and back between
  launches (zeroed first, written on every k tile, as the reference's
  aliased ``psum``).

The accumulator is exact, so the result does not depend on the tiles:
the kernels pick their own (128 x 128 output tiles), and the block sizes
only set the divisibility the reference asks for and B7b's k tiles.

On a CPU tensor the wrapper computes the plain version of its schedule
(``matmul_plain``, ``matmul_ws_plain``: exact products in float64, on any
device — ``chip_smoke.py`` holds the kernels to them on the card). On a
CUDA tensor it launches the kernel or raises — there is no fallback —
checks each launch's status and adds one to ``LAUNCHES[name]`` per
launch: once per B7a call, K / block_k times per B7b call.
"""

from __future__ import annotations

import torch

from repro_torch.core.quant import int8_matmul_ref as exact_product
from repro_torch.kernels import build
from repro_torch.kernels.common import device_tensor
from repro_torch.kernels.int8_matmul.ref import (int8_matmul_ref,
                                                 requant_epilogue)

SCHEDULES = ("tpu", "weight_stationary")
# Launches of the CUDA kernels since the last reset (plain versions and
# CPU calls do not count).
LAUNCHES = {"int8_matmul": 0, "int8_matmul_ws": 0}
# schedule -> counter
_COUNTER = {"tpu": "int8_matmul", "weight_stationary": "int8_matmul_ws"}
# B7b keeps a (block_k x 128) weight tile and a 128 x 64 chunk of x in
# one block's shared memory (232,448 bytes): (bk + 16)·128 + 10,240.
WS_MAX_BLOCK_K = 1664


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _operands(x_q, w_q, bias, mult, block_m, block_n, block_k, schedule):
    """Check a call's operands as ``int8_matmul_pallas`` does; returns
    ``(bk, bias (N,) int32, mult (N,) f32)`` with bias and mult broadcast
    and on x's device."""
    if schedule not in SCHEDULES:
        raise ValueError(f"schedule {schedule!r} is not one of {SCHEDULES}")
    if x_q.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise TypeError("x_q and w_q must be int8")
    if x_q.ndim != 2 or w_q.ndim != 2 or x_q.shape[1] != w_q.shape[0]:
        raise ValueError(f"x_q {tuple(x_q.shape)} and w_q "
                         f"{tuple(w_q.shape)} are not (M, K) and (K, N)")
    m, kdim = x_q.shape
    n = w_q.shape[1]
    bm, bn, bk = min(block_m, m), min(block_n, n), min(block_k, kdim)
    if min(bm, bn, bk) <= 0 or m % bm or n % bn or kdim % bk:
        raise ValueError(f"(M, N, K) = {(m, n, kdim)} is not a multiple of "
                         f"the blocks {(bm, bn, bk)} (the ops.int8_matmul "
                         f"wrapper pads)")
    dev = x_q.device
    bias = torch.broadcast_to(
        device_tensor(bias, torch.int32, dev).reshape(-1), (n,))
    mult = torch.broadcast_to(
        device_tensor(mult, torch.float32, dev).reshape(-1), (n,))
    return bk, bias, mult


def matmul_plain(x_q, w_q, bias, mult) -> torch.Tensor:
    """B7a's plain version, on the tensors' device: the exact product,
    plus bias, then the requant epilogue."""
    return int8_matmul_ref(x_q, w_q, bias, mult)


def matmul_ws_plain(x_q, w_q, bias, mult, *, block_k: int) -> torch.Tensor:
    """B7b's plain version: the same k-tile loop with an int32 partial
    sum, then bias and the requant epilogue on the last tile."""
    psum = torch.zeros((x_q.shape[0], w_q.shape[1]), dtype=torch.int32,
                       device=x_q.device)
    for k0 in range(0, x_q.shape[1], block_k):
        psum = psum + exact_product(x_q[:, k0:k0 + block_k],
                                    w_q[k0:k0 + block_k])
    return requant_epilogue(psum + bias[None, :], mult)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and 16-byte aligned (a view at an odd offset is
    copied): the kernels load 4 bytes at a time."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def kernel_launcher(x_q, w_q, bias, mult, *, block_m: int = 256,
                    block_n: int = 128, block_k: int = 128,
                    schedule: str = "tpu"):
    """Check a kernel call's operands and bind them: returns ``(launches,
    out)``, where each of ``launches`` enqueues one kernel launch on the
    current stream (B7a: one; B7b: one per k tile, in order, after a zero
    fill of the partial sums) and raises if it fails; ``out`` is written
    by the last."""
    if x_q.device.type != "cuda":
        raise RuntimeError(f"int8_matmul: tensors on {x_q.device}; the "
                           f"kernels run on CUDA tensors, the plain "
                           f"versions on CPU ones")
    if w_q.device != x_q.device:
        raise ValueError("int8_matmul: x_q and w_q on different devices")
    bk, bias, mult = _operands(x_q, w_q, bias, mult, block_m, block_n,
                               block_k, schedule)
    m, kdim = x_q.shape
    n = w_q.shape[1]
    if kdim % 4 or n % 4 or bk % 4:
        raise ValueError(f"int8_matmul on the card loads 4 bytes at a time: "
                         f"K {kdim}, N {n} and the k tile {bk} must be "
                         f"multiples of 4 (pad through ops.int8_matmul with "
                         f"such block sizes)")
    if schedule == "weight_stationary" and bk > WS_MAX_BLOCK_K:
        raise ValueError(f"int8_matmul: block_k {bk} does not fit B7b's "
                         f"resident weight tile (at most {WS_MAX_BLOCK_K})")
    x_q, w_q = _aligned(x_q), _aligned(w_q)
    bias, mult = _aligned(bias), _aligned(mult)
    out = torch.empty((m, n), dtype=torch.int8, device=x_q.device)
    keep = (x_q, w_q, bias, mult, out)       # alive while the launches are
    ptrs = tuple(t.data_ptr() for t in keep[:4])

    def checked(fn_name, *args):
        fn = build.launcher(fn_name)

        def launch():
            err = fn(*args, torch.cuda.current_stream(
                keep[0].device).cuda_stream)
            if err != 0:
                raise RuntimeError(f"int8_matmul: {fn_name} failed with CUDA "
                                   f"error {err}")
        return launch

    if schedule == "tpu":
        return [checked("int8_matmul_launch", *ptrs, out.data_ptr(), m, n,
                        kdim)], out
    psum = torch.empty((m, n), dtype=torch.int32, device=x_q.device)
    keep += (psum,)
    tiles = [checked("int8_matmul_ws_launch", *ptrs, psum.data_ptr(),
                     out.data_ptr(), m, n, kdim, k0, bk,
                     int(k0 + bk == kdim))
             for k0 in range(0, kdim, bk)]

    def first():
        psum.zero_()
        tiles[0]()
    return [first, *tiles[1:]], out


def int8_matmul_kernel(x_q, w_q, bias, mult, *, block_m: int = 256,
                       block_n: int = 128, block_k: int = 128,
                       schedule: str = "tpu") -> torch.Tensor:
    """x (M,K) int8, w (K,N) int8, bias (N,) int32 in accumulator units,
    mult (N,) or scalar f32 requant multipliers. Returns int8 (M,N). M, N
    and K must be multiples of the blocks (each capped at its dimension);
    the ``ops.int8_matmul`` wrapper pads."""
    if x_q.device.type == "cpu":
        bk, bias, mult = _operands(x_q, w_q, bias, mult, block_m, block_n,
                                   block_k, schedule)
        if schedule == "tpu":
            return matmul_plain(x_q, w_q, bias, mult)
        return matmul_ws_plain(x_q, w_q, bias, mult, block_k=bk)
    launches, out = kernel_launcher(x_q, w_q, bias, mult, block_m=block_m,
                                    block_n=block_n, block_k=block_k,
                                    schedule=schedule)
    for launch in launches:
        launch()
        LAUNCHES[_COUNTER[schedule]] += 1
    return out
