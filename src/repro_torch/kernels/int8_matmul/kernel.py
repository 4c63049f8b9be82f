"""Int8 GEMM kernels for Hopper and their plain versions: ITA's quantized
linear layer, the counterparts of ``int8_matmul_pallas``
(``repro/kernels/int8_matmul/kernel.py``).

x (M, K) int8 @ w (K, N) int8 -> exact int32, + bias (N,) int32, then
``clip(round(f32(acc) · mult))`` with per-channel float32 multipliers
(N,) -> int8 (M, N). Two schedules compute the same function, each in one
launch per call (``csrc/matmul.cu`` has the designs):

- ``"tpu"`` (B7a, ``int8_matmul_launch``): output tiles, K walked in
  order inside a block; ``matmul_geometry`` picks the wgmma kernel
  (M > 16) or the rows kernel (a decode step).
- ``"weight_stationary"`` (B7b, ``int8_matmul_ws_launch``): the paper's
  schedule; a block keeps a weight tile of ``block_k`` in shared memory
  while the rows of its m range (``ws_geometry``) stream past it, and
  the int32 partial sums go to device memory and back on every k tile
  (zeroed first, as the reference's aliased ``psum``).

Both kernels read the weight K-major, the (N, K) buffer behind a (K, N)
view ``w.t().contiguous().t()``: such a view is used as it is, and any
other w is transposed once per call. ``core.quant.quantize_tensor``
stores a weight quantized per output channel so, once.

The accumulator is exact, so the result does not depend on the tiles:
the kernels pick their own, and the block sizes only set the
divisibility the reference asks for and B7b's k tiles.

On a CPU tensor the wrapper computes the plain version of its schedule
(``matmul_plain``, ``matmul_ws_plain``: exact products in float64, on any
device — ``chip_smoke.py`` holds the kernels to them on the card). On a
CUDA tensor it launches the kernel or raises — there is no fallback —
checks each launch's status and adds one to ``LAUNCHES[name]`` per
launch: once per call of either schedule.
"""

from __future__ import annotations

import torch

from repro_torch.core.quant import int8_matmul_ref as exact_product
from repro_torch.core.cost_hook import counted
from repro_torch.kernels import build
from repro_torch.kernels.common import device_tensor, sm_count
from repro_torch.kernels.int8_matmul.ref import (int8_matmul_ref,
                                                 requant_epilogue)

SCHEDULES = ("tpu", "weight_stationary")
# Launches of the CUDA kernels since the last reset (plain versions and
# CPU calls do not count).
LAUNCHES = {"int8_matmul": 0, "int8_matmul_ws": 0}
# schedule -> counter
_COUNTER = {"tpu": "int8_matmul", "weight_stationary": "int8_matmul_ws"}
_MAX_SMEM = 232448              # a block's shared memory on sm_90
# B7a: at most 16 rows take the rows geometry (blocks of 32 columns, each
# walking all of K in chunks of 128 bytes), more rows the wgmma one
# (128-row tiles, 256 columns where such tiles number at least the SMs,
# else 128; a ~192 KB ring of TMA stages).
ROWS_MAX_M, ROWS_COLS = 16, 32
WGMMA_BM, WGMMA_BK, WGMMA_RING = 128, 128, 192 * 1024
# B7b: 128 x 128 partial-sum tiles, rows streamed in 64-byte chunks of x
# (128 x 80 bytes of shared memory), weight tiles of 128 rows of block_k
# rounded up to 64, + 16 bytes; m ranges for ~8 blocks per SM. The row
# tile's partial sums are staged in shared memory (128 rows of 132 ints)
# where the blocks outnumber the SMs and two then fit an SM
# (WS_TWO_BLOCKS bytes each: block_k up to 256), else held in registers;
# two weight tiles where they fit, one up to WS_MAX_BLOCK_K (1664: one
# tile of 128 x 1680 bytes beside the x chunk fills a block's shared
# memory).
WS_TILE, WS_CHUNK, WS_BLOCKS_PER_SM = 128, 64, 8
WS_STAGED, WS_TWO_BLOCKS = 128 * 132 * 4, 115712
WS_MAX_BLOCK_K = 1664


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def matmul_geometry(m: int, n: int, kdim: int, *, sms: int) -> dict:
    """B7a's launch for an (m, kdim) x (kdim, n) call on a card of
    ``sms`` SMs (``csrc/matmul.cu`` ``int8_matmul_launch`` takes it as
    given and checks it). The operands' rows are padded to ``ld``, a
    multiple of 16 bytes (TMA strides and 16-byte loads). ``kind``
    "rows" (m <= 16): blocks of ``ROWS_COLS`` columns, each over all of
    K. ``kind`` "wgmma": 128 x ``bn`` output
    tiles. Raises on what the kernel cannot take."""
    if m <= 0 or n <= 0 or kdim <= 0:
        raise ValueError(f"int8_matmul: (M, N, K) = {(m, n, kdim)} must be "
                         f"positive")
    if kdim % 4 or n % 4:
        raise ValueError(f"int8_matmul on the card: K {kdim} and N {n} must "
                         f"be multiples of 4")
    ld = _cdiv(kdim, 16) * 16
    if m <= ROWS_MAX_M:
        return {"kind": "rows", "ld": ld, "bn": 0,
                "grid": (_cdiv(n, ROWS_COLS),)}
    m_tiles = _cdiv(m, WGMMA_BM)
    bn = 256 if _cdiv(n, 256) * m_tiles >= sms else 128
    stage = WGMMA_BM * WGMMA_BK + bn * WGMMA_BK
    stages = WGMMA_RING // stage
    return {"kind": "wgmma", "ld": ld, "bn": bn,
            "grid": (m_tiles, _cdiv(n, bn)), "stages": stages,
            "smem": stages * stage + 16 * stages + 8 * bn + 1024}


def ws_geometry(m: int, n: int, kdim: int, bk: int, *, sms: int) -> dict:
    """B7b's launch on a card of ``sms`` SMs (``int8_matmul_ws_launch``
    takes ``range_rows``, ``staged`` and ``double_w`` as given and checks
    that they fit): a block owns the partial sums of ``range_rows`` rows
    (a multiple of 128) by 128 columns; m ranges number enough for
    ~``WS_BLOCKS_PER_SM`` blocks per SM where M allows, and each reads
    the weights once. ``staged``: the row tile's partial sums land in
    shared memory, two blocks to an SM (where the blocks outnumber the
    SMs and two fit); ``double_w``: two weight tiles (the next one lands
    while the rows stream past the current one). Raises on what the
    kernel cannot take."""
    if m <= 0 or n <= 0 or kdim <= 0 or bk <= 0:
        raise ValueError(f"int8_matmul: (M, N, K) = {(m, n, kdim)} and "
                         f"block_k {bk} must be positive")
    if kdim % 4 or n % 4 or bk % 4:
        raise ValueError(f"int8_matmul on the card loads 4 bytes at a time: "
                         f"K {kdim}, N {n} and the k tile {bk} must be "
                         f"multiples of 4 (pad through ops.int8_matmul with "
                         f"such block sizes)")
    m_tiles, n_tiles = _cdiv(m, WS_TILE), _cdiv(n, WS_TILE)
    per = _cdiv(m_tiles, min(m_tiles,
                             _cdiv(WS_BLOCKS_PER_SM * sms, n_tiles)))
    ranges = _cdiv(m_tiles, per)
    tile = WS_TILE * (_cdiv(bk, WS_CHUNK) * WS_CHUNK + 16)
    chunk = WS_TILE * (WS_CHUNK + 16)
    staged, double_w = n_tiles * ranges > sms, True
    if not staged or chunk + WS_STAGED + 2 * tile > WS_TWO_BLOCKS:
        double_w = False
        if not staged or chunk + WS_STAGED + tile > WS_TWO_BLOCKS:
            staged, double_w = False, chunk + 2 * tile <= _MAX_SMEM
    smem = chunk + staged * WS_STAGED + (2 if double_w else 1) * tile
    if smem > _MAX_SMEM:
        raise ValueError(f"int8_matmul: block_k {bk} does not fit B7b's "
                         f"resident weight tile (at most {WS_MAX_BLOCK_K})")
    return {"range_rows": per * WS_TILE, "ranges": ranges,
            "grid": (n_tiles, ranges), "k_tiles": _cdiv(kdim, bk),
            "staged": staged, "double_w": double_w, "smem": smem}


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
    """``t`` 16-byte aligned (a view at an odd offset is copied, with its
    strides)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def k_major(w_q: torch.Tensor) -> torch.Tensor:
    """The (N, K) contiguous buffer of the weight (K, N): the buffer itself
    for a K-major view (``w.t().contiguous().t()``), else a transposed
    copy."""
    wt = w_q.t()
    return _aligned(wt if wt.is_contiguous() else wt.contiguous())


def _pad_k(t: torch.Tensor, ld: int) -> torch.Tensor:
    """Rows of ``t`` (R, K) padded with zeros to ``ld`` bytes."""
    pad = ld - t.shape[1]
    return t if pad == 0 else torch.nn.functional.pad(t, (0, pad))


def kernel_launcher(x_q, w_q, bias, mult, *, block_m: int = 256,
                    block_n: int = 128, block_k: int = 128,
                    schedule: str = "tpu"):
    """Check a kernel call's operands and bind them: returns ``(launch,
    out)``, where ``launch()`` enqueues the call's one kernel launch on
    the current stream (B7b's after a zero fill of its partial sums) and
    raises if it fails; ``out`` is written by it. w is taken K-major
    (``k_major``)."""
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
    x_q, wt = _aligned(x_q.contiguous()), k_major(w_q)
    bias, mult = _aligned(bias.contiguous()), _aligned(mult.contiguous())
    out = torch.empty((m, n), dtype=torch.int8, device=x_q.device)
    psum, sms = None, sm_count(x_q.device)
    if schedule == "tpu":
        geo = matmul_geometry(m, n, kdim, sms=sms)
        x_q, wt = _pad_k(x_q, geo["ld"]), _pad_k(wt, geo["ld"])
        name = "int8_matmul_launch"
        args = (x_q, wt, bias, mult, out, m, n, geo["ld"], geo["bn"])
    else:
        geo = ws_geometry(m, n, kdim, bk, sms=sms)
        psum = torch.empty((m, n), dtype=torch.int32, device=x_q.device)
        name = "int8_matmul_ws_launch"
        args = (x_q, wt, bias, mult, psum, out, m, n, kdim, bk,
                geo["range_rows"], int(geo["staged"]), int(geo["double_w"]))
    fn = build.launcher(name)
    ptrs = tuple(a.data_ptr() if isinstance(a, torch.Tensor) else a
                 for a in args)

    def launch():                        # args: alive while it is
        if psum is not None:
            psum.zero_()
        err = fn(*ptrs, torch.cuda.current_stream(args[0].device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"int8_matmul: {name} failed with CUDA error "
                               f"{err}")
    return launch, out


@counted("int8_matmul")
def int8_matmul_kernel(x_q, w_q, bias, mult, *, block_m: int = 256,
                       block_n: int = 128, block_k: int = 128,
                       schedule: str = "tpu") -> torch.Tensor:
    """x (M,K) int8, w (K,N) int8, bias (N,) int32 in accumulator units,
    mult (N,) or scalar f32 requant multipliers. Returns int8 (M,N). M, N
    and K must be multiples of the blocks (each capped at its dimension);
    the ``ops.int8_matmul`` wrapper pads."""
    if x_q.device.type == "meta":           # shapes only (the dry-run)
        return x_q.new_empty((x_q.shape[0], w_q.shape[1]))
    if x_q.device.type == "cpu":
        bk, bias, mult = _operands(x_q, w_q, bias, mult, block_m, block_n,
                                   block_k, schedule)
        if schedule == "tpu":
            return matmul_plain(x_q, w_q, bias, mult)
        return matmul_ws_plain(x_q, w_q, bias, mult, block_k=bk)
    launch, out = kernel_launcher(x_q, w_q, bias, mult, block_m=block_m,
                                  block_n=block_n, block_k=block_k,
                                  schedule=schedule)
    launch()
    LAUNCHES[_COUNTER[schedule]] += 1
    return out
