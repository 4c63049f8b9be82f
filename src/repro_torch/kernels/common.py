"""Shared helpers of the ITA attention kernels: the declared integer
bounds, the block-size defaults, and the plain-PyTorch versions of the
mask, the streaming DA step and the two DIs (``repro.kernels.common``).

The CUDA kernels carry the same helpers as ``__device__`` functions
(``kernels/ita_attention/csrc/ita_common.cuh``); the functions here are
what the kernels' plain versions and the chunked prefill path use, and
they are held bit-exact to the JAX helpers by the CPU tests.

Integer hazards the port handles explicitly:

- JAX shifts with ``shift_right_logical``; torch ``>>`` on int32 is an
  arithmetic shift. They agree on non-negative operands, so every shift
  here is applied to a value that is non-negative where it is used
  (``da_update`` computes ``new_max - logits`` on masked lanes too, where
  it can be negative, and masks the shift amount afterwards).
- torch has no count-leading-zeros: ``floor_log2`` (``core/softmax.py``)
  takes ``floor(log2 x)`` from the float64 exponent of ``x`` (exact for
  every int32; float32 would round 2^24 < x up).
"""

from __future__ import annotations

import functools
import numbers

import torch

from repro_torch.core.quant import SOFTMAX_SHIFT
from repro_torch.core.softmax import adaptive_sigma_inv
# re-exported: the kernels' plain versions and the chunked prefill use them
from repro_torch.core.softmax import floor_log2, pow2_neg  # noqa: F401

# --- Declared integer bounds of the ITA softmax pipeline -------------------
# NEG_SENTINEL: the masked-logit fill, below any requantized int8 logit;
#   ``new_max - x <= 127 - (-256) = 383`` keeps the DA shift <= 11.
NEG_SENTINEL = -256
# MASK_K: shift applied to masked elements; 128 >> 31 == 0.
MASK_K = 31
# U_MAX: the DA numerator ``u = 128 >> k`` is at most 128.
U_MAX = 128
# SIGMA_INV_MAX: both DIs give a reciprocal in [0, 256] on live rows.
SIGMA_INV_MAX = 256
# PAPER_INV_MAX: the paper DI before the EN shift (all-masked row): 2^16.
PAPER_INV_MAX = 1 << 16

# Per-backend block-size defaults: attention backends record (block_q,
# block_kv); the decode kernel has no q tiling (block_q is None).
BLOCK_DEFAULTS = {
    "ita_onepass_pallas": (128, 128),
    "ita_twopass_pallas": (128, 128),
    "ita_decode_pallas": (None, 128),
    "int8_matmul": (256, 128, 128),
}

# Rings allocated at a multiple of this never need a KV pad-copy in the
# fused-attention plumbing; ``KVCacheState.init`` aligns capacities above
# one block to it.
MIN_BLOCK_KV = 128


def default_blocks(backend: str) -> tuple:
    """(block_q, block_kv) defaults for a fused attention backend name
    (the matmul entry records three sizes — use ``default_matmul_blocks``)."""
    blocks = BLOCK_DEFAULTS.get(backend, (128, 128))
    if len(blocks) != 2:
        raise ValueError(f"{backend!r} records {len(blocks)} block sizes, "
                         f"not (bq, bkv); use default_matmul_blocks() for "
                         f"the matmul kernel")
    return blocks


def default_matmul_blocks() -> tuple:
    """(block_m, block_n, block_k) defaults for the int8 matmul kernel."""
    return BLOCK_DEFAULTS["int8_matmul"]


def tile_mask(q_tile, kv_tile, bq: int, bkv: int, causal: bool, window: int,
              kv_len=None, q_offset=0, q_len=None, device=None):
    """Validity mask (bq, bkv) of one (q_tile, kv_tile) grid cell, from
    indices: key j is visible from query i iff the causal/window
    conditions hold, ``j < kv_len`` and the query row is one of the row's
    first ``q_len``. Scalars, or tensors broadcastable against (bq, bkv)."""
    qli = q_tile * bq + torch.arange(bq, dtype=torch.int32,
                                     device=device)[:, None]
    qi = q_offset + qli
    kj = kv_tile * bkv + torch.arange(bkv, dtype=torch.int32,
                                      device=device)[None, :]
    valid = torch.ones(torch.broadcast_shapes(qi.shape, kj.shape),
                       dtype=torch.bool, device=device)
    if causal or window > 0:
        valid = valid & (qi >= kj)
    if window > 0:
        valid = valid & ((qi - kj) < window)
    if kv_len is not None:
        valid = valid & (kj < kv_len)
    if q_len is not None:
        valid = valid & (qli < q_len)
    return valid


def da_update(m: torch.Tensor, sigma: torch.Tensor, logits: torch.Tensor,
              valid: torch.Tensor):
    """One streaming DA step over a (..., bq, bkv) int32 logits tile.

    ``m``/``sigma`` are the (..., bq, 1) running max and denominator.
    Returns ``(u, delta, new_m, new_sigma)``: the numerators ``u = 128 >>
    k`` (int32, in [0, 128]), the correction shift ``delta`` for values
    accumulated under the previous max, and the updated statistics.
    """
    x = torch.where(valid, logits, NEG_SENTINEL)
    part_max = x.amax(dim=-1, keepdim=True)
    new_m = torch.maximum(m, part_max)
    delta = torch.clamp((new_m - m) >> SOFTMAX_SHIFT, max=31)
    # masked lanes may have new_m - logits < 0; their shift is replaced
    # by MASK_K below, so clamping them to 0 first changes nothing
    k = torch.clamp((new_m - logits).clamp(min=0) >> SOFTMAX_SHIFT, max=31)
    k = torch.where(valid, k, MASK_K)
    u = torch.full_like(k, 128) >> k
    new_sigma = (sigma >> delta) + 2 * u.sum(dim=-1, keepdim=True,
                                             dtype=torch.int32)
    return u, delta, new_m, new_sigma


def adaptive_inverse(sigma: torch.Tensor):
    """DI with per-row power-of-two scaling: ``(sigma_inv, e_r)`` with
    ``sigma_inv ~= 2^(e_r+8) / sigma`` in (128, 256], ``e_r = floor(log2
    sigma)``; the clip to ``SIGMA_INV_MAX`` is an identity on every
    reachable value."""
    return adaptive_sigma_inv(torch.clamp(sigma, min=1))


def paper_inverse(sigma: torch.Tensor) -> torch.Tensor:
    """DI as in silicon: ``PAPER_INV_MAX // sigma`` (16-bit)."""
    return torch.div(torch.full_like(sigma, PAPER_INV_MAX),
                     torch.clamp(sigma, min=1), rounding_mode="floor")


def device_tensor(x, dtype, device) -> torch.Tensor:
    """``x`` as a ``dtype`` tensor on ``device``. A Python or numpy number
    is filled on the device: copying a host scalar to the card would
    synchronize the host with the stream on every call."""
    if isinstance(x, numbers.Number):
        return torch.full((), x, dtype=dtype, device=device)
    return torch.as_tensor(x, dtype=dtype, device=device)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device) -> int:
    """The streaming multiprocessors of a CUDA device (132 on an H100
    SXM), which the kernels' geometries fill."""
    device = torch.device(device)
    index = device.index
    return _sm_count(torch.cuda.current_device() if index is None else index)


def exact_float32_matmul() -> None:
    """Make float32 matrix products on the card run in full float32.

    The plain versions and the chunked prefill take their integer
    products (int8 Q·Kᵀ, u·V) as float32 products, which are exact while
    every partial sum stays below 2^24; TF32 would round the operands.
    Entry points call this once; ``int_matmul`` checks it."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def int_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact integer product ``a @ b`` of small integer tensors, taken as
    a float32 product (CUDA has no int8/int32 matmul). The caller bounds
    every partial sum below 2^24 (|Q·Kᵀ| <= 128·128·d, |u·V| <= 128·128·
    bkv). Returns float32 holding integers."""
    if a.is_cuda and (torch.backends.cuda.matmul.allow_tf32
                      or torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError(
            "integer products need full float32 matmuls on the card: call "
            "repro_torch.kernels.common.exact_float32_matmul() first")
    return torch.matmul(a.float(), b.float())
