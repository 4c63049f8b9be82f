"""Gradient compression for the data-parallel axis across pods
(``repro.runtime.compression``).

ITA's thesis — 8-bit integers with calibrated scales lose little —
applied to gradient traffic: the same symmetric int8 quantization, with
error feedback (the quantization residual is carried to the next step,
so the compression error accumulates to zero instead of biasing the
update).

- ``ef_compress`` / ``ef_decompress``: transforms of a dict of gradients
  (name -> tensor) usable inside any train step, the error-feedback
  state threaded beside the optimizer state.
- ``compressed_psum``: the int8 all-reduce over one mesh axis: quantize
  locally, all-gather the int8 shards and the float32 scales, then
  dequantize and sum locally (no int8 overflow; about a quarter of the
  float32 all-reduce's bytes on the wire).
"""

from __future__ import annotations

import torch

from repro_torch.core.quant import INT8_MAX, INT8_MIN
from repro_torch.launch import hints


def init_ef_state(grads: dict) -> dict:
    return {n: torch.zeros_like(g, dtype=torch.float32)
            for n, g in grads.items()}


def _quantize(g):
    # a tensor divisor: the card divides by a Python scalar as a
    # multiply by its reciprocal
    top = torch.full((), INT8_MAX, dtype=torch.float32, device=g.device)
    scale = torch.clamp(torch.max(torch.abs(g)), min=1e-12) / top
    q = torch.clamp(torch.round(g / scale), INT8_MIN, INT8_MAX)
    return q, scale


def ef_compress(grads: dict, ef_state: dict):
    """Returns ``(int8 dict, scales dict, new_ef_state)``."""
    qs, scales, errs = {}, {}, {}
    for n, g in grads.items():
        g = g.float() + ef_state[n]
        q, scale = _quantize(g)
        errs[n] = g - q * scale
        qs[n], scales[n] = q.to(torch.int8), scale
    return qs, scales, errs


def ef_decompress(q_grads: dict, scales: dict) -> dict:
    return {n: q.float() * scales[n] for n, q in q_grads.items()}


def compressed_psum(x: torch.Tensor, axis: str, mesh) -> torch.Tensor:
    """int8 all-reduce of ``x`` over ``axis`` of ``mesh``: the sum over
    the axis's ranks of each rank's dequantized int8 copy of its ``x``
    (float32), formed as the reference's ``tensordot`` of the gathered
    scales with the gathered int8 shards. The all-gathers run on an axis
    of one rank too: they are the wire format this demonstrates."""
    q, scale = _quantize(x.float())
    qs = hints.all_gather(q.to(torch.int8)[None], 0, axis, mesh=mesh,
                          always=True)
    ss = hints.all_gather(scale.reshape(1), 0, axis, mesh=mesh, always=True)
    return torch.tensordot(ss, qs.float(), dims=([0], [0]))


def make_compressed_grad_allreduce(mesh, axis: str = "pod"):
    """``mean(grads) -> grads``: the compressed mean over ``axis`` of a
    dict of gradients (local tensors or DTensors, each rank's shard
    reduced with its counterparts along ``axis``)."""
    n = dict(zip(mesh.mesh_dim_names, mesh.shape, strict=True))[axis]

    def mean(grads: dict) -> dict:
        out = {}
        for name, g in grads.items():
            local = g.to_local() if hasattr(g, "to_local") else g
            red = compressed_psum(local, axis, mesh) / n
            if hasattr(g, "to_local"):
                from torch.distributed.tensor import DTensor
                red = DTensor.from_local(red, mesh, g.placements,
                                         run_check=False)
            out[name] = red
        return out

    return mean
