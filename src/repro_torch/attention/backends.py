"""The registered attention backends of this slice of the port
(``repro.attention.backends``).

Four implementations of the ITA pipeline (Q·Kᵀ → shift-only softmax →
A·V), registered under the JAX package's names, in its priority order and
with its ``supports(spec)`` verdicts:

- ``ita_decode_pallas``  — the fused decode kernel (a single query tile
  over an int8 KV ring; skips KV tiles past the valid prefix).
- ``ita_chunked_xla``    — streaming DA/DI/EN in plain torch ops (the
  unpinned integer prefill; the S×S matrix never materializes).
- ``ita_onepass_pallas`` — the fused flash-style kernel, bit-identical to
  ``ita_decode_pallas`` row for row at equal block_kv.
- ``ita_twopass_pallas`` — the paper's two-pass dataflow (the int8 A
  matrix written once and read once), prefill only.

The names are config keys (``cfg.attention_backend``): ``_pallas`` names
the JAX counterpart of a backend, whose kernel here is the Hopper kernel
in ``repro_torch/kernels/ita_attention/csrc``, and ``_xla`` a backend
that the JAX package leaves to XLA and the port to plain torch ops.
Backends in the same ``family`` are bit-identical on the int8 output grid.
"""

from __future__ import annotations

import torch

from repro_torch.attention import xla as X
from repro_torch.attention.chunked import streaming_attention
from repro_torch.attention.registry import Backend, register_backend
from repro_torch.attention.spec import AttentionSpec, QuantScales
from repro_torch.kernels.common import default_blocks, device_tensor
from repro_torch.kernels.ita_attention.ops import fused_attention

_DEF_Q_CHUNK = 512
_DEF_KV_CHUNK = 512


def _qscale(spec: AttentionSpec, q):
    return spec.query_scale or q.shape[-1] ** -0.5


def _head_shape(ndim, head_axis):
    sh = [1] * ndim
    sh[head_axis] = -1
    return sh


def _scale(scale, ndim, head_axis, device):
    s = device_tensor(scale, torch.float32, device)
    return s.reshape(_head_shape(ndim, head_axis)) if s.ndim else s


def _quantize(x, scale, head_axis):
    """int8 passes through; float is quantized onto ``scale`` (scalar or
    per-head vector broadcast on ``head_axis``)."""
    if x.dtype == torch.int8:
        return x
    return X.quantize_to_int8(x, _scale(scale, x.ndim, head_axis, x.device))


def _dequantize(x_i8, scale, head_axis):
    return x_i8.float() * _scale(scale, x_i8.ndim, head_axis, x_i8.device)


def _requant_out(out_f, spec: AttentionSpec, scales: QuantScales,
                 head_axis):
    """Float backend output -> the spec's out_dtype (int8 rides s_out)."""
    if spec.out_dtype != "int8":
        return out_f
    return X.quantize_to_int8(
        out_f, _scale(scales.require("s_out").s_out, out_f.ndim, head_axis,
                      out_f.device))


def _require_zero_q_offset(q_offset, name):
    """The streaming q-chunk loop starts at query position 0."""
    if isinstance(q_offset, int) and q_offset == 0:
        return
    raise ValueError(
        f"{name} streams from query position 0; got q_offset={q_offset!r} "
        "(decode-style offsets ride the fused/direct backends)")


# ---------------------------------------------------------------------------
# Streaming backend (plain torch ops, as the JAX package leaves it to XLA)
# ---------------------------------------------------------------------------

def _chunked_supports(spec: AttentionSpec):
    if spec.impl != "ita":
        return "streams the ITA integer/STE arithmetic only"
    if spec.ragged_q:
        return "ragged q_len rides the fused one-pass kernels"
    if spec.mode == "decode":
        return ("decode rides the fused/direct paths (the streaming "
                "q-chunk loop assumes q_offset=0)")
    if spec.layout != "bshd":
        return "model layout (B,S,H,hd) only"
    if spec.scale_kind != "per_tensor":
        return "per-head scales are not plumbed through the XLA streaming path"
    if spec.mode == "train" and spec.out_dtype == "int8":
        return ("the QAT forward is differentiable float (s_out fake-quant), "
                "not int8 on the s_out grid")
    return True


def _chunked_run(q, k, v, spec, scales, *, q_offset=0, kv_len=None, **opts):
    _require_zero_q_offset(q_offset, "ita_chunked_xla")
    scales.require("s_q", "s_k", "s_v")
    if spec.mode == "train":
        raise NotImplementedError(
            "the QAT train forward (ita_ste + fake_quant) comes with the "
            "training slice of the port (ROADMAP A10)")
    out = streaming_attention(
        _quantize(q, scales.s_q, 2), _quantize(k, scales.s_k, 2),
        _quantize(v, scales.s_v, 2), impl="ita_int", scale=_qscale(spec, q),
        s_q=scales.s_q, s_k=scales.s_k, s_v=scales.s_v, causal=spec.causal,
        window=spec.window, kv_len=kv_len, softcap=spec.softcap,
        adaptive=spec.softmax == "adaptive",
        q_chunk=opts.get("q_chunk", _DEF_Q_CHUNK),
        kv_chunk=opts.get("kv_chunk", _DEF_KV_CHUNK))
    return _requant_out(out, spec, scales, 2)


# ---------------------------------------------------------------------------
# Fused kernel backends
# ---------------------------------------------------------------------------

def _fused_common_supports(spec: AttentionSpec):
    if spec.impl != "ita":
        return "fuses the ITA shift-only softmax only"
    if spec.softcap:
        return "logit softcap is not fused into the Pallas kernels"
    if spec.query_scale:
        return "the kernels hard-wire the 1/sqrt(d) query scale in logit_mult"
    if not spec.has_s_out:
        return ("the kernels requantize output through s_out (out_mult = "
                "s_v/s_out); legacy param sets without it ride the XLA "
                "paths")
    return True


def _onepass_supports(spec: AttentionSpec):
    ok = _fused_common_supports(spec)
    if ok is not True:
        return ok
    if spec.mode == "train":
        return "serve-path kernel (QAT train needs the differentiable STE "\
               "forward in ita_chunked_xla)"
    return True


def _twopass_supports(spec: AttentionSpec):
    ok = _fused_common_supports(spec)
    if ok is not True:
        return ok
    if spec.ragged_q:
        return ("the materialized A matrix assumes uniform query rows; "
                "ragged q_len rides the onepass kernels")
    if spec.layout == "bhsd_paged":
        return ("materializes/re-streams a contiguous A matrix; the paged "
                "KV pool serves the onepass/decode kernels")
    if spec.mode != "prefill":
        return ("paper-faithful analysis path — materializes the A matrix "
                "in HBM; decode rides the fused decode/onepass kernels")
    return True


def _decode_supports(spec: AttentionSpec):
    ok = _fused_common_supports(spec)
    if ok is not True:
        return ok
    if spec.mode != "decode":
        return "decode-shaped kernel (no q tiling; single query tile)"
    if spec.ragged_q:
        return ("mixed chunk-width rows need the q-tiled onepass kernel "
                "(the single decode tile caps at 8 queries)")
    if spec.q_len is None or spec.q_len > 8:
        return ("single query tile of at most 8 tokens (declare q_len in "
                "the spec); longer bursts ride onepass/direct")
    return True


def _fused_run(kind, q, k, v, spec, scales, q_offset, kv_len, opts):
    scales.require("s_q", "s_k", "s_v", "s_out")
    if spec.layout == "bshd":
        q8 = _quantize(q, scales.s_q, 2).transpose(1, 2)
        k8 = _quantize(k, scales.s_k, 2)
        v8 = _quantize(v, scales.s_v, 2)
        kv_native = True
    else:             # bhsd / bhsd_bsgd / bhsd_paged: q already (B,H,S,D)
        q8 = _quantize(q, scales.s_q, 1)
        kv_native = spec.layout == "bhsd_bsgd"
        kv_axis = 1 if spec.layout == "bhsd" else 2
        k8 = _quantize(k, scales.s_k, kv_axis)
        v8 = _quantize(v, scales.s_v, kv_axis)
    if kv_native and kind == "twopass":
        # twopass consumes kernel-layout KV: one transpose (decode and
        # onepass read the (B,S,G,hd) buffers in place)
        k8, v8 = k8.transpose(1, 2), v8.transpose(1, 2)
        kv_native = False
    dbq, dbkv = default_blocks(f"ita_{kind}_pallas")
    out = fused_attention(
        q8, k8, v8, scales.s_q, scales.s_k, scales.s_v, scales.s_out,
        q_offset=q_offset, kv_len=kv_len, q_lens=opts.get("q_lens"),
        causal=spec.causal, window=spec.window, kind=kind,
        adaptive=spec.softmax == "adaptive",
        block_q=opts.get("block_q", dbq or 128),
        block_kv=opts.get("block_kv", dbkv), kv_native=kv_native,
        page_table=opts.get("page_table"))
    if spec.layout == "bshd":
        out = out.transpose(1, 2)                        # back to (B,S,H,D)
    if spec.out_dtype == "int8":
        return out
    return _dequantize(out, scales.s_out, 2 if spec.layout == "bshd" else 1)


def _onepass_run(q, k, v, spec, scales, *, q_offset=0, kv_len=None, **opts):
    return _fused_run("onepass", q, k, v, spec, scales, q_offset, kv_len,
                      opts)


def _twopass_run(q, k, v, spec, scales, *, q_offset=0, kv_len=None, **opts):
    return _fused_run("twopass", q, k, v, spec, scales, q_offset, kv_len,
                      opts)


def _decode_run(q, k, v, spec, scales, *, q_offset=0, kv_len=None, **opts):
    return _fused_run("decode", q, k, v, spec, scales, q_offset, kv_len,
                      opts)


# ---------------------------------------------------------------------------
# Registration — order is dispatch priority (the JAX package's order)
# ---------------------------------------------------------------------------

register_backend(Backend(
    name="ita_decode_pallas", family="ita_fused",
    supports=_decode_supports, run=_decode_run,
    description="fused decode kernel over int8 KV ring buffers "
                "(cache-native layout, skips invalid KV tiles)"))
register_backend(Backend(
    name="ita_chunked_xla", family="ita_stream_xla",
    supports=_chunked_supports, run=_chunked_run,
    description="streaming DA/DI/EN in plain torch ops; integer prefill "
                "(S×S never materializes)"))
register_backend(Backend(
    name="ita_onepass_pallas", family="ita_fused",
    supports=_onepass_supports, run=_onepass_run,
    description="fused flash-style kernel; bit-identical to "
                "ita_decode_pallas at equal block_kv"))
register_backend(Backend(
    name="ita_twopass_pallas", family="ita_twopass",
    supports=_twopass_supports, run=_twopass_run,
    description="paper-faithful two-pass dataflow (A matrix in device "
                "memory)"))
