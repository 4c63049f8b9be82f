"""Typed front door of the attention engine: ``AttentionSpec`` (what the
caller needs computed) and ``QuantScales`` (the quantization grid it lives
on) — a copy of ``repro.attention.spec``.

``AttentionSpec`` is a frozen, hashable dataclass: the sole input of
every backend's ``supports()`` predicate, with the same fields, values
and validation as the JAX package's, so one spec gets the same verdicts
in both. ``QuantScales`` holds the four scale roles as tensors, Python
floats or per-head vectors.
"""

from __future__ import annotations

import dataclasses
from typing import Any

MODES = ("train", "prefill", "decode")
IMPLS = ("float", "ita", "ibert")
SOFTMAXES = ("adaptive", "paper")
# q-layout[_kv-layout]: "bshd" (model: batch, seq, heads, dim), "bhsd"
# (kernel: batch, heads, seq, dim), "bhsd_bsgd" (decode engine: q in
# kernel layout, K/V consumed cache-natively as (B, C, G, hd) ring
# buffers via kernel index maps — no per-step transpose copies),
# "bhsd_paged" (continuous batching: q in kernel layout, K/V a shared
# (num_pages, page_size, G, hd) pool consumed through per-sequence page
# tables — dispatch requires the ``page_table=`` operand).
LAYOUTS = ("bshd", "bhsd", "bhsd_bsgd", "bhsd_paged")
SCALE_KINDS = ("per_tensor", "per_head")
OUT_DTYPES = ("float", "int8")


@dataclasses.dataclass(frozen=True)
class AttentionSpec:
    """Static description of one attention computation.

    Everything a backend's ``supports()`` predicate may gate on lives
    here; dynamic data (tensors, scale values, q_offset/kv_len) does not.

    ``query_scale``: 0.0 means the default ``head_dim ** -0.5``.
    ``q_len``: static query length when known (decode bursts gate the
    fused decode kernel on it); ``None`` = unspecified.
    ``has_s_out``: whether the caller's scales carry the inter-block
    output requant grid — the fused kernels require it (their out_mult is
    ``s_v / s_out``); legacy param sets without ``s_out`` stay eligible
    for the XLA paths only.
    ``n_heads`` / ``n_kv_heads``: optional GQA declaration — when set,
    ``dispatch`` validates tensor shapes against them.
    ``ragged_q``: the caller passes a per-row ``q_lens`` vector and each
    batch row treats only its first ``q_lens[b]`` query rows as real —
    the mixed chunked-prefill/decode serve step, where one call carries
    decode rows (1 query) next to prefill rows (``chunk`` queries). Only
    the fused one-pass kernels serve it.
    """

    mode: str = "prefill"            # train | prefill | decode
    impl: str = "ita"                # float | ita | ibert
    causal: bool = True
    window: int = 0                  # sliding window size; 0 = off
    softcap: float = 0.0             # tanh logit softcap; 0 = off
    query_scale: float = 0.0         # 0 -> head_dim ** -0.5
    softmax: str = "adaptive"        # adaptive | paper (ITA §III DI)
    layout: str = "bshd"             # bshd | bhsd | bhsd_bsgd
    scale_kind: str = "per_tensor"   # per_tensor | per_head
    out_dtype: str = "float"         # float | int8 (on the s_out grid)
    has_s_out: bool = True
    q_len: int | None = None
    n_heads: int | None = None
    n_kv_heads: int | None = None
    ragged_q: bool = False

    def __post_init__(self):
        for field, value, allowed in (
                ("mode", self.mode, MODES),
                ("impl", self.impl, IMPLS),
                ("softmax", self.softmax, SOFTMAXES),
                ("layout", self.layout, LAYOUTS),
                ("scale_kind", self.scale_kind, SCALE_KINDS),
                ("out_dtype", self.out_dtype, OUT_DTYPES)):
            if value not in allowed:
                raise ValueError(
                    f"AttentionSpec.{field}={value!r} not in {allowed}")
        if self.window < 0:
            raise ValueError(f"window must be >= 0, got {self.window}")
        if self.impl == "float" and self.out_dtype == "int8":
            raise ValueError("out_dtype='int8' requires a quantized impl "
                             "(the float pipeline has no s_out grid)")
        if self.out_dtype == "int8" and not self.has_s_out:
            raise ValueError("out_dtype='int8' needs the s_out grid "
                             "(has_s_out=False declares it absent)")
        if (self.n_heads is not None and self.n_kv_heads is not None
                and self.n_heads % self.n_kv_heads != 0):
            raise ValueError(
                f"GQA requires n_kv_heads | n_heads, got "
                f"{self.n_heads}/{self.n_kv_heads}")

    @property
    def quantized(self) -> bool:
        return self.impl != "float"

    def replace(self, **kw) -> "AttentionSpec":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class QuantScales:
    """Quantization scales for the four tensor roles of the pipeline.

    Per-tensor: 0-d arrays / python floats (the QAT-calibrated path).
    Per-head: ``s_q``/``s_out`` of shape (Hq,), ``s_k``/``s_v`` of shape
    (Hkv,) (per-head KV-cache quantization). ``None`` marks an absent
    scale (float impl needs none; legacy checkpoints may lack ``s_out``).
    """

    s_q: Any = None
    s_k: Any = None
    s_v: Any = None
    s_out: Any = None

    @classmethod
    def per_tensor(cls, s_q, s_k=None, s_v=None, s_out=None):
        """Convenience: one scalar per role (s_k/s_v default to s_q)."""
        return cls(s_q=s_q, s_k=s_k if s_k is not None else s_q,
                   s_v=s_v if s_v is not None else s_q, s_out=s_out)

    @classmethod
    def from_params(cls, params) -> "QuantScales":
        """Lift the QAT scale leaves out of an attention param dict."""
        return cls(s_q=params.get("s_q"), s_k=params.get("s_k"),
                   s_v=params.get("s_v"), s_out=params.get("s_out"))

    def require(self, *names: str) -> "QuantScales":
        missing = [n for n in names if getattr(self, n) is None]
        if missing:
            raise ValueError(f"QuantScales missing {missing} "
                             "(required by the selected backend)")
        return self
