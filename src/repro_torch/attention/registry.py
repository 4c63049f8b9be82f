"""Capability-based backend registry + the single ``dispatch`` entry point
(``repro.attention.registry``).

Every attention implementation registers a ``Backend`` carrying a
``supports(spec) -> True | reason`` predicate. ``dispatch`` walks the
priority-ordered registry and runs the first eligible backend;
``backend=`` overrides the choice (still capability-checked).
``list_backends(spec)`` and ``backend_reasons(spec)`` expose the
verdicts.

Backend names are config keys (``ModelConfig.attention_backend``) shared
with the JAX package, so one config picks the same backend in both.
Backends of the JAX package that this slice of the port does not carry
yet (``UNPORTED``) raise ``NotImplementedError`` naming their slice.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Callable
from typing import Any

from repro_torch.attention.spec import AttentionSpec

SupportsFn = Callable[[AttentionSpec], bool | str]

# JAX-package backends still to be ported, and where they come in.
_BACKENDS_SLICE = ("the dispatch backends with the baseline softmaxes of "
                   "core/softmax.py (ROADMAP A4)")
UNPORTED = {name: _BACKENDS_SLICE
            for name in ("ita_direct_xla", "ibert_xla", "float_xla")}


class BackendUnsupported(ValueError):
    """Raised when a spec reaches a backend that declared it unsupported,
    or when no registered backend supports the spec."""


@dataclasses.dataclass(frozen=True)
class Backend:
    name: str
    family: str                 # exactness family (bit-identical within)
    supports: SupportsFn        # spec -> True | human-readable reason
    run: Callable[..., Any]     # (q, k, v, spec, scales, **opts) -> out
    description: str = ""


_REGISTRY: dict[str, Backend] = {}


def register_backend(backend: Backend) -> Backend:
    """Register (or replace) a backend. Registration order is priority
    order for automatic dispatch."""
    _REGISTRY[backend.name] = backend
    return backend


def get_backend(name: str) -> Backend:
    if name in UNPORTED:
        raise NotImplementedError(
            f"attention backend {name!r} is not ported yet: it comes with "
            f"{UNPORTED[name]}")
    if name not in _REGISTRY:
        raise KeyError(f"unknown attention backend {name!r}; "
                       f"registered: {list(_REGISTRY)}")
    return _REGISTRY[name]


def all_backends() -> tuple[Backend, ...]:
    return tuple(_REGISTRY.values())


def backend_reasons(spec: AttentionSpec) -> dict[str, bool | str]:
    """Every registered backend's verdict for ``spec``: ``True`` or the
    reason why not."""
    return {b.name: b.supports(spec) for b in _REGISTRY.values()}


def list_backends(spec: AttentionSpec | None = None) -> list[str]:
    """Names of backends eligible for ``spec`` in priority order (all
    registered backends when ``spec`` is None)."""
    if spec is None:
        return list(_REGISTRY)
    return [name for name, ok in backend_reasons(spec).items() if ok is True]


def _shapes(q, k, spec: AttentionSpec):
    """(sq, hq, skv, hkv, d) under the spec's layout."""
    if spec.layout == "bshd":
        sq, hq = q.shape[1], q.shape[2]
        skv, hkv = k.shape[1], k.shape[2]
    elif spec.layout == "bhsd":
        hq, sq = q.shape[1], q.shape[2]
        hkv, skv = k.shape[1], k.shape[2]
    elif spec.layout == "bhsd_paged":           # kv = (P, page, G, hd) pool
        hq, sq = q.shape[1], q.shape[2]
        skv, hkv = k.shape[1], k.shape[2]       # skv = one page here
    else:                                       # bhsd_bsgd: q bhsd, kv bsgd
        hq, sq = q.shape[1], q.shape[2]
        skv, hkv = k.shape[1], k.shape[2]
    return sq, hq, skv, hkv, q.shape[-1]


def _validate(q, k, v, spec: AttentionSpec, scales):
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(f"q/k/v must be rank-4, got "
                         f"{q.ndim}/{k.ndim}/{v.ndim}")
    sq, hq, skv, hkv, d = _shapes(q, k, spec)
    if hq % hkv != 0:
        raise ValueError(f"GQA requires kv heads | q heads under layout "
                         f"{spec.layout!r}, got hq={hq}, hkv={hkv} "
                         "(wrong layout declared?)")
    if spec.n_heads is not None and spec.n_heads != hq:
        raise ValueError(f"spec.n_heads={spec.n_heads} but q has {hq} "
                         f"heads under layout {spec.layout!r}")
    if spec.n_kv_heads is not None and spec.n_kv_heads != hkv:
        raise ValueError(f"spec.n_kv_heads={spec.n_kv_heads} but kv has "
                         f"{hkv} heads under layout {spec.layout!r}")
    if spec.q_len is not None and spec.q_len != sq:
        raise ValueError(f"spec.q_len={spec.q_len} but q length is {sq} "
                         f"under layout {spec.layout!r}")
    if spec.quantized and scales is None:
        raise ValueError(f"impl={spec.impl!r} needs QuantScales")


def dispatch(q, k, v, *, spec: AttentionSpec, scales=None,
             q_offset: Any = 0, kv_len: Any = None,
             page_table: Any = None, q_lens: Any = None,
             backend: str | None = None, **opts):
    """Run one attention computation through the registry.

    ``q``/``k``/``v``: rank-4 tensors in ``spec.layout``; integer impls
    take float tensors (quantized onto the matching scale) or int8 ones
    (consumed as they are). ``q_offset``/``kv_len``: the logical position
    of query 0 and the valid KV prefix, scalars or (B,) vectors.
    ``page_table`` (B, n_pages) int32: required by exactly the
    ``bhsd_paged`` layout, where ``k``/``v`` are a shared paged pool.
    ``q_lens`` (B,): required by exactly ``spec.ragged_q``. ``backend``:
    explicit override by name, still capability-checked. ``opts``:
    tuning knobs (``block_q``, ``block_kv``, ``q_chunk``, ``kv_chunk``).

    Returns the output in ``spec.layout``: float32, or int8 on the
    ``s_out`` grid per ``spec.out_dtype``.
    """
    if backend is not None:
        b = get_backend(backend)
        ok = b.supports(spec)
        if ok is not True:
            raise BackendUnsupported(
                f"backend {b.name!r} does not support this spec: {ok}")
    else:
        reasons = backend_reasons(spec)
        b = next((_REGISTRY[n] for n, ok in reasons.items() if ok is True),
                 None)
        if b is None:
            detail = "; ".join(f"{n}: {r}" for n, r in reasons.items())
            raise NotImplementedError(
                f"no ported backend supports {spec} (verdicts — {detail}); "
                f"the JAX package's {sorted(UNPORTED)} come with later "
                f"slices of the port")
    if (spec.layout == "bhsd_paged") != (page_table is not None):
        raise ValueError(
            "page_table= is required by exactly the 'bhsd_paged' layout "
            f"(layout={spec.layout!r}, page_table "
            f"{'missing' if page_table is None else 'given'})")
    if spec.ragged_q != (q_lens is not None):
        raise ValueError(
            "q_lens= is required by exactly ragged_q specs "
            f"(ragged_q={spec.ragged_q}, q_lens "
            f"{'missing' if q_lens is None else 'given'})")
    _validate(q, k, v, spec, scales)
    if page_table is not None:
        opts["page_table"] = page_table
    if q_lens is not None:
        opts["q_lens"] = q_lens
    return b.run(q, k, v, spec, scales, q_offset=q_offset, kv_len=kv_len,
                 **opts)
