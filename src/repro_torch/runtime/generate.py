"""Batched autoregressive generation over int8 KV rings
(``repro.runtime.generate.generate``): prefill the prompt batch, then
decode ``gen`` tokens through the ring caches.

    from repro_torch.models import init_model
    from repro_torch.runtime.generate import generate
    model = init_model(cfg, seed=0)                  # on the card
    res = generate(model, cfg, prompts, gen=32)
    res.tokens          # (B, gen) int32
    res.decode_tok_s    # decode throughput (live sequences only)

Ragged batches: ``prompt_lengths`` (B,) for right-padded prompts — each
sequence prefills, positions and decodes at its own length through the
per-row kernel meta. ``paged=True`` swaps the per-sequence rings for
shared paged KV pools (equal tokens). ``loop="fused"`` (the default)
replays the decode step from a CUDA graph captured once per shape;
``loop="stepwise"`` runs its ops eagerly, step by step (equal tokens).

``serve_continuous`` is the continuous-batching server on top: a fixed-
slot batch over the paged pool, segments of steps with host admission
between them, each step replayed from a CUDA graph when greedy.
Finished sequences release their pages. Arrived prompts enter by
chunked prefill — admission only enqueues their token ids, and the
segments prefill them chunk by chunk straight into pool pages,
interleaved with decode under a decode-maximal token budget — or, with
``admission="stall"``, by a stop-the-world prefill into a ring scratch
copied into pool pages. Throughput is sustained tok/s over the whole
arrival trace.

    from repro_torch.runtime.generate import ServeRequest, serve_continuous
    res = serve_continuous(model, cfg, [ServeRequest(prompt, gen=32)],
                           slots=4)
    res.completed[0].tokens, res.tok_s, res.ttft_quantile(0.5)
"""

from __future__ import annotations

import collections
import dataclasses
import os
import time
import weakref
from typing import Any

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.common import exact_float32_matmul


@dataclasses.dataclass
class GenerateResult:
    tokens: torch.Tensor         # (B, gen) generated token ids
    prefill_s: float             # wall clock of the prefill step
    decode_s: float              # wall clock of all decode steps
    decode_steps: int            # steps actually run (< gen-1 on early exit)
    n_decode_tokens: int         # decode tokens from *live* sequences
    capture_s: float = 0.0       # of decode_s: capturing the decode step
    graph_bytes: int = 0         # device memory of the step's graph pool
    alloc_bytes: int = 0         # allocated memory the capture added

    @property
    def decode_tok_s(self) -> float:
        return self.n_decode_tokens / max(self.decode_s, 1e-9)


LOOPS = ("fused", "stepwise")

# captured decode steps of generate(loop="fused") over caches it made
# itself, kept while their model lives: model -> {key: CapturedSteps}
_DECODE_GRAPHS = weakref.WeakKeyDictionary()
_DECODE_GRAPHS_KEPT = 4                 # per model, the most recent


def _decode_graphs(model, cfg, dev, key, generator, own_caches):
    """The ``CapturedSteps`` of a fused decode loop. A greedy loop over
    caches ``generate`` made keeps its step across calls of the same
    model, config and carry shapes (one capture, as the JAX package
    compiles its loop once), in static buffers that are the first call's
    own carry; a later call copies its carry in. A loop over the
    caller's ``caches=`` captures its own step over the caller's buffers
    (nothing copied, nothing kept), and a sampled loop its own with the
    call's generator registered."""
    from repro_torch.launch.steps import CapturedSteps
    if generator is not None or not own_caches:
        return CapturedSteps(dev, generator=generator)
    kept = _DECODE_GRAPHS.setdefault(model, collections.OrderedDict())
    key = (cfg, str(dev)) + key
    if key in kept:
        kept.move_to_end(key)
        return kept[key]
    graphs = kept[key] = CapturedSteps(dev)
    while len(kept) > _DECODE_GRAPHS_KEPT:
        kept.popitem(last=False)
    return graphs


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _validate_ragged(cfg, lengths, prompt_len: int):
    if not cfg.causal:
        raise ValueError("ragged prompts need causal attention (pad "
                         "columns must be invisible to valid rows)")
    kinds = {k for pat, _ in cfg.layer_groups for k in pat}
    recurrent = kinds - {"attn", "local", "swa", "enc", "cross",
                         "attn_cross"}
    if recurrent:
        raise ValueError(
            f"ragged prompts are attention-only (recurrent blocks "
            f"{sorted(recurrent)} would roll pad tokens into their state)")
    for kind, cap in (("swa", cfg.window), ("local", cfg.local_window)):
        if kind in kinds and cap < prompt_len:
            raise ValueError(
                f"ragged prompts need ring capacity >= the padded prompt "
                f"length; {kind!r} blocks cap it at {cap} < {prompt_len}")
    if lengths.ndim != 1:
        raise ValueError("prompt_lengths must be a (B,) vector")
    lo, hi = int(lengths.min()), int(lengths.max())
    if lo < 1 or hi > prompt_len:
        raise ValueError(f"prompt_lengths must lie in [1, {prompt_len}] "
                         f"(the padded prompt width); got "
                         f"{lengths.tolist()}")


def _first_paged(caches):
    """The first attention layer's ``PagedKVState`` (an ``attn_cross``
    layer's self-attention pool included), or None for ring caches (and
    for stacks without self-attention layers)."""
    from repro_torch.attention import PagedKVState
    return next((c["mix"] for c in caches
                 if isinstance(c["mix"], PagedKVState)), None)


def _validate_pool_provision(caches, batch: int, tokens_per_seq: int):
    """Lockstep generate() has no admission scheduler rationing pages, so
    an undersized pool would overdraw the on-device allocator mid-loop —
    refuse up front. The worst case is exact: every sequence grows to
    min(tokens, window)."""
    paged = _first_paged(caches)
    if paged is None:
        return
    page, npps = paged.page_size, paged.pages_per_seq
    per_seq = min(-(-min(tokens_per_seq, npps * page) // page), npps)
    if batch * per_seq > paged.num_pages - 1:
        raise ValueError(
            f"paged pool undersized for lockstep generate: {batch} "
            f"sequences x {per_seq} pages each > {paged.num_pages - 1} "
            f"allocatable pages (num_pages={paged.num_pages}, page_size="
            f"{page}) — raise num_pages, or serve through "
            f"serve_continuous, whose admission scheduler rations an "
            f"oversubscribed pool")


def _validate_frontend(cfg, frontend, batch: int):
    """A stack with cross layers needs ``frontend=`` (B,
    n_frontend_tokens, frontend_dim) — the JAX package fails on it with a
    ``TypeError`` deep in the first cross layer; the port names it."""
    from repro_torch.models.transformer import has_cross
    if frontend is None:
        if has_cross(cfg):
            raise ValueError(
                f"{cfg.name} has cross-attention layers: generate() needs "
                f"frontend= embeddings of shape ({batch}, "
                f"{cfg.n_frontend_tokens}, {cfg.frontend_dim})")
        return
    want = (batch, cfg.n_frontend_tokens, cfg.frontend_dim)
    if tuple(frontend.shape) != want:
        raise ValueError(f"frontend= of shape {tuple(frontend.shape)}; "
                         f"{cfg.name} takes {want}")


def _validate_caches(caches, cfg, batch: int, max_len: int, dev):
    """Reused ``caches=`` must match what this call would allocate: rings
    of this batch and max_len, or paged pools of this batch and max_len
    (pool and page size are free choices), and the recurrent layers'
    state tensors, with the mismatched field named."""
    from repro_torch.models import init_caches
    paged = _first_paged(caches)
    kw = {}
    if paged is not None:
        if paged.batch != batch:
            raise ValueError(
                f"caches= batch mismatch: page tables hold {paged.batch} "
                f"slots but this call decodes batch={batch}")
        kw = dict(paged=True, page_size=paged.page_size,
                  num_pages=paged.num_pages)
    expected = init_caches(cfg, batch, max_len, device="cpu", **kw)
    if len(caches) != len(expected):
        raise ValueError(f"caches= holds {len(caches)} layers, "
                         f"{cfg.name!r} has {len(expected)}")
    fields = ("k", "page_table", "free_stack") if paged is not None \
        else ("k",)

    def cross(i, c, e, key):
        """(name, got, want) of a static cross cache ``{"k8", "v8"}``."""
        if not isinstance(c.get(key), dict) or set(c[key]) != set(e[key]):
            raise ValueError(f"caches= layer {i} {key!r} is not the "
                             f"cross cache {{k8, v8}} of {cfg.name!r}")
        return [(f"{key}.{leaf}", c[key][leaf], e[key][leaf])
                for leaf in e[key]]

    def tensors(i, c, e):
        """(name, got, want) of layer ``i``'s tensors."""
        if isinstance(e["mix"], dict) and "k8" in e["mix"]:
            return cross(i, c, e, "mix")        # a cross layer
        if isinstance(e["mix"], dict):          # a recurrent layer
            if set(c) != set(e) or any(
                    not isinstance(c[k], dict) or set(c[k]) != set(e[k])
                    for k in e):
                raise ValueError(f"caches= layer {i} is not the recurrent "
                                 f"state {{{', '.join(sorted(e))}}} of "
                                 f"{cfg.name!r}")
            return [(f"{k}.{leaf}", c[k][leaf], e[k][leaf])
                    for k in e for leaf in e[k]]
        if type(c["mix"]) is not type(e["mix"]):
            raise ValueError(f"caches= layer {i} mixes ring and paged "
                             f"caches")
        return [(f, getattr(c["mix"], f), getattr(e["mix"], f))
                for f in fields] + (cross(i, c, e, "cross")
                                    if "cross" in e else [])

    for i, (c, e) in enumerate(zip(caches, expected, strict=True)):
        for f, got, want in tensors(i, c, e):
            if got.shape != want.shape or got.dtype != want.dtype \
                    or got.device != dev:
                raise ValueError(
                    f"caches= layer {i} {f} {tuple(got.shape)}/{got.dtype}"
                    f" on {got.device} does not match batch={batch}, "
                    f"max_len={max_len} ({tuple(want.shape)}/{want.dtype} "
                    f"on {dev})")


def generate(model, cfg, prompts, gen: int, *, frontend=None,
             temperature: float = 0.0,
             generator: torch.Generator | None = None,
             max_len: int | None = None, caches=None, prompt_lengths=None,
             eos_id: int | None = None, pad_id: int = 0,
             early_exit: bool = False, paged: bool = False,
             page_size: int = 128, num_pages: int | None = None,
             loop: str = "fused", device="cuda") -> GenerateResult:
    """Prefill the prompt batch, then decode ``gen`` tokens.

    ``prompts`` (B, S) int, right-padded when ``prompt_lengths`` (B,)
    declares a ragged batch. ``frontend`` (B, n_frontend_tokens,
    frontend_dim): an encoder–decoder model's frontend embeddings (a
    stack with cross layers needs it), encoded once at prefill into the
    cross layers' static caches, which the decode steps only read: the
    decode step (captured or eager) never runs the encoder, where the
    JAX package passes the frontend to every step and XLA drops the
    unused encoder. ``max_len`` sizes the KV rings (default
    S + gen; smaller values evict the oldest tokens; capacities above one
    KV block are block-aligned). ``paged=True`` allocates the KV as
    shared paged pools (``PagedKVState``, ``page_size``/``num_pages``;
    equal tokens to the rings at ``page_size`` = the ring's KV block).
    ``caches`` reuses rings or pools from ``init_caches`` (validated
    against batch, max_len and the pool geometry). ``temperature
    > 0`` with a ``generator`` samples; otherwise decoding is greedy.
    ``eos_id``: sequences that emit it are pinned to ``pad_id`` and stop
    counting toward ``decode_tok_s``; ``early_exit`` stops once all have
    (a host check per step). ``loop="fused"`` replays the decode step
    from a CUDA graph (``launch.steps.CapturedSteps``), captured at the
    first call of a model, config and shape — its capture time
    (``capture_s``) is part of that call's ``decode_s``, as the JAX
    package's compile is — and kept while the model lives, its static
    buffers holding one set of caches; over ``caches=`` or sampling, per
    call (the caller's buffers are the graph's; the generator is
    registered with it). ``loop="stepwise"`` runs the step's ops eagerly
    (equal tokens). ``device`` (default the card; raises when CUDA is
    missing) must hold the model.
    """
    from repro_torch.launch.steps import (make_generate_loop,
                                          make_prefill_step, sample_token,
                                          tree_leaves)
    from repro_torch.models import init_caches

    if loop not in LOOPS:
        raise ValueError(f"loop={loop!r} not in {LOOPS}")
    if early_exit and eos_id is None:
        raise ValueError("early_exit needs an eos_id to exit on")
    dev = resolve_device(device)
    if model.embed.device != dev:
        raise ValueError(f"the model lives on {model.embed.device}, not on "
                         f"{dev}")
    exact_float32_matmul()
    prompts = torch.as_tensor(prompts, device=dev).long()
    b, prompt_len = prompts.shape
    _validate_frontend(cfg, frontend, b)
    if gen <= 0:
        return GenerateResult(torch.zeros((b, 0), dtype=torch.int32,
                                          device=dev), 0.0, 0.0, 0, 0)
    max_len = max_len or prompt_len + gen
    own_caches = caches is None
    if own_caches:
        caches = init_caches(cfg, b, max_len, paged=paged,
                             page_size=page_size, num_pages=num_pages,
                             device=dev)
    else:
        _validate_caches(caches, cfg, b, max_len, dev)
    _validate_pool_provision(caches, b, prompt_len + gen)
    lengths = None
    if prompt_lengths is not None:
        lengths = torch.as_tensor(prompt_lengths, dtype=torch.int32,
                                  device=dev)
        _validate_ragged(cfg, lengths, prompt_len)

    sample = temperature > 0.0 and generator is not None
    temperature = temperature if sample else 1.0

    with torch.inference_mode():
        _sync(dev)
        t0 = time.perf_counter()
        logits, caches = make_prefill_step(cfg)(model, prompts, caches,
                                                lengths, frontend)
        tok = sample_token(logits, generator, temperature, sample=sample)
        _sync(dev)
        t_prefill = time.perf_counter() - t0

        pos0 = lengths if lengths is not None else torch.full(
            (b,), prompt_len, dtype=torch.int32, device=dev)
        run = make_generate_loop(cfg, gen=gen, sample=sample,
                                 eos_id=eos_id, pad_id=pad_id,
                                 early_exit=early_exit)
        graphs = None
        if loop == "fused":
            shapes = tuple((tuple(t.shape), t.dtype) for t in
                           tree_leaves((tok, pos0, caches)))
            graphs = _decode_graphs(model, cfg, dev,
                                    (eos_id, pad_id, shapes),
                                    generator if sample else None,
                                    own_caches)
        captured = graphs.capture_s if graphs is not None else 0.0
        t0 = time.perf_counter()
        rest, n_dec, steps_run, caches = run(model, tok, caches, pos0,
                                             generator, temperature, graphs)
        tokens = torch.cat([tok, rest], dim=1)
        _sync(dev)
        t_decode = time.perf_counter() - t0

    return GenerateResult(
        tokens=tokens, prefill_s=t_prefill, decode_s=t_decode,
        decode_steps=steps_run, n_decode_tokens=int(n_dec),
        capture_s=graphs.capture_s - captured if graphs is not None else 0.0,
        graph_bytes=graphs.graph_bytes if graphs is not None else 0,
        alloc_bytes=graphs.alloc_bytes if graphs is not None else 0)


# ---------------------------------------------------------------------------
# Continuous batching: paged pool + admission scheduler + segments
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ServeRequest:
    """One request of an arrival trace. ``arrival`` is in virtual time
    units = decode steps (the scheduler's clock); ``gen`` counts every
    generated token including the one sampled from the prompt.
    ``priority`` is the request's SLO class (higher = more urgent): it
    orders admission and the mixed steps' prompt-chunk budget, and picks
    preemption victims (strictly lower classes only). ``request_id`` is
    the request's stable identity in the journal: re-submitting the same
    id after a crash dedupes against it (a completed request is replayed,
    not served twice). Unset, it is ``req-<trace index>``; ids are unique
    per trace."""
    prompt: Any                      # (S,) int token ids
    gen: int
    arrival: int = 0
    priority: int = 0
    request_id: str | None = None


@dataclasses.dataclass
class CompletedRequest:
    index: int                       # position in the submitted trace
    arrival: int                     # virtual (step) arrival time
    admitted_step: int               # step count when first admitted
    finished_step: int               # step count when the slot freed
    arrived_s: float                 # wall clock when first admittable
    finished_s: float                # wall clock at the freeing boundary
    tokens: Any                      # (gen,) int32 generated ids
    first_token_s: float = 0.0       # wall clock of the first emitted token
    priority: int = 0                # the request's SLO class
    preemptions: int = 0             # times this request was evicted
    replayed: bool = False           # rebuilt from the journal, not served

    @property
    def latency_s(self) -> float:
        return self.finished_s - self.arrived_s

    @property
    def ttft_s(self) -> float:
        """Time to first token: queue wait + prompt processing."""
        return self.first_token_s - self.arrived_s


@dataclasses.dataclass
class ServeResult:
    completed: list                  # CompletedRequest, completion order
    wall_s: float                    # whole-trace wall clock
    steps: int                       # decode steps executed
    segments: int                    # segments run
    admission_rounds: int            # admission writes
    page_util: list                  # (step, fraction of pool pages held)
    prefill_stall_s: float = 0.0     # wall spent in stop-the-world prefill
                                     # (0 under chunked admission)
    prefill_tokens: int = 0          # prompt tokens prefilled
    shared_prefix_tokens: int = 0    # prompt tokens skipped by adoption
    prefix_hits: int = 0             # admissions that adopted >= 1 page
    preemptions: int = 0             # victim evictions (fault kills too)
    straggler_segments: int = 0      # segments the watchdog flagged slow
    drained: bool = False            # a graceful drain cut the serve short
    recovered: bool = False          # this serve resumed from a journal
    restored_from_snapshot: bool = False   # warm pool/index restore hit
    replayed_tokens: int = 0         # tokens recovered from the journal
    snapshot_bytes: int = 0          # last snapshot's leaf bytes
    recovery_s: float = 0.0          # wall spent in replay + restore
    snapshots: int = 0               # snapshots taken
    snapshot_s: float = 0.0          # caller wall blocked in them (device
                                     # -> host copy, checksums)
    aging_steps: int | None = None   # starvation-aging period (None = off)
    max_class: int = 0               # highest SLO class in the trace
    capture_s: float = 0.0           # of wall_s: capturing the serve steps
    graph_bytes: int = 0             # device memory of their graph pools
    alloc_bytes: int = 0             # allocated memory the captures added

    @property
    def total_tokens(self) -> int:
        return sum(int(np.asarray(c.tokens).size) for c in self.completed)

    @property
    def prefix_hit_rate(self) -> float:
        """Fraction of completed requests admitted with a shared prefix."""
        return self.prefix_hits / max(len(self.completed), 1)

    @property
    def tok_s(self) -> float:
        return self.total_tokens / max(self.wall_s, 1e-9)

    @property
    def prefill_stall_frac(self) -> float:
        return self.prefill_stall_s / max(self.wall_s, 1e-9)

    def _quantile(self, values, q: float) -> float:
        vals = sorted(values)
        if not vals:
            return 0.0
        return vals[min(int(q * len(vals)), len(vals) - 1)]

    def _of_class(self, priority):
        return (c for c in self.completed
                if priority is None or c.priority == priority)

    def latency_quantile(self, q: float, priority: int | None = None):
        return self._quantile(
            (c.latency_s for c in self._of_class(priority)), q)

    def ttft_quantile(self, q: float, priority: int | None = None):
        return self._quantile(
            (c.ttft_s for c in self._of_class(priority)), q)

    def admission_delay_quantile(self, q: float,
                                 priority: int | None = None):
        """Virtual-time TTFT proxy: decode steps from arrival to first
        admission (deterministic, no wall clock)."""
        return self._quantile(
            (c.admitted_step - c.arrival for c in self._of_class(priority)),
            q)

    def class_summary(self) -> dict:
        """Per SLO class: count, preemptions suffered, p95 TTFT, latency
        and admission delay, the worst admission delay, and with aging
        on, ``aging_bound_steps``: the wait after which a request of the
        class reaches the priority cap and no new arrival overtakes it."""
        out = {}
        for c in self.completed:
            d = out.setdefault(c.priority, {"n": 0, "preemptions": 0})
            d["n"] += 1
            d["preemptions"] += c.preemptions
        for prio, d in out.items():
            d["p95_ttft_s"] = self.ttft_quantile(0.95, priority=prio)
            d["p95_latency_s"] = self.latency_quantile(0.95, priority=prio)
            d["p95_admit_delay_steps"] = self.admission_delay_quantile(
                0.95, priority=prio)
            d["max_admit_delay_steps"] = max(
                (c.admitted_step - c.arrival for c in self._of_class(prio)),
                default=0)
            if self.aging_steps is not None:
                d["aging_bound_steps"] = self.aging_steps * (
                    self.max_class + 1 - prio)
        return out


def _each_pool(caches, fn):
    """``caches`` with ``fn`` applied to every layer's pool."""
    return [dict(c, mix=fn(c["mix"])) for c in caches]


def _release_slots(caches, finished):
    """Hand every finished slot's pages (all layers) back to the pools."""
    finished = torch.as_tensor(finished, dtype=torch.bool,
                               device=caches[0]["mix"].pos.device)
    return _each_pool(caches, lambda p: p.release(finished))


def _adopt_prefix_slots(caches, slot_ids, pages, n_pages, n_tokens):
    """Point admitted slots' leading table entries at the shared prefix
    pages in every layer's pool (the allocators run in lockstep, so one
    page id means the same page in all of them). Rows of slot -1 or with
    ``n_pages`` 0 change nothing."""
    return _each_pool(caches, lambda p: p.adopt_prefix(slot_ids, pages,
                                                       n_pages, n_tokens))


def _pin_pages(caches, pages):
    """+1 refcount on ``pages`` in every layer's pool: the prefix index's
    registration pin."""
    return _each_pool(caches, lambda p: p.incref_pages(pages))


def _unpin_pages(caches, pages):
    """Drop the index pin on ``pages`` in every layer's pool; pages that
    reach refcount 0 return to the free stacks."""
    return _each_pool(caches, lambda p: p.decref_pages(pages))


def _check_paged_invariants(caches, pins=None):
    """``check_invariants`` on every layer's pool, ``pins`` the host's
    {page: count} pin ledger (a readback per layer: debug only)."""
    for c in caches:
        c["mix"].check_invariants(pins=pins)


def _adopt_prompts(caches, scratch, slot_ids, lengths):
    """Copy freshly prefilled ring K/V bytes from ``scratch`` into pool
    pages at the admitted slots (``PagedKVState.write_prompts``), every
    layer: the stall admission's hand-off. Rows of slot -1 are padding
    and dropped. The ring holds exactly the quantized bytes decode will
    read, so the adopted pages equal a prefill straight into the pool."""
    return [dict(c, mix=c["mix"].write_prompts(t["mix"].k, t["mix"].v,
                                               lengths=lengths,
                                               slots=slot_ids))
            for c, t in zip(caches, scratch, strict=True)]


def _validate_serve_cfg(cfg, admission: str = "chunked", chunk: int = 1):
    from repro_torch import attention as ATT
    from repro_torch.models.attention import make_spec
    kinds = {k for pat, _ in cfg.layer_groups for k in pat}
    if not kinds <= {"attn", "local", "swa"}:
        raise ValueError(
            f"continuous batching serves decoder-only attention stacks "
            f"(got block kinds {sorted(kinds)})")
    if not cfg.causal:
        raise ValueError("continuous batching needs causal attention")
    specs = [("paged decode", dict(q_len=1))]
    if admission == "chunked":
        # the mixed segment's ragged chunked-prefill call must be servable
        specs.append(("ragged chunked-prefill paged decode",
                      dict(q_len=chunk, ragged_q=True)))
    for kind in kinds:
        window = {"attn": 0, "local": cfg.local_window,
                  "swa": cfg.window}[kind]
        for what, kw in specs:
            spec = make_spec(cfg, mode="decode", causal=True, window=window,
                             layout="bhsd_paged", **kw)
            if not ATT.list_backends(spec):
                reasons = "; ".join(f"{n}: {r}" for n, r in
                                    ATT.backend_reasons(spec).items())
                raise ValueError(
                    f"no attention backend serves the {what} spec for "
                    f"{kind!r} blocks of {cfg.name!r} — {reasons}")


ADMISSIONS = ("chunked", "stall")


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def serve_continuous(model, cfg, requests, *, slots: int,
                     segment: int = 16, max_len: int | None = None,
                     page_size: int = 128, num_pages: int | None = None,
                     temperature: float = 0.0, seed: int | None = None,
                     eos_id: int | None = None, pad_id: int = 0,
                     admission: str = "chunked", chunk_size: int = 32,
                     token_budget: int | None = None,
                     prefix_sharing: bool = False,
                     preemption: bool = False, faults=None,
                     straggler_factor: float = 2.0,
                     debug_invariants: bool | None = None,
                     audit=None, journal_dir: str | None = None,
                     snapshot_every: int = 0, resume: bool = False,
                     drain=None, drain_timeout: float | None = None,
                     aging_steps: int | None = None,
                     device="cuda") -> ServeResult:
    """Serve an arrival trace with continuous batching over a paged pool
    (``repro.runtime.generate.serve_continuous``).

    A fixed-slot batch (``slots`` wide) runs segments of ``segment``
    steps; between segments the host scheduler (1) releases the pages of
    every finished sequence, (2) admits arrived requests into free slots
    and (3) reads back the segment's tokens — once per segment. Virtual
    time = decode steps (request ``arrival`` is in steps).

    Admission reserves the request's worst-case page need (``ceil((len +
    gen) / page_size)``, capped at the per-slot window), so the on-device
    allocator is never overdrawn mid-segment. ``admission`` selects how
    a prompt enters:

    - ``"chunked"`` (default): admission enqueues the prompt's token ids
      into the slot state; the segments prefill it in ``chunk_size``-token
      chunks, page-native, interleaved with decode under a decode-maximal
      per-step ``token_budget`` (default ``slots - 1 + chunk_size``).
    - ``"stall"``: the stop-the-world path kept for A/B parity. Each
      admission round runs one ragged prefill of the admitted prompts
      over a ring scratch (``slots`` rows of the longest prompt,
      allocated once), samples their first tokens, copies the K/V bytes
      into pool pages and enters the slots in the decode phase; every
      decode slot waits meanwhile (``ServeResult.prefill_stall_s``). A
      request of one token, or whose first token is EOS, finishes in its
      admission round.

    Admission order: SLO class (aged, with ``aging_steps``), then
    arrival, then trace position; the head of the queue waits for pages
    (no overtaking). ``audit`` (testing hook) is called after every
    admission round with the caches, the slot->request map and the pin
    ledger. ``debug_invariants`` (or env ``ITA_PAGED_DEBUG=1``) checks
    the allocator invariants of every layer after every round.

    ``prefix_sharing=True`` (chunked only) shares identical prompt
    prefixes through the pool: every full page of prompt tokens a slot
    prefills is registered in a host ``PrefixIndex`` and pinned (+1
    refcount) so it outlives its request, and a later admission whose
    prompt walks the same chain adopts those pages
    (``PagedKVState.adopt_prefix``) instead of reserving and prefilling
    them. At least one prompt token always prefills (the first sampled
    token needs live logits), and only requests that cannot wrap their
    window (``len + gen <= capacity``) share or donate, so serving never
    overwrites an adopted page. Under page pressure the index evicts idle
    pins (LRU, pages of active adopters protected) before the head of the
    queue waits.

    ``preemption=True`` (chunked only) lets admission make room for a
    higher-class arrival when the pool or the slots are full: victims of
    strictly lower (aged) class, lowest class first, then most reserved
    pages, are evicted all together or not at all (``steps.
    preempt_rows``); their pages go back (pinned prefix pages lose a
    reference, never freed) and their requests re-enter the queue
    carrying the prompt plus every token generated so far, to be
    re-prefilled through chunked admission with the budget left. A
    victim's sampling generator state is kept at eviction and restored at
    re-admission, so greedy and sampled tokens equal an unpreempted
    serve's. Only requests whose whole stream fits the window are
    preemptable. ``faults`` (a ``runtime.fault_tolerance.ServeFaultPlan``,
    chunked only) injects seeded kills (the same eviction, whatever
    ``preemption``), phantom page pressure on one round's budget, sleeps
    before segments and crashes (``SimulatedCrash``). A segment's wall
    time, from before its injected sleep to its readback, feeds a
    ``StragglerWatchdog`` at ``straggler_factor`` times the moving median
    (``ServeResult.straggler_segments``). ``aging_steps`` raises a
    waiting request's class by one every that many virtual steps, capped
    one above the trace's highest class, which bounds the low class's
    admission delay (``class_summary()``).

    Greedy serving equals generating each request alone (``generate``
    with the ``ita_onepass_pallas`` pin, the same ``max_len``), under
    either admission, with prefix sharing and through preemption: the
    chunks stream the same KV tile schedule when ``page_size`` equals the
    fused ``block_kv`` (128), and the projections give a token the same
    bits in any batch (``models.layers.linear``), so a page's bytes
    depend on its tokens and page-aligned position only. On the card a
    greedy serve replays its steps from two CUDA graphs, the mixed
    step's and the decode step's (``steps.CapturedSteps``, captured at
    their first use in the serve; ``capture_s``); admission, adoption,
    pins and evictions run eagerly between segments and the next step
    copies their tensors into the graphs' buffers. ``temperature > 0``
    with a ``seed`` samples each request from its own generator
    (``steps.request_generator(seed, index)``), independent of arrival
    order and co-scheduled traffic; a sampled step reads its emitting
    rows back to the host to draw from their generators, so sampled
    serving runs its steps eagerly.

    **Crash safety** (``runtime.journal``): ``journal_dir`` turns on a
    write-ahead request journal — admissions, each request's emitted
    tokens and (sampling) generator state, flushed at every segment
    boundary, and completions — and, with ``snapshot_every=N``, a
    ``Checkpointer`` snapshot of the paged pools and the prefix index
    every N segments. ``resume=True`` replays the journal first:
    completed requests (matched by ``ServeRequest.request_id``) come back
    as replayed ``CompletedRequest``s without being served twice, and
    every unfinished request is rebuilt as a pending ``prompt ++
    emitted`` stream with its journaled generator state and re-admitted
    through the preemption resume, so greedy and sampled tokens equal a
    serve that never crashed. A usable snapshot (checksums, version and
    geometry checked, every row released, the allocator invariants
    checked against the pins) warm-starts the pools and the prefix index
    before the first segment, so the captured steps bind to the restored
    pools; any snapshot problem falls back to a cold start from the
    journal, never to other tokens. ``drain`` (a ``journal.ServeDrain``)
    stops admission and lets in-flight work finish — or, past
    ``drain_timeout`` seconds, stops at the next boundary with its
    progress journaled — then takes a final snapshot. ``device``
    (default the card; raises when CUDA is missing) must hold the model.
    """
    from repro_torch.attention import PrefixIndex
    from repro_torch.checkpoint.checkpointing import (CheckpointCorrupt,
                                                      Checkpointer)
    from repro_torch.launch.steps import (CapturedSteps, ServeSlotState,
                                          admit_chunked, admit_stall,
                                          aged_priority, make_prefill_step,
                                          make_serve_segment, preempt_rows,
                                          request_generator,
                                          sample_token_rows, tree_leaves)
    from repro_torch.models import init_caches
    from repro_torch.runtime.fault_tolerance import (ServeFaultInjector,
                                                     SimulatedCrash)
    from repro_torch.runtime.journal import (JOURNAL_VERSION, ServeJournal,
                                             check_fingerprint,
                                             generator_state, prompt_digest,
                                             state_hex)
    from repro_torch.runtime.watchdog import StragglerWatchdog

    if admission not in ADMISSIONS:
        raise ValueError(f"admission={admission!r} not in {ADMISSIONS}")
    if (preemption or faults is not None) and admission != "chunked":
        raise ValueError(
            "preemption / fault injection require admission='chunked' "
            "(victims resume through chunked re-prefill of their "
            "prompt + generated prefix)")
    if prefix_sharing and admission != "chunked":
        raise ValueError(
            "prefix_sharing requires admission='chunked' (stall-mode "
            "prefill bypasses the page-native write path)")
    if aging_steps is not None and aging_steps <= 0:
        raise ValueError(f"aging_steps={aging_steps} must be positive")
    dev = resolve_device(device)
    if model.embed.device != dev:
        raise ValueError(f"the model lives on {model.embed.device}, not on "
                         f"{dev}")
    exact_float32_matmul()
    _validate_serve_cfg(cfg, admission=admission, chunk=max(1, chunk_size))
    requests = list(requests)
    if not requests:
        return ServeResult([], 0.0, 0, 0, 0, [])
    injector = ServeFaultInjector(faults) if faults is not None else None
    watchdog = StragglerWatchdog(factor=straggler_factor)
    may_preempt = preemption or (injector is not None
                                 and injector.plan.may_kill)
    prompts_np = [np.asarray(r.prompt, np.int32).reshape(-1)
                  for r in requests]
    prompt_pad = max(p.size for p in prompts_np)
    longest = max(p.size + r.gen for p, r in zip(prompts_np, requests,
                                                  strict=True))
    max_len = max_len or longest
    sample = temperature > 0.0 and seed is not None
    temp = temperature if sample else 1.0

    caches = init_caches(cfg, slots, max_len, paged=True,
                         page_size=page_size, num_pages=num_pages,
                         device=dev)
    geo = _first_paged(caches)
    pool_pages = geo.num_pages - 1                 # minus parking
    pages_per_seq = geo.pages_per_seq
    capacity = pages_per_seq * page_size

    # pending streams: what admission prefills per request — the prompt,
    # or after a preemption the prompt + generated prefix with the budget
    # left. The page need is the same across resumes, so only requests
    # whose whole stream fits the window are resumable, and the prompt
    # buffer holds up to plen + gen - 1 tokens for them
    pending = {i: (p, int(r.gen)) for i, (p, r) in enumerate(
        zip(prompts_np, requests, strict=True))}
    prio_req = [int(r.priority) for r in requests]
    resumable = [p.size + r.gen <= capacity
                 for p, r in zip(prompts_np, requests, strict=True)]
    max_class = max(prio_req, default=0)

    # -- write-ahead journal and its replay (runtime.journal) -------------
    journal = fingerprint = None
    seed_emitted, seed_gens = {}, {}     # index -> journaled tokens, state
    replayed_completed, done_replayed = [], set()
    replayed_tokens, recovered, recovery_s = 0, False, 0.0
    rids = [r.request_id if r.request_id is not None else f"req-{i:06d}"
            for i, r in enumerate(requests)]
    if len(set(rids)) != len(rids):
        dup = sorted({r for r in rids if rids.count(r) > 1})
        raise ValueError(f"duplicate request_id(s): {dup} — journal "
                         f"dedupe needs ids unique per trace")
    if journal_dir is not None:
        t_rec = time.perf_counter()
        os.makedirs(journal_dir, exist_ok=True)
        jpath = os.path.join(journal_dir, "journal.jsonl")
        fingerprint = {
            "journal_version": JOURNAL_VERSION, "arch": cfg.name,
            "page_size": int(page_size), "max_len": int(max_len),
            "temperature": float(temperature), "sample": bool(sample),
            "eos_id": eos_id, "pad_id": int(pad_id),
            # a generator's state is its device type's (mt19937 on the
            # CPU, a Philox seed and offset on the card), and the two draw
            # other tokens: a resume across them is refused
            "key": [int(seed), dev.type] if sample else None}
        jreplay = None
        if resume and os.path.exists(jpath) and os.path.getsize(jpath):
            jreplay = ServeJournal.replay(jpath)
            if jreplay.header is None:
                raise ValueError(
                    f"{jpath}: no intact header record — not a serve "
                    f"journal (or its very first write was torn)")
            check_fingerprint(jreplay.header["fingerprint"], fingerprint)
            recovered = True
        journal = ServeJournal(jpath, fingerprint=fingerprint,
                               fresh=jreplay is None)
        for i, r in enumerate(requests):
            digest = prompt_digest(prompts_np[i])
            sub = jreplay.submits.get(rids[i]) if jreplay else None
            if sub is not None:
                # the same id must mean the same request: a digest or
                # shape mismatch is id reuse, not a resume
                if (sub["digest"] != digest or sub["gen"] != int(r.gen)
                        or sub["i"] != i):
                    raise ValueError(
                        f"request_id {rids[i]!r} reused for a different "
                        f"request (journal has index {sub['i']}, gen "
                        f"{sub['gen']}, digest {sub['digest']})")
            else:
                journal.append({"t": "submit", "rid": rids[i], "i": i,
                                "digest": digest, "gen": int(r.gen),
                                "arrival": int(r.arrival),
                                "priority": prio_req[i]})
            if jreplay is None:
                continue
            toks = [int(x) for x in jreplay.emitted.get(rids[i], [])]
            comp = jreplay.completes.get(rids[i])
            # a torn flush can keep the complete record but lose the same
            # boundary's progress, so the journaled token count decides: a
            # short stream resumes and generates its tail again
            needed = int(comp["n"]) if comp is not None else int(r.gen)
            if len(toks) >= needed:
                # finished before the crash: replayed, never served twice
                comp = comp or {}
                replayed_tokens += needed
                replayed_completed.append(CompletedRequest(
                    index=i, arrival=int(r.arrival),
                    admitted_step=int(comp.get("admitted_step", 0)),
                    finished_step=int(comp.get("finished_step", 0)),
                    arrived_s=float(comp.get("arrived_s", 0.0)),
                    finished_s=float(comp.get("finished_s", 0.0)),
                    first_token_s=float(comp.get("first_token_s", 0.0)),
                    tokens=np.asarray(toks[:needed], np.int32),
                    priority=prio_req[i],
                    preemptions=int(comp.get("preemptions", 0)),
                    replayed=True))
                done_replayed.add(i)
            elif toks and resumable[i] \
                    and (not sample or rids[i] in jreplay.keys):
                # unfinished: resumed as if preempted at its last
                # journaled boundary, with the budget left and its
                # generator state
                pending[i] = (np.concatenate([prompts_np[i],
                                              np.asarray(toks, np.int32)]),
                              int(r.gen) - len(toks))
                seed_emitted[i] = toks
                replayed_tokens += len(toks)
                if sample:
                    seed_gens[i] = generator_state(jreplay.keys[rids[i]])
            # else nothing journaled (or not resumable): the request
            # starts over from its prompt and its sampling stream from
            # its seed, so its tokens come out the same, generated again
        journal.flush()
        recovery_s = time.perf_counter() - t_rec
    if may_preempt or seed_emitted:
        prompt_pad = max(p.size + (r.gen - 1 if resumable[i] else 0)
                         for i, (p, r) in enumerate(
                             zip(prompts_np, requests, strict=True)))

    def eff_prio(i, at_step):
        return aged_priority(prio_req[i], at_step - requests[i].arrival,
                             aging_steps, max_class)

    index = None
    if prefix_sharing:
        geos = {(c["mix"].num_pages, c["mix"].page_size,
                 c["mix"].pages_per_seq) for c in caches}
        if len(geos) > 1:
            raise ValueError(
                f"prefix_sharing needs one uniform pool geometry across "
                f"all attention layers (one physical page id must mean "
                f"the same logical page everywhere), got {sorted(geos)}")
        index = PrefixIndex(page_size)
    debug = debug_invariants if debug_invariants is not None \
        else bool(os.environ.get("ITA_PAGED_DEBUG"))
    chunk = max(1, min(chunk_size, capacity))
    budget = token_budget if token_budget is not None \
        else slots - 1 + chunk
    if budget < slots:
        raise ValueError(
            f"token_budget={budget} < slots={slots}: a decode-maximal "
            f"step must cover every decoding slot plus at least one "
            f"prefill token")
    # greedy steps replay from CUDA graphs shared by every segment
    graphs = None if sample else CapturedSteps(dev)
    seg_fns = {}

    def seg_fn(mixed_steps):
        # mixed_steps 0: pure decode. Otherwise a two-phase segment:
        # chunk-wide mixed steps sized to the prompt chunks actually
        # outstanding (rounded up to a power of two, as the JAX package
        # bounds its compilations), then 1-token decode steps
        if mixed_steps not in seg_fns:
            seg_fns[mixed_steps] = make_serve_segment(
                cfg, segment=segment, sample=sample, eos_id=eos_id,
                pad_id=pad_id, chunk=chunk if mixed_steps else None,
                budget=budget, mixed_steps=mixed_steps or None,
                graphs=graphs)
        return seg_fns[mixed_steps]

    def pages_for(i):
        n = prompts_np[i].size + requests[i].gen
        return min(-(-n // page_size), pages_per_seq)

    for idx in range(len(requests)):
        plen = prompts_np[idx].size
        if plen > capacity:
            raise ValueError(
                f"request {idx}: prompt length {plen} exceeds the per-slot "
                f"window {capacity}; raise max_len")
        if pages_for(idx) > pool_pages:
            raise ValueError(
                f"request {idx} needs {pages_for(idx)} pages but the pool "
                f"has {pool_pages}; raise num_pages")

    # stall admission: one ring scratch for the admission prefills (fully
    # overwritten by every ragged prefill), allocated once per serve
    scratch = init_caches(cfg, slots, prompt_pad, device=dev) \
        if admission == "stall" else None
    prefill = make_prefill_step(cfg)

    # scheduler state (host)
    queue = [i for i in sorted(range(len(requests)),
                               key=lambda i: requests[i].arrival)
             if i not in done_replayed]
    slot_req = [None] * slots                      # request index per slot
    slot_pgen = [0] * slots                        # host mirror of pgen
    reserved = [0] * slots                         # pages reserved per slot
    plen_host = [0] * slots                        # prompt length per slot
    cursor_host = [0] * slots                      # host mirror of cursor
    prefilling = [False] * slots                   # host mirror of phase
    slot_prompt = [None] * slots                   # admitted pending stream
    arrived_wall, first_tok, admitted_step = {}, {}, {}
    emitted = {i: list(seed_emitted.get(i, [])) for i in range(len(requests))}
    jhw = {i: len(toks) for i, toks in emitted.items()}  # journaled so far
    preempt_count = {}                             # request -> evictions
    resume_gen = dict(seed_gens)                   # request -> generator state
    n_preempts = straggler_segs = 0
    completed, page_util = list(replayed_completed), []
    drain_since = None                             # wall time a drain began
    # prefix sharing (all empty when index is None)
    pins = {}                                      # page -> 1 (index pins)
    slot_shared = [[] for _ in range(slots)]       # adopted pages per slot
    slot_shareable = [False] * slots               # row may donate pages
    reg_done = [0] * slots                         # prompt pages registered
    prefill_tokens = shared_tokens = prefix_hits = 0
    stall_s = 0.0

    # -- snapshots of the pools and the prefix index, and the warm restore
    restored_from_snapshot = False
    snap_ckpt, snap_ord = None, 0
    n_snapshots, snapshot_s, snapshot_bytes = 0, 0.0, 0
    snap_geo = {"arch": cfg.name, "slots": int(slots),
                "page_size": int(page_size), "num_pages": int(geo.k.shape[0]),
                "pages_per_seq": int(pages_per_seq)}
    if journal is not None and snapshot_every > 0:
        snap_ckpt = Checkpointer(os.path.join(journal_dir, "snapshots"),
                                 keep=2, prefix="serve")
        snap_ord = snap_ckpt.latest_step() or 0
    if recovered and snap_ckpt is not None and index is not None:
        t_rec = time.perf_counter()
        try:
            if snap_ckpt.latest_step() is None:
                raise FileNotFoundError("no serve snapshot on disk")
            loaded, snap_meta = snap_ckpt.restore(caches, device=dev)
            extra = snap_meta["extra"]
            if extra.get("geometry") != snap_geo:
                raise CheckpointCorrupt(
                    f"snapshot geometry {extra.get('geometry')} != this "
                    f"serve's {snap_geo}")
            if snap_meta["shapes"] != [list(t.shape)
                                       for t in tree_leaves(caches)]:
                raise CheckpointCorrupt("snapshot leaf shapes changed")
            index.load_state_dict(extra["index"])
            new_pins = {int(p): int(c) for p, c in extra["pins"].items()}
            # no row of the snapshot survives the crash: release them all,
            # so the refcounts drop to the index pins, and check the
            # allocator invariants before trusting any of it
            loaded = _release_slots(loaded, np.ones((slots,), bool))
            _check_paged_invariants(loaded, pins=dict(new_pins))
            caches, pins = loaded, new_pins
            restored_from_snapshot = True
        except (CheckpointCorrupt, FileNotFoundError, AssertionError,
                KeyError, ValueError) as e:
            # a missing, corrupt or mismatched snapshot costs prefill
            # work, never correctness: the fresh pools stay, the index
            # starts empty and the journal alone recovers
            if not isinstance(e, FileNotFoundError):
                print(f"[serve] snapshot unusable ({e}); cold start "
                      f"from journal", flush=True)
            index = PrefixIndex(page_size)
        recovery_s += time.perf_counter() - t_rec

    def save_snapshot():
        # after the boundary's readback, so the copy follows the segment
        nonlocal snap_ord, n_snapshots, snapshot_s, snapshot_bytes
        t_snap = time.perf_counter()
        snap_ord += 1
        snap_ckpt.save(snap_ord, caches, extra={
            "kind": "serve", "geometry": snap_geo,
            "fingerprint": fingerprint,
            "index": index.state_dict() if index is not None else None,
            "pins": {str(p): int(c) for p, c in pins.items()}})
        snapshot_s += time.perf_counter() - t_snap
        n_snapshots += 1
        snapshot_bytes = sum(t.numel() * t.element_size()
                             for t in tree_leaves(caches))

    state = ServeSlotState.init(slots, prompt_pad, dev)
    step = segments = rounds = 0
    to_release = []                                # slots freed, pages held
    t0 = time.perf_counter()

    def stall_admit(state, caches, adm, prompts, lengths, slot_ids,
                    req_gens, prios):
        # the stop-the-world ragged prefill over the ring scratch, the
        # first tokens, the bytes copied into pool pages, then the slot
        # state write; every admitted slot enters the decode phase
        nonlocal scratch
        lengths_d = torch.as_tensor(lengths, device=dev)
        slot_d = torch.as_tensor(slot_ids, device=dev)
        logits, scratch = prefill(model, torch.as_tensor(prompts, device=dev),
                                  scratch, lengths_d)
        tok0 = sample_token_rows(logits, req_gens, temp, sample=sample,
                                 advance=slot_d >= 0)
        caches = _adopt_prompts(caches, scratch, slot_d, lengths_d)
        tok0_np = tok0.cpu().numpy()
        new_done = np.zeros((slots,), bool)
        new_rem = np.zeros((slots,), np.int32)
        now_s = time.perf_counter() - t0
        for row, (slot, i) in enumerate(adm):
            first = int(tok0_np[row, 0])
            emitted[i].append(first)
            first_tok.setdefault(i, now_s)
            new_rem[row] = requests[i].gen - 1
            new_done[row] = requests[i].gen <= 1 or (
                eos_id is not None and first == eos_id)
            cursor_host[slot] = plen_host[slot]
            prefilling[slot] = False
        state = admit_stall(state, slot_ids, lengths, tok0, new_done,
                            new_rem, req_gens, prios)
        _sync(dev)
        return state, caches

    def clear(slot):
        slot_req[slot] = None
        reserved[slot] = 0
        prefilling[slot] = False
        slot_prompt[slot] = None
        slot_shared[slot] = []
        slot_shareable[slot] = False
        reg_done[slot] = 0

    def finish(slot, now_s):
        i = slot_req[slot]
        completed.append(CompletedRequest(
            index=i, arrival=requests[i].arrival,
            admitted_step=admitted_step[i], finished_step=step,
            arrived_s=arrived_wall[i], finished_s=now_s,
            first_token_s=first_tok.get(i, now_s),
            tokens=np.asarray(emitted[i][:requests[i].gen], np.int32),
            priority=prio_req[i], preemptions=preempt_count.get(i, 0)))
        if journal is not None:
            # "n", the finished token count, is what replay trusts (a torn
            # flush can drop this boundary's progress but keep this)
            journal.append({
                "t": "complete", "rid": rids[i],
                "n": len(emitted[i][:requests[i].gen]),
                "admitted_step": admitted_step[i], "finished_step": step,
                "arrival": int(requests[i].arrival),
                "arrived_s": arrived_wall[i], "finished_s": now_s,
                "first_token_s": first_tok.get(i, now_s),
                "priority": prio_req[i],
                "preemptions": preempt_count.get(i, 0)})
        clear(slot)

    def preempt_slot(slot):
        # evict the slot's request on the host: keep its generator state,
        # re-enqueue it as prompt + generated prefix with the budget left;
        # the caller clears the device rows (one preempt_rows) and
        # releases the pages
        nonlocal n_preempts
        i = slot_req[slot]
        if sample:
            resume_gen[i] = state.gens[slot].get_state()
        g = len(emitted[i])
        pending[i] = (np.concatenate([prompts_np[i],
                                      np.asarray(emitted[i], np.int32)]),
                      requests[i].gen - g)
        preempt_count[i] = preempt_count.get(i, 0) + 1
        n_preempts += 1
        clear(slot)
        cursor_host[slot] = plen_host[slot] = 0
        slot_pgen[slot] += 1
        queue.append(i)
        queue.sort(key=lambda j: (requests[j].arrival, j))
        to_release.append(slot)

    def journal_progress():
        # one progress record per boundary: each request's tokens since
        # its last record and, sampling, its generator state after those
        # draws (a live row's own, a preempted request's kept state)
        slot_of = {slot_req[s]: s for s in range(slots)
                   if slot_req[s] is not None}
        deltas, keys = {}, {}
        for i, toks in emitted.items():
            if len(toks) <= jhw[i]:
                continue
            deltas[rids[i]] = [int(x) for x in toks[jhw[i]:]]
            if sample:
                if i in slot_of:
                    keys[rids[i]] = state_hex(state.gens[slot_of[i]]
                                              .get_state())
                elif i in resume_gen:
                    keys[rids[i]] = state_hex(resume_gen[i])
            jhw[i] = len(toks)
        if deltas:
            rec = {"t": "progress", "d": deltas}
            if keys:
                rec["k"] = keys
            journal.append(rec)

    def crash(where):
        # a process death: the journal's fsync and the snapshot's write in
        # flight settle first, so the restart reads settled files (a real
        # death mid-write leaves a torn tail or a .tmp directory, which
        # replay and the rename make equal to the write never starting)
        if journal is not None:
            journal.wait()
        if snap_ckpt is not None:
            snap_ckpt.wait()
        raise SimulatedCrash(step, where)

    with torch.inference_mode():
        while queue or any(s is not None for s in slot_req):
            now_s = time.perf_counter() - t0
            if injector is not None and injector.want_crash(step):
                crash("round-boundary")
            draining = drain is not None and drain.poll(step)
            if draining:
                if drain_since is None:
                    drain_since = time.perf_counter()
                if all(s is None for s in slot_req):
                    break                  # nothing in flight: drained
                if drain_timeout is not None and \
                        time.perf_counter() - drain_since >= drain_timeout:
                    # in-flight progress is journaled through the last
                    # boundary; a resume picks it up
                    break
            for i in queue:
                if requests[i].arrival <= step:
                    arrived_wall.setdefault(i, now_s)
            victims = []
            if injector is not None and injector.want_kill(step):
                # a forced kill: a seeded pick among the live resumable
                # slots, evicted as a preemption (and admittable again
                # this very round)
                live = [s for s in range(slots) if slot_req[s] is not None
                        and resumable[slot_req[s]]]
                if live:
                    s = live[int(injector.rng.integers(len(live)))]
                    preempt_slot(s)
                    victims.append(s)
            # -- admission: arrived requests into free, page-backed slots.
            # Reservations and index pins both count against the pool
            # (a pinned page inside an active donor's reservation counts
            # twice: conservative); injected pressure takes phantom pages
            free_slots = [s for s in range(slots) if slot_req[s] is None]
            phantom = injector.phantom_pages(step) if injector is not None \
                else 0
            page_budget = pool_pages - sum(reserved) - len(pins) - phantom
            adm, adm_shared, evict_batch = [], {}, []
            # admission order: aged class, arrival, trace position (a
            # snapshot: this round's victims are candidates next round);
            # a drain admits nothing
            cand = [] if draining else sorted(
                (i for i in queue if requests[i].arrival <= step),
                key=lambda j: (-eff_prio(j, step), requests[j].arrival, j))
            for i in cand:
                if not free_slots and not preemption:
                    break
                prompt_i, gen_i = pending[i]
                plen_i = prompt_i.size
                sh_pages = []
                if index is not None and plen_i + gen_i <= capacity:
                    # at most plen - 1 tokens: the last prompt token must
                    # prefill live for the first token's logits
                    sh_pages = index.lookup(prompt_i, max_tokens=plen_i - 1)
                need = min(-(-(plen_i + gen_i) // page_size),
                           pages_per_seq) - len(sh_pages)
                if need > page_budget and index is not None and len(index):
                    # evict idle pins (LRU) before preempting or waiting;
                    # pages active slots adopted, or this request will,
                    # keep theirs
                    protected = {p for lst in slot_shared for p in lst}
                    protected |= set(sh_pages)
                    evicted = index.evict_lru(need - page_budget, protected)
                    for p in evicted:
                        pins.pop(p, None)
                    evict_batch.extend(evicted)
                    page_budget += len(evicted)
                if preemption and (need > page_budget or not free_slots):
                    # evict strictly lower-class victims, lowest class
                    # first, then most reserved pages, until the
                    # candidate fits; all or nothing
                    cast = sorted(
                        (s for s in range(slots)
                         if slot_req[s] is not None
                         and eff_prio(slot_req[s], step) < eff_prio(i, step)
                         and resumable[slot_req[s]]),
                        key=lambda s: (eff_prio(slot_req[s], step),
                                       -reserved[s], s))
                    gain, picked = 0, []
                    for s in cast:
                        if need <= page_budget + gain \
                                and (free_slots or picked):
                            break
                        picked.append(s)
                        gain += reserved[s]
                    if need <= page_budget + gain and (free_slots or picked):
                        for s in picked:
                            preempt_slot(s)
                            victims.append(s)
                            free_slots.append(s)
                        page_budget += gain
                if not free_slots or need > page_budget:
                    break                          # head-of-line: keep order
                slot = free_slots.pop(0)
                queue.remove(i)
                slot_req[slot] = i
                reserved[slot] = need
                page_budget -= need
                admitted_step.setdefault(i, step)  # first admission: TTFT
                adm.append((slot, i))
                adm_shared[slot] = sh_pages
                slot_prompt[slot] = prompt_i
                slot_shared[slot] = list(sh_pages)
                slot_shareable[slot] = (index is not None
                                        and plen_i + gen_i <= capacity)
                reg_done[slot] = len(sh_pages)     # adopted: already indexed
                sh_toks = len(sh_pages) * page_size
                prefill_tokens += plen_i - sh_toks
                shared_tokens += sh_toks
                prefix_hits += bool(sh_pages)
            if victims:
                # the victims' rows are cleared before any release,
                # adoption or admission, and before the next segment
                mask = np.zeros((slots,), bool)
                mask[victims] = True
                state = preempt_rows(state, mask)
            if adm and to_release:
                # deferred page hand-back, right before the pages are
                # needed (the host reservation keeps the budget exact)
                mask = np.zeros((slots,), bool)
                mask[to_release] = True
                caches = _release_slots(caches, mask)
                to_release = []
            if evict_batch:
                # unpin evicted entries even when the head still waits, so
                # the pin ledger and the refcounts never diverge
                caches = _unpin_pages(caches, np.asarray(evict_batch,
                                                         np.int32))
            if adm:
                rounds += 1
                prompts = np.zeros((slots, prompt_pad), np.int32)
                lengths = np.ones((slots,), np.int32)
                gens = np.zeros((slots,), np.int32)
                prios = np.zeros((slots,), np.int32)
                slot_ids = np.full((slots,), -1, np.int32)
                req_gens = [None] * slots
                for row, (slot, i) in enumerate(adm):
                    p, g = pending[i]
                    prompts[row, :p.size] = p
                    lengths[row] = p.size
                    gens[row] = g
                    prios[row] = eff_prio(i, step)
                    slot_ids[row] = slot
                    plen_host[slot] = p.size
                    if sample:
                        # a resumed request continues the stream it left
                        req_gens[row] = request_generator(seed, i, dev)
                        if i in resume_gen:
                            req_gens[row].set_state(resume_gen.pop(i))
                if admission == "chunked":
                    shared_rows = np.zeros((slots,), np.int32)
                    if index is not None:
                        adopt_pages = np.zeros((slots, pages_per_seq),
                                               np.int32)
                        adopt_n = np.zeros((slots,), np.int32)
                        for row, (slot, i) in enumerate(adm):
                            sh = adm_shared[slot]
                            adopt_pages[row, :len(sh)] = sh
                            adopt_n[row] = len(sh)
                            shared_rows[row] = len(sh) * page_size
                        if adopt_n.any():
                            caches = _adopt_prefix_slots(
                                caches, slot_ids, adopt_pages, adopt_n,
                                shared_rows)
                    # the segments prefill from the first unshared token
                    state = admit_chunked(state, slot_ids, prompts,
                                          lengths, gens, req_gens,
                                          shared=shared_rows, prios=prios)
                    for row, (slot, _) in enumerate(adm):
                        cursor_host[slot] = int(shared_rows[row])
                        prefilling[slot] = True
                else:
                    t_stall = time.perf_counter()
                    state, caches = stall_admit(state, caches, adm,
                                                prompts, lengths, slot_ids,
                                                req_gens, prios)
                    stall_s += time.perf_counter() - t_stall
                if audit is not None:
                    audit(caches, list(slot_req), dict(pins))
                if debug:
                    _check_paged_invariants(caches, pins=dict(pins))
            if admission == "stall" and adm:
                # admitted requests of one token, or whose first token is
                # EOS, finish without decoding
                just_done = state.done.cpu().numpy()
                fin = [s for s in range(slots)
                       if slot_req[s] is not None and just_done[s]]
                if fin:
                    now_s = time.perf_counter() - t0
                    for s in fin:
                        finish(s, now_s)
                    to_release.extend(fin)
                    continue
            if all(s is None for s in slot_req):
                if not queue:
                    break
                step += segment                    # idle: nothing admittable
                continue

            # -- one segment: mixed while any slot is mid-prompt (sized to
            # the chunks left), pure decode otherwise. Its wall time runs
            # from before an injected sleep to the readback's sync
            t_seg = time.perf_counter()
            if injector is not None:
                pause = injector.straggle(step)
                if pause > 0.0:
                    time.sleep(pause)              # injected straggler
            if any(prefilling):
                # bounded below by the largest single prompt (one chunk
                # per slot per step) and by the total prefill work over
                # the per-step prefill capacity
                left = [plen_host[s] - cursor_host[s]
                        for s in range(slots) if prefilling[s]]
                n_dec = sum(1 for s in range(slots)
                            if slot_req[s] is not None and not prefilling[s])
                per_step = max(budget - n_dec, 1)
                need = max(-(-max(left) // chunk),
                           -(-sum(left) // per_step))
                fn = seg_fn(min(segment, _next_pow2(max(need, 1))))
            else:
                fn = seg_fn(0)
            owner = [(slot_req[s], slot_pgen[s]) for s in range(slots)]
            toks, emits, _, state, caches, _ = fn(model, state, caches, temp)
            segments += 1
            step += segment
            # pool utilization from the host reservation ledger (an exact
            # upper bound on the pages held; no extra device read)
            page_util.append((step, sum(reserved) / max(pool_pages, 1)))
            back = torch.cat([toks, emits.to(torch.int32),
                              state.done.to(torch.int32)[:, None],
                              state.cursor[:, None], state.pgen[:, None]],
                             dim=1).cpu().numpy()
            toks_np, emits_np = back[:, :segment], back[:, segment:2 * segment]
            done_np, cursor_np, pgen_np = back[:, -3], back[:, -2], back[:, -1]
            if injector is not None and injector.want_crash_after(step):
                # after the readback, before the flush: the lost tokens
                # are generated again from the previous boundary
                crash("mid-segment")
            straggler_segs += watchdog.observe(
                time.perf_counter() - t_seg).straggler
            now_s = time.perf_counter() - t0
            for s in range(slots):
                i, gen_s = owner[s]
                if i is None or int(pgen_np[s]) != gen_s:
                    continue       # a victim's row: nothing to credit
                row = toks_np[s][emits_np[s] != 0].tolist()
                if row:
                    first_tok.setdefault(i, now_s)
                    emitted[i].extend(row)
                cursor_host[s] = int(cursor_np[s])
                prefilling[s] = cursor_host[s] < plen_host[s]
            if index is not None:
                # register every newly completed full page of prompt
                # tokens (no-wrap donors never rewrite it), before the
                # release below, so a request that just finished still
                # donates; one readback of layer 0's page table serves
                # every layer (the pools run in lockstep)
                reg = []
                for s in range(slots):
                    if slot_req[s] is None or not slot_shareable[s]:
                        continue
                    full = min(cursor_host[s], plen_host[s]) // page_size
                    if full > reg_done[s]:
                        reg.append((s, full))
                if reg:
                    table = _first_paged(caches).page_table.cpu().numpy()
                    new_pins = []
                    for s, full in reg:
                        # the slot's pending stream: a resumed slot's pages
                        # hash under prompt + generated prefix, which a
                        # later re-admission adopts back
                        new_pins.extend(index.register(slot_prompt[s],
                                                       table[s, :full]))
                        reg_done[s] = full
                    if new_pins:
                        pins.update((p, 1) for p in new_pins)
                        caches = _pin_pages(caches,
                                            np.asarray(new_pins, np.int32))
            fin = [s for s in range(slots)
                   if slot_req[s] is not None and done_np[s]]
            for s in fin:
                finish(s, now_s)
            to_release.extend(fin)
            if journal is not None:
                # the boundary's group commit: progress, generator states
                # and completions in one written batch
                journal_progress()
                journal.flush()
                if snap_ckpt is not None and segments % snapshot_every == 0:
                    save_snapshot()

        if journal is not None:
            journal_progress()
            journal.flush()
            if snap_ckpt is not None:
                # a clean restart (drain, then resume) warm-starts from it
                save_snapshot()
                snap_ckpt.wait()
            journal.close()
    if debug:
        _check_paged_invariants(caches, pins=dict(pins))
    wall = time.perf_counter() - t0
    return ServeResult(completed=completed, wall_s=wall, steps=step,
                       segments=segments, admission_rounds=rounds,
                       page_util=page_util, prefill_stall_s=stall_s,
                       prefill_tokens=prefill_tokens,
                       shared_prefix_tokens=shared_tokens,
                       prefix_hits=prefix_hits, preemptions=n_preempts,
                       straggler_segments=straggler_segs,
                       drained=drain_since is not None, recovered=recovered,
                       restored_from_snapshot=restored_from_snapshot,
                       replayed_tokens=replayed_tokens,
                       snapshot_bytes=snapshot_bytes, recovery_s=recovery_s,
                       snapshots=n_snapshots, snapshot_s=snapshot_s,
                       aging_steps=aging_steps, max_class=max_class,
                       capture_s=graphs.capture_s if graphs else 0.0,
                       graph_bytes=graphs.graph_bytes if graphs else 0,
                       alloc_bytes=graphs.alloc_bytes if graphs else 0)
