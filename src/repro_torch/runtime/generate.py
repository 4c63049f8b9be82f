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
    for kind, cap in (("swa", cfg.window), ("local", cfg.local_window)):
        kinds = {k for pat, _ in cfg.layer_groups for k in pat}
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
    """The first layer's ``PagedKVState``, or None for ring caches."""
    from repro_torch.attention import PagedKVState
    node = caches[0]["mix"] if caches else None
    return node if isinstance(node, PagedKVState) else None


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


def _validate_caches(caches, cfg, batch: int, max_len: int, dev):
    """Reused ``caches=`` must match what this call would allocate: rings
    of this batch and max_len, or paged pools of this batch and max_len
    (pool and page size are free choices), with the mismatched field
    named."""
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
    for i, (c, e) in enumerate(zip(caches, expected, strict=True)):
        if type(c["mix"]) is not type(e["mix"]):
            raise ValueError(f"caches= layer {i} mixes ring and paged "
                             f"caches")
        for f in fields:
            got, want = getattr(c["mix"], f), getattr(e["mix"], f)
            if got.shape != want.shape or got.dtype != want.dtype \
                    or got.device != dev:
                raise ValueError(
                    f"caches= layer {i} {f} {tuple(got.shape)}/{got.dtype}"
                    f" on {got.device} does not match batch={batch}, "
                    f"max_len={max_len} ({tuple(want.shape)}/{want.dtype} "
                    f"on {dev})")


def generate(model, cfg, prompts, gen: int, *, temperature: float = 0.0,
             generator: torch.Generator | None = None,
             max_len: int | None = None, caches=None, prompt_lengths=None,
             eos_id: int | None = None, pad_id: int = 0,
             early_exit: bool = False, paged: bool = False,
             page_size: int = 128, num_pages: int | None = None,
             loop: str = "fused", device="cuda") -> GenerateResult:
    """Prefill the prompt batch, then decode ``gen`` tokens.

    ``prompts`` (B, S) int, right-padded when ``prompt_lengths`` (B,)
    declares a ragged batch. ``max_len`` sizes the KV rings (default
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
                                                lengths)
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
    orders admission and the mixed steps' prompt-chunk budget.
    ``request_id`` names the request for the journal (ROADMAP A8)."""
    prompt: Any                      # (S,) int token ids
    gen: int
    arrival: int = 0
    priority: int = 0
    request_id: str | None = None


@dataclasses.dataclass
class CompletedRequest:
    index: int                       # position in the submitted trace
    arrival: int                     # virtual (step) arrival time
    admitted_step: int               # step count when admitted
    finished_step: int               # step count when the slot freed
    arrived_s: float                 # wall clock when first admittable
    finished_s: float                # wall clock at the freeing boundary
    tokens: Any                      # (gen,) int32 generated ids
    first_token_s: float = 0.0       # wall clock of the first emitted token
    priority: int = 0                # the request's SLO class

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
    capture_s: float = 0.0           # of wall_s: capturing the serve steps
    graph_bytes: int = 0             # device memory of their graph pools
    alloc_bytes: int = 0             # allocated memory the captures added

    @property
    def total_tokens(self) -> int:
        return sum(int(np.asarray(c.tokens).size) for c in self.completed)

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
        """Virtual-time TTFT proxy: decode steps from arrival to
        admission (deterministic, no wall clock)."""
        return self._quantile(
            (c.admitted_step - c.arrival for c in self._of_class(priority)),
            q)


def _release_slots(caches, finished):
    """Hand every finished slot's pages (all layers) back to the pools."""
    finished = torch.as_tensor(finished, dtype=torch.bool,
                               device=caches[0]["mix"].pos.device)
    return [dict(c, mix=c["mix"].release(finished)) for c in caches]


def _check_paged_invariants(caches):
    for c in caches:
        c["mix"].check_invariants()


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

# serve_continuous options of the JAX package that later slices port
_UNPORTED_SERVE = {
    "prefix_sharing": "prefix sharing with PrefixIndex (ROADMAP A8)",
    "preemption": "preemption, SLO classes and aging (ROADMAP A8)",
    "faults": "fault injection with preemption (ROADMAP A8)",
    "aging_steps": "preemption, SLO classes and aging (ROADMAP A8)",
    "journal_dir": "journal, snapshot and recovery (ROADMAP A8)",
    "snapshot_every": "journal, snapshot and recovery (ROADMAP A8)",
    "resume": "journal, snapshot and recovery (ROADMAP A8)",
    "drain": "journal, snapshot, recovery and drain (ROADMAP A8)",
    "drain_timeout": "journal, snapshot, recovery and drain (ROADMAP A8)",
}


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

    Admission order: SLO class, then
    arrival, then trace position; the head of the queue waits for pages
    (no overtaking). ``audit`` (testing hook) is called after every
    admission round with the caches, the slot->request map and the pin
    ledger (empty). ``debug_invariants`` (or env ``ITA_PAGED_DEBUG=1``)
    checks the allocator invariants after every round.

    Greedy serving equals generating each request alone (``generate``
    with the ``ita_onepass_pallas`` pin, the same ``max_len``), under
    either admission: the chunks stream the same KV tile schedule when
    ``page_size`` equals the fused ``block_kv`` (128), and the projections
    give a token the same bits in any batch (``models.layers.linear``).
    On the card a greedy serve replays its steps from two CUDA graphs,
    the mixed step's and the decode step's (``steps.CapturedSteps``,
    captured at their first use in the serve; ``capture_s``).
    ``temperature > 0`` with a ``seed`` samples each request from its own
    generator (``steps.request_generator(seed, index)``), independent of
    arrival order and co-scheduled traffic; a sampled step reads its
    emitting rows back to the host to draw from their generators, so
    sampled serving runs its steps eagerly.

    The options of ``_UNPORTED_SERVE`` come with later slices and raise
    ``NotImplementedError``. ``device`` (default the card; raises when
    CUDA is missing) must hold the model.
    """
    from repro_torch.launch.steps import (CapturedSteps, ServeSlotState,
                                          admit_chunked, admit_stall,
                                          make_prefill_step,
                                          make_serve_segment,
                                          request_generator,
                                          sample_token_rows)
    from repro_torch.models import init_caches

    given = dict(prefix_sharing=prefix_sharing, preemption=preemption,
                 faults=faults, aging_steps=aging_steps,
                 journal_dir=journal_dir, snapshot_every=snapshot_every,
                 resume=resume, drain=drain, drain_timeout=drain_timeout)
    for name, value in given.items():
        if value not in (None, False, 0):
            raise NotImplementedError(
                f"serve_continuous({name}=...) is not ported yet: it comes "
                f"with {_UNPORTED_SERVE[name]}")
    if admission not in ADMISSIONS:
        raise ValueError(f"admission={admission!r} not in {ADMISSIONS}")
    dev = resolve_device(device)
    if model.embed.device != dev:
        raise ValueError(f"the model lives on {model.embed.device}, not on "
                         f"{dev}")
    exact_float32_matmul()
    _validate_serve_cfg(cfg, admission=admission, chunk=max(1, chunk_size))
    requests = list(requests)
    if not requests:
        return ServeResult([], 0.0, 0, 0, 0, [])
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
    prio_req = [int(r.priority) for r in requests]
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
    queue = sorted(range(len(requests)), key=lambda i: requests[i].arrival)
    slot_req = [None] * slots                      # request index per slot
    reserved = [0] * slots                         # pages reserved per slot
    plen_host = [0] * slots                        # prompt length per slot
    cursor_host = [0] * slots                      # host mirror of cursor
    prefilling = [False] * slots                   # host mirror of phase
    arrived_wall, first_tok, admitted_step = {}, {}, {}
    emitted = {i: [] for i in range(len(requests))}
    completed, page_util = [], []
    prefill_tokens, stall_s = 0, 0.0
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

    def finish(slot, now_s):
        i = slot_req[slot]
        completed.append(CompletedRequest(
            index=i, arrival=requests[i].arrival,
            admitted_step=admitted_step[i], finished_step=step,
            arrived_s=arrived_wall[i], finished_s=now_s,
            first_token_s=first_tok.get(i, now_s),
            tokens=np.asarray(emitted[i][:requests[i].gen], np.int32),
            priority=prio_req[i]))
        slot_req[slot] = None
        reserved[slot] = 0
        prefilling[slot] = False

    with torch.inference_mode():
        while queue or any(s is not None for s in slot_req):
            now_s = time.perf_counter() - t0
            for i in queue:
                if requests[i].arrival <= step:
                    arrived_wall.setdefault(i, now_s)
            # -- admission: arrived requests into free, page-backed slots
            free_slots = [s for s in range(slots) if slot_req[s] is None]
            page_budget = pool_pages - sum(reserved)
            adm = []
            cand = sorted((i for i in queue if requests[i].arrival <= step),
                          key=lambda j: (-prio_req[j], requests[j].arrival,
                                         j))
            for i in cand:
                need = pages_for(i)
                if not free_slots or need > page_budget:
                    break                          # head-of-line: keep order
                slot = free_slots.pop(0)
                queue.remove(i)
                slot_req[slot] = i
                reserved[slot] = need
                page_budget -= need
                admitted_step.setdefault(i, step)
                adm.append((slot, i))
                prefill_tokens += prompts_np[i].size
            if adm and to_release:
                # deferred page hand-back, right before the pages are
                # needed (the host reservation keeps the budget exact)
                mask = np.zeros((slots,), bool)
                mask[to_release] = True
                caches = _release_slots(caches, mask)
                to_release = []
            if adm:
                rounds += 1
                prompts = np.zeros((slots, prompt_pad), np.int32)
                lengths = np.ones((slots,), np.int32)
                gens = np.zeros((slots,), np.int32)
                prios = np.zeros((slots,), np.int32)
                slot_ids = np.full((slots,), -1, np.int32)
                req_gens = [None] * slots
                for row, (slot, i) in enumerate(adm):
                    p = prompts_np[i]
                    prompts[row, :p.size] = p
                    lengths[row] = p.size
                    gens[row] = requests[i].gen
                    prios[row] = prio_req[i]
                    slot_ids[row] = slot
                    plen_host[slot] = p.size
                    if sample:
                        req_gens[row] = request_generator(seed, i, dev)
                if admission == "chunked":
                    state = admit_chunked(state, slot_ids, prompts,
                                          lengths, gens, req_gens,
                                          prios=prios)
                    for slot, _ in adm:
                        cursor_host[slot] = 0
                        prefilling[slot] = True
                else:
                    t_stall = time.perf_counter()
                    state, caches = stall_admit(state, caches, adm,
                                                prompts, lengths, slot_ids,
                                                req_gens, prios)
                    stall_s += time.perf_counter() - t_stall
                if audit is not None:
                    audit(caches, list(slot_req), {})
                if debug:
                    _check_paged_invariants(caches)
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
            # the chunks left), pure decode otherwise
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
            toks, emits, _, state, caches, _ = fn(model, state, caches, temp)
            segments += 1
            step += segment
            # pool utilization from the host reservation ledger (an exact
            # upper bound on the pages held; no extra device read)
            page_util.append((step, sum(reserved) / max(pool_pages, 1)))
            back = torch.cat([toks, emits.to(torch.int32),
                              state.done.to(torch.int32)[:, None],
                              state.cursor[:, None]], dim=1).cpu().numpy()
            toks_np, emits_np = back[:, :segment], back[:, segment:2 * segment]
            done_np, cursor_np = back[:, -2], back[:, -1]
            now_s = time.perf_counter() - t0
            for s in range(slots):
                if slot_req[s] is None:
                    continue
                i = slot_req[s]
                row = toks_np[s][emits_np[s] != 0].tolist()
                if row:
                    first_tok.setdefault(i, now_s)
                    emitted[i].extend(row)
                cursor_host[s] = int(cursor_np[s])
                prefilling[s] = cursor_host[s] < plen_host[s]
            fin = [s for s in range(slots)
                   if slot_req[s] is not None and done_np[s]]
            for s in fin:
                finish(s, now_s)
            to_release.extend(fin)

    if debug:
        _check_paged_invariants(caches)
    wall = time.perf_counter() - t0
    return ServeResult(completed=completed, wall_s=wall, steps=step,
                       segments=segments, admission_rounds=rounds,
                       page_util=page_util, prefill_stall_s=stall_s,
                       prefill_tokens=prefill_tokens,
                       capture_s=graphs.capture_s if graphs else 0.0,
                       graph_bytes=graphs.graph_bytes if graphs else 0,
                       alloc_bytes=graphs.alloc_bytes if graphs else 0)
