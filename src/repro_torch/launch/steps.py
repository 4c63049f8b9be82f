"""Prefill / decode steps, sampling, the decode loop and the
continuous-batching serve segments (``repro.launch.steps``).

The JAX package jits the steps and scans every decode step in one
dispatch. The port's counterpart is ``CapturedSteps``: a step captured
once in a CUDA graph over static buffers and replayed, one graph launch
in place of the step's thousands of kernel launches. The decode loop and
a serve segment's steps stay a Python loop around the step (the eager
loop with ``graphs=None``); a greedy segment never reads back to the
host between its steps. Sampling uses a ``torch.Generator`` — one
per served request, seeded from ``(seed, request index)``
(``request_generator``); the JAX package's threefry keys give other
numbers, so sampled streams are compared within the port only (greedy
tokens are compared across the two).
"""

from __future__ import annotations

import dataclasses
import functools
import time

import numpy as np
import torch

from repro_torch.attention.state import scatter_drop
from repro_torch.models import forward
from repro_torch.models.layers import unembed


def make_prefill_step(cfg):
    def prefill_step(model, tokens, caches, lengths=None):
        logits, caches = forward(model, tokens, cfg, mode="prefill",
                                 caches=caches, lengths=lengths)
        if lengths is None:
            return logits[:, -1:], caches
        # ragged: each sequence's next-token logits sit at its own last
        # valid position of the right-padded prompt
        idx = (torch.as_tensor(lengths, device=logits.device).long() - 1)
        return logits[torch.arange(logits.shape[0], device=logits.device),
                      idx][:, None], caches
    return prefill_step


def make_decode_step(cfg):
    def decode_step(model, tokens, caches, pos0, live=None):
        return forward(model, tokens, cfg, mode="decode", caches=caches,
                       pos0=pos0, live=live)
    return decode_step


def sample_token(logits, generator, temperature, *, sample: bool):
    """Next token (B, 1) int32 from (B, 1, V) logits: greedy argmax (the
    first maximal index, as ``jnp.argmax``) or temperature sampling from
    ``generator``."""
    if not sample:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(logits[:, -1].float() / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator).to(torch.int32)


def advance_step(logits, generator, temperature, done, n, *, sample: bool,
                 eos_id: int | None, pad_id: int):
    """Per-step tail of the decode loop: sample the next token, pin
    finished sequences to ``pad_id``, count live decode tokens into ``n``
    and fold new EOS hits into ``done``. Returns ``(tok, done, n)``."""
    nxt = sample_token(logits, generator, temperature, sample=sample)
    if eos_id is not None:
        nxt = torch.where(done[:, None], pad_id, nxt)
        n = n + (~done).sum().to(torch.int32)
        done = done | (nxt[:, 0] == eos_id)
    else:
        n = n + nxt.shape[0]
    return nxt, done, n


def make_decode_body(cfg, model, generator, temperature, *, sample: bool,
                     eos_id: int | None, pad_id: int):
    """One step of the decode loop over the carry ``(tok, pos, done, n,
    caches)``: the forward of the last tokens, then ``advance_step``.
    Returns ``body(carry) -> (carry, ())``."""
    decode = make_decode_step(cfg)

    def body(carry):
        tok, pos, done, n, caches = carry
        logits, caches = decode(model, tok, caches, pos)
        tok, done, n = advance_step(logits, generator, temperature, done, n,
                                    sample=sample, eos_id=eos_id,
                                    pad_id=pad_id)
        return (tok, pos + 1, done, n, caches), ()
    return body


def make_generate_loop(cfg, *, gen: int, sample: bool, eos_id: int | None,
                       pad_id: int, early_exit: bool):
    """The decode loop: ``gen - 1`` decode steps after the prefill token.

    Returns ``loop(model, tok0, caches, pos0, generator, temperature,
    graphs=None) -> (tokens (B, gen-1), n_decode_tokens, steps_run,
    caches)``. ``graphs`` (a ``CapturedSteps``) replays the step from a
    CUDA graph, the fused loop; ``None`` runs its ops eagerly, the
    stepwise loop. With ``early_exit`` the loop stops once every sequence
    has emitted EOS (one host check per step, in both loops) and the
    steps it skips are ``pad_id``."""
    steps = gen - 1

    def loop(model, tok0, caches, pos0, generator, temperature, graphs=None):
        b, dev = tok0.shape[0], tok0.device
        done = (tok0[:, 0] == eos_id) if eos_id is not None \
            else torch.zeros((b,), dtype=torch.bool, device=dev)
        out = torch.full((b, steps), pad_id, dtype=torch.int32, device=dev)
        n = torch.zeros((), dtype=torch.int32, device=dev)
        body = make_decode_body(cfg, model, generator, temperature,
                                sample=sample, eos_id=eos_id, pad_id=pad_id)
        # copies: captured steps advance their first carry in place
        carry = (tok0.clone(), pos0.to(torch.int32, copy=True), done, n,
                 caches)
        steps_run = 0
        for i in range(steps):
            if early_exit and bool(carry[2].all()):
                break
            carry, _ = body(carry) if graphs is None \
                else graphs.run("decode", body, carry)
            out[:, i] = carry[0][:, 0]
            steps_run += 1
        return out, carry[3], steps_run, carry[4]

    return loop


# ---------------------------------------------------------------------------
# Captured steps: one step of a loop replayed from a CUDA graph
# ---------------------------------------------------------------------------

def tree_leaves(tree) -> list:
    """The tensors of a carry — tensors in dataclasses, dicts, lists and
    tuples — depth first; anything else is not a leaf."""
    if torch.is_tensor(tree):
        return [tree]
    if dataclasses.is_dataclass(tree):
        parts = [getattr(tree, f.name) for f in dataclasses.fields(tree)]
    elif isinstance(tree, dict):
        parts = list(tree.values())
    elif isinstance(tree, (list, tuple)):
        parts = tree
    else:
        return []
    return [leaf for part in parts for leaf in tree_leaves(part)]


def tree_replace(tree, leaves):
    """``tree`` with its tensors taken in ``tree_leaves`` order from the
    iterator ``leaves``."""
    if torch.is_tensor(tree):
        return next(leaves)
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: tree_replace(getattr(tree, f.name), leaves)
            for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: tree_replace(v, leaves) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_replace(v, leaves) for v in tree)
    return tree


def _launch_counters():
    """Every kernel wrapper's launch counter (``LAUNCHES``)."""
    from repro_torch.kernels.int8_matmul import kernel as MK
    from repro_torch.kernels.ita_attention import kernel as K
    from repro_torch.kernels.ita_softmax import kernel as SK
    return K.LAUNCHES, SK.LAUNCHES, MK.LAUNCHES


@functools.cache
def _side_stream(device):
    """The stream of every warm-up and capture on ``device``: cuBLAS keeps
    a workspace per stream it runs on for the life of the process, so a
    fresh stream per capture would add one each time."""
    return torch.cuda.Stream(device)


class CapturedSteps:
    """The steps of one loop over one set of static buffers, each captured
    in a ``torch.cuda.CUDAGraph`` at its first call and replayed after.

    ``run(name, body, carry)``: ``body(carry) -> (carry, outs)`` maps a
    carry (a tree of tensors: slot state, positions, the KV states) to
    the next carry of the same shapes and the step's other outputs. The
    first ``run`` takes the carry's own tensors as the static buffers (a
    tensor whose storage an earlier leaf holds is cloned), so the steps
    advance the caller's first carry in place and the KV pools are never
    copied: a caller that needs a tensor of that carry unchanged passes
    a copy. Every later ``run`` copies in the carry's tensors that are
    not the static ones (an admission between two steps made new ones)
    and returns the static carry, which the step advances in place: the
    body ends by copying each output tensor into its static buffer. A
    tensor the body writes in place (the int8 KV pools) is its own
    output and is not copied. ``outs`` are the graph's own tensors,
    overwritten by its next replay.

    On the card a body's first call is its warm-up — one real step,
    eagerly, on a side stream (which builds the kernels and sets up
    cuBLAS) — and its capture on the same stream; later calls replay
    the graph. Bodies of one object share the static buffers (the
    serve's mixed and decode steps). A kernel wrapper counts its
    launches in Python, so the capture's counts are taken off the
    counters (capture launches nothing) and every replay adds them
    again. ``generator`` (sampling) is registered with each graph, so a
    replay draws from it as the eager step does. A failed capture
    raises. On the CPU (the caller asked for it) every call runs the
    body eagerly with the same static buffers and copy-back; no graph
    exists there.

    ``capture_s`` sums the captures' wall time. ``graph_bytes`` sums the
    device memory the graphs' private pools reserved during capture;
    ``alloc_bytes`` sums the growth of allocated device memory from just
    before each capturing call's copy-in to just after its capture
    (static copies, the graph's outputs, cuBLAS's workspace on the side
    stream's first use).
    """

    def __init__(self, device, generator=None):
        self.device = torch.device(device)
        self.generator = generator
        self.static = None                 # static buffers (carry leaves)
        self.graphs = {}                   # name -> (graph, outs, counts)
        self.capture_s = 0.0
        self.graph_bytes = 0
        self.alloc_bytes = 0

    def load(self, carry):
        """``carry`` over the static buffers (see the class docstring)."""
        leaves = tree_leaves(carry)
        if self.static is None:
            self.static, held = [], set()
            for t in leaves:
                ptr = t.untyped_storage().data_ptr()
                self.static.append(t.clone() if ptr in held else t)
                held.add(ptr)
        elif len(leaves) != len(self.static):
            raise ValueError(f"carry of {len(leaves)} tensors for static "
                             f"buffers of {len(self.static)}")
        else:
            for s, t in zip(self.static, leaves, strict=True):
                if t is s:
                    continue
                if t.shape != s.shape or t.dtype != s.dtype \
                        or t.device != s.device:
                    raise ValueError(
                        f"carry tensor {tuple(t.shape)}/{t.dtype} on "
                        f"{t.device} does not fit its static buffer "
                        f"{tuple(s.shape)}/{s.dtype} on {s.device}")
                s.copy_(t)
        return tree_replace(carry, iter(self.static))

    def _advance(self, new):
        """The step's tail: its output carry into the static buffers."""
        ptrs = {s.untyped_storage().data_ptr() for s in self.static}
        pending = []
        for s, t in zip(self.static, tree_leaves(new), strict=True):
            if t is s:                     # written in place (the pools)
                continue
            if t.untyped_storage().data_ptr() in ptrs:
                t = t.clone()              # shares another static buffer
            pending.append((s, t))
        for s, t in pending:
            s.copy_(t)

    def run(self, name, body, carry):
        """One step of ``body`` (named ``name``) on ``carry``; returns
        ``(static carry, outs)``."""
        if self.device.type != "cuda":
            carry = self.load(carry)
            new, outs = body(carry)
            self._advance(new)
            return carry, outs
        if name not in self.graphs:
            held = torch.cuda.memory_allocated(self.device)
            carry = self.load(carry)
            outs = self._warm_up_and_capture(name, body, carry)
            self.alloc_bytes += torch.cuda.memory_allocated(self.device) \
                - held
            return carry, outs
        carry = self.load(carry)
        graph, outs, counts = self.graphs[name]
        graph.replay()
        for counter, delta in counts:
            for kernel, n in delta.items():
                counter[kernel] += n
        return carry, outs

    def _warm_up_and_capture(self, name, body, carry):
        cur = torch.cuda.current_stream(self.device)
        side = _side_stream(self.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            new, outs = body(carry)
            self._advance(new)
        cur.wait_stream(side)
        for t in tree_leaves(outs):
            t.record_stream(cur)
        counters = _launch_counters()
        before = [dict(c) for c in counters]
        graph = torch.cuda.CUDAGraph()
        if self.generator is not None:
            graph.register_generator_state(self.generator)
        t0 = time.perf_counter()
        with torch.cuda.graph(graph, stream=side):
            held = torch.cuda.memory_reserved(self.device)
            new, outs_g = body(carry)
            self._advance(new)
        self.graph_bytes += torch.cuda.memory_reserved(self.device) - held
        counts = []
        for counter, was in zip(counters, before, strict=True):
            delta = {k: n - was[k] for k, n in counter.items()
                     if n != was[k]}
            for kernel, n in delta.items():
                counter[kernel] -= n       # capture launched nothing
            if delta:
                counts.append((counter, delta))
        self.graphs[name] = (graph, outs_g, counts)
        torch.cuda.synchronize(self.device)
        self.capture_s += time.perf_counter() - t0
        return outs


# ---------------------------------------------------------------------------
# Continuous-batching serve segments (pure decode + mixed chunked prefill)
# ---------------------------------------------------------------------------

def request_generator(seed: int, index: int, device) -> torch.Generator:
    """The sampling stream of served request ``index``: a generator on
    ``device`` seeded from ``(seed, index)``, so a request draws the same
    numbers whatever else is served beside it (and solo ``generate()``
    given this generator draws them too)."""
    mixed = np.random.SeedSequence([seed, index]).generate_state(
        1, np.uint64)[0]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(mixed) & ((1 << 63) - 1))
    return gen


@dataclasses.dataclass(frozen=True)
class ServeSlotState:
    """Per-slot state of the continuous-batching serve loop
    (``repro.launch.steps.ServeSlotState``): fixed-width tensors on the
    card that the segments carry and the admission write updates.
    Prompt token ids wait in ``prompt_buf`` and are prefilled chunk by
    chunk inside the segments (``cursor`` < ``plen`` marks the prefill
    phase). ``prio`` is the slot's SLO class: it orders the mixed body's
    prompt-chunk grants. ``pgen`` is the preemption generation (kept for
    the preemption slice). ``gens`` holds each slot's sampling generator
    (host objects; ``None`` when serving greedily) in place of the JAX
    package's per-slot PRNG keys."""

    tok: torch.Tensor           # (B, 1) int32 — last sampled token
    pos: torch.Tensor           # (B,) int32 — stream position (cache pos)
    done: torch.Tensor          # (B,) bool — finished / empty slots
    rem: torch.Tensor           # (B,) int32 — tokens left to emit
    cursor: torch.Tensor        # (B,) int32 — prompt tokens prefilled
    plen: torch.Tensor          # (B,) int32 — prompt length
    prompt_buf: torch.Tensor    # (B, prompt_pad) int32 — queued prompt ids
    prio: torch.Tensor          # (B,) int32 — SLO class (higher = urgent)
    pgen: torch.Tensor          # (B,) int32 — preemption generation
    gens: tuple = ()            # per-slot torch.Generator or None

    @classmethod
    def init(cls, slots: int, prompt_pad: int,
             device="cpu") -> "ServeSlotState":
        i32 = dict(dtype=torch.int32, device=device)
        return cls(tok=torch.zeros((slots, 1), **i32),
                   pos=torch.zeros((slots,), **i32),
                   done=torch.ones((slots,), dtype=torch.bool,
                                   device=device),
                   rem=torch.zeros((slots,), **i32),
                   cursor=torch.zeros((slots,), **i32),
                   plen=torch.zeros((slots,), **i32),
                   prompt_buf=torch.zeros((slots, max(prompt_pad, 1)),
                                          **i32),
                   prio=torch.zeros((slots,), **i32),
                   pgen=torch.zeros((slots,), **i32),
                   gens=(None,) * slots)


def admit_rows(state, slot_ids):
    """Sink row indices for a fixed-width admission batch (padding rows
    carry slot id -1 and drop out of every scatter)."""
    return torch.where(slot_ids >= 0, slot_ids, state.done.shape[0])


def _place_generators(state, slot_ids, req_gens):
    """``state.gens`` with row ``i``'s generator ``req_gens[i]`` in slot
    ``slot_ids[i]`` (padding rows, slot -1, place nothing)."""
    gen_list = list(state.gens)
    if req_gens is not None:
        for slot, g in zip(np.asarray(slot_ids.cpu()).tolist(), req_gens,
                           strict=True):
            if slot >= 0:
                gen_list[slot] = g
    return tuple(gen_list)


def admit_chunked(state, slot_ids, prompts, lengths, gens, req_gens=None,
                  prios=None):
    """Chunked admission is only this state write (plus the host's page
    reservation): enqueue the prompt ids and arm the slots' phase state
    (``cursor`` and ``pos`` at 0); the segments prefill page-native.
    ``slot_ids`` (n,) (-1 = padding), ``prompts`` (n, prompt_pad),
    ``lengths``/``gens`` (n,); ``req_gens`` the n rows' sampling
    generators (or None); ``prios`` (n,) the SLO classes (None = class
    0)."""
    dev = state.pos.device

    def col(x):
        return torch.as_tensor(x, dtype=torch.int32, device=dev)
    slot_ids = col(slot_ids)
    rows = admit_rows(state, slot_ids)
    lengths = col(lengths)
    prio = torch.zeros_like(lengths) if prios is None else col(prios)

    def put(t, v):
        return scatter_drop(t, (rows,), v)
    return dataclasses.replace(
        state, prompt_buf=put(state.prompt_buf, col(prompts)),
        plen=put(state.plen, lengths), cursor=put(state.cursor, 0),
        pos=put(state.pos, 0), tok=put(state.tok, 0),
        done=put(state.done, False), rem=put(state.rem, col(gens)),
        prio=put(state.prio, prio),
        gens=_place_generators(state, slot_ids, req_gens))


def admit_stall(state, slot_ids, lengths, tok0, new_done, new_rem,
                req_gens=None, prios=None):
    """Stall admission's state write, after the stop-the-world prefill
    sampled ``tok0`` (n, 1): the slot enters the decode phase directly
    (``cursor == plen == pos == lengths``), with ``done``/``rem`` from
    ``new_done``/``new_rem`` (a request of one token, or whose first token
    is EOS, is done at once). Rows, generators and SLO classes as in
    ``admit_chunked``."""
    dev = state.pos.device

    def col(x, dtype=torch.int32):
        return torch.as_tensor(x, dtype=dtype, device=dev)
    slot_ids = col(slot_ids)
    rows = admit_rows(state, slot_ids)
    lengths = col(lengths)
    prio = torch.zeros_like(lengths) if prios is None else col(prios)

    def put(t, v):
        return scatter_drop(t, (rows,), v)
    return dataclasses.replace(
        state, tok=put(state.tok, col(tok0).reshape(-1, 1)),
        pos=put(state.pos, lengths), plen=put(state.plen, lengths),
        cursor=put(state.cursor, lengths),
        done=put(state.done, col(new_done, torch.bool)),
        rem=put(state.rem, col(new_rem)), prio=put(state.prio, prio),
        gens=_place_generators(state, slot_ids, req_gens))


def sample_token_rows(logits, gens, temperature, *, sample: bool,
                      advance=None):
    """Per-row ``sample_token``: row ``b`` draws from its own generator
    ``gens[b]`` exactly as solo ``generate()`` draws from its generator
    (one ``multinomial`` per sampled token), so a request served through
    any admission interleaving consumes the same stream as generating it
    alone. ``advance`` (B,) masks the rows that draw this step (rows mid-
    prompt draw nothing); sampling reads it back to the host, one small
    copy per step. Greedy (``sample=False``) is a plain argmax and never
    leaves the card."""
    if not sample:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    b = logits.shape[0]
    rows = range(b) if advance is None else \
        [i for i, a in enumerate(advance.tolist()) if a]
    tok = torch.zeros((b, 1), dtype=torch.int32, device=logits.device)
    for i in rows:
        tok[i] = sample_token(logits[i:i + 1], gens[i], temperature,
                              sample=True)[0]
    return tok


def advance_step_rows(logits, gens, temperature, done, rem, n, active, *,
                      sample: bool, eos_id: int | None, pad_id: int):
    """Per-row serve-step tail shared by the pure-decode and mixed
    segment bodies: sample each ``active`` row from its own stream, pad
    everything else, count active emissions into ``n``, charge them
    against ``rem`` and fold budget exhaustion / EOS into ``done``.
    Returns ``(tok (B, 1), done, rem, n)``."""
    nxt = sample_token_rows(logits, gens, temperature, sample=sample,
                            advance=active)
    nxt = torch.where(active[:, None], nxt, pad_id)
    n = n + active.sum(dtype=torch.int32)
    rem = rem - active.to(torch.int32)
    done = done | (active & (rem <= 0))
    if eos_id is not None:
        done = done | (active & (nxt[:, 0] == eos_id))
    return nxt, done, rem, n


def make_serve_segment(cfg, *, segment: int, sample: bool,
                       eos_id: int | None, pad_id: int,
                       chunk: int | None = None, budget: int | None = None,
                       mixed_steps: int | None = None, graphs=None):
    """One continuous-batching segment: ``segment`` steps over a
    fixed-slot ``ServeSlotState`` between two host admission points.

    ``chunk=None`` — pure decode: every live slot advances one token per
    step through the paged decode kernel (``live`` masks finished, empty
    and mid-prompt slots out of cache writes and position advances).

    ``chunk=N`` — mixed chunked prefill + decode: each step every live
    slot processes one decode token or one prompt chunk of up to ``N``
    tokens written straight into pool pages (``append_chunk`` and the
    ragged-q paged onepass kernel). The per-step token budget is
    decode-maximal: every decoding slot gets its token first, then prompt
    chunks fill the leftover ``budget - n_decode`` in priority order
    (stable, so equal classes keep slot order). A slot whose chunk
    completes its prompt samples its first token that step.

    ``mixed_steps=k`` runs a two-phase segment: ``k`` mixed steps, then
    ``segment - k`` 1-token decode steps (``None`` = all mixed).

    ``graphs`` (a ``CapturedSteps``; greedy only) replays each step from
    one of two CUDA graphs, the mixed step's and the decode step's,
    whatever ``k`` (the JAX package compiles a segment per ``k``);
    ``None`` runs the steps' ops eagerly.

    Returns ``seg(model, state, caches, temperature) -> (tokens (B,
    segment), emitted (B, segment), grants (B, segment), state, caches,
    n_live)`` — ``emitted`` marks the real step-tokens, ``grants`` the
    per-slot token counts (``sum(grants[:, t]) <= budget``). The outputs
    stay on the card until the caller reads them back, once per segment.
    """
    decode = make_decode_step(cfg)
    if chunk is not None:
        if chunk < 1:
            raise ValueError(f"chunk={chunk} must be >= 1")
        if budget is None or budget < 1:
            raise ValueError(f"budget={budget} must be >= 1")
    if graphs is not None and sample:
        raise ValueError("sampled serve steps read the host every step and "
                         "run eagerly (graphs=None)")

    def decode_body(model, temperature, carry):
        caches, st, n = carry
        # slots still mid-prompt (a two-phase segment whose mixed steps
        # underestimated budget contention) pause rather than decode from
        # a token they never sampled
        live = ~st.done & (st.cursor >= st.plen)
        logits, caches = decode(model, st.tok, caches, st.pos, live)
        nxt, done, rem, n = advance_step_rows(
            logits, st.gens, temperature, st.done, st.rem, n, live,
            sample=sample, eos_id=eos_id, pad_id=pad_id)
        st = dataclasses.replace(
            st, tok=torch.where(live[:, None], nxt, st.tok),
            pos=st.pos + live.to(torch.int32), done=done, rem=rem)
        return (caches, st, n), (nxt[:, 0], live, live.to(torch.int32))

    def mixed_body(model, temperature, carry):
        caches, st, n = carry
        live = ~st.done
        prefilling = live & (st.cursor < st.plen)
        decoding = live & (st.cursor >= st.plen)
        # decode-maximal budget: decode slots first, prompt chunks fill
        # the leftover greedily in priority order
        want = torch.where(prefilling,
                           torch.clamp(st.plen - st.cursor, max=chunk), 0)
        order = torch.argsort(-st.prio, stable=True)
        want_o = want[order]
        cum_o = torch.cumsum(want_o, 0, dtype=torch.int32) - want_o
        left = budget - decoding.sum(dtype=torch.int32)
        grant = torch.zeros_like(want)
        grant[order] = torch.minimum(torch.clamp(left - cum_o, min=0),
                                     want_o)
        n_new = grant + decoding.to(torch.int32)
        # token block: prompt chunk at the cursor, or [tok, pad...]
        ar = torch.arange(chunk, dtype=torch.int32, device=st.pos.device)
        cols = st.cursor[:, None] + ar
        ptoks = torch.gather(
            st.prompt_buf, 1,
            torch.clamp(cols, 0, st.prompt_buf.shape[1] - 1).long())
        first = ar[None, :] == 0
        tokens = torch.where(prefilling[:, None], ptoks,
                             torch.where(first, st.tok, pad_id))
        x, caches = forward(model, tokens, cfg, mode="decode",
                            caches=caches, pos0=st.pos, q_lens=n_new,
                            skip_unembed=True)
        # next-token logits sit at each row's last granted column; only
        # that (B, 1, d) slice is unembedded
        idx = torch.clamp(n_new - 1, min=0).long()[:, None, None]
        sel = torch.gather(x, 1, idx.expand(-1, 1, x.shape[-1]))
        logits = unembed(model.unembed_weight(), sel, cfg.logit_softcap)
        completes = prefilling & (st.cursor + n_new >= st.plen)
        emits = decoding | completes
        nxt, done, rem, n = advance_step_rows(
            logits, st.gens, temperature, st.done, st.rem, n, emits,
            sample=sample, eos_id=eos_id, pad_id=pad_id)
        st = dataclasses.replace(
            st, tok=torch.where(emits[:, None], nxt, st.tok),
            pos=st.pos + n_new, done=done, rem=rem,
            cursor=st.cursor + torch.where(prefilling, n_new, 0))
        return (caches, st, n), (nxt[:, 0], emits, n_new)

    k = 0 if chunk is None else \
        (segment if mixed_steps is None else min(mixed_steps, segment))

    def seg(model, state, caches, temperature):
        b, dev = state.pos.shape[0], state.pos.device
        carry = (caches, state, torch.zeros((), dtype=torch.int32,
                                            device=dev))
        toks = torch.empty((b, segment), dtype=torch.int32, device=dev)
        emits = torch.empty((b, segment), dtype=torch.bool, device=dev)
        grants = torch.empty((b, segment), dtype=torch.int32, device=dev)
        for i in range(segment):
            name, body = ("mixed", mixed_body) if i < k \
                else ("decode", decode_body)
            body = functools.partial(body, model, temperature)
            carry, out = body(carry) if graphs is None \
                else graphs.run(name, body, carry)
            toks[:, i], emits[:, i], grants[:, i] = out
        caches, state, n = carry
        return toks, emits, grants, state, caches, n

    return seg
