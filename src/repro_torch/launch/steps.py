"""Prefill / decode steps, sampling and the decode loop
(``repro.launch.steps``).

The JAX package jits the steps and scans every decode step in one
dispatch; the port runs them eagerly, the decode loop a Python loop over
steps (each step: the decode forward through every layer, then sampling
on the card). Sampling uses a ``torch.Generator``; the JAX package's
threefry keys give other numbers, so sampled streams are compared within
the port only (greedy tokens are compared across the two).
"""

from __future__ import annotations

import torch

from repro_torch.models import forward


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
    def decode_step(model, tokens, caches, pos0):
        return forward(model, tokens, cfg, mode="decode", caches=caches,
                       pos0=pos0)
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


def make_generate_loop(cfg, *, gen: int, sample: bool, eos_id: int | None,
                       pad_id: int, early_exit: bool):
    """The decode loop: ``gen - 1`` decode steps after the prefill token.

    Returns ``loop(model, tok0, caches, pos0, generator, temperature) ->
    (tokens (B, gen-1), n_decode_tokens, steps_run, caches)``; with
    ``early_exit`` the loop stops once every sequence has emitted EOS (one
    host check per step) and the steps it skips are ``pad_id``."""
    decode = make_decode_step(cfg)
    steps = gen - 1

    def loop(model, tok0, caches, pos0, generator, temperature):
        b, dev = tok0.shape[0], tok0.device
        done = (tok0[:, 0] == eos_id) if eos_id is not None \
            else torch.zeros((b,), dtype=torch.bool, device=dev)
        out = torch.full((b, steps), pad_id, dtype=torch.int32, device=dev)
        n = torch.zeros((), dtype=torch.int32, device=dev)
        tok, pos, steps_run = tok0, pos0.to(torch.int32), 0
        for i in range(steps):
            if early_exit and bool(done.all()):
                break
            logits, caches = decode(model, tok, caches, pos)
            tok, done, n = advance_step(logits, generator, temperature, done,
                                        n, sample=sample, eos_id=eos_id,
                                        pad_id=pad_id)
            out[:, i] = tok[:, 0]
            pos = pos + 1
            steps_run += 1
        return out, n, steps_run, caches

    return loop
