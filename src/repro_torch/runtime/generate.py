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
per-row kernel meta. Continuous batching over the paged pool
(``serve_continuous``) comes with the next slice of the port.
"""

from __future__ import annotations

import dataclasses
import time

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

    @property
    def decode_tok_s(self) -> float:
        return self.n_decode_tokens / max(self.decode_s, 1e-9)


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


def _validate_caches(caches, cfg, batch: int, max_len: int, dev):
    from repro_torch.models import init_caches
    expected = init_caches(cfg, 1, max_len, device="cpu")
    if len(caches) != len(expected):
        raise ValueError(f"caches= holds {len(caches)} layers, "
                         f"{cfg.name!r} has {len(expected)}")
    for i, (c, e) in enumerate(zip(caches, expected, strict=True)):
        k, ek = c["mix"].k, e["mix"].k
        if k.shape != (batch,) + ek.shape[1:] or k.dtype != ek.dtype \
                or k.device != dev:
            raise ValueError(
                f"caches= layer {i} ring {tuple(k.shape)}/{k.dtype} on "
                f"{k.device} does not match batch={batch}, max_len="
                f"{max_len} ({(batch,) + tuple(ek.shape[1:])}/{ek.dtype} on "
                f"{dev})")


def generate(model, cfg, prompts, gen: int, *, temperature: float = 0.0,
             generator: torch.Generator | None = None,
             max_len: int | None = None, caches=None, prompt_lengths=None,
             eos_id: int | None = None, pad_id: int = 0,
             early_exit: bool = False, paged: bool = False,
             device="cuda") -> GenerateResult:
    """Prefill the prompt batch, then decode ``gen`` tokens.

    ``prompts`` (B, S) int, right-padded when ``prompt_lengths`` (B,)
    declares a ragged batch. ``max_len`` sizes the KV rings (default
    S + gen; smaller values evict the oldest tokens; capacities above one
    KV block are block-aligned). ``caches`` reuses rings from
    ``init_caches`` (validated against batch and max_len). ``temperature
    > 0`` with a ``generator`` samples; otherwise decoding is greedy.
    ``eos_id``: sequences that emit it are pinned to ``pad_id`` and stop
    counting toward ``decode_tok_s``; ``early_exit`` stops once all have.
    ``device`` (default the card; raises when CUDA is missing) must hold
    the model.
    """
    from repro_torch.launch.steps import (make_generate_loop,
                                          make_prefill_step, sample_token)
    from repro_torch.models import init_caches

    if paged:
        raise NotImplementedError(
            "paged KV pools (PagedKVState) come with the next slice of the "
            "port (ROADMAP A5/B3)")
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
    if caches is None:
        caches = init_caches(cfg, b, max_len, device=dev)
    else:
        _validate_caches(caches, cfg, b, max_len, dev)
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
        loop = make_generate_loop(cfg, gen=gen, sample=sample,
                                  eos_id=eos_id, pad_id=pad_id,
                                  early_exit=early_exit)
        t0 = time.perf_counter()
        rest, n_dec, steps_run, caches = loop(model, tok, caches, pos0,
                                              generator, temperature)
        tokens = torch.cat([tok, rest], dim=1)
        _sync(dev)
        t_decode = time.perf_counter() - t0

    return GenerateResult(tokens=tokens, prefill_s=t_prefill,
                          decode_s=t_decode, decode_steps=steps_run,
                          n_decode_tokens=int(n_dec))
