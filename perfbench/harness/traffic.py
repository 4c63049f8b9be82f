"""The one traffic generator: a trace of requests from a mix's parameter
file and a seed.

The mix file gives ``requests`` (how many; more than a window serves),
``block`` (requests per block), ``prompt`` and ``output`` (each
``{"dist": "uniform" | "log_uniform", "min", "max"}``, bounds
inclusive) and ``arrival``: ``{"kind": "backlog"}`` (every request due
at step 0) or ``{"kind": "poisson", "rate_per_step": r}`` (an open loop
in the serve's virtual time, decode steps).

Every block holds the same multiset of sizes and gaps: ``block``
stratified quantiles of each distribution (the output quantiles paired
with the prompt ones by a fixed shuffle), so a prefix of whole blocks
has the same composition under every seed. The seed shuffles the order
within each block (of the sizes and, independently, of the gaps) and
draws the prompt token ids, uniform over the vocabulary. So two seeds
give different requests of the same work, and one seed the same trace.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Request:
    prompt: np.ndarray          # (plen,) int32 token ids
    gen: int                    # tokens to generate (no EOS)
    arrival: int                # due at this decode step


def _quantiles(spec: dict, n: int) -> np.ndarray:
    u = (np.arange(n) + 0.5) / n
    lo, hi = float(spec["min"]), float(spec["max"])
    if spec["dist"] == "uniform":
        v = lo + u * (hi + 1 - lo) - 0.5
    elif spec["dist"] == "log_uniform":
        v = np.exp(np.log(lo) + u * (np.log(hi + 1) - np.log(lo))) - 0.5
    else:
        raise ValueError(f"unknown length distribution {spec['dist']!r}")
    return np.clip(np.rint(v), lo, hi).astype(np.int64)


def block_sizes(mix: dict) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The seed-independent ``(prompt, output, gap)`` multisets of one
    block (gaps in steps; zeros for a backlog)."""
    n = int(mix["block"])
    prompt = _quantiles(mix["prompt"], n)
    output = _quantiles(mix["output"], n)[
        np.random.default_rng(0).permutation(n)]
    arr = mix["arrival"]
    if arr["kind"] == "backlog":
        gaps = np.zeros(n)
    elif arr["kind"] == "poisson":
        u = (np.arange(n) + 0.5) / n
        gaps = -np.log1p(-u) / float(arr["rate_per_step"])
    else:
        raise ValueError(f"unknown arrival kind {arr['kind']!r}")
    return prompt, output, gaps


def generate(mix: dict, seed: int, vocab: int) -> list[Request]:
    """The trace of ``mix`` under ``seed`` (module docstring)."""
    prompt, output, gaps = block_sizes(mix)
    n, total = len(prompt), int(mix["requests"])
    rng = np.random.default_rng(int(seed) % 2**64)
    plens, gens, steps = [], [], []
    for start in range(0, total, n):
        take = min(n, total - start)
        order = rng.permutation(n)[:take]
        plens.append(prompt[order])
        gens.append(output[order])
        steps.append(gaps[rng.permutation(n)[:take]])
    plens, gens = np.concatenate(plens), np.concatenate(gens)
    arrivals = np.floor(np.cumsum(np.concatenate(steps))).astype(np.int64)
    ids = rng.integers(0, vocab, size=int(plens.sum()), dtype=np.int32)
    cut = np.cumsum(plens)[:-1]
    return [Request(p, int(g), int(a))
            for p, g, a in zip(np.split(ids, cut), gens, arrivals,
                               strict=True)]
