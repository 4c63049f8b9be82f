"""What decides ``correct``: the served tokens against the plain
reference (``perfbench/reference``), after the window has closed.

A sample of the finished requests, drawn from the seed and holding the
request with the longest prompt and output, is run through the
reference once each, at the configuration's stated precision: the
prompt followed by its served tokens. At each served position the
reference's logits give the gap by which the served token lies below
the reference's best token; the check compares the widest gap of the
sample with the cell's limit (greedy serving puts first the reference's
best token, or one within rounding of it). Beside it, every finished
request has to hold exactly the tokens it asked for, and at least one
request has to finish.

``gaps(..., control="fp8")`` reads the same positions for the control,
the reference one precision below the stated one (``reference.model``):
the gap of the token the control puts first. The limit lies between
the program's widest gaps and the control's, as ``PERF.md`` records
(``control.py`` takes both readings).
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.reference import model as REF


def sample(completed, trace, seed: int, n: int) -> list:
    """``n`` finished requests: the longest (prompt plus output) and the
    rest drawn from ``seed``."""
    if not completed:
        return []
    size = [len(trace[c.index].prompt) + trace[c.index].gen
            for c in completed]
    first = int(np.argmax(size))
    rest = [i for i in range(len(completed)) if i != first]
    rng = np.random.default_rng([int(seed) % 2**64, 7])
    pick = rng.choice(len(rest), size=min(n - 1, len(rest)), replace=False)
    return [completed[first]] + [completed[rest[int(i)]] for i in pick]


def _positions(c, trace):
    prompt = np.asarray(trace[c.index].prompt, np.int64)
    served = np.asarray(c.tokens, np.int64)
    seq = np.concatenate([prompt, served[:-1]])
    return seq, np.arange(len(prompt) - 1, len(seq)), served


def gaps(tree, mc: dict, picked, trace, control: str | None = None):
    """Per sampled request, the reference's gaps of the served tokens, or
    with ``control`` (a precision of ``reference.model``) the reference's
    gaps of the tokens the control puts first."""
    out = []
    for c in picked:
        seq, pos, served = _positions(c, trace)
        ref = REF.logits_at(tree, mc, seq, pos)
        if control is None:
            tok = torch.as_tensor(served, device=ref.device)
        else:
            tok = REF.logits_at(tree, mc, seq, pos, control).argmax(-1)
        gap = ref.max(dim=-1).values - ref.gather(1, tok[:, None])[:, 0]
        out.append(gap.cpu().numpy())
        del ref
    return out


def check(window, tree, mc: dict, seed: int, limits: dict,
          control: str | None = None) -> dict:
    """``{name: {"value", "limit", "holds"}}`` of every number compared;
    ``holds`` is ``"<="`` or ``">="``. With ``control``, the control's
    tokens take the served ones' place in ``max_logit_gap``."""
    res, trace = window.result, window.trace
    short = sum(len(np.asarray(c.tokens)) != trace[c.index].gen
                for c in res.completed)
    picked = sample(res.completed, trace, seed, limits["sample_requests"])
    g = gaps(tree, mc, picked, trace, control)
    widest = float(max((x.max() for x in g), default=float("inf")))
    return {
        "finished_requests": {"value": len(res.completed), "limit": 1,
                              "holds": ">="},
        "short_requests": {"value": int(short), "limit": 0, "holds": "<="},
        "checked_tokens": {"value": int(sum(x.size for x in g)),
                           "limit": limits["min_checked_tokens"],
                           "holds": ">="},
        "max_logit_gap": {"value": widest, "limit": limits["max_logit_gap"],
                          "holds": "<="},
    }


def passed(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] if c["holds"] == "<="
               else c["value"] >= c["limit"] for c in checks.values())
