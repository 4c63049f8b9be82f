"""95th percentile over finished requests of the time per output token
a streaming user sees: (finished - first token) / (gen - 1), in ms.
Tokens are read back once per segment, so no single gap between two
tokens is observable."""

import numpy as np

from perfbench.harness.readers import p95


def read(run):
    vals = []
    for c in run.result.completed:
        n = int(np.asarray(c.tokens).size)
        if n >= 2:
            vals.append(1e3 * (c.finished_s - c.first_token_s) / (n - 1))
    return p95(vals)
