"""The whole serve's share of the card's bf16 dense peak, in %: the
model FLOPs of every request the window served (``harness/work.py``)
over the window's wall time times 989.4 TFLOP/s."""

import numpy as np

from perfbench.harness import work


def read(run):
    res = run.result
    if run.trace is None or run.wall_s <= 0:
        return None
    flops = sum(work.request_model_flops(
        run.mc, len(run.request(c).prompt), int(np.asarray(c.tokens).size))
        for c in res.completed)
    return 100.0 * flops / (run.wall_s * work.PEAKS["bf16_flops"])
