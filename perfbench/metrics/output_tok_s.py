"""Generated tokens of every finished request over the window's wall
time: the service's throughput, over all the work and all the time of
the window (the drain's tail included)."""

import numpy as np


def read(run):
    res = run.result
    if not res.completed or run.wall_s <= 0:
        return None
    tokens = sum(int(np.asarray(c.tokens).size) for c in res.completed)
    return tokens / run.wall_s
