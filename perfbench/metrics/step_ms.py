"""The window's wall time over the decode steps it executed, in ms: the
mean time of a replayed step, host work between segments included."""


def read(run):
    res = run.result
    if run.trace is None or not res.steps:
        return None
    return 1e3 * run.wall_s / res.steps
