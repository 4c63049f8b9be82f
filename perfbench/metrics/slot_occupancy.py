"""Share of slot-steps held by a request: the sum over finished requests
of (finished step - admitted step) over steps x slots, in %. A count of
the scheduler's own steps, from the traced run."""


def read(run):
    res = run.result
    if run.trace is None or not res.steps:
        return None
    held = sum(c.finished_step - c.admitted_step for c in res.completed)
    return 100.0 * held / (res.steps * run.spec["serve"]["slots"])
