"""Share of the traced device time spent in ITA attention, in %: the
paged kernels ``onepass_kernel`` (B3, the mixed steps) and
``decode_kernel`` (B4p, the decode steps). A faster attention kernel
lowers it. (A share of the kernels' roofline needs the attention work
of the traced span, which only the program's per-step counts can give:
PERF.md lists them as an open question.)"""


def read(run):
    t = run.trace
    if t is None or t.device_s <= 0:
        return None
    return 100.0 * t.seconds(r"onepass_kernel|decode_kernel") / t.device_s
