"""Time the int8 GEMM (ITA's quantized linear layer, schedules B7a "tpu"
and B7b "weight_stationary") of a ``repro_torch`` tree at the shapes of
qwen2-7b's projections: M = 2048 rows (a prefill of 4 x 512 tokens) and
M = 4 (a decode step of 4 sequences), by K x N = 3584 x 3584 (wq, wo),
3584 x 512 (wk, wv), 3584 x 18944 (w_gate, w_up), 18944 x 3584 (w_down).

    python3 scripts/bench_int8_matmul.py [--src DIR] [--label NAME]

``--src`` is the ``src`` directory whose ``repro_torch`` is timed (this
checkout's by default): run the script on two trees, one after another on
the same card, to compare them (for example a parent unpacked by ``git
archive`` into the git-ignored ``build/``, then this tree, this tree, the
parent). The operands are random (int8 x and w, int32 bias, float32
multipliers) from a fixed seed, so two trees see the same inputs, and
each row carries a checksum of the int8 output that two exact trees
share. Needs a CUDA card; builds the tree's kernels on first use.

Each row, one JSON line, times with CUDA events (medians over ``reps``
of the mean over 10 calls):

- ``kernel_ms``: the kernel alone, bound once (``kernel_launcher``) and
  launched back to back, on a weight stored K-major (a tree that reads w
  row-major copies it once, at binding);
- ``kernel_graph_ms``: the same launches captured in a CUDA graph (device
  time, without the host's work per launch);
- ``wrapper_row_major_ms`` / ``wrapper_k_major_ms``: ``ops.int8_matmul``
  called back to back on the weight stored row-major (the layout
  ``quantize_tensor`` gave it before weights were stored K-major) and
  K-major.

The first line names the card and its power limit as ``nvidia-smi``
reports them.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

SHAPES = [(m, k, n) for m in (2048, 4)
          for k, n in ((3584, 3584), (3584, 512), (3584, 18944),
                       (18944, 3584))]
SCHEDULES = ("tpu", "weight_stationary")


def events_ms(fn, reps, inner=10):
    import torch
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


def graph_ms(fn, reps, inner=10):
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    return events_ms(graph.replay, reps, inner=1) / inner


def launcher(kernel_launcher, *args, **kw):
    """One callable for a bound call: a tree's ``kernel_launcher`` returns
    one launch, or a list of them to run in order."""
    launch, out = kernel_launcher(*args, **kw)
    if callable(launch):
        return launch, out
    launches = launch

    def run():
        for f in launches:
            f()
    return run, out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1]
                                         / "src"))
    ap.add_argument("--label", default="tree")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch
    if not torch.cuda.is_available():
        print("bench_int8_matmul: needs a CUDA card", file=sys.stderr)
        return 1
    from repro_torch.kernels.int8_matmul import kernel as MK
    from repro_torch.kernels.int8_matmul.ops import int8_matmul
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip().splitlines()[0]
    print(json.dumps({"label": args.label, "src": args.src, "card": card}),
          flush=True)
    g = torch.Generator().manual_seed(args.seed)
    for m, k, n in SHAPES:
        x = torch.randint(-128, 128, (m, k), generator=g,
                          dtype=torch.int8).cuda()
        w_rm = torch.randint(-128, 128, (k, n), generator=g,
                             dtype=torch.int8).cuda()
        w_km = w_rm.t().contiguous().t()
        bias = torch.randint(-10**5, 10**5, (n,), generator=g,
                             dtype=torch.int32).cuda()
        mult = (torch.rand(n, generator=g) * 40 / (5329 * k ** 0.5)).cuda()
        x_pad = torch.nn.functional.pad(x, (0, 0, 0, max(0, 8 - m)))
        for schedule in SCHEDULES:
            reps = 10 if m > 16 and schedule != "tpu" else 20
            run, out = launcher(MK.kernel_launcher, x_pad, w_km, bias, mult,
                                schedule=schedule)
            kernel = events_ms(run, reps)
            graph = graph_ms(run, reps)
            wrapper = {layout: events_ms(
                lambda w=w, schedule=schedule: int8_matmul(
                    x, w, bias, mult, schedule=schedule), reps)
                for layout, w in (("row_major", w_rm), ("k_major", w_km))}
            got = int8_matmul(x, w_rm, bias, mult, schedule=schedule)
            if not torch.equal(out[:m], got):
                raise AssertionError(f"{(m, k, n, schedule)}: the bound "
                                     f"kernel and the wrapper disagree")
            checksum = int((got.long() * torch.arange(
                1, n + 1, device=got.device)).sum())
            print(json.dumps({
                "label": args.label, "m": m, "k": k, "n": n,
                "schedule": schedule, "kernel_ms": kernel,
                "kernel_graph_ms": graph,
                "wrapper_row_major_ms": wrapper["row_major"],
                "wrapper_k_major_ms": wrapper["k_major"],
                "checksum": checksum}), flush=True)
        del x, w_rm, w_km
    return 0


if __name__ == "__main__":
    sys.exit(main())
