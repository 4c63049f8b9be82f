"""The readings that set a cell's limit on ``max_logit_gap`` (not run by
the benchmark's own runs). For each seed, one short window of the cell
as ``run.py`` serves it, then ``harness/check.py`` twice with the cell's
own sample and limits: once on the served tokens (the program, which has
to come out correct) and once on the tokens that the float8 control puts
first at the same positions (which has to come out not correct).

    python3 perfbench/control.py --workload CELL --seeds 1,2,3 \\
        [--seconds 8]

One JSON line per seed; the process sets up CUDA and the kernels once.
Exits with 1 if a seed's program is not correct or its control is.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def reading(spec: dict, seed: int, seconds: float, device) -> dict:
    """The program's and the control's checks of one seed."""
    import torch

    from perfbench.harness import check as CHECK
    from perfbench.harness import serve, traffic
    from perfbench.harness import weights as W

    cfg, mc = serve.port_config(spec["config"]), spec["config"]["model"]
    tree = W.make(mc, seed, device)
    model = W.serve_model(tree, cfg)
    trace = traffic.generate(spec["traffic"], seed, mc["vocab_size"])
    serve.warm_up(model, cfg, spec["serve"], spec["traffic"], seed, device)
    window = serve.timed(model, cfg, trace, spec["serve"], spec["traffic"],
                         seconds, device)
    del model
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    limits = spec["serve"]["check"]
    t = time.perf_counter()
    prog = CHECK.check(window, tree, mc, seed, limits)
    ref_s = time.perf_counter() - t
    ctrl = CHECK.check(window, tree, mc, seed, limits, control="fp8")
    return {"seed": seed, "finished": len(window.result.completed),
            "program_correct": CHECK.passed(prog),
            "control_correct": CHECK.passed(ctrl),
            "program": prog, "control": ctrl, "reference_s": ref_s,
            "wall_s": window.result.wall_s}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    args = ap.parse_args(argv)
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    import torch

    from perfbench import run as RUN
    from perfbench.harness import spec as SPEC
    RUN._fixed_caches(ROOT)
    from repro_torch.kernels import build
    from repro_torch.kernels.common import exact_float32_matmul
    spec = SPEC.cell_spec(args.workload)
    device = torch.device("cuda", 0)
    exact_float32_matmul()
    build.build_all()
    sound = True
    for seed in (int(s) for s in args.seeds.split(",")):
        row = reading(spec, seed, args.seconds, device)
        sound &= row["program_correct"] and not row["control_correct"]
        print(json.dumps({"workload": args.workload, **row}), flush=True)
    return 0 if sound else 1


if __name__ == "__main__":
    sys.exit(main())
