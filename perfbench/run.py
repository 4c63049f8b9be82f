"""One run of one cell of the serving benchmark of ``repro_torch``.

    python3 perfbench/run.py --workload CELL --seed N --seconds S \
        --trace 0|1

Set-up (timed as ``setup_s``): imports and CUDA, the program's kernels
built or loaded from ``build/repro_torch_kernels/`` in the checkout,
the weights drawn on the card from ``--seed`` (``harness/weights.py``),
the trace of requests generated from ``--seed``
(``harness/traffic.py``), a short warm-up serve of the cell's shapes.
Then the window: one ``serve_continuous`` over the trace, drained after
``--seconds`` (``harness/serve.py``); with ``--trace 1`` its device work is profiled
up to the boundary at which the drain takes effect (``harness/
trace.py``). Then the check against the plain reference
(``harness/check.py``), after the peak memory was read and the
program's pool freed.

The last line of standard output is one JSON object: ``correct``,
``attempted`` (requests finished: every request admitted before the
drain finishes), ``failed`` (finished short of their tokens),
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones, each read by ``metrics/<name>.py``), ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``: each number compared
beside its limit, which also close standard error. Without a CUDA card
(or with fewer cards than the cell asks for), without the program's
source beside the benchmark, or with JAX or the JAX package loaded once
the window has closed, it prints no result and exits with 2.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _fixed_caches(root: Path) -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(root / "build" / "perfbench" / sub)


def forbidden_modules() -> list[str]:
    """Loaded modules whose whole top-level name is JAX's or the JAX
    package's (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def card(chips: int):
    """The first card, or an error message."""
    import torch
    if not torch.cuda.is_available():
        return None, "no CUDA card: torch.cuda.is_available() is False"
    if torch.cuda.device_count() < chips:
        return None, (f"the cell asks for {chips} cards, "
                      f"torch.cuda.device_count() is "
                      f"{torch.cuda.device_count()}")
    return torch.device("cuda", 0), None


def measure(spec: dict, seed: int, seconds: float, trace: bool, device,
            t_start: float = T_START) -> dict:
    """Set-up, window, metrics and check of one run on ``device``;
    returns the result object (without printing it)."""
    import torch

    from perfbench.harness import check as CHECK
    from perfbench.harness import readers, serve, traffic
    from perfbench.harness import trace as TRACE
    from perfbench.harness import weights as W

    on_card = device.type == "cuda"
    split = {}
    t = time.perf_counter()
    torch.zeros(1, device=device)
    from repro_torch.kernels.common import exact_float32_matmul
    exact_float32_matmul()
    split["import_and_cuda_s"] = time.perf_counter() - t_start
    t = time.perf_counter()
    if on_card:
        from repro_torch.kernels import build
        build.build_all()
        for name in build.SOURCES:
            build.library(name)
    split["kernels_s"] = time.perf_counter() - t
    cfg, mc = serve.port_config(spec["config"]), spec["config"]["model"]
    t = time.perf_counter()
    tree = W.make(mc, seed, device)
    model = W.serve_model(tree, cfg)
    if on_card:
        torch.cuda.synchronize(device)
    split["weights_s"] = time.perf_counter() - t
    t = time.perf_counter()
    requests = traffic.generate(spec["traffic"], seed, mc["vocab_size"])
    split["traffic_s"] = time.perf_counter() - t
    t = time.perf_counter()
    serve.warm_up(model, cfg, spec["serve"], spec["traffic"], seed, device)
    split["warmup_s"] = time.perf_counter() - t
    setup_s = time.perf_counter() - t_start

    drain = TRACE.profiled_drain(device) if trace else None
    window = serve.timed(model, cfg, requests, spec["serve"],
                         spec["traffic"], seconds, device, drain)
    if drain is not None:
        drain.stop()                    # a serve that ended before the drain
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    run = readers.Run(spec=spec, mc=mc, window=window, setup_s=setup_s,
                      trace=drain.trace if drain else None,
                      pause_s=drain.pause_s if drain else 0.0)
    names = spec["per_layer"] if trace else spec["end_to_end"]
    metrics = {}
    for name in names:
        value = readers.read(name, run)
        if value is not None:
            metrics[name] = {"value": value, "unit": spec["units"][name]}
    attempted = len(window.result.completed)
    failed = sum(len(c.tokens) != window.trace[c.index].gen
                 for c in window.result.completed)

    del model
    if on_card:
        torch.cuda.empty_cache()
    checks = CHECK.check(window, tree, mc, seed, spec["serve"]["check"])
    device_info = {"platform": "gpu" if on_card else device.type,
                   "kind": torch.cuda.get_device_name(device) if on_card
                   else device.type,
                   "count": 1, "memory_peak_bytes": int(peak)}
    res = window.result
    out = {"correct": CHECK.passed(checks) and failed == 0,
           "attempted": attempted, "failed": int(failed),
           "metrics": metrics, "device": device_info,
           "setup_split": split,
           "window": {"wall_s": run.wall_s, "steps": res.steps,
                      "segments": res.segments, "capture_s": res.capture_s,
                      "tokens": sum(len(c.tokens) for c in res.completed),
                      "prefill_tokens": res.prefill_tokens}}
    if run.trace is not None:
        device_info["busy_s"] = run.trace.busy_s
        device_info["window_s"] = run.trace.window_s
        out["breakdown"] = run.trace.breakdown()
        out["trace_cost_s"] = dict(run.trace.cost_s,
                                   launches=run.trace.launches)
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    args = parse(argv)
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"no program beside the benchmark: {ROOT / 'src'} holds no "
              f"repro_torch", file=sys.stderr)
        return 2
    _fixed_caches(ROOT)
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    from perfbench.harness import spec as SPEC
    spec = SPEC.cell_spec(args.workload)
    device, err = card(int(spec["entry"]["chips"]))
    if err:
        print(err, file=sys.stderr)
        return 2
    out = measure(spec, args.seed, args.seconds, bool(args.trace), device)
    found = forbidden_modules()
    if found:
        print(f"loaded after the window: {', '.join(found)} (the benchmark "
              f"may load neither JAX nor the JAX package)", file=sys.stderr)
        return 2
    print(json.dumps({k: out[k] for k in out if k != "checks"}
                     | {"checks": out["checks"]}))
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']} {c['holds']} {c['limit']}",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
