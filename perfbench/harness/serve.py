"""The system under test, driven as users run it: ``repro_torch.runtime.
generate.serve_continuous`` (chunked admission, greedy decoding, the
mixed and decode steps replayed from CUDA graphs, ITA int8 attention
over the paged int8 pool), with its configuration, the benchmark's
weights and the generated trace.

The timed window is one serve over a trace longer than the window can
serve. At ``seconds`` a timer requests the serve's own drain
(``runtime.journal.ServeDrain``, no timeout): the serve admits nothing
more and finishes every request in flight. The window is the serve's
``wall_s``: it holds the serve's graph captures and the drain's tail.
Requests still waiting at the drain were never attempted.
"""

from __future__ import annotations

import dataclasses
import threading

import torch

from perfbench.harness import traffic


def port_config(config: dict):
    """The program's ``ModelConfig`` of a configuration file, each number
    the file states checked against it."""
    from repro_torch.configs.registry import get_config
    cfg = get_config(config["port_config"], **config.get("port_overrides",
                                                         {}))
    for key, want in config["model"].items():
        got = cfg.n_layers if key == "n_layers" else getattr(cfg, key)
        if got != want:
            raise ValueError(f"{config['port_config']}: {key} is {got!r} in "
                             f"the program, {want!r} in the configuration "
                             f"file")
    return cfg


def serve_kwargs(serve: dict, mix: dict, device) -> dict:
    """``serve_continuous``'s arguments of a workload file. ``max_len`` is
    the mix's longest request, so every trace of the mix (and the warm-up)
    allocates the same pool."""
    return dict(slots=serve["slots"], segment=serve["segment"],
                page_size=serve["page_size"], num_pages=serve["num_pages"],
                chunk_size=serve["chunk_size"],
                token_budget=serve.get("token_budget"),
                max_len=mix["prompt"]["max"] + mix["output"]["max"],
                device=device)


def to_requests(trace):
    from repro_torch.runtime.generate import ServeRequest
    return [ServeRequest(r.prompt, gen=r.gen, arrival=r.arrival)
            for r in trace]


def warm_up(model, cfg, serve: dict, mix: dict, seed: int, device):
    """A short serve of the cell's own shapes: a few requests of the
    mix's smallest prompts and outputs, every one due at step 0, so the
    serve runs mixed and decode steps over the same pool and batch
    geometry as the window."""
    from repro_torch.runtime.generate import serve_continuous
    small = dict(mix, requests=serve["warmup_requests"], block=8,
                 arrival={"kind": "backlog"},
                 prompt=dict(mix["prompt"], max=mix["prompt"]["min"]),
                 output=dict(mix["output"], max=mix["output"]["min"]))
    reqs = to_requests(traffic.generate(small, seed, cfg.vocab_size))
    serve_continuous(model, cfg, reqs, **serve_kwargs(serve, mix, device))


@dataclasses.dataclass
class Window:
    result: object              # the serve's ServeResult
    trace: list                 # the generated trace (traffic.Request)


def timed(model, cfg, trace, serve: dict, mix: dict, seconds: float,
          device, drain=None) -> Window:
    """The timed window (module docstring); ``drain`` a ``ServeDrain``
    of the caller's (a new one by default)."""
    from repro_torch.runtime.generate import serve_continuous
    from repro_torch.runtime.journal import ServeDrain
    drain = ServeDrain() if drain is None else drain
    timer = threading.Timer(seconds, drain.request)
    timer.daemon = True
    reqs = to_requests(trace)
    kw = serve_kwargs(serve, mix, device)
    timer.start()
    try:
        res = serve_continuous(model, cfg, reqs, drain=drain, **kw)
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
    finally:
        timer.cancel()
        timer.join()
    return Window(result=res, trace=trace)
