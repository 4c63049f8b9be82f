"""A cell at the smoke width of a configuration, for the CPU tests: the
same files as a real cell, with the program's widths and the trace cut
to what a CPU serves in seconds."""

from __future__ import annotations

import copy

SMOKE_WIDTHS = {
    "phi3-mini-3.8b": dict(d_model=64, n_heads=4, n_kv_heads=4,
                           head_dim=16, d_ff=128, vocab_size=512,
                           n_layers=2),
}


def smoke_spec(spec: dict, dtype: str = "float32") -> dict:
    """``spec`` (``harness.spec.cell_spec``) at smoke width: the
    configuration's widths and depth cut, the program's configuration
    overridden to match, and a short backlog of short requests
    (every slot busy from the first step)."""
    spec = copy.deepcopy(spec)
    cfg = spec["config"]
    widths = dict(SMOKE_WIDTHS[cfg["port_config"]])
    layers = widths.pop("n_layers")
    cfg["model"].update(widths, n_layers=layers, dtype=dtype,
                        param_dtype=dtype)
    cfg["port_overrides"] = dict(
        cfg["port_overrides"], **widths, dtype=dtype, param_dtype=dtype,
        layer_groups=((("attn",), layers),))
    mix = spec["traffic"]
    mix.update(requests=16, block=8,
               prompt=dict(mix["prompt"], min=12, max=72),
               output=dict(mix["output"], min=4, max=16))
    mix["arrival"] = {"kind": "backlog"}
    serve = spec["serve"]
    serve.update(slots=4, num_pages=32, warmup_requests=2,
                 token_budget=4 * serve["chunk_size"])
    # the cell's own sample; at smoke width the program reads 0 against
    # the reference and the float8 control 0.66-2.9 (CPU, seeds 3 and 17):
    # the smoke limit lies between them, as the cell's limit lies between
    # its readings
    serve["check"] = dict(serve["check"], min_checked_tokens=8,
                          max_logit_gap=0.35)
    return spec
