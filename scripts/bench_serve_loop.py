"""Time the serving loops of a ``repro_torch`` tree end to end on
full-width qwen2-7b (28 layers, random bf16 weights from seed 0, ITA int8
attention), at the shapes of ``chip_smoke.py`` (its ``B``, ``PROMPT``,
``GEN``, ``SERVE`` and ``serve_trace``, imported from it):

- ``generate()`` run (a): batch 4, prompt 512, 32 tokens, unpinned; with
  ``loop="fused"`` (the decode step replayed from a CUDA graph) and
  ``loop="stepwise"`` where the tree has the argument, else the tree's
  one loop; each loop twice (the first fused call captures);
- ``serve_continuous`` of ``chip_smoke.py``'s 12-request trace (numpy
  seed 7: prompts 133-975 tokens, 16-45 generated, arrivals 0-6 steps
  apart; 4 slots, 128-token pages, 24 pages, 96-token chunks, 16-step
  segments), unpinned, chunked admission; and where the tree has it,
  ``admission="stall"`` under the ``ita_onepass_pallas`` pin.

    python3 scripts/bench_serve_loop.py [--src DIR] [--label NAME]

``--src`` is the ``src`` directory whose ``repro_torch`` is timed (this
checkout's by default): run the script on two trees, one after another on
the same card, to compare them (a parent unpacked by ``git archive`` into
the git-ignored ``build/``, then this tree, this tree, the parent). Each
run prints one JSON line with its wall-clock figures and a checksum of
its tokens, which two trees with equal tokens share; the first line
names the card and its power limit as ``nvidia-smi`` reports them. Needs
a CUDA card; builds the tree's kernels first (not timed).
"""

from __future__ import annotations

import argparse
import dataclasses
import inspect
import json
import subprocess
import sys
import zlib
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from chip_smoke import B, GEN, PROMPT, SERVE, serve_trace  # noqa: E402


def checksum(rows):
    import numpy as np
    return zlib.crc32(b"".join(np.asarray(r, np.int32).tobytes()
                               for r in rows))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="tree")
    opts = ap.parse_args(argv)
    sys.path.insert(0, str(Path(opts.src).resolve()))
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels.common import exact_float32_matmul
    from repro_torch.models import init_model
    from repro_torch.runtime.generate import generate, serve_continuous

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps({"label": opts.label, "card": card,
                      "src": str(Path(opts.src).resolve())}), flush=True)
    exact_float32_matmul()
    build.build_all()
    cfg = get_config("qwen2-7b", attention_impl="ita")
    model = init_model(cfg, seed=0, device="cuda")
    prompts = torch.randint(0, cfg.vocab_size, (B, PROMPT),
                            generator=torch.Generator().manual_seed(0))
    loops = ["fused", "stepwise"] \
        if "loop" in inspect.signature(generate).parameters else [None]

    def emit(**row):
        print(json.dumps({"label": opts.label, **row}), flush=True)

    for loop in loops:
        for call in (1, 2):
            kw = {} if loop is None else {"loop": loop}
            res = generate(model, cfg, prompts, GEN, device="cuda", **kw)
            emit(what="generate (a)", loop=loop or "eager", call=call,
                 prefill_s=res.prefill_s, decode_s=res.decode_s,
                 decode_tok_s=res.decode_tok_s,
                 capture_s=getattr(res, "capture_s", 0.0),
                 tokens=checksum(res.tokens.cpu().numpy()))
    reqs = serve_trace(cfg)
    pinned = dataclasses.replace(cfg, attention_backend="ita_onepass_pallas")
    for admission, c in (("chunked", cfg), ("stall", pinned)):
        try:
            res = serve_continuous(
                model, c, reqs, slots=SERVE["slots"],
                segment=SERVE["segment"], page_size=SERVE["page_size"],
                num_pages=SERVE["num_pages"],
                chunk_size=SERVE["chunk_size"], admission=admission,
                device="cuda")
        except NotImplementedError as err:     # a tree without stall
            emit(what="serve", admission=admission, skipped=str(err))
            continue
        done = sorted(res.completed, key=lambda r: r.index)
        emit(what="serve", admission=admission, wall_s=res.wall_s,
             tok_s=res.tok_s, tokens_out=res.total_tokens,
             ttft_p50=res.ttft_quantile(0.5),
             ttft_p90=res.ttft_quantile(0.9),
             latency_p50=res.latency_quantile(0.5), steps=res.steps,
             prefill_stall_s=res.prefill_stall_s,
             capture_s=getattr(res, "capture_s", 0.0),
             tokens=checksum(r.tokens for r in done))


if __name__ == "__main__":
    main()
