"""Time the twopass kernels (B5a pass 1 ``qk_da``, B5b pass 2 ``av_en``)
of a ``repro_torch`` tree at the shapes of ``chip_smoke.py`` on qwen2-7b
(28 q heads, 4 kv heads, head dim 128, batch 4; kernel-layout K/V,
``block_kv`` 128, random int8 operands from a fixed seed):

- "prefill 512": run (c)'s layer-0 call — q (112, 512, 128), K/V (16,
  512, 128), causal, paper DI;
- the other three twopass calls of ``chip_smoke.py``'s phase 2: a
  300-key window over 256 queries at offset 256, ragged kv_len tails
  (512, 300, 129, 40) with 64 queries at their ends, and Skv 200 padded
  to 256 with kv_len (200, 150, 97, 1);
- "prefill 512, block_kv 256": run (c)'s call in 256-key tiles.

    python3 scripts/bench_twopass.py [--src DIR] [--label NAME] [--call NAME]

``--src`` is the ``src`` directory whose ``repro_torch`` is timed (this
checkout's by default): run the script on two trees, one after another on
the same card, to compare them (for example a parent unpacked by ``git
archive`` into the git-ignored ``build/``, then this tree, this tree, the
parent). Operands are random from a fixed seed, so two trees see the same
inputs. Pass 1 runs on the call's operands; pass 2 on the plain pass 1's
outputs. Each row carries a checksum of the kernel's outputs (A and the
statistics, or out), which two exact trees share, and whether they equal
the plain version. Where the tree's launchers take a ``geometry``, each
pass is also timed in the block size (packed rows) that its
``twopass_geometry`` did not pick. Needs a CUDA card; builds the tree's
kernels on first use.

Each row, one JSON line: ``ms``, the median over 30 runs of the mean of
10 back-to-back launches of the bound kernel (CUDA events), and
``graph_ms``, the same launches captured in a CUDA graph (device time,
without the host's work per launch). The first line names the card and
its power limit as ``nvidia-smi`` reports them.
"""

from __future__ import annotations

import argparse
import inspect
import json
import statistics
import subprocess
import sys
import zlib
from pathlib import Path

HQ, HKV, D, B, PROMPT = 28, 4, 128, 4, 512


def events_ms(fn, reps=30, inner=10):
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


def graph_ms(fn, reps=30, inner=10):
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


def calls():
    """``{name: (args, kwargs)}`` of ``ita_attention_twopass``."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(19)
    bh, rep = B * HQ, HQ // HKV

    def i8(*shape):
        return torch.randint(-128, 128, shape, generator=g, device="cuda",
                             dtype=torch.int8)

    def rows(*x):
        return torch.tensor(x, dtype=torch.int32,
                            device="cuda").repeat_interleave(HQ)
    lm = 0.004 + 0.026 * torch.rand(bh, generator=g, device="cuda")
    om = 0.5 + 1.5 * torch.rand(bh, generator=g, device="cuda")
    q = i8(bh, PROMPT, D)
    k, v = i8(B * HKV, PROMPT, D), i8(B * HKV, PROMPT, D)
    tail = rows(PROMPT, 300, 129, 40)
    short = rows(200, 150, 97, 1)
    base = dict(causal=True, adaptive=False, kv_rep=rep, block_kv=128)
    return {
        "prefill 512": ((q, k, v, lm, om, PROMPT), base),
        "window 300": ((i8(bh, 256, D), k, v, lm, om, PROMPT),
                       dict(base, q_offset=PROMPT - 256, window=300)),
        "kv_len tail": ((i8(bh, 64, D), k, v, lm, om, tail),
                        dict(base, q_offset=torch.clamp(tail - 64, min=0))),
        "Skv 200 padded to 256": ((i8(bh, 200, D), i8(B * HKV, 256, D),
                                   i8(B * HKV, 256, D), lm, om, short),
                                  base),
        "prefill 512, block_kv 256": ((q, k, v, lm, om, PROMPT),
                                      dict(base, block_kv=256)),
    }


def crc(*tensors):
    h = 0
    for t in tensors:
        h = zlib.crc32(t.cpu().numpy().tobytes(), h)
    return h


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--src", default=str(Path(__file__).resolve()
                                             .parents[1] / "src"))
    parser.add_argument("--label", default="this tree")
    parser.add_argument("--call", action="append",
                        help="time only this call (repeatable)")
    opts = parser.parse_args()
    sys.path.insert(0, str(Path(opts.src).resolve()))
    import torch
    if not torch.cuda.is_available():
        print("bench_twopass: CUDA is not available", file=sys.stderr)
        return 2
    from repro_torch.kernels.common import exact_float32_matmul, sm_count
    from repro_torch.kernels.ita_attention import kernel as K
    exact_float32_matmul()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps({"card": card, "label": opts.label, "src": opts.src}))
    other = "geometry" in inspect.signature(K.twopass_qk_launcher).parameters
    for name, (args, kw) in calls().items():
        if opts.call and name not in opts.call:
            continue
        q, k, v, lm, om, kv_len = args
        pass_kw = {n: x for n, x in kw.items() if n != "adaptive"}
        want1 = K.twopass_qk_plain(q, k, lm, kv_len,
                                   adaptive=kw["adaptive"], **pass_kw)
        want2 = K.twopass_av_plain(*want1, v, om, kv_len, **pass_kw)
        geos, picked = [("", None)], None
        if other:
            bkv = min(kw["block_kv"], k.shape[1])
            picked = K.twopass_geometry(q.shape[0], q.shape[1], D, bkv,
                                        kw["kv_rep"], sm_count(q.device),
                                        k.shape[1] // bkv)
            # the block size twopass_geometry did not pick, where allowed
            for sms in (1, 10 ** 6):
                geo = K.twopass_geometry(q.shape[0], q.shape[1], D, bkv,
                                         kw["kv_rep"], sms, k.shape[1] // bkv)
                if any(geo[x]["rows"] != picked[x]["rows"] for x in geo):
                    geos.append((f"rows {geo['qk']['rows']}", geo))
        for variant, geo in geos:
            for kernel, bind in (
                    ("B5a qk_da", lambda x: K.twopass_qk_launcher(
                        q, k, lm, kv_len, adaptive=kw["adaptive"],
                        **pass_kw, **x)),
                    ("B5b av_en", lambda x: K.twopass_av_launcher(
                        *want1, v, om, kv_len, **pass_kw, **x))):
                kind = "qk" if kernel[:3] == "B5a" else "av"
                extra = {} if geo is None else {"geometry": geo[kind]}
                launch, out = bind(extra)
                launch()
                torch.cuda.synchronize()
                outs = out if isinstance(out, tuple) else (out,)
                wants = want1 if isinstance(out, tuple) else (want2,)
                row = {"label": opts.label, "call": name, "kernel": kernel,
                       "variant": variant or "picked",
                       "rows": (picked or {}).get(kind, {}).get("rows")
                       if geo is None else extra["geometry"]["rows"],
                       "ms": events_ms(launch), "graph_ms": graph_ms(launch),
                       "equal_plain": all(torch.equal(o, w) for o, w in
                                          zip(outs, wants, strict=True)),
                       "checksum": crc(*outs)}
                print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
