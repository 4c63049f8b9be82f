"""Time the ITA decode kernel (B4 over a ring, B4p over a paged pool) and
the onepass kernel on a decode-shaped call (B2, sq 1) of a
``repro_torch`` tree at the main path's shapes on qwen2-7b (28 q heads,
4 kv heads, head dim 128, batch 4):

- B4: ``generate()``'s layer-0 decode step after a 512-token prompt — q
  (112, 1, 128), the cache-native ring (4, 640, 4, 128), kv_len 513 and
  q_offset 512 in every row (5 KV tiles);
- B4p: the serve's busiest decode call in ``chip_smoke.py`` — a pool of
  25 pages of 128 tokens, a (4, 8) page table, kv_len 953, 638, 305 and
  666 per sequence (8, 5, 3 and 6 tiles);
- B2: the B4 call through the onepass kernel;
- B4 at kv_len 1 (one live tile per row): the kernel's fixed cost.

    python3 scripts/bench_decode.py [--src DIR] [--label NAME]

``--src`` is the ``src`` directory whose ``repro_torch`` is timed (this
checkout's by default): run the script on two trees, one after another on
the same card, to compare them (for example a parent unpacked by ``git
archive`` into the git-ignored ``build/``, then this tree, this tree, the
parent). Operands are random from a fixed seed, so two trees see the same
inputs; each row carries a checksum of the int8 output, which two exact
trees share, and whether it equals the plain version. Where the tree's
``kernel.decode_geometry`` picks a cluster, B4 and B4p are also timed
with ``DECODE_MAX_CLUSTER = 1`` (one streaming block per kv row). Needs a
CUDA card; builds the tree's kernels on first use.

Each row, one JSON line: ``ms``, the median over 30 runs of the mean of
10 back-to-back launches of the bound kernel (CUDA events), and
``graph_ms``, the same launches captured in a CUDA graph (device time,
without the host's work per launch). The first line names the card and
its power limit as ``nvidia-smi`` reports them.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import zlib
from pathlib import Path

HQ, HKV, D, B = 28, 4, 128, 4
RING, PAGE, POOL, TABLE = 640, 128, 25, 8
SERVE_KV_LEN = (953, 638, 305, 666)


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
    """``{name: (kernel, args, kwargs)}`` of the three calls."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(18)
    bh, rep = B * HQ, HQ // HKV

    def i8(*shape):
        return torch.randint(-128, 128, shape, generator=g, device="cuda",
                             dtype=torch.int8)
    lm = 0.004 + 0.026 * torch.rand(bh, generator=g, device="cuda")
    om = 0.5 + 1.5 * torch.rand(bh, generator=g, device="cuda")
    q = i8(bh, 1, D)
    k, v = i8(B, RING, HKV, D), i8(B, RING, HKV, D)
    kv_len = torch.full((bh,), 513, dtype=torch.int32, device="cuda")
    one = torch.ones_like(kv_len)
    ring_kw = dict(q_offset=kv_len - 1, causal=True, kv_rep=rep, hq=HQ)
    pool_k, pool_v = i8(POOL, PAGE, HKV, D), i8(POOL, PAGE, HKV, D)
    # each sequence's pages from a permutation of pages 1..24, the rest of
    # its row the parking page 0, as the serve's allocator leaves it
    perm = (torch.randperm(POOL - 1, generator=torch.Generator()
                           .manual_seed(18)) + 1).tolist()
    table = torch.zeros((B, TABLE), dtype=torch.int32)
    for b, n in enumerate(SERVE_KV_LEN):
        used = -(-n // PAGE)
        table[b, :used] = torch.tensor(perm[:used], dtype=torch.int32)
        perm = perm[used:]
    table = table.cuda()
    serve_len = torch.tensor(SERVE_KV_LEN, dtype=torch.int32,
                             device="cuda").repeat_interleave(HQ)
    paged_kw = dict(q_offset=serve_len - 1, causal=True, kv_rep=rep, hq=HQ)
    return {
        "B4 ring decode": ("ita_attention_decode",
                           (q, k, v, lm, om, kv_len), ring_kw),
        "B4p paged decode, busiest serve call": (
            "ita_attention_decode_paged",
            (q, pool_k, pool_v, table, lm, om, serve_len), paged_kw),
        "B2 onepass, decode-shaped": ("ita_attention_onepass",
                                      (q, k, v, lm, om, kv_len), ring_kw),
        "B4 ring decode, kv_len 1 (one tile)": (
            "ita_attention_decode", (q, k, v, lm, om, one),
            dict(ring_kw, q_offset=one - 1)),
    }


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--src", default=str(Path(__file__).resolve()
                                             .parents[1] / "src"))
    parser.add_argument("--label", default="this tree")
    opts = parser.parse_args()
    sys.path.insert(0, str(Path(opts.src).resolve()))
    import torch
    if not torch.cuda.is_available():
        print("bench_decode: CUDA is not available", file=sys.stderr)
        return 2
    from repro_torch.kernels.common import exact_float32_matmul
    from repro_torch.kernels.ita_attention import kernel as K
    exact_float32_matmul()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps({"card": card, "label": opts.label, "src": opts.src}))
    clusters = (None, 1) if hasattr(K, "DECODE_MAX_CLUSTER") else (None,)
    for name, (kernel, args, kw) in calls().items():
        plain = (K.paged_attention_plain if kernel.endswith("_paged")
                 else K.attention_plain)(*args, **kw)
        for cap in clusters if kernel != "ita_attention_onepass" else (None,):
            saved = getattr(K, "DECODE_MAX_CLUSTER", None)
            if cap is not None:
                K.DECODE_MAX_CLUSTER = cap
            try:
                launch, out = K.kernel_launcher(kernel, *args, **kw)
                launch()
                torch.cuda.synchronize()
                row = {"label": opts.label, "call": name,
                       "max_cluster": cap if cap is not None else saved,
                       "ms": events_ms(launch), "graph_ms": graph_ms(launch),
                       "equal_plain": bool(torch.equal(out, plain)),
                       "checksum": zlib.crc32(out.cpu().numpy().tobytes())}
            finally:
                if cap is not None:
                    K.DECODE_MAX_CLUSTER = saved
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
