#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA card and the
CUDA toolkit (``nvcc``). Phases, each fatal on failure:

1. Build the port's CUDA kernels from ``src/repro_torch/kernels/
   ita_attention/csrc``, ``.../ita_softmax/csrc`` and ``.../int8_matmul/
   csrc`` (nvcc, all sources in parallel).
2. Hold each kernel to its plain PyTorch version on the card, bit for bit
   (``torch.equal``), at qwen2-7b shapes (B=4, 28 heads, 4 KV heads,
   head dim 128): decode over a ring of capacity 640 with ragged rows in
   both K/V layouts, causal and windowed, adaptive and paper DI; a
   512-token onepass prefill on the cache-native layout and a multi-tile
   3D case; onepass with kv_len and q_len drawn per head of a kv row
   (3D), decode-shaped onepass calls (sq 1 and 2, both layouts, with and
   without a window) and head dims 64 and 256 (128- and 256-key tiles);
   the decode kernel's block at sq 1, 2, 3 and 8 (7 to 56 packed rows)
   with kv_len drawn per head, many at 1, 128, 129 and the capacity, kv_rep
   1, a ring of 20 tokens, rings of 2304 tokens (runs of 3 tiles per CTA;
   with a window that skips leading tiles), each decode shape both as
   clusters and as one streaming block per kv row; the paged kernels over
   a pool of 128-token pages with permuted, non-contiguous page tables,
   kv_len ending mid-page and, for the paged onepass, q_len 0, 1 and 96
   in one call, the paged decode kernel also over pages of 16 and 64
   tokens and over 18 pages per sequence — each also equal to the ring
   kernel on the gathered pages; the twopass kernels (both
   passes through the wrapper and each alone: out, A and pass 1's
   statistics) in kernel layout on the 512-token causal prefill, a
   window, ragged kv_len tails and Skv 200 padded to 256, paper and
   adaptive DI, and a single-tile call equal to the one-shot paper
   oracle ``ita_attention_ref``. Check that the model's projections
   (``models.layers.linear``) and norm give a row the same bits whatever
   the rows beside it, which serve-equals-solo rests on, and the same
   bits replayed from a CUDA graph as run eagerly, which the captured
   steps rest on.
3. Drive ``generate()`` on full-width qwen2-7b (random bf16 weights from a
   seed, batch 4, prompt 512, 32 tokens), its decode step replayed from a
   CUDA graph (``loop="fused"``, the default; captured at the first call,
   kept for the second): (a) unpinned — chunked prefill, then the decode
   kernel — twice, with identical tokens; (b) with the
   ``ita_onepass_pallas`` pin; (c) with the ``ita_twopass_pallas`` pin
   and the paper DI (``softmax_impl="ita_paper"``) — twopass prefill,
   then the decode kernel — twice, with identical tokens. Each run is
   held token for token against ``loop="stepwise"`` (the step's ops
   eagerly) on the same inputs. The launch counters are zeroed before
   each run and read after it (a replay counts the launches its capture
   saw); the inputs and outputs of layers 0 and 27 of one prefill call
   and one decode step (the first, run eagerly before the capture; run
   (b): also layer 0 of its first decode step, a decode-shaped onepass
   call) are kept and held to the plain versions afterwards. The
   smoke-width config (unpinned and with each pin) checks the card's
   logits against the CPU's plain versions. Profile one unpinned
   ``generate()`` with each loop (device time by kernel, busy share).
4. Drive the standalone softmax (``kernels.ita_softmax.ops.ita_softmax``)
   on layer 0's attention matrix A of run (c) (57,344 rows of 512 int8
   logits, the causal mask, ``block_c`` 128), paper and adaptive, with
   the counters zeroed before and read after; hold it to its plain
   version.
5. Serve an arrival trace with ``serve_continuous(admission="chunked")``
   on full-width qwen2-7b, unpinned: 4 slots, 12 requests (prompts of
   128-1024 tokens, 16-48 generated, arrivals 0-6 steps apart, numpy
   from a seed), 128-token pages, 96-token chunks, 16-step segments and
   24 pages, fewer than the 37 of full provisioning, so admission waits
   on released pages. The launch counters are zeroed before the serve
   and read after it (both paged kernels must have run); the serve's
   mixed and decode steps replay from two CUDA graphs; the allocator
   invariants are checked after every admission round and after the
   serve; each request's tokens must equal ``generate()`` of the request
   alone with the ``ita_onepass_pallas`` pin at the same ``max_len``;
   layer 0's paged calls of the first mixed and the first decode step
   (each step's eager warm-up before its capture) are held to their
   plain versions. Then the trace once more with ``admission="stall"``
   under the ``ita_onepass_pallas`` pin: a ragged prefill of the
   admitted prompts through the ring onepass kernel (28 launches an
   admission round) copied into pool pages, then captured decode steps
   (through the paged onepass kernel, which the pin reaches); every
   request's tokens must equal the chunked serve's, and layer 0's ring
   onepass call of the busiest admission round and its paged onepass
   call of the first decode step are held to their plain versions.
   Then the trace sampled
   (temperature 0.8): its steps run eagerly, so the layer-0 inputs of
   both paged kernels are kept at every step for phase 6; its launches
   and steps must equal the greedy serve's and each request's tokens
   solo ``generate()`` drawing from the request's generator. Then
   profile a serve of the trace's first two requests (device busy
   share, kernels launched).
6. Time each kernel on the main path's inputs with CUDA events (median):
   the bound kernel alone, launched back to back (``ms``) and from a
   CUDA graph (``graph_ms``, device time without the host's work per
   launch), its wrapper call and its plain version, beside its bound;
   the decode kernel also without a cluster (one streaming block per kv
   row: ``streaming_ms``, ``streaming_graph_ms``), and the geometry it
   took (the ring onepass kernel on run (b)'s prefill and on
   its decode-shaped call; the paged kernels on layer-0 inputs of the
   sampled serve: its busiest mixed call and its busiest decode call,
   and the mean per launch over the layer-0 calls of every step; the
   twopass passes on layer 0 of run (c); the softmax on that call's A).
7. ITA's quantized linear layer on qwen2-7b's layer 0: the inputs of
   its seven projections (wq, wk, wv, wo, w_gate, w_up, w_down) in
   run (a)'s prefill (M = 2048 rows) and in the decode step after it
   (M = 4), captured at ``models.layers.linear``; the bf16 weights
   quantized per output channel, the activations per tensor, the q/k/v
   biases in accumulator units and the multipliers s_x·s_w/s_y from
   ``core.quant.quantized_linear`` (s_y calibrated on the exact
   accumulator); ``quantize_tensor`` stores the quantized weights K-major
   (the (K, N) view of an (N, K) buffer, the storage the kernels read).
   ``kernels.int8_matmul.ops.int8_matmul`` runs every projection with
   both schedules (B7a, B7b), the counters zeroed just before and read
   just after: one launch per call of either. Each output must equal its
   plain version, the other schedule, the same call on the row-major
   weight and ``quantized_linear``'s int8 values; so must a random-bias
   case and cases that pad M, K and N (row-major weights). Then each
   shape is timed: each kernel alone on the K-major weight (back-to-back
   launches, the ``ms`` of every kernel; and device time, launches
   captured in a CUDA graph), the wrapper call on the K-major and on the
   row-major weight (which it transposes once per call), the plain
   version, and ``torch._int_mm`` (cuBLASLt, the int32 product only;
   back-to-back and in a CUDA graph) on both layouts as the library
   yardstick.

It prints the card, the kernels' JSON line and, last, ``{"ok": true,
"device": ...}``. Without CUDA, or without the rest of the repository, it
exits non-zero and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

T0 = time.perf_counter()
ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
INT8_OPS_PER_S = 1979e12         # H100 SXM dense int8 tensor-core peak
B, PROMPT, GEN = 4, 512, 32
RING = 640                       # the main path's ring: 512 + 32 aligned
LONG_RING = 2304                 # 18 tiles: more than a cluster's CTAs
STREAMING = "/streaming"         # a decode case run without a cluster
DEV = "cuda"
WIDTH = {}                       # config overrides (none: full width)

SOURCES = {
    "ita_attention_onepass": (
        "src/repro_torch/kernels/ita_attention/csrc/onepass.cu",
        "src/repro/kernels/ita_attention/kernel.py:298"),
    "ita_attention_decode": (
        "src/repro_torch/kernels/ita_attention/csrc/decode.cu",
        "src/repro/kernels/ita_attention/kernel.py:427"),
    "ita_attention_onepass_paged": (
        "src/repro_torch/kernels/ita_attention/csrc/onepass.cu",
        "src/repro/kernels/ita_attention/kernel.py:559"),
    "ita_attention_decode_paged": (
        "src/repro_torch/kernels/ita_attention/csrc/decode.cu",
        "src/repro/kernels/ita_attention/kernel.py:508"),
    "ita_attention_twopass_qk_da": (
        "src/repro_torch/kernels/ita_attention/csrc/twopass.cu",
        "src/repro/kernels/ita_attention/kernel.py:336"),
    "ita_attention_twopass_av_en": (
        "src/repro_torch/kernels/ita_attention/csrc/twopass.cu",
        "src/repro/kernels/ita_attention/kernel.py:368"),
    "ita_softmax": (
        "src/repro_torch/kernels/ita_softmax/csrc/softmax.cu",
        "src/repro/kernels/ita_softmax/kernel.py:74"),
    "int8_matmul": (
        "src/repro_torch/kernels/int8_matmul/csrc/matmul.cu",
        "src/repro/kernels/int8_matmul/kernel.py:89"),
    "int8_matmul_ws": (
        "src/repro_torch/kernels/int8_matmul/csrc/matmul.cu",
        "src/repro/kernels/int8_matmul/kernel.py:113"),
}
PAGED = ("ita_attention_onepass_paged", "ita_attention_decode_paged")
DECODE = ("ita_attention_decode", "ita_attention_decode_paged")
# run (b)'s decode-shaped B2 call (sq 1), kept and timed beside its prefill
ONEPASS_DECODE = "ita_attention_onepass/decode"
MATMUL = {"tpu": "int8_matmul", "weight_stationary": "int8_matmul_ws"}
# phase 7: layer 0's projections (attribute of the block's attn or mlp)
PROJECTIONS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
MLP_PROJECTIONS = ("w_gate", "w_up", "w_down")
QKV_BIAS = {"wq": "bq", "wk": "bk", "wv": "bv"}
TWOPASS = ("ita_attention_twopass_qk_da", "ita_attention_twopass_av_en")
# phase 5: the served trace and the serve's geometry
SERVE = dict(slots=4, requests=12, plen=(128, 1024), gen=(16, 48),
             gap=(0, 6), page_size=128, chunk_size=96, segment=16,
             num_pages=24)


def log(msg):
    print(msg, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def reset_launches():
    """Zero every kernel wrapper's launch counter."""
    from repro_torch.kernels.int8_matmul import kernel as MK
    from repro_torch.kernels.ita_attention import kernel as K
    from repro_torch.kernels.ita_softmax import kernel as SK
    K.reset_launches()
    SK.reset_launches()
    MK.reset_launches()


def read_launches():
    """Every kernel's launches since the last reset, after the stream has
    drained."""
    import torch

    from repro_torch.kernels.int8_matmul import kernel as MK
    from repro_torch.kernels.ita_attention import kernel as K
    from repro_torch.kernels.ita_softmax import kernel as SK
    torch.cuda.synchronize()
    return {**K.LAUNCHES, **SK.LAUNCHES, **MK.LAUNCHES}


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

class Checks:
    """Kernel-vs-plain comparisons: counts and the largest difference."""

    def __init__(self):
        self.n = {name: 0 for name in SOURCES}
        self.max_err = {name: 0.0 for name in SOURCES}

    def compare(self, name, got, want, label):
        import torch
        torch.cuda.synchronize()
        err = (got.double() - want.double()).abs().max().item() \
            if got.numel() else 0
        self.max_err[name] = max(self.max_err[name], float(err))
        self.n[name] += 1
        if not torch.equal(got, want):
            first = (got != want).nonzero()[0].tolist()
            raise AssertionError(
                f"{name} [{label}] differs from its plain version: max |d| "
                f"{err}, first at {first}: kernel {got[tuple(first)].item()} "
                f"plain {want[tuple(first)].item()}")


def kernel_cases(rng_seed=0):
    """(name, args, kwargs, label) at qwen2-7b shapes on the card."""
    import torch
    g = torch.Generator(device=DEV).manual_seed(rng_seed)
    hq, hkv, d = 28, 4, 128
    if WIDTH:
        hq, hkv, d = WIDTH["n_heads"], WIDTH["n_kv_heads"], WIDTH["head_dim"]
    bh, rep = B * hq, hq // hkv

    def i8(*shape):
        return torch.randint(-128, 128, shape, generator=g, device=DEV,
                             dtype=torch.int8)

    def f32(lo, hi, n):
        return lo + (hi - lo) * torch.rand(n, generator=g, device=DEV)

    lm, om = f32(0.004, 0.03, bh), f32(0.5, 2.0, bh)
    kv_b = torch.tensor([RING, PROMPT + 1, RING // 2, 17], device=DEV,
                        dtype=torch.int32)[:B]
    kv_len = kv_b.repeat_interleave(hq)
    cases = []
    for layout in ("4d", "3d"):
        shape = (B, RING, hkv, d) if layout == "4d" else (B * hkv, RING, d)
        k, v = i8(*shape), i8(*shape)
        for sq in (1, 4):
            q = i8(bh, sq, d)
            for window, adaptive in ((0, True), (0, False), (200, True)):
                cases.append(("ita_attention_decode", (q, k, v, lm, om, kv_len),
                              dict(q_offset=kv_len - sq, causal=True,
                                   window=window, adaptive=adaptive,
                                   kv_rep=rep,
                                   hq=hq if layout == "4d" else None),
                              f"decode {layout} sq={sq} window={window} "
                              f"adaptive={adaptive}"))
    # 512-token prefill straight out of the cache-native layout
    q = i8(bh, PROMPT, d)
    k, v = i8(B, RING, hkv, d), i8(B, RING, hkv, d)
    for adaptive in (True, False):
        cases.append(("ita_attention_onepass", (q, k, v, lm, om, PROMPT),
                      dict(causal=True, adaptive=adaptive, kv_rep=rep,
                           hq=hq),
                      f"onepass 4d prefill 512 adaptive={adaptive}"))
    # multi-tile 3D: 5 KV tiles, ragged rows, ragged q_len, a window
    q = i8(bh, 256, d)
    k, v = i8(B * hkv, RING, d), i8(B * hkv, RING, d)
    q_len = torch.randint(1, 257, (bh,), generator=g, device=DEV,
                          dtype=torch.int32)
    for window in (0, 300):
        cases.append(("ita_attention_onepass", (q, k, v, lm, om, kv_len),
                      dict(q_offset=torch.clamp(kv_len - 256, min=0),
                           q_len=q_len, causal=True, window=window,
                           adaptive=True, kv_rep=rep),
                      f"onepass 3d 5 tiles ragged window={window}"))
    # the packed heads of one kv row with their own kv_len and q_len (3D),
    # and decode-shaped onepass calls (sq 1 and 2) in both layouts
    kv_rows = torch.randint(1, RING + 1, (bh,), generator=g, device=DEV,
                            dtype=torch.int32)
    q_len = torch.randint(0, 129, (bh,), generator=g, device=DEV,
                          dtype=torch.int32)
    cases.append(("ita_attention_onepass",
                  (i8(bh, 128, d), k, v, lm, om, kv_rows),
                  dict(q_offset=torch.clamp(kv_rows - q_len, min=0),
                       q_len=q_len, causal=True, adaptive=False, kv_rep=rep),
                  "onepass 3d kv_len and q_len per head"))
    for sq, layout in ((1, "4d"), (2, "3d"), (1, "3d"), (2, "4d")):
        shape = (B, RING, hkv, d) if layout == "4d" else (B * hkv, RING, d)
        kd, vd = i8(*shape), i8(*shape)
        for window in (0, 200):
            cases.append(("ita_attention_onepass",
                          (i8(bh, sq, d), kd, vd, lm, om, kv_len),
                          dict(q_offset=kv_len - sq, causal=True,
                               window=window, adaptive=True, kv_rep=rep,
                               hq=hq if layout == "4d" else None),
                          f"onepass decode-shaped {layout} sq={sq} "
                          f"window={window}"))
    # the decode block's edges: sq 1, 2, 3 and 8 (7 to 56 packed rows),
    # each head of a kv row with its own kv_len, many at 1, 128, 129 and
    # the capacity; as clusters over a kv row's tiles and as one
    # streaming block per kv row ("/streaming": DECODE_MAX_CLUSTER 1)
    k4, v4 = i8(B, RING, hkv, d), i8(B, RING, hkv, d)
    edges = torch.tensor([1, 128, 129, RING], device=DEV, dtype=torch.int32)
    heads = torch.randint(1, RING + 1, (bh,), generator=g, device=DEV,
                          dtype=torch.int32)
    pick = torch.rand(bh, generator=g, device=DEV) < 0.6
    heads = torch.where(pick, edges[torch.randint(
        0, 4, (bh,), generator=g, device=DEV)], heads)
    for sq in (1, 2, 3, 8):
        lens = torch.clamp(heads, min=sq)
        for variant in ("", STREAMING):
            cases.append((
                "ita_attention_decode" + variant,
                (i8(bh, sq, d), k4, v4, lm, om, lens),
                dict(q_offset=lens - sq, causal=True, adaptive=sq != 3,
                     kv_rep=rep, hq=hq),
                f"decode 4d sq={sq} kv_len per head{variant}"))
    # kv_rep 1 (a kv head per q head), a ring of 20 tokens (one tile of
    # 20), and rings of 2304 tokens (18 tiles: runs of 3 per CTA), one
    # with a window that skips the leading tiles
    k1 = i8(B, RING, hq, d)
    cases.append(("ita_attention_decode",
                  (i8(bh, 1, d), k1, i8(B, RING, hq, d), lm, om, kv_len),
                  dict(q_offset=kv_len - 1, causal=True, kv_rep=1, hq=hq),
                  "decode 4d kv_rep 1"))
    short = torch.randint(1, 21, (bh,), generator=g, device=DEV,
                          dtype=torch.int32)
    cases.append(("ita_attention_decode",
                  (i8(bh, 1, d), i8(B * hkv, 20, d), i8(B * hkv, 20, d), lm,
                   om, short),
                  dict(q_offset=short - 1, causal=True, kv_rep=rep),
                  "decode 3d ring of 20 tokens"))
    long = torch.tensor([LONG_RING, 1900, 700, 129], device=DEV,
                        dtype=torch.int32)[:B].repeat_interleave(hq)
    kl, vl = i8(B, LONG_RING, hkv, d), i8(B, LONG_RING, hkv, d)
    for window, variant in ((0, ""), (0, STREAMING), (300, "")):
        cases.append(("ita_attention_decode" + variant,
                      (i8(bh, 1, d), kl, vl, lm, om, long),
                      dict(q_offset=long - 1, causal=True, window=window,
                           kv_rep=rep, hq=hq),
                      f"decode 4d ring {LONG_RING} window={window}"
                      f"{variant}"))
    # head dims 64 and 256 at the model's head counts (256 with 128- and
    # 256-key tiles: two staging stages and one)
    for hd, bkv in ((64, 128), (256, 128), (256, 256)):
        kh, vh = i8(B, 512, hkv, hd), i8(B, 512, hkv, hd)
        cases.append(("ita_attention_onepass",
                      (i8(bh, 192, hd), kh, vh, lm, om, kv_b.clamp(max=512)
                       .repeat_interleave(hq)),
                      dict(q_offset=(kv_b.clamp(max=512) - 192).clamp(min=0)
                           .repeat_interleave(hq), causal=True,
                           adaptive=True, block_kv=bkv, kv_rep=rep, hq=hq),
                      f"onepass 4d d={hd} block_kv={bkv}"))
    return cases


def paged_cases(rng_seed=1):
    """(name, args, kwargs, label) of the paged kernels at qwen2-7b shapes:
    a pool of 128-token pages, permuted page tables with spare pages
    between a row's pages, kv_len ending mid-page, and for the paged
    onepass a prefill chunk, a decode row and an idle row (q_len 96, 1,
    0) in one call."""
    import torch
    g = torch.Generator(device=DEV).manual_seed(rng_seed)
    hq, hkv, d = 28, 4, 128
    if WIDTH:
        hq, hkv, d = WIDTH["n_heads"], WIDTH["n_kv_heads"], WIDTH["head_dim"]
    page, n_pages, chunk = SERVE["page_size"], 9, SERVE["chunk_size"]
    bh, rep, total = B * hq, hq // hkv, B * n_pages + 7
    table = (torch.randperm(total - 1, generator=g, device=DEV)
             [:B * n_pages] + 1).to(torch.int32).view(B, n_pages)

    def i8(*shape):
        return torch.randint(-128, 128, shape, generator=g, device=DEV,
                             dtype=torch.int8)

    def f32(lo, hi, n):
        return lo + (hi - lo) * torch.rand(n, generator=g, device=DEV)

    k, v = i8(total, page, hkv, d), i8(total, page, hkv, d)
    lm, om = f32(0.004, 0.03, bh), f32(0.5, 2.0, bh)

    def rows(*x):
        return torch.tensor(x, device=DEV, dtype=torch.int32)[:B] \
            .repeat_interleave(hq)
    kv_len = rows(1000, 515, chunk, 300)
    q_len = rows(chunk, 1, chunk, 0)
    cases = []
    for window, adaptive in ((0, True), (0, False), (200, True)):
        tail = f"window={window} adaptive={adaptive}"
        common = dict(causal=True, window=window, adaptive=adaptive,
                      kv_rep=rep, hq=hq)
        cases.append(("ita_attention_onepass_paged",
                      (i8(bh, chunk, d), k, v, table, lm, om, kv_len),
                      dict(q_offset=torch.clamp(kv_len - q_len, min=0),
                           q_len=q_len, **common),
                      f"onepass paged q_len 96/1/96/0 {tail}"))
        cases.append(("ita_attention_decode_paged",
                      (i8(bh, 1, d), k, v, table, lm, om, kv_len),
                      dict(q_offset=torch.clamp(kv_len - 1, min=0),
                           **common),
                      f"decode paged {tail}"))
    cases.append(("ita_attention_decode_paged" + STREAMING,
                  (i8(bh, 1, d), k, v, table, lm, om, kv_len),
                  dict(q_offset=torch.clamp(kv_len - 1, min=0), causal=True,
                       kv_rep=rep, hq=hq),
                  f"decode paged{STREAMING}"))
    # pages of 16 and 64 tokens (sq 1 and 2), and a pool of 18 pages of
    # 128 tokens per sequence (runs of 3 tiles per CTA)
    for pg, n_pg, sq, lens in ((16, 40, 1, (600, 515, 96, 1)),
                               (64, 12, 2, (700, 64, 65, 300)),
                               (128, 18, 1, (LONG_RING, 1900, 700, 129))):
        n_tot = B * n_pg + 5
        tab = (torch.randperm(n_tot - 1, generator=g, device=DEV)
               [:B * n_pg] + 1).to(torch.int32).view(B, n_pg)
        kp, vp = i8(n_tot, pg, hkv, d), i8(n_tot, pg, hkv, d)
        lens = rows(*lens)
        for variant in ("", STREAMING):
            cases.append(("ita_attention_decode_paged" + variant,
                          (i8(bh, sq, d), kp, vp, tab, lm, om, lens),
                          dict(q_offset=lens - sq, causal=True, kv_rep=rep,
                               hq=hq),
                          f"decode paged pages of {pg} tokens sq={sq}"
                          f"{variant}"))
    return cases


def twopass_cases(rng_seed=2):
    """(args, kwargs, label) of ``ita_attention_twopass`` at qwen2-7b
    shapes (kernel-layout K/V, GQA 28/4): the 512-token causal prefill,
    a window, ragged kv_len tails with query offsets, and Skv = 200 padded
    to the 256 of two 128-key tiles, as ``fused_attention`` pads it; the
    prefill in 256-key tiles (the largest), 40 queries (280 packed rows a
    kv row, not a multiple of the kernels' 64- or 128-row blocks) on
    ragged rows, head dim 64, and pad rows (one q row sees a single key,
    the next none: A still written, output 0); each paper and adaptive."""
    import torch
    g = torch.Generator(device=DEV).manual_seed(rng_seed)
    hq, hkv, d = 28, 4, 128
    if WIDTH:
        hq, hkv, d = WIDTH["n_heads"], WIDTH["n_kv_heads"], WIDTH["head_dim"]
    bh, rep = B * hq, hq // hkv

    def i8(*shape):
        return torch.randint(-128, 128, shape, generator=g, device=DEV,
                             dtype=torch.int8)

    lm = 0.004 + 0.026 * torch.rand(bh, generator=g, device=DEV)
    om = 0.5 + 1.5 * torch.rand(bh, generator=g, device=DEV)
    kv = torch.tensor([PROMPT, 300, 129, 40], device=DEV,
                      dtype=torch.int32)[:B].repeat_interleave(hq)
    short = torch.tensor([200, 150, 97, 1], device=DEV,
                         dtype=torch.int32)[:B].repeat_interleave(hq)
    inputs = {
        "prefill 512": ((i8(bh, PROMPT, d), i8(B * hkv, PROMPT, d),
                         i8(B * hkv, PROMPT, d), lm, om, PROMPT),
                        dict(causal=True)),
        "window 300": ((i8(bh, 256, d), i8(B * hkv, PROMPT, d),
                        i8(B * hkv, PROMPT, d), lm, om, PROMPT),
                       dict(q_offset=PROMPT - 256, causal=True, window=300)),
        "kv_len tail": ((i8(bh, 64, d), i8(B * hkv, PROMPT, d),
                         i8(B * hkv, PROMPT, d), lm, om, kv),
                        dict(q_offset=torch.clamp(kv - 64, min=0),
                             causal=True)),
        "Skv 200 padded to 256": ((i8(bh, 200, d), i8(B * hkv, 256, d),
                                   i8(B * hkv, 256, d), lm, om, short),
                                  dict(causal=True)),
    }
    prefill = inputs["prefill 512"][0]
    tail = torch.clamp(kv, max=384)
    pad = kv.clone()
    pad[:2] = torch.tensor([1, 0], device=DEV, dtype=torch.int32)
    inputs.update({
        "prefill 512 in 256-key tiles": (prefill,
                                         dict(causal=True, block_kv=256)),
        "40 queries, ragged": ((i8(bh, 40, d), i8(B * hkv, 384, d),
                                i8(B * hkv, 384, d), lm, om, tail),
                               dict(q_offset=torch.clamp(tail - 40, min=0),
                                    causal=True)),
        "head dim 64": ((i8(bh, 96, 64), i8(B * hkv, 256, 64),
                         i8(B * hkv, 256, 64), lm, om, 256),
                        dict(q_offset=160, causal=True)),
        "pad rows": ((i8(bh, 48, d), i8(B * hkv, 256, d),
                      i8(B * hkv, 256, d), lm, om, pad),
                     dict(q_offset=torch.clamp(pad - 48, min=0),
                          causal=True)),
    })
    cases = []
    for label, (args, kw) in inputs.items():
        for adaptive in (False, True):
            cases.append((args, dict(dict(block_kv=128), **kw,
                                     adaptive=adaptive, kv_rep=rep),
                          f"twopass {label} adaptive={adaptive}"))
    return cases


def check_twopass(checks, args, kw, label):
    """Both twopass kernels against their plain versions: out and A through
    the wrapper, then each pass alone on the plain version's inputs (pass
    1's statistics too)."""
    from repro_torch.kernels.ita_attention import kernel as K
    qk, av = TWOPASS
    out, a = K.ita_attention_twopass(*args, **kw)
    want_out, want_a = K.twopass_plain(*args, **kw)
    checks.compare(qk, a, want_a, label + " (A)")
    checks.compare(av, out, want_out, label + " (out)")
    q, k, v, lm, om, kv_len = args
    pass_kw = {n: x for n, x in kw.items() if n != "adaptive"}
    launch, got = K.twopass_qk_launcher(q, k, lm, kv_len,
                                        adaptive=kw["adaptive"], **pass_kw)
    launch()
    want = K.twopass_qk_plain(q, k, lm, kv_len, adaptive=kw["adaptive"],
                              **pass_kw)
    for g_, w_, what in zip(got, want, ("A", "row max", "Σ_inv", "e_r"),
                            strict=True):
        checks.compare(qk, g_, w_, f"{label} pass 1 alone ({what})")
    launch, got = K.twopass_av_launcher(*want, v, om, kv_len, **pass_kw)
    launch()
    checks.compare(av, got, K.twopass_av_plain(*want, v, om, kv_len,
                                               **pass_kw),
                   label + " pass 2 alone")


def check_twopass_oneshot(checks):
    """A single-tile twopass call (MHA, scalar multipliers, 128 queries
    and keys) equals the one-shot paper-EN oracle ``ita_attention_ref``."""
    import torch

    from repro_torch.kernels.ita_attention import kernel as K
    from repro_torch.kernels.ita_attention.ref import ita_attention_ref
    g = torch.Generator(device=DEV).manual_seed(3)
    bh, s, d = B * 28, 128, 128
    q, k, v = (torch.randint(-128, 128, (bh, s, d), generator=g, device=DEV,
                             dtype=torch.int8) for _ in range(3))
    lm = torch.tensor(0.011, device=DEV)
    om = torch.tensor(1.7, device=DEV)
    for adaptive in (False, True):
        out, a = K.ita_attention_twopass(q, k, v, lm, om, s, causal=True,
                                         adaptive=adaptive, block_kv=s)
        ref_out, ref_a = ita_attention_ref(q, k, v, lm, om, s, causal=True,
                                           adaptive=adaptive)
        label = f"twopass single tile vs ita_attention_ref adaptive={adaptive}"
        checks.compare(TWOPASS[0], a, ref_a, label + " (A)")
        checks.compare(TWOPASS[1], out, ref_out, label + " (out)")


def plain_of(name):
    from repro_torch.kernels.ita_attention import kernel as K
    return K.paged_attention_plain if name in PAGED else K.attention_plain


def run_case(name, args, kw):
    """Kernel ``name`` on a case; a ``STREAMING`` suffix runs the decode
    kernel as one streaming block per kv row (no cluster)."""
    from repro_torch.kernels.ita_attention import kernel as K
    name, _, variant = name.partition("/")
    saved = K.DECODE_MAX_CLUSTER
    if variant:
        K.DECODE_MAX_CLUSTER = 1
    try:
        return getattr(K, name)(*args, **kw)
    finally:
        K.DECODE_MAX_CLUSTER = saved


def check_kernels(checks):
    from repro_torch.kernels.ita_attention import kernel as K
    for name, args, kw, label in kernel_cases():
        got = run_case(name, args, kw)
        checks.compare(name.partition("/")[0], got,
                       K.attention_plain(*args, **kw), label)
    for name, args, kw, label in paged_cases():
        got = run_case(name, args, kw)
        name = name.partition("/")[0]
        checks.compare(name, got, K.paged_attention_plain(*args, **kw),
                       label)
        q, k, v, table = args[:4]
        ring = getattr(K, name.removesuffix("_paged"))(
            q, K.gather_pages(k, table), K.gather_pages(v, table),
            *args[4:], block_kv=k.shape[1], **kw)
        checks.compare(name, got, ring, label + " vs the ring kernel")
    for args, kw, label in twopass_cases():
        check_twopass(checks, args, kw, label)
    check_twopass_oneshot(checks)
    log(f"[kernels] bit-exact vs plain at qwen2-7b shapes: {checks.n}")


def check_row_invariance():
    """The projections and the norm give each row the same bits whatever
    rows share the call (``models.layers``: fixed blocks of 128 rows): a
    served request's tokens can equal its solo ``generate()`` only if
    this holds. They also give the same bits replayed from a CUDA graph
    as run eagerly (cuBLAS may pick its kernel and workspace anew under
    capture): the captured steps of ``generate()`` and the serve rest on
    that. Also reports where a plain ``x @ w`` or ``torch.mean`` over
    rows would not be row-invariant."""
    import torch

    from repro_torch.models.layers import linear, rmsnorm
    g = torch.Generator(device=DEV).manual_seed(5)
    counts = (1, 4, 16, 96, 384, 644)
    notes = []

    def same_rows(fn, x, what):
        full = fn(x)
        for m in counts:
            part = fn(x[:m])
            for r in {0, m // 2, m - 1}:
                if not torch.equal(part[r], full[r]):
                    raise AssertionError(f"{what}: row {r} of {m} rows "
                                         f"differs from the same row of "
                                         f"{x.shape[0]}")
        alone = fn(x[200:201])
        if not torch.equal(alone[0], full[200]):
            raise AssertionError(f"{what}: row 200 alone differs")
        for m in (4, 96, 384):
            same_in_graph(fn, x[:m].clone(), f"{what}, {m} rows")

    graphs = []

    def same_in_graph(fn, x, what):
        want = fn(x)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):          # warm up off the capture
            fn(x)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            got = fn(x)
        graph.replay()
        if not torch.equal(got, want):
            raise AssertionError(f"{what}: replayed from a CUDA graph, "
                                 f"{int((got != want).sum())} elements "
                                 f"differ from the eager call")
        graphs.append(what)

    def raw_differs(fn, x):
        """For each row count m, how many of the first m rows differ
        between the m-row call and the row computed alone."""
        alone = [fn(x[r:r + 1])[0] for r in range(max(counts))]
        found = {}
        for m in counts[1:]:
            full = fn(x[:m])
            bad = sum(not torch.equal(full[r], alone[r]) for r in range(m))
            if bad:
                found[m] = bad
        return found or "none"

    for k, n in ((3584, 3584), (3584, 18944), (18944, 3584)):
        x = torch.randn(700, k, generator=g, device=DEV).to(torch.bfloat16)
        w = (torch.randn(k, n, generator=g, device=DEV) * k ** -0.5) \
            .to(torch.bfloat16)
        same_rows(lambda t: linear(t, w), x, f"linear K={k} N={n}")
        notes.append(f"x @ w (K={k}, N={n}) rows differing from the row "
                     f"alone, by row count: {raw_differs(lambda t: t @ w, x)}")
    x = torch.randn(700, 3584, generator=g, device=DEV).to(torch.bfloat16)
    scale = torch.randn(3584, generator=g, device=DEV)
    same_rows(lambda t: rmsnorm(scale, t), x, "rmsnorm")
    xf = x.float() * x.float()
    notes.append(f"torch.mean over rows, rows differing from the row "
                 f"alone, by row count: "
                 f"{raw_differs(lambda t: torch.mean(t, dim=-1), xf)}")
    log(f"[invariance] linear and rmsnorm: every checked row equal among "
        f"{counts} and 700 rows; {len(graphs)} calls replayed from CUDA "
        f"graphs equal to eager (4, 96 and 384 rows); " + "; ".join(notes))


# ---------------------------------------------------------------------------
# Phase 3: full-width generate
# ---------------------------------------------------------------------------

class Recorder:
    """Stands in for a kernel wrapper inside ``ops``: forwards every call
    and keeps the inputs (cloned: the rings change in place later) and the
    output of the calls whose index is in ``keep``. Calls made while a
    CUDA graph is captured are forwarded only: they run nothing then, and
    their replays never reach Python."""

    def __init__(self, fn, keep):
        self.fn, self.keep, self.calls, self.kept = fn, set(keep), 0, {}

    def __call__(self, *args, **kw):
        import torch
        out = self.fn(*args, **kw)
        if torch.cuda.is_current_stream_capturing():
            return out          # a graph's capture runs nothing: no call
        if self.calls in self.keep:

            def clone(x):
                if isinstance(x, tuple):
                    return tuple(clone(y) for y in x)
                return x.clone() if torch.is_tensor(x) else x
            self.kept[self.calls] = ([clone(a) for a in args],
                                     {k: clone(x) for k, x in kw.items()},
                                     clone(out))
        self.calls += 1
        return out


def run_generate(model, cfg, prompts, *, record=None, keep=(),
                 loop="fused"):
    """One ``generate()`` with the launch counters zeroed just before and
    read just after; ``record`` names the ops wrapper to record."""
    from repro_torch.kernels.ita_attention import ops
    from repro_torch.runtime.generate import generate
    rec = None
    if record is not None:
        rec = Recorder(getattr(ops, record), keep)
        setattr(ops, record, rec)
    try:
        reset_launches()
        res = generate(model, cfg, prompts, GEN, loop=loop, device=DEV)
        launches = read_launches()
    finally:
        if rec is not None:
            setattr(ops, record, rec.fn)
    return res, launches, rec


def hold_to_stepwise(model, cfg, prompts, fused, want, label):
    """Run ``label`` once more with ``loop="stepwise"``: its tokens and
    launches must equal the fused run's. Logs both loops' figures."""
    import torch
    step, launches, _ = run_generate(model, cfg, prompts, loop="stepwise")
    if launches != want or not torch.equal(step.tokens, fused.tokens):
        raise AssertionError(f"{label}: loop='stepwise' gave other tokens "
                             f"or launches ({launches}) than the fused loop")
    log(f"[generate] {label} fused vs stepwise, tokens identical: decode "
        f"{fused.decode_tok_s:.1f} vs {step.decode_tok_s:.1f} tok/s, "
        f"prefill {fused.prefill_s:.3f} vs {step.prefill_s:.3f} s, "
        f"capture {fused.capture_s:.3f} s (none stepwise), graph pool "
        f"{fused.graph_bytes / 2**20:.1f} MiB; {card_line()}")
    return step


def log_capture(label, first, kept):
    """The first fused call (which captured the decode step) beside the
    second (which replayed the kept graph)."""
    log(f"[generate] {label} capture: first fused call decode "
        f"{first.decode_s:.3f} s ({first.decode_tok_s:.1f} tok/s) of which "
        f"capture {first.capture_s:.3f} s; graph pool "
        f"{first.graph_bytes / 2**20:.1f} MiB (device memory the capture "
        f"reserved), allocated memory +{first.alloc_bytes / 2**20:.1f} MiB "
        f"from before the copy-in to after the capture (the call's own "
        f"carry, its ring included, is the kept graph's static buffers); "
        f"second call {kept.decode_s:.3f} s "
        f"({kept.decode_tok_s:.1f} tok/s), capture {kept.capture_s:.3f} s")


def smoke_width_reference():
    """The smoke-width config on the card against the CPU's plain versions:
    prefill and two decode steps' logits within 5e-2 (float projections
    round differently on the two devices, which can move an int8 step)."""
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.models import forward, init_caches, init_model
    for backend in ("", "ita_onepass_pallas", "ita_twopass_pallas"):
        cfg = get_config("qwen2-7b", smoke=True, attention_impl="ita",
                         attention_backend=backend)
        tokens = torch.randint(0, cfg.vocab_size, (2, 20),
                               generator=torch.Generator().manual_seed(1))
        logits = {}
        for dev in ("cpu", "cuda"):
            model = init_model(cfg, seed=3, device="cpu").to(dev)
            caches = init_caches(cfg, 2, 24, device=dev)
            with torch.inference_mode():
                lg, caches = forward(model, tokens, cfg, mode="prefill",
                                     caches=caches)
                seq = [lg[:, -1:].float().cpu()]
                tok = torch.argmax(seq[0], -1)
                for step in range(2):
                    lg, caches = forward(model, tok, cfg, mode="decode",
                                         caches=caches,
                                         pos0=torch.full((2,), 20 + step))
                    seq.append(lg.float().cpu())
                    tok = torch.argmax(seq[-1], -1)
            logits[dev] = torch.cat(seq, 1)
        err = (logits["cpu"] - logits["cuda"]).abs().max().item()
        if not (torch.isfinite(logits["cuda"]).all() and err <= 5e-2):
            raise AssertionError(f"smoke-width logits on the card differ "
                                 f"from the CPU's by {err} (pin {backend!r})")
        log(f"[reference] smoke width, pin {backend or 'none'}: card vs CPU "
            f"logits max |d| {err:.3g}")


def full_width_model():
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.models import init_model
    cfg = get_config("qwen2-7b", attention_impl="ita", **WIDTH)
    t0 = time.perf_counter()
    model = init_model(cfg, seed=0, device=DEV)
    torch.cuda.synchronize()
    log(f"[model] {cfg.name} full width: {cfg.n_layers} layers, d="
        f"{cfg.d_model}, weights "
        f"{sum(p.numel() * p.element_size() for p in model.parameters()) / 1e9:.2f}"
        f" GB {cfg.dtype}, init {time.perf_counter() - t0:.1f} s")
    return model, cfg


def prompt_batch(cfg):
    """Run (a)'s prompts: B x PROMPT token ids from seed 0."""
    import torch
    return torch.randint(0, cfg.vocab_size, (B, PROMPT),
                         generator=torch.Generator().manual_seed(0))


def full_width(model, cfg, checks):
    import torch

    from repro_torch.models import forward, init_caches
    n_layers = cfg.n_layers
    prompts = prompt_batch(cfg)

    # (a) unpinned: chunked prefill, then the decode kernel every step
    res_a, la, rec_dec = run_generate(model, cfg, prompts,
                                      record="ita_attention_decode",
                                      keep=(0, n_layers - 1))
    want = dict.fromkeys(SOURCES, 0)
    want["ita_attention_decode"] = n_layers * (GEN - 1)
    if la != want:
        raise AssertionError(f"unpinned launches {la} != {want}")
    res_a2, la2, _ = run_generate(model, cfg, prompts)
    if la2 != want or not torch.equal(res_a.tokens, res_a2.tokens):
        raise AssertionError("a second unpinned run gave other tokens or "
                             "launches")
    log_capture("(a)", res_a, res_a2)
    step_a = hold_to_stepwise(model, cfg, prompts, res_a2, want, "(a)")
    # (b) pinned onepass: prefill and every decode step through onepass
    cfg_b = dataclasses.replace(cfg, attention_backend="ita_onepass_pallas")
    # calls 0 and n_layers - 1 are prefill, n_layers the first decode step
    res_b, lb, rec_one = run_generate(model, cfg_b, prompts,
                                      record="ita_attention_onepass",
                                      keep=(0, n_layers - 1, n_layers))
    want_b = dict.fromkeys(SOURCES, 0)
    want_b["ita_attention_onepass"] = n_layers * GEN
    if lb != want_b:
        raise AssertionError(f"pinned launches {lb} != {want_b}")
    step_b = hold_to_stepwise(model, cfg_b, prompts, res_b, want_b, "(b)")
    for res in (res_a, res_b):
        tok = res.tokens
        if tok.shape != (B, GEN) or tok.min() < 0 \
                or tok.max() >= cfg.vocab_size:
            raise AssertionError(f"bad tokens {tuple(tok.shape)}")
    with torch.inference_mode():
        logits, _ = forward(model, prompts[:1, :64].to(DEV), cfg,
                            mode="prefill",
                            caches=init_caches(cfg, 1, 64, device=DEV))
    if not torch.isfinite(logits).all():
        raise AssertionError("non-finite prefill logits at full width")
    log(f"[generate] (a) unpinned launches {la}; prefill "
        f"{res_a2.prefill_s:.3f} s, decode {res_a2.decode_tok_s:.1f} tok/s "
        f"({res_a2.n_decode_tokens} tokens in {res_a2.decode_s:.3f} s)")
    log(f"[generate] (b) onepass-pinned launches {lb}; prefill "
        f"{res_b.prefill_s:.3f} s, decode {res_b.decode_tok_s:.1f} tok/s")
    log(f"[generate] tokens (a) {res_a.tokens[0, :8].tolist()} "
        f"(b) {res_b.tokens[0, :8].tolist()}; (a) and (b) agree on "
        f"{(res_a.tokens == res_b.tokens).float().mean().item():.3f} of "
        f"tokens")
    # (c) the paper's dataflow: twopass prefill with the paper DI, then
    # the ring decode kernel (twopass serves prefill only)
    cfg_c = dataclasses.replace(cfg, attention_backend="ita_twopass_pallas",
                                softmax_impl="ita_paper")
    res_c, lc, rec_two = run_generate(model, cfg_c, prompts,
                                      record="ita_attention_twopass",
                                      keep=(0, n_layers - 1))
    want_c = dict.fromkeys(SOURCES, 0)
    want_c.update({TWOPASS[0]: n_layers, TWOPASS[1]: n_layers,
                   "ita_attention_decode": n_layers * (GEN - 1)})
    if lc != want_c:
        raise AssertionError(f"twopass-pinned launches {lc} != {want_c}")
    res_c2, lc2, _ = run_generate(model, cfg_c, prompts)
    if lc2 != want_c or not torch.equal(res_c.tokens, res_c2.tokens):
        raise AssertionError("a second twopass-pinned run gave other tokens "
                             "or launches")
    log_capture("(c)", res_c, res_c2)
    step_c = hold_to_stepwise(model, cfg_c, prompts, res_c2, want_c, "(c)")
    tok = res_c.tokens
    if tok.shape != (B, GEN) or tok.min() < 0 or tok.max() >= cfg.vocab_size:
        raise AssertionError(f"bad tokens {tuple(tok.shape)}")
    log(f"[generate] (c) twopass-pinned, paper DI: launches {lc}; prefill "
        f"{res_c2.prefill_s:.3f} s, decode {res_c2.decode_tok_s:.1f} tok/s "
        f"(first call: prefill {res_c.prefill_s:.3f} s); tokens "
        f"{tok[0, :8].tolist()}; agree with (b) on "
        f"{(tok == res_b.tokens).float().mean().item():.3f} of tokens "
        f"(information: twopass/paper and onepass/adaptive are different "
        f"exactness families)")

    from repro_torch.kernels.ita_attention import kernel as K
    captured = {}
    for name, rec, what in (("ita_attention_decode", rec_dec, "decode step"),
                            ("ita_attention_onepass", rec_one, "(b)")):
        for idx, (args, kw, out) in sorted(rec.kept.items()):
            checks.compare(name, out, K.attention_plain(*args, **kw),
                           f"main path {what}, call {idx} (sq "
                           f"{args[0].shape[1]})")
        captured[name] = rec.kept[0]
    captured[ONEPASS_DECODE] = rec_one.kept[n_layers]
    for idx, (args, kw, (out, a)) in sorted(rec_two.kept.items()):
        want_out, want_a = K.twopass_plain(*args, **kw)
        checks.compare(TWOPASS[0], a, want_a,
                       f"main path (c) prefill, layer {idx} (A)")
        checks.compare(TWOPASS[1], out, want_out,
                       f"main path (c) prefill, layer {idx} (out)")
    captured["twopass"] = rec_two.kept[0]
    log(f"[generate] main-path inputs of layers 0 and {n_layers - 1} "
        f"bit-exact vs plain (runs (a), (b), (c); (b) also layer 0 of its "
        f"first decode step)")
    profile_generate(model, cfg, prompts)
    return {"prefill_s": res_a2.prefill_s, "decode_tok_s":
            res_a2.decode_tok_s, "pinned_prefill_s": res_b.prefill_s,
            "pinned_decode_tok_s": res_b.decode_tok_s,
            "twopass_prefill_s": res_c2.prefill_s,
            "twopass_decode_tok_s": res_c2.decode_tok_s,
            "stepwise_decode_tok_s": (step_a.decode_tok_s,
                                      step_b.decode_tok_s,
                                      step_c.decode_tok_s),
            "capture_s": res_a.capture_s,
            "launches": {"ita_attention_decode": la["ita_attention_decode"],
                         "ita_attention_onepass":
                             lb["ita_attention_onepass"],
                         # one prefill call per layer, the rest decode
                         ONEPASS_DECODE:
                             lb["ita_attention_onepass"] - n_layers,
                         TWOPASS[0]: lc[TWOPASS[0]],
                         TWOPASS[1]: lc[TWOPASS[1]]}}, captured


# ---------------------------------------------------------------------------
# Phase 4: the standalone softmax on the full-width attention matrix
# ---------------------------------------------------------------------------

def full_width_softmax(a, checks):
    """B6 through its entry point (``ops.ita_softmax``) on layer 0's A of
    run (c): BH·Sq rows of Skv int8 logits, the causal mask as int8,
    ``block_c`` 128, paper and adaptive DI. The launch counters are zeroed
    just before and read just after; each output is held to the plain
    version and must be finite probabilities (rows sum to at most 1)."""
    import torch

    from repro_torch.kernels.ita_softmax import kernel as SK
    from repro_torch.kernels.ita_softmax.ops import ita_softmax
    bh, sq, skv = a.shape
    x = a.reshape(bh * sq, skv)
    mask = torch.ones(sq, skv, dtype=torch.int8, device=DEV).tril() \
        .repeat(bh, 1)
    reset_launches()
    outs = {ad: ita_softmax(x, mask, block_c=128, adaptive=ad)
            for ad in (False, True)}
    launches = read_launches()
    want = dict.fromkeys(SOURCES, 0)
    want["ita_softmax"] = 2
    if launches != want:
        raise AssertionError(f"softmax launches {launches} != {want}")
    for ad, out in outs.items():
        checks.compare("ita_softmax", out,
                       SK.softmax_plain(x, mask, block_c=128, adaptive=ad),
                       f"layer 0 A of (c), {tuple(x.shape)}, adaptive={ad}")
        rows = out.double().sum(-1)
        if out.shape != x.shape or not torch.isfinite(out).all() \
                or rows.max() > 1.0 or (out * (mask == 0)).any():
            raise AssertionError(f"softmax adaptive={ad}: not probabilities")
    log(f"[softmax] B6 on layer 0's A ({tuple(x.shape)} int8, causal mask, "
        f"block_c 128): launches {launches['ita_softmax']}, bit-exact vs "
        f"plain, paper and adaptive")
    return (x, mask), launches["ita_softmax"]


# ---------------------------------------------------------------------------
# Phase 5: full-width continuous-batching serve
# ---------------------------------------------------------------------------

def serve_trace(cfg, seed=7):
    """The served trace: numpy from ``seed``."""
    import numpy as np

    from repro_torch.runtime.generate import ServeRequest
    rng = np.random.default_rng(seed)
    reqs, t = [], 0
    for _ in range(SERVE["requests"]):
        plen = int(rng.integers(SERVE["plen"][0], SERVE["plen"][1] + 1))
        reqs.append(ServeRequest(
            prompt=rng.integers(0, cfg.vocab_size, plen).astype(np.int32),
            gen=int(rng.integers(SERVE["gen"][0], SERVE["gen"][1] + 1)),
            arrival=t))
        t += int(rng.integers(SERVE["gap"][0], SERVE["gap"][1] + 1))
    return reqs


def busiest(rec, kv_arg=6):
    """The kept call with the most KV work (the largest summed kv_len,
    argument ``kv_arg``: 6 of a paged call, 5 of a ring call)."""
    import torch

    def work(item):
        return int(torch.as_tensor(item[1][0][kv_arg]).sum().item())
    return max(rec.kept.items(), key=work)


def recording(names, keep):
    """``Recorder``s put in place of the ops wrappers ``names``."""
    from repro_torch.kernels.ita_attention import ops
    recs = {name: Recorder(getattr(ops, name), keep) for name in names}
    for name, rec in recs.items():
        setattr(ops, name, rec)
    return recs


def unrecord(recs):
    from repro_torch.kernels.ita_attention import ops
    for name, rec in recs.items():
        setattr(ops, name, rec.fn)


def check_recorded(checks, name, rec, idx, what):
    """Kept call ``idx`` of ``rec`` against its plain version."""
    args, kw, out = rec.kept[idx]
    checks.compare(name, out, plain_of(name)(*args, **kw), what)


def full_width_serve(model, cfg, checks):
    import numpy as np
    import torch

    from repro_torch.kernels.ita_attention import kernel as K
    from repro_torch.runtime.generate import generate, serve_continuous
    reqs = serve_trace(cfg)
    n_layers = cfg.n_layers
    # the steps run eagerly only at their warm-up: call 0 of B3 is layer 0
    # of the first mixed step, call 0 of B4p of the first decode step
    warm = recording(PAGED, keep=(0,))
    try:
        reset_launches()
        res = serve_continuous(
            model, cfg, reqs, slots=SERVE["slots"],
            segment=SERVE["segment"], page_size=SERVE["page_size"],
            num_pages=SERVE["num_pages"], chunk_size=SERVE["chunk_size"],
            debug_invariants=True, device=DEV)
        launches = read_launches()
    finally:
        unrecord(warm)
    if any(launches[name] <= 0 for name in PAGED):
        raise AssertionError(f"a paged kernel did not run in the serve: "
                             f"{launches}")
    if len(res.completed) != len(reqs):
        raise AssertionError(f"{len(res.completed)} of {len(reqs)} "
                             f"requests completed")
    peak = max(u for _, u in res.page_util)
    log(f"[serve] {len(reqs)} requests (prompts "
        f"{min(r.prompt.size for r in reqs)}-"
        f"{max(r.prompt.size for r in reqs)}, gen "
        f"{min(r.gen for r in reqs)}-{max(r.gen for r in reqs)}, last "
        f"arrival step {reqs[-1].arrival}), {SERVE['slots']} slots, "
        f"{SERVE['num_pages']} pages: {res.steps} steps, {res.segments} "
        f"segments, {res.admission_rounds} admission rounds, peak page "
        f"reservation {peak:.0%}; allocator invariants held in all "
        f"{n_layers} layers after every round and after the serve")
    log(f"[serve] launches {launches}")
    log(f"[serve] {res.total_tokens} tokens in {res.wall_s:.3f} s: "
        f"sustained {res.tok_s:.2f} tok/s; TTFT p50 "
        f"{res.ttft_quantile(0.5):.3f} s p90 {res.ttft_quantile(0.9):.3f} "
        f"s; latency p50 {res.latency_quantile(0.5):.3f} s; mixed and "
        f"decode steps captured in {res.capture_s:.3f} s, graph pools "
        f"{res.graph_bytes / 2**20:.1f} MiB reserved, allocated memory "
        f"+{res.alloc_bytes / 2**20:.1f} MiB from before the first copy-in "
        f"to after each capture (the carry, KV pools included, is the "
        f"graphs' static buffers); {card_line()}")
    for name, what in zip(PAGED, ("mixed", "decode"), strict=True):
        check_recorded(checks, name, warm[name], 0,
                       f"chunked serve, layer 0 of the first {what} step "
                       f"(its eager warm-up)")
    log("[serve] the chunked serve's own layer-0 paged calls of its first "
        "mixed step (B3) and first decode step (B4p), run eagerly before "
        "their capture, bit-exact vs plain")

    # each request alone, through the onepass pin, at the serve's max_len
    cfg_pin = dataclasses.replace(cfg, attention_backend="ita_onepass_pallas")
    max_len = max(r.prompt.size + r.gen for r in reqs)
    for c in sorted(res.completed, key=lambda c: c.index):
        r = reqs[c.index]
        solo = generate(model, cfg_pin, torch.as_tensor(r.prompt)[None],
                        r.gen, max_len=max_len, device=DEV)
        want = solo.tokens[0].cpu().numpy()
        if not np.array_equal(c.tokens, want):
            first = int(np.flatnonzero(c.tokens != want)[0])
            raise AssertionError(
                f"request {c.index} (prompt {r.prompt.size}, gen {r.gen}): "
                f"served tokens differ from solo generate() at {first}: "
                f"{c.tokens[first]} vs {want[first]}")
    log(f"[serve] every request's tokens equal solo generate() "
        f"(ita_onepass_pallas pin, max_len {max_len})")
    stall = stall_serve(model, cfg_pin, reqs, res, checks)
    recs = sampled_serve(model, cfg, reqs, res, launches, max_len)

    captured = {}
    for name, rec in recs.items():
        idx, (args, kw, out) = busiest(rec)
        checks.compare(name, out, K.paged_attention_plain(*args, **kw),
                       f"sampled serve, layer 0 of step {idx // n_layers}")
        captured[name] = (args, kw, out)
    log("[serve] the sampled serve's busiest layer-0 paged calls bit-exact "
        "vs plain")
    mean = {name: mean_kernel_ms(name, rec) for name, rec in recs.items()}
    served_mean = {name: ms for name, (ms, _) in mean.items()}
    for name, (ms, n) in mean.items():
        log(f"[timing] {name} over the sampled serve: mean {ms:.5f} ms per "
            f"launch over the layer-0 calls of all {n} steps that launched "
            f"it (5 launches each); {card_line()}")
    profile_serve(model, cfg, reqs)
    return {"tok_s": res.tok_s, "wall_s": res.wall_s,
            "ttft_p50": res.ttft_quantile(0.5),
            "ttft_p90": res.ttft_quantile(0.9),
            "mean_ms": served_mean, "stall": stall}, launches, captured


def sampled_serve(model, cfg, reqs, greedy, launches, max_len):
    """The trace once more, sampled (temperature 0.8, seed 11). A sampled
    step reads its emitting rows back to draw from their generators, so
    its steps run eagerly and Python sees every kernel call: this serve's
    layer-0 paged calls are kept for phase 6 (the busiest call and the
    mean over every step). Without EOS its schedule (admissions, chunks,
    kv lengths) is the greedy serve's, so its kernels get the same work
    and launches. Each request's tokens must equal solo ``generate()``
    (onepass pin, fused loop) drawing from the request's generator."""
    import numpy as np
    import torch

    from repro_torch.launch.steps import request_generator
    from repro_torch.runtime.generate import generate, serve_continuous
    n_layers = cfg.n_layers
    keep = range(0, n_layers * 512, n_layers)          # layer 0 of a step
    recs = recording(PAGED, keep)
    try:
        reset_launches()
        res = serve_continuous(
            model, cfg, reqs, slots=SERVE["slots"],
            segment=SERVE["segment"], page_size=SERVE["page_size"],
            num_pages=SERVE["num_pages"], chunk_size=SERVE["chunk_size"],
            temperature=0.8, seed=11, device=DEV)
        sampled = read_launches()
    finally:
        unrecord(recs)
    if sampled != launches or res.steps != greedy.steps \
            or len(res.completed) != len(reqs):
        raise AssertionError(f"sampled serve: {res.steps} steps, launches "
                             f"{sampled}, not the greedy serve's")
    cfg_pin = dataclasses.replace(cfg, attention_backend="ita_onepass_pallas")
    for c in res.completed:
        r = reqs[c.index]
        solo = generate(model, cfg_pin, torch.as_tensor(r.prompt)[None],
                        r.gen, max_len=max_len, temperature=0.8,
                        generator=request_generator(11, c.index, DEV),
                        device=DEV).tokens[0].cpu().numpy()
        if not np.array_equal(c.tokens, solo):
            raise AssertionError(f"sampled serve: request {c.index}'s "
                                 f"tokens differ from solo generate()")
    log(f"[serve] sampled (temperature 0.8, seed 11; steps eager): every "
        f"request's tokens equal solo generate() drawing from its "
        f"generator (fused loop, its graph registered with it); launches "
        f"and {res.steps} steps equal the greedy serve's; {res.total_tokens}"
        f" tokens in {res.wall_s:.3f} s: sustained {res.tok_s:.2f} tok/s; "
        f"{card_line()}")
    return recs


def stall_serve(model, cfg_pin, reqs, chunked, checks):
    """The trace once more with ``admission="stall"`` under the onepass
    pin: each admission round's ragged prefill runs the ring onepass
    kernel (B2) once a layer, and the pin takes the decode steps to the
    paged onepass kernel (B3) at one query a row; every request's tokens
    must equal the chunked serve's (which equal solo ``generate()``).
    Layer 0's B2 call of the busiest round (every round runs eagerly) and
    layer 0's B3 call of the first decode step (its eager warm-up) are
    held against their plain versions."""
    import numpy as np
    import torch

    from repro_torch.runtime.generate import serve_continuous
    n_layers = cfg_pin.n_layers
    recs = recording(("ita_attention_onepass",),
                     keep=range(0, n_layers * 64, n_layers))
    recs.update(recording(("ita_attention_onepass_paged",), keep=(0,)))
    try:
        reset_launches()
        res = serve_continuous(
            model, cfg_pin, reqs, slots=SERVE["slots"],
            segment=SERVE["segment"], page_size=SERVE["page_size"],
            num_pages=SERVE["num_pages"], admission="stall",
            debug_invariants=True, device=DEV)
        launches = read_launches()
    finally:
        unrecord(recs)
    if len(res.completed) != len(reqs):
        raise AssertionError(f"stall serve: {len(res.completed)} of "
                             f"{len(reqs)} requests completed")
    if launches["ita_attention_onepass"] != n_layers * res.admission_rounds \
            or res.prefill_stall_s <= 0:
        raise AssertionError(f"stall serve: {launches} over "
                             f"{res.admission_rounds} admission rounds, "
                             f"stall {res.prefill_stall_s} s")
    want = {c.index: c.tokens for c in chunked.completed}
    for c in res.completed:
        if not np.array_equal(c.tokens, want[c.index]):
            raise AssertionError(f"stall serve: request {c.index}'s tokens "
                                 f"differ from the chunked serve's")
    idx, (args, _, _) = busiest(recs["ita_attention_onepass"], kv_arg=5)
    check_recorded(checks, "ita_attention_onepass",
                   recs["ita_attention_onepass"], idx,
                   f"stall serve, layer 0 of admission round "
                   f"{idx // n_layers} (sq {args[0].shape[1]})")
    check_recorded(checks, "ita_attention_onepass_paged",
                   recs["ita_attention_onepass_paged"], 0,
                   "stall serve, layer 0 of the first decode step (its "
                   "eager warm-up)")
    log(f"[serve] stall serve: layer 0's B2 call of its busiest admission "
        f"round ({idx // n_layers}, q {tuple(args[0].shape)}, summed kv_len "
        f"{int(torch.as_tensor(args[5]).sum())}) and layer 0's B3 call of "
        f"its first decode step bit-exact vs plain")
    paged = {name: launches[name] for name in PAGED}
    log(f"[serve] stall admission (ita_onepass_pallas pin): every "
        f"request's tokens equal the chunked serve's; {res.steps} steps, "
        f"{res.segments} segments, {res.admission_rounds} admission rounds; "
        f"B2 (ring onepass) {launches['ita_attention_onepass']} launches "
        f"({n_layers} a round), paged {paged} (the pin reaches the paged "
        f"decode spec, so decode steps run the paged onepass kernel); "
        f"prefill_stall_s {res.prefill_stall_s:.3f} s; {res.total_tokens} "
        f"tokens in {res.wall_s:.3f} s: sustained {res.tok_s:.2f} tok/s; "
        f"TTFT p50 {res.ttft_quantile(0.5):.3f} s p90 "
        f"{res.ttft_quantile(0.9):.3f} s; capture {res.capture_s:.3f} s, "
        f"graph pool {res.graph_bytes / 2**20:.1f} MiB, allocated "
        f"+{res.alloc_bytes / 2**20:.1f} MiB; "
        f"{card_line()}")
    return {"tok_s": res.tok_s, "wall_s": res.wall_s,
            "ttft_p50": res.ttft_quantile(0.5),
            "ttft_p90": res.ttft_quantile(0.9),
            "prefill_stall_s": res.prefill_stall_s, "launches": launches}


# ---------------------------------------------------------------------------
# Phase 6: timings and bounds
# ---------------------------------------------------------------------------

def median_ms(fn, reps=30, warmup=3):
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def mean_kernel_ms(name, rec, inner=5):
    """Mean time per launch of kernel ``name`` over every call ``rec``
    kept (CUDA events around ``inner`` back-to-back launches of each bound
    call, after one warm-up launch). Returns ``(ms, calls)``."""
    import torch

    from repro_torch.kernels.ita_attention import kernel as K
    total, calls = 0.0, 0
    for args, kw, _ in rec.kept.values():
        launch, out = K.kernel_launcher(name, *args, **kw)
        launch()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            launch()
        b.record()
        b.synchronize()
        total += a.elapsed_time(b) / inner
        calls += 1
    return total / max(calls, 1), calls


def roofline(nbytes, ops):
    """The least time for ``nbytes`` moved and ``ops`` integer operations
    on this card: ``(ms, "bytes" or "operations")``."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / INT8_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def visible_work(args, kw):
    """``(pairs, kv_tokens, meta)`` of a ring call: the visible (query,
    key) pairs and the K/V tokens the rows' masks reach (per kv row, the
    largest visible key + 1)."""
    import torch

    from repro_torch.kernels.common import tile_mask
    from repro_torch.kernels.ita_attention import kernel as K
    q, k = args[:2]
    bh, sq, _ = q.shape
    _, _, meta = K.row_operands(*args[:6], kw.get("q_offset", 0),
                                kw.get("q_len"), kw.get("kv_rep", 1),
                                kw.get("hq"))
    skv = k.shape[1]
    col = [meta[:, i].view(bh, 1, 1) for i in range(3)]
    valid = tile_mask(0, 0, sq, skv, kw.get("causal", True),
                      kw.get("window", 0), kv_len=col[0], q_offset=col[1],
                      q_len=col[2], device=q.device)
    reach = torch.where(valid.any(1), torch.arange(skv, device=q.device),
                        -1).amax(1) + 1                      # (bh,)
    rep = kw.get("kv_rep", 1)
    kv_tokens = int(reach.view(-1, rep).amax(1).sum().item())
    return int(valid.sum().item()), kv_tokens, meta


def bound_ms(name, args, kw):
    """The least time for a ring or paged call's work on this card: each
    input read once (only the K/V prefix the rows' masks can reach; for a
    paged call also its page table), the output written once, against the
    integer ops of the visible (query, key) pairs (Q·Kᵀ and u·V: 4 ops
    per pair and head-dim element)."""
    from repro_torch.kernels.ita_attention import kernel as K
    table_bytes = 0
    if name in PAGED:          # the same work as the ring of its pages
        q, k, v, table = args[:4]
        table_bytes = table.numel() * 4
        args = (q, K.gather_pages(k, table), K.gather_pages(v, table)) \
            + tuple(args[4:])
    q = args[0]
    bh, _, d = q.shape
    pairs, kv_tokens, meta = visible_work(args, kw)
    nbytes = q.numel() * 2 + 2 * kv_tokens * d + meta.numel() * 4 + bh * 8 \
        + table_bytes
    return roofline(nbytes, 4 * pairs * d)


def twopass_bounds(args, kw):
    """Least times of the two passes of a twopass call. Pass 1 reads Q and
    all of K (A holds the logit of every pair, masked ones included), the
    multipliers and meta, and writes all of A and three int32 statistics
    per query row; its ops are Q·Kᵀ at every pair (2 per head-dim
    element). Pass 2 reads A only at the visible pairs (p is 0 elsewhere,
    whatever A holds), the statistics, the V prefix the masks reach, the
    multipliers and meta, and writes out; its ops are p·V at the visible
    pairs (2 per pair and head-dim element)."""
    q, k = args[:2]
    bh, sq, d = q.shape
    skv = k.shape[1]
    pairs, kv_tokens, meta = visible_work(args, kw)
    stats, small = 3 * bh * sq * 4, meta.numel() * 4 + bh * 4
    return (roofline(q.numel() + k.numel() + bh * sq * skv + stats + small,
                     2 * bh * sq * skv * d),
            roofline(pairs + stats + kv_tokens * d + small + bh * sq * d,
                     2 * pairs * d))


def softmax_bound(x, mask):
    """Least time of a standalone softmax call: x read only where the mask
    is set (a masked element's output is 0 whatever x holds), the mask
    read and the f32 output written at every element; ~10 integer ops
    (DA and EN) per unmasked element."""
    live = int((mask != 0).sum().item())
    return roofline(live + mask.numel() + x.numel() * 4, 10 * live)


def profile_run(label, fn):
    """Device time by kernel over one call of ``fn`` (``torch.profiler``,
    device activity only: host op records would cost more than the run),
    the device's busy share of its wall time (the profiler's own host
    cost inflates the wall time) and the kernels launched. Returns what
    ``fn`` returned."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    n = sum(e.count for e in kernels)
    log(f"[profile] {label}: wall {wall_ms:.1f} ms, device busy "
        f"{busy_ms:.1f} ms ({busy_ms / wall_ms:.1%}), {n} kernel launches; "
        f"top kernels by device time:")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
        log(f"[profile]   {e.self_device_time_total / 1e3:9.2f} ms "
            f"{e.count:6d} x  {e.key[:90]}")
    for kernel in ("onepass_kernel", "decode_kernel"):
        found = [e for e in kernels if kernel in e.key]
        ms = sum(e.self_device_time_total for e in found) / 1e3
        n = sum(e.count for e in found)
        if n:
            log(f"[profile] {label}: {kernel} {ms:.2f} ms over {n} "
                f"launches ({ms / n:.5f} ms each), {ms / busy_ms:.1%} of "
                f"device time")
    return out


def profile_generate(model, cfg, prompts):
    """Run (a) under the profiler with each loop: the decode step replayed
    from its kept graph, then its ops eagerly."""
    from repro_torch.runtime.generate import generate
    for loop, how in (("fused", "decode step replayed from its kept graph"),
                      ("stepwise", "decode step's ops eagerly")):
        profile_run(f"generate (a), {how}", lambda loop=loop: generate(
            model, cfg, prompts, GEN, loop=loop, device=DEV))


def profile_serve(model, cfg, reqs):
    """The serve's first two requests under the profiler."""
    from repro_torch.runtime.generate import serve_continuous
    res = profile_run(
        "serve of requests 0-1, steps replayed from CUDA graphs",
        lambda: serve_continuous(
            model, cfg, reqs[:2], slots=SERVE["slots"],
            segment=SERVE["segment"], page_size=SERVE["page_size"],
            num_pages=SERVE["num_pages"], chunk_size=SERVE["chunk_size"],
            device=DEV))
    log(f"[profile] serve of requests 0-1: {res.steps} steps, "
        f"{res.segments} segments, {res.total_tokens} tokens")


def kernel_ms(bind, reps=30, inner=10):
    """Median over ``reps`` of the mean time of ``inner`` back-to-back
    launches of a bound kernel (CUDA events): the kernel alone, without
    its wrapper's host work. ``bind()`` returns ``(launch, out)``."""
    import torch
    launch, out = bind()        # out stays alive while launch writes it
    for _ in range(3):
        launch()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            launch()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


def graph_ms(bind, reps=20, inner=10):
    """Device time of one launch of a bound call: ``inner`` launches
    captured in a CUDA graph, the median over ``reps`` replays (CUDA
    events) divided by ``inner``. Unlike ``kernel_ms`` it leaves out the
    host's work per launch, which paces back-to-back launches of calls
    shorter than a few tens of µs. ``bind()`` returns ``(launch, out)``."""
    import torch
    launch, out = bind()        # out stays alive while launch writes it
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):          # warm up off the capture
        for _ in range(3):
            launch()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            launch()
    graph.replay()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


def call_meta(name, args, kw):
    """The per-batch-row kv_len and q_offset of a ring or paged call (and
    a paged call's page table shape; a decode call's geometry), for the
    timing log."""
    import torch

    from repro_torch.kernels.common import sm_count
    from repro_torch.kernels.ita_attention import kernel as K
    hq = kw.get("hq") or kw.get("kv_rep", 1)
    kv_len = args[6 if name in PAGED else 5]

    def per_row(x):
        x = torch.as_tensor(x).reshape(-1)
        return x[::hq].tolist() if x.numel() > 1 else x.tolist()
    table = f" table{tuple(args[3].shape)}" if name in PAGED else ""
    geometry = ""
    if name in DECODE:
        bh, sq, d = args[0].shape
        if name in PAGED:
            bkv, n_tiles = args[1].shape[1], args[3].shape[1]
        else:
            bkv = min(kw.get("block_kv", 128), args[1].shape[1])
            n_tiles = args[1].shape[1] // bkv
        geo = K.decode_geometry(bh, sq, d, bkv, kw.get("kv_rep", 1),
                                sm_count(args[0].device), n_tiles,
                                max_cluster=K.DECODE_MAX_CLUSTER)
        geometry = (f"; clusters of {geo['cluster']} CTAs, "
                    f"{geo['stages']} stage(s), {geo['grid']} CTAs")
    return (f"{table} kv_len per batch row {per_row(kv_len)} q_offset "
            f"{per_row(kw.get('q_offset', 0))}{geometry}")


def timing_entries(captured, softmax_inputs):
    """``(name, shape, bind, call, plain, (bound_ms, bound_by))`` of every
    kernel on the main path's inputs: the ring kernels on layer 0 of
    ``generate()``, the paged ones on layer 0 of the serve, the twopass
    passes on layer 0 of run (c), the softmax on that call's A."""
    from repro_torch.kernels.ita_attention import kernel as K
    from repro_torch.kernels.ita_softmax import kernel as SK
    from repro_torch.kernels.ita_softmax.ops import ita_softmax
    entries = []
    for name, (args, kw, _) in captured.items():
        if name == "twopass":
            continue
        kname = name.split("/")[0]
        fn, plain_fn = getattr(K, kname), plain_of(kname)
        entries.append((
            name, f"q{tuple(args[0].shape)} k{tuple(args[1].shape)}"
            + call_meta(kname, args, kw),
            lambda name=kname, args=args, kw=kw: K.kernel_launcher(
                name, *args, **kw),
            lambda fn=fn, args=args, kw=kw: fn(*args, **kw),
            lambda f=plain_fn, args=args, kw=kw: f(*args, **kw),
            bound_ms(kname, args, kw)))
    args, kw, _ = captured["twopass"]
    q, k, v, lm, om, kv_len = args
    pass_kw = {n: x for n, x in kw.items() if n != "adaptive"}
    stats = K.twopass_qk_plain(q, k, lm, kv_len, adaptive=kw["adaptive"],
                               **pass_kw)
    b_qk, b_av = twopass_bounds(args, kw)
    whole = (lambda: K.ita_attention_twopass(*args, **kw))
    entries += [
        (TWOPASS[0], f"q{tuple(q.shape)} k{tuple(k.shape)}",
         lambda: K.twopass_qk_launcher(q, k, lm, kv_len,
                                       adaptive=kw["adaptive"], **pass_kw),
         whole,
         lambda: K.twopass_qk_plain(q, k, lm, kv_len,
                                    adaptive=kw["adaptive"], **pass_kw),
         b_qk),
        (TWOPASS[1], f"a{tuple(stats[0].shape)} v{tuple(v.shape)}",
         lambda: K.twopass_av_launcher(*stats, v, om, kv_len, **pass_kw),
         whole,
         lambda: K.twopass_av_plain(*stats, v, om, kv_len, **pass_kw),
         b_av)]
    x, mask = softmax_inputs
    entries.append((
        "ita_softmax", f"x{tuple(x.shape)} block_c 128 paper",
        lambda: SK.kernel_launcher(x, mask, block_c=128),
        lambda: ita_softmax(x, mask, block_c=128),
        lambda: SK.softmax_plain(x, mask, block_c=128),
        softmax_bound(x, mask)))
    return entries


def streaming_ms(bind):
    """``kernel_ms`` and ``graph_ms`` of a decode call bound with
    ``DECODE_MAX_CLUSTER`` 1: one streaming block per kv row."""
    from repro_torch.kernels.ita_attention import kernel as K
    saved = K.DECODE_MAX_CLUSTER
    K.DECODE_MAX_CLUSTER = 1
    try:
        return {"ms": kernel_ms(bind), "graph_ms": graph_ms(bind)}
    finally:
        K.DECODE_MAX_CLUSTER = saved


def time_kernels(captured, softmax_inputs, launches, checks, serve_mean):
    """One row per kernel. B2's row also carries its decode-shaped call
    (``decode``: times, bound and launches of run (b)'s sq-1 calls) and
    the launches of its prefill calls; each paged kernel's row its mean
    time per launch over the serve (``serve_mean_ms``)."""
    rows, decode = [], None
    for name, shape, bind, call_fn, plain_fn, (bms, by) in timing_entries(
            captured, softmax_inputs):
        ms = kernel_ms(bind)
        graph = graph_ms(bind)
        call = median_ms(call_fn)
        plain = median_ms(plain_fn, reps=10)
        whose = "both passes" if name in TWOPASS else "one call"
        log(f"[timing] {name} at main-path shape {shape}: kernel {ms:.4f} "
            f"ms back to back, {graph:.4f} ms in a CUDA graph (wrapper "
            f"call, {whose}: {call:.4f} ms), plain {plain:.4f} ms, bound "
            f"{bms:.5f} ms ({by}); library call: none (no PyTorch call "
            f"computes ITA's integer attention or softmax); {card_line()}")
        if name in DECODE:
            streaming = streaming_ms(bind)
            log(f"[timing] {name} without a cluster (one streaming block "
                f"per kv row): kernel {streaming['ms']:.4f} ms back to "
                f"back, {streaming['graph_ms']:.4f} ms in a CUDA graph, "
                f"against {graph:.4f} ms with its geometry; {card_line()}")
        if name == ONEPASS_DECODE:
            decode = {"ms": ms, "graph_ms": graph, "plain_ms": plain,
                      "bound_ms": bms, "bound_by": by,
                      "launches": launches[name]}
            continue
        source, replaces = SOURCES[name]
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": checks.max_err[name], "ms": ms,
                     "graph_ms": graph, "plain_ms": plain, "bound_ms": bms,
                     "bound_by": by, "library_ms": None})
        if name in serve_mean:
            rows[-1]["serve_mean_ms"] = serve_mean[name]
        if name in DECODE:
            rows[-1]["streaming_ms"] = streaming["ms"]
            rows[-1]["streaming_graph_ms"] = streaming["graph_ms"]
    for row in rows:
        if row["name"] == "ita_attention_onepass":
            row["decode"] = decode
            row["prefill_launches"] = row["launches"] - decode["launches"]
    return rows

# ---------------------------------------------------------------------------
# Phase 7: ITA's quantized linear layer on layer 0
# ---------------------------------------------------------------------------

def layer0_projection_inputs(model, cfg):
    """``{M: {projection: x (M, K)}}``: what layer 0's projections see in
    one prefill of run (a)'s prompts (M = B·PROMPT) and in the decode step
    after it (M = B), recorded at ``models.layers.linear`` (the norm's
    output for wq/wk/wv/w_gate/w_up, the attention output for wo,
    ``silu(gate)·up`` for w_down)."""
    import torch

    from repro_torch.models import attention as MA
    from repro_torch.models import forward, init_caches
    from repro_torch.models import layers as ML
    weights = layer0_weights(model)
    seen, orig = {}, ML.linear

    def recording(x, w):
        for name, ww in weights.items():
            if w is ww and name not in seen:
                seen[name] = x.reshape(-1, x.shape[-1]).clone()
        return orig(x, w)

    MA.linear = ML.linear = recording
    try:
        with torch.inference_mode():
            caches = init_caches(cfg, B, RING, device=DEV)
            logits, caches = forward(model, prompt_batch(cfg), cfg,
                                     mode="prefill", caches=caches)
            prefill = dict(seen)
            seen.clear()
            forward(model, logits[:, -1:].argmax(-1), cfg, mode="decode",
                    caches=caches, pos0=torch.full((B,), PROMPT))
            decode = dict(seen)
    finally:
        MA.linear = ML.linear = orig
    out = {B * PROMPT: prefill, B: decode}
    for m, xs in out.items():
        if sorted(xs) != sorted(PROJECTIONS) or any(
                x.shape[0] != m for x in xs.values()):
            raise AssertionError(f"captured {sorted(xs)} at M = {m}")
    return out


def layer0_weights(model):
    """Layer 0's seven projection weights (K, N), by name."""
    blk = model.blocks[0]
    return {name: getattr(blk.mlp if name in MLP_PROJECTIONS else blk.attn,
                          name) for name in PROJECTIONS}


def linear_operands(x, w_q, bias=None):
    """The int8 matmul's operands for ``quantized_linear(x, w_q, bias)``
    and its result: ``(x_q, w_q values, bias_q (N,) int32, mult (N,) f32,
    quantized_linear's int8 out)``; ``mult = s_x·s_w/s_y`` with s_y
    calibrated on the exact accumulator, as ``quantized_linear`` forms
    it; no bias gives zeros."""
    import torch

    from repro_torch.core.quant import quantize_tensor, quantized_linear
    out, _ = quantized_linear(x, w_q, bias)
    xq = quantize_tensor(x)
    acc_scale = xq.scale * w_q.scale
    bias_q = torch.zeros_like(acc_scale) if bias is None else torch.round(
        bias.float() / acc_scale)
    return (xq.values, w_q.values, bias_q.to(torch.int32).reshape(-1),
            (acc_scale / out.scale).reshape(-1), out.values)


def other_layout(w_q):
    """The same weight values in the other storage: row-major for a
    K-major view, K-major for a row-major one."""
    return w_q.contiguous() if w_q.t().is_contiguous() \
        else w_q.t().contiguous().t()


def check_linear(checks, x_q, w_q, bias_q, mult, want, label):
    """B7a and B7b through ``ops.int8_matmul`` against their plain
    versions, each other, the same call on the weight in the other
    storage and ``quantized_linear``'s int8 values."""
    from repro_torch.kernels.int8_matmul import kernel as MK
    from repro_torch.kernels.int8_matmul.ops import int8_matmul
    outs = {}
    w_other = other_layout(w_q)
    for schedule, name in MATMUL.items():
        outs[name] = int8_matmul(x_q, w_q, bias_q, mult, schedule=schedule)
        plain = MK.matmul_plain(x_q, w_q, bias_q, mult) \
            if schedule == "tpu" \
            else MK.matmul_ws_plain(x_q, w_q, bias_q, mult, block_k=128)
        checks.compare(name, outs[name], plain, label)
        checks.compare(name, outs[name], want, label + " vs quantized_linear")
        checks.compare(name, int8_matmul(x_q, w_other, bias_q, mult,
                                         schedule=schedule), outs[name],
                       label + " with the weight in the other storage")
    checks.compare(MATMUL["weight_stationary"], outs["int8_matmul_ws"],
                   outs["int8_matmul"], label + " vs B7a")


def matmul_bound(m, k, n):
    """Least time of one B7a call: x, w, bias and mult read once, out
    written once, against 2 operations per multiply-add."""
    return roofline(m * k + k * n + 8 * n + m * n, 2 * m * n * k)


def ws_bound(m, k, n, block_k=128):
    """Least time of one B7b call, from the call's own M, K and N: x, w,
    bias and mult read once, the int32 partial sums read and written once
    per k tile (the schedule's 2·4·M·N·K/block_k bytes), out written
    once, against 2 operations per multiply-add. The reference reads
    each weight tile once; the kernel's re-reads of w (once per m range)
    are its own design's cost, logged beside the [psum] bytes."""
    nbytes = m * k + k * n + 8 * n + 2 * 4 * m * n * -(-k // block_k) \
        + m * n
    return roofline(nbytes, 2 * m * n * k)


def full_width_linear(model, cfg, checks):
    """Phase 7 (module docstring). Returns the main path's launches and
    its operands ``{(M, projection): linear_operands(...)}``."""
    import torch

    from repro_torch.core.quant import QTensor, quantize_tensor
    from repro_torch.kernels.int8_matmul.ops import int8_matmul
    inputs = layer0_projection_inputs(model, cfg)
    weights = layer0_weights(model)
    blk = model.blocks[0]
    w_qs = {}
    for name, w in weights.items():
        w_qs[name] = quantize_tensor(w.float(), axis=0)
        if not w_qs[name].values.t().is_contiguous():
            raise AssertionError(f"{name}: quantize_tensor did not store "
                                 f"the weight K-major")
    ops = {}
    for m, xs in inputs.items():
        for name in PROJECTIONS:
            bias = getattr(blk.attn, QKV_BIAS[name]) \
                if name in QKV_BIAS and cfg.qkv_bias else None
            ops[(m, name)] = linear_operands(xs[name].float(), w_qs[name],
                                             bias)
    # the main path: every projection, both schedules, counters around it
    reset_launches()
    outs = {(key, schedule): int8_matmul(x_q, w_q, bias_q, mult,
                                         schedule=schedule)
            for key, (x_q, w_q, bias_q, mult, _) in ops.items()
            for schedule in MATMUL}
    launches = read_launches()
    want = dict.fromkeys(SOURCES, 0)
    want["int8_matmul"] = want["int8_matmul_ws"] = len(ops)
    if launches != want:
        raise AssertionError(f"quantized-linear launches {launches} != "
                             f"{want}")
    for (m, name), operands in ops.items():
        w_q, ref = operands[1], operands[-1]
        label = f"layer 0 {name} M={m} K={w_q.shape[0]} N={w_q.shape[1]}"
        for schedule, kname in MATMUL.items():
            checks.compare(kname, outs[((m, name), schedule)], ref,
                           label + " (main path) vs quantized_linear")
        check_linear(checks, *operands, label)
    # a random bias, and shapes that pad M, K and N
    g = torch.Generator(device=DEV).manual_seed(11)
    x = inputs[B * PROMPT]["wq"].float()
    bias = torch.randn(w_qs["wq"].values.shape[1], generator=g, device=DEV)
    check_linear(checks, *linear_operands(x, w_qs["wq"], bias),
                 "layer 0 wq M=2048, random bias")
    for m, name, k, n in ((1000, "wk", 3500, 500), (B, "w_gate", 3500, 1000),
                          (300, "w_down", 18900, 3580)):
        w_cut = QTensor(w_qs[name].values[:k, :n].contiguous(),
                        w_qs[name].scale[:, :n])
        x = inputs[B * PROMPT if m > B else B][name][:m, :k].float()
        check_linear(checks, *linear_operands(x, w_cut),
                     f"{name}[:{k}, :{n}] M={m} (padded)")
    log(f"[linear] layer 0's 7 projections at M = {B * PROMPT} and {B}, "
        f"both schedules, weights K-major: launches {launches}; every "
        f"output bit-exact vs its plain version, the other schedule, the "
        f"row-major weight and quantized_linear (checks B7a "
        f"{checks.n['int8_matmul']}, B7b {checks.n['int8_matmul_ws']}: "
        f"model and random bias, padded M, K and N)")
    return launches, ops


def int_mm_call(x_q, w_q):
    """``torch._int_mm`` on the same operands, the library yardstick (the
    int32 product only; it needs more than 16 rows, so fewer are padded
    to 32): ``(call, note)``."""
    import torch

    from repro_torch.core.quant import int8_matmul_ref
    note = "int32 product only"
    if x_q.shape[0] <= 16:
        note += f", {x_q.shape[0]} rows padded to 32"
        x_q = torch.nn.functional.pad(x_q, (0, 0, 0, 32 - x_q.shape[0]))
    if not torch.equal(torch._int_mm(x_q, w_q), int8_matmul_ref(x_q, w_q)):
        raise AssertionError("torch._int_mm disagrees with the exact "
                             "product: not a yardstick")
    return (lambda: torch._int_mm(x_q, w_q)), note


def time_linear(ops, launches, checks):
    """Each distinct (M, K, N) of phase 7: the kernels alone on the
    K-major weight (back-to-back launches, as every kernel's ``ms``; and
    device time from a CUDA graph), the wrapper calls on the K-major and
    the row-major weight, their plain versions, ``torch._int_mm`` on both
    layouts (back-to-back calls and a CUDA graph); B7b's psum bytes.
    Returns the kernels' rows at w_gate, M = B·PROMPT."""
    from repro_torch.kernels.int8_matmul import kernel as MK
    from repro_torch.kernels.int8_matmul.ops import int8_matmul
    sms = MK.sm_count(DEV)
    rows, seen = [], set()
    for (m, name), (x_q, w_km, bias_q, mult, _) in ops.items():
        k, n = w_km.shape
        if (m, k, n) in seen:
            continue
        seen.add((m, k, n))
        w_rm = other_layout(w_km)
        lib, lib_graph, note = {}, {}, ""
        for layout, w in (("row-major", w_rm), ("K-major", w_km)):
            call_, note = int_mm_call(x_q, w)
            lib[layout] = kernel_ms(lambda call_=call_: (call_, None))
            lib_graph[layout] = graph_ms(lambda call_=call_: (call_, None))
        best = min(lib, key=lib.get)
        x_pad = int8_matmul_pad(x_q)
        for schedule, kname in MATMUL.items():
            bms, by = matmul_bound(m, k, n) if schedule == "tpu" \
                else ws_bound(m, k, n)

            def bind(schedule=schedule):
                return MK.kernel_launcher(x_pad, w_km, bias_q, mult,
                                          schedule=schedule)
            reps = 10 if m > B and schedule != "tpu" else 20
            ms = kernel_ms(bind, reps=reps)
            graph = graph_ms(bind, reps=reps)
            call = {layout: median_ms(
                lambda w=w, schedule=schedule: int8_matmul(
                    x_q, w, bias_q, mult, schedule=schedule))
                for layout, w in (("K-major", w_km), ("row-major", w_rm))}
            plain_fn = (lambda: MK.matmul_plain(x_q, w_km, bias_q, mult)) \
                if schedule == "tpu" else (lambda: MK.matmul_ws_plain(
                    x_q, w_km, bias_q, mult, block_k=128))
            plain = median_ms(plain_fn, reps=5, warmup=1)
            geo = MK.matmul_geometry(x_pad.shape[0], n, k, sms=sms) \
                if schedule == "tpu" \
                else MK.ws_geometry(x_pad.shape[0], n, k, 128, sms=sms)
            log(f"[timing] {kname} layer 0 {name} M={m} K={k} N={n}: kernel "
                f"{ms:.4f} ms on the K-major weight (back-to-back launches; "
                f"CUDA graph {graph:.4f} ms; wrapper call "
                f"{call['K-major']:.4f} ms, on the row-major weight, "
                f"transposed per call, {call['row-major']:.4f} ms), plain "
                f"{plain:.4f} ms, bound {bms:.5f} ms ({by}), torch._int_mm "
                f"{lib['row-major']:.4f} ms row-major / {lib['K-major']:.4f} "
                f"ms K-major back-to-back, {lib_graph['row-major']:.4f} / "
                f"{lib_graph['K-major']:.4f} ms in a CUDA graph ({note}); "
                f"grid {geo['grid']}")
            if schedule == "weight_stationary":
                rows_k = x_pad.shape[0]
                psum = 2 * 4 * rows_k * n * k // 128
                extra = (geo["ranges"] - 1) * k * n
                log(f"[psum] {kname} layer 0 {name} M={m} K={k} N={n}: "
                    f"{psum / 1e9:.4f} GB of partial sums per call "
                    f"(2·4·M·N·K/block_k on {rows_k} rows; 1 launch of "
                    f"{geo['grid'][0] * geo['grid'][1]} blocks, m ranges of "
                    f"{geo['range_rows']} rows, which read w "
                    f"{geo['ranges']} times: {extra / 1e9:.4f} GB more than "
                    f"the bound's once) in {graph:.4f} ms of device time, "
                    f"{psum / 1e9 / graph:.3f} TB/s")
            if (m, name) == (B * PROMPT, "w_gate"):
                source, replaces = SOURCES[kname]
                rows.append({"name": kname, "route": "cuda",
                             "source": source, "replaces": replaces,
                             "launches": launches[kname],
                             "max_abs_err": checks.max_err[kname], "ms": ms,
                             "plain_ms": plain, "bound_ms": bms,
                             "bound_by": by, "library_ms": lib[best],
                             "library_layout": best,
                             "library_row_major_ms": lib["row-major"],
                             "library_k_major_ms": lib["K-major"],
                             "graph_ms": graph,
                             "library_graph_row_major_ms":
                                 lib_graph["row-major"],
                             "library_graph_k_major_ms":
                                 lib_graph["K-major"],
                             "wrapper_k_major_ms": call["K-major"],
                             "wrapper_row_major_ms": call["row-major"]})
    return rows


def int8_matmul_pad(x_q):
    """x_q padded to the rows ``ops.int8_matmul`` gives the kernels (at
    least 8; the default block_m divides the model's row counts)."""
    import torch
    return torch.nn.functional.pad(x_q, (0, 0, 0, max(0, 8 - x_q.shape[0])))


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    from repro_torch.kernels.common import exact_float32_matmul

    card = card_line()
    log(f"[card] {card}; torch {torch.__version__} CUDA "
        f"{torch.version.cuda}; {torch.cuda.get_device_name(0)}")
    exact_float32_matmul()
    t0 = time.perf_counter()
    report = build.build_all(verbose=True)
    log(f"[build] {sorted(report)} built in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, info in report.items():
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")

    checks = Checks()
    check_kernels(checks)
    check_row_invariance()
    smoke_width_reference()
    model, cfg = full_width_model()
    metrics, captured = full_width(model, cfg, checks)
    softmax_inputs, softmax_launches = full_width_softmax(
        captured["twopass"][2][1], checks)
    served, serve_launches, serve_captured = full_width_serve(model, cfg,
                                                              checks)
    captured.update(serve_captured)
    # ring and twopass kernels: the generate() runs; paged kernels: the
    # serve; the softmax: its run on run (c)'s A
    rows = time_kernels(captured, softmax_inputs,
                        {**serve_launches, **metrics["launches"],
                         "ita_softmax": softmax_launches}, checks,
                        served["mean_ms"])
    linear_launches, linear_ops = full_width_linear(model, cfg, checks)
    rows += time_linear(linear_ops, linear_launches, checks)
    log(f"[result] prefill {metrics['prefill_s']:.4f} s, decode "
        f"{metrics['decode_tok_s']:.1f} tok/s (unpinned); pinned onepass "
        f"prefill {metrics['pinned_prefill_s']:.4f} s, decode "
        f"{metrics['pinned_decode_tok_s']:.1f} tok/s; pinned twopass (paper "
        f"DI) prefill {metrics['twopass_prefill_s']:.4f} s, decode "
        f"{metrics['twopass_decode_tok_s']:.1f} tok/s; serve "
        f"{served['tok_s']:.2f} tok/s sustained, TTFT p50 "
        f"{served['ttft_p50']:.3f} s p90 {served['ttft_p90']:.3f} s, wall "
        f"{served['wall_s']:.3f} s; stall serve {served['stall']['tok_s']:.2f} "
        f"tok/s, wall {served['stall']['wall_s']:.3f} s, prefill stall "
        f"{served['stall']['prefill_stall_s']:.3f} s; stepwise decode "
        f"(a) (b) (c) {', '.join(f'{x:.1f}' for x in metrics['stepwise_decode_tok_s'])}"
        f" tok/s; {card}")
    log(f"[result] checks {checks.n}; wall {time.perf_counter() - T0:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
