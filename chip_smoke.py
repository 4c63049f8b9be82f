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
   steps rest on. At phase 9's and 10's head shapes (phi3-mini's 32/32
   heads of 96, olmoe-1b-7b's 16/16 of 128, kv_rep 1; recurrentgemma-
   2b's 10/1 of 256, kv_rep 10) hold B2 (prefill and decode-shaped), B4
   (clusters and streaming), B3 (q_len 96/1/96/0) and B4p to their
   plain versions, and at recurrentgemma-2b's window of 2048 B4 and
   decode-shaped B2 over a full 2048-entry ring and B4 over a 2304-entry
   ring whose window skips leading tiles; check that the MoE layer at
   olmoe-1b-7b's widths gives a row the same bits whatever rows share
   the call (the router's float32 product and softmax, the expert FFN's
   blocked ``bmm`` in any block and at any row, replayed from a CUDA
   graph, and a token's layer output alone, among 4, 96 and 384
   tokens); and hold ``runtime/kv_cache.py``'s ``prefill_attend`` and
   ``decode_attend`` with per-head scales, on a ring and on a pool, to
   the same steps on the CPU. Hold B2 and B3 non-causal, as the cross
   layers call them, to their plain versions at whisper-large-v3's
   20/20 heads of 64 over 1500 keys padded to 1536 (``kv_len`` 1500)
   and llama-3.2-vision-90b's 64/8 of 128 over 1601 padded to 1664
   (a prefill and a decode-shaped row; B3 over 128-token pages).
3. Drive ``generate()`` on full-width qwen2-7b, its depth cut to
   ``QWEN2_LAYERS`` (14) of its 28 layers (random bf16 weights from a
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
   saw); the inputs and outputs of layers 0 and 13 of one prefill call
   and one decode step (the first, run eagerly before the capture; run
   (b): also layer 0 of its first decode step, a decode-shaped onepass
   call) are kept and held to the plain versions afterwards. The
   smoke-width configs (qwen2 unpinned and with each pin;
   recurrentgemma and rwkv6; whisper and llama-vision, their gates 0.5,
   unpinned and onepass-pinned, with a frontend) check the card's logits
   against the CPU's plain versions. Profile one unpinned
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
   admitted prompts through the ring onepass kernel (14 launches an
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
   share, kernels launched). Then the trace behind a shared 256-token
   system prefix, sharing on and off; the overload serve (classes,
   preemption, aging, a fault plan; greedy, then its first six
   requests sampled); a captured mixed step that copies a shared page on
   write. Then crash-safe serving: (i) the chunked serve with a
   write-ahead journal and without, in two on/off pairs, equal tokens,
   walls and tok/s of each; (ii) the prefixed trace with sharing,
   preemption and a snapshot of the pools and the prefix index every 4
   segments through ``serve_with_recovery``, crashed at a round boundary
   after a snapshot and then mid-segment (after the readback, before the
   journal flush), the third attempt warm-restored from the snapshot:
   two crashes, the calm tokens, the first B3 and B4p calls after each
   restore held to their plain versions, the paged kernels' launches
   counted over the three attempts, the snapshot's bytes and the
   caller's time per snapshot, ``recovery_s`` and the recapture time;
   (iii) a byte of the newest snapshot flipped: a cold start with the
   calm tokens; (iv) the first six requests sampled, crashed
   mid-segment and recovered from their journaled CUDA generator states:
   the calm sampled tokens; (v) a drain at step 48, then a resume: the
   union of both runs is the calm tokens, nothing served twice.
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
8. The paper's baselines and the model they serve (the XLA backends):
   (a) on run (a)'s weights and prompts, ``generate()`` with
   ``attention_impl="float"`` (bf16 rings; ``float_xla``: the streaming
   online softmax at prefill, ``direct_float`` at decode) and with
   ``"ibert"`` (int8 rings; ``ibert_xla`` at both), each fused twice
   (the capture, then the kept graph's replays: the steady-state
   figures) and held to stepwise, the backends that served each call
   site counted (no other may serve, and no fused attention kernel may
   launch), then profiled for the busy share; the share of tokens equal to run (a)'s
   ITA tokens and the last prompt position's logits against the float
   run are printed, not gated. (b) On run (c)'s layer-0 logits (phase
   4's rows): B6 (paper DI, counted), I-BERT, Softermax, the QAT STE
   forward and the float oracle on the card; I-BERT must equal I-BERT on
   the CPU bit for bit; the MAE of each against float is printed. (c)
   After qwen2-7b is freed: gemma2-27b at full width (46 alternating
   local-4096/global layers, d 4608, 32/16 heads, GeGLU 36864, vocab
   256000, softcaps 50 and 30, query scale 144^-0.5; random bf16 weights
   from seed 0, ITA): (i) 16 of its 46 layers (``GEMMA2_PERIODS``),
   batch 4, prompt 512, 32 tokens; (ii) 2 of its 46 layers
   (``GEMMA2_LONG_PERIODS``), batch 1, prompt 4608, 16 tokens
   (the local rings wrap); prefill served by
   ``ita_chunked_xla``, decode by ``ita_direct_xla``, no fused kernel,
   fused tokens equal stepwise; prefill s, decode tok/s, the replayed
   step beside the weight-read floor, busy share, peak allocation.
9. The mixture of experts and the other dense configs, each at full
   width in its own frame after gemma2-27b is freed (random weights
   from seed 0, ITA): (a) olmoe-1b-7b (16 layers, d 2048, 16/16 heads
   of 128, 64 experts of 1024 top-8, vocab 50304, bf16 parameters):
   ``generate()`` at batch 4, prompt 512, 32 tokens, unpinned (chunked
   prefill, then B4) and onepass-pinned (B2 throughout), each fused
   twice with equal tokens and launches and held to stepwise, the
   serving backends counted and layer 0's calls held to plain; the
   decode step's two weight-read floors (all 64 experts, and only the
   experts four decode steps route to, counted at the router); then a
   12-request ``serve_continuous(admission="chunked")`` (numpy seed 7,
   prompts 128-512, 16-45 generated, 4 slots, 128-token pages, 96-token
   chunks, 16-step segments), B3 and B4p only, every request equal to
   solo ``generate()`` under the onepass pin; its first four requests
   served once more under the profiler, with the same tokens. Prompts
   stop at 512 so that every call keeps ``t·k <= 4096``, where the MoE
   drops nothing. (b) phi3-mini-3.8b (32
   layers, d 3072, 32/32 heads of 96): ``generate()`` as (a)'s, beside
   its weight-read floor. Layer 0's kernel calls of both are timed as
   sub-rows of the kernels line (``olmoe``, ``phi3``,
   ``*_prefill``/``*_decode`` on B2).
10. The recurrent blocks, after phase 9's models are freed (random
   weights from seed 0, ITA): (a)
   recurrentgemma-2b at full width (26 layers: 18 RG-LRU, 8 local
   attention of 10/1 heads of 256, window 2048; rnn width 2560, GeGLU
   7680, vocab 256000, bf16 parameters): ``generate()`` at batch 4,
   prompt 512, 32 tokens, (a) unpinned (chunked prefill, then B4), (b)
   onepass-pinned (B2), (c) (a) with ``paged=True`` (B4p; its tokens
   must equal (a)'s), (d) batch 1, prompt 4096, 16 tokens (the 2048-
   entry local rings wrap and the window binds); each fused twice with
   equal tokens and launches and held to stepwise, the backends counted
   and layer 2's (the first local layer's) calls held to plain, timed as
   sub-rows (``recurrentgemma``, ``recurrentgemma_long``,
   ``recurrentgemma_prefill``/``_decode``); the replayed step beside the
   weight-read floor, busy share, the recurrent state's bytes a
   sequence. (b) rwkv6-7b at full width (32 layers, d 4096, 64 heads of
   64, channel mix 14336, vocab 65536): ``generate()`` at batch 4,
   prompt 512, 32 tokens, fused twice and stepwise with equal tokens,
   no attention call and no kernel launch (attention-free).
11. The encoder–decoder and cross-attention blocks, after phase 10's
   models are freed (random weights from seed 0, ITA, pinned to
   ``ita_onepass_pallas``: unpinned, the decode kernel refuses the
   1500- and 1601-key cross caches, as the JAX package's does). (a)
   whisper-large-v3 at full width and depth (32 encoder and 32 decoder
   layers, d 1280, 20/20 heads of 64, GELU 5120, vocab 51866, bf16
   parameters): ``generate()`` at batch 4 over a 1500-frame random
   frontend, prompt 192, 64 tokens, on rings fused twice with equal
   tokens and launches and held to stepwise, then once fused with
   ``paged=True`` (tokens equal, launches counted); the encoder on
   ``ita_chunked_xla`` (the QAT
   forward, train mode), self and cross attention on
   ``ita_onepass_pallas`` at prefill and decode (B3 for the paged self
   decode); layer 0's self and cross B2 calls and B3 held to plain; the
   unpinned call must raise the reference's text. Printed: the encoder's
   and the prefill's seconds, decode tok/s, the replayed step beside
   its floor (the decoder's weights but the cross ``wk``/``wv``, plus
   the cross caches), the cross caches' bytes, the busy share (a
   profiled call of 16 tokens, the encoder included) and the
   per-step device time of the cross caches' pad-copy to the 128-key
   tile (``torch.profiler``). (b) llama-3.2-vision-90b at full width, its
   depth cut to 1 of its 20 periods (4 self-attention layers and the
   gated cross layer, its gates set to 0.5): 1601 patch embeddings of
   1280 through ``frontend_proj``, batch 4, prompt 512, 32 tokens, held
   as (a). Sub-rows ``whisper_*`` and ``llama_vision_*`` of the kernels
   line.

12. Training, after phase 11's models are freed (random weights from
   seed 0, ITA). (a) phi3-mini-3.8b at full width and depth (32 layers,
   d 3072, 32/32 heads of 96, SwiGLU 8192, vocab 32064; bf16 storage, a
   float32 master, float32 ``mu``/``nu``): 8 steps of
   ``make_train_step`` (AdamW, lr 1e-3, warmup 1, per-block remat) on one
   repeated synthetic batch of 4 x 513 tokens, the last one profiled;
   gates: finite losses and grad norms, the last loss below the first,
   every layer's ``s_q``/``s_k`` moved and ``s_v``/``s_out`` unchanged,
   every attention call on ``ita_chunked_xla`` in train mode, no kernel
   launched; printed: seconds a step, tokens/s, busy share, peak
   allocation. (b) The trained weights served with gradients off and the
   optimizer state freed: ``generate()`` unpinned at batch 4, prompt 512,
   16 tokens, fused twice and stepwise with equal tokens and launches
   (the chunked prefill, then B4), layer 0's first B4 call held to plain
   and timed as the ``phi3_trained`` sub-row. (c) phi3-mini at full
   width cut to 1 layer: ``TrainDriver`` 6 straight steps against 3
   steps, a checkpoint, a restore and 3 more, parameters and optimizer
   state bit-identical, deterministic algorithms on (an op without a
   deterministic version is named); each save's bytes and the caller's
   seconds, in a temporary directory removed afterwards. (d) phi3-smoke's
   train step on the card against the CPU's: ``float`` within 1e-5,
   ``ita``'s loss within 5e-3 (a flipped ``s_out`` tie). (e)
   whisper-large-v3 at full width and depth (32 encoder and 32 decoder
   layers, 1.55 B parameters; bf16 storage, a float32 master), two
   AdamW steps at 4 x 448 tokens over a seeded 4 x 1500-frame float32
   frontend, (i) under its own ``remat_policy="dots"`` and (ii) from seed
   0 again under ``"full"``: each step's seconds and the peak
   allocation; gates: losses equal bit for bit, every parameter, master
   and moment of (ii) equal to (i)'s (``torch.equal`` on the card), and
   the bytes one ``loss_fn`` forward holds for its backward, dots minus
   full, within 2% of the kept ``mm`` outputs' bytes from the shapes
   (``dots_saved_bytes``). The trained weights then served through B2:
   ``generate()`` pinned to onepass on rings, 4 x 64 prompt tokens, 16
   new, fused twice and stepwise with equal tokens and launches, layer
   0's self and cross calls held to plain; the ``whisper_trained``
   sub-row.

13. The roofline of four paths (``repro_torch.roofline``), each inside
   the frame where its model already lives: qwen2-7b (a)'s chunked
   prefill at 4 x 512 and its decode step, olmoe-1b-7b (a)'s decode step
   and phase 12's phi3-mini-3.8b train step at 4 x 512 (a ninth step,
   counted, whose weights 12b serves). ``op_costs`` counts one eager
   step (a replay records nothing): every aten matmul by dtype and
   family (an operand once per ``linear`` or expert-FFN call), the
   kernels by their formulas. Printed per path:
   ``Roofline.row()`` (compute, memory, bottleneck, ``model_flops``,
   ``useful_ratio``) beside the measured step (the prefill timed once
   more uncounted; a decode step as its run's replayed step; the train
   step as 12a's mean), ``mfu`` and ``share``. Gates: ``share`` and
   ``mfu`` in (0, 1.05]; the counted projection, MLP, router and
   unembedding FLOPs (and the MoE capacity buffer's) equal
   ``op_costs.expected_flops`` exactly.
14. The range certificates (``repro_torch.analysis``): the 18-case
   matrix at the full geometry (traced on the CPU), all ``ok``; the six
   lints, the four card lints on the card; and the nine kernels on calls
   at the declared extremes (Q/K/V saturated at +127, -128 and both;
   fully masked rows beside rows at the capacity; scales at
   ``SCALE_BOUNDS``; the GEMM's bias at ±2^20), each bit-exact to its
   plain version with every output inside its certificate's proven
   interval.

15. The multi-card layer on a mesh of one card: a world-size-1 NCCL
   process group on a free local port, the (data=1, model=1) mesh over
   it. (a) qwen2-7b at full width (``QWEN2_LAYERS`` layers, a new model
   from phase 3's seed): ``generate()`` unpinned and onepass-pinned,
   then the model sharded in place (``shard_model``; no parameter
   copied) and the same greedy runs through ``shard_cell``'s prefill and
   decode steps: tokens and launches (B4 in (a), B2 in (b)) equal to the
   unsharded runs'. (b) phi3-mini-3.8b at full width cut to 8 layers,
   then whisper-large-v3 at full width cut to 2 encoder and 2 decoder
   layers under its ``fsdp`` and ``remat_policy="dots"`` (4 x 448
   tokens, a seeded frontend): two steps of ``shard_train_step`` against
   ``make_train_step`` from the same seed on the same batch, losses,
   parameters and AdamW moments bit-identical. (c) ``compressed_psum``
   over the NCCL group, equal to its formula. (d) meanwhile, on the CPU in subprocesses,
   ``python -m repro_torch.launch.dryrun`` on the (16, 16) mesh's cells
   qwen2-7b decode_32k, mixtral-8x7b train_4k and llama-3.2-vision-90b
   prefill_32k, all ``ok``, each record's per-device bytes and
   bottleneck printed. The group is destroyed at the end.

It prints the card, the kernels' JSON line, the roofline's JSON line
(``{"roofline": [...]}``, one record per path) and, last, ``{"ok": true,
"device": ...}``. Without CUDA, or without the rest of the repository, it
exits non-zero and prints no result.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

T0 = time.perf_counter()
ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

B, PROMPT, GEN = 4, 512, 32
RING = 640                       # the main path's ring: 512 + 32 aligned
LONG_RING = 2304                 # 18 tiles: more than a cluster's CTAs
STREAMING = "/streaming"         # a decode case run without a cluster
DEV = "cuda"
WIDTH = {}                       # config overrides (none: full width)
# phases 3-8b's depth: 14 of qwen2-7b's 28 layers, widths unchanged (the
# script's slowest run took 1010 s of its 1200 with all 28 and phase 12)
QWEN2_LAYERS = 14

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
# the prefix and overload serves: one shared system prefix of two full
# pages (numpy seed 11) before every prompt; the overload serve's classes,
# aging and fault plan. A kill at the round of step 24 (step 32) and a
# 10-page pressure spike at the round of step 16, where class-1 request 2
# heads the queue with the pool nearly full: it preempts class-0 request
# 0 (a CPU rehearsal of the schedule, which weights do not change without
# EOS: request 0 by priority, request 1 by the kill, in the 12-request
# serve and in its first six)
SYSTEM_PREFIX = 256
OVERLOAD_PLAN = dict(seed=0, kill_steps=(24,), pressure_steps=(16,),
                     pressure_pages=10, straggle_steps=(64,), straggle_s=0.05)
AGING_STEPS = 32
# crash-safe serving: a snapshot every 4 segments (64 steps); attempt 1 of
# the recovered prefix serve crashes at the round of step 80 (after its
# first snapshot), attempt 2 after the readback of step 80 (after its
# own); the drain stops admitting at step 48
SNAPSHOT_EVERY = 4
CRASHES = (80, 80)
DRAIN_AFTER = 48
# phase 6: the stall serve's ragged B2 prefill and decode-shaped B3 call
STALL_PREFILL = "ita_attention_onepass/stall_prefill"
STALL_DECODE = "ita_attention_onepass_paged/stall_decode"
# phase 9's and 10's models and their head shapes (arch, hq, hkv, head
# dim); recurrentgemma-2b's local attention also at its window
MOE_PHASE_SHAPES = (("phi3-mini-3.8b", 32, 32, 96),
                    ("olmoe-1b-7b", 16, 16, 128),
                    ("recurrentgemma-2b", 10, 1, 256))
LOCAL_WINDOW = {"recurrentgemma-2b": 2048}
# phase 2's smoke-width configs held to the CPU: (arch, pinned backend)
SMOKE_REFERENCE = (("qwen2-7b", ""), ("qwen2-7b", "ita_onepass_pallas"),
                   ("qwen2-7b", "ita_twopass_pallas"),
                   ("recurrentgemma-2b", ""), ("rwkv6-7b", ""),
                   ("whisper-large-v3", ""),
                   ("whisper-large-v3", "ita_onepass_pallas"),
                   ("llama-3.2-vision-90b", ""),
                   ("llama-3.2-vision-90b", "ita_onepass_pallas"))
# phase 11: the cross-attention shapes (arch, hq, hkv, head dim, frames,
# prompt); whisper's prompt and tokens stay inside its 448-token context
CROSS_SHAPES = (("whisper-large-v3", 20, 20, 64, 1500, 192),
                ("llama-3.2-vision-90b", 64, 8, 128, 1601, 512))
WHISPER_PROMPT, WHISPER_GEN = 192, 64
WHISPER_PROFILE_GEN = 16        # the profiled call's tokens
PIN = "ita_onepass_pallas"
# 11b: llama-3.2-vision-90b's depth, 1 of its 20 (4 self + 1 cross) periods
VISION_PERIODS = 1
CROSS_GATE = 0.5                # the reference initialises the gates to 0
# phase 9a's served trace: prompts up to 512 tokens, so every call (solo
# prefill of 512 included) keeps t·k <= 4096 and drops nothing
MOE_SERVE = dict(SERVE, plen=(128, 512), gen=(16, 45), num_pages=None)
# sub-rows of the kernels line: (kernel, key)
SUBROWS = {ONEPASS_DECODE: ("ita_attention_onepass", "decode"),
           STALL_PREFILL: ("ita_attention_onepass", "stall_prefill"),
           STALL_DECODE: ("ita_attention_onepass_paged", "stall_decode")}


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


def model_shape_cases(rng_seed=3):
    """(name, args, kwargs, label) of B2, B3, B4 and B4p at phase 9's and
    10's head shapes: phi3-mini's 32/32 heads of 96 and olmoe-1b-7b's
    16/16 of 128 (kv_rep 1), recurrentgemma-2b's 10/1 of 256 (kv_rep
    10), on rings of ``RING`` and on a pool of 128-token pages; at a
    local window (recurrentgemma-2b's 2048) also B4 and decode-shaped B2
    over a full ring of the window's length (the wrapped local ring of
    phase 10 (d)), and B4 over a ring of ``LONG_RING`` whose window skips
    leading tiles."""
    import torch
    g = torch.Generator(device=DEV).manual_seed(rng_seed)

    def i8(*shape):
        return torch.randint(-128, 128, shape, generator=g, device=DEV,
                             dtype=torch.int8)

    def f32(lo, hi, n):
        return lo + (hi - lo) * torch.rand(n, generator=g, device=DEV)

    cases = []
    for arch, hq, hkv, d in MOE_PHASE_SHAPES:
        bh, rep = B * hq, hq // hkv
        lm, om = f32(0.004, 0.03, bh), f32(0.5, 2.0, bh)

        def rows(*x, hq=hq):
            return torch.tensor(x, device=DEV, dtype=torch.int32)[:B] \
                .repeat_interleave(hq)
        kv_len = rows(RING, PROMPT + 1, RING // 2, 17)
        k4, v4 = i8(B, RING, hkv, d), i8(B, RING, hkv, d)
        common = dict(causal=True, kv_rep=rep, hq=hq)
        tag = f"{arch} {hq}/{hkv} d={d}"
        for sq, variant in ((1, ""), (1, STREAMING), (4, "")):
            cases.append(("ita_attention_decode" + variant,
                          (i8(bh, sq, d), k4, v4, lm, om, kv_len),
                          dict(q_offset=kv_len - sq, adaptive=sq == 1,
                               **common),
                          f"decode 4d sq={sq} {tag}{variant}"))
        k3, v3 = i8(B * hkv, RING, d), i8(B * hkv, RING, d)
        cases.append(("ita_attention_decode",
                      (i8(bh, 2, d), k3, v3, lm, om, kv_len),
                      dict(q_offset=kv_len - 2, causal=True, window=200,
                           kv_rep=rep),
                      f"decode 3d sq=2 window=200 {tag}"))
        cases.append(("ita_attention_onepass",
                      (i8(bh, PROMPT, d), k4, v4, lm, om, PROMPT),
                      dict(adaptive=True, **common),
                      f"onepass 4d prefill {PROMPT} {tag}"))
        cases.append(("ita_attention_onepass",
                      (i8(bh, 1, d), k4, v4, lm, om, kv_len),
                      dict(q_offset=kv_len - 1, adaptive=True, **common),
                      f"onepass decode-shaped sq=1 {tag}"))
        page, n_pages, chunk = SERVE["page_size"], 5, SERVE["chunk_size"]
        total = B * n_pages + 3
        table = (torch.randperm(total - 1, generator=g, device=DEV)
                 [:B * n_pages] + 1).to(torch.int32).view(B, n_pages)
        kp, vp = i8(total, page, hkv, d), i8(total, page, hkv, d)
        lens = rows(600, 515, chunk, 300)
        q_len = rows(chunk, 1, chunk, 0)
        cases.append(("ita_attention_onepass_paged",
                      (i8(bh, chunk, d), kp, vp, table, lm, om, lens),
                      dict(q_offset=torch.clamp(lens - q_len, min=0),
                           q_len=q_len, adaptive=True, **common),
                      f"onepass paged q_len 96/1/96/0 {tag}"))
        for variant in ("", STREAMING):
            cases.append(("ita_attention_decode_paged" + variant,
                          (i8(bh, 1, d), kp, vp, table, lm, om, lens),
                          dict(q_offset=torch.clamp(lens - 1, min=0),
                               adaptive=True, **common),
                          f"decode paged {tag}{variant}"))
        window = LOCAL_WINDOW.get(arch)
        if window is None:
            continue
        full = rows(window, window, window, window)
        kw_ = dict(common, window=window, adaptive=True)
        kf, vf = i8(B, window, hkv, d), i8(B, window, hkv, d)
        for name in ("ita_attention_decode", "ita_attention_decode"
                     + STREAMING, "ita_attention_onepass"):
            cases.append((name, (i8(bh, 1, d), kf, vf, lm, om, full),
                          dict(q_offset=full - 1, **kw_),
                          f"{name} full ring of {window}, window {window} "
                          f"{tag}"))
        long_len = rows(LONG_RING, 2100, window + 1, 300)
        kl, vl = i8(B, LONG_RING, hkv, d), i8(B, LONG_RING, hkv, d)
        for variant in ("", STREAMING):
            cases.append(("ita_attention_decode" + variant,
                          (i8(bh, 1, d), kl, vl, lm, om, long_len),
                          dict(q_offset=long_len - 1, **kw_),
                          f"decode ring {LONG_RING}, window {window} "
                          f"{tag}{variant}"))
    return cases


def cross_cases(rng_seed=5):
    """(name, args, kwargs, label) of B2 and B3 non-causal, as the cross
    layers call them, at ``CROSS_SHAPES``: the memory's keys zero-padded
    to the 128-key tile with ``kv_len`` the frame count and queries at
    offset 0; B2 on the cache-native ring (the prompt's rows and a
    decode-shaped row), B3 over a pool of 128-token pages (a chunk of 96
    rows and one row)."""
    import torch
    g = torch.Generator(device=DEV).manual_seed(rng_seed)

    def i8(*shape):
        return torch.randint(-128, 128, shape, generator=g, device=DEV,
                             dtype=torch.int8)

    def f32(lo, hi, n):
        return lo + (hi - lo) * torch.rand(n, generator=g, device=DEV)

    cases = []
    for arch, hq, hkv, d, frames, prompt in CROSS_SHAPES:
        bh, page = B * hq, SERVE["page_size"]
        n_pages = -(-frames // page)
        lm, om = f32(0.004, 0.03, bh), f32(0.5, 2.0, bh)
        kv_len = torch.full((bh,), frames, dtype=torch.int32, device=DEV)
        k, v = i8(B, n_pages * page, hkv, d), i8(B, n_pages * page, hkv, d)
        k[:, frames:] = 0
        v[:, frames:] = 0
        common = dict(q_offset=0, causal=False, adaptive=True,
                      kv_rep=hq // hkv, hq=hq)
        tag = f"{arch} {hq}/{hkv} d={d}, {frames} keys padded to " \
              f"{n_pages * page}"
        for sq in (prompt, 1):
            cases.append(("ita_attention_onepass",
                          (i8(bh, sq, d), k, v, lm, om, kv_len),
                          dict(block_kv=page, **common),
                          f"onepass non-causal sq={sq} {tag}"))
        total = B * n_pages + 3
        table = (torch.randperm(total - 1, generator=g, device=DEV)
                 [:B * n_pages] + 1).to(torch.int32).view(B, n_pages)
        kp, vp = i8(total, page, hkv, d), i8(total, page, hkv, d)
        for sq in (SERVE["chunk_size"], 1):
            cases.append(("ita_attention_onepass_paged",
                          (i8(bh, sq, d), kp, vp, table, lm, om, kv_len),
                          dict(common), f"onepass paged non-causal sq={sq} "
                          f"{tag}"))
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
    shapes = model_shape_cases() + cross_cases()
    for name, args, kw, label in kernel_cases() + [
            c for c in shapes if not c[0].startswith(PAGED)]:
        got = run_case(name, args, kw)
        checks.compare(name.partition("/")[0], got,
                       K.attention_plain(*args, **kw), label)
    for name, args, kw, label in paged_cases() + [
            c for c in shapes if c[0].startswith(PAGED)]:
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
    log(f"[kernels] bit-exact vs plain at qwen2-7b shapes, at phase "
        f"9's and 10's (32/32 heads of 96, 16/16 of 128, 10/1 of 256 with "
        f"window 2048) and at phase 11's non-causal cross calls (20/20 of "
        f"64 over 1500 keys, 64/8 of 128 over 1601): {checks.n}")


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


def check_moe_row_invariance():
    """The MoE layer at olmoe-1b-7b's widths (d 2048, 64 experts of 1024,
    top-8, bf16): the router's float32 product and softmax give a row the
    same bits whatever rows share the call; the expert FFN gives a row of
    the blocked capacity buffer the same bits whatever the other rows of
    its block and whichever block holds it, and the same replayed from a
    CUDA graph; and in the exact regime a token's output of the whole
    layer does not depend on the tokens beside it (a decode step's 4
    rows, a chunk of 96, a mixed step's 384)."""
    import torch

    from repro_torch.models import moe as TM
    g = torch.Generator(device=DEV).manual_seed(6)
    d, e, f, k = 2048, 64, 1024, 8

    def w(*shape):
        return (torch.randn(shape, generator=g, device=DEV)
                * shape[-2] ** -0.5).to(torch.bfloat16)
    router = torch.randn((d, e), generator=g, device=DEV) * d ** -0.5
    wg, wu, wd = w(e, d, f), w(e, d, f), w(e, f, d)
    x = torch.randn((700, d), generator=g, device=DEV).to(torch.bfloat16)
    full = TM.router_probs(x, router)
    for m in (1, 4, 96, 384, 644):
        part = TM.router_probs(x[:m], router)
        for r in {0, m // 2, m - 1}:
            if not torch.equal(part[r], full[r]):
                raise AssertionError(f"router row {r} of {m} rows differs")
    buf = torch.randn((3, e, 128, d), generator=g, device=DEV) \
        .to(torch.bfloat16)
    ffn = TM.expert_ffn(buf, wg, wu, wd)
    moved = torch.zeros_like(buf[:1])
    moved[0, :, 5] = buf[2, :, 77]
    if not torch.equal(TM.expert_ffn(moved, wg, wu, wd)[0, :, 5],
                       ffn[2, :, 77]):
        raise AssertionError("expert FFN: a row moved to another block and "
                             "row differs")
    if not torch.equal(TM.expert_ffn(buf.flip(0), wg, wu, wd),
                       ffn.flip(0)):
        raise AssertionError("expert FFN: blocks in another order differ")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        TM.expert_ffn(buf, wg, wu, wd)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = TM.expert_ffn(buf, wg, wu, wd)
    graph.replay()
    torch.cuda.synchronize()
    if not torch.equal(replayed, ffn):
        raise AssertionError("expert FFN replayed from a CUDA graph differs "
                             "from eager")
    xs = x[:384][None]
    layer = TM.apply_moe(xs, router, wg, wu, wd, k)
    for lo, n in ((0, 4), (200, 96), (383, 1)):
        part = TM.apply_moe(xs[:, lo:lo + n], router, wg, wu, wd, k)
        if not torch.equal(part[0], layer[0, lo:lo + n]):
            raise AssertionError(f"MoE layer: tokens {lo}..{lo + n - 1} "
                                 f"differ from the same tokens among 384")
    log("[invariance] MoE at olmoe-1b-7b widths: router rows equal among "
        "1-700 rows; expert FFN rows equal in any block, at any row, "
        "and replayed from a CUDA graph; a token's layer output equal "
        "alone, among 4, 96 and 384 tokens (cap 8 to 3072)")


def check_kv_cache_engine(checks):
    """``runtime.kv_cache``'s prefill and decode steps with per-head scales
    at olmoe-1b-7b's heads (16/16, head dim 128), on a ring and on a pool
    of 128-token pages: a ragged 256-token prefill (lengths 256 and 200)
    and 3 decode steps on the card (B2, then B4 or B4p) equal the same
    steps on the CPU (the plain versions): every output and the caches'
    bytes and scales."""
    import torch

    from repro_torch.runtime import kv_cache as KVE
    g = torch.Generator().manual_seed(8)
    b, hq, hkv, d, pre, steps = 2, 16, 16, 128, 256, 3
    q8 = torch.randint(-128, 128, (b, hq, pre + steps, d), generator=g,
                       dtype=torch.int8)
    kf = torch.randn((b, pre + steps, hkv, d), generator=g)
    vf = torch.randn((b, pre + steps, hkv, d), generator=g)
    lengths = torch.tensor([pre, 200], dtype=torch.int32)
    for paged in (False, True):
        outs, caches = {}, {}
        for dev in ("cpu", DEV):
            if paged:
                cache = KVE.init_paged_cache(b, 512, hkv, d,
                                             per_head_scales=True,
                                             device=dev)
            else:
                cache = KVE.init_cache(b, 512, hkv, d, per_head_scales=True,
                                       device=dev)
            out, cache = KVE.prefill_attend(
                cache, q8[:, :, :pre].to(dev), kf[:, :pre].to(dev),
                vf[:, :pre].to(dev), 0.05, 0.04,
                lengths=lengths.to(dev))
            seq = [out[0].cpu(), out[1, :, :200].cpu()]
            for t in range(pre, pre + steps):
                out, cache = KVE.decode_attend(
                    cache, q8[:, :, t:t + 1].to(dev),
                    kf[:, t:t + 1].to(dev), vf[:, t:t + 1].to(dev), 0.05,
                    0.04)
                seq.append(out.cpu())
            outs[dev], caches[dev] = seq, cache
        where = "pool" if paged else "ring"
        decode = "ita_attention_decode_paged" if paged \
            else "ita_attention_decode"
        for i, (got, want) in enumerate(zip(outs[DEV], outs["cpu"],
                                            strict=True)):
            name = "ita_attention_onepass" if i < 2 else decode
            checks.compare(name, got, want,
                           f"kv_cache engine on a {where}, output {i}")
        for part in ("k", "v", "k_scale", "v_scale", "pos"):
            got = getattr(caches[DEV], part).cpu()
            if not torch.equal(got, getattr(caches["cpu"], part)):
                raise AssertionError(f"kv_cache engine on a {where}: cache "
                                     f"{part} differs from the CPU's")
    log("[kv_cache] prefill_attend/decode_attend with per-head scales at "
        "16/16 heads of 128, ring and pool: outputs and caches equal the "
        "CPU's plain versions")


# ---------------------------------------------------------------------------
# Phase 3: full-width generate
# ---------------------------------------------------------------------------

class Recorder:
    """Stands in for a kernel wrapper inside ``ops``: forwards every call
    and keeps the inputs (cloned: the rings change in place later) and the
    output of the calls whose index is in ``keep``; ``by_rows`` counts the
    calls by query length (the first argument's rows). Calls made while a
    CUDA graph is captured are forwarded only: they run nothing then, and
    their replays never reach Python."""

    def __init__(self, fn, keep):
        self.fn, self.keep, self.calls, self.kept = fn, set(keep), 0, {}
        self.by_rows = {}

    def __call__(self, *args, **kw):
        import torch
        out = self.fn(*args, **kw)
        if torch.cuda.is_current_stream_capturing():
            return out          # a graph's capture runs nothing: no call
        sq = args[0].shape[1]
        self.by_rows[sq] = self.by_rows.get(sq, 0) + 1
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
                 loop="fused", gen=GEN, **kw):
    """One ``generate()`` of ``gen`` tokens (``kw``: its other options)
    with the launch counters zeroed just before and read just after;
    ``record`` names the ops wrapper to record."""
    from repro_torch.kernels.ita_attention import ops
    from repro_torch.runtime.generate import generate
    rec = None
    if record is not None:
        rec = Recorder(getattr(ops, record), keep)
        setattr(ops, record, rec)
    try:
        reset_launches()
        res = generate(model, cfg, prompts, gen, loop=loop, device=DEV,
                       **kw)
        launches = read_launches()
    finally:
        if rec is not None:
            setattr(ops, record, rec.fn)
    return res, launches, rec


def hold_to_stepwise(model, cfg, prompts, fused, want, label, record=None,
                     **kw):
    """Run ``label`` once more with ``loop="stepwise"``: its tokens and
    launches must equal the fused run's. Logs both loops' figures.
    Returns the run and, with ``record``, its ``Recorder`` of that
    wrapper: the stepwise loop makes every call eagerly, so its recorded
    calls are its launches, which is checked."""
    import torch
    step, launches, rec = run_generate(model, cfg, prompts, record=record,
                                       loop="stepwise", **kw)
    if launches != want or not torch.equal(step.tokens, fused.tokens):
        raise AssertionError(f"{label}: loop='stepwise' gave other tokens "
                             f"or launches ({launches}) than the fused loop")
    if rec is not None and rec.calls != launches[record]:
        raise AssertionError(f"{label}: {rec.calls} recorded {record} calls "
                             f"in the stepwise loop, {launches[record]} "
                             f"launches")
    log(f"[generate] {label} fused vs stepwise, tokens identical: decode "
        f"{fused.decode_tok_s:.1f} vs {step.decode_tok_s:.1f} tok/s, "
        f"prefill {fused.prefill_s:.3f} vs {step.prefill_s:.3f} s, "
        f"capture {fused.capture_s:.3f} s (none stepwise), graph pool "
        f"{fused.graph_bytes / 2**20:.1f} MiB; {card_line()}")
    return step, rec


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
    """The smoke-width configs on the card against the CPU's plain
    versions (qwen2-7b unpinned and with each pin, recurrentgemma-2b,
    rwkv6-7b, whisper-large-v3 and llama-3.2-vision-90b unpinned and
    onepass-pinned over a random frontend, their cross gates opened):
    prefill and two decode steps' logits within 5e-2 (float products
    round differently on the two devices, which can move an int8 step of
    the attention; RWKV's per-head group norm magnifies a rounding
    difference where a head's row cancels)."""
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.models import forward, init_caches, init_model
    for arch, backend in SMOKE_REFERENCE:
        cfg = get_config(arch, smoke=True, attention_impl="ita",
                         attention_backend=backend)
        gen = torch.Generator().manual_seed(1)
        tokens = torch.randint(0, cfg.vocab_size, (2, 20), generator=gen)
        frontend = torch.randn((2, cfg.n_frontend_tokens, cfg.frontend_dim),
                               generator=gen) if cfg.frontend_dim else None
        logits = {}
        for dev in ("cpu", "cuda"):
            model = open_gates(init_model(cfg, seed=3, device="cpu")).to(dev)
            caches = init_caches(cfg, 2, 24, device=dev)
            with torch.inference_mode():
                lg, caches = forward(
                    model, tokens, cfg, mode="prefill", caches=caches,
                    frontend=None if frontend is None else frontend.to(dev))
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
            raise AssertionError(f"{cfg.name} logits on the card differ "
                                 f"from the CPU's by {err} (pin {backend!r})")
        log(f"[reference] {cfg.name}, pin {backend or 'none'}: card vs CPU "
            f"logits max |d| {err:.3g}")


def open_gates(model):
    """The cross layers' gates set to ``CROSS_GATE`` (a zero gate, the
    reference's initial value, hides the cross layer)."""
    import torch
    with torch.no_grad():
        for blk in model.blocks:
            for gate in ("gate_attn", "gate_mlp"):
                if hasattr(blk, gate):
                    getattr(blk, gate).fill_(CROSS_GATE)
    return model


def full_width_model():
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.models import init_model
    cfg = get_config("qwen2-7b", attention_impl="ita",
                     layer_groups=((("attn",), QWEN2_LAYERS),), **WIDTH)
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
    step_a, _ = hold_to_stepwise(model, cfg, prompts, res_a2, want, "(a)")
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
    step_b, _ = hold_to_stepwise(model, cfg_b, prompts, res_b, want_b, "(b)")
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
    step_c, _ = hold_to_stepwise(model, cfg_c, prompts, res_c2, want_c, "(c)")
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
    return {"tokens": res_a2.tokens,
            "prefill_s": res_a2.prefill_s, "decode_tok_s":
            res_a2.decode_tok_s, "pinned_prefill_s": res_b.prefill_s,
            "pinned_decode_tok_s": res_b.decode_tok_s,
            "twopass_prefill_s": res_c2.prefill_s,
            "twopass_decode_tok_s": res_c2.decode_tok_s,
            "stepwise_decode_tok_s": (step_a.decode_tok_s,
                                      step_b.decode_tok_s,
                                      step_c.decode_tok_s),
            "capture_s": res_a.capture_s,
            "step_s": res_a2.decode_s / res_a2.decode_steps,
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

def serve_trace(cfg, seed=7, spec=SERVE):
    """The served trace of ``spec``'s sizes: numpy from ``seed``."""
    import numpy as np

    from repro_torch.runtime.generate import ServeRequest
    rng = np.random.default_rng(seed)
    reqs, t = [], 0
    for _ in range(spec["requests"]):
        plen = int(rng.integers(spec["plen"][0], spec["plen"][1] + 1))
        reqs.append(ServeRequest(
            prompt=rng.integers(0, cfg.vocab_size, plen).astype(np.int32),
            gen=int(rng.integers(spec["gen"][0], spec["gen"][1] + 1)),
            arrival=t))
        t += int(rng.integers(spec["gap"][0], spec["gap"][1] + 1))
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
    stall, stall_captured = stall_serve(model, cfg_pin, reqs, res, checks)
    recs = sampled_serve(model, cfg, reqs, res, launches, max_len)

    captured = dict(stall_captured)
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
    launches = {**launches,
                STALL_PREFILL: stall["launches"]["ita_attention_onepass"],
                STALL_DECODE: stall["launches"]["ita_attention_onepass_paged"]}
    return {"tok_s": res.tok_s, "wall_s": res.wall_s,
            "ttft_p50": res.ttft_quantile(0.5),
            "ttft_p90": res.ttft_quantile(0.9),
            "mean_ms": served_mean, "stall": stall,
            "tokens": {c.index: c.tokens for c in res.completed}}, \
        launches, captured


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
    held against their plain versions and returned for phase 6."""
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
            "prefill_stall_s": res.prefill_stall_s, "launches": launches}, {
        STALL_PREFILL: recs["ita_attention_onepass"].kept[idx],
        STALL_DECODE: recs["ita_attention_onepass_paged"].kept[0]}


def prefixed_trace(cfg, reqs):
    """The served trace with one shared ``SYSTEM_PREFIX``-token prefix
    (numpy seed 11) before every prompt."""
    import numpy as np
    system = np.random.default_rng(11).integers(
        0, cfg.vocab_size, SYSTEM_PREFIX).astype(np.int32)
    return [dataclasses.replace(r, prompt=np.concatenate([system, r.prompt]))
            for r in reqs]


def serve_kw(**more):
    return {**dict(slots=SERVE["slots"], segment=SERVE["segment"],
                   page_size=SERVE["page_size"], num_pages=SERVE["num_pages"],
                   chunk_size=SERVE["chunk_size"], debug_invariants=True,
                   device=DEV), **more}


def hold_to(res, want, label):
    """Every request of ``res`` has the tokens of ``want`` (index ->
    tokens)."""
    import numpy as np
    for c in res.completed:
        if not np.array_equal(c.tokens, want[c.index]):
            first = int(np.flatnonzero(c.tokens != want[c.index])[0])
            raise AssertionError(f"{label}: request {c.index}'s tokens "
                                 f"differ at {first}")


def solo_tokens(model, cfg, reqs, max_len, **kw):
    """Each request alone through ``generate()`` (onepass pin, fused loop)
    at the serve's ``max_len``: index -> tokens."""
    import torch

    from repro_torch.runtime.generate import generate
    cfg_pin = dataclasses.replace(cfg, attention_backend="ita_onepass_pallas")
    return {i: generate(model, cfg_pin, torch.as_tensor(r.prompt)[None],
                        r.gen, max_len=max_len, device=DEV,
                        **{k: f(i) for k, f in kw.items()}
                        ).tokens[0].cpu().numpy()
            for i, r in enumerate(reqs)}


def serve_line(res):
    return (f"prefix_hits {res.prefix_hits}, shared_prefix_tokens "
            f"{res.shared_prefix_tokens}, prefill_tokens "
            f"{res.prefill_tokens}, {res.steps} steps, {res.segments} "
            f"segments, {res.admission_rounds} rounds, wall {res.wall_s:.3f} "
            f"s, {res.tok_s:.2f} tok/s, TTFT p50 "
            f"{res.ttft_quantile(0.5):.3f} s")


def prefix_serve(model, cfg, reqs):
    """The trace with a shared system prefix, served with
    ``prefix_sharing=True`` (its steps replayed from CUDA graphs) and
    without: every request's tokens equal in both and equal solo
    ``generate()``; at least one admission adopted shared pages; the
    allocator invariants, pins included, held in every layer after every
    round and after each serve. Returns the prefixed trace and its solo
    tokens."""
    from repro_torch.runtime.generate import serve_continuous
    preqs = prefixed_trace(cfg, reqs)
    reset_launches()
    on = serve_continuous(model, cfg, preqs, prefix_sharing=True,
                          **serve_kw())
    launches = read_launches()
    off = serve_continuous(model, cfg, preqs, **serve_kw())
    if any(launches[name] <= 0 for name in PAGED):
        raise AssertionError(f"prefix serve: a paged kernel did not run: "
                             f"{launches}")
    if on.prefix_hits <= 0 or off.prefix_hits != 0 \
            or len(on.completed) != len(preqs) != len(off.completed):
        raise AssertionError(f"prefix serve: {on.prefix_hits} hits, "
                             f"{len(on.completed)} completed")
    max_len = max(r.prompt.size + r.gen for r in preqs)
    solo = solo_tokens(model, cfg, preqs, max_len)
    hold_to(on, solo, "prefix serve vs solo generate()")
    hold_to(off, solo, "prefix-off serve vs solo generate()")
    log(f"[prefix] {len(preqs)} requests behind one {SYSTEM_PREFIX}-token "
        f"system prefix: every request's tokens equal with sharing on, off "
        f"and solo generate() (onepass pin, max_len {max_len}); allocator "
        f"invariants with pins held in all {cfg.n_layers} layers after every "
        f"round and after each serve; launches {launches}")
    log(f"[prefix] sharing on: {serve_line(on)}; {card_line()}")
    log(f"[prefix] sharing off: {serve_line(off)}; {card_line()}")
    return preqs, solo, max_len


def recording_injector():
    """``ServeFaultInjector`` replaced by a subclass that keeps each
    instance, so the serve's injector can be read after it."""
    from repro_torch.runtime import fault_tolerance as FT
    made = []

    class Kept(FT.ServeFaultInjector):
        def __init__(self, plan):
            super().__init__(plan)
            made.append(self)
    FT.ServeFaultInjector = Kept
    return made, lambda: setattr(FT, "ServeFaultInjector",
                                 Kept.__mro__[1])


def overload_serve(model, cfg, preqs, solo, max_len, checks):
    """The prefixed trace under overload: requests ``i % 3 == 2`` in class
    1, the rest class 0, with preemption, prefix sharing, aging and the
    seeded ``OVERLOAD_PLAN``. At least two preemptions, at least one of
    them by priority (more preemptions than kills); every request's
    greedy tokens equal solo ``generate()``. Then the first six requests
    sampled (temperature 0.8, seed 11; eager steps) under the same plan:
    at least one is preempted, and each equals solo fused ``generate()``
    drawing from its generator; layer 0's B3 call of an adopted row's
    first mixed step (its chunk starts at the shared pages' end) is held
    to its plain version."""
    from repro_torch.launch.steps import request_generator
    from repro_torch.runtime.fault_tolerance import ServeFaultPlan
    from repro_torch.runtime.generate import serve_continuous
    oreqs = [dataclasses.replace(r, priority=int(i % 3 == 2))
             for i, r in enumerate(preqs)]
    plan = ServeFaultPlan(**OVERLOAD_PLAN)
    kw = serve_kw(prefix_sharing=True, preemption=True, faults=plan,
                  aging_steps=AGING_STEPS)
    made, restore = recording_injector()
    try:
        res = serve_continuous(model, cfg, oreqs, **kw)
    finally:
        restore()
    inj = made[-1]
    if len(res.completed) != len(oreqs) or res.preemptions < 2 \
            or inj.kills_requested < 1 \
            or res.preemptions <= inj.kills_requested:
        raise AssertionError(f"overload serve: {res.preemptions} "
                             f"preemptions, {inj.kills_requested} kills, "
                             f"{len(res.completed)} completed")
    hold_to(res, solo, "overload serve vs solo generate()")
    victims = {c.index: c.priority for c in res.completed if c.preemptions}
    log(f"[overload] plan {OVERLOAD_PLAN}, aging_steps {AGING_STEPS}, "
        f"classes 1 for i % 3 == 2: {res.preemptions} preemptions "
        f"({inj.kills_requested} kill, {inj.pressure_events} pressure "
        f"spike, {inj.straggle_events} injected sleep), preempted requests "
        f"(index: class) {victims}, straggler_segments "
        f"{res.straggler_segments}; every request's greedy tokens equal "
        f"solo generate(); invariants with pins held in all "
        f"{cfg.n_layers} layers after every round")
    log(f"[overload] {serve_line(res)}; class_summary "
        f"{json.dumps(res.class_summary())}; {card_line()}")

    # sampled, first six requests: all layer-0 B3 calls kept (eager steps)
    n_layers = cfg.n_layers
    rec = recording(("ita_attention_onepass_paged",),
                    keep=range(0, n_layers * 8192, n_layers))
    rec = rec["ita_attention_onepass_paged"]
    adopted, seen = [], [None] * SERVE["slots"]

    def audit(caches, slot_req, pins):
        # a slot newly taken whose stream starts past 0 adopted pages
        pos = caches[0]["mix"].pos.tolist()
        for s, i in enumerate(slot_req):
            if i is not None and i != seen[s] and pos[s] > 0:
                adopted.append((rec.calls, s, pos[s]))
        seen[:] = slot_req
    made, restore = recording_injector()
    try:
        sampled = serve_continuous(model, cfg, oreqs[:6], temperature=0.8,
                                   seed=11, audit=audit, **kw)
    finally:
        restore()
        unrecord({"ita_attention_onepass_paged": rec})
    gens = solo_tokens(model, cfg, oreqs[:6],
                       max(r.prompt.size + r.gen for r in oreqs[:6]),
                       temperature=lambda i: 0.8,
                       generator=lambda i: request_generator(11, i, DEV))
    hold_to(sampled, gens, "sampled overload serve vs solo generate()")
    pre = {c.index: c.preemptions for c in sampled.completed if c.preemptions}
    if not pre:
        raise AssertionError("sampled overload serve: nothing preempted")
    idx, what = first_adopted_call(rec, adopted, n_layers)
    check_recorded(checks, "ita_attention_onepass_paged", rec, idx, what)
    log(f"[overload] sampled (temperature 0.8, seed 11; steps eager), "
        f"requests 0-5 under the same plan: {sampled.preemptions} "
        f"preemptions ({made[-1].kills_requested} kill), preempted "
        f"(index: times) {pre}; every request's tokens equal solo fused "
        f"generate() drawing from its generator; {serve_line(sampled)}; "
        f"B3 over adopted pages ({what}) bit-exact vs plain; {card_line()}")
    return {"tok_s": res.tok_s, "wall_s": res.wall_s,
            "preemptions": res.preemptions, "sampled_tokens": gens}


def first_adopted_call(rec, adopted, n_layers):
    """The first kept layer-0 B3 call in which a row that adopted shared
    pages prefills its first chunk: its ``q_offset`` is the adopted token
    count (> 0) and its ``q_len`` > 0. Returns ``(index, label)``."""
    import torch
    for calls, slot, pos in adopted:
        for idx in sorted(i for i in rec.kept if i >= calls):
            _, kw, _ = rec.kept[idx]
            hq = kw.get("hq") or kw.get("kv_rep", 1)

            def row(x):
                return int(torch.as_tensor(x).reshape(-1)[::hq][slot])
            if row(kw["q_len"]) > 0:
                if row(kw["q_offset"]) != pos:
                    break          # this row's first chunk is not kept
                return idx, (f"layer 0 of step {idx // n_layers}, slot "
                             f"{slot}: "
                             f"q_offset {pos} over shared pages, q_len "
                             f"{row(kw['q_len'])}")
    raise AssertionError(f"no adopted row's first mixed step was kept "
                         f"({adopted})")


def cow_step(model, cfg, checks):
    """Copy-on-write inside a captured mixed step, at full width. Slot 0
    prefills a 256-token prompt into both pages of a 2-page window and
    finishes (its pages stay); slot 1 adopts its first page and prefills
    a 320-token stream of the same leading tokens in 64-token chunks, so
    its third step wraps onto the shared page and copies it first. The
    steps replayed from a CUDA graph (the copy in the second replay) give
    the eager steps' bits in every tensor of the carry; layer 0's B3 call
    right after the copy (eager) is held to its plain version; the
    copied page belongs to slot 1 alone and the invariants hold."""
    import numpy as np
    import torch

    from repro_torch.launch.steps import (CapturedSteps, ServeSlotState,
                                          admit_chunked, make_serve_segment,
                                          tree_leaves)
    from repro_torch.models import init_caches
    from repro_torch.runtime.generate import _adopt_prefix_slots
    page, chunk, n_layers = 128, 64, cfg.n_layers
    stream = np.random.default_rng(5).integers(
        0, cfg.vocab_size, (1, 320)).astype(np.int32)

    def seg(segment, graphs=None):
        return make_serve_segment(cfg, segment=segment, sample=False,
                                  eos_id=None, pad_id=0, chunk=chunk,
                                  budget=chunk + 1, graphs=graphs)

    def start():
        caches = init_caches(cfg, 2, 2 * page, paged=True, page_size=page,
                             num_pages=6, device=DEV)
        state = admit_chunked(ServeSlotState.init(2, 320, DEV), [0],
                              stream, [256], [1])
        _, _, _, state, caches, _ = seg(4)(model, state, caches, 1.0)
        shared = caches[0]["mix"].page_table[0, 0].item()
        caches = _adopt_prefix_slots(caches, [1], [[shared, 0]], [1],
                                     [page])
        state = admit_chunked(state, [1], stream, [320], [4], shared=[page])
        return caches, state, shared

    with torch.inference_mode():
        eager, graph = start(), start()
        shared = eager[2]
        carry_e, carry_g = eager[:2], graph[:2]
        step_e, graphs = seg(1), CapturedSteps(DEV)
        step_g = seg(1, graphs)
        # calls counted: eager step 1, the graph's warm-up, eager steps 2
        # and 3 (replays and the capture never reach Python)
        rec = recording(("ita_attention_onepass_paged",),
                        keep=(3 * n_layers,))
        try:
            for i in range(3):
                toks_e, _, _, st_e, c_e, _ = step_e(model, carry_e[1],
                                                    carry_e[0], 1.0)
                carry_e = (c_e, st_e)
                toks_g, _, _, st_g, c_g, _ = step_g(model, carry_g[1],
                                                    carry_g[0], 1.0)
                carry_g = (c_g, st_g)
                torch.cuda.synchronize()
                for a, b in zip(tree_leaves((carry_e, toks_e)),
                                tree_leaves((carry_g, toks_g)), strict=True):
                    if not torch.equal(a, b):
                        raise AssertionError(f"COW step {i}: the captured "
                                             f"step differs from eager")
        finally:
            unrecord(rec)
    pool = carry_e[0][0]["mix"]
    table, ref = pool.page_table.tolist(), pool.ref_count.tolist()
    if table[0][0] != shared or table[1][0] == shared or ref[shared] != 1:
        raise AssertionError(f"no copy on write: tables {table}, shared "
                             f"page {shared} refcount {ref[shared]}")
    for c in carry_e[0]:
        c["mix"].check_invariants()
    check_recorded(checks, "ita_attention_onepass_paged",
                   rec["ita_attention_onepass_paged"], 3 * n_layers,
                   "layer 0 of the step that copied a shared page")
    log(f"[cow] slot 1 wrapped onto page {shared}, shared with slot 0, in "
        f"its third mixed step and copied it to page {table[1][0]}: the "
        f"step replayed from a CUDA graph equals the eager step in every "
        f"tensor (pools, tables, refcounts, free stacks, slot state, "
        f"tokens) over 3 steps; layer 0's B3 call after the copy bit-exact "
        f"vs plain; invariants held in all {n_layers} layers; "
        f"{card_line()}")


# ---------------------------------------------------------------------------
# Phase 5, crash-safe serving: journal, snapshots, recovery, drain
# ---------------------------------------------------------------------------

def recorded_after_restore(names):
    """``Recorder``s in place of the ops wrappers ``names`` that keep the
    first call after every ``Checkpointer.restore`` (the warm restore's
    first read of the restored pools). Returns ``(recs, undo)``."""
    from repro_torch.checkpoint import checkpointing as CK
    recs = recording(names, keep=())
    restore = CK.Checkpointer.restore

    def marked(self, *args, **kw):
        out = restore(self, *args, **kw)
        for rec in recs.values():
            rec.keep.add(rec.calls)
        return out
    CK.Checkpointer.restore = marked

    def undo():
        CK.Checkpointer.restore = restore
        unrecord(recs)
    return recs, undo


def timed_journal():
    """``ServeJournal.flush`` and ``close`` wrapped to sum their wall time
    (``close`` holds the last flush and the final fsync). Returns
    ``(spent, undo)``, ``spent`` mapping each name to [calls, seconds]."""
    from repro_torch.runtime.journal import ServeJournal
    spent = {"flush": [0, 0.0], "close": [0, 0.0]}
    originals = {name: getattr(ServeJournal, name) for name in spent}

    def timed(name):
        def run(self):
            t = time.perf_counter()
            try:
                return originals[name](self)
            finally:
                spent[name][0] += 1
                spent[name][1] += time.perf_counter() - t
        return run
    for name in spent:
        setattr(ServeJournal, name, timed(name))
    return spent, lambda: [setattr(ServeJournal, name, fn)
                           for name, fn in originals.items()]


def journal_overhead(model, cfg, reqs, want):
    """The phase's chunked serve with a journal (in a temporary directory)
    and without, in two pairs (on, off; off, on): tokens equal the
    journal-off serve's; walls and tok/s of each, the journal-on overhead
    from the fastest of each side, and the wall the journal's own writes
    took on the caller."""
    import tempfile

    from repro_torch.runtime.generate import serve_continuous
    runs = {"on": [], "off": []}
    spent, undo = timed_journal()
    try:
        for side in ("on", "off", "off", "on"):
            with tempfile.TemporaryDirectory() as d:
                res = serve_continuous(
                    model, cfg, reqs, **serve_kw(
                        debug_invariants=False,
                        journal_dir=d if side == "on" else None))
            if len(res.completed) != len(reqs):
                raise AssertionError(f"journal {side}: {len(res.completed)} "
                                     f"of {len(reqs)} requests completed")
            hold_to(res, want, f"journal-{side} serve vs the chunked serve")
            runs[side].append(res)
    finally:
        undo()
    best = {side: min(r.wall_s for r in rs) for side, rs in runs.items()}
    for side, rs in runs.items():
        log(f"[journal] journal {side}: walls "
            f"{', '.join(f'{r.wall_s:.3f}' for r in rs)} s, tok/s "
            f"{', '.join(f'{r.tok_s:.2f}' for r in rs)}, capture "
            f"{', '.join(f'{r.capture_s:.3f}' for r in rs)} s; "
            f"{card_line()}")
    log(f"[journal] {len(reqs)} requests, every token equal with the journal "
        f"on and off; journal-on overhead (fastest walls) "
        f"{(best['on'] / best['off'] - 1) * 100:.2f}%; the journal's writes "
        f"on the caller over both journal-on serves: {spent['flush'][0]} "
        f"flushes in {spent['flush'][1] * 1e3:.3f} ms, {spent['close'][0]} "
        f"closes (last flush and fsync) in {spent['close'][1] * 1e3:.3f} "
        f"ms; {card_line()}")
    return best


def crash_and_warm_restore(model, cfg, preqs, solo, checks):
    """The prefixed trace, sharing and preemption on, a snapshot every
    ``SNAPSHOT_EVERY`` segments, through ``serve_with_recovery``: attempt
    1 crashes at the round of step ``CRASHES[0]`` (after a snapshot),
    attempt 2 after the readback of step ``CRASHES[1]`` (after its own
    snapshot, before the flush), attempt 3 runs clean from a warm restore.
    Tokens equal the calm prefix serve's (solo ``generate()``); B3's and
    B4p's first calls after each restore are held to their plain
    versions; the paged kernels ran (counters zeroed just before, read
    just after)."""
    import tempfile

    from repro_torch.runtime.fault_tolerance import ServeFaultPlan
    from repro_torch.runtime.journal import serve_with_recovery
    plans = (ServeFaultPlan(crash_steps=(CRASHES[0],)),
             ServeFaultPlan(crash_after_steps=(CRASHES[1],)))
    recs, undo = recorded_after_restore(PAGED)
    try:
        with tempfile.TemporaryDirectory() as d:
            reset_launches()
            res, crashes = serve_with_recovery(
                model, cfg, preqs, journal_dir=d, plans=plans,
                **serve_kw(prefix_sharing=True, preemption=True,
                           snapshot_every=SNAPSHOT_EVERY))
            launches = read_launches()
    finally:
        undo()
    if crashes != 2 or not res.restored_from_snapshot \
            or len(res.completed) != len(preqs):
        raise AssertionError(f"crash and warm restore: {crashes} crashes, "
                             f"restored {res.restored_from_snapshot}, "
                             f"{len(res.completed)} completed")
    if any(launches[name] <= 0 for name in PAGED):
        raise AssertionError(f"recovered serve: a paged kernel did not run: "
                             f"{launches}")
    hold_to(res, solo, "recovered prefix serve vs the calm prefix serve")
    for name, rec in recs.items():
        if not rec.kept:
            raise AssertionError(f"{name}: no call after a restore kept")
        for idx in sorted(rec.kept):
            check_recorded(checks, name, rec, idx,
                           f"first call after a warm restore (call {idx})")
    per_snap = res.snapshot_s / max(res.snapshots, 1)
    log(f"[recovery] plans {[p.crash_steps or p.crash_after_steps for p in plans]}"
        f" (round boundary, then mid-segment): {crashes} crashes survived, "
        f"warm restore from the snapshot of the pools and the prefix index; "
        f"every token equal to the calm prefix serve; the first B3 and B4p "
        f"calls after each restore bit-exact vs plain; launches {launches}")
    log(f"[recovery] last attempt: recovery_s {res.recovery_s:.4f} (replay "
        f"+ restore), recapture (capture_s) {res.capture_s:.3f} s, "
        f"replayed_tokens {res.replayed_tokens}, {res.snapshots} snapshots "
        f"of {res.snapshot_bytes} bytes, caller blocked "
        f"{per_snap * 1e3:.2f} ms per snapshot (device->host copy, crc32); "
        f"{serve_line(res)}; {card_line()}")
    return {"recovery_s": res.recovery_s, "capture_s": res.capture_s,
            "snapshot_bytes": res.snapshot_bytes, "snapshot_ms": per_snap * 1e3,
            "replayed_tokens": res.replayed_tokens}


def corrupt_snapshot(model, cfg, preqs, solo):
    """The first six prefixed requests, sharing on, a snapshot every
    ``SNAPSHOT_EVERY`` segments, crashed at the round of step
    ``CRASHES[0]``; a byte of the newest snapshot's first leaf flipped;
    the resume starts cold (``restored_from_snapshot`` false) with the
    calm tokens."""
    import os
    import tempfile

    from repro_torch.runtime.fault_tolerance import ServeFaultPlan
    from repro_torch.runtime.fault_tolerance import SimulatedCrash
    from repro_torch.runtime.generate import serve_continuous
    kw = serve_kw(prefix_sharing=True, snapshot_every=SNAPSHOT_EVERY)
    with tempfile.TemporaryDirectory() as d:
        try:
            serve_continuous(model, cfg, preqs[:6], journal_dir=d,
                             faults=ServeFaultPlan(crash_steps=(CRASHES[0],)),
                             **kw)
            raise AssertionError("corrupt snapshot: the serve did not crash")
        except SimulatedCrash:
            pass
        snaps = sorted(os.listdir(os.path.join(d, "snapshots")))
        leaf = os.path.join(d, "snapshots", snaps[-1], "leaf_00000.npy")
        raw = bytearray(open(leaf, "rb").read())
        raw[-1] ^= 0xFF
        open(leaf, "wb").write(bytes(raw))
        res = serve_continuous(model, cfg, preqs[:6], journal_dir=d,
                               resume=True, **kw)
    if not res.recovered or res.restored_from_snapshot \
            or len(res.completed) != 6:
        raise AssertionError(f"corrupt snapshot: recovered {res.recovered}, "
                             f"restored {res.restored_from_snapshot}")
    hold_to(res, solo, "cold start after a corrupt snapshot")
    log(f"[recovery] corrupt snapshot ({snaps[-1]}, a byte of leaf 0 "
        f"flipped): cold start from the journal, every token equal; "
        f"replayed_tokens {res.replayed_tokens}, recovery_s "
        f"{res.recovery_s:.4f}; {serve_line(res)}; {card_line()}")


def sampled_recovery(model, cfg, preqs, want):
    """The first six prefixed requests sampled (temperature 0.8, seed 11;
    eager steps), sharing on, snapshots, crashed after the readback of
    step ``CRASHES[1]`` and recovered: tokens equal the calm sampled
    serve's (the journaled states of the requests' CUDA generators)."""
    import tempfile

    from repro_torch.runtime.fault_tolerance import ServeFaultPlan
    from repro_torch.runtime.journal import serve_with_recovery
    with tempfile.TemporaryDirectory() as d:
        res, crashes = serve_with_recovery(
            model, cfg, preqs[:6], journal_dir=d,
            plans=(ServeFaultPlan(crash_after_steps=(CRASHES[1],)),),
            **serve_kw(prefix_sharing=True, snapshot_every=SNAPSHOT_EVERY,
                       temperature=0.8, seed=11))
    if crashes != 1 or len(res.completed) != 6:
        raise AssertionError(f"sampled recovery: {crashes} crashes, "
                             f"{len(res.completed)} completed")
    hold_to(res, want, "sampled recovery vs the calm sampled serve")
    log(f"[recovery] sampled (temperature 0.8, seed 11), requests 0-5, "
        f"crashed after the readback of step {CRASHES[1]}: every token "
        f"equal to the calm sampled serve; restored_from_snapshot "
        f"{res.restored_from_snapshot}, replayed_tokens "
        f"{res.replayed_tokens}; {serve_line(res)}; {card_line()}")


def drain_and_resume(model, cfg, preqs, solo):
    """The first six prefixed requests drained at step ``DRAIN_AFTER`` (no
    more admissions; in-flight requests finish), then resumed: each run's
    tokens equal the calm ones, together they cover every request, and
    the resume serves none twice."""
    import tempfile

    from repro_torch.runtime.generate import serve_continuous
    from repro_torch.runtime.journal import ServeDrain
    kw = serve_kw(prefix_sharing=True)
    with tempfile.TemporaryDirectory() as d:
        drained = serve_continuous(model, cfg, preqs[:6], journal_dir=d,
                                   drain=ServeDrain(after_steps=DRAIN_AFTER),
                                   **kw)
        rest = serve_continuous(model, cfg, preqs[:6], journal_dir=d,
                                resume=True, **kw)
    done = {c.index for c in drained.completed}
    again = {c.index for c in rest.completed if not c.replayed}
    if not drained.drained or not 0 < len(done) < 6 \
            or len(rest.completed) != 6 or again & done:
        raise AssertionError(f"drain: drained {drained.drained}, done "
                             f"{sorted(done)}, served again {sorted(again)}")
    hold_to(drained, solo, "drained serve")
    hold_to(rest, solo, "resume after the drain")
    log(f"[recovery] drain at step {DRAIN_AFTER}: requests {sorted(done)} "
        f"finished in {drained.steps} steps, the resume served "
        f"{sorted(again)} (replayed_tokens {rest.replayed_tokens}); every "
        f"token equal to the calm serve; {card_line()}")


def recovery_phase(model, cfg, reqs, chunked, preqs, solo, sampled, checks):
    """Crash-safe serving at full width (module docstring, phase 5)."""
    best = journal_overhead(model, cfg, reqs, chunked)
    out = crash_and_warm_restore(model, cfg, preqs, solo, checks)
    corrupt_snapshot(model, cfg, preqs, solo)
    sampled_recovery(model, cfg, preqs, sampled)
    drain_and_resume(model, cfg, preqs, solo)
    return {**out, "journal_on_wall_s": best["on"],
            "journal_off_wall_s": best["off"]}


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
    on this card: ``(ms, "bytes" or "operations")``
    (``repro_torch.roofline.analysis.least_ms``, the H100's peaks)."""
    from repro_torch.roofline.analysis import least_ms
    return least_ms(nbytes, ops)


def weight_floor(nbytes):
    """Milliseconds to read ``nbytes`` once from this card's HBM
    (``repro_torch.roofline.analysis.weight_floor_ms``)."""
    from repro_torch.roofline.analysis import weight_floor_ms
    return weight_floor_ms(nbytes)


def bound_ms(name, args, kw):
    """The least time for a ring or paged call's work on this card
    (``repro_torch.roofline.op_costs.attention_work``: each input read
    once, only the K/V prefix the rows' masks can reach, the output
    written once, against the visible pairs' integer ops)."""
    from repro_torch.roofline.op_costs import attention_work
    return roofline(*attention_work(name, args, kw))


def twopass_bounds(args, kw):
    """Least times of the two passes of a twopass call
    (``op_costs.twopass_work``)."""
    from repro_torch.roofline.op_costs import twopass_work
    return tuple(roofline(*w) for w in twopass_work(args, kw))


def softmax_bound(x, mask):
    """Least time of a standalone softmax call (``op_costs.softmax_work``:
    x read only where the mask is set, the mask read and the f32 output
    written at every element, ~10 integer ops per unmasked element)."""
    from repro_torch.roofline.op_costs import softmax_work
    return roofline(*softmax_work(x, mask))


def profile_run(label, fn):
    """Device time by kernel over one call of ``fn`` (``torch.profiler``,
    device activity only: host op records would cost more than the run),
    the device's busy share of its wall time (the profiler's own host
    cost inflates the wall time) and the kernels launched. The device
    events are summed from the profiler's raw records: ``key_averages()``
    over a train step's ~200,000 kernels takes ~40 s. Returns what ``fn``
    returned and the busy share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = {}                         # name -> [device ms, launches]
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            k = kernels.setdefault(e.name(), [0.0, 0])
            k[0] += e.duration_ns() / 1e6
            k[1] += 1
    busy_ms = sum(ms for ms, _ in kernels.values())
    n = sum(c for _, c in kernels.values())
    log(f"[profile] {label}: wall {wall_ms:.1f} ms, device busy "
        f"{busy_ms:.1f} ms ({busy_ms / wall_ms:.1%}), {n} kernel launches; "
        f"top kernels by device time:")
    for name, (ms, c) in sorted(kernels.items(), key=lambda kv: -kv[1][0])[
            :10]:
        log(f"[profile]   {ms:9.2f} ms {c:6d} x  {name[:90]}")
    for kernel in ("onepass_kernel", "decode_kernel"):
        found = [v for name, v in kernels.items() if kernel in name]
        ms = sum(v[0] for v in found)
        c = sum(v[1] for v in found)
        if c:
            log(f"[profile] {label}: {kernel} {ms:.2f} ms over {c} "
                f"launches ({ms / c:.5f} ms each), {ms / busy_ms:.1%} of "
                f"device time")
    return out, busy_ms / wall_ms


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
    res, _ = profile_run(
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
    the stall serve's ragged admission prefill (``stall_prefill``), with
    the launches of its own prefill calls; B3's row the stall serve's
    decode-shaped call (``stall_decode``); each sub-row its excess,
    launches x (graph - bound). Each paged kernel's row carries its mean
    time per launch over the serve (``serve_mean_ms``)."""
    rows, sub = [], {}
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
        if name in SUBROWS:
            sub[name] = {"ms": ms, "graph_ms": graph, "plain_ms": plain,
                         "bound_ms": bms, "bound_by": by,
                         "launches": launches[name],
                         "excess_ms": launches[name] * (graph - bms)}
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
    for name, (kernel, key) in SUBROWS.items():
        row = next(r for r in rows if r["name"] == kernel)
        row[key] = sub[name]
    for row in rows:
        if row["name"] == "ita_attention_onepass":
            row["prefill_launches"] = row["launches"] \
                - row["decode"]["launches"]
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
    """Least time of one B7a call (``op_costs.matmul_work``)."""
    from repro_torch.roofline.op_costs import matmul_work
    return roofline(*matmul_work(m, k, n))


def ws_bound(m, k, n, block_k=128):
    """Least time of one B7b call (``op_costs.ws_work``: the int32
    partial sums read and written once per k tile; the kernel's re-reads
    of w, once per m range, are its own design's cost, logged beside the
    [psum] bytes)."""
    from repro_torch.roofline.op_costs import ws_work
    return roofline(*ws_work(m, k, n, block_k))


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


# ---------------------------------------------------------------------------
# Phase 8: the paper's baselines and gemma2-27b (the XLA backends)
# ---------------------------------------------------------------------------

GEMMA2_LONG, GEMMA2_LONG_GEN = 4608, 16  # run (ii): the local rings wrap
# run (ii)'s depth: 1 (local, global) period of gemma2-27b's 23, widths
# unchanged (cut from 4 periods to keep the script inside its time once
# phase 11 was added)
GEMMA2_LONG_PERIODS = 1
# run (i)'s depth: 8 of gemma2-27b's 23 (local, global) periods, widths
# unchanged (cut from all 23 to keep the script inside its time once
# phase 12 was added)
GEMMA2_PERIODS = 8


def served_by(fn):
    """Call ``fn`` with every registered backend's ``run`` counted by
    (backend, mode): the backends that served its attention calls. Calls
    run eagerly (prefill, a stepwise step, a captured step's warm-up and
    capture) are counted; replays never reach Python. Returns ``(fn's
    result, {(backend, mode): calls})``."""
    from repro_torch import attention as ATT
    seen = {}

    def counted(b):
        def run(q, k, v, spec, scales, **kw):
            seen[(b.name, spec.mode)] = seen.get((b.name, spec.mode), 0) + 1
            return b.run(q, k, v, spec, scales, **kw)
        return dataclasses.replace(b, run=run)
    originals = ATT.all_backends()
    for b in originals:
        ATT.register_backend(counted(b))
    try:
        out = fn()
    finally:
        for b in originals:
            ATT.register_backend(b)
    return out, seen


def check_served(seen, want, label, required=("prefill", "decode")):
    """``want``: mode -> the one backend that may serve it; each mode of
    ``required`` must have been served."""
    modes = {mode for _, mode in seen}
    if any(want.get(mode) != name for name, mode in seen) \
            or not modes >= set(required):
        raise AssertionError(f"{label}: served by {seen}, want {want} "
                             f"for {required}")


def last_logits(model, cfg, prompts):
    """Logits (float32) of each prompt's last position after a prefill
    through the ring caches."""
    import torch

    from repro_torch.models import forward, init_caches
    from repro_torch.models.layers import unembed
    with torch.inference_mode():
        x, _ = forward(model, prompts.to(DEV), cfg, mode="prefill",
                       caches=init_caches(cfg, prompts.shape[0],
                                          prompts.shape[1], device=DEV),
                       skip_unembed=True)
        return unembed(model.unembed_weight(), x[:, -1:],
                       cfg.logit_softcap)[:, 0]


def baseline_generate(model, cfg, prompts, gen, want_served, label):
    """``generate()`` fused twice (the first call captures the decode
    step, the second replays the kept graph: the steady-state figures)
    and stepwise, each with the launch counters zeroed just before and
    read just after (no fused attention kernel may launch) and the
    backends that served it counted; all three give the same tokens.
    Then one more fused call under the profiler (busy share, device time
    by kernel). Returns the kept-graph result and its figures."""
    import torch

    from repro_torch.runtime.generate import generate

    def run(loop, required=("prefill", "decode")):
        reset_launches()
        res, seen = served_by(lambda: generate(model, cfg, prompts, gen,
                                               loop=loop, device=DEV))
        launches = read_launches()
        moved = {k: n for k, n in launches.items() if n}
        if moved:
            raise AssertionError(f"{label} ({loop}): kernels launched "
                                 f"{moved}")
        check_served(seen, want_served, f"{label} ({loop})", required)
        return res, seen
    first, seen = run("fused")
    # the kept graph replays every decode step: only prefill reaches Python
    fused, _ = run("fused", required=("prefill",))
    step, _ = run("stepwise")
    tok = fused.tokens
    if not (torch.equal(tok, step.tokens) and torch.equal(tok, first.tokens)):
        raise AssertionError(f"{label}: fused and stepwise tokens differ")
    if tok.shape != (prompts.shape[0], gen) or tok.min() < 0 \
            or tok.max() >= cfg.vocab_size:
        raise AssertionError(f"{label}: bad tokens {tuple(tok.shape)}")
    _, busy = profile_run(f"{label} fused generate", lambda: generate(
        model, cfg, prompts, gen, device=DEV))
    step_ms = 1e3 * fused.decode_s / fused.decode_steps
    log(f"[baselines] {label}: served by {seen} (eager calls of the "
        f"capturing call); fused, fused again and stepwise tokens "
        f"identical; prefill {fused.prefill_s:.3f} s, decode "
        f"{fused.decode_tok_s:.1f} tok/s from the kept graph "
        f"({step_ms:.2f} ms a step; the capturing call "
        f"{first.decode_tok_s:.1f} tok/s, capture {first.capture_s:.3f} s)"
        f" vs {step.decode_tok_s:.1f} stepwise; busy {busy:.1%}; "
        f"{card_line()}")
    return fused, {"prefill_s": fused.prefill_s,
                   "decode_tok_s": fused.decode_tok_s,
                   "stepwise_decode_tok_s": step.decode_tok_s,
                   "capture_s": first.capture_s, "busy": busy,
                   "step_ms": step_ms}


def baselines_at_full_width(model, cfg, ita_tokens):
    """Phase 8a: the float and I-BERT baselines on run (a)'s weights and
    prompts: bf16 rings through ``float_xla`` (streaming prefill, direct
    decode), int8 rings through ``ibert_xla`` at both; tokens against
    run (a)'s ITA tokens and last-position logits against the float
    run's (printed, not gated)."""
    prompts = prompt_batch(cfg)
    out, logits = {}, {}
    for impl, backend in (("float", "float_xla"), ("ibert", "ibert_xla")):
        cfg_x = dataclasses.replace(cfg, attention_impl=impl)
        res, fig = baseline_generate(
            model, cfg_x, prompts, GEN,
            {"prefill": backend, "decode": backend}, f"8a qwen2-7b {impl}")
        fig["same_as_ita"] = (res.tokens == ita_tokens).float().mean().item()
        out[impl] = fig
        logits[impl] = last_logits(model, cfg_x, prompts)
    logits["ita"] = last_logits(model, cfg, prompts)
    for impl in ("ita", "ibert"):
        out.setdefault(impl, {})["logit_max_abs_vs_float"] = \
            (logits[impl] - logits["float"]).abs().max().item()
    log(f"[baselines] 8a tokens equal to run (a)'s ITA tokens: float "
        f"{out['float']['same_as_ita']:.3f}, ibert "
        f"{out['ibert']['same_as_ita']:.3f}; last prompt position's logits "
        f"max |d| vs float: ITA {out['ita']['logit_max_abs_vs_float']:.4f},"
        f" I-BERT {out['ibert']['logit_max_abs_vs_float']:.4f}")
    return out


def softmax_family(softmax_inputs, checks):
    """Phase 8b: the softmax family on run (c)'s layer-0 logits (the rows
    B6 consumes in phase 4): ITA (B6 through its entry point, paper DI,
    counters zeroed just before and read just after), I-BERT, Softermax,
    the QAT STE forward and the float oracle, on the card. I-BERT on the
    card must equal I-BERT on the CPU bit for bit. The MAEs against float
    over the causally valid elements are printed."""
    import torch

    from repro_torch.core import softmax as TS
    from repro_torch.core.quant import EPS_MAX
    from repro_torch.kernels.ita_softmax import kernel as SK
    from repro_torch.kernels.ita_softmax.ops import ita_softmax
    x, mask8 = softmax_inputs
    mask = mask8 != 0
    reset_launches()
    ita = ita_softmax(x, mask8, block_c=128, adaptive=False)
    launches = read_launches()
    want = dict.fromkeys(SOURCES, 0)
    want["ita_softmax"] = 1
    if launches != want:
        raise AssertionError(f"8b softmax launches {launches} != {want}")
    checks.compare("ita_softmax", ita,
                   SK.softmax_plain(x, mask8, block_c=128, adaptive=False),
                   f"8b, {tuple(x.shape)}, paper DI")
    family = {
        "float": lambda: TS.softmax_float(x, mask=mask),
        "ibert": lambda: TS.ibert_softmax(x, mask=mask),
        "softermax": lambda: TS.softermax(x, mask=mask),
        "ita_ste": lambda: TS.ita_softmax_ste(x.float() * EPS_MAX,
                                              mask=mask)}
    probs = {name: fn() for name, fn in family.items()}
    probs["ita"] = ita
    cpu = TS.ibert_softmax(x.cpu(), mask=mask.cpu())
    if not torch.equal(probs["ibert"].cpu(), cpu):
        n = (probs["ibert"].cpu() != cpu).sum().item()
        raise AssertionError(f"8b: I-BERT on the card differs from the CPU "
                             f"in {n} elements")
    ref = probs["float"]
    mae = {name: ((p.float() - ref).abs() * mask).sum().item()
           / mask.sum().item() for name, p in probs.items()
           if name != "float"}
    ms = {name: median_ms(fn, reps=5, warmup=1)
          for name, fn in family.items()}
    ms["ita"] = median_ms(lambda: ita_softmax(x, mask8, block_c=128,
                                              adaptive=False), reps=5,
                          warmup=1)
    log(f"[softmax] 8b on run (c)'s layer-0 logits {tuple(x.shape)}, "
        f"causal: B6 launches {launches['ita_softmax']}; I-BERT card == "
        f"CPU bit for bit; MAE vs float over the valid elements: "
        + ", ".join(f"{n} {v:.6f}" for n, v in mae.items())
        + "; ms (CUDA events, median of 5): "
        + ", ".join(f"{n} {v:.3f}" for n, v in ms.items())
        + f"; {card_line()}")
    return launches["ita_softmax"], {"mae": mae, "ms": ms}


def gemma2_at_full_width():
    """Phase 8c: gemma2-27b (random bf16 weights, seed 0, ITA): (i) at
    full width and ``GEMMA2_PERIODS`` of its 23 (local, global) periods,
    batch 4, prompt 512, 32 tokens; (ii) at full width and
    ``GEMMA2_LONG_PERIODS`` of its periods,
    batch 1, prompt 4608, 16 tokens, so the 4096-entry local rings wrap
    and the window binds. Prefill must be served by ``ita_chunked_xla``,
    decode by ``ita_direct_xla``, no fused attention kernel may launch,
    and the fused loop's tokens equal the stepwise loop's. Each model is
    freed before the next."""
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.models import init_model
    full = get_config("gemma2-27b", attention_impl="ita")
    served = {"prefill": "ita_chunked_xla", "decode": "ita_direct_xla"}
    gen = torch.Generator().manual_seed(0)
    out = {}
    for run, (b, plen, n), periods in (
            ("i", (B, PROMPT, GEN), GEMMA2_PERIODS),
            ("ii", (1, GEMMA2_LONG, GEMMA2_LONG_GEN), GEMMA2_LONG_PERIODS)):
        cfg = dataclasses.replace(
            full, layer_groups=((full.layer_groups[0][0], periods),))
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        model = init_model(cfg, seed=0, device=DEV)
        torch.cuda.synchronize()
        weight_bytes = sum(p.numel() * p.element_size()
                           for p in model.parameters())
        floor = weight_floor(weight_bytes)
        log(f"[gemma2] ({run}) {cfg.name}: {cfg.n_layers} layers (local "
            f"{cfg.local_window} / global), d={cfg.d_model}, "
            f"{cfg.n_heads}/{cfg.n_kv_heads} heads, GeGLU {cfg.d_ff}, vocab "
            f"{cfg.vocab_size}; weights {weight_bytes / 1e9:.2f} GB "
            f"{cfg.dtype}, init {time.perf_counter() - t0:.1f} s; allocated "
            f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
        prompts = torch.randint(0, cfg.vocab_size, (b, plen), generator=gen)
        torch.cuda.reset_peak_memory_stats()
        res, fig = baseline_generate(model, cfg, prompts, n, served,
                                     f"8c gemma2-27b ({run})")
        fig["max_alloc_gb"] = torch.cuda.max_memory_allocated() / 1e9
        fig.update(layers=cfg.n_layers, weights_gb=weight_bytes / 1e9,
                   floor_ms=floor)
        logits = last_logits(model, cfg, prompts[:1, -64:])
        if not torch.isfinite(logits).all() \
                or logits.abs().max() > cfg.logit_softcap:
            raise AssertionError(f"8c ({run}): logits not finite or beyond "
                                 f"the softcap")
        out[run] = fig
        log(f"[gemma2] ({run}) batch {b}, prompt {plen}, {n} tokens: prefill"
            f" {fig['prefill_s']:.3f} s, decode {fig['decode_tok_s']:.1f} "
            f"tok/s, {fig['step_ms']:.2f} ms a step (kept graph) against a "
            f"weight-read floor of {floor:.2f} ms "
            f"({weight_bytes / 1e9:.2f} GB / 3.35 TB/s), busy "
            f"{fig['busy']:.1%}, max allocated {fig['max_alloc_gb']:.2f} GB;"
            f" tokens {res.tokens[0, :8].tolist()}; {card_line()}")
        del model, res
    return out


# ---------------------------------------------------------------------------
# Phase 9: the mixture of experts and phi3-mini at full width
# ---------------------------------------------------------------------------

def phase9_model(arch):
    """``arch`` at full width, random weights from seed 0, ITA."""
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.models import init_model
    cfg = get_config(arch, attention_impl="ita")
    t0 = time.perf_counter()
    model = init_model(cfg, seed=0, device=DEV)
    torch.cuda.synchronize()
    nbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    log(f"[phase9] {cfg.name} full width: {cfg.n_layers} layers, d "
        f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of "
        f"{cfg.head_dim}, d_ff {cfg.d_ff}, experts {cfg.n_experts} top-"
        f"{cfg.n_experts_active}, vocab {cfg.vocab_size}, param_dtype "
        f"{cfg.param_dtype}; weights {nbytes / 1e9:.2f} GB, init "
        f"{time.perf_counter() - t0:.1f} s; allocated "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
    return model, cfg, nbytes


def generate_twice(model, cfg, prompts, label, record, keep, want, **kw):
    """Two fused ``generate()`` calls (the capture, then the kept graph's
    replays) with the counters zeroed just before and read just after
    each and the serving backends counted, equal tokens and launches
    ``want``; then the stepwise loop held to them (``kw``: options of
    all three calls, ``gen`` among them). Returns the kept call's
    result, the stepwise one's, the backends seen in the first call, the
    ``Recorder`` of ``record``, the kept call's counted launches of
    ``record`` and the stepwise call's by query length."""
    import torch
    (first, l1, rec), seen = served_by(lambda: run_generate(
        model, cfg, prompts, record=record, keep=keep, **kw))
    (kept, l2, _), _ = served_by(lambda: run_generate(model, cfg, prompts,
                                                      **kw))
    if l1 != want or l2 != want:
        raise AssertionError(f"{label}: launches {l1}, {l2} != {want}")
    if not torch.equal(first.tokens, kept.tokens):
        raise AssertionError(f"{label}: two fused calls gave other tokens")
    tok = kept.tokens
    if tok.shape != (prompts.shape[0], kw.get("gen", GEN)) \
            or tok.min() < 0 or tok.max() >= cfg.vocab_size:
        raise AssertionError(f"{label}: bad tokens {tuple(tok.shape)}")
    log_capture(label, first, kept)
    step, srec = hold_to_stepwise(model, cfg, prompts, kept, want, label,
                                  record=record, **kw)
    return kept, step, seen, rec, l2.get(record), \
        None if srec is None else srec.by_rows


def subrow(name, call, launches, label):
    """Times and bound of kernel ``name`` on one kept call: a sub-row of
    the kernels line."""
    from repro_torch.kernels.ita_attention import kernel as K
    args, kw, _ = call

    def bind():
        return K.kernel_launcher(name, *args, **kw)
    ms, graph = kernel_ms(bind), graph_ms(bind)
    plain = median_ms(lambda: plain_of(name)(*args, **kw), reps=3, warmup=1)
    bms, by = bound_ms(name, args, kw)
    log(f"[timing] {name} at {label} q{tuple(args[0].shape)} "
        f"k{tuple(args[1].shape)}{call_meta(name, args, kw)}: kernel "
        f"{ms:.4f} ms back to back, {graph:.4f} ms in a CUDA graph, plain "
        f"{plain:.4f} ms, bound {bms:.5f} ms ({by}), {launches} launches; "
        f"{card_line()}")
    return {"ms": ms, "graph_ms": graph, "plain_ms": plain, "bound_ms": bms,
            "bound_by": by, "launches": launches,
            "excess_ms": launches * (graph - bms)}


def generate_phase9(model, cfg, checks, tag):
    """``generate()`` at batch 4, prompt 512, 32 tokens: unpinned (the
    chunked prefill, then B4 every step) and pinned to onepass (B2 at
    prefill and at every decode step); layer 0's calls held to plain.
    Returns the figures and the kernels' sub-rows."""
    import torch

    from repro_torch.runtime.generate import generate
    n = cfg.n_layers
    prompts = prompt_batch(cfg)
    want_a = dict.fromkeys(SOURCES, 0)
    want_a["ita_attention_decode"] = n * (GEN - 1)
    res_a, step_a, seen_a, rec_dec, n_dec, _ = generate_twice(
        model, cfg, prompts, f"9 {tag} (a)", "ita_attention_decode", (0,),
        want_a)
    check_served(seen_a, {"prefill": "ita_chunked_xla",
                          "decode": "ita_decode_pallas"}, f"9 {tag} (a)")
    cfg_b = dataclasses.replace(cfg, attention_backend="ita_onepass_pallas")
    want_b = dict.fromkeys(SOURCES, 0)
    want_b["ita_attention_onepass"] = n * GEN
    res_b, step_b, seen_b, rec_one, n_one, rows_b = generate_twice(
        model, cfg_b, prompts, f"9 {tag} (b)", "ita_attention_onepass",
        (0, n), want_b)
    # B2's split between the prefill (q rows > 1) and the decode steps
    # (1 row), counted in the stepwise run, whose calls are its launches
    one_pre = sum(c for sq, c in rows_b.items() if sq > 1)
    one_dec = rows_b.get(1, 0)
    check_served(seen_b, {"prefill": "ita_onepass_pallas",
                          "decode": "ita_onepass_pallas"}, f"9 {tag} (b)")
    check_recorded(checks, "ita_attention_decode", rec_dec, 0,
                   f"9 {tag} (a), layer 0 of the first decode step")
    for idx, what in ((0, "prefill"), (n, "first decode step")):
        check_recorded(checks, "ita_attention_onepass", rec_one, idx,
                       f"9 {tag} (b), layer 0 of the {what}")
    logits = last_logits(model, cfg, prompts[:1, -64:])
    if not torch.isfinite(logits).all():
        raise AssertionError(f"9 {tag}: non-finite logits")
    _, busy = profile_run(f"9 {tag} fused generate (a)", lambda: generate(
        model, cfg, prompts, GEN, device=DEV))
    figs = {"prefill_s": res_a.prefill_s, "decode_tok_s": res_a.decode_tok_s,
            "step_ms": 1e3 * res_a.decode_s / res_a.decode_steps,
            "stepwise_tok_s": step_a.decode_tok_s,
            "pinned_prefill_s": res_b.prefill_s,
            "pinned_decode_tok_s": res_b.decode_tok_s,
            "pinned_step_ms": 1e3 * res_b.decode_s / res_b.decode_steps,
            "busy": busy, "served_a": seen_a, "served_b": seen_b}
    log(f"[phase9] {tag} generate: (a) served by {seen_a}, prefill "
        f"{figs['prefill_s']:.3f} s, decode {figs['decode_tok_s']:.1f} tok/s"
        f" ({figs['step_ms']:.2f} ms a replayed step), stepwise "
        f"{figs['stepwise_tok_s']:.1f} tok/s, busy {busy:.1%}; (b) served "
        f"by {seen_b}, prefill {figs['pinned_prefill_s']:.3f} s, decode "
        f"{figs['pinned_decode_tok_s']:.1f} tok/s "
        f"({figs['pinned_step_ms']:.2f} ms); tokens "
        f"{res_a.tokens[0, :8].tolist()}; launches counted: B4 {n_dec} in "
        f"(a), B2 {n_one} in (b), in (b)'s stepwise run {one_pre} at "
        f"prefill and {one_dec} at decode; {card_line()}")
    sub = {
        "ita_attention_decode": {tag: subrow(
            "ita_attention_decode", rec_dec.kept[0], n_dec,
            f"9 {tag} (a) decode")},
        "ita_attention_onepass": {
            f"{tag}_prefill": subrow("ita_attention_onepass",
                                     rec_one.kept[0], one_pre,
                                     f"9 {tag} (b) prefill"),
            f"{tag}_decode": subrow("ita_attention_onepass",
                                    rec_one.kept[n], one_dec,
                                    f"9 {tag} (b) decode")}}
    return figs, sub


def routed_experts(model, cfg, prompts, steps=4):
    """The mean number of distinct experts a decode step routes to per
    layer: a ring prefill of ``prompts``, then ``steps`` greedy decode
    steps, the router of every MoE layer read at each."""
    import torch

    from repro_torch.models import forward, init_caches
    from repro_torch.models import moe as TM
    counts = []

    def hook(mod, inp):
        x = inp[0]
        if x.shape[1] == 1:
            x2 = x.reshape(-1, x.shape[-1])
            top_i = TM.top_k(TM.router_probs(x2, mod.router), mod.k)[1]
            counts.append(top_i.unique().numel())
    handles = [blk.mlp.register_forward_pre_hook(hook)
               for blk in model.blocks]
    b, s = prompts.shape
    try:
        with torch.inference_mode():
            caches = init_caches(cfg, b, s + steps, device=DEV)
            logits, caches = forward(model, prompts.to(DEV), cfg,
                                     mode="prefill", caches=caches)
            tok = torch.argmax(logits[:, -1:], -1)
            for i in range(steps):
                logits, caches = forward(model, tok, cfg, mode="decode",
                                         caches=caches,
                                         pos0=torch.full((b,), s + i))
                tok = torch.argmax(logits, -1)
    finally:
        for h in handles:
            h.remove()
    return sum(counts) / len(counts)


def moe_floors(model, cfg, routed):
    """Weight-read floors of one decode step, in ms: every weight but the
    embedding table (of which a step reads only the batch's rows) read
    once; and the same with only ``routed`` of each layer's experts."""
    expert = sum(p.numel() * p.element_size() for blk in model.blocks
                 for p in (blk.mlp.w_gate, blk.mlp.w_up, blk.mlp.w_down))
    rest = sum(p.numel() * p.element_size() for p in model.parameters()) \
        - expert - model.embed.numel() * model.embed.element_size()
    routed_bytes = rest + expert * routed / cfg.n_experts
    return {"all_gb": (rest + expert) / 1e9,
            "all_ms": weight_floor(rest + expert),
            "routed_gb": routed_bytes / 1e9,
            "routed_ms": weight_floor(routed_bytes)}


def olmoe_serve(model, cfg, checks):
    """Phase 9a's serve: ``MOE_SERVE``'s 12 requests through
    ``serve_continuous(admission="chunked")``, unpinned (B3 at the mixed
    steps, B4p at the decode steps), counters zeroed just before and read
    just after, the backends counted; every request's tokens equal solo
    ``generate()`` under the onepass pin; layer 0's first B3 and B4p
    calls held to plain. Then the trace's first four requests served
    under the profiler (busy share), with the same tokens."""
    import numpy as np
    import torch

    from repro_torch.runtime.generate import generate, serve_continuous
    reqs = serve_trace(cfg, spec=MOE_SERVE)
    kw = dict(slots=MOE_SERVE["slots"], segment=MOE_SERVE["segment"],
              page_size=MOE_SERVE["page_size"],
              num_pages=MOE_SERVE["num_pages"],
              chunk_size=MOE_SERVE["chunk_size"], device=DEV)
    warm = recording(PAGED, keep=(0,))
    try:
        reset_launches()
        res, seen = served_by(lambda: serve_continuous(
            model, cfg, reqs, debug_invariants=True, **kw))
        launches = read_launches()
    finally:
        unrecord(warm)
    moved = {k: n for k, n in launches.items() if n}
    if set(moved) != set(PAGED) or len(res.completed) != len(reqs):
        raise AssertionError(f"9a serve: launches {moved}, "
                             f"{len(res.completed)} of {len(reqs)} done")
    # mixed steps through the paged onepass kernel, decode steps through
    # the paged decode kernel (the eager calls: warm-ups and captures)
    if set(seen) != {("ita_onepass_pallas", "decode"),
                     ("ita_decode_pallas", "decode")}:
        raise AssertionError(f"9a serve: served by {seen}")
    for name, what in zip(PAGED, ("mixed", "decode"), strict=True):
        check_recorded(checks, name, warm[name], 0,
                       f"9a serve, layer 0 of the first {what} step")
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
                f"9a request {c.index} (prompt {r.prompt.size}, gen "
                f"{r.gen}): served tokens differ from solo generate() at "
                f"{first}: {c.tokens[first]} vs {want[first]}")
    again, busy = profile_run("9a olmoe serve of requests 0-3",
                              lambda: serve_continuous(model, cfg, reqs[:4],
                                                       **kw))
    tokens = {c.index: c.tokens for c in res.completed}
    for c in again.completed:
        if not np.array_equal(c.tokens, tokens[c.index]):
            raise AssertionError(f"9a: a second serve gave request "
                                 f"{c.index} other tokens")
    figs = {"tok_s": res.tok_s, "wall_s": res.wall_s,
            "ttft_p50": res.ttft_quantile(0.5), "steps": res.steps,
            "busy": busy, "launches": {n: launches[n] for n in PAGED},
            "served": seen}
    log(f"[phase9] 9a serve: {len(reqs)} requests (prompts "
        f"{min(r.prompt.size for r in reqs)}-"
        f"{max(r.prompt.size for r in reqs)}, gen "
        f"{min(r.gen for r in reqs)}-{max(r.gen for r in reqs)}, last "
        f"arrival step {reqs[-1].arrival}); served by {seen} (eager calls); "
        f"launches {figs['launches']}; {res.steps} steps, {res.segments} "
        f"segments; {res.total_tokens} tokens in {res.wall_s:.3f} s: "
        f"{res.tok_s:.2f} tok/s, TTFT p50 {figs['ttft_p50']:.3f} s; busy "
        f"{busy:.1%} (profiled serve of requests 0-3, wall "
        f"{again.wall_s:.3f} s); every "
        f"request equal to solo generate() (onepass pin, max_len "
        f"{max_len}); {card_line()}")
    sub = {name: {"olmoe": subrow(name, warm[name].kept[0], launches[name],
                                  f"9a serve first {what} step")}
           for name, what in zip(PAGED, ("mixed", "decode"), strict=True)}
    return figs, sub


def phase9(checks):
    """Phase 9: olmoe-1b-7b (9a: generate and the serve) and phi3-mini-3.8b
    (9b: generate), each at full width in its own frame, freed before the
    next. Returns a result line and the kernels' sub-rows."""
    import torch
    subs, roof = {}, []

    def merge(sub):
        for name, rows in sub.items():
            subs.setdefault(name, {}).update(rows)

    def olmoe():
        model, cfg, nbytes = phase9_model("olmoe-1b-7b")
        figs, sub = generate_phase9(model, cfg, checks, "olmoe")
        merge(sub)
        routed = routed_experts(model, cfg, prompt_batch(cfg))
        floors = moe_floors(model, cfg, routed)
        log(f"[phase9] 9a decode-step weight-read floors: all 64 experts "
            f"{floors['all_gb']:.2f} GB, {floors['all_ms']:.2f} ms; the "
            f"routed {routed:.1f} of 64 a layer (batch {B}, top-"
            f"{cfg.n_experts_active}, mean over 4 steps) "
            f"{floors['routed_gb']:.2f} GB, {floors['routed_ms']:.2f} ms; "
            f"replayed step {figs['step_ms']:.2f} ms; {card_line()}")
        serve, sub = olmoe_serve(model, cfg, checks)
        merge(sub)
        costs, shape = counted_decode_step(model, cfg)
        roof.append(roofline_record("olmoe-1b-7b (a) decode step (replayed)",
                                    costs, cfg, shape,
                                    figs["step_ms"] / 1e3))
        return dict(figs, weights_gb=nbytes / 1e9, routed=routed,
                    floors=floors, serve=serve)

    def phi3():
        model, cfg, nbytes = phase9_model("phi3-mini-3.8b")
        figs, sub = generate_phase9(model, cfg, checks, "phi3")
        merge(sub)
        floor = weight_floor(nbytes - model.embed.numel()
                             * model.embed.element_size())
        log(f"[phase9] 9b phi3 replayed step {figs['step_ms']:.2f} ms "
            f"against a weight-read floor of {floor:.2f} ms; {card_line()}")
        return dict(figs, weights_gb=nbytes / 1e9, floor_ms=floor)

    out = {}
    for name, fn in (("olmoe", olmoe), ("phi3", phi3)):
        out[name] = fn()
        gc.collect()
        torch.cuda.empty_cache()
    o, p = out["olmoe"], out["phi3"]
    line = (f"[result] phase 9: olmoe-1b-7b ({o['weights_gb']:.2f} GB) "
            f"prefill {o['prefill_s']:.3f} s, decode {o['decode_tok_s']:.1f}"
            f" tok/s, step {o['step_ms']:.2f} ms (floors "
            f"{o['floors']['all_ms']:.2f} all experts, "
            f"{o['floors']['routed_ms']:.2f} routed), busy {o['busy']:.1%};"
            f" pinned prefill {o['pinned_prefill_s']:.3f} s, decode "
            f"{o['pinned_decode_tok_s']:.1f} tok/s; serve "
            f"{o['serve']['tok_s']:.2f} tok/s, wall "
            f"{o['serve']['wall_s']:.3f} s, TTFT p50 "
            f"{o['serve']['ttft_p50']:.3f} s, busy {o['serve']['busy']:.1%};"
            f" phi3-mini-3.8b ({p['weights_gb']:.2f} GB) prefill "
            f"{p['prefill_s']:.3f} s, decode {p['decode_tok_s']:.1f} tok/s,"
            f" step {p['step_ms']:.2f} ms (floor {p['floor_ms']:.2f}), busy "
            f"{p['busy']:.1%}; pinned decode {p['pinned_decode_tok_s']:.1f} "
            f"tok/s")
    return line, subs, roof


# ---------------------------------------------------------------------------
# Phase 10: the recurrent blocks at full width
# ---------------------------------------------------------------------------

RG_LONG, RG_LONG_GEN = 4096, 16      # 10a (d): the local rings wrap


def weight_floor_ms(model, cfg):
    """A decode step's weight-read floor: every weight read once, but of
    an untied embedding table only the batch's rows (a tied table is the
    unembedding, read whole)."""
    nbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    if not cfg.tie_embeddings:
        nbytes -= model.embed.numel() * model.embed.element_size()
    return weight_floor(nbytes)


def recurrent_state_bytes(cfg):
    """Bytes of one sequence's recurrent state (all recurrent layers)."""
    from repro_torch.models import init_caches
    return sum(t.numel() * t.element_size()
               for c in init_caches(cfg, 1, 1, device="cpu")
               for part in c.values() if isinstance(part, dict)
               for t in part.values())


def recurrentgemma_phase(checks):
    """10a: recurrentgemma-2b at full width (random bf16 weights, seed 0,
    ITA): (a) unpinned ``generate()`` 4 x 512, 32 tokens (chunked
    prefill, B4 at every decode step of its 8 local layers); (b) pinned
    to onepass (B2 at prefill and decode); (c) (a) with ``paged=True``
    (B4p), tokens equal to (a)'s; (d) 1 x ``RG_LONG``, ``RG_LONG_GEN``
    tokens: the 2048-entry local rings wrap and the window binds. Each
    run twice fused (capture, then the kept graph) and once stepwise,
    equal tokens and counted launches; layer 0's kernel calls held to
    plain. Returns the figures and the kernels' sub-rows."""
    import torch

    from repro_torch.runtime.generate import generate
    model, cfg, nbytes = phase9_model("recurrentgemma-2b")
    n_local = sum(pat.count("local") * n for pat, n in cfg.layer_groups)
    prompts = prompt_batch(cfg)
    served = {"prefill": "ita_chunked_xla", "decode": "ita_decode_pallas"}

    def want(**counts):
        return dict(dict.fromkeys(SOURCES, 0), **counts)
    res_a, step_a, seen_a, rec_a, n_a, _ = generate_twice(
        model, cfg, prompts, "10a (a)", "ita_attention_decode", (0,),
        want(ita_attention_decode=n_local * (GEN - 1)))
    check_served(seen_a, served, "10a (a)")
    check_recorded(checks, "ita_attention_decode", rec_a, 0,
                   "10a (a), layer 2 of the first decode step")
    cfg_b = dataclasses.replace(cfg, attention_backend="ita_onepass_pallas")
    res_b, _, seen_b, rec_b, n_b, rows_b = generate_twice(
        model, cfg_b, prompts, "10a (b)", "ita_attention_onepass",
        (0, n_local), want(ita_attention_onepass=n_local * GEN))
    check_served(seen_b, {"prefill": "ita_onepass_pallas",
                          "decode": "ita_onepass_pallas"}, "10a (b)")
    one_pre = sum(c for sq, c in rows_b.items() if sq > 1)
    one_dec = rows_b.get(1, 0)
    for idx, what in ((0, "prefill"), (n_local, "first decode step")):
        check_recorded(checks, "ita_attention_onepass", rec_b, idx,
                       f"10a (b), layer 2 of the {what}")
    res_c, _, seen_c, rec_c, n_c, _ = generate_twice(
        model, cfg, prompts, "10a (c)", "ita_attention_decode_paged", (0,),
        want(ita_attention_decode_paged=n_local * (GEN - 1)), paged=True)
    check_served(seen_c, served, "10a (c)")
    check_recorded(checks, "ita_attention_decode_paged", rec_c, 0,
                   "10a (c), layer 2 of the first decode step")
    if not torch.equal(res_c.tokens, res_a.tokens):
        raise AssertionError("10a (c): paged tokens differ from (a)'s")
    long = torch.randint(0, cfg.vocab_size, (1, RG_LONG),
                         generator=torch.Generator().manual_seed(4))
    res_d, _, seen_d, rec_d, n_d, _ = generate_twice(
        model, cfg, long, "10a (d)", "ita_attention_decode", (0,),
        want(ita_attention_decode=n_local * (RG_LONG_GEN - 1)),
        gen=RG_LONG_GEN)
    check_served(seen_d, served, "10a (d)")
    args_d, kw_d, _ = rec_d.kept[0]
    check_recorded(checks, "ita_attention_decode", rec_d, 0,
                   f"10a (d), layer 2 of the first decode step (ring "
                   f"{args_d[1].shape[1]}, window {kw_d.get('window')})")
    if args_d[1].shape[1] != cfg.local_window \
            or kw_d.get("window") != cfg.local_window:
        raise AssertionError(f"10a (d): the decode call ran over a ring of "
                             f"{args_d[1].shape[1]}, window "
                             f"{kw_d.get('window')}")
    logits = last_logits(model, cfg, prompts[:1, -64:])
    if not torch.isfinite(logits).all():
        raise AssertionError("10a: non-finite logits")
    _, busy = profile_run("10a recurrentgemma fused generate (a)",
                          lambda: generate(model, cfg, prompts, GEN,
                                           device=DEV))
    floor = weight_floor_ms(model, cfg)
    figs = {"weights_gb": nbytes / 1e9, "floor_ms": floor,
            "state_bytes": recurrent_state_bytes(cfg),
            "prefill_s": res_a.prefill_s, "decode_tok_s": res_a.decode_tok_s,
            "step_ms": 1e3 * res_a.decode_s / res_a.decode_steps,
            "stepwise_tok_s": step_a.decode_tok_s,
            "pinned_prefill_s": res_b.prefill_s,
            "pinned_decode_tok_s": res_b.decode_tok_s,
            "paged_decode_tok_s": res_c.decode_tok_s,
            "long_prefill_s": res_d.prefill_s,
            "long_decode_tok_s": res_d.decode_tok_s, "busy": busy}
    log(f"[phase10] 10a recurrentgemma-2b: (a) served by {seen_a}, prefill "
        f"{figs['prefill_s']:.3f} s, decode {figs['decode_tok_s']:.1f} tok/s"
        f" ({figs['step_ms']:.2f} ms a replayed step against a weight-read "
        f"floor of {floor:.2f} ms), stepwise {figs['stepwise_tok_s']:.1f} "
        f"tok/s, busy {busy:.1%}; (b) served by {seen_b}, prefill "
        f"{figs['pinned_prefill_s']:.3f} s, decode "
        f"{figs['pinned_decode_tok_s']:.1f} tok/s; (c) paged, tokens equal "
        f"to (a), decode {figs['paged_decode_tok_s']:.1f} tok/s; (d) 1 x "
        f"{RG_LONG}, prefill {figs['long_prefill_s']:.3f} s, decode "
        f"{figs['long_decode_tok_s']:.1f} tok/s; recurrent state "
        f"{figs['state_bytes']} bytes a sequence; tokens "
        f"{res_a.tokens[0, :8].tolist()}; launches counted: B4 {n_a} in (a),"
        f" B2 {n_b} in (b) ({one_pre} at prefill, {one_dec} at decode in "
        f"its stepwise run), B4p {n_c} in (c), B4 {n_d} in (d); "
        f"{card_line()}")
    sub = {
        "ita_attention_decode": {
            "recurrentgemma": subrow("ita_attention_decode", rec_a.kept[0],
                                     n_a, "10a (a) decode"),
            "recurrentgemma_long": subrow("ita_attention_decode",
                                          rec_d.kept[0], n_d,
                                          "10a (d) decode, wrapped ring")},
        "ita_attention_onepass": {
            "recurrentgemma_prefill": subrow(
                "ita_attention_onepass", rec_b.kept[0], one_pre,
                "10a (b) prefill"),
            "recurrentgemma_decode": subrow(
                "ita_attention_onepass", rec_b.kept[n_local], one_dec,
                "10a (b) decode")},
        "ita_attention_decode_paged": {
            "recurrentgemma": subrow("ita_attention_decode_paged",
                                     rec_c.kept[0], n_c, "10a (c) decode")}}
    return figs, sub


def rwkv_phase():
    """10b: rwkv6-7b at full width (random weights, seed 0; no attention
    layer, so no attention kernel may launch): ``generate()`` 4 x 512, 32
    tokens, twice fused and once stepwise, equal tokens."""
    import torch

    from repro_torch.runtime.generate import generate
    model, cfg, nbytes = phase9_model("rwkv6-7b")
    prompts = prompt_batch(cfg)
    res, step, seen, _, _, _ = generate_twice(
        model, cfg, prompts, "10b", None, (), dict.fromkeys(SOURCES, 0))
    if seen:
        raise AssertionError(f"10b: attention calls {seen} in rwkv6-7b")
    logits = last_logits(model, cfg, prompts[:1, -64:])
    if not torch.isfinite(logits).all():
        raise AssertionError("10b: non-finite logits")
    _, busy = profile_run("10b rwkv6 fused generate",
                          lambda: generate(model, cfg, prompts, GEN,
                                           device=DEV))
    floor = weight_floor_ms(model, cfg)
    figs = {"weights_gb": nbytes / 1e9, "floor_ms": floor,
            "state_bytes": recurrent_state_bytes(cfg),
            "prefill_s": res.prefill_s, "decode_tok_s": res.decode_tok_s,
            "step_ms": 1e3 * res.decode_s / res.decode_steps,
            "stepwise_tok_s": step.decode_tok_s, "busy": busy}
    log(f"[phase10] 10b rwkv6-7b: no attention kernel runs (attention-free;"
        f" every counter 0); recurrent state {figs['state_bytes']} bytes a "
        f"sequence; prefill {figs['prefill_s']:.3f} s, decode "
        f"{figs['decode_tok_s']:.1f} tok/s ({figs['step_ms']:.2f} ms a "
        f"replayed step against a weight-read floor of {floor:.2f} ms), "
        f"stepwise {figs['stepwise_tok_s']:.1f} tok/s, busy {busy:.1%}; "
        f"tokens {res.tokens[0, :8].tolist()}; {card_line()}")
    return figs


def phase10(checks):
    """Phase 10: recurrentgemma-2b (10a) and rwkv6-7b (10b) at full
    width, each in its own frame, freed before the next. Returns a result
    line and the kernels' sub-rows."""
    import torch
    out = {}
    for name, fn in (("rg", lambda: recurrentgemma_phase(checks)),
                     ("rw", lambda: (rwkv_phase(), {}))):
        out[name] = fn()
        gc.collect()
        torch.cuda.empty_cache()
    (rg, subs), (rw, _) = out["rg"], out["rw"]
    line = (f"[result] phase 10: recurrentgemma-2b ({rg['weights_gb']:.2f} "
            f"GB) prefill {rg['prefill_s']:.3f} s, decode "
            f"{rg['decode_tok_s']:.1f} tok/s, step {rg['step_ms']:.2f} ms "
            f"(floor {rg['floor_ms']:.2f}), busy {rg['busy']:.1%}; pinned "
            f"decode {rg['pinned_decode_tok_s']:.1f} tok/s; paged decode "
            f"{rg['paged_decode_tok_s']:.1f} tok/s; 1 x {RG_LONG} prefill "
            f"{rg['long_prefill_s']:.3f} s, decode "
            f"{rg['long_decode_tok_s']:.1f} tok/s; rwkv6-7b "
            f"({rw['weights_gb']:.2f} GB) prefill {rw['prefill_s']:.3f} s, "
            f"decode {rw['decode_tok_s']:.1f} tok/s, step "
            f"{rw['step_ms']:.2f} ms (floor {rw['floor_ms']:.2f}), busy "
            f"{rw['busy']:.1%}, state {rw['state_bytes']} bytes a sequence")
    return line, subs


# ---------------------------------------------------------------------------
# Phase 11: the encoder-decoder and cross-attention blocks at full width
# ---------------------------------------------------------------------------

def cross_model(arch, **over):
    """``arch`` at full width (``over``: its cuts), random weights from
    seed 0, ITA, pinned to the onepass backend, the cross gates opened;
    a random frontend of batch ``B`` (CPU generator, seed 11) on the
    card."""
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.models import init_model
    cfg = get_config(arch, attention_impl="ita", attention_backend=PIN,
                     **over)
    t0 = time.perf_counter()
    model = open_gates(init_model(cfg, seed=0, device=DEV))
    torch.cuda.synchronize()
    nbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    frontend = torch.randn((B, cfg.n_frontend_tokens, cfg.frontend_dim),
                           generator=torch.Generator().manual_seed(11)
                           ).to(DEV)
    log(f"[phase11] {cfg.name} full width: {cfg.n_layers} decoder layers "
        f"{cfg.layer_groups}, {cfg.n_encoder_layers} encoder layers, d "
        f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of "
        f"{cfg.head_dim}, d_ff {cfg.d_ff} ({cfg.mlp_type}), vocab "
        f"{cfg.vocab_size}, frontend {cfg.n_frontend_tokens} x "
        f"{cfg.frontend_dim}, param_dtype {cfg.param_dtype}; weights "
        f"{nbytes / 1e9:.2f} GB, init {time.perf_counter() - t0:.1f} s; "
        f"allocated {torch.cuda.memory_allocated() / 1e9:.2f} GB")
    return model, cfg, nbytes, frontend


def lap(what):
    log(f"[wall] {what} done at {time.perf_counter() - T0:.1f} s")


def cross_cache_bytes(cfg, batch):
    """The static int8 cross caches (k8 and v8 of every cross layer)."""
    n_cross = sum(sum(k in ("cross", "attn_cross") for k in pat) * n
                  for pat, n in cfg.layer_groups)
    return 2 * n_cross * batch * cfg.n_frontend_tokens * cfg.n_kv_heads \
        * cfg.head_dim


def cross_floor_ms(model, cfg, batch):
    """A decode step's floor: the decoder's weights read once (of an
    untied embedding only the batch's rows; not the cross layers'
    ``wk``/``wv``, which a decode step never reads, nor the encoder or
    ``frontend_proj``) and the cross caches."""
    cross_kv = {f"blocks.{i}.{'xattn' if blk.kind == 'attn_cross' else 'attn'}"
                f".{w}" for i, blk in enumerate(model.blocks)
                if blk.kind in ("cross", "attn_cross") for w in ("wk", "wv")}
    nbytes = sum(p.numel() * p.element_size()
                 for name, p in model.named_parameters()
                 if not (name.startswith(("encoder", "frontend_proj"))
                         or name in cross_kv
                         or (name == "embed" and not cfg.tie_embeddings)))
    return weight_floor(nbytes + cross_cache_bytes(cfg, batch))


def pad_copy_ms(cfg):
    """Device time of one decode step's pad-copies of the cross caches to
    the 128-key tile (``ops._pad_seq`` of k8 and v8 in every cross layer,
    as the onepass wrapper runs them, each over its own cache: together
    they do not fit the L2), summed over the kernels ``torch.profiler``
    records; and the bytes they move."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.ita_attention import ops
    shape = (B, cfg.n_frontend_tokens, cfg.n_kv_heads, cfg.head_dim)
    n_cross = cross_cache_bytes(cfg, B) // (2 * torch.Size(shape).numel())
    caches = [torch.zeros(shape, dtype=torch.int8, device=DEV)
              for _ in range(2 * n_cross)]
    for c in caches[:2]:
        ops._pad_seq(c, 128)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for c in caches:
            ops._pad_seq(c, 128)
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    padded = -(-cfg.n_frontend_tokens // 128) * 128
    moved = 2 * n_cross * B * cfg.n_kv_heads * cfg.head_dim \
        * (cfg.n_frontend_tokens + padded)
    return us / 1e3, moved


def encode_s(model, cfg, frontend):
    """Wall seconds of the encoder alone (the frontend to the memory),
    warm: after the ``generate()`` calls that ran it."""
    import torch

    from repro_torch.models.transformer import _encode
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _encode(model, cfg, frontend)
        torch.cuda.synchronize()
    return time.perf_counter() - t0


def unpinned_raises(model, cfg, prompts, frontend, label):
    """The unpinned call (the decode kernel over the unaligned cross
    cache) must raise the reference's text."""
    from repro_torch.runtime.generate import generate
    want = (f"decode KV ring capacity {cfg.n_frontend_tokens} is not a "
            f"block_kv=128 multiple")
    try:
        generate(model, dataclasses.replace(cfg, attention_backend=""),
                 prompts, 2, frontend=frontend, loop="stepwise", device=DEV)
    except ValueError as err:
        if want not in str(err):
            raise AssertionError(f"{label}: unpinned raised {err!r}")
        log(f"[phase11] {label} unpinned: raised as the reference does: "
            f"{str(err)[:120]}")
        return
    raise AssertionError(f"{label}: the unpinned decode did not raise")


def cross_counts(cfg):
    """(self-attention layers, cross-attention layers) of the stack."""
    def count(kinds):
        return sum(sum(k in kinds for k in pat) * r
                   for pat, r in cfg.layer_groups)
    return count(("attn", "attn_cross")), count(("cross", "attn_cross"))


def cross_served(seen, cfg, label):
    """The encoder on the QAT forward of ``ita_chunked_xla``, everything
    else on the onepass backend."""
    check_served(seen, {"train": "ita_chunked_xla", "prefill": PIN,
                        "decode": PIN}, label,
                 required=("train", "prefill", "decode") if
                 cfg.n_encoder_layers else ("prefill", "decode"))


def cross_generate(model, cfg, prompts, frontend, label, gen, checks):
    """``generate()`` pinned to onepass, fused twice and stepwise (equal
    tokens and launches), the backends counted (``cross_served``);
    layer 0's B2 calls (self and cross, prefill and first decode step)
    held to plain. Returns the kept call's result, the stepwise one's,
    the backends, the launches and the kept calls by role."""
    n_self, n_cross = cross_counts(cfg)
    kinds = [k for pat, r in cfg.layer_groups for _ in range(r)
             for k in pat]
    # B2 calls of one prefill, in order: per layer, self then cross
    order = [role for k in kinds for role in
             (("self", "cross") if k == "attn_cross"
              else ("cross",) if k == "cross" else ("self",))]
    first_cross = order.index("cross")
    want = dict.fromkeys(SOURCES, 0)
    want["ita_attention_onepass"] = (n_self + n_cross) * gen
    keep = (0, first_cross, len(order), len(order) + first_cross)
    kept, step, seen, rec, launches, rows = generate_twice(
        model, cfg, prompts, label, "ita_attention_onepass", keep, want,
        gen=gen, frontend=frontend)
    if rows != {prompts.shape[1]: n_self + n_cross,
                1: (n_self + n_cross) * (gen - 1)}:
        raise AssertionError(f"{label}: B2 calls by query rows {rows}")
    cross_served(seen, cfg, label)
    calls = {"prefill": rec.kept[0], "cross_prefill": rec.kept[first_cross],
             "decode": rec.kept[len(order)],
             "cross": rec.kept[len(order) + first_cross]}
    for role, call in calls.items():
        args, kw, out = call
        if (role.startswith("cross")) == kw.get("causal"):
            raise AssertionError(f"{label}: {role} call causal="
                                 f"{kw.get('causal')}")
        checks.compare("ita_attention_onepass", out,
                       plain_of("ita_attention_onepass")(*args, **kw),
                       f"{label}, layer 0 {role} (q{tuple(args[0].shape)} "
                       f"k{tuple(args[1].shape)} kv_len "
                       f"{int(args[5].reshape(-1)[0])})")
    return kept, step, seen, launches, calls


def whisper_phase(checks):
    """11a: whisper-large-v3 at full width and depth (module docstring).
    Returns the figures and the kernels' sub-rows."""
    import torch

    from repro_torch.models import forward, init_caches
    from repro_torch.runtime.generate import generate
    model, cfg, nbytes, frontend = cross_model("whisper-large-v3")
    prompts = torch.randint(0, cfg.vocab_size, (B, WHISPER_PROMPT),
                            generator=torch.Generator().manual_seed(12))
    gen = WHISPER_GEN
    n_self, n_cross = cross_counts(cfg)
    unpinned_raises(model, cfg, prompts, frontend, "11a")
    lap("11a unpinned refusal")
    res, step, seen, n_one, calls = cross_generate(
        model, cfg, prompts, frontend, "11a (a) rings", gen, checks)
    lap("11a (a) rings")
    # (b) paged: one fused call, its tokens the rings', B3 at every self
    # decode; its first B3 call (the capture's eager warm-up) held to plain
    recs = recording(PAGED, (0,))
    try:
        (res_p, launches_p, _), seen_p = served_by(lambda: run_generate(
            model, cfg, prompts, gen=gen, frontend=frontend, paged=True))
    finally:
        unrecord(recs)
    want_p = dict.fromkeys(SOURCES, 0)
    want_p["ita_attention_onepass"] = n_self + n_cross * gen
    want_p["ita_attention_onepass_paged"] = n_self * (gen - 1)
    if launches_p != want_p:
        raise AssertionError(f"11a (b): launches {launches_p} != {want_p}")
    cross_served(seen_p, cfg, "11a (b) paged")
    rec_p = recs["ita_attention_onepass_paged"]
    check_recorded(checks, "ita_attention_onepass_paged", rec_p, 0,
                   "11a (b), layer 0 of the first decode step (B3)")
    if not torch.equal(res_p.tokens, res.tokens):
        raise AssertionError("11a: paged tokens differ from the rings'")
    enc_s = encode_s(model, cfg, frontend)
    lap("11a (b) paged")
    with torch.inference_mode():
        logits, _ = forward(model, prompts[:1, -64:].to(DEV), cfg,
                            mode="prefill", frontend=frontend[:1],
                            caches=init_caches(cfg, 1, 64, device=DEV))
    if not torch.isfinite(logits).all():
        raise AssertionError("11a: non-finite logits")
    # 16 tokens: the profiler's host work grows with the events (a
    # 64-token call records ~400,000 kernels and took ~47 s to sum)
    _, busy = profile_run(f"11a whisper fused generate (rings), "
                          f"{WHISPER_PROFILE_GEN} tokens",
                          lambda: generate(model, cfg, prompts,
                                           WHISPER_PROFILE_GEN,
                                           frontend=frontend, device=DEV))
    lap("11a profile")
    pad_ms, pad_bytes = pad_copy_ms(cfg)
    floor = cross_floor_ms(model, cfg, B)
    figs = {"weights_gb": nbytes / 1e9, "floor_ms": floor,
            "encoder_s": enc_s, "prefill_s": res.prefill_s,
            "decode_tok_s": res.decode_tok_s,
            "step_ms": 1e3 * res.decode_s / res.decode_steps,
            "stepwise_tok_s": step.decode_tok_s,
            # the paged run's one fused call captured its step
            "paged_decode_tok_s": res_p.n_decode_tokens
            / (res_p.decode_s - res_p.capture_s),
            "cross_bytes": cross_cache_bytes(cfg, B), "busy": busy,
            "pad_ms": pad_ms, "pad_bytes": pad_bytes}
    log(f"[phase11] 11a whisper-large-v3: served by {seen}; encoder "
        f"{enc_s:.3f} s, prefill (encoder included) "
        f"{figs['prefill_s']:.3f} s, decode {figs['decode_tok_s']:.1f} "
        f"tok/s ({figs['step_ms']:.2f} ms a replayed step against a floor "
        f"of {floor:.3f} ms: the decoder's weights but the cross wk/wv, "
        f"and the cross caches), stepwise {figs['stepwise_tok_s']:.1f} "
        f"tok/s, paged {figs['paged_decode_tok_s']:.1f} tok/s (tokens "
        f"equal; one fused call, its capture's {res_p.capture_s:.3f} s "
        f"left out), busy {busy:.1%}; cross caches "
        f"{figs['cross_bytes']} "
        f"bytes; their pad-copy to the 128-key tile {pad_ms:.3f} ms of "
        f"device time a step ({pad_bytes} bytes read and written); tokens "
        f"{res.tokens[0, :8].tolist()}; launches a call: B2 {n_one} "
        f"(rings), B2 {launches_p['ita_attention_onepass']} and B3 "
        f"{launches_p['ita_attention_onepass_paged']} (paged); "
        f"{card_line()}")
    dec = n_self * (gen - 1)
    sub = {"ita_attention_onepass": {
        "whisper_prefill": subrow("ita_attention_onepass", calls["prefill"],
                                  n_self, "11a self prefill"),
        "whisper_cross_prefill": subrow(
            "ita_attention_onepass", calls["cross_prefill"], n_self,
            "11a cross prefill (non-causal)"),
        "whisper_decode": subrow("ita_attention_onepass", calls["decode"],
                                 dec, "11a self decode"),
        "whisper_cross": subrow("ita_attention_onepass", calls["cross"],
                                dec, "11a cross decode (non-causal)")},
        "ita_attention_onepass_paged": {
            "whisper": subrow("ita_attention_onepass_paged", rec_p.kept[0],
                              dec, "11a (b) paged self decode")}}
    return figs, sub


def vision_phase(checks):
    """11b: llama-3.2-vision-90b at full width, ``VISION_PERIODS`` of its
    20 periods (module docstring). Returns the figures and sub-rows."""
    import torch

    from repro_torch.runtime.generate import generate
    model, cfg, nbytes, frontend = cross_model(
        "llama-3.2-vision-90b",
        layer_groups=((("attn", "attn", "attn", "attn", "cross"),
                       VISION_PERIODS),))
    prompts = prompt_batch(cfg)
    unpinned_raises(model, cfg, prompts, frontend, "11b")
    res, step, seen, n_one, calls = cross_generate(
        model, cfg, prompts, frontend, "11b", GEN, checks)
    lap("11b generate")
    _, busy = profile_run("11b llama-vision fused generate",
                          lambda: generate(model, cfg, prompts, GEN,
                                           frontend=frontend, device=DEV))
    floor = cross_floor_ms(model, cfg, B)
    figs = {"weights_gb": nbytes / 1e9, "floor_ms": floor,
            "prefill_s": res.prefill_s, "decode_tok_s": res.decode_tok_s,
            "step_ms": 1e3 * res.decode_s / res.decode_steps,
            "stepwise_tok_s": step.decode_tok_s, "busy": busy,
            "cross_bytes": cross_cache_bytes(cfg, B)}
    log(f"[phase11] 11b llama-3.2-vision-90b ({VISION_PERIODS} of 20 "
        f"periods): served by {seen}; prefill {figs['prefill_s']:.3f} s, "
        f"decode {figs['decode_tok_s']:.1f} tok/s ({figs['step_ms']:.2f} ms"
        f" a replayed step against a floor of {floor:.3f} ms), stepwise "
        f"{figs['stepwise_tok_s']:.1f} tok/s, busy {busy:.1%}; cross caches"
        f" {figs['cross_bytes']} bytes; tokens {res.tokens[0, :8].tolist()};"
        f" B2 {n_one} launches a call; {card_line()}")
    n_cross = VISION_PERIODS
    sub = {"ita_attention_onepass": {
        "llama_vision_cross_prefill": subrow(
            "ita_attention_onepass", calls["cross_prefill"], n_cross,
            "11b cross prefill (non-causal)"),
        "llama_vision_cross": subrow(
            "ita_attention_onepass", calls["cross"], n_cross * (GEN - 1),
            "11b cross decode (non-causal)")}}
    return figs, sub


def phase11(checks):
    """Phase 11: whisper-large-v3 (11a) and llama-3.2-vision-90b cut to
    ``VISION_PERIODS`` periods (11b), each in its own frame, freed before
    the next. Returns a result line and the kernels' sub-rows."""
    import torch
    out = {}
    for name, fn in (("w", whisper_phase), ("v", vision_phase)):
        out[name] = fn(checks)
        gc.collect()
        torch.cuda.empty_cache()
    (w, subs), (v, vsubs) = out["w"], out["v"]
    for kernel, rows in vsubs.items():
        subs.setdefault(kernel, {}).update(rows)
    line = (f"[result] phase 11: whisper-large-v3 ({w['weights_gb']:.2f} "
            f"GB) encoder {w['encoder_s']:.3f} s, prefill "
            f"{w['prefill_s']:.3f} s, decode {w['decode_tok_s']:.1f} tok/s,"
            f" step {w['step_ms']:.2f} ms (floor {w['floor_ms']:.3f}), "
            f"stepwise {w['stepwise_tok_s']:.1f} tok/s, paged "
            f"{w['paged_decode_tok_s']:.1f} tok/s, busy {w['busy']:.1%}, "
            f"cross caches {w['cross_bytes']} bytes, pad-copy "
            f"{w['pad_ms']:.3f} ms a step; llama-3.2-vision-90b "
            f"({VISION_PERIODS} period, {v['weights_gb']:.2f} GB) prefill "
            f"{v['prefill_s']:.3f} s, decode {v['decode_tok_s']:.1f} tok/s,"
            f" step {v['step_ms']:.2f} ms (floor {v['floor_ms']:.3f}), "
            f"busy {v['busy']:.1%}")
    return line, subs


# ---------------------------------------------------------------------------
# Phase 12: training at full width, then serving the trained weights
# ---------------------------------------------------------------------------

TRAIN_ARCH = "phi3-mini-3.8b"
TRAIN_B, TRAIN_SEQ, TRAIN_STEPS, TRAIN_LR = 4, 512, 8, 1e-3
TRAINED_GEN = 16                 # 12b's tokens
RESUME_LAYERS = 1                # 12c's depth: 1 of phi3-mini's 32 layers
RESUME_STEPS = 6                 # 12c: 6 straight against 3 + restore + 3
QAT_SCALES = ("s_q", "s_k", "s_v", "s_out")


def train_setup(cfg, steps, device=DEV, seed=0, seq=TRAIN_SEQ):
    """``cfg``'s model (random weights from ``seed``) with its AdamW state
    and train step (lr ``TRAIN_LR``, warmup 1), and its synthetic batch
    pipeline at ``TRAIN_B`` x ``seq``."""
    from repro_torch.data.pipeline import DataPipeline, SyntheticSource
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import init_model
    from repro_torch.optim.optimizer import (AdamWConfig, init_opt_state,
                                             train_params)
    model = init_model(cfg, seed=seed, device=device)
    opt_state = init_opt_state(train_params(model))
    step = make_train_step(cfg, AdamWConfig(lr=TRAIN_LR, warmup_steps=1,
                                            total_steps=steps))
    pipe = DataPipeline(SyntheticSource(cfg.vocab_size, seed=seed),
                        batch=TRAIN_B, seq_len=seq, device=device)
    return model, opt_state, step, pipe


def train_full_width(checks):
    """12a: phi3-mini-3.8b at full width and depth, ``TRAIN_STEPS`` steps
    of ``make_train_step`` on one repeated synthetic batch, driven
    directly (``TrainDriver``'s final save would write ~46 GB). Gates:
    finite losses and grad norms, the last loss below the first, every
    layer's ``s_q``/``s_k`` moved and ``s_v``/``s_out`` unchanged, every
    attention call served by ``ita_chunked_xla`` in train mode, no kernel
    launched. The last step runs under the profiler. Returns the model,
    its config and the figures."""
    import torch

    from repro_torch.configs.registry import get_config
    cfg = get_config(TRAIN_ARCH, attention_impl="ita")
    t0 = time.perf_counter()
    model, opt_state, step, pipe = train_setup(cfg, TRAIN_STEPS)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    state_bytes = sum(t.numel() * t.element_size() for t in
                      list(model.parameters()) + list(opt_state.mu.values())
                      + list(opt_state.nu.values())
                      + list(opt_state.master.values()))
    log(f"[phase12] {cfg.name} full width: {cfg.n_layers} layers, d "
        f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of "
        f"{cfg.head_dim}, SwiGLU {cfg.d_ff}, vocab {cfg.vocab_size}; "
        f"{n_params / 1e9:.3f} B parameters (stored {cfg.dtype}, master "
        f"float32), parameters + mu + nu + master {state_bytes / 1e9:.2f} "
        f"GB, init {time.perf_counter() - t0:.1f} s; allocated "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
    batch = pipe.next()
    scales = {n: p.detach().clone() for n, p in model.named_parameters()
              if n.endswith(QAT_SCALES)}
    torch.cuda.reset_peak_memory_stats()
    losses, norms, secs = [], [], []

    def steps():
        nonlocal opt_state
        for i in range(TRAIN_STEPS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            if i == TRAIN_STEPS - 1:
                (opt_state, m), busy = profile_run(
                    "12a train step", lambda: step(model, opt_state, batch))
            else:
                opt_state, m = step(model, opt_state, batch)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
            log(f"[phase12] 12a step {i + 1}: loss {losses[-1]:.5f}, grad "
                f"norm {norms[-1]:.4f}, lr {float(m['lr']):.2e}, "
                f"{secs[-1]:.3f} s")
        return busy
    reset_launches()
    busy, seen = served_by(steps)
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    if not all(map(math.isfinite, losses + norms)):
        raise AssertionError(f"12a: non-finite loss or grad norm: {losses}, "
                             f"{norms}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"12a: the loss did not fall: {losses}")
    if set(seen) != {("ita_chunked_xla", "train")}:
        raise AssertionError(f"12a: attention served by {seen}")
    if any(launches.values()):
        raise AssertionError(f"12a: a fused kernel launched: {launches}")
    params = dict(model.named_parameters())
    for n, before in scales.items():
        moved = not torch.equal(params[n].detach(), before)
        if moved != n.endswith(("s_q", "s_k")):
            raise AssertionError(f"12a: {n} {'moved' if moved else 'stayed'}"
                                 f" ({before.item()} -> {params[n].item()})")
    per_step = statistics.mean(secs[1:-1])
    tokens = TRAIN_B * TRAIN_SEQ
    figs = {"params_b": n_params / 1e9, "state_gb": state_bytes / 1e9,
            "peak_gb": peak / 1e9, "first_s": secs[0], "step_s": per_step,
            "tok_s": tokens / per_step, "busy": busy, "losses": losses,
            "attention_calls": sum(seen.values())}
    log(f"[phase12] 12a {TRAIN_STEPS} steps at {TRAIN_B} x {TRAIN_SEQ} (tokens "
        f"{TRAIN_B} x {TRAIN_SEQ + 1}): losses "
        f"{', '.join(f'{x:.4f}' for x in losses)}; grad norms "
        f"{', '.join(f'{x:.3f}' for x in norms)}; first step "
        f"{secs[0]:.3f} s, then {per_step:.3f} s a step (steps 2-"
        f"{TRAIN_STEPS - 1}), {tokens / per_step:.0f} tokens/s; profiled "
        f"step {secs[-1]:.3f} s, busy {busy:.1%}; peak allocated "
        f"{peak / 1e9:.2f} GB; attention {seen}; kernel launches "
        f"{sum(launches.values())}; s_q/s_k moved, s_v/s_out unchanged; "
        f"{card_line()}")
    # phase 13: a ninth step, counted (its weights are what 12b serves)
    from repro_torch.configs.base import ShapeConfig
    costs, opt_state = count_train_step(step, model, opt_state, batch)
    figs["roofline"] = roofline_record(
        f"{TRAIN_ARCH} train step", costs, cfg,
        ShapeConfig(f"train_{TRAIN_B}x{TRAIN_SEQ}", TRAIN_SEQ, TRAIN_B,
                    "train"), per_step)
    del opt_state, batch
    return model, cfg, figs


def serve_trained(model, cfg, checks):
    """12b: the trained phi3-mini's gradients switched off and its
    optimizer state freed, ``generate()`` unpinned at batch 4, prompt
    512, ``TRAINED_GEN`` tokens, fused twice and stepwise (equal tokens
    and launches), the chunked prefill then B4 every step, layer 0's
    first B4 call held to plain. Returns figures and the B4 sub-row."""
    import torch
    model.requires_grad_(False)
    gc.collect()
    torch.cuda.empty_cache()
    n = cfg.n_layers
    want = dict.fromkeys(SOURCES, 0)
    want["ita_attention_decode"] = n * (TRAINED_GEN - 1)
    res, step_res, seen, rec, n_dec, _ = generate_twice(
        model, cfg, prompt_batch(cfg), "12b phi3 trained",
        "ita_attention_decode", (0,), want, gen=TRAINED_GEN)
    check_served(seen, {"prefill": "ita_chunked_xla",
                        "decode": "ita_decode_pallas"}, "12b")
    check_recorded(checks, "ita_attention_decode", rec, 0,
                   "12b trained phi3, layer 0 of the first decode step")
    figs = {"prefill_s": res.prefill_s, "decode_tok_s": res.decode_tok_s,
            "step_ms": 1e3 * res.decode_s / res.decode_steps,
            "stepwise_tok_s": step_res.decode_tok_s}
    log(f"[phase12] 12b trained phi3 generate (unpinned): served by {seen};"
        f" prefill {figs['prefill_s']:.3f} s, decode "
        f"{figs['decode_tok_s']:.1f} tok/s ({figs['step_ms']:.2f} ms a "
        f"replayed step), stepwise {figs['stepwise_tok_s']:.1f} tok/s; "
        f"tokens {res.tokens[0, :8].tolist()}; B4 launches {n_dec}; "
        f"{card_line()}")
    sub = {"ita_attention_decode": {"phi3_trained": subrow(
        "ita_attention_decode", rec.kept[0], n_dec, "12b trained phi3")}}
    return figs, sub


def resume_bit_identical():
    """12c: phi3-mini at full width cut to ``RESUME_LAYERS`` layer(s):
    ``TrainDriver`` for ``RESUME_STEPS`` straight steps against half of
    them, a checkpoint, a restore in a new driver and the other half;
    parameters and optimizer state must be bit-identical. Deterministic
    algorithms are on for the phase (``warn_only``: an op without a
    deterministic version warns, and is named here). Checkpoints go to a
    temporary directory, removed afterwards. Returns the figures."""
    import shutil
    import tempfile
    import warnings

    import torch

    from repro_torch.checkpoint.checkpointing import Checkpointer
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.steps import tree_leaves
    from repro_torch.runtime.fault_tolerance import FTConfig, TrainDriver
    full = get_config(TRAIN_ARCH, attention_impl="ita")
    cfg = dataclasses.replace(
        full, layer_groups=((full.layer_groups[0][0], RESUME_LAYERS),))
    saves = []
    real_save = Checkpointer.save

    def timed_save(self, step, tree, extra=None, blocking=False):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fut = real_save(self, step, tree, extra=extra, blocking=blocking)
        saves.append({"step": step, "blocking": blocking,
                      "caller_s": time.perf_counter() - t,
                      "bytes": sum(x.numel() * x.element_size()
                                   for x in tree_leaves(tree))})
        return fut

    def driver(ckdir, every):
        model, opt_state, step, pipe = train_setup(cfg, RESUME_STEPS)
        return TrainDriver(FTConfig(ckpt_dir=ckdir, ckpt_every=every,
                                    keep=1), step, model, opt_state, pipe)

    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    half = RESUME_STEPS // 2
    torch.use_deterministic_algorithms(True, warn_only=True)
    Checkpointer.save = timed_save
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("default")
            straight = driver(f"{root}/straight", 10 ** 6)
            straight.run(RESUME_STEPS, log_every=0)
            shutil.rmtree(f"{root}/straight")
            first = driver(f"{root}/resume", half)
            first.run(half, log_every=0)
            del first
            resumed = driver(f"{root}/resume", half)
            t = time.perf_counter()
            if not resumed.maybe_restore() or resumed.step != half:
                raise AssertionError("12c: no checkpoint to restore")
            restore_s = time.perf_counter() - t
            resumed.run(RESUME_STEPS, log_every=0)
        a = tree_leaves({"params": dict(straight.model.named_parameters()),
                         "opt": straight.opt_state})
        b = tree_leaves({"params": dict(resumed.model.named_parameters()),
                         "opt": resumed.opt_state})
        differ = [i for i, (x, y) in enumerate(zip(a, b))
                  if not torch.equal(x, y)]
        if len(a) != len(b) or differ:
            raise AssertionError(f"12c: {len(differ)} of {len(a)} tensors "
                                 f"differ after the resume")
    finally:
        Checkpointer.save = real_save
        torch.use_deterministic_algorithms(False)
        shutil.rmtree(root, ignore_errors=True)
    nondet = sorted({str(w.message).split(" does not have a deterministic")[0]
                     [:120] for w in caught
                     if "deterministic" in str(w.message)})
    n_params = sum(p.numel() for p in straight.model.parameters())
    figs = {"params_m": n_params / 1e6, "saves": saves,
            "restore_s": restore_s, "nondeterministic": nondet,
            "tensors": len(a)}
    log(f"[phase12] 12c {cfg.name} at {RESUME_LAYERS} layer(s), full width "
        f"({n_params / 1e6:.1f} M parameters): {RESUME_STEPS} straight steps"
        f" == {half} + checkpoint + restore + {half}, {len(a)} tensors "
        f"(parameters, mu, nu, master, count) bit-identical; saves "
        + "; ".join(f"step {s['step']} {s['bytes']} B, caller "
                    f"{s['caller_s']:.3f} s{' (blocking)' * s['blocking']}"
                    for s in saves)
        + f"; restore {restore_s:.3f} s; ops without a deterministic "
        f"version: {nondet or 'none'}; {card_line()}")
    return figs


def train_step_card_vs_cpu():
    """12d: phi3-smoke, one train step at ``TRAIN_B`` x ``TRAIN_SEQ`` on
    the card against the CPU's on the same weights and batch
    (``repro_torch.launch.train_parity``, which ``tests/test_torch_cuda.py``
    runs too): ``float`` loss and grad norm within 1e-5, parameters within
    1e-5 of their scale but the under 1% a near-zero gradient stepped the
    other way (by at most 2·lr); ``ita`` loss as is within 5e-3 (a
    flipped ``s_out`` tie), and with the output fake-quant replaced by
    identity on both: loss within 1e-5, grad norm within 1e-4, every
    gradient within 1e-2 of its norm (a Q/K STE round may flip at a tie),
    the ``s_q``/``s_k`` gradients of the STE backward within 5e-5 and not
    zero, ``s_v``/``s_out`` zero, parameters held as under ``float``."""
    from repro_torch.launch.train_parity import (describe,
                                                 train_step_card_vs_cpu as
                                                 card_vs_cpu)
    out = {}
    for impl in ("float", "ita"):
        figs = card_vs_cpu(TRAIN_ARCH, impl, device=DEV, lr=TRAIN_LR,
                           batch=TRAIN_B, seq=TRAIN_SEQ)
        out[impl] = figs["loss_rel"]
        log(f"[phase12] 12d phi3-smoke train step, card vs CPU, "
            f"{describe(impl, figs)}")
    return out


WHISPER_TRAIN_STEPS = 2             # 12e: AdamW steps under each policy
WHISPER_TRAIN_SEQ = 448             # 12e: whisper's decoder context
WHISPER_TRAIN_LAYERS = 32           # 12e: encoder and decoder depth (of 32)
WHISPER_SERVE_PROMPT, WHISPER_SERVE_GEN = 64, 16
DOTS_TOL = 0.02                     # 12e: kept bytes against the formula


def dots_saved_bytes(cfg, batch, seq):
    """The ``mm`` outputs ``remat_policy="dots"`` keeps from one forward
    of a whisper-like stack (``enc`` blocks and ``attn_cross`` blocks with
    the GELU MLP), from the shapes: each ``linear`` of a block computes
    its rows in whole 128-row blocks, in the compute dtype. Encoder
    layer: Q, K, V, the output and both MLP projections over the
    ``batch x n_frontend_tokens`` frames; decoder layer: self Q, K, V and
    output, cross Q and output, both MLP projections over ``batch x
    seq`` tokens, and the cross K and V over the frames. Returns bytes
    by part."""
    import torch

    from repro_torch.roofline.op_costs import padded_rows
    kinds = {k for pat, _ in cfg.layer_groups for k in pat}
    if kinds != {"attn_cross"} or cfg.mlp_type != "gelu":
        raise ValueError(f"dots_saved_bytes covers whisper's blocks, not "
                         f"{sorted(kinds)} with {cfg.mlp_type}")
    size = torch.empty((), dtype=cfg.compute_dtype()).element_size()
    d, hd, ff = cfg.d_model, cfg.head_dim, cfg.d_ff
    q, kv = cfg.n_heads * hd, cfg.n_kv_heads * hd
    frames = padded_rows(batch * cfg.n_frontend_tokens)
    tokens = padded_rows(batch * seq)
    mlp = ff + d
    return {"encoder": size * frames * (q + 2 * kv + d + mlp)
            * cfg.n_encoder_layers,
            "decoder": size * tokens * (q + 2 * kv + d + q + d + mlp)
            * cfg.n_layers,
            "cross_kv": size * frames * 2 * kv * cfg.n_layers}


def forward_held_bytes(model, cfg, batch):
    """Bytes ``loss_fn``'s forward leaves allocated for its backward (read
    before ``.backward()``, which never runs: the graph is dropped)."""
    import torch

    from repro_torch.models import loss_fn
    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    loss, _ = loss_fn(model, batch, cfg)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() - before
    del loss
    gc.collect()
    return held


def whisper_train_policy(cfg, frontend, label):
    """12e (i)/(ii): whisper from seed 0, ``WHISPER_TRAIN_STEPS`` steps of
    ``make_train_step`` under ``cfg.remat_policy`` on the pipeline's
    tokens and ``frontend``; every attention call on ``ita_chunked_xla``
    in train mode, no kernel launched. Returns the model, its AdamW state
    and the figures (each step's seconds and loss tensor, the last step
    profiled and its busy share; the peak allocation, printed also above
    the state resident at the first step; the batches)."""
    import torch
    model, opt_state, step, pipe = train_setup(cfg, WHISPER_TRAIN_STEPS,
                                               seq=WHISPER_TRAIN_SEQ)
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    secs, losses, batches, busy = [], [], [], [0.0]

    def steps():
        nonlocal opt_state
        for i in range(WHISPER_TRAIN_STEPS):
            batch = {"tokens": pipe.next()["tokens"], "frontend": frontend}
            batches.append(batch)
            torch.cuda.synchronize()
            t = time.perf_counter()
            if i == WHISPER_TRAIN_STEPS - 1:
                (opt_state, m), busy[0] = profile_run(
                    f"12e {label} ({cfg.remat_policy}) train step",
                    lambda: step(model, opt_state, batch))
            else:
                opt_state, m = step(model, opt_state, batch)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t)
            losses.append(m["loss"].clone())
            log(f"[phase12] 12e {label} ({cfg.remat_policy}) step {i + 1}: "
                f"loss {float(m['loss']):.6f}, grad norm "
                f"{float(m['grad_norm']):.4f}, {secs[-1]:.3f} s")
    reset_launches()
    _, seen = served_by(steps)
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    if set(seen) != {("ita_chunked_xla", "train")}:
        raise AssertionError(f"12e {label}: attention served by {seen}")
    if any(launches.values()):
        raise AssertionError(f"12e {label}: a fused kernel launched: "
                             f"{launches}")
    if not all(math.isfinite(float(x)) for x in losses):
        raise AssertionError(f"12e {label}: non-finite loss {losses}")
    log(f"[phase12] 12e {label} ({cfg.remat_policy}): step s "
        f"{', '.join(f'{x:.3f}' for x in secs)} (the last profiled, busy "
        f"{busy[0]:.1%}); peak allocated "
        f"{peak / 1e9:.2f} GB, {(peak - resident) / 1e9:.2f} GB above the "
        f"{resident / 1e9:.2f} GB resident at the first step; "
        f"{card_line()}")
    return model, opt_state, {"secs": secs, "losses": losses, "peak": peak,
                              "busy": busy[0], "batches": batches}


def whisper_train_phase(checks):
    """12e: whisper-large-v3 at full width (``WHISPER_TRAIN_LAYERS`` of its
    32 encoder and 32 decoder layers; bf16 storage, a float32 master),
    trained on ``TRAIN_B`` x ``WHISPER_TRAIN_SEQ`` tokens over a seeded
    1500-frame float32 frontend: (i) under its own ``remat_policy="dots"``
    and (ii) from seed 0 again under ``"full"``. Gates: losses equal bit
    for bit, and after the last step every parameter, master, ``mu`` and
    ``nu`` of (ii) ``torch.equal`` to (i)'s (both states on the card);
    the bytes one ``loss_fn`` forward holds for its backward, dots minus
    full, within ``DOTS_TOL`` of ``dots_saved_bytes``. Then the trained
    weights served through B2 (``cross_generate``: pinned to onepass on
    rings, fused twice and stepwise, launches counted, layer 0's self and
    cross calls held to plain). Returns the figures and the B2 sub-row."""
    import torch

    from repro_torch.configs.registry import get_config
    full = get_config("whisper-large-v3", attention_impl="ita")
    if full.remat_policy != "dots":
        raise AssertionError(f"12e: whisper's policy {full.remat_policy}")
    cfg = dataclasses.replace(
        full, n_encoder_layers=WHISPER_TRAIN_LAYERS,
        layer_groups=((full.layer_groups[0][0], WHISPER_TRAIN_LAYERS),))
    frontend = torch.randn((TRAIN_B, cfg.n_frontend_tokens,
                            cfg.frontend_dim),
                           generator=torch.Generator().manual_seed(13)
                           ).to(DEV)
    runs = {}
    for label, policy in (("(i)", "dots"), ("(ii)", "full")):
        runs[policy] = whisper_train_policy(
            dataclasses.replace(cfg, remat_policy=policy), frontend, label)
        gc.collect()
    (m_d, o_d, dots), (model, opt_state, fullr) = runs["dots"], runs["full"]
    n_params = sum(p.numel() for p in model.parameters())
    if not all(torch.equal(a, b) for a, b in zip(dots["losses"],
                                                fullr["losses"])):
        raise AssertionError(f"12e: losses differ: {dots['losses']} != "
                             f"{fullr['losses']}")
    got = dict(m_d.named_parameters())
    compared = 0
    for n, p in model.named_parameters():
        for a, b_ in ((p, got[n]), (opt_state.master[n], o_d.master[n]),
                      (opt_state.mu[n], o_d.mu[n]),
                      (opt_state.nu[n], o_d.nu[n])):
            if not torch.equal(a, b_):
                raise AssertionError(f"12e: {n} differs between dots and "
                                     f"full after step "
                                     f"{WHISPER_TRAIN_STEPS}")
            compared += 1
    del m_d, o_d, runs
    gc.collect()
    torch.cuda.empty_cache()
    lap("12e train (i) dots, (ii) full")
    # Gate 2: what one forward keeps for its backward under each policy
    held = {pol: forward_held_bytes(model, dataclasses.replace(
        cfg, remat_policy=pol), fullr["batches"][0])
        for pol in ("dots", "full")}
    for r in (dots, fullr):
        del r["batches"]
    parts = dots_saved_bytes(cfg, TRAIN_B, WHISPER_TRAIN_SEQ)
    want = sum(parts.values())
    diff = held["dots"] - held["full"]
    rel = diff / want - 1
    log(f"[phase12] 12e one forward holds {held['dots']} B under dots, "
        f"{held['full']} B under full: {diff} B more against "
        f"{want} B of kept mm outputs by the formula ("
        + ", ".join(f"{k} {v}" for k, v in parts.items())
        + f"), {rel:+.4%}; {card_line()}")
    if abs(rel) > DOTS_TOL:
        raise AssertionError(f"12e: dots keeps {diff} B more than full, "
                             f"the formula {want} B ({rel:+.2%})")
    lap("12e memory")
    # serve the trained weights through B2
    model.requires_grad_(False)
    del opt_state
    gc.collect()
    torch.cuda.empty_cache()
    serve_cfg = dataclasses.replace(cfg, attention_backend=PIN)
    prompts = torch.randint(0, cfg.vocab_size, (B, WHISPER_SERVE_PROMPT),
                            generator=torch.Generator().manual_seed(14))
    gen = WHISPER_SERVE_GEN
    res, step_res, seen, n_one, calls = cross_generate(
        model, serve_cfg, prompts, frontend, "12e trained whisper", gen,
        checks)
    n_self, _ = cross_counts(serve_cfg)
    dec = n_self * (gen - 1)
    sub = {"ita_attention_onepass": {"whisper_trained": subrow(
        "ita_attention_onepass", calls["decode"], dec,
        "12e trained whisper self decode")}}
    figs = {"params_b": n_params / 1e9, "layers": WHISPER_TRAIN_LAYERS,
            "dots": dots, "full": fullr, "held": held, "saved": want,
            "rel": rel, "decode_tok_s": res.decode_tok_s}
    log(f"[phase12] 12e whisper-large-v3 at {WHISPER_TRAIN_LAYERS}/"
        f"{WHISPER_TRAIN_LAYERS} layers, full width ({n_params / 1e9:.3f} "
        f"B parameters): losses {[float(x) for x in fullr['losses']]} "
        f"bit-identical under dots and full, {compared} tensors (parameters, masters, mu, nu) "
        f"bit-identical; step s dots "
        f"{', '.join(f'{x:.3f}' for x in dots['secs'])}, full "
        f"{', '.join(f'{x:.3f}' for x in fullr['secs'])}; peak allocated "
        f"dots {dots['peak'] / 1e9:.2f} GB, full {fullr['peak'] / 1e9:.2f} "
        f"GB; trained serve (onepass pin, {B} x {WHISPER_SERVE_PROMPT}, "
        f"{gen} tokens): served by {seen}, prefill {res.prefill_s:.3f} s, "
        f"decode {res.decode_tok_s:.1f} tok/s, stepwise "
        f"{step_res.decode_tok_s:.1f} tok/s, B2 launches {n_one}, tokens "
        f"{res.tokens[0, :8].tolist()}; the card's total_memory "
        f"{torch.cuda.get_device_properties(0).total_memory} B; "
        f"{card_line()}")
    return figs, sub


def phase12(checks):
    """Phase 12: 12a train phi3-mini-3.8b at full width, 12b serve its
    trained weights (B4), then, after it is freed, 12c the bit-identical
    resume at one layer, 12d the card against the CPU and 12e whisper
    trained under both remat policies and served (B2). Returns a result
    line and the kernels' sub-rows."""
    import torch
    model, cfg, train = train_full_width(checks)
    lap("12a train")
    serve, subs = serve_trained(model, cfg, checks)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    lap("12b serve")
    resume = resume_bit_identical()
    gc.collect()
    torch.cuda.empty_cache()
    lap("12c resume")
    card_cpu = train_step_card_vs_cpu()
    lap("12d card vs CPU")
    gc.collect()
    torch.cuda.empty_cache()
    w, w_subs = whisper_train_phase(checks)
    for kernel, rows in w_subs.items():
        subs.setdefault(kernel, {}).update(rows)
    lap("12e whisper")
    line = (f"[result] phase 12: {TRAIN_ARCH} train ({train['params_b']:.3f}"
            f" B parameters, state {train['state_gb']:.2f} GB) "
            f"{train['step_s']:.3f} s a step at {TRAIN_B} x {TRAIN_SEQ}, "
            f"{train['tok_s']:.0f} tokens/s, first step "
            f"{train['first_s']:.3f} s, busy {train['busy']:.1%}, peak "
            f"allocated {train['peak_gb']:.2f} GB, loss "
            f"{train['losses'][0]:.4f} -> {train['losses'][-1]:.4f}; trained "
            f"serve prefill {serve['prefill_s']:.3f} s, decode "
            f"{serve['decode_tok_s']:.1f} tok/s ({serve['step_ms']:.2f} ms), "
            f"stepwise {serve['stepwise_tok_s']:.1f} tok/s; resume at "
            f"{RESUME_LAYERS} layer ({resume['params_m']:.1f} M) "
            f"bit-identical, saves "
            + ", ".join(f"{s['bytes']} B {s['caller_s']:.3f} s"
                        f"{' blocking' * s['blocking']}"
                        for s in resume["saves"])
            + f", restore {resume['restore_s']:.3f} s; card vs CPU loss rel "
            f"float {card_cpu['float']:.2e}, ita {card_cpu['ita']:.2e}; "
            f"12e whisper-large-v3 ({w['layers']} + {w['layers']} layers, "
            f"{w['params_b']:.3f} B parameters) at {TRAIN_B} x "
            f"{WHISPER_TRAIN_SEQ}: step s dots "
            f"{', '.join(f'{x:.3f}' for x in w['dots']['secs'])} (busy "
            f"{w['dots']['busy']:.1%}), full "
            f"{', '.join(f'{x:.3f}' for x in w['full']['secs'])} (busy "
            f"{w['full']['busy']:.1%}), peak dots "
            f"{w['dots']['peak'] / 1e9:.2f} GB, full "
            f"{w['full']['peak'] / 1e9:.2f} GB, bit-identical; a forward "
            f"holds {(w['held']['dots'] - w['held']['full']) / 1e9:.3f} GB "
            f"more under dots ({w['rel']:+.3%} of the kept mm outputs' "
            f"{w['saved'] / 1e9:.3f} GB); trained serve decode "
            f"{w['decode_tok_s']:.1f} tok/s")
    return line, subs, [train["roofline"]]


# ---------------------------------------------------------------------------
# Phase 13: each path's roofline (repro_torch.roofline)
# ---------------------------------------------------------------------------

def roofline_record(label, costs, cfg, shape, measured_s):
    """One path's roofline: ``Roofline.row()`` of its counted eager step
    (``op_costs``) beside the measured step, its ``mfu`` and ``share``.
    Gates: ``share`` and ``mfu`` in (0, 1.05]; the counted FLOPs outside
    the attention equal ``op_costs.expected_flops``, the analytic
    ``model_flops`` matmul term at the rows the port computes, exactly
    (as ``tests/test_torch_roofline.py`` holds them)."""
    from repro_torch.roofline import op_costs as OC
    from repro_torch.roofline.analysis import matmul_term, model_flops
    roof = costs.roofline(model_flops(cfg, shape))
    want = OC.expected_flops(cfg, shape)
    got = {fam: costs.flops.get(fam, 0.0) for fam in want}
    if got != want:
        raise AssertionError(f"13 {label}: counted {got} != analytic {want}")
    mfu, share = roof.mfu(measured_s), roof.share(measured_s)
    if not (0 < mfu <= 1.05 and 0 < share <= 1.05):
        raise AssertionError(f"13 {label}: mfu {mfu} or share {share} "
                             f"outside (0, 1.05]")
    rec = {"path": label, "arch": cfg.name, "layers": cfg.n_layers,
           "shape": dataclasses.asdict(shape), "card": card_line(),
           **roof.row(), "measured_s": measured_s, "mfu": mfu,
           "share": share, "families": dict(costs.flops),
           "expected": want, "matmul_term": matmul_term(cfg, shape),
           "kernel_ops": sum(costs.kernel_ops.values()),
           "kernel_calls": dict(costs.kernel_calls)}
    log(f"[roofline] {label}: compute {roof.compute_s * 1e3:.4f} ms (int8 "
        f"{roof.flops_int8:.4g}, bf16 {roof.flops_bf16:.4g}, fp32 "
        f"{roof.flops_fp32:.4g}), memory {roof.memory_s * 1e3:.4f} ms "
        f"({roof.hbm_bytes:.4g} B), bottleneck {roof.bottleneck}, "
        f"model_flops {roof.model_flops:.4g}, useful {roof.useful_ratio:.4f}"
        f"; measured {measured_s * 1e3:.3f} ms, mfu {mfu:.5f}, share "
        f"{share:.5f}; matmul FLOPs by family {rec['families']} (analytic "
        f"{want}; model_flops' matmul term {rec['matmul_term']:.4g}), "
        f"kernel calls {rec['kernel_calls']}; {card_line()}")
    return rec


def counted_decode_step(model, cfg):
    """Prefill run (a)'s prompts eagerly on fresh rings, then count one
    decode step eagerly (a replay records nothing): ``(costs, shape)``."""
    import torch

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models import forward, init_caches
    from repro_torch.roofline import op_costs as OC
    prompts = prompt_batch(cfg).to(DEV)
    with torch.inference_mode():
        logits, caches = forward(model, prompts, cfg, mode="prefill",
                                 caches=init_caches(cfg, B, RING,
                                                    device=DEV))
        tok = torch.argmax(logits[:, -1:], -1)
        with OC.counting() as costs:
            forward(model, tok, cfg, mode="decode", caches=caches,
                    pos0=torch.full((B,), PROMPT, device=DEV))
    torch.cuda.synchronize()
    return costs, ShapeConfig(f"decode_{B}x{PROMPT + 1}", PROMPT + 1, B,
                              "decode")


def qwen2_roofline(model, cfg, metrics):
    """Phase 13 on qwen2-7b (a): the chunked prefill at 4 x 512 (counted
    once, then timed uncounted) and the decode step (counted eagerly,
    measured as (a)'s replayed step)."""
    import torch

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models import forward, init_caches
    from repro_torch.roofline import op_costs as OC
    prompts = prompt_batch(cfg).to(DEV)

    def prefill():
        return forward(model, prompts, cfg, mode="prefill",
                       caches=init_caches(cfg, B, RING, device=DEV))
    with torch.inference_mode():
        with OC.counting() as costs:
            prefill()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prefill()
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
    recs = [roofline_record("qwen2-7b (a) prefill", costs, cfg,
                            ShapeConfig(f"prefill_{B}x{PROMPT}", PROMPT, B,
                                        "prefill"), prefill_s)]
    costs, shape = counted_decode_step(model, cfg)
    recs.append(roofline_record("qwen2-7b (a) decode step (replayed)",
                                costs, cfg, shape, metrics["step_s"]))
    return recs


def count_train_step(step, model, opt_state, batch):
    """One more train step, counted (``op_costs``); returns its costs and
    the optimizer state."""
    from repro_torch.roofline import op_costs as OC
    with OC.counting() as costs:
        opt_state, _ = step(model, opt_state, batch)
    return costs, opt_state


# ---------------------------------------------------------------------------
# Phase 14: the range certificates, the loop lints, the kernels at the
# declared extremes (repro_torch.analysis)
# ---------------------------------------------------------------------------

def phase14():
    """The 18-case matrix at the full geometry (traced on the CPU), all
    six lints on the card, and the nine kernels at the declared extremes
    bit-exact to their plain versions inside their certificates' proven
    output intervals. Returns the result line."""
    from repro_torch.analysis.extremes import KERNELS, check_extremes
    from repro_torch.analysis.lints import run_lints
    from repro_torch.analysis.verify import run_verification
    t0 = time.perf_counter()
    rep = run_verification(smoke=False)
    for c in rep["cases"]:
        log(f"[analysis] {'PASS' if c['ok'] else 'FAIL'} {c['name']}: "
            f"{c.get('n_ops')} ops, max|int| {c.get('max_int_magnitude')}, "
            f"out {c.get('out')}, {c.get('error', '')}"
            + "".join(f"; finding {f['kind']} {f['prim']} {f['ival']}"
                      for f in c.get("findings", [])[:3]))
    bad = [c["name"] for c in rep["cases"] if not c["ok"]]
    if rep["n_cases"] != 18 or bad:
        raise AssertionError(f"14: certificates failed: {bad}")
    matrix_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    lints = run_lints(smoke=False, device=DEV)["lints"]
    for lint in lints:
        log(f"[analysis] lint {lint['name']}: ran {lint['ran']}, ok "
            f"{lint['ok']}: {lint['detail']}")
    if len(lints) != 6 or not all(x["ran"] and x["ok"] for x in lints):
        raise AssertionError("14: a lint failed or did not run")
    lints_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    rows = check_extremes(DEV)
    for r in rows:
        log(f"[analysis] extremes {r['kernel']} ({r['variant']}): certified "
            f"{r['certified']}, bit-exact {r['equal']}, inside {r['inside']}"
            f"; proven {r['proven']}, seen {r['seen']}")
    bad = [(r["kernel"], r["variant"]) for r in rows
           if not (r["certified"] and r["equal"] and r["inside"])]
    if bad or {r["kernel"] for r in rows} != set(KERNELS):
        raise AssertionError(f"14: kernels at the extremes failed: {bad}")
    return (f"[result] phase 14: 18/18 certificates at the full geometry "
            f"({matrix_s:.1f} s), 6/6 lints on the card ({lints_s:.1f} s), "
            f"{len(rows)} extreme calls of the 9 kernels bit-exact inside "
            f"their certificates ({time.perf_counter() - t0:.1f} s)")


# ---------------------------------------------------------------------------
# Phase 15: the multi-card layer on a mesh of one card
# ---------------------------------------------------------------------------

# 15b's depth: 8 of phi3-mini-3.8b's 32 layers, widths unchanged (two
# models and their AdamW states side by side)
PHI3_SHARD_LAYERS = 8
WHISPER_SHARD_LAYERS = 2           # 15b: whisper's depth, each stack
# 15d: the dry-run's cells on the (16, 16) production mesh, on the CPU
DRYRUN_CELLS = (("qwen2-7b", "decode_32k"), ("mixtral-8x7b", "train_4k"),
                ("llama-3.2-vision-90b", "prefill_32k"))


def start_dryruns(out_dir):
    """15d: one ``python -m repro_torch.launch.dryrun`` subprocess a cell,
    on the CPU (no card visible), all started at once."""
    import os
    procs = []
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    for arch, shape in DRYRUN_CELLS:
        out = Path(out_dir) / f"{arch}_{shape}.jsonl"
        procs.append((arch, shape, out, subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--out", str(out)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    return procs


def finish_dryruns(procs):
    """15d: every subprocess's exit code and record; each record's
    per-device bytes and bottleneck printed."""
    lines = []
    for arch, shape, out, proc in procs:
        stdout, stderr = proc.communicate(timeout=300)
        if proc.returncode != 0 or not out.exists():
            raise AssertionError(f"15d dry-run {arch} x {shape} exited "
                                 f"{proc.returncode}: {stderr[-2000:]}")
        rec = json.loads(out.read_text().splitlines()[-1])
        if rec["status"] != "ok":
            raise AssertionError(f"15d dry-run {arch} x {shape}: "
                                 f"{rec.get('error')}")
        mem, roof = rec["memory"], rec["roofline"]
        lines.append(
            f"{arch} x {shape} [{rec['mesh']}]: arguments "
            f"{mem['argument_bytes'] / 2**30:.3f} GiB/device, outputs "
            f"{mem['output_bytes'] / 2**30:.3f}, temporaries "
            f"{mem['temp_bytes'] / 2**30:.3f}, collectives "
            f"{rec['collectives']['total_bytes']:.4e} B "
            f"{rec['collectives']['counts']}, bottleneck "
            f"{roof['bottleneck']} (compute {roof['compute_s']:.4e} s, "
            f"memory {roof['memory_s']:.4e} s, collective "
            f"{roof['collective_s']:.4e} s), useful "
            f"{roof['useful_ratio']:.3f}, {rec['step_s']:.1f} s")
        log(f"[phase15] 15d dry-run {lines[-1]}")
    return lines


def sharded_generate(model, cfg, prompts, mesh):
    """``generate()``'s greedy run through ``shard_cell``'s prefill and
    decode steps on DTensors placed by the rules: ``(tokens, launches,
    prefill_s, decode_s)``, the launch counters zeroed just before and
    read just after."""
    import torch

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import sharding as SH
    from repro_torch.launch.steps import map_pairs, shard_cell
    from repro_torch.models import init_caches
    b, s = prompts.shape
    max_len = s + GEN
    prefill = shard_cell(cfg, ShapeConfig("prefill", s, b, "prefill"), mesh)
    decode = shard_cell(cfg, ShapeConfig("decode", max_len, b, "decode"),
                        mesh)
    caches = init_caches(cfg, b, max_len, device=DEV)
    caches = map_pairs(lambda _, t, sh: SH.place(t, sh), caches,
                       SH.cache_shardings(caches, b, mesh))

    def batch(t):
        return SH.place(t, SH.Sharding(mesh, SH.batch_spec(
            t.shape, mesh, cfg.parallelism)))

    def greedy(logits):
        return torch.argmax(logits.full_tensor(), dim=-1).to(torch.int32)
    pos = torch.full((b,), s, dtype=torch.int32, device=DEV)
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, caches = prefill(model, batch(prompts.to(DEV)), caches)
    toks = [greedy(logits)]
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for i in range(GEN - 1):
        logits, caches = decode(model, batch(toks[-1]), caches,
                                pos0=SH.place(pos + i, SH.replicated(mesh)))
        toks.append(greedy(logits))
    launches = read_launches()
    t2 = time.perf_counter()
    return torch.cat(toks, dim=1), launches, t1 - t0, t2 - t1


def phase15_qwen2(mesh, card):
    """15a: qwen2-7b at full width (``QWEN2_LAYERS`` layers, a new model
    from phase 3's seed in place of the freed one): unsharded
    ``generate()`` (a) unpinned and (b) onepass-pinned, then the model
    sharded onto the mesh in place (``shard_model``: on one rank each
    DTensor holds the very tensor the parameter held) and each run again
    through ``shard_cell``. Gates: equal tokens; (a)'s B4 and (b)'s B2
    launched as the unsharded runs launch them."""
    import torch

    from repro_torch.launch.sharding import shard_model
    model, cfg = full_width_model()
    prompts = prompt_batch(cfg)
    cfgs = {"a": cfg, "b": dataclasses.replace(
        cfg, attention_backend="ita_onepass_pallas")}
    want = {k: run_generate(model, c, prompts)[:2] for k, c in cfgs.items()}
    ptrs = [p.data_ptr() for p in model.parameters()]
    shard_model(model, mesh)
    if [p.to_local().data_ptr() for p in model.parameters()] != ptrs:
        raise AssertionError("15a: shard_model copied a parameter")
    parts = []
    for k, c in cfgs.items():
        toks, launches, pre_s, dec_s = sharded_generate(model, c, prompts,
                                                        mesh)
        res, unsharded = want[k]
        if not torch.equal(toks.cpu(), res.tokens.cpu()):
            raise AssertionError(f"15a ({k}): sharded tokens differ from "
                                 f"generate()'s")
        if launches != unsharded:
            raise AssertionError(f"15a ({k}): sharded launches {launches} "
                                 f"!= generate()'s {unsharded}")
        b2, b4 = launches["ita_attention_onepass"], \
            launches["ita_attention_decode"]
        if (b4 if k == "a" else b2) == 0:
            raise AssertionError(f"15a ({k}): no kernel launched")
        log(f"[phase15] 15a qwen2-7b ({k}) sharded on (data=1, model=1): "
            f"tokens equal to generate()'s ({toks[0, :6].tolist()}...); "
            f"launches B2 {b2}, B4 {b4}; prefill {pre_s:.3f} s, eager "
            f"decode {B * (GEN - 1) / dec_s:.1f} tok/s; {card}")
        parts.append(f"({k}) B2 {b2} B4 {b4} prefill {pre_s:.3f} s decode "
                     f"{B * (GEN - 1) / dec_s:.1f} tok/s")
    return "15a qwen2-7b sharded tokens equal, " + "; ".join(parts)


def phase15_train(mesh, card, cfg, label, seq=TRAIN_SEQ):
    """15b: ``cfg`` (a full-width model cut in depth): two steps of
    ``make_train_step`` and of ``shard_train_step`` on a sharded copy
    from the same seed, on the same batch (``TRAIN_B`` x ``seq`` tokens,
    and a seeded frontend for a cross stack). Gate: the losses and every
    parameter and AdamW moment bit-identical (on one rank the sharded
    step runs the same kernels on the same tensors). Returns the result
    line's part."""
    import torch

    from repro_torch.launch import sharding as SH
    from repro_torch.launch.steps import shard_train_step
    from repro_torch.models import init_model
    from repro_torch.optim.optimizer import AdamWConfig, init_opt_state
    torch.cuda.reset_peak_memory_stats()
    model, opt, step, pipe = train_setup(cfg, 2, seq=seq)
    sharded = SH.shard_model(init_model(cfg, seed=0, device=DEV), mesh)
    s_opt = init_opt_state(dict(sharded.named_parameters()))
    s_step = shard_train_step(cfg, mesh, AdamWConfig(
        lr=TRAIN_LR, warmup_steps=1, total_steps=2))
    batch = pipe.next()
    if cfg.frontend_dim:
        batch["frontend"] = torch.randn(
            (TRAIN_B, cfg.n_frontend_tokens, cfg.frontend_dim),
            generator=torch.Generator().manual_seed(13)).to(DEV)
    s_batch = {k: SH.place(v, SH.Sharding(mesh, SH.batch_spec(
        v.shape, mesh, cfg.parallelism))) for k, v in batch.items()}
    losses, secs = [], []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        opt, m = step(model, opt, batch)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        s_opt, sm = s_step(sharded, s_opt, s_batch)
        torch.cuda.synchronize()
        secs.append((t1 - t0, time.perf_counter() - t1))
        if not torch.equal(m["loss"], sm["loss"]):
            raise AssertionError(f"15b {label}: sharded loss "
                                 f"{float(sm['loss'])!r} != "
                                 f"{float(m['loss'])!r}")
        losses.append(float(m["loss"]))
    got = dict(sharded.named_parameters())
    for n, p in model.named_parameters():
        for a, b_ in ((p, got[n]), (opt.mu[n], s_opt.mu[n]),
                      (opt.nu[n], s_opt.nu[n])):
            if not torch.equal(a, b_.to_local()):
                raise AssertionError(f"15b {label}: {n} differs after the "
                                     f"sharded step")
    n_params = sum(p.numel() for p in model.parameters())
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"[phase15] 15b {label} ({n_params / 1e9:.3f} B parameters, "
        f"parallelism {cfg.parallelism}, remat_policy {cfg.remat_policy}) "
        f"on (data=1, model=1): 2 steps at {TRAIN_B} x {seq + 1}, losses "
        f"{losses} bit-identical to make_train_step's, every parameter, mu "
        f"and nu bit-identical; step s unsharded/sharded "
        + ", ".join(f"{a:.3f}/{b_:.3f}" for a, b_ in secs)
        + f"; peak allocated {peak:.2f} GB; {card}")
    return (f"15b {label} sharded train step bit-identical, step s "
            + ", ".join(f"{a:.3f}/{b_:.3f}" for a, b_ in secs))


def phase15_trains(mesh, card):
    """15b on phi3-mini-3.8b at full width cut to ``PHI3_SHARD_LAYERS``
    layers, then on whisper-large-v3 at full width cut to
    ``WHISPER_SHARD_LAYERS`` encoder and decoder layers under its own
    ``fsdp`` and ``remat_policy="dots"`` (the per-layer gathers recomputed
    in the backward, the products kept)."""
    import torch

    from repro_torch.configs.registry import get_config
    phi3 = get_config(TRAIN_ARCH, attention_impl="ita",
                      layer_groups=((("attn",), PHI3_SHARD_LAYERS),))
    parts = [phase15_train(mesh, card, phi3,
                           f"phi3-mini ({PHI3_SHARD_LAYERS} of 32 layers)")]
    gc.collect()
    torch.cuda.empty_cache()
    whisper = get_config("whisper-large-v3", attention_impl="ita",
                         n_encoder_layers=WHISPER_SHARD_LAYERS,
                         layer_groups=((("attn_cross",),
                                        WHISPER_SHARD_LAYERS),))
    parts.append(phase15_train(
        mesh, card, whisper, f"whisper-large-v3 ({WHISPER_SHARD_LAYERS} + "
        f"{WHISPER_SHARD_LAYERS} of 32 + 32 layers, dots)",
        seq=WHISPER_TRAIN_SEQ))
    return "; ".join(parts)


def phase15_psum(mesh, card):
    """15c: ``compressed_psum`` of a float32 (4096, 1024) tensor over the
    NCCL group (its all-gathers run on one rank too), bit-equal to the
    reference's formula on this rank's input."""
    import torch

    from repro_torch.runtime import compression as C
    x = torch.randn((4096, 1024), generator=torch.Generator(
        device=DEV).manual_seed(15), device=DEV)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = C.compressed_psum(x, "data", mesh)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    q, scale = C._quantize(x)
    want = torch.tensordot(scale.reshape(1), q[None], dims=([0], [0]))
    if not torch.equal(got, want):
        raise AssertionError("15c: compressed_psum differs from the "
                             "formula")
    err = float((got - x).abs().max())
    log(f"[phase15] 15c compressed_psum over NCCL (world 1): bit-equal to "
        f"the formula; max |x - psum| {err:.3e} (scale "
        f"{float(scale):.3e}); wire {x.numel() + 4} B vs float32 "
        f"{x.numel() * 4} B; {ms:.3f} ms (first call); {card}")
    return f"15c compressed_psum bit-equal, {ms:.3f} ms"


def phase15(card):
    """Phase 15: a world-size-1 NCCL process group on a free local port
    and the (data=1, model=1) mesh over it; 15a-15c on the card while
    15d's dry-runs run on the CPU; the group destroyed at the end."""
    import tempfile

    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import free_port, make_host_mesh
    with tempfile.TemporaryDirectory() as tmp:
        procs = start_dryruns(tmp)
        try:
            dist.init_process_group(
                "nccl", init_method=f"tcp://127.0.0.1:{free_port()}",
                rank=0, world_size=1,
                device_id=torch.device("cuda", torch.cuda.current_device()))
            try:
                mesh = make_host_mesh()
                log(f"[phase15] NCCL world 1, mesh {mesh}")
                parts = [phase15_qwen2(mesh, card)]
                gc.collect()
                torch.cuda.empty_cache()
                parts.append(phase15_trains(mesh, card))
                gc.collect()
                torch.cuda.empty_cache()
                parts.append(phase15_psum(mesh, card))
            finally:
                dist.destroy_process_group()
            dry = finish_dryruns(procs)
        finally:
            for *_, proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
    return "[result] phase 15: " + "; ".join(parts) + "; 15d dry-run " \
        + "; ".join(dry)


def qwen2_phases(checks):
    """Phases 3-7 and 8a-8b on full-width qwen2-7b. Returns the kernels
    line's rows and the result line; the model and everything built on it
    are freed with this frame."""
    model, cfg = full_width_model()
    metrics, captured = full_width(model, cfg, checks)
    lap("phase 3")
    roof = qwen2_roofline(model, cfg, metrics)
    lap("phase 13 qwen2-7b")
    softmax_inputs, softmax_launches = full_width_softmax(
        captured["twopass"][2][1], checks)
    served, serve_launches, serve_captured = full_width_serve(model, cfg,
                                                              checks)
    captured.update(serve_captured)
    lap("phases 4-5 serve")
    preqs, solo, max_len = prefix_serve(model, cfg, serve_trace(cfg))
    overload = overload_serve(model, cfg, preqs, solo, max_len, checks)
    cow_step(model, cfg, checks)
    lap("phase 5 prefix, overload, copy on write")
    recovery = recovery_phase(model, cfg, serve_trace(cfg), served["tokens"],
                              preqs, solo, overload["sampled_tokens"], checks)
    lap("phase 5 recovery")
    baselines = baselines_at_full_width(model, cfg, metrics["tokens"])
    family_launches, family = softmax_family(softmax_inputs, checks)
    lap("phase 8a-8b")
    # ring and twopass kernels: the generate() runs; paged kernels: the
    # serve; the softmax: its run on run (c)'s A
    rows = time_kernels(captured, softmax_inputs,
                        {**serve_launches, **metrics["launches"],
                         "ita_softmax": softmax_launches + family_launches},
                        checks,
                        served["mean_ms"])
    lap("phase 6")
    linear_launches, linear_ops = full_width_linear(model, cfg, checks)
    rows += time_linear(linear_ops, linear_launches, checks)
    summary = (
        f"[result] prefill {metrics['prefill_s']:.4f} s, decode "
        f"{metrics['decode_tok_s']:.1f} tok/s (unpinned); pinned onepass "
        f"prefill {metrics['pinned_prefill_s']:.4f} s, decode "
        f"{metrics['pinned_decode_tok_s']:.1f} tok/s; pinned twopass (paper "
        f"DI) prefill {metrics['twopass_prefill_s']:.4f} s, decode "
        f"{metrics['twopass_decode_tok_s']:.1f} tok/s; serve "
        f"{served['tok_s']:.2f} tok/s sustained, TTFT p50 "
        f"{served['ttft_p50']:.3f} s p90 {served['ttft_p90']:.3f} s, wall "
        f"{served['wall_s']:.3f} s; stall serve {served['stall']['tok_s']:.2f} "
        f"tok/s, wall {served['stall']['wall_s']:.3f} s, prefill stall "
        f"{served['stall']['prefill_stall_s']:.3f} s; overload serve "
        f"{overload['tok_s']:.2f} tok/s, wall {overload['wall_s']:.3f} s, "
        f"{overload['preemptions']} preemptions; journal on/off wall "
        f"{recovery['journal_on_wall_s']:.3f}/"
        f"{recovery['journal_off_wall_s']:.3f} s, snapshot "
        f"{recovery['snapshot_bytes']} bytes, {recovery['snapshot_ms']:.2f} "
        f"ms on the caller, recovery_s {recovery['recovery_s']:.4f}, "
        f"recapture {recovery['capture_s']:.3f} s; stepwise decode "
        f"(a) (b) (c) {', '.join(f'{x:.1f}' for x in metrics['stepwise_decode_tok_s'])}"
        f" tok/s; phase 8a float prefill "
        f"{baselines['float']['prefill_s']:.3f} s, decode "
        f"{baselines['float']['decode_tok_s']:.1f} tok/s, ibert prefill "
        f"{baselines['ibert']['prefill_s']:.3f} s, decode "
        f"{baselines['ibert']['decode_tok_s']:.1f} tok/s; 8b MAE vs float "
        + ", ".join(f"{n} {v:.6f}" for n, v in family["mae"].items())
        + f"; {card_line()}")
    return rows, summary, roof


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
    check_moe_row_invariance()
    check_kv_cache_engine(checks)
    smoke_width_reference()
    lap("phase 2")
    rows, summary, roof = qwen2_phases(checks)
    lap("phases 3-8b")
    # phase 8c needs the card to itself: qwen2-7b's weights, graphs and
    # pools went with qwen2_phases' frame
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[gemma2] after qwen2-7b: allocated "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB, reserved "
        f"{torch.cuda.memory_reserved() / 1e9:.2f} GB")
    gemma2 = gemma2_at_full_width()
    lap("phase 8c")
    gc.collect()
    torch.cuda.empty_cache()
    phase9_line, phase9_subs, phase9_roof = phase9(checks)
    lap("phase 9")
    gc.collect()
    torch.cuda.empty_cache()
    phase10_line, phase10_subs = phase10(checks)
    lap("phase 10")
    gc.collect()
    torch.cuda.empty_cache()
    phase11_line, phase11_subs = phase11(checks)
    lap("phase 11")
    gc.collect()
    torch.cuda.empty_cache()
    phase12_line, phase12_subs, phase12_roof = phase12(checks)
    lap("phase 12")
    roof += phase9_roof + phase12_roof
    phase14_line = phase14()
    lap("phase 14")
    gc.collect()
    torch.cuda.empty_cache()
    phase15_line = phase15(card)
    lap("phase 15")
    for row in rows:
        for subs in (phase9_subs, phase10_subs, phase11_subs, phase12_subs):
            row.update(subs.get(row["name"], {}))
    log(summary)
    log(f"[result] phase 8: " + "; ".join(
        f"gemma2 ({r}, {gemma2[r]['layers']} layers) prefill "
        f"{gemma2[r]['prefill_s']:.3f} s, decode "
        f"{gemma2[r]['decode_tok_s']:.1f} tok/s, step "
        f"{gemma2[r]['step_ms']:.2f} ms (floor {gemma2[r]['floor_ms']:.2f}), "
        f"busy {gemma2[r]['busy']:.1%}, max allocated "
        f"{gemma2[r]['max_alloc_gb']:.2f} GB" for r in ("i", "ii"))
        + f"; {card}")
    log(f"{phase9_line}; {card}")
    log(f"{phase10_line}; {card}")
    log(f"{phase11_line}; {card}")
    log(f"{phase12_line}; {card}")
    log("[result] phase 13: " + "; ".join(
        f"{r['path']} measured {r['measured_s'] * 1e3:.3f} ms, roofline "
        f"{max(r['compute_s'], r['memory_s']) * 1e3:.4f} ms "
        f"({r['bottleneck']}), share {r['share']:.5f}, mfu {r['mfu']:.5f}"
        for r in roof) + f"; {card}")
    log(f"{phase14_line}; {card}")
    log(f"{phase15_line}; {card}")
    log(f"[result] checks {checks.n}; wall {time.perf_counter() - T0:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"roofline": roof}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
