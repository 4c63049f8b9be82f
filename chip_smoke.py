#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA card and the
CUDA toolkit (``nvcc``). Phases, each fatal on failure:

1. Build the port's CUDA kernels from ``src/repro_torch/kernels/
   ita_attention/csrc`` (nvcc, all sources in parallel).
2. Hold each kernel to its plain PyTorch version on the card, bit for bit
   (``torch.equal``), at qwen2-7b shapes (B=4, 28 heads, 4 KV heads,
   head dim 128): decode over a ring of capacity 640 with ragged rows in
   both K/V layouts, causal and windowed, adaptive and paper DI; a
   512-token onepass prefill on the cache-native layout and a multi-tile
   3D case.
3. Drive ``generate()`` on full-width qwen2-7b (random bf16 weights from a
   seed, batch 4, prompt 512, 32 tokens): (a) unpinned — chunked prefill,
   then the decode kernel — twice, with identical tokens; (b) with the
   ``ita_onepass_pallas`` pin. The launch counters are zeroed before each
   run and read after it; the inputs and outputs of layers 0 and 27 of
   one prefill call and one decode step are kept and held to the plain
   versions afterwards. The smoke-width config checks the card's logits
   against the CPU's plain versions.
4. Profile one unpinned ``generate()`` (device time by kernel, busy
   share). Time each kernel on the main path's inputs with CUDA events
   (median): the bound kernel alone, its wrapper call and its plain
   version, beside its bound.

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

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
INT8_OPS_PER_S = 1979e12         # H100 SXM dense int8 tensor-core peak
B, PROMPT, GEN = 4, 512, 32
RING = 640                       # the main path's ring: 512 + 32 aligned
DEV = "cuda"
WIDTH = {}                       # config overrides (none: full width)

SOURCES = {
    "ita_attention_onepass": (
        "src/repro_torch/kernels/ita_attention/csrc/onepass.cu",
        "src/repro/kernels/ita_attention/kernel.py:298"),
    "ita_attention_decode": (
        "src/repro_torch/kernels/ita_attention/csrc/decode.cu",
        "src/repro/kernels/ita_attention/kernel.py:427"),
}


def log(msg):
    print(msg, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


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
        err = (got.int() - want.int()).abs().max().item() if got.numel() \
            else 0
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
    return cases


def check_kernels(checks):
    from repro_torch.kernels.ita_attention import kernel as K
    for name, args, kw, label in kernel_cases():
        got = getattr(K, name)(*args, **kw)
        checks.compare(name, got, K.attention_plain(*args, **kw), label)
    log(f"[kernels] bit-exact vs plain at qwen2-7b shapes: {checks.n}")


# ---------------------------------------------------------------------------
# Phase 3: full-width generate
# ---------------------------------------------------------------------------

class Recorder:
    """Stands in for a kernel wrapper inside ``ops``: forwards every call
    and keeps the inputs (cloned: the rings change in place later) and the
    output of the calls whose index is in ``keep``."""

    def __init__(self, fn, keep):
        self.fn, self.keep, self.calls, self.kept = fn, set(keep), 0, {}

    def __call__(self, *args, **kw):
        out = self.fn(*args, **kw)
        if self.calls in self.keep:
            import torch

            def clone(x):
                return x.clone() if torch.is_tensor(x) else x
            self.kept[self.calls] = ([clone(a) for a in args],
                                     {k: clone(x) for k, x in kw.items()},
                                     out.clone())
        self.calls += 1
        return out


def run_generate(model, cfg, prompts, *, record=None, keep=()):
    """One ``generate()`` with the launch counters zeroed just before and
    read just after; ``record`` names the ops wrapper to record."""
    import torch

    from repro_torch.kernels.ita_attention import kernel as K
    from repro_torch.kernels.ita_attention import ops
    from repro_torch.runtime.generate import generate
    rec = None
    if record is not None:
        rec = Recorder(getattr(ops, record), keep)
        setattr(ops, record, rec)
    try:
        K.reset_launches()
        res = generate(model, cfg, prompts, GEN, device=DEV)
        torch.cuda.synchronize()
        launches = dict(K.LAUNCHES)
    finally:
        if rec is not None:
            setattr(ops, record, rec.fn)
    return res, launches, rec


def smoke_width_reference():
    """The smoke-width config on the card against the CPU's plain versions:
    prefill and two decode steps' logits within 5e-2 (float projections
    round differently on the two devices, which can move an int8 step)."""
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.models import forward, init_caches, init_model
    for backend in ("", "ita_onepass_pallas"):
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


def full_width(checks):
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.models import forward, init_caches, init_model
    cfg = get_config("qwen2-7b", attention_impl="ita", **WIDTH)
    n_layers = cfg.n_layers
    t0 = time.perf_counter()
    model = init_model(cfg, seed=0, device=DEV)
    torch.cuda.synchronize()
    log(f"[generate] {cfg.name} full width: {n_layers} layers, d="
        f"{cfg.d_model}, weights "
        f"{sum(p.numel() * p.element_size() for p in model.parameters()) / 1e9:.2f}"
        f" GB {cfg.dtype}, init {time.perf_counter() - t0:.1f} s")
    prompts = torch.randint(0, cfg.vocab_size, (B, PROMPT),
                            generator=torch.Generator().manual_seed(0))

    # (a) unpinned: chunked prefill, then the decode kernel every step
    res_a, la, rec_dec = run_generate(model, cfg, prompts,
                                      record="ita_attention_decode",
                                      keep=(0, n_layers - 1))
    want = {"ita_attention_decode": n_layers * (GEN - 1),
            "ita_attention_onepass": 0}
    if la != want:
        raise AssertionError(f"unpinned launches {la} != {want}")
    res_a2, la2, _ = run_generate(model, cfg, prompts)
    if la2 != want or not torch.equal(res_a.tokens, res_a2.tokens):
        raise AssertionError("a second unpinned run gave other tokens or "
                             "launches")
    # (b) pinned onepass: prefill and every decode step through onepass
    cfg_b = dataclasses.replace(cfg, attention_backend="ita_onepass_pallas")
    res_b, lb, rec_one = run_generate(model, cfg_b, prompts,
                                      record="ita_attention_onepass",
                                      keep=(0, n_layers - 1))
    want_b = {"ita_attention_onepass": n_layers * GEN,
              "ita_attention_decode": 0}
    if lb != want_b:
        raise AssertionError(f"pinned launches {lb} != {want_b}")
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

    from repro_torch.kernels.ita_attention import kernel as K
    captured = {}
    for name, rec, what in (("ita_attention_decode", rec_dec, "decode step"),
                            ("ita_attention_onepass", rec_one, "prefill")):
        for idx, (args, kw, out) in sorted(rec.kept.items()):
            checks.compare(name, out, K.attention_plain(*args, **kw),
                           f"main path {what}, layer {idx}")
        captured[name] = rec.kept[0]
    log(f"[generate] main-path inputs of layers 0 and {n_layers - 1} "
        f"bit-exact vs plain")
    profile_generate(model, cfg, prompts)
    return {"prefill_s": res_a2.prefill_s, "decode_tok_s":
            res_a2.decode_tok_s, "pinned_prefill_s": res_b.prefill_s,
            "pinned_decode_tok_s": res_b.decode_tok_s,
            "launches": {"ita_attention_decode": la["ita_attention_decode"],
                         "ita_attention_onepass":
                             lb["ita_attention_onepass"]}}, captured


# ---------------------------------------------------------------------------
# Phase 4: timings and bounds
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


def bound_ms(args, kw):
    """The least time for the call's work on this card: each input read
    once (only the K/V prefix the rows' masks can reach), the output
    written once, against the integer ops of the visible (query, key)
    pairs (Q·Kᵀ and u·V: 4 ops per pair and head-dim element)."""
    import torch

    from repro_torch.kernels.common import tile_mask
    from repro_torch.kernels.ita_attention import kernel as K
    q, k, v = args[:3]
    bh, sq, d = q.shape
    _, _, meta = K.row_operands(*args[:6], kw.get("q_offset", 0),
                                kw.get("q_len"), kw.get("kv_rep", 1),
                                kw.get("hq"))
    skv = k.shape[1]
    col = [meta[:, i].view(bh, 1, 1) for i in range(3)]
    valid = tile_mask(0, 0, sq, skv, kw.get("causal", True),
                      kw.get("window", 0), kv_len=col[0], q_offset=col[1],
                      q_len=col[2], device=q.device)
    pairs = int(valid.sum().item())
    # K/V rows reached: per kv row, the largest visible key + 1
    reach = torch.where(valid.any(1), torch.arange(skv, device=q.device),
                        -1).amax(1) + 1                      # (bh,)
    rep = kw.get("kv_rep", 1)
    kv_tokens = int(reach.view(-1, rep).amax(1).sum().item())
    nbytes = q.numel() * 2 + 2 * kv_tokens * d + meta.numel() * 4 + bh * 8
    ops = 4 * pairs * d
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / INT8_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def profile_generate(model, cfg, prompts):
    """Device time by kernel over one unpinned ``generate()`` call
    (``torch.profiler``), and the device's busy share of its wall time
    (the profiler's own host cost inflates the wall time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.runtime.generate import generate
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        generate(model, cfg, prompts, GEN, device=DEV)
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    log(f"[profile] generate (a): wall {wall_ms:.1f} ms, device busy "
        f"{busy_ms:.1f} ms ({busy_ms / wall_ms:.1%}); top kernels by "
        f"device time:")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
        log(f"[profile]   {e.self_device_time_total / 1e3:9.2f} ms "
            f"{e.count:6d} x  {e.key[:90]}")


def kernel_ms(name, args, kw, reps=30, inner=10):
    """Median over ``reps`` of the mean time of ``inner`` back-to-back
    launches of the bound kernel (CUDA events): the kernel alone, without
    its wrapper's host work, which is longer than a decode call."""
    import torch

    from repro_torch.kernels.ita_attention import kernel as K
    launch, _ = K.kernel_launcher(name, *args, **kw)
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


def time_kernels(captured, launches, checks):
    from repro_torch.kernels.ita_attention import kernel as K
    rows = []
    for name, (args, kw, _) in captured.items():
        fn = getattr(K, name)
        ms = kernel_ms(name, args, kw)
        call = median_ms(lambda fn=fn: fn(*args, **kw))
        plain = median_ms(lambda: K.attention_plain(*args, **kw), reps=10)
        bms, by = bound_ms(args, kw)
        source, replaces = SOURCES[name]
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": checks.max_err[name], "ms": ms,
                     "plain_ms": plain, "bound_ms": bms, "bound_by": by,
                     "library_ms": None})
        log(f"[timing] {name} at main-path shape q{tuple(args[0].shape)} "
            f"k{tuple(args[1].shape)}: kernel {ms:.4f} ms (wrapper call "
            f"{call:.4f} ms), plain {plain:.4f} ms, bound "
            f"{bms:.5f} ms ({by}); library call: none (no PyTorch call "
            f"computes ITA's integer attention)")
    return rows


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
    smoke_width_reference()
    metrics, captured = full_width(checks)
    rows = time_kernels(captured, metrics["launches"], checks)
    log(f"[result] prefill {metrics['prefill_s']:.4f} s, decode "
        f"{metrics['decode_tok_s']:.1f} tok/s (unpinned); pinned onepass "
        f"prefill {metrics['pinned_prefill_s']:.4f} s, decode "
        f"{metrics['pinned_decode_tok_s']:.1f} tok/s; {card}")
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
