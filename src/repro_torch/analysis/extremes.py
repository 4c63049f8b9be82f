"""The nine kernels at the declared extremes, against their plain
versions and their certificates.

For each kernel, a few calls whose inputs sit at the ends of the
declared operand ranges (``attention/spec.py``): Q/K/V saturated at
+127, at -128 and at random ones of the two; fully masked rows
(``kv_len`` 0, ``q_len`` 0, an all-zero softmax mask row) beside rows
with ``kv_len`` at the capacity; the quantization scales at the ends of
``SCALE_BOUNDS`` (each row's multipliers formed from them as the
attention backends form them); the int8 GEMM's bias at ±2^20 and its
multipliers at 0 and 1.

Each call is traced on the CPU through the kernel's plain version
(``make_fx``) and certified with the call's inputs seeded to the
declared ranges, not to their values (``analysis.ranges``): the proven
interval of every output. Then the kernel runs on ``device`` (on the
card, its CUDA kernel, through the launcher where a wrapper does not
return every output), and must equal its plain version on the same
tensors bit for bit, with every output inside its proven interval. On
the CPU the wrappers take their plain versions, so a CPU run rehearses
the inputs, the traces and the interval checks only.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.fx.experimental.proxy_tensor import make_fx

from repro_torch.analysis.intervals import Interval
from repro_torch.analysis.ranges import analyze_graph, tensor_interval
from repro_torch.attention.spec import INT8_RANGE, SCALE_BOUNDS

KERNELS = ("ita_attention_onepass", "ita_attention_decode",
           "ita_attention_onepass_paged", "ita_attention_decode_paged",
           "ita_attention_twopass_qk_da", "ita_attention_twopass_av_en",
           "ita_softmax", "int8_matmul", "int8_matmul_ws")
# qwen2-7b's heads: 28 query heads over 4 KV heads of 128
B, HQ, HKV, D = 2, 28, 4, 128
SKV, PAGE = 256, 128
VARIANTS = ("hi", "lo", "mixed")


@dataclasses.dataclass
class Call:
    """One kernel call: its inputs, their seeds, the plain version and
    the kernel (both ``fn(*inputs) -> tuple of outputs``)."""

    kernel: str
    variant: str
    inputs: list
    seeds: list
    plain: object
    run: object


def _saturated(shape, variant, rng) -> torch.Tensor:
    lo, hi = INT8_RANGE
    if variant == "hi":
        return torch.full(shape, hi, dtype=torch.int8)
    if variant == "lo":
        return torch.full(shape, lo, dtype=torch.int8)
    return torch.from_numpy(np.where(rng.random(shape) < 0.5, hi, lo)
                            .astype(np.int8))


def _scales(n, variant, rng) -> torch.Tensor:
    lo, hi = SCALE_BOUNDS
    if variant in ("hi", "lo"):
        return torch.full((n,), hi if variant == "hi" else lo)
    return torch.from_numpy(np.where(rng.random(n) < 0.5, hi, lo)
                            .astype(np.float32))


def _meta(variant, rows, sq, rng):
    """Per-row ``kv_len``, ``q_offset`` and ``q_len``: every row at the
    capacity, or (mixed) fully masked rows beside rows at the capacity."""
    kv_len = np.full(rows, SKV, np.int32)
    q_len = np.full(rows, sq, np.int32)
    if variant == "mixed":
        dead = rng.random(rows) < 0.3
        kv_len[dead] = 0
        q_len[rng.random(rows) < 0.2] = 0
    q_off = np.maximum(kv_len - sq, 0).astype(np.int32)
    return (torch.from_numpy(kv_len), torch.from_numpy(q_off),
            torch.from_numpy(q_len))


def _scale_seeds(n):
    return [Interval(*SCALE_BOUNDS)] * n


def _attention_calls(variant, rng) -> list:
    from repro_torch.kernels.ita_attention import kernel as K
    from repro_torch.kernels.ita_attention.ops import row_multipliers
    rep = HQ // HKV
    calls = []

    def mults(s_q, s_k, s_v, s_out):
        return row_multipliers(s_q, s_k, s_v, s_out, b=B, hq=HQ, hkv=HKV,
                               d=D, device=s_q.device)

    scale_in = [_scales(HQ, variant, rng), _scales(HKV, variant, rng),
                _scales(HKV, variant, rng), _scales(HQ, variant, rng)]
    act = Interval(*INT8_RANGE)
    for kernel, sq in (("ita_attention_onepass", 16),
                       ("ita_attention_decode", 2)):
        kv_len, q_off, q_len = _meta(variant, B * HQ, sq, rng)
        q = _saturated((B * HQ, sq, D), variant, rng)
        k = _saturated((B, SKV, HKV, D), variant, rng)
        v = _saturated((B, SKV, HKV, D), variant, rng)
        kw = dict(causal=True, adaptive=variant != "lo", block_kv=128,
                  kv_rep=rep, hq=HQ)

        def call(fn, q, k, v, sq_, sk_, sv_, so_, kv_len, q_off, q_len,
                 kw=kw):
            lm, om = mults(sq_, sk_, sv_, so_)
            return (fn(q, k, v, lm, om, kv_len, q_offset=q_off,
                       q_len=q_len, **kw),)
        calls.append(Call(
            kernel, variant, [q, k, v, *scale_in, kv_len, q_off, q_len],
            [act] * 3 + _scale_seeds(4) + [Interval(0, SKV),
                                           Interval(0, SKV),
                                           Interval(0, sq)],
            lambda *a, call=call: call(K.attention_plain, *a),
            lambda *a, call=call, kernel=kernel: call(getattr(K, kernel),
                                                      *a)))
    n_pages = SKV // PAGE
    pool = B * n_pages + 1
    for kernel, sq in (("ita_attention_onepass_paged", 16),
                       ("ita_attention_decode_paged", 1)):
        kv_len, q_off, q_len = _meta(variant, B, sq, rng)
        q = _saturated((B * HQ, sq, D), variant, rng)
        k = _saturated((pool, PAGE, HKV, D), variant, rng)
        v = _saturated((pool, PAGE, HKV, D), variant, rng)
        table = torch.from_numpy(rng.permutation(pool)[:B * n_pages]
                                 .reshape(B, n_pages).astype(np.int32))
        kw = dict(causal=True, adaptive=variant != "lo", kv_rep=rep, hq=HQ)

        def pcall(fn, q, k, v, table, sq_, sk_, sv_, so_, kv_len, q_off,
                  q_len, kw=kw):
            lm, om = mults(sq_, sk_, sv_, so_)
            rows = lambda x: x.repeat_interleave(HQ)       # noqa: E731
            return (fn(q, k, v, table, lm, om, rows(kv_len),
                       q_offset=rows(q_off), q_len=rows(q_len), **kw),)
        calls.append(Call(
            kernel, variant,
            [q, k, v, table, *scale_in, kv_len, q_off, q_len],
            [act] * 3 + [Interval(0, pool - 1)] + _scale_seeds(4)
            + [Interval(0, SKV), Interval(0, SKV), Interval(0, sq)],
            lambda *a, pcall=pcall: pcall(K.paged_attention_plain, *a),
            lambda *a, pcall=pcall, kernel=kernel: pcall(
                getattr(K, kernel), *a)))
    return calls


def _twopass_calls(variant, rng) -> list:
    from repro_torch.kernels.ita_attention import kernel as K
    from repro_torch.kernels.ita_attention.ops import row_multipliers
    rep, sq = HQ // HKV, 16
    kv_len, q_off, _ = _meta(variant, B * HQ, sq, rng)
    q = _saturated((B * HQ, sq, D), variant, rng)
    k = _saturated((B * HKV, SKV, D), variant, rng)
    v = _saturated((B * HKV, SKV, D), variant, rng)
    scale_in = [_scales(HQ, variant, rng), _scales(HKV, variant, rng),
                _scales(HKV, variant, rng), _scales(HQ, variant, rng)]
    kw = dict(causal=True, adaptive=variant != "hi", block_kv=128,
              kv_rep=rep)
    pass_kw = {n: x for n, x in kw.items() if n != "adaptive"}
    act = Interval(*INT8_RANGE)

    def mults(s_q, s_k, s_v, s_out):
        return row_multipliers(s_q, s_k, s_v, s_out, b=B, hq=HQ, hkv=HKV,
                               d=D, device=s_q.device)

    def qk(fn, q, k, sq_, sk_, sv_, so_, kv_len, q_off):
        lm, _ = mults(sq_, sk_, sv_, so_)
        return tuple(fn(q, k, lm, kv_len, q_offset=q_off,
                        adaptive=kw["adaptive"], **pass_kw))

    def qk_kernel(*a):
        if a[0].device.type != "cuda":
            return qk(K.twopass_qk_plain, *a)
        launch, outs = qk(lambda *x, **y: K.twopass_qk_launcher(*x, **y),
                          *a)
        launch()
        return tuple(outs)

    stats = K.twopass_qk_plain(q, k, mults(*scale_in)[0], kv_len,
                               q_offset=q_off, adaptive=kw["adaptive"],
                               **pass_kw)

    def av(fn, a, row_max, inv, e_r, v, sq_, sk_, sv_, so_, kv_len, q_off):
        _, om = mults(sq_, sk_, sv_, so_)
        return (fn(a, row_max, inv, e_r, v, om, kv_len, q_offset=q_off,
                   **pass_kw),)

    def av_kernel(*a):
        if a[0].device.type != "cuda":
            return av(K.twopass_av_plain, *a)
        launch, out = av(lambda *x, **y: K.twopass_av_launcher(*x, **y),
                         *a)[0]
        launch()
        return (out,)

    meta_seeds = [Interval(0, SKV), Interval(0, SKV)]
    return [
        Call("ita_attention_twopass_qk_da", variant,
             [q, k, *scale_in, kv_len, q_off],
             [act] * 2 + _scale_seeds(4) + meta_seeds,
             lambda *a: qk(K.twopass_qk_plain, *a), qk_kernel),
        # pass 2 reads pass 1's statistics: its seeds are the intervals
        # pass 1's certificate proves for them (filled in by ``certify``)
        Call("ita_attention_twopass_av_en", variant,
             [*stats, v, *scale_in, kv_len, q_off],
             [None] * 4 + [act] + _scale_seeds(4) + meta_seeds,
             lambda *a: av(K.twopass_av_plain, *a), av_kernel),
    ]


def _softmax_calls(variant, rng) -> list:
    from repro_torch.kernels.ita_softmax import kernel as SK
    r, c = 64, 512
    x = _saturated((r, c), variant, rng)
    mask = np.ones((r, c), np.int8)
    if variant == "mixed":
        mask[rng.random(r) < 0.25] = 0              # fully masked rows
        mask[:, rng.random(c) < 0.1] = 0
    mask = torch.from_numpy(mask)
    adaptive = variant != "lo"

    def run(fn):
        return lambda x, m: (fn(x, m, block_c=128, adaptive=adaptive),)
    return [Call("ita_softmax", variant, [x, mask],
                 [Interval(*INT8_RANGE), Interval(0, 1)],
                 run(SK.softmax_plain), run(SK.ita_softmax_kernel))]


def _matmul_calls(variant, rng) -> list:
    from repro_torch.kernels.int8_matmul import kernel as MK
    m, kdim, n = 256, 512, 256
    x = _saturated((m, kdim), variant, rng)
    w = _saturated((kdim, n), "mixed" if variant == "mixed" else variant,
                   rng)
    bias = torch.full((n,), (1 << 20) if variant == "hi" else -(1 << 20),
                      dtype=torch.int32)
    if variant == "mixed":
        bias = torch.from_numpy(np.where(rng.random(n) < 0.5, 1 << 20,
                                         -(1 << 20)).astype(np.int32))
    mult = torch.from_numpy(np.where(rng.random(n) < 0.5, 0.0, 1.0)
                            .astype(np.float32))
    seeds = [Interval(*INT8_RANGE)] * 2 + [Interval(-(1 << 20), 1 << 20),
                                           Interval(0.0, 1.0)]
    calls = []
    for kernel, schedule in (("int8_matmul", "tpu"),
                             ("int8_matmul_ws", "weight_stationary")):
        def plain(x, w, bias, mult, schedule=schedule):
            if schedule == "tpu":
                return (MK.matmul_plain(x, w, bias, mult),)
            return (MK.matmul_ws_plain(x, w, bias, mult, block_k=128),)

        def run(x, w, bias, mult, schedule=schedule):
            return (MK.int8_matmul_kernel(x, w, bias, mult,
                                          schedule=schedule),)
        calls.append(Call(kernel, variant, [x, w, bias, mult], seeds,
                          plain, run))
    return calls


def extreme_calls(seed: int = 0) -> list:
    """Every kernel's calls at the extremes, ``VARIANTS`` of each."""
    rng = np.random.default_rng(seed)
    calls = []
    for variant in VARIANTS:
        calls += _attention_calls(variant, rng) + _twopass_calls(variant, rng)
        calls += _softmax_calls(variant, rng) + _matmul_calls(variant, rng)
    return calls


def certify(call: Call, proven=None):
    """The proven intervals of ``call``'s outputs: its plain version
    traced on its inputs (CPU) and certified with its seeds (``proven``:
    earlier calls' output intervals by kernel, which seed a pass that
    reads them). Returns ``(ok, [Interval per output])``."""
    seeds = list(call.seeds)
    if call.kernel == "ita_attention_twopass_av_en":
        seeds[:4] = proven[("ita_attention_twopass_qk_da", call.variant)]
    gm = make_fx(lambda *a: call.plain(*a))(*call.inputs)
    res = analyze_graph(gm, seeds)
    return res.ok, res.outvals


def check_extremes(device="cuda", seed: int = 0, kernels=KERNELS) -> list:
    """Every call of ``extreme_calls`` of ``kernels``: certified on the
    CPU, run on ``device`` through the kernel and the plain version.
    Returns one dict a call: ``equal`` (bit for bit), ``inside`` (every
    output in its proven interval), the certificate's ``ok`` and the
    intervals."""
    out, proven = [], {}
    for call in extreme_calls(seed):
        if call.kernel not in kernels and not (
                call.kernel == "ita_attention_twopass_qk_da"
                and "ita_attention_twopass_av_en" in kernels):
            continue
        ok, outs = certify(call, proven)
        proven[(call.kernel, call.variant)] = outs
        if call.kernel not in kernels:        # pass 1 seeds pass 2 only
            continue
        dev = [x.to(device) for x in call.inputs]
        got = call.run(*dev)
        want = call.plain(*dev)
        if device != "cpu":
            torch.cuda.synchronize()
        equal = all(torch.equal(g, w) for g, w in zip(got, want,
                                                       strict=True))
        seen = [tensor_interval(g.cpu()) for g in got]
        inside = all(p.contains(s) for p, s in zip(outs, seen, strict=True))
        out.append({"kernel": call.kernel, "variant": call.variant,
                    "certified": ok, "equal": equal, "inside": inside,
                    "proven": [repr(p) for p in outs],
                    "seen": [repr(s) for s in seen]})
    return out
