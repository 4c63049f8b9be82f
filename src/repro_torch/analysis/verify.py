"""No-overflow certificates for the port's quantized kernels and backends
(``repro.analysis.verify``).

The matrix has the reference's 18 cases, by name. Each traces a port
function to an aten graph (``make_fx``, real tensors on the CPU), seeds
its inputs from the declared operand ranges of ``attention/spec.py``,
and runs the interval interpreter (``analysis.ranges``). A case passes
when the walk makes no finding: every integer op's proven interval fits
its dtype, every narrowing cast is proven in range, every shift amount
is proven legal.

- A ``*_pallas`` case traces the plain version of the port's kernel
  (the kernel wrappers compute it on CPU tensors), which walks the
  kernel's KV tile schedule: the trace unrolls it tile by tile.
- A ``*_xla`` case traces the port's backend of that name
  (``attention/xla.py``, ``attention/chunked.py``) through ``dispatch``.
- ``ita_softmax_*`` trace the standalone softmax (its plain version) and
  ``core.softmax``; ``int8_matmul/*`` the int8 GEMM wrapper, through its
  plain version and through the reference path.

A trace runs on concrete inputs drawn inside the seeds, with ``kv_len``
at the pool's capacity (the declared extreme). No plain version reads a
value back to the host, so the graph holds for every input inside the
seeds; a trace that did would be reported as ``path_fixed``.

Geometries are the reference's: the full one runs a 2048-token KV at the
128-wide KV tile, so the per-tile reduction widths, which are what the
accumulators see, are the production ones.
"""

from __future__ import annotations

import dataclasses
import functools
import time

import numpy as np
import torch
from torch.fx.experimental.proxy_tensor import make_fx

from repro_torch import attention as ATT
from repro_torch.analysis.intervals import INF, Interval
from repro_torch.analysis.ranges import analyze_graph
from repro_torch.attention.spec import declared_ranges

REPORT_SCHEMA = "ita-range-report-v1"


@dataclasses.dataclass(frozen=True)
class Geometry:
    b: int
    hq: int
    hkv: int
    sq: int
    skv: int
    d: int
    bq: int
    bkv: int
    page: int

    def to_json(self):
        return dataclasses.asdict(self)


SMOKE_GEOMETRY = Geometry(b=1, hq=2, hkv=2, sq=32, skv=128, d=32,
                          bq=16, bkv=32, page=32)
FULL_GEOMETRY = Geometry(b=1, hq=4, hkv=2, sq=128, skv=2048, d=64,
                         bq=64, bkv=128, page=128)


@dataclasses.dataclass
class Case:
    """One traceable function, its input specs and seeds."""

    name: str
    backend: str
    desc: str
    fn: object                    # closure over static config
    specs: list                   # (shape, torch dtype) per input
    seeds: list                   # Interval per input

    def example(self, rng: np.random.Generator, at=None) -> list:
        """Concrete inputs inside the seeds: random (``at`` None), or every
        input at its seed's ``"lo"`` or ``"hi"`` end."""
        return [_draw(shape, dt, seed, rng, at)
                for (shape, dt), seed in zip(self.specs, self.seeds,
                                             strict=True)]

    def trace(self, rng=None) -> torch.fx.GraphModule:
        """The aten graph of ``fn``, traced on random inputs inside the
        seeds with every position operand (``kv_len``, the last int32
        inputs) at its declared upper extreme."""
        rng = rng or np.random.default_rng(0)
        args = self.example(rng)
        return make_fx(self.fn)(*args)


def _draw(shape, dt, seed: Interval, rng, at=None) -> torch.Tensor:
    if dt == torch.bool:
        if at is not None:
            return torch.full(shape, at == "hi", dtype=torch.bool)
        return torch.from_numpy(rng.random(shape) < 0.7)
    if dt.is_floating_point:
        lo, hi = float(seed.lo), float(seed.hi)
        if at is not None:
            return torch.full(shape, lo if at == "lo" else hi, dtype=dt)
        return torch.from_numpy(rng.uniform(lo, hi, shape)).to(dt)
    lo, hi = int(seed.lo), int(seed.hi)
    if at is not None:
        return torch.full(shape, lo if at == "lo" else hi, dtype=dt)
    return torch.from_numpy(rng.integers(lo, hi + 1, shape)).to(dt)


def _iv(bounds) -> Interval:
    return Interval(bounds[0], bounds[1])


# ---------------------------------------------------------------------------
# The cases
# ---------------------------------------------------------------------------

def _paper_ref(x, mask):
    from repro_torch.core import softmax as SM
    return SM.ita_softmax_int(x, mask)


def _adaptive_ref(x, mask):
    from repro_torch.core import softmax as SM
    return SM.ita_softmax_adaptive_int(x, mask)


def _softmax_cases(g: Geometry) -> list:
    from repro_torch.kernels.ita_softmax.ops import ita_softmax
    specs = [((g.sq, g.skv), torch.int8), ((g.sq, g.skv), torch.bool)]
    seeds = [Interval(-128, 127), Interval(0, 1)]
    cases = []
    for adaptive in (False, True):
        mode = "adaptive" if adaptive else "paper"
        cases.append(Case(
            name=f"ita_softmax_pallas/{mode}", backend="ita_softmax",
            desc=f"standalone DA/DI/EN softmax (B6's plain version), "
                 f"{mode} inverse, ({g.sq},{g.skv}) parts of {g.bkv}",
            fn=functools.partial(ita_softmax, block_r=g.bq, block_c=g.bkv,
                                 adaptive=adaptive),
            specs=specs, seeds=list(seeds)))
        cases.append(Case(
            name=f"ita_softmax_ref/{mode}", backend="ita_softmax",
            desc=f"one-shot torch reference softmax, {mode} inverse",
            fn=_adaptive_ref if adaptive else _paper_ref, specs=specs,
            seeds=list(seeds)))
    return cases


def _matmul_cases(g: Geometry) -> list:
    from repro_torch.kernels.int8_matmul.ops import int8_matmul
    mdim, kdim, ndim = 4 * g.bq, 4 * g.bkv, 2 * g.bkv
    specs = [((mdim, kdim), torch.int8), ((kdim, ndim), torch.int8),
             ((ndim,), torch.int32), ((ndim,), torch.float32)]
    r = declared_ranges(ATT.AttentionSpec(mode="prefill", impl="ita"))
    # bias rides the int32 accumulator: |bias| <= kdim * 127 * 127 keeps
    # acc + bias inside the certified budget
    seeds = [_iv(r["q"]), _iv(r["k"]), Interval(-(1 << 20), 1 << 20),
             Interval(0.0, 1.0)]
    cases = []
    for use_kernel in (True, False):
        eng = "pallas" if use_kernel else "xla"
        cases.append(Case(
            name=f"int8_matmul/{eng}", backend="int8_matmul",
            desc=f"int8 GEMM + bias + requant, "
                 f"{'B7a plain' if use_kernel else 'reference'} path, "
                 f"({mdim},{kdim})x({kdim},{ndim})",
            fn=functools.partial(int8_matmul, block_m=g.bq * 2,
                                 block_n=g.bkv, block_k=g.bkv,
                                 use_pallas=use_kernel),
            specs=specs, seeds=seeds))
    return cases


def _attention_case(name, backend, spec, g: Geometry, *, desc,
                    kv_len=False, q_offset=False, paged=False,
                    ragged=False, opts=None) -> Case:
    npages = (g.b * g.skv) // g.page + 1
    npps = g.skv // g.page
    r = declared_ranges(spec, kv_capacity=g.skv, num_pages=npages)
    qlen = spec.q_len if spec.q_len else g.sq
    if spec.layout == "bshd":
        q = (g.b, qlen, g.hq, g.d)
        k = (g.b, g.skv, g.hkv, g.d)
    elif spec.layout == "bhsd":
        q = (g.b, g.hq, qlen, g.d)
        k = (g.b, g.hkv, g.skv, g.d)
    elif spec.layout == "bhsd_bsgd":
        q = (g.b, g.hq, qlen, g.d)
        k = (g.b, g.skv, g.hkv, g.d)
    else:                                           # bhsd_paged
        q = (g.b, g.hq, qlen, g.d)
        k = (npages, g.page, g.hkv, g.d)
    act = torch.float32 if spec.impl == "float" else torch.int8
    specs = [(q, act), (k, act), (k, act)]
    seeds = [_iv(r["q"]), _iv(r["k"]), _iv(r["v"])]
    extra_names = []
    if spec.impl != "float":
        shapes = [(g.hq,), (g.hkv,), (g.hkv,), (g.hq,)] \
            if spec.scale_kind == "per_head" else [(), (), (), ()]
        specs += [(s, torch.float32) for s in shapes]
        seeds += [_iv(r["scale"])] * 4
    for flag, role, shape, seed in (
            (kv_len, "kv_len", (g.b,), _iv(r["kv_len"])),
            (q_offset, "q_offset", (g.b,), _iv(r["q_offset"])),
            (paged, "page_table", (g.b, npps), _iv(r["page_table"])),
            (ragged, "q_lens", (g.b,), Interval(0, qlen))):
        if flag:
            specs.append((shape, torch.int32))
            seeds.append(seed)
            extra_names.append(role)
    call_opts = dict(opts or {})

    def fn(q, k, v, *rest):
        if spec.impl == "float":
            scales, extras = None, rest
        else:
            scales = ATT.QuantScales(*rest[:4])
            extras = rest[4:]
        kw = dict(zip(extra_names, extras, strict=True))
        return ATT.dispatch(q, k, v, spec=spec, scales=scales,
                            backend=backend, **kw, **call_opts)

    return Case(name=name, backend=backend, desc=desc, fn=fn, specs=specs,
                seeds=seeds)


def build_matrix(*, smoke: bool = False, backends=None) -> list:
    """The certification matrix. ``smoke`` runs the small geometry; the
    full run certifies at production tile widths."""
    g = SMOKE_GEOMETRY if smoke else FULL_GEOMETRY
    S = ATT.AttentionSpec
    cases = _softmax_cases(g) + _matmul_cases(g)

    fused_kw = dict(out_dtype="int8")
    cases += [
        _attention_case(
            "float_xla/prefill", "float_xla",
            S(mode="prefill", impl="float", causal=True), g,
            desc="float oracle, streaming prefill",
            opts={"q_chunk": g.bq * 2, "kv_chunk": g.bkv * 2}),
        _attention_case(
            "ita_chunked_xla/prefill-paper", "ita_chunked_xla",
            S(mode="prefill", impl="ita", causal=True, softmax="paper",
              out_dtype="int8"),
            g, desc="streaming ITA int path, paper inverse",
            opts={"q_chunk": g.bq * 2, "kv_chunk": g.bkv * 2}),
        _attention_case(
            "ita_chunked_xla/prefill-adaptive", "ita_chunked_xla",
            S(mode="prefill", impl="ita", causal=True, softmax="adaptive",
              out_dtype="int8"),
            g, desc="streaming ITA int path, adaptive inverse",
            opts={"q_chunk": g.bq * 2, "kv_chunk": g.bkv * 2}),
        _attention_case(
            "ita_direct_xla/decode-paper", "ita_direct_xla",
            S(mode="decode", impl="ita", causal=True, q_len=8,
              softmax="paper", out_dtype="int8"), g,
            desc="one-shot decode fallback, paper inverse",
            kv_len=True, q_offset=True),
        _attention_case(
            "ita_direct_xla/decode-adaptive", "ita_direct_xla",
            S(mode="decode", impl="ita", causal=True, q_len=8,
              softmax="adaptive", out_dtype="int8"), g,
            desc="one-shot decode fallback, adaptive inverse",
            kv_len=True, q_offset=True),
        _attention_case(
            "ibert_xla/decode", "ibert_xla",
            S(mode="decode", impl="ibert", causal=True, q_len=1), g,
            desc="I-BERT polynomial softmax decode baseline",
            kv_len=True, q_offset=True),
        _attention_case(
            "ita_onepass_pallas/prefill-paper", "ita_onepass_pallas",
            S(mode="prefill", impl="ita", causal=True, layout="bhsd",
              softmax="paper", **fused_kw), g,
            desc="B2's plain version, causal prefill, paper inverse",
            opts={"block_q": g.bq, "block_kv": g.bkv}),
        _attention_case(
            "ita_onepass_pallas/serve-ragged-paged", "ita_onepass_pallas",
            S(mode="decode", impl="ita", causal=True, layout="bhsd_paged",
              q_len=g.bq, ragged_q=True, softmax="adaptive",
              scale_kind="per_head", **fused_kw), g,
            desc="the serve path (B3's plain version): ragged chunked-"
                 "prefill+decode rows over paged KV, adaptive inverse, "
                 "per-head scales",
            kv_len=True, q_offset=True, paged=True, ragged=True,
            opts={"block_q": g.bq}),
        _attention_case(
            "ita_twopass_pallas/prefill-paper", "ita_twopass_pallas",
            S(mode="prefill", impl="ita", causal=True, layout="bhsd",
              softmax="paper", **fused_kw), g,
            desc="B5a/B5b's plain versions, paper inverse",
            opts={"block_q": g.bq, "block_kv": g.bkv}),
        _attention_case(
            "ita_twopass_pallas/prefill-adaptive", "ita_twopass_pallas",
            S(mode="prefill", impl="ita", causal=True, layout="bhsd",
              softmax="adaptive", **fused_kw), g,
            desc="B5a/B5b's plain versions, adaptive inverse",
            opts={"block_q": g.bq, "block_kv": g.bkv}),
        _attention_case(
            "ita_decode_pallas/ring", "ita_decode_pallas",
            S(mode="decode", impl="ita", causal=True, layout="bhsd_bsgd",
              q_len=1, scale_kind="per_head", **fused_kw), g,
            desc="B4's plain version over the ring layout, per-head "
                 "scales",
            kv_len=True, q_offset=True, opts={"block_kv": g.bkv}),
        _attention_case(
            "ita_decode_pallas/paged-adaptive", "ita_decode_pallas",
            S(mode="decode", impl="ita", causal=True, layout="bhsd_paged",
              q_len=1, softmax="adaptive", **fused_kw), g,
            desc="B4p's plain version over paged KV through the page "
                 "table, adaptive inverse",
            kv_len=True, q_offset=True, paged=True),
    ]
    if backends:
        cases = [c for c in cases if c.backend in backends]
    return cases


# ---------------------------------------------------------------------------
# Runner
# ---------------------------------------------------------------------------

def _bound_json(v):
    if v == INF:
        return "inf"
    if v == -INF:
        return "-inf"
    return v


def analyze_case(case: Case):
    """``(graph, AnalysisResult)`` of one case."""
    gm = case.trace()
    return gm, analyze_graph(gm, case.seeds)


def run_case(case: Case) -> dict:
    t0 = time.monotonic()
    try:
        _, res = analyze_case(case)
    except Exception as e:  # noqa: BLE001 — a crash is a failed certificate
        return {
            "name": case.name, "backend": case.backend, "desc": case.desc,
            "ok": False, "error": f"{type(e).__name__}: {e}",
            "elapsed_s": round(time.monotonic() - t0, 3),
        }
    outs = [o for o in res.outvals if isinstance(o, Interval)]
    return {
        "name": case.name,
        "backend": case.backend,
        "desc": case.desc,
        "ok": res.ok,
        "n_ops": len(res.records),
        "n_unproven": res.n_unproven,
        "path_fixed": res.path_fixed,
        "max_int_magnitude": res.max_int_magnitude,
        "int32_headroom_bits": _headroom_bits(res.max_int_magnitude),
        "out": [[_bound_json(o.lo), _bound_json(o.hi)] for o in outs],
        "findings": [f.to_json() for f in res.findings],
        "notes": [n.to_json() for n in res.notes],
        "elapsed_s": round(time.monotonic() - t0, 3),
    }


def _headroom_bits(mag: int) -> int:
    """How many doublings the widest proven int value has before int32."""
    if mag <= 0:
        return 31
    bits = 0
    while mag < (1 << 31) and bits < 31:
        mag <<= 1
        bits += 1
    return bits - 1 if bits else 0


def run_verification(*, smoke: bool = False, backends=None) -> dict:
    g = SMOKE_GEOMETRY if smoke else FULL_GEOMETRY
    cases = build_matrix(smoke=smoke, backends=backends)
    results = [run_case(c) for c in cases]
    certified = sorted({r["backend"] for r in results if r["ok"]})
    failed = sorted({r["backend"] for r in results if not r["ok"]})
    return {
        "schema": REPORT_SCHEMA,
        "mode": "smoke" if smoke else "full",
        "geometry": g.to_json(),
        "n_cases": len(results),
        "n_failed": sum(1 for r in results if not r["ok"]),
        "certified_backends": certified,
        "failed_backends": failed,
        "ok": all(r["ok"] for r in results),
        "cases": results,
    }
