"""The port's range certificates and loop lints (``repro_torch.analysis``),
on the CPU.

The reference analyzer is not the oracle here (under jax 0.9 eight of
its own tests in ``tests/test_analysis.py`` fail). The port is held to
three things:

- the reference's ``analysis/intervals.py`` (numpy only, its four unit
  tests green): the port's copy agrees with it on its corner cases and
  on random intervals (hypothesis);
- the reference's golden table (``tests/test_analysis.py``'s
  ``SOFTMAX_GOLDEN``), which states what the softmax certificates mean:
  every case ``ok`` with the same proven output intervals. The widest
  proven integer (``max_int_magnitude``) is the port's own, derived
  below from the port's ops;
- an empirical soundness check: every case's graph run concretely
  (``torch.fx.Interpreter``) on 64 seeded inputs inside its seeds and on
  the extremes (every input at its lower, at its upper end), every
  integer node's observed min and max inside its proven interval.

Plus: the analyzer on torch functions (a clipped and an unclipped int8
matmul, an int32 product overflow); the 18 case names equal the
reference's ``build_matrix`` names; all 18 certified at the smoke and at
the full geometry; three mutants flip their certificate; the CLI's
report schema; the two lints that run anywhere (the card lints report
``ran: False`` here); the nine kernels' plain versions at the declared
extremes inside their certificates (the card holds the kernels to them).
"""

import json

import numpy as np
import pytest
import torch
from torch.fx.experimental.proxy_tensor import make_fx

from compat_hypothesis import given, settings, st
from repro.analysis import intervals as JI
from repro.analysis.verify import build_matrix as j_build_matrix
from repro_torch.analysis import intervals as TI
from repro_torch.analysis import analyze_graph, build_matrix, run_case
from repro_torch.analysis.intervals import Interval
from repro_torch.analysis.verify import analyze_case

MODULES = {"port": TI, "reference": JI}

# ---------------------------------------------------------------------------
# Interval domain: the reference's four corner tests on both modules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mod", list(MODULES))
def test_div_int_truncation_corners(mod):
    m = MODULES[mod]
    out, had_zero = m.div_int(m.Interval(-7, -7), m.Interval(2, 2))
    assert not had_zero and (out.lo, out.hi) == (-3, -3)
    out, had_zero = m.div_int(m.Interval(-10, 9), m.Interval(3, 5))
    assert not had_zero
    assert out.contains(m.point(-10 // 3 + 1))
    assert out.contains(m.point(3)) and out.lo == -3 and out.hi == 3
    _, had_zero = m.div_int(m.Interval(1, 8), m.Interval(-2, 2))
    assert had_zero


@pytest.mark.parametrize("mod", list(MODULES))
def test_shift_right_logical_negative_patterns(mod):
    m = MODULES[mod]
    out = m.shift_right_logical(m.Interval(-5, 7), m.Interval(0, 0), 32)
    assert (out.lo, out.hi) == (-5, 7)
    out = m.shift_right_logical(m.Interval(-1, -1), m.Interval(1, 1), 32)
    assert out.hi == (1 << 31) - 1 and out.lo == 0
    out = m.shift_right_logical(m.Interval(128, 128), m.Interval(2, 5), 32)
    assert (out.lo, out.hi) == (4, 32)


@pytest.mark.parametrize("mod", list(MODULES))
def test_clz_bounds(mod):
    m = MODULES[mod]
    assert m.clz(m.point(1), 32) == m.point(31)
    assert m.clz(m.point(0), 32) == m.point(32)
    out = m.clz(m.Interval(1, 1 << 20), 32)
    assert (out.lo, out.hi) == (11, 31)
    assert m.clz(m.Interval(-5, -1), 32) == m.point(0)


@pytest.mark.parametrize("mod", list(MODULES))
def test_dtype_fit(mod):
    m = MODULES[mod]
    assert m.fits(m.Interval(-128, 127), np.int8)
    assert not m.fits(m.Interval(-129, 0), np.int8)
    assert m.dtype_range(np.int32).hi == (1 << 31) - 1
    if mod == "port":                          # torch dtypes name themselves
        assert m.fits(m.Interval(-128, 127), torch.int8)
        assert m.dtype_bits(torch.int32) == 32
        assert m.dtype_range(torch.float32) == m.TOP


def _pair(a, b):
    return (min(a, b), max(a, b))


@settings(max_examples=200, deadline=None)
@given(st.integers(-(1 << 40), 1 << 40), st.integers(-(1 << 40), 1 << 40),
       st.integers(-(1 << 40), 1 << 40), st.integers(-(1 << 40), 1 << 40),
       st.integers(0, 40), st.integers(0, 40))
def test_intervals_agree_with_reference(a, b, c, d, s0, s1):
    (alo, ahi), (blo, bhi), (slo, shi) = _pair(a, b), _pair(c, d), \
        _pair(s0, s1)

    def both(fn):
        got = fn(TI, TI.Interval(alo, ahi), TI.Interval(blo, bhi),
                 TI.Interval(slo, shi))
        want = fn(JI, JI.Interval(alo, ahi), JI.Interval(blo, bhi),
                  JI.Interval(slo, shi))
        return repr(got), repr(want)

    for fn in (lambda m, x, y, s: x + y, lambda m, x, y, s: x - y,
               lambda m, x, y, s: x * y, lambda m, x, y, s: x.join(y),
               lambda m, x, y, s: x.meet(y), lambda m, x, y, s: -x,
               lambda m, x, y, s: x.abs(), lambda m, x, y, s: m.div_int(x, y),
               lambda m, x, y, s: m.rem_int(x, y),
               lambda m, x, y, s: m.div_float(x, y),
               lambda m, x, y, s: m.shift_right_logical(x, s, 64),
               lambda m, x, y, s: m.shift_right_arith(x, s),
               lambda m, x, y, s: m.shift_left(x, s),
               lambda m, x, y, s: m.clz(x, 64),
               lambda m, x, y, s: m.fits(x, "int32"),
               lambda m, x, y, s: x.contains(y)):
        got, want = both(fn)
        assert got == want


# ---------------------------------------------------------------------------
# The analyzer on torch functions
# ---------------------------------------------------------------------------

def _analyze(fn, args, seeds):
    return analyze_graph(make_fx(fn)(*args), seeds)


def test_analyzer_proves_clipped_matmul_and_flags_unclipped():
    from repro_torch.kernels.common import int_matmul

    def clipped(x, y):
        acc = torch.matmul(x.to(torch.int32), y.to(torch.int32))
        return torch.clamp(acc, -128, 127).to(torch.int8)

    def unclipped(x, y):
        acc = torch.matmul(x.to(torch.int32), y.to(torch.int32))
        return acc.to(torch.int8)

    def clipped_f32(x, y):                     # the port's integer product
        return torch.clamp(int_matmul(x, y), -128, 127).to(torch.int8)

    args = (torch.zeros((4, 64), dtype=torch.int8),
            torch.zeros((64, 4), dtype=torch.int8))
    seeds = [Interval(-128, 127), Interval(-128, 127)]
    res = _analyze(clipped, args, seeds)
    assert res.ok and res.max_int_magnitude == 64 * 128 * 128
    assert res.outvals == [Interval(-128, 127)]
    res = _analyze(clipped_f32, args, seeds)
    assert res.ok
    res = _analyze(unclipped, args, seeds)
    assert not res.ok
    assert [f.kind for f in res.findings] == ["narrowing"]


def test_analyzer_flags_int32_product_overflow():
    res = _analyze(lambda x: x * x, (torch.zeros(8, dtype=torch.int32),),
                   [Interval(-(1 << 20), 1 << 20)])
    assert not res.ok
    assert res.findings[0].kind == "overflow"
    assert res.findings[0].prim == "mul"


def test_analyzer_flags_float32_integer_product_past_2_24():
    """An integer product carried in float32 is exact only inside
    ±2^24: 1024 int8 terms of 128·128 reach 2^24 and pass; 1025 do not."""
    from repro_torch.kernels.common import int_matmul
    seeds = [Interval(-128, 127), Interval(-128, 127)]
    for k, ok in ((1024, True), (1025, False)):
        res = _analyze(int_matmul, (torch.zeros((2, k), dtype=torch.int8),
                                    torch.zeros((k, 2), dtype=torch.int8)),
                       seeds)
        assert res.ok == ok
        assert ok or res.findings[0].kind == "overflow"


def test_analyzer_widens_unknown_ops_as_unproven():
    res = _analyze(lambda x: torch.cumprod(x, 0).to(torch.int8),
                   (torch.ones(4, dtype=torch.int32),), [Interval(1, 2)])
    assert res.n_unproven == 1
    assert not res.ok                          # the widened value narrows


# ---------------------------------------------------------------------------
# The matrix
# ---------------------------------------------------------------------------

# (ok, proven output intervals) of the reference's golden table
# (tests/test_analysis.py SOFTMAX_GOLDEN), and the port's own widest
# proven integer at the smoke geometry (rows of 128 int8 logits):
# - ref/paper: 2^16 = 65536, the paper DI's dividend ``1 << 16`` and
#   its quotient ``65536 // sigma`` at sigma = 1 (the shifted p after it
#   stays <= 65536; clamped to 256);
# - ref/adaptive: 2^23 = 8388608, the adaptive DI's dividend ``1 <<
#   (e_r + 8)`` at e_r = floor(log2(128 · 256)) = 15;
# - pallas/paper: (127 - 8) << 23 = 998244352, the int32 bit pattern of
#   ``pow2_neg(8)`` = 2^-8 (the paper DI's output scale);
# - pallas/adaptive: (127 - 0) << 23 = 1065353216, ``pow2_neg(e_r)`` at
#   e_r = 0 (2^0 = 1.0).
# The reference's 2^27 - 1 was its logical shift of a possibly negative
# ``max - x``; the port clamps ``max - x`` at 0 before its arithmetic
# shift, so that value never exists.
SOFTMAX_GOLDEN = {
    "ita_softmax_pallas/paper": (True, [[0.0, 256.0]], 998244352, 0),
    "ita_softmax_pallas/adaptive": (True, [[0.0, 256.0]], 1065353216, 0),
    "ita_softmax_ref/paper": (
        True, [[0, 256], [1, 32768], [-256, 127]], 65536, 0),
    "ita_softmax_ref/adaptive": (
        True, [[0, 256], [0, 15], [-256, 127]], 8388608, 0),
}


def _case(name, smoke=True):
    matches = [c for c in build_matrix(smoke=smoke) if c.name == name]
    assert len(matches) == 1, name
    return matches[0]


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
def test_case_names_equal_reference(smoke):
    assert [c.name for c in build_matrix(smoke=smoke)] == \
        [c.name for c in j_build_matrix(smoke=smoke)]
    assert [c.backend for c in build_matrix(smoke=smoke)] == \
        [c.backend for c in j_build_matrix(smoke=smoke)]


@pytest.mark.parametrize("name", sorted(SOFTMAX_GOLDEN))
def test_softmax_range_report_matches_golden(name):
    r = run_case(_case(name))
    ok, out, mag, unproven = SOFTMAX_GOLDEN[name]
    assert r["ok"] == ok, r.get("findings", r.get("error"))
    assert r["out"] == out
    assert r["max_int_magnitude"] == mag
    assert r["n_unproven"] == unproven
    assert not r["path_fixed"]
    assert json.dumps(r)


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
def test_every_case_is_certified(smoke):
    from repro_torch.analysis.verify import run_verification
    rep = run_verification(smoke=smoke)
    bad = {c["name"]: c.get("findings", c.get("error"))
           for c in rep["cases"] if not c["ok"]}
    assert rep["ok"] and not bad, bad
    assert rep["n_cases"] == 18
    assert not any(c["n_unproven"] or c["path_fixed"] for c in rep["cases"])


# ---------------------------------------------------------------------------
# Teeth: seeded mutants must flip their certificate
# ---------------------------------------------------------------------------

def test_mutant_dropped_requant_clip_is_flagged(monkeypatch):
    """Remove the int8 clip from the QK requant of the twopass kernels'
    plain version: the int8 logits (and A) are no longer proven in
    range -> narrowing."""
    import repro_torch.kernels.ita_attention.kernel as K
    from repro_torch.kernels.common import int_matmul

    def qk_noclip(q_q, k_q, lmult):
        acc = int_matmul(q_q, k_q.transpose(-1, -2))
        return torch.round(acc * lmult).to(torch.int32)

    monkeypatch.setattr(K, "requant_logits", qk_noclip)
    r = run_case(_case("ita_twopass_pallas/prefill-paper"))
    assert not r["ok"]
    assert "narrowing" in {f["kind"] for f in r["findings"]}


def test_mutant_dropped_shift_clamp_is_flagged(monkeypatch):
    """The reference's mutant in the port's ``da_update``: the shift
    ``k`` of ``new_max - logits`` without ``min(k, 31)`` and without the
    port's clamp of the difference at 0 (the reference's logical shift
    needed neither to be negative): a masked lane's ``new_max - logits``
    may be negative, and torch's arithmetic ``>>`` keeps it so — a
    negative shift of ``128 >> k`` -> shift_range. Dropping
    ``min(k, 31)`` alone keeps the certificate: with int8 logits the
    port's ``k`` is proven <= 7."""
    import repro_torch.kernels.common as C
    import repro_torch.kernels.ita_attention.ref as R
    from repro_torch.core.quant import SOFTMAX_SHIFT

    def da(m, sigma, logits, valid, *, keep_floor):
        x = torch.where(valid, logits, C.NEG_SENTINEL)
        new_m = torch.maximum(m, x.amax(dim=-1, keepdim=True))
        delta = torch.clamp((new_m - m) >> SOFTMAX_SHIFT, max=31)
        diff = new_m - logits
        k = (diff.clamp(min=0) if keep_floor else diff) >> SOFTMAX_SHIFT
        k = torch.where(valid, k, C.MASK_K)       # min(k, 31) dropped
        u = torch.full_like(k, 128) >> k
        new_sigma = (sigma >> delta) + 2 * u.sum(dim=-1, keepdim=True,
                                                 dtype=torch.int32)
        return u, delta, new_m, new_sigma

    case = "ita_onepass_pallas/prefill-paper"
    monkeypatch.setattr(R, "da_update", lambda *a: da(*a, keep_floor=True))
    r = run_case(_case(case))
    assert r["ok"], r["findings"]
    monkeypatch.setattr(R, "da_update", lambda *a: da(*a, keep_floor=False))
    r = run_case(_case(case))
    assert not r["ok"]
    assert "shift_range" in {f["kind"] for f in r["findings"]}


def test_mutant_widened_softmax_numerator_is_flagged(monkeypatch):
    """Remove the p <= 256 identity clamp from ``core/softmax.py``: at
    the full geometry's 2048 keys the decode fallback's p·V, taken as
    float32 products over 512-key tiles (65536 · 128 · 512 = 2^32), is no
    longer proven exact -> overflow."""
    from repro_torch.core import softmax as SM

    def noclamp(x_q, mask=None, axis=-1):
        row_max = SM._masked_max(x_q, mask, axis)
        k = SM._apply_mask_k(SM._k_of(x_q, row_max), mask)
        terms = SM._shift_terms(SM._UNIT, k)
        sigma = torch.clamp(terms.sum(dim=axis, keepdim=True,
                                      dtype=torch.int32), min=1)
        sigma_inv = torch.div(torch.full_like(sigma, 1 << SM._W_INV), sigma,
                              rounding_mode="floor")
        return SM._shift_terms(sigma_inv, k), sigma, row_max

    monkeypatch.setattr(SM, "ita_softmax_int", noclamp)
    r = run_case(_case("ita_direct_xla/decode-paper", smoke=False))
    assert not r["ok"]
    kinds = {f["kind"] for f in r["findings"]}
    assert kinds & {"overflow", "narrowing"}, r["findings"]


# ---------------------------------------------------------------------------
# Soundness: concrete runs inside the proven intervals
# ---------------------------------------------------------------------------

class _Observed(torch.fx.Interpreter):
    """Records the min and max of every integer node and of every float
    node the analysis holds integer-valued (``intvals``: the integer
    products the port carries in float32, ``int_matmul``), and the float
    nodes among those whose values are not all integers."""

    def __init__(self, gm, intvals):
        super().__init__(gm)
        self.intvals = intvals
        self.seen = {}
        self.fractional = set()

    def run_node(self, n):
        out = super().run_node(n)
        if n.op == "output" or not isinstance(out, torch.Tensor) \
                or not out.numel() or out.dtype == torch.bool:
            return out
        if out.dtype.is_floating_point:
            if n.name not in self.intvals:
                return out
            if not torch.equal(out, out.round()):
                self.fractional.add(n.name)
            lo, hi = float(out.min()), float(out.max())
        else:
            lo, hi = int(out.min()), int(out.max())
        was = self.seen.get(n.name)
        self.seen[n.name] = (lo, hi) if was is None else (
            min(lo, was[0]), max(hi, was[1]))
        return out


@pytest.mark.parametrize("name", [c.name for c in build_matrix(smoke=True)])
def test_soundness_concrete_runs_inside_proven_intervals(name):
    case = _case(name)
    gm, res = analyze_case(case)
    rng = np.random.default_rng(1)
    obs = _Observed(gm, res.intvals)
    inputs = [case.example(rng) for _ in range(64)]
    inputs += [case.example(rng, at="lo"), case.example(rng, at="hi")]
    for args in inputs:
        obs.run(*args)
    assert obs.seen and not obs.fractional, obs.fractional
    carried = {n.name for n in gm.graph.nodes if n.name in res.intvals
               and isinstance(n.meta.get("val"), torch.Tensor)
               and n.meta["val"].dtype.is_floating_point}
    assert carried <= set(obs.seen), carried - set(obs.seen)
    outside = {n: (lo, hi, res.intervals[n]) for n, (lo, hi) in
               obs.seen.items()
               if not res.intervals[n].contains(Interval(lo, hi))}
    assert not outside, outside


# ---------------------------------------------------------------------------
# CLI, lints, kernels at the extremes
# ---------------------------------------------------------------------------

def test_cli_writes_schema_checked_report(tmp_path, capsys):
    from repro_torch.analysis.__main__ import main
    from repro_torch.analysis.verify import REPORT_SCHEMA
    out = tmp_path / "range_report.json"
    rc = main(["--smoke", "--backend", "ita_softmax", "--no-lints",
               "--json", str(out)])
    assert rc == 0
    rep = json.loads(out.read_text())
    assert rep["schema"] == REPORT_SCHEMA
    assert rep["ok"] and rep["n_failed"] == 0
    assert rep["certified_backends"] == ["ita_softmax"]
    assert {c["name"] for c in rep["cases"]} == set(SOFTMAX_GOLDEN)
    keys = {"name", "backend", "desc", "ok", "n_ops", "n_unproven",
            "max_int_magnitude", "int32_headroom_bits", "out", "findings",
            "notes", "elapsed_s"}
    assert all(keys <= set(c) for c in rep["cases"])
    assert "certificates" in capsys.readouterr().out


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a machine "
                    "without CUDA: the refusal is what it checks")
def test_lints_ask_for_the_card_unless_the_cpu_is_named():
    """The lints default to the card and raise without one, as the
    port's other entry points; the CLI runs them on the CPU only on
    ``--device cpu`` or ``--smoke``, and raises before any work."""
    from repro_torch.analysis.__main__ import main
    from repro_torch.analysis.lints import run_lints
    for call in (lambda: run_lints(smoke=True),
                 lambda: main(["--backend", "ita_softmax"]),
                 lambda: main(["--smoke", "--device", "cuda"])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert main(["--smoke", "--backend", "ita_softmax", "--no-lints",
                 "--device", "cuda"]) == 0          # no lint, no device


def test_cpu_lints_pass_and_card_lints_do_not_run():
    from repro_torch.analysis.lints import (CARD_LINTS,
                                            expected_variant_bound,
                                            run_lints)
    report = run_lints(smoke=True, device="cpu")
    by_name = {lint["name"]: lint for lint in report["lints"]}
    assert by_name["pow2-variant-contract"]["ok"], by_name
    assert by_name["serve-variant-bound"]["ok"], by_name
    assert expected_variant_bound(8) == 5
    assert report["ok"]
    for name in CARD_LINTS:
        assert by_name[name]["ran"] is False and by_name[name]["ok"] is None


def test_kernels_plain_versions_at_extremes_inside_certificates():
    from repro_torch.analysis.extremes import KERNELS, check_extremes
    rows = check_extremes("cpu")
    assert {r["kernel"] for r in rows} == set(KERNELS)
    bad = [r for r in rows
           if not (r["certified"] and r["equal"] and r["inside"])]
    assert not bad, bad
