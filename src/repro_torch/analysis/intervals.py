"""Integer/real interval domain of the range analyzer
(a copy of ``repro.analysis.intervals``).

One abstract value: a closed interval ``[lo, hi]`` over the extended
reals. Integer-dtype values carry exact python-int bounds (unbounded —
overflow is *detected*, never silently wrapped); float-dtype values
carry float bounds. ``TOP`` is ``[-inf, inf]``; the empty/uninitialized
state (scratch memory before its first write) is represented by ``None``
at the ref-cell layer, not here.

The domain is non-relational: it cannot prove facts that need a
correlation between two values (e.g. ``2^(e_r+8) // sigma <= 256``
requires knowing ``2^e_r <= sigma``). Kernels make such bounds
structural with identity clamps (see ``kernels/common.py``) so the
analyzer stays simple and sound.

Dtypes are numpy dtypes, dtype classes, plain names or torch dtypes
(``torch.int32`` names itself ``"torch.int32"``; the prefix is dropped),
so the module needs numpy only.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

INF = math.inf


@dataclasses.dataclass(frozen=True)
class Interval:
    """Closed interval [lo, hi]; bounds are python ints, floats or ±inf."""

    lo: float
    hi: float

    def __post_init__(self):
        assert self.lo <= self.hi, (self.lo, self.hi)

    # -- structure ----------------------------------------------------------

    @property
    def is_point(self) -> bool:
        return self.lo == self.hi

    def join(self, other: "Interval") -> "Interval":
        return Interval(min(self.lo, other.lo), max(self.hi, other.hi))

    def meet(self, other: "Interval") -> "Interval":
        """Intersection; collapses to the nearer bound if disjoint."""
        lo, hi = max(self.lo, other.lo), min(self.hi, other.hi)
        if lo > hi:                       # disjoint — keep a sound point
            return Interval(lo, lo) if self.hi < other.lo else Interval(hi, hi)
        return Interval(lo, hi)

    def contains(self, other: "Interval") -> bool:
        return self.lo <= other.lo and other.hi <= self.hi

    def __repr__(self):
        def f(v):
            if v == INF:
                return "inf"
            if v == -INF:
                return "-inf"
            if isinstance(v, float) and v == int(v) and abs(v) < 2 ** 63:
                return str(int(v))
            return str(v)
        return f"[{f(self.lo)}, {f(self.hi)}]"

    # -- arithmetic ---------------------------------------------------------

    def __add__(self, other: "Interval") -> "Interval":
        return Interval(self.lo + other.lo, self.hi + other.hi)

    def __sub__(self, other: "Interval") -> "Interval":
        return Interval(self.lo - other.hi, self.hi - other.lo)

    def __mul__(self, other: "Interval") -> "Interval":
        cands = [_mul(a, b) for a in (self.lo, self.hi)
                 for b in (other.lo, other.hi)]
        return Interval(min(cands), max(cands))

    def __neg__(self) -> "Interval":
        return Interval(-self.hi, -self.lo)

    def scale(self, n) -> "Interval":
        """Multiply by a non-negative constant (e.g. a reduction count)."""
        assert n >= 0, n
        return Interval(_mul(self.lo, n), _mul(self.hi, n))

    def abs(self) -> "Interval":
        if self.lo >= 0:
            return self
        if self.hi <= 0:
            return -self
        return Interval(0, max(-self.lo, self.hi))


def _mul(a, b):
    """inf-safe product with 0 * inf = 0 (interval corners)."""
    if a == 0 or b == 0:
        return 0
    return a * b


TOP = Interval(-INF, INF)
ZERO = Interval(0, 0)
ONE = Interval(1, 1)
BOOL = Interval(0, 1)


def point(v) -> Interval:
    return Interval(v, v)


def join_all(ivals) -> Interval:
    out = None
    for iv in ivals:
        out = iv if out is None else out.join(iv)
    assert out is not None
    return out


# -- dtype ranges -----------------------------------------------------------

_INT_RANGES = {
    "int8": (-(1 << 7), (1 << 7) - 1),
    "int16": (-(1 << 15), (1 << 15) - 1),
    "int32": (-(1 << 31), (1 << 31) - 1),
    "int64": (-(1 << 63), (1 << 63) - 1),
    "uint8": (0, (1 << 8) - 1),
    "uint16": (0, (1 << 16) - 1),
    "uint32": (0, (1 << 32) - 1),
    "uint64": (0, (1 << 64) - 1),
}


def _dtype_name(dtype) -> str:
    """Canonical name: accepts np.dtype instances, dtype classes like
    ``np.int8``, plain strings and torch dtypes."""
    try:
        return np.dtype(dtype).name
    except TypeError:
        return str(dtype).removeprefix("torch.")


def is_int_dtype(dtype) -> bool:
    return _dtype_name(dtype) in _INT_RANGES


def is_bool_dtype(dtype) -> bool:
    return _dtype_name(dtype) == "bool"


def dtype_bits(dtype) -> int:
    name = _dtype_name(dtype)
    return int(name.lstrip("uint").lstrip("int") or 0) \
        if name in _INT_RANGES else 0


def dtype_range(dtype) -> Interval:
    """The representable interval of ``dtype`` (TOP for floats)."""
    name = _dtype_name(dtype)
    if name in _INT_RANGES:
        lo, hi = _INT_RANGES[name]
        return Interval(lo, hi)
    if name == "bool":
        return BOOL
    return TOP


def fits(ival: Interval, dtype) -> bool:
    return dtype_range(dtype).contains(ival)


# -- transfer helpers shared by ranges.py -----------------------------------

def div_int(num: Interval, den: Interval) -> tuple[Interval, bool]:
    """lax.div on ints (truncation toward zero). Returns (result, had_zero):
    a divisor interval containing 0 makes the result TOP (flagged as a
    note by the caller, not an overflow finding)."""
    if den.lo <= 0 <= den.hi:
        return TOP, True
    cands = [_trunc_div(a, b) for a in (num.lo, num.hi)
             for b in (den.lo, den.hi)]
    # quotient is monotone between corners for a fixed-sign divisor, but
    # truncation means the extrema can sit at mixed corners; corners are
    # sufficient because trunc-div is monotone in the numerator and
    # anti-monotone in |divisor|.
    if num.lo <= 0 <= num.hi:
        cands.append(0)
    return Interval(min(cands), max(cands)), False


def _trunc_div(a, b):
    if a in (INF, -INF) or b in (INF, -INF):
        if b in (INF, -INF):
            return 0
        return INF if (a > 0) == (b > 0) else -INF
    q = abs(int(a)) // abs(int(b))
    return q if (a >= 0) == (b >= 0) else -q


def div_float(num: Interval, den: Interval) -> Interval:
    if den.lo <= 0 <= den.hi:
        return TOP
    cands = [a / b for a in (num.lo, num.hi) for b in (den.lo, den.hi)
             if b not in (INF, -INF)] or [0.0]
    if num.lo <= 0 <= num.hi:
        cands.append(0.0)
    return Interval(min(cands), max(cands))


def rem_int(num: Interval, den: Interval) -> tuple[Interval, bool]:
    """lax.rem (sign follows the numerator). TOP when 0 in divisor."""
    if den.lo <= 0 <= den.hi:
        return TOP, True
    m = max(abs(den.lo), abs(den.hi)) - 1
    lo = 0 if num.lo >= 0 else -m
    hi = 0 if num.hi <= 0 else m
    return Interval(lo, hi), False


def shift_right_logical(val: Interval, sh: Interval, bits: int) -> Interval:
    """Bit-pattern right shift on a ``bits``-wide integer. For shift >= 1
    the result is a non-negative value < 2^(bits - shift); shift == 0 is
    the identity (a negative stays negative)."""
    if sh.hi <= 0:                        # shift is exactly 0: identity
        return val
    cands = []
    sh_lo = max(int(sh.lo), 0)
    if sh.lo <= 0:                        # shift 0 possible: identity
        cands += [val.lo, val.hi]
    s = max(sh_lo, 1)
    if val.hi >= 0:                       # non-negative part, shifted
        cands.append(max(val.lo, 0) >> min(int(sh.hi), bits - 1)
                     if sh.hi < bits else 0)
        cands.append(int(val.hi) >> s)
    if val.lo < 0:                        # negative bit patterns go huge
        cands.append(((1 << bits) - 1) >> s)
        cands.append(0)
    if not cands:
        cands = [0]
    return Interval(min(cands), max(cands))


def shift_right_arith(val: Interval, sh: Interval) -> Interval:
    """Arithmetic right shift (python ``>>`` semantics on ints)."""
    cands = []
    for v in (val.lo, val.hi):
        for s in (int(max(sh.lo, 0)), int(max(sh.hi, 0))):
            cands.append(int(v) >> s if v not in (INF, -INF)
                         else (0 if v == INF else -1))
    return Interval(min(cands), max(cands))


def shift_left(val: Interval, sh: Interval) -> Interval:
    """Unbounded left shift (the caller applies the dtype-fit check)."""
    cands = []
    for v in (val.lo, val.hi):
        for s in (int(max(sh.lo, 0)), int(max(sh.hi, 0))):
            cands.append(int(v) << s if v not in (INF, -INF) else v)
    return Interval(min(cands), max(cands))


def clz(val: Interval, bits: int) -> Interval:
    """Count-leading-zeros over a ``bits``-wide integer."""
    def one(v):
        if v < 0:
            return 0
        if v == 0:
            return bits
        return bits - int(v).bit_length()
    if val.hi < 0:
        return point(0)                 # sign bit always set
    lo_c = 0 if val.lo < 0 else one(val.hi)
    hi_c = one(max(val.lo, 0))
    return Interval(min(lo_c, hi_c), max(lo_c, hi_c))
