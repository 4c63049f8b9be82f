"""Interval interpreter over aten-level ``torch.fx`` graphs
(``repro.analysis.ranges``, rewritten for the port).

``analyze_graph(gm, seeds)`` walks a graph that
``torch.fx.experimental.proxy_tensor.make_fx`` traced from a port
function, with every input seeded to a declared interval (int8 tensors
to [-128, 127], scales to ``attention.spec``'s ``SCALE_BOUNDS``,
``kv_len`` to the pool's capacity, ...), and propagates one transfer
function per aten op. Three checks, with torch's semantics, turn the
propagation into a no-overflow certificate:

- **overflow**: the result of an integer add, sub, mul, matmul, sum or
  left shift, computed in unbounded integers, must fit the op's dtype.
  The port takes its integer products as float matmuls
  (``kernels.common.int_matmul``, float64 in ``core.quant``): a matmul of
  two integer-valued float operands is an integer matmul carried in
  that float type, and its result must fit the float's exact-integer
  range (±2^24 in float32, ±2^53 in float64), which bounds every
  partial sum too;
- **narrowing**: a cast to an integer dtype (``_to_copy``) whose operand
  is not proven inside the target range (a float operand is truncated
  toward zero first, as torch converts);
- **shift_range**: a shift amount not proven within ``[0, bits-1]``.
  torch's ``>>`` on a signed dtype is an arithmetic shift
  (``kernels/common.py``), unlike JAX's ``shift_right_logical``: a
  negative operand stays negative, and its shift needs no logical
  widening.

The graph is the schedule: the plain versions' Python loops over KV
tiles unroll in the trace, so every tile's DA step is walked in order
and the reference's Pallas grid simulation has no counterpart.

The domain is non-relational but for two sound rules:
``maximum(a, b) - a`` (or ``- b``) is non-negative, so the DA step's
``delta = (new_max - old_max) >> 5`` is a legal shift; and ``x -
amax(x)`` is non-positive (I-BERT's ``x - max``).

An op without a transfer function gives its dtype's full range and a
note (the report counts it as *unproven*, never as proven). A trace that
read a tensor value back to the host (``aten._local_scalar_dense``) has
its control path fixed at the traced values: the report notes it
(``path_fixed``).
"""

from __future__ import annotations

import dataclasses
import math
import operator
import struct

import torch
import torch.fx

from repro_torch.analysis import intervals as iv
from repro_torch.analysis.intervals import (BOOL, INF, TOP, Interval,
                                            dtype_bits, dtype_range, fits,
                                            is_bool_dtype, is_int_dtype,
                                            join_all, point)

# exact-integer range of the float types an integer product rides
_EXACT_INT = {torch.float32: 1 << 24, torch.float64: 1 << 53,
              torch.bfloat16: 1 << 8, torch.float16: 1 << 11}


@dataclasses.dataclass
class Finding:
    """A failed check — the interval could not be proven in range."""

    kind: str          # overflow | narrowing | shift_range
    prim: str
    path: str
    dtype: str
    ival: str
    bound: str
    message: str

    def to_json(self):
        return dataclasses.asdict(self)


@dataclasses.dataclass
class Note:
    """Non-failing diagnostics (unproven ops, possible zero divisors,
    a control path fixed at the traced values)."""

    kind: str          # unproven | zero_divisor | path_fixed
    path: str
    message: str

    def to_json(self):
        return dataclasses.asdict(self)


@dataclasses.dataclass
class OpRecord:
    prim: str
    path: str
    dtype: str
    lo: float
    hi: float


@dataclasses.dataclass
class AnalysisResult:
    findings: list
    notes: list
    records: list
    outvals: list
    intervals: dict            # node name -> proven Interval (tensors)
    intvals: frozenset = frozenset()  # float nodes proven integer-valued

    @property
    def ok(self) -> bool:
        return not self.findings

    @property
    def n_unproven(self) -> int:
        return sum(1 for n in self.notes if n.kind == "unproven")

    @property
    def path_fixed(self) -> bool:
        return any(n.kind == "path_fixed" for n in self.notes)

    @property
    def max_int_magnitude(self) -> int:
        """Largest |bound| proven over every integer-dtype op — the
        headline of a certificate (how close the pipeline comes to the
        int32 rail)."""
        m = 0
        for r in self.records:
            if is_int_dtype(r.dtype) and abs(r.lo) != INF and abs(r.hi) != INF:
                m = max(m, int(abs(r.lo)), int(abs(r.hi)))
        return m

    def findings_by_kind(self):
        out: dict[str, int] = {}
        for f in self.findings:
            out[f.kind] = out.get(f.kind, 0) + 1
        return out


def tensor_interval(t: torch.Tensor) -> Interval:
    """The interval of a concrete tensor's values (its min and max)."""
    if t.numel() == 0:
        return dtype_range(t.dtype)
    if t.dtype == torch.bool or not t.dtype.is_floating_point:
        return Interval(int(t.min()), int(t.max()))
    lo, hi = float(t.min()), float(t.max())
    if not (math.isfinite(lo) and math.isfinite(hi)):
        return TOP
    return Interval(lo, hi)


def _meta(node):
    return node.meta.get("val")


def _dtype(node):
    v = _meta(node)
    return v.dtype if isinstance(v, torch.Tensor) else None


def _shape(x):
    v = _meta(x) if isinstance(x, torch.fx.Node) else x
    return tuple(v.shape)


def _name(node) -> str:
    t = node.target
    packet = getattr(t, "overloadpacket", None)
    return packet.__name__ if packet is not None else getattr(
        t, "__name__", str(t))


def _mutated(node):
    """The input node an in-place (or ``out=``) op writes, or None."""
    schema = getattr(node.target, "_schema", None)
    if schema is None:
        return None
    for i, a in enumerate(schema.arguments):
        if a.alias_info is not None and a.alias_info.is_write:
            x = node.args[i] if i < len(node.args) else node.kwargs.get(
                a.name)
            return x if isinstance(x, torch.fx.Node) else None
    return None


def _overload(node) -> str:
    return getattr(node.target, "_overloadname", "")


class Interp:
    """One analysis run over one graph."""

    def __init__(self, gm: torch.fx.GraphModule):
        self.gm = gm
        self.env: dict = {}
        self.intval: set = set()        # float nodes holding integers
        self.findings: list[Finding] = []
        self.notes: list[Note] = []
        self.records: list[OpRecord] = []
        self._noted: set = set()

    # -- plumbing -----------------------------------------------------------

    def value(self, a):
        if isinstance(a, torch.fx.Node):
            return self.env[a]
        if isinstance(a, bool):
            return point(int(a))
        if isinstance(a, (int, float)):
            return point(a) if math.isfinite(a) else \
                Interval(a, a) if a in (INF, -INF) else TOP
        if isinstance(a, (list, tuple)):
            return [self.value(x) for x in a]
        return a

    def is_intval(self, a) -> bool:
        """An integer-valued operand: an integer tensor, or a float one
        cast from integers or rounded."""
        if isinstance(a, torch.fx.Node):
            dt = _dtype(a)
            return a in self.intval or (dt is not None
                                        and not dt.is_floating_point)
        return isinstance(a, int) or (isinstance(a, float)
                                      and a == int(a))

    def note_once(self, kind, path, message):
        key = (kind, message)
        if key not in self._noted:
            self._noted.add(key)
            self.notes.append(Note(kind, path, message))

    def check_fit(self, kind, prim, path, dtype, ival: Interval) -> Interval:
        if is_int_dtype(dtype) and not fits(ival, dtype):
            self.findings.append(Finding(
                kind=kind, prim=prim, path=path, dtype=str(dtype),
                ival=repr(ival), bound=repr(dtype_range(dtype)),
                message=f"{prim}: proven interval {ival!r} exceeds "
                        f"{dtype} range {dtype_range(dtype)!r}"))
            return ival.meet(dtype_range(dtype))
        return ival

    def check_exact(self, prim, path, dtype, ival: Interval):
        """An integer product carried in a float type must stay inside
        the float's exact-integer range."""
        bound = _EXACT_INT.get(dtype)
        if bound is None:
            return
        if max(abs(ival.lo), abs(ival.hi)) > bound:
            self.findings.append(Finding(
                kind="overflow", prim=prim, path=path, dtype=str(dtype),
                ival=repr(ival), bound=repr(Interval(-bound, bound)),
                message=f"{prim}: integer product {ival!r} carried in "
                        f"{dtype} leaves its exact-integer range "
                        f"±{bound}"))

    def check_shift(self, prim, path, dtype, sh: Interval):
        bits = dtype_bits(dtype) or 32
        ok = Interval(0, bits - 1)
        if not ok.contains(sh):
            self.findings.append(Finding(
                kind="shift_range", prim=prim, path=path, dtype=str(dtype),
                ival=repr(sh), bound=repr(ok),
                message=f"{prim}: shift amount {sh!r} not proven within "
                        f"{ok!r} (shift >= width is undefined)"))

    # -- walking ------------------------------------------------------------

    def run(self, seeds) -> list:
        placeholders = [n for n in self.gm.graph.nodes
                        if n.op == "placeholder"]
        if len(placeholders) != len(seeds):
            raise ValueError(f"{len(seeds)} seeds for {len(placeholders)} "
                             f"graph inputs")
        outvals = []
        for node in self.gm.graph.nodes:
            if node.op == "placeholder":
                seed = seeds[placeholders.index(node)]
                dt = _dtype(node)
                rng = dtype_range(dt) if dt is not None else TOP
                self.env[node] = rng if seed is None else seed.meet(rng)
            elif node.op == "get_attr":
                self.env[node] = tensor_interval(
                    getattr(self.gm, node.target))
            elif node.op == "call_function":
                self.call(node)
            elif node.op == "output":
                outvals = self.value(node.args[0])
                if not isinstance(outvals, list):
                    outvals = [outvals]
            else:
                raise ValueError(f"unsupported graph node {node.op}")
        return _flatten(outvals)

    def call(self, node):
        path = node.name
        if node.target is operator.getitem:
            src, idx = node.args
            self.env[node] = self.env[src][idx]
            if src in self.intval:
                self.intval.add(node)
            return
        name = _name(node)
        if name == "_local_scalar_dense":
            self.note_once("path_fixed", path,
                           "a tensor value was read back to the host: the "
                           "trace's control path is fixed at its values")
        fn = _TRANSFER.get(name)
        args = [self.value(a) for a in node.args]
        kwargs = {k: self.value(v) for k, v in node.kwargs.items()}
        if fn is None:
            out = self.unknown(node, name)
        else:
            out = fn(self, node, args, kwargs, path)
        tgt = _mutated(node)
        if tgt is not None and isinstance(out, Interval):
            # an in-place op: later reads of its target see either state
            self.env[tgt] = self.env[tgt].join(out)
        self.env[node] = out
        v = _meta(node)
        if isinstance(out, Interval) and isinstance(v, torch.Tensor):
            self.records.append(OpRecord(
                prim=name, path=path, dtype=str(v.dtype).removeprefix(
                    "torch."), lo=out.lo, hi=out.hi))

    def unknown(self, node, name):
        self.note_once("unproven", node.name,
                       f"no transfer function for '{name}' (result "
                       f"widened to dtype range)")
        v = _meta(node)
        if isinstance(v, (list, tuple)):
            return [dtype_range(x.dtype) if isinstance(x, torch.Tensor)
                    else TOP for x in v]
        return dtype_range(v.dtype) if isinstance(v, torch.Tensor) else TOP


def _flatten(vals):
    out = []
    for v in vals:
        if isinstance(v, list):
            out.extend(_flatten(v))
        else:
            out.append(v)
    return out


# ---------------------------------------------------------------------------
# Transfer functions — (interp, node, args, kwargs, path) -> value
# ---------------------------------------------------------------------------

def _odtype(node):
    return _dtype(node)


def _ival(x):
    return x if isinstance(x, Interval) else TOP


def _mark_int(self, node, *operands):
    if all(self.is_intval(a) for a in operands):
        self.intval.add(node)


def _maximum_of(a, b) -> bool:
    """``a`` is ``maximum(b, ·)`` or ``maximum(·, b)``."""
    return isinstance(a, torch.fx.Node) and isinstance(b, torch.fx.Node) \
        and _name(a) == "maximum" and b in a.args


def _amax_of(a, b) -> bool:
    """``a`` is ``amax(b, ...)``: no element of ``b`` exceeds it."""
    return isinstance(a, torch.fx.Node) and isinstance(b, torch.fx.Node) \
        and _name(a) == "amax" and a.args[0] is b


def _t_add(self, node, args, kw, path):
    a, b = _ival(args[0]), _ival(args[1])
    alpha = kw.get("alpha", point(1))
    out = a + b * _ival(alpha) if alpha is not None else a + b
    _mark_int(self, node, *node.args[:2])
    return self.check_fit("overflow", "add", path, _odtype(node), out)


def _t_sub(self, node, args, kw, path):
    a, b = _ival(args[0]), _ival(args[1])
    alpha = kw.get("alpha")
    out = a - (b * alpha if isinstance(alpha, Interval) else b)
    if _maximum_of(node.args[0], node.args[1]):
        out = Interval(max(out.lo, 0), max(out.hi, 0))
    if _amax_of(node.args[1], node.args[0]):
        out = Interval(min(out.lo, 0), min(out.hi, 0))
    _mark_int(self, node, *node.args[:2])
    return self.check_fit("overflow", "sub", path, _odtype(node), out)


def _t_rsub(self, node, args, kw, path):
    a, b = _ival(args[0]), _ival(args[1])
    _mark_int(self, node, *node.args[:2])
    return self.check_fit("overflow", "sub", path, _odtype(node), b - a)


def _t_mul(self, node, args, kw, path):
    _mark_int(self, node, *node.args[:2])
    return self.check_fit("overflow", "mul", path, _odtype(node),
                          _ival(args[0]) * _ival(args[1]))


def _t_maximum(self, node, args, kw, path):
    a, b = args[0], args[1]
    _mark_int(self, node, *node.args[:2])
    return Interval(max(a.lo, b.lo), max(a.hi, b.hi))


def _t_clamp(self, node, args, kw, path):
    x = args[0]
    lo = args[1] if len(args) > 1 else kw.get("min")
    hi = args[2] if len(args) > 2 else kw.get("max")
    out_lo, out_hi = x.lo, x.hi
    if isinstance(lo, Interval):
        out_lo, out_hi = max(out_lo, lo.lo), max(out_hi, lo.hi)
    if isinstance(hi, Interval):
        out_lo, out_hi = min(out_lo, hi.lo), min(out_hi, hi.hi)
    _mark_int(self, node, node.args[0])
    return Interval(out_lo, out_hi)


def _t_div(self, node, args, kw, path):
    dt = _odtype(node)
    mode = kw.get("rounding_mode", args[2] if len(args) > 2 else None)
    num, den = _ival(args[0]), _ival(args[1])
    if mode is None or not is_int_dtype(dt):
        out = iv.div_float(num, den)
        if mode == "floor":
            out = _floor(out)
            self.intval.add(node)
        elif mode == "trunc":
            out = Interval(_trunc(out.lo), _trunc(out.hi))
            self.intval.add(node)
        return out
    if mode == "trunc":
        out, had_zero = iv.div_int(num, den)
    else:
        out, had_zero = _floor_div_int(num, den)
    if had_zero:
        self.note_once("zero_divisor", path,
                       f"integer divisor {den!r} may contain 0 (quotient "
                       f"widened)")
    return out.meet(dtype_range(dt))


def _floor_div_int(num: Interval, den: Interval):
    """Python ``//`` (floor) on integer intervals; TOP when the divisor
    may be 0. Floor division is monotone in the numerator and, for a
    divisor of fixed sign, its extremes sit at the corners."""
    if den.lo <= 0 <= den.hi:
        return TOP, True
    cands = []
    for a in (num.lo, num.hi):
        for b in (den.lo, den.hi):
            if a in (INF, -INF) or b in (INF, -INF):
                if b in (INF, -INF):
                    cands.append(0 if a >= 0 else -1)
                else:
                    cands.append(INF if (a > 0) == (b > 0) else -INF)
            else:
                cands.append(int(a) // int(b))
    return Interval(min(cands), max(cands)), False


def _floor(x: Interval) -> Interval:
    return Interval(x.lo if x.lo in (-INF, INF) else math.floor(x.lo),
                    x.hi if x.hi in (-INF, INF) else math.floor(x.hi))


def _trunc(v):
    return v if v in (-INF, INF) else math.trunc(v)


def _t_remainder(self, node, args, kw, path):
    num, den = args[0], args[1]
    if den.lo <= 0 <= den.hi:
        self.note_once("zero_divisor", path,
                       f"remainder divisor {den!r} may contain 0")
        return dtype_range(_odtype(node))
    m = max(abs(den.lo), abs(den.hi))
    # torch.remainder takes the divisor's sign
    out = Interval(0, m) if den.lo > 0 else Interval(-m, 0)
    _mark_int(self, node, *node.args[:2])
    return out.meet(dtype_range(_odtype(node))) \
        if is_int_dtype(_odtype(node)) else out


def _t_matmul(self, node, args, kw, path):
    a, b = node.args[0], node.args[1]
    n = _shape(a)[-1] if _shape(a) else 1
    elem = _ival(args[0]) * _ival(args[1])
    out = Interval(iv._mul(elem.lo, n), iv._mul(elem.hi, n))
    dt = _odtype(node)
    if is_int_dtype(dt):
        return self.check_fit("overflow", _name(node), path, dt, out)
    if self.is_intval(a) and self.is_intval(b):
        self.intval.add(node)
        self.check_exact(_name(node), path, dt, out)
    return out


def _reduced(node, dims) -> int:
    shape = _shape(node.args[0])
    if dims is None or (isinstance(dims, list) and not dims):
        return math.prod(shape) if shape else 1
    dims = dims if isinstance(dims, (list, tuple)) else [dims]
    return math.prod(shape[int(d.lo) if isinstance(d, Interval) else d]
                     for d in dims) if shape else 1


def _t_sum(self, node, args, kw, path):
    n = _reduced(node, node.args[1] if len(node.args) > 1
                 else node.kwargs.get("dim"))
    x = args[0]
    out = Interval(iv._mul(x.lo, n), iv._mul(x.hi, n))
    _mark_int(self, node, node.args[0])
    dt = _odtype(node)
    if not is_int_dtype(dt) and self.is_intval(node.args[0]):
        self.check_exact("sum", path, dt, out)
    return self.check_fit("overflow", "sum", path, dt, out)


def _t_identity(self, node, args, kw, path):
    if node.args and isinstance(node.args[0], torch.fx.Node) \
            and self.is_intval(node.args[0]):
        self.intval.add(node)
    return args[0]


def _t_reduce_tuple(self, node, args, kw, path):
    """max.dim / min.dim / sort / topk: (values, indices)."""
    v = _meta(node)
    if isinstance(v, (list, tuple)):
        idx = v[1]
        n = _shape(node.args[0])
        return [args[0], Interval(0, max(max(n, default=1) - 1, 0))
                if isinstance(idx, torch.Tensor) else TOP]
    return args[0]


def _t_join_args(self, node, args, kw, path):
    vals = [a for a in args[0]] if isinstance(args[0], list) else [args[0]]
    ops = node.args[0] if isinstance(node.args[0], (list, tuple)) \
        else [node.args[0]]
    if all(self.is_intval(a) for a in ops):
        self.intval.add(node)
    return join_all(vals)


def _t_where(self, node, args, kw, path):
    cond, a, b = args[0], _ival(args[1]), _ival(args[2])
    if self.is_intval(node.args[1]) and self.is_intval(node.args[2]):
        self.intval.add(node)
    if isinstance(cond, Interval) and cond.is_point:
        return a if cond.lo else b
    return a.join(b)


def _t_fill_value(idx):
    def t(self, node, args, kw, path):
        val = args[idx] if len(args) > idx else kw.get("fill_value")
        v = _ival(val)
        dt = _odtype(node)
        if not (dt is not None and dt.is_floating_point) \
                or (v.is_point and v.lo == int(v.lo)):
            self.intval.add(node)
        if is_int_dtype(dt):
            return Interval(_trunc(v.lo), _trunc(v.hi))
        if dt is not None and dt.is_floating_point:
            # the value the tensor holds: rounded to its dtype (-1e30 in
            # float32 is -1.0000000150474662e30); rounding is monotone
            return Interval(*(float(torch.tensor(x, dtype=dt))
                              for x in (v.lo, v.hi)))
        return v
    return t


def _t_const(value):
    def t(self, node, args, kw, path):
        self.intval.add(node)
        return point(value)
    return t


def _t_arange(self, node, args, kw, path):
    """``arange(end)``, ``arange(start, end)``, ``arange(start, end,
    step)``: from ``start`` to its last element (the length is the
    output's)."""
    self.intval.add(node)
    nums = [a for a in node.args if isinstance(a, (int, float))]
    start = nums[0] if len(nums) >= 2 else 0
    step = nums[2] if len(nums) >= 3 else 1
    n = _shape(node)[0]
    if n == 0:
        return point(start)
    last = start + step * (n - 1)
    return Interval(min(start, last), max(start, last))


def _t_to_copy(self, node, args, kw, path):
    dt = _odtype(node)
    src = node.args[0]
    x = args[0]
    sdt = _dtype(src)
    if is_bool_dtype(dt):
        if x.is_point:
            return point(int(x.lo != 0))
        return BOOL if x.lo <= 0 <= x.hi else point(1)
    if is_int_dtype(dt):
        if sdt is not None and sdt.is_floating_point:
            x = Interval(_trunc(x.lo), _trunc(x.hi))
        return self.check_fit("narrowing", "_to_copy", path, dt, x)
    if self.is_intval(src):
        self.intval.add(node)
    return x


def _t_bitcast(self, node, args, kw, path):
    """``view(dtype)``: int32 bits read as float32. Non-negative bit
    patterns below the infinities order as their floats do."""
    dt = _odtype(node)
    sdt = _dtype(node.args[0])
    x = args[0]
    if sdt == torch.int32 and dt == torch.float32 and x.lo >= 0 \
            and x.hi < 0x7F800000:
        def f(bits):
            return struct.unpack("<f", struct.pack("<i", int(bits)))[0]
        return Interval(f(x.lo), f(x.hi))
    if dt == sdt:
        return x
    return self.unknown(node, "view.dtype")


def _t_view(self, node, args, kw, path):
    if _overload(node) == "dtype":
        return _t_bitcast(self, node, args, kw, path)
    return _t_identity(self, node, args, kw, path)


def _t_cmp(op):
    def t(self, node, args, kw, path):
        a, b = _ival(args[0]), _ival(args[1])
        if op == "eq":
            if a.is_point and b.is_point:
                return point(int(a.lo == b.lo))
            if a.hi < b.lo or b.hi < a.lo:
                return point(0)
        elif op == "ne":
            if a.is_point and b.is_point:
                return point(int(a.lo != b.lo))
            if a.hi < b.lo or b.hi < a.lo:
                return point(1)
        elif op == "lt":
            if a.hi < b.lo:
                return point(1)
            if a.lo >= b.hi:
                return point(0)
        elif op == "le":
            if a.hi <= b.lo:
                return point(1)
            if a.lo > b.hi:
                return point(0)
        elif op == "gt":
            if a.lo > b.hi:
                return point(1)
            if a.hi <= b.lo:
                return point(0)
        elif op == "ge":
            if a.lo >= b.hi:
                return point(1)
            if a.hi < b.lo:
                return point(0)
        return BOOL
    return t


def _t_and(self, node, args, kw, path):
    a, b = _ival(args[0]), _ival(args[1])
    dt = _odtype(node)
    if not is_bool_dtype(dt):
        if a.lo >= 0 and b.lo >= 0:
            return Interval(0, min(a.hi, b.hi))
        return dtype_range(dt)
    if (a.is_point and a.lo == 0) or (b.is_point and b.lo == 0):
        return point(0)
    if a.is_point and b.is_point:
        return point(int(bool(a.lo) and bool(b.lo)))
    return BOOL


def _t_frexp(self, node, args, kw, path):
    """``(mantissa, exponent)`` with ``x = m·2^e``: for ``x >= 1`` (or
    ``x <= -1``) the exponent is monotone in ``|x|``."""
    x = _ival(args[0])
    if x.lo >= 1 or x.hi <= -1:
        lo, hi = sorted((abs(x.lo), abs(x.hi)))
        e_lo = math.frexp(lo)[1] if lo != INF else 1025
        e_hi = math.frexp(hi)[1] if hi != INF else 1025
        ex = Interval(e_lo, e_hi)
    else:
        ex = Interval(-1074, 1025)
    return [Interval(-1.0, 1.0), ex]


def _t_rshift(self, node, args, kw, path):
    dt = _odtype(node)
    sh = _ival(args[1])
    self.check_shift("__rshift__", path, dt, sh)
    bits = dtype_bits(dt) or 32
    sh = sh.meet(Interval(0, bits - 1))
    self.intval.add(node)
    return iv.shift_right_arith(_ival(args[0]), sh)


def _t_lshift(self, node, args, kw, path):
    dt = _odtype(node)
    sh = _ival(args[1])
    self.check_shift("__lshift__", path, dt, sh)
    out = iv.shift_left(_ival(args[0]), sh.meet(
        Interval(0, max((dtype_bits(dt) or 32) - 1, 0))))
    self.intval.add(node)
    return self.check_fit("overflow", "__lshift__", path, dt, out)


def _t_round(self, node, args, kw, path):
    x = args[0]
    self.intval.add(node)
    if kw.get("decimals"):
        return x
    lo = x.lo if x.lo in (-INF, INF) else float(round(x.lo))
    hi = x.hi if x.hi in (-INF, INF) else float(round(x.hi))
    return Interval(lo, hi)


def _t_floor(self, node, args, kw, path):
    self.intval.add(node)
    return _floor(args[0])


def _t_exp(self, node, args, kw, path):
    x = args[0]
    lo = 0.0 if x.lo == -INF else (INF if x.lo > 700 else math.exp(x.lo))
    hi = INF if x.hi > 700 or x.hi == INF else math.exp(x.hi)
    return Interval(lo, hi)


_IDENTITY = ("_unsafe_view", "expand", "permute", "transpose", "unsqueeze",
             "slice", "select", "clone", "alias", "detach", "repeat",
             "index", "amax")

_TRANSFER = {name: _t_identity for name in _IDENTITY}
_TRANSFER.update({
    "view": _t_view, "min": _t_reduce_tuple, "max": _t_reduce_tuple,
    "add": _t_add, "sub": _t_sub, "rsub": _t_rsub, "mul": _t_mul,
    "maximum": _t_maximum, "clamp": _t_clamp,
    "div": _t_div, "floor_divide": _t_div, "remainder": _t_remainder,
    "mm": _t_matmul, "bmm": _t_matmul, "sum": _t_sum,
    "stack": _t_join_args, "where": _t_where,
    "full": _t_fill_value(1), "full_like": _t_fill_value(1),
    "scalar_tensor": _t_fill_value(0),
    "zeros": _t_const(0), "ones": _t_const(1), "ones_like": _t_const(1),
    "arange": _t_arange, "_to_copy": _t_to_copy,
    "ge": _t_cmp("ge"), "lt": _t_cmp("lt"), "ne": _t_cmp("ne"),
    "bitwise_and": _t_and, "frexp": _t_frexp,
    "__rshift__": _t_rshift, "__lshift__": _t_lshift,
    "round": _t_round, "floor": _t_floor, "exp": _t_exp,
})


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------

def analyze_graph(gm: torch.fx.GraphModule, seeds) -> AnalysisResult:
    """Run the interval interpreter over ``gm`` (an aten-level graph from
    ``make_fx``) with one seed interval per input (``None``: the input's
    dtype range)."""
    interp = Interp(gm)
    outvals = interp.run(list(seeds))
    intervals = {n.name: v for n, v in interp.env.items()
                 if isinstance(v, Interval)
                 and isinstance(_meta(n), torch.Tensor)}
    return AnalysisResult(findings=interp.findings, notes=interp.notes,
                          records=interp.records, outvals=outvals,
                          intervals=intervals,
                          intvals=frozenset(n.name for n in interp.intval))
