"""Operation and byte counts of one eager step of the port
(``repro.roofline.hlo_costs``, rewritten for PyTorch).

The reference reads its costs from compiled HLO text. The port counts
what one step runs:

- ``OpCounter``, a ``TorchDispatchMode``, sums every aten matmul
  (``mm``, ``addmm``, ``bmm``, ``baddbmm``, ``_int_mm``, ``dot``, ``mv``,
  and ``matmul`` and ``linear``, which reach the mode undecomposed under
  ``torch.inference_mode``):
  ``2·M·N·K`` FLOPs, split by operand dtype (int8, bf16/fp16, float32 and
  float64), and its operand and result bytes, the reference's HBM proxy.
  Within one call of ``models.layers.linear`` or of the MoE expert FFN an
  operand is charged once: their 128-row blocks read the same weight,
  which the reference's single ``x @ w`` charges once.
  Each matmul is filed under a family: ``attention`` (inside the
  attention engine's ``dispatch``), ``experts`` (the MoE expert FFN),
  ``dense`` (``linear`` and every other matmul of a forward: router,
  unembedding), or, in an autograd backward, ``dense`` for the backward
  of ``linear`` and ``other`` for the rest.
- The nine kernels are counted by one formula of each call's shapes and
  masks (``attention_work``, ``twopass_work``, ``softmax_work``,
  ``matmul_work``, ``ws_work``): each input read once (only the K/V
  prefix the masks reach), each output written once, and the integer
  operations of the visible work. It does not matter which implementation
  runs, the CUDA kernel or, on the CPU, its plain version: the aten ops
  inside a counted kernel call are not counted again.

- Collectives (``torch.ops._c10d_functional``: all-gather,
  reduce-scatter, all-reduce, all-to-all, the ops of ``launch.hints``
  and of DTensor's redistributions) are counted by kind: calls and
  operand bytes, the reference's collective term.

The kernels and scopes are seen through ``core.cost_hook``: the counter
is the hook while it counts, and every wrapper and scope is decorated
with ``counted``, so no call site escapes it.

On the meta device (the dry-run) the masks hold no values: a call's
work is counted for the cell's full context, every row attending a
K/V of the call's full length (causal rows at the end of it); and the
streaming attention's chunk loop and RWKV6's token scan are counted by
formula (``streaming_work``, ``wkv_work``: their products in float32, as
the CPU and the card run them).

A CUDA-graph replay runs no Python and records nothing, so the counter
counts a step run once eagerly; it refuses to run while a graph is
captured. The formulas read the masks' extent back to the host
(``.item()``), which is fine in an eager step.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.core import cost_hook
from repro_torch.models.layers import ROW_BLOCK
from repro_torch.roofline.analysis import Roofline, lookup_term, matmul_term

_aten = torch.ops.aten
# matmul overload packet -> indices of its (lhs, rhs) operands
_MATMULS = {
    _aten.mm: (0, 1), _aten.bmm: (0, 1), _aten._int_mm: (0, 1),
    _aten.addmm: (1, 2), _aten.baddbmm: (1, 2), _aten.dot: (0, 1),
    _aten.mv: (0, 1), _aten.matmul: (0, 1), _aten.linear: (0, 1),
}
_c10d = torch.ops._c10d_functional
COLLECTIVES = {_c10d.all_gather_into_tensor: "all-gather",
               _c10d.reduce_scatter_tensor: "reduce-scatter",
               _c10d.all_reduce: "all-reduce",
               _c10d.all_to_all_single: "all-to-all"}
PAGED = ("ita_attention_onepass_paged", "ita_attention_decode_paged")
# attention wrapper of ``kernels.ita_attention.ops`` -> counted kernel
_ATTENTION = ("ita_attention_onepass", "ita_attention_decode",
              "ita_attention_onepass_paged", "ita_attention_decode_paged")
TWOPASS = ("ita_attention_twopass_qk_da", "ita_attention_twopass_av_en")
KERNELS = _ATTENTION + TWOPASS + ("ita_softmax", "int8_matmul",
                                  "int8_matmul_ws")


# ---------------------------------------------------------------------------
# The kernels' work: one formula of each call's shapes and masks
# ---------------------------------------------------------------------------

def visible_work(args, kw):
    """``(pairs, kv_tokens, meta)`` of a ring call: the visible (query,
    key) pairs and the K/V tokens the rows' masks reach (per kv row, the
    largest visible key + 1)."""
    from repro_torch.kernels.common import tile_mask
    from repro_torch.kernels.ita_attention import kernel as K
    q, k = args[:2]
    bh, sq, _ = q.shape
    if q.device.type == "meta":
        return _full_context_work(bh, sq, k.shape[1], kw)
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


def _full_context_work(bh, sq, skv, kw):
    """``visible_work`` of a meta call: each row's queries the last
    ``sq`` positions of a full ``skv`` context when causal (window
    ``kw["window"]``), every key otherwise."""
    import numpy as np
    causal, window = kw.get("causal", True), kw.get("window", 0)
    if causal:
        pos = skv - sq + np.arange(sq)
        lo = np.maximum(0, pos - window + 1) if window else 0
        per_row = int((pos - lo + 1).sum())
    else:
        per_row = sq * skv
    rep = kw.get("kv_rep", 1)
    return bh * per_row, bh // rep * skv, torch.empty((bh, 3),
                                                      device="meta")


def attention_work(name, args, kw):
    """``(bytes, int8 ops)`` of a ring or paged attention call: each input
    read once (only the K/V prefix the rows' masks can reach; for a paged
    call also its page table), the output written once, against the
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
    return nbytes, 4 * pairs * d


def twopass_work(args, kw):
    """``((bytes, ops) of pass 1, (bytes, ops) of pass 2)`` of a twopass
    call. Pass 1 reads Q and all of K (A holds the logit of every pair,
    masked ones included), the multipliers and meta, and writes all of A
    and three int32 statistics per query row; its ops are Q·Kᵀ at every
    pair (2 per head-dim element). Pass 2 reads A only at the visible
    pairs (p is 0 elsewhere, whatever A holds), the statistics, the V
    prefix the masks reach, the multipliers and meta, and writes out;
    its ops are p·V at the visible pairs (2 per pair and head-dim
    element)."""
    q, k = args[:2]
    bh, sq, d = q.shape
    skv = k.shape[1]
    pairs, kv_tokens, meta = visible_work(args, kw)
    stats, small = 3 * bh * sq * 4, meta.numel() * 4 + bh * 4
    return ((q.numel() + k.numel() + bh * sq * skv + stats + small,
             2 * bh * sq * skv * d),
            (pairs + stats + kv_tokens * d + small + bh * sq * d,
             2 * pairs * d))


def softmax_work(x, mask):
    """``(bytes, ops)`` of a standalone softmax call: x read only where
    the mask is set (a masked element's output is 0 whatever x holds),
    the mask read and the f32 output written at every element; ~10
    integer ops (DA and EN) per unmasked element."""
    live = mask.numel() if mask.device.type == "meta" \
        else int((mask != 0).sum().item())
    return live + mask.numel() + x.numel() * 4, 10 * live


def streaming_work(q, k, steps, cq, ckv, passes=1):
    """``(FLOPs, bytes)`` of ``steps`` chunk pairs of the streaming
    attention, ``passes`` times: per pair a Q·Kᵀ and a weights·V product
    of ``cq`` queries by ``ckv`` keys over every head, their float32
    operands and results charged once."""
    b, _, h, hd = q.shape
    g = k.shape[2]
    flops = 4 * b * h * cq * ckv * hd
    nbytes = 4 * (2 * b * h * cq * hd + 2 * b * g * ckv * hd
                  + 2 * b * h * cq * ckv)
    return steps * passes * flops, steps * passes * nbytes


def wkv_work(r, s0, passes=1):
    """``(FLOPs, bytes)`` of RWKV6's WKV scan over ``T`` tokens,
    ``passes`` times: per token the (1, dh) · (dh, dh) product of every
    head, its float32 operands and result charged once."""
    b, t, h, dh = r.shape
    return (passes * t * 2 * b * h * dh * dh,
            passes * t * 4 * (2 * b * h * dh + b * h * dh * dh))


# a meta call's scope (``core.cost_hook`` name) -> (family, its work)
_META_WORK = {"streaming_attention": ("attention", streaming_work),
              "wkv_scan": ("dense", wkv_work)}


def matmul_work(m, k, n):
    """``(bytes, ops)`` of one B7a call: x, w, bias and mult read once,
    out written once, against 2 operations per multiply-add."""
    return m * k + k * n + 8 * n + m * n, 2 * m * n * k


def ws_work(m, k, n, block_k=128):
    """``(bytes, ops)`` of one B7b call, from the call's own M, K and N:
    x, w, bias and mult read once, the int32 partial sums read and
    written once per k tile (the schedule's 2·4·M·N·K/block_k bytes), out
    written once, against 2 operations per multiply-add. The reference
    reads each weight tile once; the kernel's re-reads of w (once per m
    range) are its own design's cost."""
    nbytes = m * k + k * n + 8 * n + 2 * 4 * m * n * -(-k // block_k) \
        + m * n
    return nbytes, 2 * m * n * k


# ---------------------------------------------------------------------------
# The counter
# ---------------------------------------------------------------------------

def _dtype_class(dtype) -> str:
    if dtype in (torch.int8, torch.uint8):
        return "int8"
    if dtype in (torch.float32, torch.float64):
        return "fp32"
    return "bf16"


def _matmul_flops(func, args, out) -> float:
    a = args[_MATMULS[func.overloadpacket][0]]
    k = a.shape[-1]
    return 2.0 * out.numel() * k


@dataclasses.dataclass
class Costs:
    """What one counted step ran."""

    flops: dict = dataclasses.field(default_factory=dict)   # family -> FLOPs
    flops_by_dtype: dict = dataclasses.field(
        default_factory=lambda: {"int8": 0.0, "bf16": 0.0, "fp32": 0.0})
    matmul_bytes: float = 0.0
    matmuls: int = 0
    kernel_ops: dict = dataclasses.field(default_factory=dict)
    kernel_bytes: dict = dataclasses.field(default_factory=dict)
    kernel_calls: dict = dataclasses.field(default_factory=dict)
    coll_bytes: dict = dataclasses.field(default_factory=dict)  # kind ->
    coll_calls: dict = dataclasses.field(default_factory=dict)

    @property
    def matmul_flops(self) -> float:
        return sum(self.flops.values())

    def roofline(self, model_flops_: float, chips: int = 1) -> Roofline:
        ops = sum(self.kernel_ops.values())
        return Roofline(
            flops=self.matmul_flops + ops,
            hbm_bytes=self.matmul_bytes + sum(self.kernel_bytes.values()),
            coll_bytes=float(sum(self.coll_bytes.values())),
            model_flops=model_flops_, chips=chips,
            flops_int8=self.flops_by_dtype["int8"] + ops,
            flops_fp32=self.flops_by_dtype["fp32"])


def _operand_key(t):
    """What makes two operands the same read: the same bytes of the same
    storage, seen through the same view."""
    return (t.untyped_storage().data_ptr(), t.storage_offset(),
            tuple(t.shape), tuple(t.stride()), t.dtype)


class _Scope:
    """A counted program scope: its family and, for ``linear`` and the
    expert FFN, the operands it has charged (each read once a call)."""

    def __init__(self, family, once):
        self.family = family
        self.seen = set() if once else None


# counted scope (``core.cost_hook`` name) -> (family, operands read once)
_SCOPES = {"linear": ("dense", True), "experts": ("experts", True),
           "attention": ("attention", False)}


def _matmul_work(m, k):
    return [("int8_matmul_ws",
             ws_work(*m, min(k.get("block_k", 128), m[1])))
            if k.get("schedule", "tpu") == "weight_stationary"
            else ("int8_matmul", matmul_work(*m))]


# kernel wrapper (``core.cost_hook`` name) -> its work, ``[(kernel,
# (bytes, ops)), ...]``, from the wrapper's arguments
_WORK = {
    **{name: (lambda a, k, name=name: [(name, attention_work(name, a, k))])
       for name in _ATTENTION},
    "ita_attention_twopass": lambda a, k: list(
        zip(TWOPASS, twopass_work(a, k), strict=True)),
    "ita_softmax": lambda a, k: [("ita_softmax", softmax_work(a[0], a[1]))],
    "int8_matmul": lambda a, k: _matmul_work(
        (a[0].shape[0], a[0].shape[1], a[1].shape[1]), k),
}


class OpCounter(TorchDispatchMode):
    """Counts the matmuls a step runs under it, and, as the cost hook
    (``core.cost_hook``), the kernels and the scopes (see the module
    docstring). Use ``counting()``."""

    def __init__(self, costs: Costs):
        super().__init__()
        self.costs = costs
        self.scopes: list[_Scope] = []
        self.inside_kernel = 0

    def family(self) -> str:
        if self.scopes:
            return self.scopes[-1].family
        if torch._C._current_graph_task_id() != -1:        # a backward
            node = torch._C._current_autograd_node()
            name = node.name() if node is not None else ""
            return "dense" if name.startswith("_LinearBackward") \
                else "other"
        return "dense"

    def _charged(self, t) -> int:
        """``t``'s bytes, or 0 if the innermost read-once scope has
        charged the same operand."""
        seen = next((s.seen for s in reversed(self.scopes)
                     if s.seen is not None), None)
        if seen is not None:
            key = _operand_key(t)
            if key in seen:
                return 0
            seen.add(key)
        return t.numel() * t.element_size()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        c = self.costs
        kind = COLLECTIVES.get(func.overloadpacket)
        if kind is not None:
            x = args[0]
            c.coll_bytes[kind] = c.coll_bytes.get(kind, 0) \
                + x.numel() * x.element_size()
            c.coll_calls[kind] = c.coll_calls.get(kind, 0) + 1
            return out
        if self.inside_kernel or func.overloadpacket not in _MATMULS:
            return out
        flops = _matmul_flops(func, args, out)
        fam = self.family()
        c.flops[fam] = c.flops.get(fam, 0.0) + flops
        lhs, rhs = (args[i] for i in _MATMULS[func.overloadpacket])
        c.flops_by_dtype[_dtype_class(lhs.dtype)] += flops
        c.matmul_bytes += self._charged(lhs) + self._charged(rhs) \
            + out.numel() * out.element_size()
        c.matmuls += 1
        return out

    def __call__(self, name, fn, args, kw):
        """The cost hook: a kernel wrapper's call counted by its formula
        (computed before the call, with the matmul count off, and the
        aten ops inside the call not counted), or a scope's call run
        inside that scope."""
        c = self.costs
        if name in _META_WORK:                       # a meta call
            family, work = _META_WORK[name]
            flops, nbytes = work(*args, **kw)
            c.flops[family] = c.flops.get(family, 0.0) + flops
            c.flops_by_dtype["fp32"] += flops
            c.matmul_bytes += nbytes
            return fn(*args, **kw)
        if name in _SCOPES:
            self.scopes.append(_Scope(*_SCOPES[name]))
            try:
                return fn(*args, **kw)
            finally:
                self.scopes.pop()
        self.inside_kernel += 1
        try:
            done = _WORK[name](args, kw)
            out = fn(*args, **kw)
        finally:
            self.inside_kernel -= 1
        for kname, (nbytes, ops) in done:
            c.kernel_ops[kname] = c.kernel_ops.get(kname, 0) + ops
            c.kernel_bytes[kname] = c.kernel_bytes.get(kname, 0) + nbytes
            c.kernel_calls[kname] = c.kernel_calls.get(kname, 0) + 1
        return out


@contextlib.contextmanager
def counting():
    """Count what runs inside the ``with`` block: yields a ``Costs``
    filled as the block runs. The block must run eagerly (no CUDA-graph
    capture or replay counts anything)."""
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        raise RuntimeError("op_costs counts an eager step, not a capture")
    costs = Costs()
    mode = OpCounter(costs)
    cost_hook.set_hook(mode)
    try:
        with mode:
            yield costs
    finally:
        cost_hook.set_hook(None)


# ---------------------------------------------------------------------------
# What the port's matmuls should count, from the config
# ---------------------------------------------------------------------------

def padded_rows(rows: int) -> int:
    """Rows a ``linear`` call computes: whole ``ROW_BLOCK`` blocks."""
    return -(-rows // ROW_BLOCK) * ROW_BLOCK


def expert_term(cfg, shape) -> float:
    """The active experts' share of ``matmul_term`` (0 without MoE)."""
    if cfg.mlp_type != "moe":
        return 0.0
    layers = sum(len(p) * n for p, n in cfg.layer_groups)
    tokens = shape.global_batch * (1 if shape.kind == "decode"
                                   else shape.seq_len)
    return (3 if shape.kind == "train" else 1) * 2 * 3 * cfg.d_model \
        * cfg.d_ff * cfg.n_experts_active * tokens * layers


def expected_flops(cfg, shape) -> dict:
    """``{"dense": ..., "experts": ...}``: the FLOPs the port's matmuls
    compute outside the attention for one step of ``shape``, derived from
    ``model_flops``'s matmul term. Three differences from the analytic
    term: (1) an untied embedding is a lookup, no matmul
    (``lookup_term``); (2) ``linear`` computes whole 128-row blocks, so a
    forward over ``t`` tokens computes ``padded_rows(t)`` rows (the
    backward of a train step takes all rows in one product); (3) the MoE
    expert FFN runs every expert over a capacity buffer of whole 128-row
    blocks (``models.moe.dispatch``); with ``cfg.remat`` under
    ``remat_policy="full"`` a train step recomputes every block's forward
    in its backward, under ``"dots"`` it keeps the forward's ``mm``
    outputs (``models.transformer.DOTS_SAVED``) and recomputes none of
    these products: only the attention and the elementwise work are
    redone, and a product served from the checkpoint's cache never
    reaches the counter. Decoders of ``attn``, ``local`` and ``swa``
    blocks; a train step of a dense one with one cross-entropy chunk."""
    from repro_torch.models.moe import capacity
    from repro_torch.roofline.analysis import param_counts
    kinds = {k for p, _ in cfg.layer_groups for k in p}
    if not kinds <= {"attn", "local", "swa"} or cfg.n_encoder_layers:
        raise ValueError(f"expected_flops covers decoder blocks only, "
                         f"not {sorted(kinds)}")
    if shape.kind == "train" and (cfg.mlp_type == "moe"
                                  or cfg.ce_chunks > 1):
        raise ValueError("expected_flops covers the train step of a dense "
                         "decoder with one cross-entropy chunk only")
    t = shape.global_batch * (1 if shape.kind == "decode" else shape.seq_len)
    pad = padded_rows(t) / t
    experts = expert_term(cfg, shape)
    rest = matmul_term(cfg, shape) - lookup_term(cfg, shape) - experts
    if shape.kind != "train":
        dense = rest * pad
    else:
        # the forward at padded rows, the backward's two products over
        # the t rows, and with full remat every block's forward once more
        dense = rest / 3 * (pad + 2)
        if cfg.remat and cfg.remat_policy == "full":
            dense += 2 * param_counts(cfg)["backbone_active"] \
                * padded_rows(t)
    if experts:
        cap = capacity(t, cfg.n_experts_active, cfg.n_experts)
        rows = padded_rows(min(cap, t)) * cfg.n_experts
        experts *= rows / (cfg.n_experts_active * t)
    return {"dense": dense, "experts": experts}
