"""Mixture-of-experts layer (``repro.models.moe``): OLMoE's 64 experts
top-8 and Mixtral's 8 experts top-2.

    moe = MoE(cfg, device=dev)
    y = moe(x)                          # x (B, S, d) -> (B, S, d)

GShard-style grouped sort-based capacity dispatch: the call's ``T =
B·S`` tokens are cut into ``G = hints.num_data_shards()`` groups of
``t = T / G`` consecutive tokens (one per data shard under a mesh; 1
without one, or when ``G`` does not divide ``T``), and all routing runs
inside a group: the router product and softmax in float32, top-k, a
stable argsort of the chosen experts, each assignment's rank within its
expert (``searchsorted``), and a keep mask ``rank < cap``. A group of
``t`` tokens (padding rows and dead decode slots included) has ``cap =
t·k`` when ``t·k <= 4096``: nothing drops, so a token's output does not
depend on the other tokens of its call. Above that ``cap =
min(max(int(1.25·t·k/E), 1), t·k)`` and the assignments past an
expert's capacity drop (combine weight 0, GShard semantics).

Under a mesh a rank holds its batch chunk, the groups of its own rows,
and routes them whole on every rank of ``model``; a group larger than
the chunk (``G`` fell back to 1) is gathered over the data axes, routed
whole on every rank, and each rank keeps its own rows of the output. With the experts over
``model`` (expert parallelism, when ``model`` divides E) the capacity
buffer is cut to this rank's experts (the reference's ``experts``
constraint) and the experts' outputs are gathered back over ``model``
before the combine: the group is whole on every rank of ``model``, so
the reference's group-to-expert exchange is a slice one way and an
all-gather the other. When ``model`` does not divide E, every expert's
FFN is split over ``ff`` instead and its product all-reduced.

The bits of a token must not depend on its call either (a served
request meets its prompt in chunks beside other requests, and its tokens
must equal ``generate()`` of the request alone). So the router product
and softmax run in the fixed row blocks of ``models.layers``, and the
expert FFN runs over a capacity buffer laid out in blocks of exactly
``ROW_BLOCK`` rows per expert, ``(n_blocks, E, 128, d)``: every block is
one ``torch.bmm`` of the same shape ``(E, 128, d) @ (E, d, f)``, the last
block zero-padded, so a row's result does not depend on the rows beside
it or on the block that holds it. The buffer is filled by a gather, not a
scatter, and the combine sums a token's ``k`` weighted expert outputs in
a fixed order (ascending expert id, from zero, as the reference's
scatter-add meets them), never with atomics, so every call gives the same
bits. Ties in the top-k go to the lower expert id, as ``lax.top_k``
breaks them: the top-k is a stable descending sort.

Nothing here reads a value back to the host, and every shape is static
(``cap`` is a Python integer of the call's shape), so a captured serve or
decode step replays the routing with the rest of the step.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.cost_hook import counted
from repro_torch.launch import hints
from repro_torch.models.layers import ROW_BLOCK, in_row_blocks, normal_param

CAPACITY_FACTOR = 1.25
EXACT_LIMIT = 4096          # t·k up to this: exact capacity, no drops


def capacity(t: int, k: int, e: int) -> int:
    """Slots per expert for a call of ``t`` tokens (``apply_moe``'s cap)."""
    if t * k <= EXACT_LIMIT:
        return t * k
    return min(max(int(CAPACITY_FACTOR * t * k / e), 1), t * k)


class MoE(nn.Module):
    """``router`` (d, E) float32 holding ``param_dtype``-rounded values
    (the reference multiplies float32 activations by it); the experts'
    ``w_gate``/``w_up`` (E, d, f) and ``w_down`` (E, f, d) in the compute
    dtype."""

    def __init__(self, cfg, *, device, generator=None):
        super().__init__()
        e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
        self.k = cfg.n_experts_active
        kw = dict(device=device, generator=generator,
                  param_dtype=cfg.param_torch_dtype())
        self.router = normal_param((d, e), d ** -0.5, dtype=torch.float32,
                                   **kw)
        dt = cfg.compute_dtype()
        self.w_gate = normal_param((e, d, f), d ** -0.5, dtype=dt, **kw)
        self.w_up = normal_param((e, d, f), d ** -0.5, dtype=dt, **kw)
        self.w_down = normal_param((e, f, d), f ** -0.5, dtype=dt, **kw)

    def forward(self, x):
        return apply_moe(x, self.router, self.w_gate, self.w_up,
                         self.w_down, self.k)


@dataclasses.dataclass(frozen=True)
class Routing:
    """One call's routing, in the reference's terms: ``top_w``/``top_i``
    (t, k) per token (weights normalized); over the ``t·k`` assignments
    sorted by expert, ``order`` (the sort), ``slot`` (``e·cap + rank``,
    ``E·cap`` where dropped), ``keep`` and ``src_tok``; ``starts`` (E,)
    each expert's first sorted assignment; ``cap``."""

    top_w: torch.Tensor
    top_i: torch.Tensor
    order: torch.Tensor
    slot: torch.Tensor
    keep: torch.Tensor
    src_tok: torch.Tensor
    starts: torch.Tensor
    cap: int


def router_probs(x2, router):
    """Softmax over the experts of ``x2 (t, d) @ router`` in float32, in
    fixed row blocks."""
    return in_row_blocks(
        x2, lambda rows: torch.softmax(rows.float() @ router, dim=-1))


def top_k(probs, k):
    """``lax.top_k``: the k largest per row, ties to the lower index."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def route(probs, k: int, cap: int) -> Routing:
    """``_dispatch_group``'s routing of ``probs (t, E)``."""
    t, e = probs.shape
    top_w, top_i = top_k(probs, k)
    total = top_w[:, 0]
    for j in range(1, k):               # a fixed order, row by row
        total = total + top_w[:, j]
    top_w = top_w / torch.clamp(total, min=1e-9)[:, None]
    e_flat = top_i.reshape(-1)
    order = torch.argsort(e_flat, stable=True)
    se = e_flat[order]
    starts = torch.searchsorted(se, torch.arange(e, dtype=se.dtype,
                                                 device=se.device))
    pos = torch.arange(t * k, device=se.device) - starts[se]
    keep = pos < cap
    slot = torch.where(keep, se * cap + pos, e * cap)
    return Routing(top_w=top_w, top_i=top_i, order=order, slot=slot,
                   keep=keep, src_tok=order // k, starts=starts, cap=cap)


def dispatch(x2, r: Routing) -> torch.Tensor:
    """The capacity buffer in row blocks, ``(n_blocks, E, ROW_BLOCK, d)``:
    capacity row ``c`` of expert ``e`` is row ``c % ROW_BLOCK`` of block
    ``c // ROW_BLOCK`` and holds the token of the expert's ``c``-th
    sorted assignment (zeros past the expert's count or ``cap``). A
    token's ``k`` experts are distinct, so no expert takes more than the
    call's ``t`` tokens: the blocks cover ``min(cap, t)`` rows, not
    ``cap``."""
    t, d = x2.shape
    tk = r.order.shape[0]
    e = r.starts.shape[0]
    nb = -(-min(r.cap, t) // ROW_BLOCK)
    dev = x2.device
    ends = torch.cat([r.starts[1:],
                      torch.full((1,), tk, dtype=r.starts.dtype, device=dev)])
    c = torch.arange(nb * ROW_BLOCK, device=dev)
    j = r.starts[:, None] + c[None, :]                       # (E, nb·128)
    valid = (j < ends[:, None]) & (c[None, :] < r.cap)
    tok = r.src_tok[torch.clamp(j, max=tk - 1)]
    tok = tok.view(e, nb, ROW_BLOCK).transpose(0, 1)          # (nb, E, 128)
    valid = valid.view(e, nb, ROW_BLOCK).transpose(0, 1)
    rows = x2[tok.reshape(-1)].view(nb, e, ROW_BLOCK, d)
    return torch.where(valid[..., None], rows, rows.new_zeros(()))


@counted("experts")
def expert_ffn(buf, w_gate, w_up, w_down):
    """SwiGLU of every expert over the blocked buffer: one
    ``(E, 128, d) @ (E, d, f)`` ``torch.bmm`` shape for every block."""
    dt = buf.dtype
    wg, wu, wd = w_gate.to(dt), w_up.to(dt), w_down.to(dt)
    if buf.device.type == "meta":       # shapes only: the blocks as one
        nb, e, r, d = buf.shape
        blk = buf.transpose(0, 1).reshape(e, nb * r, d)
        y = torch.bmm(F.silu(torch.bmm(blk, wg)) * torch.bmm(blk, wu), wd)
        return y.view(e, nb, r, -1).transpose(0, 1)
    out = torch.empty_like(buf)
    for i in range(buf.shape[0]):
        blk = buf[i]
        h = F.silu(torch.bmm(blk, wg)) * torch.bmm(blk, wu)
        out[i] = torch.bmm(h, wd)
    return out


def combine(y_buf, r: Routing, t: int, dtype) -> torch.Tensor:
    """``_combine_group``: each token's kept expert outputs times their
    weights, summed in ``dtype`` from zero in ascending expert id."""
    nb, e, _, d = y_buf.shape
    tk = r.order.shape[0]
    k = tk // t
    dev = y_buf.device
    inv = torch.empty_like(r.order)
    inv[r.order] = torch.arange(tk, device=dev)
    slot, keep = r.slot[inv], r.keep[inv]          # per (token, choice)
    ex = torch.clamp(slot // r.cap, max=e - 1)
    c = slot % r.cap
    flat = (c // ROW_BLOCK) * (e * ROW_BLOCK) + ex * ROW_BLOCK \
        + c % ROW_BLOCK
    got = y_buf.reshape(-1, d)[flat]
    got = torch.where(keep[:, None], got, got.new_zeros(()))
    contrib = (got * r.top_w.reshape(-1).to(dtype)[:, None]).view(t, k, d)
    rank = torch.argsort(r.top_i, dim=-1)          # distinct ids per token
    contrib = torch.gather(contrib, 1, rank[..., None].expand(t, k, d))
    out = torch.zeros((t, d), dtype=dtype, device=dev)
    for j in range(k):
        out = out + contrib[:, j]
    return out


def groups(t_local: int) -> tuple:
    """``(G, t)``: the global group count and tokens per group of a call
    of ``t_local`` tokens on this rank (its chunk of the batch)."""
    total = t_local * hints.batch_ranks()
    g = hints.num_data_shards()
    if total % g or total // g < 1:
        g = 1
    return g, total // g


def _experts(buf, w_gate, w_up, w_down):
    """The expert FFN over ``buf`` under the mesh's layout of the experts
    (module docstring)."""
    tp = hints.tp_dim(w_gate)
    if tp is None:
        return expert_ffn(buf, w_gate, w_up, w_down)
    if tp == 0:                         # experts over model
        local = hints.constrain(buf, None, "experts", None, None)
        return hints.gather_tp(expert_ffn(local, w_gate, w_up, w_down), 1)
    return hints.constrain(expert_ffn(hints.to_tp(buf), w_gate, w_up,
                                      w_down), partial=True)


def apply_moe(x, router, w_gate, w_up, w_down, k: int):
    """x (B, S, d) -> (B, S, d) (``repro.models.moe.apply_moe``)."""
    b, s, d = x.shape
    e = router.shape[1]
    x2 = x.reshape(b * s, d)
    _, t = groups(b * s)
    whole = t > b * s                   # the group spans the data ranks
    if whole:
        x2 = hints.gather_batch(x2)
    cap = capacity(t, k, e)
    outs = []
    for i in range(0, x2.shape[0], t):  # this rank's groups
        xg = x2[i:i + t]
        r = route(router_probs(xg, router), k, cap)
        y_buf = _experts(dispatch(xg, r), w_gate, w_up, w_down)
        outs.append(combine(y_buf, r, t, x.dtype))
    out = outs[0] if len(outs) == 1 else torch.cat(outs)
    if whole:
        out = hints.local_rows(out)
    return out.view(b, s, d)


def moe_aux_loss(x, router, k: int):
    """Switch-Transformer load-balance loss ``E · Σ_e f_e · p_e`` (float32
    0-d): ``f_e`` the share of top-k choices, ``p_e`` the mean router
    probability of expert ``e``."""
    e = router.shape[1]
    probs = torch.softmax(x.reshape(-1, x.shape[-1]).float() @ router,
                          dim=-1)
    _, top_i = top_k(probs, k)
    if hints.batch_ranks() == 1:
        frac = F.one_hot(top_i, e).float().mean(dim=(0, 1))
        return e * torch.sum(frac * probs.mean(0))
    # under a mesh: both means over the global batch
    n = probs.shape[0] * hints.batch_ranks()
    frac = hints.batch_sum(F.one_hot(top_i, e).float().sum(dim=(0, 1))) \
        / (n * k)
    return e * torch.sum(frac * (hints.batch_sum(probs.sum(0)) / n))
