"""Logical sharding hints for model code (``repro.launch.hints``), and
the collectives of their sites.

Model code never names mesh axes; it asks for roles (``batch``, ``seq``,
``heads``, ``kv_heads``, ``ff``, ``vocab``, ``experts``). The launcher
installs the mesh (``use_hints``); without one every hint is a no-op and
every collective here returns its input, so single-device runs are
untouched. Divisibility is checked per call, as in the reference.

The port runs the model on local shards (``launch.steps`` unwraps the
DTensors once), so a hint is where data moves:

- Activations are laid out one way between the sites: the batch split
  over the data axes by the step (over every axis under ``fsdp``), the
  rest whole on each rank of ``model``. The reference's ``seq`` role,
  its sequence parallelism, moves nothing here: the port keeps each
  sequence whole and runs attention whole where the heads do not divide.
- ``constrain(x, ..., "heads", ...)`` cuts this rank's slice of a dim
  that is whole on every rank of ``model`` (tensor parallelism: its
  gradient is gathered back in the backward); ``partial=True`` marks a
  row-parallel product, all-reduced over ``model`` here.
- ``to_tp`` marks an activation that feeds this rank's own weight
  columns: nothing in the forward, an all-reduce of its gradient over
  ``model`` in the backward (Megatron's *f*; ``reduce_tp`` is its *g*).
- ``gathered(module)`` swaps a module's local parameter shards for
  their gathered values for the duration of a call: an all-gather over
  each sharded axis but the one tensor parallelism keeps (ZeRO-3, per
  layer), whose backward reduce-scatters the gradient over the data
  axes and cuts the rank's chunk over ``model``.

Collectives are ``torch.ops._c10d_functional`` ops on the mesh's
groups (NCCL on the card, gloo on the CPU, the fake group of the
dry-run), which ``roofline.op_costs`` counts by kind and bytes. An axis
of size 1 moves nothing and runs no op.
"""

from __future__ import annotations

import contextlib
import threading

import torch

from repro_torch.launch.mesh import axis_size, axis_sizes, batch_axes

_STATE = threading.local()
_C = None


def _ops():
    global _C
    if _C is None:
        _C = torch.ops._c10d_functional
    return _C


def _mesh():
    return getattr(_STATE, "mesh", None)


def _mode():
    return getattr(_STATE, "mode", "tp_fsdp")


def _split():
    return getattr(_STATE, "split", ())


@contextlib.contextmanager
def use_hints(mesh, parallelism: str = "tp_fsdp", batch_split=()):
    """Install ``mesh`` for the model code inside the block;
    ``batch_split``: the axes the step split the batch over (its local
    rows are one chunk of the global batch over them)."""
    prev = (_mesh(), _mode(), _split())
    _STATE.mesh, _STATE.mode, _STATE.split = mesh, parallelism, \
        tuple(batch_split)
    try:
        yield
    finally:
        _STATE.mesh, _STATE.mode, _STATE.split = prev


def token_axes(mesh=None, mode=None):
    """All axes token-level work parallelizes over (``fsdp``: + model)."""
    mesh = mesh or _mesh()
    base = batch_axes(mesh)
    return base + ("model",) if (mode or _mode()) == "fsdp" else base


_ROLES = {"heads", "kv_heads", "ff", "vocab", "experts"}


def tp_size() -> int:
    """Ranks of tensor parallelism: ``model``'s size under ``tp_fsdp``,
    else 1."""
    mesh = _mesh()
    if mesh is None or _mode() == "fsdp":
        return 1
    return axis_size(mesh, "model")


def tp_rank() -> int:
    if tp_size() == 1:
        return 0
    return _mesh().get_local_rank("model")


def constrain(x, *roles, partial: bool = False):
    """``constrain(x, 'batch', None, 'heads', None)`` — roles per dim. A
    tensor-parallel role (heads, kv_heads, ff, vocab, experts) that
    divides its dim cuts this rank's slice of that dim (the tensor is
    whole on every rank of ``model``); ``partial=True``: ``x`` is this
    rank's partial sum of a row-parallel product, all-reduced over
    ``model`` first. ``batch`` and ``seq`` move nothing (module
    docstring)."""
    if x is None:
        return x
    m = tp_size()
    if m == 1:
        return x
    if partial:
        x = reduce_tp(x)
    for dim, role in enumerate(roles):
        if role in _ROLES and x.shape[dim] % m == 0:
            x = split_tp(x, dim)
    return x


def heads_shardable(n_heads: int) -> bool:
    mesh = _mesh()
    if mesh is None or _mode() == "fsdp":
        return mesh is not None and _mode() == "fsdp"  # skip seq-sharding too
    return n_heads % axis_size(mesh, "model") == 0


def batch_ranks() -> int:
    """Chunks the global batch is split into (1 without a mesh)."""
    mesh = _mesh()
    return 1 if mesh is None else axis_size(mesh, _split())


def replicas() -> int:
    """Ranks over the token axes that hold the same batch chunk: a
    step's local loss is divided by it, since the data-parallel gradient
    sums over every rank of those axes."""
    return num_data_shards() // batch_ranks()


def batch_sum(x):
    """``x`` summed over the ranks holding the other chunks of the batch
    (the gradient as is: each rank's own rows take their share)."""
    if batch_ranks() == 1:
        return x
    return _BatchSum.apply(x)


def gather_batch(x):
    """Every rank's rows of ``x`` (dim 0) over the axes the batch is
    split over, in global order; the gradient summed back to this rank's
    rows (every rank's result may depend on every row)."""
    if batch_ranks() == 1:
        return x
    return _GatherBatch.apply(x)


def local_rows(x):
    """This rank's chunk of the global rows of ``x`` (dim 0)."""
    n = batch_ranks()
    if n == 1:
        return x
    from repro_torch.launch.sharding import chunk_index
    size = x.shape[0] // n
    return x.narrow(0, chunk_index(_mesh(), _split()) * size, size)


def num_data_shards() -> int:
    """Group count for MoE dispatch (1 when no mesh installed)."""
    mesh = _mesh()
    if mesh is None:
        return 1
    return axis_size(mesh, token_axes(mesh))


# ---------------------------------------------------------------------------
# Collectives on one axis
# ---------------------------------------------------------------------------

def _group(axis, mesh=None):
    mesh = mesh or _mesh()
    return axis_sizes(mesh)[axis], mesh.get_group(axis).group_name


def all_gather(x, dim, axis, mesh=None, always=False):
    """Concatenate every rank's ``x`` along ``dim`` over ``axis``
    (``always``: run the collective on an axis of one rank too)."""
    n, name = _group(axis, mesh)
    if n == 1 and not always:
        return x
    x = x.movedim(dim, 0).contiguous()
    out = _ops().wait_tensor(_ops().all_gather_into_tensor(x, n, name))
    return out.movedim(0, dim)


def reduce_scatter(x, dim, axis, mesh=None):
    """Sum ``x`` over ``axis`` and keep this rank's chunk along ``dim``."""
    n, name = _group(axis, mesh)
    if n == 1:
        return x
    x = x.movedim(dim, 0).contiguous()
    out = _ops().wait_tensor(_ops().reduce_scatter_tensor(x, "sum", n, name))
    return out.movedim(0, dim)


def all_reduce(x, axis, op="sum", mesh=None):
    n, name = _group(axis, mesh)
    if n == 1:
        return x
    return _ops().wait_tensor(_ops().all_reduce(x.contiguous(), op, name))


def _chunk(x, dim, axis, mesh=None):
    mesh = mesh or _mesh()
    n = axis_sizes(mesh)[axis]
    if n == 1:
        return x
    size = x.shape[dim] // n
    return x.narrow(dim, mesh.get_local_rank(axis) * size, size)


# ---------------------------------------------------------------------------
# Tensor parallelism (autograd)
# ---------------------------------------------------------------------------

class _BatchSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        for axis in _split():
            x = all_reduce(x, axis)
        return x

    @staticmethod
    def backward(ctx, g):
        return g


class _GatherBatch(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        for axis in reversed(_split()):      # innermost first
            x = all_gather(x, 0, axis)
        return x

    @staticmethod
    def backward(ctx, g):
        for axis in _split():
            g = reduce_scatter(g, 0, axis)
        return g


class _ToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, "model")


class _ReduceTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return all_reduce(x, "model")

    @staticmethod
    def backward(ctx, g):
        return g


class _SplitTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim):
        ctx.dim = dim
        return _chunk(x, dim, "model").contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.dim, "model"), None


class _GatherTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim):
        ctx.dim = dim
        return all_gather(x, dim, "model")

    @staticmethod
    def backward(ctx, g):
        return _chunk(g, ctx.dim, "model").contiguous(), None


def to_tp(x):
    """Megatron's *f*: identity; the gradient all-reduced over ``model``."""
    return _ToTP.apply(x) if tp_size() > 1 else x


def reduce_tp(x):
    """Megatron's *g*: all-reduce over ``model``; the gradient as is."""
    return _ReduceTP.apply(x) if tp_size() > 1 else x


def split_tp(x, dim):
    """This rank's slice of ``dim`` (whole on every rank of ``model``)."""
    return _SplitTP.apply(x, dim) if tp_size() > 1 else x


def gather_tp(x, dim):
    """Every rank's slice of ``dim`` concatenated over ``model``; the
    gradient cut back to this rank's slice."""
    return _GatherTP.apply(x, dim) if tp_size() > 1 else x


def select_heads(kv, first: int, count: int, group: int):
    """The K/V heads (dim -2 of ``kv``, whole on every rank) that query
    heads ``first .. first + count - 1`` read, query head ``j`` reading
    K/V head ``j // group``: a slice of whole heads when the local query
    heads cover them evenly, else one K/V head per query head."""
    lo, hi = first // group, (first + count - 1) // group + 1
    n = hi - lo
    if count % n == 0 and all((first + j) // group - lo == j // (count // n)
                              for j in range(count)):
        idx = torch.arange(lo, hi, device=kv.device)
    else:
        idx = (first + torch.arange(count, device=kv.device)) // group
    return to_tp(kv).index_select(-2, idx)


# ---------------------------------------------------------------------------
# Parameters: the per-layer gather of their local shards
# ---------------------------------------------------------------------------

class _GatherParam(torch.autograd.Function):
    """All-gather a parameter's local shard over ``steps`` (``(dim, axis,
    summed)``, innermost axis first); the backward goes back in reverse:
    a reduce-scatter for a ``summed`` (data) axis, this rank's chunk for
    a tensor-parallel one (every rank of ``model`` used the same whole
    value)."""

    @staticmethod
    def forward(ctx, x, steps):
        ctx.steps = steps
        for dim, axis, _ in steps:
            x = all_gather(x, dim, axis)
        return x

    @staticmethod
    def backward(ctx, g):
        for dim, axis, summed in reversed(ctx.steps):
            g = reduce_scatter(g, dim, axis) if summed \
                else _chunk(g, dim, axis).contiguous()
        return g, None


def gather_steps(spec, keep_tp: bool, mesh=None, mode=None):
    """The ``_GatherParam`` steps of a parameter stored under ``spec``:
    every sharded axis but ``model`` when ``keep_tp`` (under ``tp_fsdp``),
    innermost first; data axes (and ``model`` under ``fsdp``) summed in
    the backward."""
    mesh = mesh or _mesh()
    mode = mode or _mode()
    summed_axes = set(token_axes(mesh, mode))
    steps = []
    for d, entry in enumerate(spec):
        axes = () if entry is None else ((entry,) if isinstance(entry, str)
                                         else tuple(entry))
        for a in reversed(axes):
            if axis_size(mesh, a) == 1 or (keep_tp and a == "model"
                                           and mode != "fsdp"):
                continue
            steps.append((d, a, a in summed_axes))
    return tuple(steps)


def param(p):
    """``p``'s value for compute: its local shard gathered as the step
    marked it (``_shard_steps``), keeping the ``_tp_dim`` mark; ``p``
    itself without a mark."""
    steps = getattr(p, "_shard_steps", None)
    if not steps:
        return p
    full = _GatherParam.apply(p, steps)
    full._tp_dim = tp_dim(p)
    return full


def tp_dim(p):
    """The dim of ``p`` that stays split over ``model`` in compute, or
    None."""
    return getattr(p, "_tp_dim", None)


@contextlib.contextmanager
def gathered(module):
    """``module``'s marked parameters (``launch.steps`` marks the local
    shards it unwraps) replaced by their ``param`` values inside the
    block."""
    if _mesh() is None or not isinstance(module, torch.nn.Module):
        yield
        return
    swapped = []
    for mod in module.modules():
        for leaf, p in list(mod._parameters.items()):
            if p is None or not getattr(p, "_shard_steps", None):
                continue
            mod._parameters[leaf] = param(p)
            swapped.append((mod, leaf, p))
    try:
        yield
    finally:
        for mod, leaf, p in swapped:
            mod._parameters[leaf] = p
