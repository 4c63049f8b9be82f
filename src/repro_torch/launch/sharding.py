"""Sharding rules (``repro.launch.sharding``): Megatron-style tensor
parallelism over ``model`` × ZeRO-3 parameter and optimizer sharding over
``data`` (and ``pod``) × data parallelism of the batch, plus MoE expert
parallelism and KV-cache sharding (over the sequence when the batch axis
cannot be split, as in the single-sequence long_500k decode).

A rule gives a *spec*: one entry per tensor dim, an axis name, a tuple of
axis names (major to minor) or None, as the reference's ``PartitionSpec``.
Every rule checks divisibility and drops an axis that does not divide its
dim (``_fit``), so the same rules place the smoke configs and the 90B
ones. The port's parameters are per layer (``named_parameters()``) where
the reference stacks them over periods under ``groups``: a port leaf's
spec is the reference's with that leading None dropped.

A ``Sharding`` is a mesh and a spec; ``placements`` turns the spec into
DTensor placements (``Shard(d)`` on each mesh dim named at tensor dim
``d``, else ``Replicate()``), and ``place`` cuts this rank's chunk of a
full tensor into a DTensor without communication.

    shard_model(model, mesh)              # parameters become DTensors
    ...
    gather_params(model)                  # back to full tensors
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch.launch.mesh import (axis_names, axis_size, axis_sizes,
                                     batch_axes)

# column-parallel (in, out) -> (fsdp, model); row-parallel -> (model, fsdp)
_COL = {"wq", "wk", "wv", "w_gate", "w_up", "w_in", "w_gate_branch", "w_r",
        "w_k", "w_v", "w_g", "ddlerp_a", "w_lora_a", "router", "unembed",
        "frontend_proj"}
_ROW = {"wo", "w_down", "w_out", "w_o", "w_lora_b"}
# the port's norm modules: their gain is the reference's ``scale`` leaf
_NORMS = {"norm1", "norm2", "norm_x", "post_norm1", "post_norm2",
          "final_norm", "encoder_norm"}


def _fit(spec, shape, mesh):
    """Drop axes that don't divide the corresponding dim."""
    out = []
    for dim, ax in zip(shape, spec, strict=False):
        out.append(ax if ax is not None and dim % axis_size(mesh, ax) == 0
                   else None)
    return tuple(out)


def leaf_name(name: str) -> str:
    """The reference's leaf name of the port parameter ``name``."""
    parts = name.split(".")
    last = parts[-1]
    if name == "embed":
        return "table"
    if last in _NORMS:                      # an RMSNorm gain
        return "scale"
    return last


def _leaf_param_spec(name, shape, mesh, parallelism="tp_fsdp"):
    """The spec of the port parameter ``name`` of ``shape``: the
    reference's ``_leaf_param_spec`` of the same leaf, unstacked."""
    name = leaf_name(name)
    fsdp = batch_axes(mesh)
    if parallelism == "fsdp":
        fsdp = fsdp + ("model",)
    shape = tuple(shape)
    nd = len(shape)

    if nd == 0:
        base = ()
    elif name == "table":
        base = ("model", fsdp)
    elif nd == 3 and name in ("w_gate", "w_up", "w_down") \
            and parallelism == "fsdp":                 # experts, pure ZeRO-3
        base = (None, fsdp, None)
    elif nd == 3 and name in ("w_gate", "w_up"):       # MoE experts (E,d,f)
        base = (("model", fsdp, None)
                if shape[0] % axis_size(mesh, "model") == 0
                else (None, fsdp, "model"))
    elif nd == 3 and name == "w_down":                 # MoE experts (E,f,d)
        base = (("model", None, fsdp)
                if shape[0] % axis_size(mesh, "model") == 0
                else (None, "model", fsdp))
    elif nd == 3:                                      # blockdiag/LoRA stacks
        base = (None, None, "model")
    elif name in _COL and nd == 2:
        base = (fsdp, "model")
    elif name in _ROW and nd == 2:
        base = ("model", fsdp)
    elif name in ("conv_w", "mu"):
        base = (None, "model")
    elif nd == 1:
        base = ("model",)
    else:                                              # norms etc.
        base = tuple(None for _ in shape)

    if parallelism == "fsdp":
        # pure ZeRO-3: TP dims become storage-only sharding, each axis
        # used once per spec
        base = tuple(fsdp if ax == "model" else ax for ax in base)
        seen = set()
        clean = []
        for ax in base:
            axs = (ax,) if isinstance(ax, str) else (ax or ())
            if any(a in seen for a in axs):
                clean.append(None)
            else:
                seen.update(axs)
                clean.append(ax)
        base = tuple(clean)
    return _fit(base, shape, mesh)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A mesh and a spec (the reference's ``NamedSharding``)."""

    mesh: object
    spec: tuple

    def placements(self):
        return placements(self.spec, self.mesh)


def _axes(entry) -> tuple:
    return () if entry is None else ((entry,) if isinstance(entry, str)
                                     else tuple(entry))


def placements(spec, mesh):
    """DTensor placements of ``spec``: ``Shard(d)`` on each mesh dim named
    at tensor dim ``d``, else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    where = {a: d for d, entry in enumerate(spec) for a in _axes(entry)}
    return [Shard(where[a]) if a in where else Replicate()
            for a in axis_names(mesh)]


def spec_of(placements_, mesh, ndim) -> tuple:
    """The spec of DTensor ``placements_`` (mesh dims in order)."""
    entries = [[] for _ in range(ndim)]
    for a, p in zip(axis_names(mesh), placements_, strict=True):
        if p.is_shard():
            entries[p.dim].append(a)
    return tuple(None if not e else (e[0] if len(e) == 1 else tuple(e))
                 for e in entries)


def chunk_index(mesh, axes) -> int:
    """This rank's chunk among ``axis_size(mesh, axes)`` (major to minor)."""
    sizes = axis_sizes(mesh)
    idx = 0
    for a in _axes(axes):
        idx = idx * sizes[a] + mesh.get_local_rank(a)
    return idx


def local_chunk(full: torch.Tensor, spec, mesh):
    """This rank's chunk of ``full`` under ``spec`` (a view)."""
    out = full
    for d, entry in enumerate(spec):
        n = axis_size(mesh, entry)
        if n > 1:
            size = full.shape[d] // n
            out = out.narrow(d, chunk_index(mesh, entry) * size, size)
    return out


def place(full: torch.Tensor, sharding: Sharding):
    """``full`` as a DTensor under ``sharding``, each rank keeping a copy
    of its own chunk (no communication; where the chunk is all of
    ``full``, as on a mesh of one rank, the DTensor holds ``full``
    itself)."""
    from torch.distributed.tensor import DTensor
    local = local_chunk(full, sharding.spec, sharding.mesh)
    if local.shape != full.shape:
        local = local.clone(memory_format=torch.contiguous_format)
    return DTensor.from_local(local, sharding.mesh, sharding.placements(),
                              run_check=False)


def param_shardings(params, mesh, parallelism="tp_fsdp") -> dict:
    """name -> ``Sharding`` of each parameter (``params``: a dict of
    tensors or shapes by name, or a module)."""
    if isinstance(params, nn.Module):
        params = dict(params.named_parameters())
    return {n: Sharding(mesh, _leaf_param_spec(n, getattr(p, "shape", p),
                                               mesh, parallelism))
            for n, p in params.items()}


def opt_state_shardings(params, mesh, parallelism="tp_fsdp",
                        has_master=False):
    from repro_torch.optim.optimizer import OptState
    ps = param_shardings(params, mesh, parallelism)
    return OptState(mu=ps, nu=ps, master=ps if has_master else None,
                    count=replicated(mesh))


def batch_spec(shape, mesh, parallelism="tp_fsdp") -> tuple:
    """A batch leaf's spec: the batch over the data axes (``fsdp``: over
    every axis, or, when the global batch does not divide them, over the
    data axes with the sequence over ``model``)."""
    bax = batch_axes(mesh)
    nd = len(shape)
    if parallelism == "fsdp":
        allax = bax + ("model",)
        if shape[0] % axis_size(mesh, allax) == 0:
            s = (allax,) + (None,) * (nd - 1)
        elif nd >= 2:                # seq-DP fallback (small global batch)
            s = (bax, "model") + (None,) * (nd - 2)
        else:
            s = (bax,) + (None,) * (nd - 1)
    else:
        s = (bax,) + (None,) * (nd - 1)
    return _fit(s, shape, mesh)


def batch_shardings(batch_shape: dict, mesh, parallelism="tp_fsdp"):
    return {k: Sharding(mesh, batch_spec(tuple(getattr(v, "shape", v)),
                                         mesh, parallelism))
            for k, v in batch_shape.items()}


def _leaf_cache_spec(name, shape, batch, mesh):
    """The reference's ``_leaf_cache_spec`` of a port cache leaf (no
    leading period axis), dispatched by the leaf's name."""
    bax = batch_axes(mesh)
    shape = tuple(shape)
    nd = len(shape)
    if nd == 0 or name in ("pos", "k_scale", "v_scale", "page_table",
                           "free_stack", "free_top", "ref_count"):
        return ()
    if nd == 1:
        return (None,)
    b_ok = shape[0] == batch and batch % axis_size(mesh, bax) == 0
    b_ax = bax if b_ok else None
    m = axis_size(mesh, "model")
    if name in ("k", "v", "k8", "v8"):                 # (B, S, G, hd)
        seq_ax = None if b_ok else "data"              # seq-shard if B small
        g_ax = "model" if shape[2] % m == 0 else None
        hd_ax = None if g_ax else ("model" if shape[3] % m == 0 else None)
        return (b_ax, seq_ax, g_ax, hd_ax)
    if name == "s":                                    # rwkv (B, H, dh, dh)
        return (b_ax, "model" if shape[1] % m == 0 else None, None, None)
    # h / shift / conv: the channel (last) dim over model
    last = "model" if shape[-1] % m == 0 else None
    return (b_ax, *((None,) * (nd - 2)), last)


def map_named(fn, tree, name=""):
    """``tree`` (dataclasses, dicts, lists, tuples) with each tensor leaf
    replaced by ``fn(name, leaf)``, ``name`` its field or key."""
    if torch.is_tensor(tree):
        return fn(name, tree)
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: map_named(fn, getattr(tree, f.name), f.name)
            for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: map_named(fn, v, k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_named(fn, v, name) for v in tree)
    return tree


def cache_shardings(caches, batch, mesh):
    """``caches`` with a ``Sharding`` in place of each tensor."""
    return map_named(
        lambda n, t: Sharding(mesh, _leaf_cache_spec(n, t.shape, batch,
                                                     mesh)), caches)


def logits_sharding(mesh, batch, vocab, parallelism="tp_fsdp"):
    bax = batch_axes(mesh)
    b_ax = bax if batch % axis_size(mesh, bax) == 0 else None
    v_ax = None if parallelism == "fsdp" else (
        "model" if vocab % axis_size(mesh, "model") == 0 else None)
    return Sharding(mesh, (b_ax, None, v_ax))


def replicated(mesh):
    return Sharding(mesh, ())


# ---------------------------------------------------------------------------
# Whole models
# ---------------------------------------------------------------------------

def _set_param(model, name, value):
    mod_name, _, leaf = name.rpartition(".")
    mod = model.get_submodule(mod_name) if mod_name else model
    mod._parameters[leaf] = value


def shard_model(model, mesh, parallelism=None):
    """Turn ``model``'s parameters into DTensor parameters placed by the
    rules, in place (each rank keeps its chunk; on a mesh of one rank the
    DTensor holds the very tensor the parameter held). Returns
    ``model``."""
    par = parallelism or getattr(model.cfg, "parallelism", "tp_fsdp")
    shardings = param_shardings(model, mesh, par)
    with torch.no_grad():
        for n, p in list(model.named_parameters()):
            _set_param(model, n, nn.Parameter(
                place(p.data, shardings[n]), requires_grad=p.requires_grad))
    model.mesh, model.parallelism = mesh, par
    return model


def gather_params(model):
    """The inverse of ``shard_model``: full tensors back in every
    parameter (a collective: every rank calls it). Returns ``model``."""
    from torch.distributed.tensor import DTensor
    with torch.no_grad():
        for n, p in list(model.named_parameters()):
            if isinstance(p, DTensor):
                _set_param(model, n, nn.Parameter(
                    p.full_tensor(), requires_grad=p.requires_grad))
    for attr in ("mesh", "parallelism"):
        if hasattr(model, attr):
            delattr(model, attr)
    return model
