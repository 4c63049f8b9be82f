"""AdamW, its learning-rate schedule and global-norm clipping
(``repro.optim.optimizer``), over a dict of the model's parameters keyed
by name.

    params = train_params(model)             # name -> nn.Parameter
    opt_state = init_opt_state(params)
    ...                                      # loss.backward()
    opt_state, stats = adamw_update({n: p.grad for n, p in params.items()},
                                    opt_state, params, cfg,
                                    grad_dtype=model_cfg.param_torch_dtype())

The update writes the parameters, ``mu``, ``nu`` and the master copy in
place and returns the state with the new ``count``. Its arithmetic is the
JAX package's, in float32 tensors where it computes in float32 arrays:
the schedule, ``b1 ** count`` and the clip scale (cast to the gradient's
dtype) are tensors, not Python doubles, which would shift the last bits.

``grad_dtype`` is the dtype the JAX package's gradient of a leaf has: its
parameter dtype (``param_dtype``). The port stores projections in the
compute dtype, so a bfloat16 model of float32 parameters holds bfloat16
gradients; the update widens each to ``grad_dtype`` before the clip, as
the reference's gradient of a float32 leaf cast to bfloat16 at its use
is the float32 widening of the bfloat16 cotangent. Its new value is
rounded to ``grad_dtype`` and then to the storage dtype, the value the
reference's next step computes with.

Under a mesh the parameters, gradients and state are DTensors placed
alike (``launch.sharding.opt_state_shardings``): the update runs on each
rank's local shards, and the global norm sums each leaf's local sum of
squares over the axes it is sharded on.

A master copy (float32) is kept when any stored leaf is bfloat16, the
JAX package's rule on its own leaves: such a leaf cannot hold the
float32 parameter. The clip runs leaf by leaf inside the update loop, so
no second gradient tree is built. Scalar (0-d) leaves, the QAT scales
and the cross gates, take no weight decay.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.transformer import host_array, jax_named_leaves


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1


@dataclasses.dataclass
class OptState:
    """Adam's moments ``mu``/``nu`` and the float32 ``master`` copy (None
    when every stored leaf is float32), dicts keyed by parameter name;
    ``count``, the steps taken, an int32 0-d tensor."""

    mu: dict
    nu: dict
    master: dict | None
    count: torch.Tensor


def train_params(model) -> dict:
    """The model's parameters by name, switched to ``requires_grad``."""
    params = dict(model.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    return params


def init_opt_state(params: dict) -> OptState:
    with torch.no_grad():
        mu = {n: torch.zeros_like(p, dtype=torch.float32)
              for n, p in params.items()}
        nu = {n: torch.zeros_like(m) for n, m in mu.items()}
        master = ({n: p.detach().float().clone() for n, p in params.items()}
                  if any(p.dtype == torch.bfloat16 for p in params.values())
                  else None)
    count = torch.zeros((), dtype=torch.int32,
                        device=next(iter(params.values())).device)
    return OptState(mu=mu, nu=nu, master=master, count=count)


def _f32(x, like):
    return torch.as_tensor(x, dtype=torch.float32, device=like.device)


def lr_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup to ``lr``, then a cosine to ``min_lr_frac · lr`` at
    ``total_steps``; float32 0-d, from the int32 ``step``."""
    s = step.float()
    warm = torch.minimum(s / _f32(max(cfg.warmup_steps, 1), s),
                         _f32(1.0, s))
    prog = torch.clamp(
        (step - cfg.warmup_steps).float()
        / _f32(max(cfg.total_steps - cfg.warmup_steps, 1), s), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(_f32(math.pi, s) * prog))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def _local(t):
    """A DTensor's local shard; any other tensor as is."""
    return t.to_local() if hasattr(t, "to_local") else t


def _sharded_axes(t) -> tuple:
    """``(mesh, axes)``: the mesh axes of size > 1 a DTensor is sharded
    over (``(None, ())`` for any other tensor)."""
    if not hasattr(t, "placements"):
        return None, ()
    mesh = t.device_mesh
    axes = tuple(a for a, pl, n in zip(mesh.mesh_dim_names, t.placements,
                                      mesh.shape, strict=True)
                 if pl.is_shard() and n > 1)
    return mesh, axes


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's float32 sum of squares
    (the leaves of a dict, in its order; None counts as zeros). A
    sharded DTensor leaf's local sums are summed over its axes, one
    all-reduce per set of axes."""
    from repro_torch.launch import hints
    leaves = [g for g in (grads.values() if isinstance(grads, dict)
                          else grads) if g is not None]
    total = None
    sharded = {}
    for g in leaves:
        mesh, axes = _sharded_axes(g)
        sq = torch.sum(torch.square(_local(g).float()))
        if axes:
            key = (id(mesh), axes)
            part = sharded.get(key, (mesh, None))[1]
            sharded[key] = (mesh, sq if part is None else part + sq)
            continue
        total = sq if total is None else total + sq
    for (_, axes), (mesh, part) in sharded.items():
        for a in axes:
            part = hints.all_reduce(part, a, mesh=mesh)
        total = part if total is None else total + part
    return torch.sqrt(total)


def _clip_scale(norm, max_norm):
    return torch.minimum(_f32(1.0, norm),
                         max_norm / torch.clamp(norm, min=1e-9))


def clip_by_global_norm(grads: dict, max_norm):
    """``(grads · min(1, max_norm / norm), norm)``, a new dict (the update
    clips leaf by leaf instead)."""
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return {n: g * scale.to(g.dtype) for n, g in grads.items()}, norm


def adamw_update(grads: dict, opt_state: OptState, params: dict,
                 cfg: AdamWConfig, *, grad_dtype=None):
    """One AdamW step over ``params`` (name -> tensor, written in place)
    from ``grads`` (name -> tensor or None, a parameter no loss reached:
    zeros). ``grad_dtype``: the reference's dtype of the gradients (module
    docstring; None: each gradient's own). Returns ``(new_opt_state,
    {"grad_norm", "lr"})``; ``mu``, ``nu`` and ``master`` are updated in
    place."""
    with torch.no_grad():
        local = {n: _local(p) for n, p in params.items()}
        some = next(iter(local.values()))

        def grad(n):
            g = grads.get(n)
            if g is None:
                g = torch.zeros_like(local[n])
            return g if grad_dtype is None else g.to(grad_dtype)

        norm = global_norm(grad(n) for n in params)
        scale = _clip_scale(norm, cfg.clip_norm)
        count = _local(opt_state.count) + 1
        lr = lr_schedule(cfg, count)
        cnt = count.float()
        b1c = 1 - torch.pow(_f32(cfg.b1, some), cnt)
        b2c = 1 - torch.pow(_f32(cfg.b2, some), cnt)
        for n, p in local.items():
            g = _local(grad(n))
            g = (g * scale.to(g.dtype)).float()
            m, v = _local(opt_state.mu[n]), _local(opt_state.nu[n])
            m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
            v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
            del g
            w32 = None if opt_state.master is None \
                else _local(opt_state.master[n])
            base = w32 if w32 is not None else p.float()
            # no decay on scalar leaves (quant scales, gates): decaying a
            # calibrated scale toward 0 corrupts the integer serve path
            wd = cfg.weight_decay if p.ndim > 0 else 0.0
            step = lr * (m / b1c / (torch.sqrt(v / b2c) + cfg.eps)
                         + wd * base)
            new32 = base - step
            del step
            out_dt = p.dtype if grad_dtype is None else grad_dtype
            p.copy_(new32.to(out_dt).to(p.dtype))
            if w32 is not None:
                w32.copy_(new32)
    return (dataclasses.replace(opt_state, count=count),
            {"grad_norm": norm, "lr": lr})


def opt_state_from_jax(opt, params_tree, cfg, model, *, device="cuda"):
    """The JAX package's ``OptState`` (numpy leaves) as the port's, for
    ``model``: ``mu``, ``nu`` and ``master`` mapped by
    ``jax_named_leaves`` (float32), ``count`` as int32. Where the port
    keeps a master copy and the reference does not (float32 parameters
    the port stores in bfloat16), the master is the reference's
    parameters ``params_tree``."""
    dev = resolve_device(device)

    def named(tree):
        return {n: torch.from_numpy(host_array(a)).float().to(dev)
                for n, a in jax_named_leaves(tree, cfg)}

    wants_master = any(p.dtype == torch.bfloat16
                       for p in model.parameters())
    master = None
    if wants_master:
        master = named(opt.master if opt.master is not None
                       else params_tree)
    return OptState(mu=named(opt.mu), nu=named(opt.nu), master=master,
                    count=torch.tensor(int(np.asarray(opt.count)),
                                       dtype=torch.int32, device=dev))
