"""The port's sharding rules (``repro_torch.launch.sharding``) against the
JAX package's (``repro.launch.sharding``), spec for spec.

For the ten configs at full and at smoke size, on abstract (16, 16) and
(2, 16, 16) meshes, under ``tp_fsdp`` and ``fsdp``: every parameter of
the port (``named_parameters()``, one per layer) has the reference's
spec of the same leaf with the leading entry of its period stack
dropped; likewise the cache leaves of the decode shapes, the batch and
the logits. The meshes are ``jax.sharding.AbstractMesh``es: the rules
read only their axis names and sizes. Also: the hints are no-ops without
a mesh, and the dry-run's cells are the reference's.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from jax.sharding import AbstractMesh  # noqa: E402

from repro.configs import registry as JR  # noqa: E402
from repro.launch import sharding as JSH  # noqa: E402
from repro.launch import steps as JST  # noqa: E402
from repro_torch.configs import registry as TR  # noqa: E402
from repro_torch.configs.base import SHAPES  # noqa: E402
from repro_torch.launch import hints  # noqa: E402
from repro_torch.launch import sharding as TSH  # noqa: E402
from repro_torch.launch import steps as TST  # noqa: E402
from repro_torch.models.transformer import jax_named_leaves  # noqa: E402

MESHES = (AbstractMesh((16, 16), ("data", "model")),
          AbstractMesh((2, 16, 16), ("pod", "data", "model")))
MODES = ("tp_fsdp", "fsdp")


def _norm(spec):
    """A spec as a tuple of axis tuples (a name and its 1-tuple alike)."""
    return tuple(() if e is None else ((e,) if isinstance(e, str)
                                       else tuple(e)) for e in spec)


class _Leaf:
    """A reference leaf's spec and shape, unstacked."""

    def __init__(self, spec, shape):
        self.spec, self.shape = spec, shape


def _ref_leaves(pshape, cfg_t, mesh, par):
    """``{port name: _Leaf}`` of the reference's parameters
    (``pshape``: its ``params_shape``)."""

    def leaf(path, sds):
        spec = tuple(JSH._leaf_param_spec(path, sds, mesh, par))
        names = [p.key for p in path
                 if isinstance(p, jax.tree_util.DictKey)]
        if "groups" not in names:
            return _Leaf(spec, tuple(sds.shape))
        holder = np.empty(sds.shape[0], dtype=object)
        for i in range(sds.shape[0]):
            holder[i] = _Leaf(spec[1:], tuple(sds.shape[1:]))
        return holder
    tree = jax.tree_util.tree_map_with_path(leaf, pshape)
    return dict(jax_named_leaves(tree, cfg_t))


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", JR.ARCH_IDS)
def test_param_specs_match_reference(arch, smoke):
    cfg_j = JR.get_config(arch, smoke=smoke)
    cfg_t = TR.get_config(arch, smoke=smoke)
    shapes = {n: tuple(p.shape) for n, p in TST.params_shape(cfg_t).items()}
    pshape = JST.params_shape(cfg_j)
    checked = 0
    for mesh in MESHES:
        for par in MODES:
            ref = _ref_leaves(pshape, cfg_t, mesh, par)
            assert set(ref) == set(shapes)
            for name, leaf in ref.items():
                assert leaf.shape == shapes[name], name
                got = TSH._leaf_param_spec(name, shapes[name], mesh, par)
                assert _norm(got) == _norm(leaf.spec), (name, mesh, par)
                checked += 1
    assert checked == 4 * len(shapes)


def _cache_leaves(tree, names=()):
    """``(name path, leaf)`` of a cache tree (dicts and dataclasses)."""
    import dataclasses
    if torch.is_tensor(tree) or hasattr(tree, "shape"):
        yield names, tree
    elif dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            yield from _cache_leaves(getattr(tree, f.name), names + (f.name,))
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _cache_leaves(v, names + (k,))


def _decode_shapes(arch):
    return [SHAPES[s] for a, s in TR.cells() if a == arch
            and SHAPES[s].kind == "decode"]


@pytest.mark.parametrize("arch", JR.ARCH_IDS)
def test_cache_batch_logits_specs_match_reference(arch):
    cfg_j, cfg_t = JR.get_config(arch), TR.get_config(arch)
    for shape in _decode_shapes(arch):
        b, s = shape.global_batch, shape.seq_len
        ref_caches = JST.caches_shape(cfg_j, b, s)
        port_caches = TST.caches_shape(cfg_t, b, s)
        for mesh in MESHES:
            ref = {}
            flat, _ = jax.tree_util.tree_flatten_with_path(ref_caches)
            for path, sds in flat:
                g, i = path[0].idx, path[1].idx
                names = tuple(p.key if isinstance(p, jax.tree_util.DictKey)
                              else p.name for p in path[2:])
                spec = tuple(JSH._leaf_cache_spec(path, sds, b, mesh))
                ref[(g, i, names)] = spec[1:] if spec else ()
            layer = 0
            for g, (pattern, n) in enumerate(cfg_t.layer_groups):
                for _ in range(n):
                    for i in range(len(pattern)):
                        for names, t in _cache_leaves(port_caches[layer]):
                            got = TSH._leaf_cache_spec(names[-1], t.shape,
                                                       b, mesh)
                            assert _norm(got) == _norm(ref[(g, i, names)]), \
                                (arch, shape.name, layer, names)
                        layer += 1
            for par in MODES:
                want = JSH.logits_sharding(mesh, b, cfg_j.vocab_size,
                                           par).spec
                got = TSH.logits_sharding(mesh, b, cfg_t.vocab_size,
                                          par).spec
                assert _norm(got) == _norm(tuple(want))
    for shape in SHAPES.values():
        specs = JST.input_specs(cfg_j, shape)
        batch = specs["batch"] if shape.kind == "train" \
            else {k: v for k, v in specs.items()
                  if k in ("tokens", "frontend")}
        for mesh in MESHES:
            for par in MODES:
                want = JSH.batch_shardings(batch, mesh, par)
                for k, v in batch.items():
                    got = TSH.batch_spec(v.shape, mesh, par)
                    assert _norm(got) == _norm(tuple(want[k].spec)), \
                        (arch, shape.name, k, par)


def test_hints_noop_without_mesh():
    x = torch.ones(4, 4)
    assert hints.constrain(x, "batch", None) is x
    assert hints.constrain(x, "batch", "heads", partial=True) is x
    assert not hints.heads_shardable(8)
    assert hints.num_data_shards() == 1
    assert hints.to_tp(x) is x and hints.reduce_tp(x) is x
    assert hints.param(x) is x


def test_cells_and_shapes_match_reference():
    assert TR.cells() == JR.cells()
    assert TR.cells(include_skipped=True) == JR.cells(include_skipped=True)
    for name in SHAPES:
        want, got = JR.get_shape(name), TR.get_shape(name)
        assert (got.name, got.seq_len, got.global_batch, got.kind) == \
            (want.name, want.seq_len, want.global_batch, want.kind)
