"""The port's dry-run (``repro_torch.launch.dryrun``) on fake process
groups: qwen2-smoke's train, prefill and decode cells on an 8-rank
(data=4, model=2) mesh and qwen2-7b's decode_32k cell on the 256-rank
production mesh run with status ok; a cell's per-device argument bytes
are the sum of the local shards the rules give; and the collectives of a
tensor-parallel prefill are the ones a formula of the model predicts."""

import math

import pytest
import torch

from repro_torch.configs.base import SHAPES, ShapeConfig
from repro_torch.configs.registry import get_config
from repro_torch.launch import dryrun as D
from repro_torch.launch import sharding as SH
from repro_torch.launch import steps as ST
from repro_torch.launch.mesh import axis_size, make_production_mesh


def _mesh(shape):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))


def _local_bytes(shape, spec, mesh, itemsize):
    n = math.prod(shape)
    for entry in spec:
        n //= axis_size(mesh, entry)
    return n * itemsize


def _expected_args(cfg, shape, mesh):
    """The rules' local shard bytes of a prefill or decode cell's
    parameters and inputs."""
    sh = ST.cell_shardings(cfg, shape, mesh)
    total = sum(_local_bytes(p.shape, sh["params"][n].spec, mesh,
                             p.element_size())
                for n, p in ST.params_shape(cfg).items())
    specs = ST.input_specs(cfg, shape)
    for k, v in specs.items():
        pairs = []
        ST.map_pairs(lambda _, t, s: pairs.append((t, s)), v, sh[k])
        total += sum(_local_bytes(t.shape, s.spec, mesh, t.element_size())
                     for t, s in pairs)
    return total


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_smoke_cells_on_a_fake_8_rank_mesh(kind):
    cfg = get_config("qwen2-7b", smoke=True, attention_impl="ita")
    shape = ShapeConfig(kind, 64, 8, kind)
    with D.fake_world(8):
        mesh = _mesh((4, 2))
        rec = D.run_cell("qwen2-7b", kind, mesh, cfg=cfg, shape=shape,
                         verbose=False)
        if kind != "train":
            assert rec["memory"]["argument_bytes"] == \
                _expected_args(cfg, shape, mesh)
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["mesh"] == "4x2" and rec["roofline"]["flops"] > 0
    assert rec["collectives"]["total_bytes"] > 0


def test_meta_stand_ins_allocate_nothing():
    """``params_shape``, ``opt_state_shape``, ``caches_shape`` and
    ``input_specs`` at full size: meta tensors of the model's shapes."""
    cfg = get_config("llama-3.2-vision-90b")
    params = ST.params_shape(cfg)
    opt = ST.opt_state_shape(cfg)
    assert all(p.is_meta for p in params.values())
    assert {n: t.shape for n, t in opt.mu.items()} == \
        {n: p.shape for n, p in params.items()}
    specs = ST.input_specs(cfg, SHAPES["decode_32k"])
    assert specs["tokens"].shape == (128, 1) and specs["pos0"].is_meta
    assert specs["frontend"].shape == (128, cfg.n_frontend_tokens,
                                       cfg.frontend_dim)
    kv = [c["mix"].k for c in specs["caches"] if hasattr(c["mix"], "k")]
    assert kv and all(k.is_meta and k.shape[1] >= 32768 for k in kv)


def test_qwen2_decode_32k_on_the_production_mesh():
    cfg = get_config("qwen2-7b")
    shape = SHAPES["decode_32k"]
    with D.fake_world(256):
        mesh = make_production_mesh(device_type="cpu")
        rec = D.run_cell("qwen2-7b", "decode_32k", mesh, verbose=False)
        want = _expected_args(cfg, shape, mesh)
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["mesh"] == "16x16" and rec["kind"] == "decode"
    assert rec["memory"]["argument_bytes"] == want
    assert rec["roofline"]["bottleneck"] in ("compute", "memory",
                                             "collective")


def test_tensor_parallel_prefill_collectives_match_formula():
    """qwen2-smoke (float, 4 query and 2 K/V heads) on (data=1, model=2):
    every projection is tensor parallel. Per layer, the attention's and
    the MLP's row-parallel outputs are all-reduced, (B, S, d) float32
    each, and the two norm gains, stored split over ``model``, are
    gathered, (d/2,) each; the vocabulary-parallel embedding adds one
    all-reduce and the final norm one gather. Nothing else moves."""
    cfg = get_config("qwen2-7b", smoke=True)
    b, s, d, layers = 2, 32, cfg.d_model, cfg.n_layers
    with D.fake_world(2):
        rec = D.run_cell("qwen2-7b", "p", _mesh((1, 2)), cfg=cfg,
                         shape=ShapeConfig("p", s, b, "prefill"),
                         verbose=False)
    assert rec["status"] == "ok", rec.get("traceback")
    col = rec["collectives"]
    assert col["counts"] == {"all-reduce": 2 * layers + 1,
                             "all-gather": 2 * layers + 1}
    assert col["bytes"] == {"all-reduce": (2 * layers + 1) * b * s * d * 4,
                            "all-gather": (2 * layers + 1) * d // 2 * 4}
    assert col["total_bytes"] == sum(col["bytes"].values())
