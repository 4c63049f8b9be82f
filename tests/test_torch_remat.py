"""``remat_policy="dots"`` in the port (``models.transformer``
``_train_block``, ``remat_kwargs``): selective activation checkpointing
that keeps each block's ``mm``/``addmm`` outputs, the counterpart of
JAX's ``dots_with_no_batch_dims_saveable``.

- ``dots`` against ``full`` in the port: loss and every gradient
  bit-identical for whisper-smoke, olmoe-smoke (its router ``mm`` kept,
  its expert ``bmm`` recomputed) and phi3-smoke.
- whisper-smoke under ``dots`` in both packages: the port against JAX
  within ``tests/test_torch_train_grad.py``'s tolerances (the output
  fake-quant swapped for identity in both, as there).
- What the backward runs: under ``dots`` its recompute runs no product
  of ``linear``; under ``full`` exactly the forward's blocks' products.
- ``op_costs`` of a phi3-smoke train step under ``dots`` equals
  ``expected_flops`` (no dense recompute); the attention is counted as
  under ``full``.
- Four gloo ranks: ``shard_train_step`` of whisper-smoke under ``fsdp``
  and ``dots`` (the per-layer gathers recomputed in the backward) within
  ``tests/test_torch_distributed.py``'s tolerances of the unsharded
  step.
- An unknown policy is refused.
"""

from __future__ import annotations

import dataclasses
import multiprocessing as mp
import traceback

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from test_torch_train_grad import (GRAD_TOL, LOSS_TOL, _case,  # noqa: F401
                                   _check_grads, _jax_loss_and_grads,
                                   _output_fake_quant_off,
                                   _port_loss_and_grads,
                                   exact_exp2_with_gradient)

WORLD = 4
TIMEOUT = 240
PRODUCTS = ("aten.mm", "aten.addmm")


@pytest.mark.parametrize("arch", ["whisper-large-v3", "olmoe-1b-7b",
                                  "phi3-mini-3.8b"])
def test_dots_loss_and_gradients_equal_full(arch):
    _, tcfg, params, batch = _case(arch, "ita", remat_policy="dots")
    assert tcfg.remat and tcfg.remat_policy == "dots"
    dl, dm, dg = _port_loss_and_grads(params, batch, tcfg)
    fl, fm, fg = _port_loss_and_grads(
        params, batch, dataclasses.replace(tcfg, remat_policy="full"))
    assert dl == fl and dm == fm, (dl, fl, dm, fm)
    assert dg.keys() == fg.keys()
    for name, g in dg.items():
        assert np.array_equal(g, fg[name]), name
    assert any(np.abs(g).max() > 0 for g in dg.values())


def test_whisper_dots_matches_jax_dots():
    jcfg, tcfg, params, batch = _case("whisper-large-v3", "ita",
                                      remat_policy="dots")
    assert jcfg.remat_policy == tcfg.remat_policy == "dots"
    with pytest.MonkeyPatch.context() as m:
        _output_fake_quant_off(m)
        jl, _, jg = _jax_loss_and_grads(params, batch, jcfg)
        tl, _, tg = _port_loss_and_grads(params, batch, tcfg)
    assert abs(tl - jl) <= LOSS_TOL * abs(jl), (tl, jl)
    worst = _check_grads(jg, tg, tcfg, GRAD_TOL)
    print(f"whisper-smoke dots: loss {tl:.7f} vs {jl:.7f}, worst tensor "
          f"gradient {worst:.2e} of its leaf's scale")


class _Products(TorchDispatchMode):
    """Counts the ``PRODUCTS`` the forward runs inside a block and the
    backward runs inside ``linear`` (the backward's own products are
    ``_Linear.backward``'s, outside it: inside it run only the
    recompute's)."""

    def __init__(self):
        super().__init__()
        self.in_block = 0
        self.in_linear = 0
        self.backward = False
        self.forward_blocks = 0
        self.recomputed = 0
        self.backward_all = 0

    def hook(self, name, fn, args, kw):
        if name != "linear":
            return fn(*args, **kw)
        self.in_linear += 1
        try:
            return fn(*args, **kw)
        finally:
            self.in_linear -= 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if str(func.overloadpacket) in PRODUCTS:
            if not self.backward:
                self.forward_blocks += self.in_block > 0
            else:
                self.backward_all += 1
                self.recomputed += self.in_linear > 0
        return func(*args, **(kwargs or {}))


def _count_products(policy):
    from repro_torch.configs.registry import get_config
    from repro_torch.core import cost_hook
    from repro_torch.models import init_model, loss_fn
    from repro_torch.models import transformer as T
    cfg = get_config("whisper-large-v3", smoke=True, attention_impl="ita",
                     remat_policy=policy)
    model = init_model(cfg, seed=0, device="cpu")
    model.requires_grad_(True)
    rng = np.random.default_rng(3)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (2, 17))),
        "frontend": torch.from_numpy(rng.normal(0, 1, (
            2, cfg.n_frontend_tokens, cfg.frontend_dim)).astype(np.float32))}
    count = _Products()
    block = T._train_block

    def counted_block(*args, **kw):
        count.in_block += 1
        try:
            return block(*args, **kw)
        finally:
            count.in_block -= 1
    cost_hook.set_hook(count.hook)
    try:
        with pytest.MonkeyPatch.context() as m, count:
            m.setattr(T, "_train_block", counted_block)
            loss, _ = loss_fn(model, batch, cfg)
            count.backward = True
            loss.backward()
    finally:
        cost_hook.set_hook(None)
    return count


def test_dots_backward_recomputes_no_product():
    full, dots = _count_products("full"), _count_products("dots")
    assert full.forward_blocks == dots.forward_blocks > 0
    # 2 encoder + 2 decoder blocks; each the same forward under both
    assert full.recomputed == full.forward_blocks
    assert dots.recomputed == 0
    assert full.backward_all - dots.backward_all == full.forward_blocks


def test_op_costs_dots_train_step_equals_expected_flops():
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import DataPipeline, SyntheticSource
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import init_model
    from repro_torch.optim.optimizer import (AdamWConfig, init_opt_state,
                                             train_params)
    from repro_torch.roofline import analysis as TA
    from repro_torch.roofline import op_costs as OC
    shape = ShapeConfig("t", 64, 2, "train")
    counted = {}
    for policy in ("full", "dots"):
        cfg = get_config("phi3-mini-3.8b", smoke=True, attention_impl="ita",
                         remat_policy=policy)
        model = init_model(cfg, seed=0, device="cpu")
        opt = init_opt_state(train_params(model))
        step = make_train_step(cfg, AdamWConfig(lr=1e-3, warmup_steps=1,
                                                total_steps=2))
        batch = DataPipeline(SyntheticSource(cfg.vocab_size, seed=0),
                             batch=2, seq_len=64, device="cpu").next()
        with OC.counting() as c:
            step(model, opt, batch)
        assert c.flops["dense"] == OC.expected_flops(cfg, shape)["dense"]
        counted[policy] = c
    full, dots = counted["full"], counted["dots"]
    # only the blocks' forward products are no longer recomputed
    assert full.flops["dense"] - dots.flops["dense"] == 2 * TA.param_counts(
        cfg)["backbone_active"] * OC.padded_rows(2 * 64)
    assert dots.flops["attention"] == full.flops["attention"] > 0
    assert dots.flops["other"] == full.flops["other"] > 0
    assert dots.matmul_bytes < full.matmul_bytes


def test_unknown_remat_policy_is_refused():
    from repro_torch.configs.registry import get_config
    from repro_torch.models import init_model, loss_fn
    cfg = get_config("phi3-mini-3.8b", smoke=True, remat_policy="offload")
    model = init_model(cfg, seed=0, device="cpu")
    model.requires_grad_(True)
    tokens = torch.zeros((1, 9), dtype=torch.long)
    with pytest.raises(ValueError, match="unknown remat_policy 'offload'"):
        loss_fn(model, {"tokens": tokens}, cfg)


# ---------------------------------------------------------------------------
# Four gloo ranks: the sharded step under dots
# ---------------------------------------------------------------------------

def _sharded_steps(steps=2):
    """Rank side: whisper-smoke under ``fsdp`` and ``dots`` on (data=2,
    model=2), the unsharded step and the sharded one from seed 0 on the
    same batches."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import DataPipeline, SyntheticSource
    from repro_torch.launch import sharding as SH
    from repro_torch.launch import steps as ST
    from repro_torch.models import init_model
    from repro_torch.optim.optimizer import (AdamWConfig, init_opt_state,
                                             train_params)
    opt_cfg = AdamWConfig(warmup_steps=1, total_steps=10)
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    cfg = get_config("whisper-large-v3", smoke=True, parallelism="fsdp",
                     remat_policy="dots")

    def run(sharded):
        model = init_model(cfg, seed=0, device="cpu")
        if sharded:
            model = SH.shard_model(model, mesh)
            opt = init_opt_state(dict(model.named_parameters()))
            step = ST.shard_train_step(cfg, mesh, opt_cfg)
        else:
            opt = init_opt_state(train_params(model))
            step = ST.make_train_step(cfg, opt_cfg)
        pipe = DataPipeline(
            SyntheticSource(cfg.vocab_size, seed=0), batch=4, seq_len=16,
            device="cpu", mesh=mesh if sharded else None,
            parallelism=cfg.parallelism,
            frontend_shape=(cfg.n_frontend_tokens, cfg.frontend_dim))
        losses = []
        for _ in range(steps):
            opt, m = step(model, opt, pipe.next())
            losses.append(float(m["loss"]))
        params = {n: (p.full_tensor() if sharded else p).detach()
                  for n, p in model.named_parameters()}
        return losses, params
    ref, ref_p = run(False)
    got, got_p = run(True)
    return {"losses": (ref, got),
            "param_err": max(float((got_p[n] - p).abs().max())
                             for n, p in ref_p.items())}


def _worker(rank, port, q_in, q_out):
    torch.set_num_threads(1)
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=WORLD)
    try:
        out = (rank, True, _sharded_steps(**q_in.get()))
    except Exception:  # noqa: BLE001 — reported to the test
        out = (rank, False, traceback.format_exc())
    q_out.put(out)
    dist.destroy_process_group()


def test_sharded_dots_step_over_four_gloo_ranks():
    from repro_torch.launch.mesh import free_port
    ctx = mp.get_context("spawn")
    port = free_port()
    q_out = ctx.Queue()
    qs = [ctx.Queue() for _ in range(WORLD)]
    procs = [ctx.Process(target=_worker, args=(r, port, qs[r], q_out),
                         daemon=True) for r in range(WORLD)]
    for p in procs:
        p.start()
    try:
        for q in qs:
            q.put({})
        got = {}
        for _ in range(WORLD):
            rank, ok, out = q_out.get(timeout=TIMEOUT)
            if not ok:
                raise AssertionError(f"rank {rank} failed:\n{out}")
            got[rank] = out
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
    ref, sharded = got[0]["losses"]
    for want, have in zip(ref, sharded, strict=True):
        assert abs(want - have) <= 1e-5, (ref, sharded)
    assert got[0]["param_err"] <= 3e-5, got[0]["param_err"]
