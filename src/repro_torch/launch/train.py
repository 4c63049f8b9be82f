"""Training launcher (``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch phi3-mini-3.8b \
        --smoke --device cpu --steps 4 --batch 2 --seq 16 \
        [--attention-impl ita] [--ckpt-dir DIR] [--resume]

Random weights from ``--seed``, synthetic tokens from the same seed,
AdamW with a warmup of ``min(100, steps // 10 + 1)`` steps, checkpoints
every ``--ckpt-every`` steps and at the end (``TrainDriver``).
``--device`` defaults to the card; the CPU runs only when asked.

Sharded, under ``torchrun`` (one process a card; gloo on the CPU):

    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --arch qwen2-7b --smoke --device cpu --host-mesh --batch 4

``--host-mesh`` trains on ``make_host_mesh()`` over the ranks that exist,
``--multi-pod`` on the (pod=2, data=16, model=16) production mesh (512
ranks; without it and without ``--host-mesh`` the run is the unsharded
one of one device). The parameters are sharded by ``shard_model``, the
step is ``shard_train_step``, the batches DTensors of the global batch,
and a checkpoint restores onto whatever mesh the resumed run has.
"""

from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.data.pipeline import DataPipeline, SyntheticSource
from repro_torch.device import resolve_device
from repro_torch.launch import sharding as SH
from repro_torch.launch.mesh import (init_distributed, make_host_mesh,
                                     make_production_mesh)
from repro_torch.launch.steps import make_train_step, shard_train_step
from repro_torch.models import init_model
from repro_torch.optim.optimizer import (AdamWConfig, init_opt_state,
                                         train_params)
from repro_torch.runtime.fault_tolerance import FTConfig, TrainDriver


def build(args):
    """``(cfg, model, opt_state, step, pipeline, shardings)``;
    ``shardings`` the ``TrainDriver``'s keyword arguments (empty
    unsharded)."""
    cfg = get_config(args.arch, smoke=args.smoke,
                     **({"attention_impl": args.attention_impl}
                        if args.attention_impl else {}))
    mesh = None
    if args.host_mesh or args.multi_pod:
        init_distributed(args.device)
        mesh = (make_host_mesh(device_type=args.device) if args.host_mesh
                else make_production_mesh(multi_pod=True,
                                          device_type=args.device))
    dev = resolve_device(args.device)
    opt_cfg = AdamWConfig(lr=args.lr, total_steps=args.steps,
                          warmup_steps=min(100, args.steps // 10 + 1))
    model = init_model(cfg, seed=args.seed, device=dev)
    shardings = {}
    if mesh is None:
        step = make_train_step(cfg, opt_cfg)
        opt_state = init_opt_state(train_params(model))
    else:
        SH.shard_model(model, mesh)
        step = shard_train_step(cfg, mesh, opt_cfg)
        params = dict(model.named_parameters())
        opt_state = init_opt_state(params)
        shardings = dict(param_shardings=SH.param_shardings(
            params, mesh, cfg.parallelism), opt_shardings=SH.
            opt_state_shardings(params, mesh, cfg.parallelism,
                                has_master=opt_state.master is not None))
    pipe = DataPipeline(
        SyntheticSource(cfg.vocab_size, seed=args.seed),
        batch=args.batch, seq_len=args.seq, device=dev,
        frontend_shape=((cfg.n_frontend_tokens, cfg.frontend_dim)
                        if cfg.frontend_dim else None),
        mesh=mesh, parallelism=cfg.parallelism)
    return cfg, model, opt_state, step, pipe, shardings


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="qwen2-7b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--host-mesh", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--attention-impl", default=None,
                    choices=["float", "ita", "ibert"])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    args = ap.parse_args(argv)

    cfg, model, opt_state, step, pipe, shardings = build(args)
    ft = FTConfig(ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every)
    driver = TrainDriver(ft, step, model, opt_state, pipe, **shardings)
    if args.resume and driver.maybe_restore():
        print(f"[train] resumed from step {driver.step}")
    metrics = driver.run(args.steps, log_every=args.log_every)
    loss = float(metrics["loss"]) if metrics else float("nan")
    print(f"[train] done: {cfg.name} step {driver.step}, loss {loss:.4f}, "
          f"stragglers {driver.straggler_events}")
    return driver


if __name__ == "__main__":
    main()
