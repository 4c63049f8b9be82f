"""Dry-run (``repro.launch.dryrun``): every (architecture × input shape)
cell on the production mesh, run on meta tensors over a fake process
group, with its per-device memory, counted costs, collectives and
roofline terms.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-7b \\
        --shape decode_32k [--multi-pod] [--all] [--archs a,b] \\
        [--attention-impl ita] [--out results.jsonl]

``main()`` starts a ``"fake"`` process group (``torch.testing``'s
``FakeStore``) of 256 ranks, or 512 with ``--multi-pod``, and builds the
production mesh over it; this process is rank 0. Each cell places a
meta-device model, optimizer state, caches and batch by the rules of
``launch.sharding`` and runs the cell's sharded step (``launch.steps``)
once under ``roofline.op_costs``: nothing is allocated and the
collectives move nothing, but every shape, placement and collective of
the step is exercised. A sharding mismatch fails here.

A record (the reference's schema): ``arch``, ``shape``, ``mesh``,
``kind``, ``status``, ``step_s`` (host seconds of the meta step),
``memory`` (per-device bytes of the arguments and outputs, summed over
their local shards, and ``temp_bytes``, the peak of the step's live
intermediate storages as the dispatcher creates them, each until the
last tensor holding it is freed), ``cost`` (counted FLOPs, the int8
share, the HBM-byte proxy, the kernels' ops), ``collectives`` (operand
bytes and calls by kind) and ``roofline`` (``Roofline.row()`` at the
H100's peaks with ``coll_bytes`` over NVLink and ``chips`` the mesh
size). The exit code is 1 if any cell fails.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs.base import SHAPES
from repro_torch.configs.registry import ARCH_IDS, cells, get_config
from repro_torch.launch import sharding as SH
from repro_torch.launch import steps as ST
from repro_torch.launch.mesh import axis_sizes, make_production_mesh
from repro_torch.roofline import analysis as RA
from repro_torch.roofline.op_costs import counting


@contextlib.contextmanager
def fake_world(world: int):
    """A fake default process group of ``world`` ranks (this process is
    rank 0), destroyed after the block."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _storage(t):
    return t.untyped_storage()._cdata


class LiveBytes(TorchDispatchMode):
    """The peak bytes of the storages ops create while it is on: each
    fresh output's storage counted until the last tensor seen holding it
    is freed (the output, or a view, detach or in-place result of it: a
    selective checkpoint keeps a detached alias of the products it saves
    after the product itself is gone). Storages the mode did not see
    created (parameters, the batch) are not counted."""

    def __init__(self):
        super().__init__()
        self.live = 0
        self.peak = 0
        self.holders = {}           # storage -> [bytes, tensors alive]

    def _drop(self, key):
        held = self.holders[key]
        held[1] -= 1
        if held[1] == 0:
            self.live -= held[0]
            del self.holders[key]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        seen = {_storage(a) for a in args if torch.is_tensor(a)}
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if not torch.is_tensor(t):
                continue
            key = _storage(t)
            held = self.holders.get(key)
            if held is None:
                if t._base is not None or key in seen:
                    continue        # an alias of an uncounted storage
                held = self.holders[key] = [
                    t.untyped_storage().nbytes(), 0]
                self.live += held[0]
            held[1] += 1
            weakref.finalize(t, self._drop, key)
        self.peak = max(self.peak, self.live)
        return out


def local_bytes(tree) -> int:
    """Bytes of the local shards of the tensors of ``tree``."""
    leaves = tree.values() if isinstance(tree, dict) \
        else ST.tree_leaves(tree)
    total = 0
    for t in leaves:
        t = t.to_local() if hasattr(t, "to_local") else t
        total += t.numel() * t.element_size()
    return total


def _place(tree, shardings):
    return ST.map_pairs(lambda _, t, s: SH.place(t, s), tree, shardings)


def run_cell(arch: str, shape_name: str, mesh, overrides: dict | None = None,
             verbose: bool = True, cfg=None, shape=None) -> dict:
    """One cell's record (module docstring) on ``mesh`` (``cfg``,
    ``shape``: a config and shape in place of the registry's)."""
    cfg = cfg or get_config(arch, **(overrides or {}))
    shape = shape or SHAPES[shape_name]
    sizes = axis_sizes(mesh)
    rec = {"arch": arch, "shape": shape_name,
           "mesh": "x".join(str(n) for n in sizes.values()),
           "kind": shape.kind, "status": "ok"}
    try:
        model = SH.shard_model(ST.meta_model(cfg), mesh, cfg.parallelism)
        sh = ST.cell_shardings(cfg, shape, mesh)
        specs = ST.input_specs(cfg, shape)
        step = ST.shard_cell(cfg, shape, mesh)
        params = dict(model.named_parameters())
        t0 = time.perf_counter()
        if shape.kind == "train":
            from repro_torch.optim.optimizer import init_opt_state
            opt = init_opt_state(params)
            batch = _place(specs["batch"], sh["batch"])
            args = local_bytes(params) + local_bytes(opt) \
                + local_bytes(batch)
            with counting() as costs, LiveBytes() as live:
                opt, metrics = step(model, opt, batch)
            outs = local_bytes(params) + local_bytes(opt) \
                + local_bytes(metrics)
        else:
            inputs = {k: _place(specs[k], sh[k]) for k in specs}
            args = local_bytes(params) + sum(local_bytes(v)
                                             for v in inputs.values())
            with counting() as costs, LiveBytes() as live:
                logits, caches = step(model, **inputs)
            outs = local_bytes([logits, caches])
        rec["step_s"] = time.perf_counter() - t0
        chips = 1
        for n in sizes.values():
            chips *= n
        roof = costs.roofline(RA.model_flops(cfg, shape), chips=chips)
        rec["memory"] = {"argument_bytes": args, "output_bytes": outs,
                         "temp_bytes": live.peak,
                         "peak_bytes": args + outs + live.peak}
        rec["cost"] = {"flops": roof.flops, "flops_int8": roof.flops_int8,
                       "hbm_bytes": roof.hbm_bytes,
                       "kernel_ops": float(sum(costs.kernel_ops.values())),
                       "matmul_flops": costs.matmul_flops}
        rec["collectives"] = {"bytes": dict(costs.coll_bytes),
                              "counts": dict(costs.coll_calls),
                              "total_bytes": roof.coll_bytes}
        rec["roofline"] = roof.row()
        if verbose:
            print(f"[{rec['mesh']}] {arch} × {shape_name}: args "
                  f"{args / 2**30:.2f} GiB/dev, temp "
                  f"{live.peak / 2**30:.2f} GiB/dev, flops/dev "
                  f"{roof.flops:.3e}, coll {roof.coll_bytes:.3e} B, useful "
                  f"{roof.useful_ratio:.2f}, bottleneck={roof.bottleneck} "
                  f"({rec['step_s']:.1f} s)", flush=True)
    except Exception as e:  # noqa: BLE001 — the dry-run reports failures
        rec["status"] = "fail"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
        if verbose:
            print(f"[{rec['mesh']}] {arch} × {shape_name}: FAIL "
                  f"{rec['error']}", flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="run every (arch × shape) cell")
    ap.add_argument("--archs", default=None,
                    help="comma-separated arch filter for --all")
    ap.add_argument("--attention-impl", default=None,
                    choices=["float", "ita", "ibert"])
    ap.add_argument("--out", default=None, help="append JSONL here")
    args = ap.parse_args(argv)
    if not args.all and not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --all")

    overrides = {}
    if args.attention_impl:
        overrides["attention_impl"] = args.attention_impl
    todo = cells() if args.all else [(args.arch, args.shape)]
    if args.archs:
        keep = set(args.archs.split(","))
        todo = [(a, s) for a, s in todo if a in keep]
    results = []
    with fake_world(512 if args.multi_pod else 256):
        mesh = make_production_mesh(multi_pod=args.multi_pod,
                                    device_type="cpu")
        for arch, shape_name in todo:
            rec = run_cell(arch, shape_name, mesh, overrides)
            results.append(rec)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps(rec) + "\n")
    n_ok = sum(r["status"] == "ok" for r in results)
    print(f"\n{n_ok}/{len(results)} cells OK")
    if n_ok < len(results):
        raise SystemExit(1)


if __name__ == "__main__":
    main()
