"""The port's sharded steps over four ranks on the CPU (gloo), against
the same steps unsharded.

Four worker processes are spawned once for the module (one thread each)
and joined in a gloo group; a test sends every rank one task and reads
rank 0's answer. Each rank builds the same smoke model from seed 0 and
runs both the unsharded step and the sharded one (``launch.sharding``,
``launch.steps``) on the meshes (data=2, model=2) and (data=1, model=4).

Tolerances: float32 smoke models; the sharded products sum in another
order (row-parallel all-reduces, the vocabulary-parallel cross entropy),
so logits are held within 1e-4 absolutely and greedy tokens exactly.
The train step's loss within 1e-5 and its gradient norm within 1e-5
relatively; every parameter after AdamW within a tenth of the learning
rate (AdamW's normalization moves a near-zero gradient's element by up
to the learning rate whatever its last bits). ``compressed_psum``
within 1e-6 of the reference's formula (its dequantized terms are
exact; only the order of their sum differs).
A checkpoint saved on one mesh and restored on another is bit-identical.
"""

from __future__ import annotations

import multiprocessing as mp
import traceback

import numpy as np
import pytest
import torch

WORLD = 4
GEN = 4
TIMEOUT = 240


# ---------------------------------------------------------------------------
# The rank side
# ---------------------------------------------------------------------------

def _mesh(shape):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh("cpu", tuple(shape),
                            mesh_dim_names=("data", "model"))


def _cfg(arch, **over):
    from repro_torch.configs.registry import get_config
    return get_config(arch, smoke=True, **over)


def _prompts(cfg, b, s, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s))
                            .astype(np.int64))


def _generate(cfg, prompts, mesh=None):
    """Prefill logits (B, 1, V) and GEN greedy tokens, through the
    unsharded steps or (``mesh``) ``shard_cell``'s."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import sharding as SH
    from repro_torch.launch import steps as ST
    from repro_torch.models import init_caches, init_model
    b, s = prompts.shape
    max_len = s + GEN
    model = init_model(cfg, seed=0, device="cpu")
    caches = init_caches(cfg, b, max_len, device="cpu")
    pos = torch.full((b,), s, dtype=torch.int32)
    if mesh is None:
        with torch.no_grad():
            logits, caches = ST.make_prefill_step(cfg)(model, prompts,
                                                       caches)
            first = logits
            toks = []
            for i in range(GEN):
                tok = torch.argmax(logits[:, -1:], dim=-1)
                toks.append(tok)
                logits, caches = ST.make_decode_step(cfg)(
                    model, tok, caches, pos + i)
        return first, torch.cat(toks, dim=1)
    SH.shard_model(model, mesh)
    prefill = ST.shard_cell(cfg, ShapeConfig("p", s, b, "prefill"), mesh)
    decode = ST.shard_cell(cfg, ShapeConfig("d", max_len, b, "decode"),
                           mesh)
    csh = SH.cache_shardings(caches, b, mesh)
    caches = ST.map_pairs(lambda _, t, sh: SH.place(t, sh), caches, csh)

    def place_batch(t):
        return SH.place(t, SH.Sharding(mesh, SH.batch_spec(
            t.shape, mesh, cfg.parallelism)))
    logits, caches = prefill(model, place_batch(prompts), caches)
    first = logits.full_tensor()
    toks = []
    for i in range(GEN):
        tok = torch.argmax(logits.full_tensor()[:, -1:], dim=-1)
        toks.append(tok)
        logits, caches = decode(model, place_batch(tok), caches,
                                pos0=SH.place(pos + i, SH.replicated(mesh)))
    return first, torch.cat(toks, dim=1)


def task_generate(arch, mesh_shape, b=4, s=24, **over):
    cfg = _cfg(arch, **over)
    prompts = _prompts(cfg, b, s)
    want_logits, want_tok = _generate(cfg, prompts)
    got_logits, got_tok = _generate(cfg, prompts, _mesh(mesh_shape))
    return {"err": float((got_logits - want_logits).abs().max()),
            "tokens_equal": bool(torch.equal(got_tok, want_tok)),
            "tokens": got_tok.tolist()}


def task_train(arch, mesh_shape, steps=2, **over):
    from repro_torch.data.pipeline import DataPipeline, SyntheticSource
    from repro_torch.launch import sharding as SH
    from repro_torch.launch import steps as ST
    from repro_torch.models import init_model
    from repro_torch.optim.optimizer import (AdamWConfig, init_opt_state,
                                             train_params)
    cfg = _cfg(arch, **over)
    opt_cfg = AdamWConfig(warmup_steps=1, total_steps=10)
    mesh = _mesh(mesh_shape)

    def pipe(m):
        return DataPipeline(SyntheticSource(cfg.vocab_size, seed=0), batch=4,
                            seq_len=16, device="cpu", mesh=m,
                            parallelism=cfg.parallelism)
    ref = init_model(cfg, seed=0, device="cpu")
    opt = init_opt_state(train_params(ref))
    step = ST.make_train_step(cfg, opt_cfg)
    p_ref = pipe(None)
    model = SH.shard_model(init_model(cfg, seed=0, device="cpu"), mesh)
    sopt = init_opt_state(dict(model.named_parameters()))
    sstep = ST.shard_train_step(cfg, mesh, opt_cfg)
    p_sh = pipe(mesh)
    losses, norms = [], []
    for _ in range(steps):
        opt, m = step(ref, opt, p_ref.next())
        sopt, sm = sstep(model, sopt, p_sh.next())
        losses.append((float(m["loss"]), float(sm["loss"])))
        norms.append((float(m["grad_norm"]), float(sm["grad_norm"])))
    got = dict(model.named_parameters())
    errs = {n: float((got[n].full_tensor() - p).detach().abs().max())
            for n, p in ref.named_parameters()}
    worst = max(errs, key=errs.get)
    return {"losses": losses, "grad_norms": norms, "param_err": errs[worst],
            "worst": worst}


def task_psum(n=257):
    import torch.distributed as dist

    from repro_torch.runtime.compression import (
        compressed_psum, make_compressed_grad_allreduce)
    mesh = _mesh((1, WORLD))
    rank = dist.get_rank()
    xs = [torch.from_numpy(np.random.default_rng(r).standard_normal(n)
                           .astype(np.float32)) for r in range(WORLD)]
    got = compressed_psum(xs[rank], "model", mesh)
    mean = make_compressed_grad_allreduce(mesh, "model")({"g": xs[rank]})
    return {"got": got.numpy(), "xs": [x.numpy() for x in xs],
            "mean_equal": bool(torch.equal(mean["g"], got / WORLD))}


def task_checkpoint(directory):
    import torch.distributed as dist

    from repro_torch.checkpoint.checkpointing import Checkpointer
    from repro_torch.launch import sharding as SH
    from repro_torch.models import init_model
    cfg = _cfg("qwen2-7b")
    model = SH.shard_model(init_model(cfg, seed=0, device="cpu"),
                           _mesh((2, 2)))
    tree = {n: p.detach() for n, p in model.named_parameters()}
    ckpt = Checkpointer(directory)
    ckpt.save(3, tree, blocking=True)
    dist.barrier()
    full = {n: p.full_tensor() for n, p in tree.items()}
    # (data=1, model=2) over ranks 0 and 1
    from torch.distributed.device_mesh import DeviceMesh
    sub = DeviceMesh("cpu", torch.arange(2).view(1, 2),
                     mesh_dim_names=("data", "model"))
    same = None
    if dist.get_rank() < 2:
        shards = SH.param_shardings(full, sub)
        back, _ = ckpt.restore(full, shardings=shards)
        same = all(torch.equal(back[n].full_tensor(), full[n])
                   for n in full)
    return {"same": same, "full": {n: t.numpy() for n, t in full.items()}}


TASKS = {"generate": task_generate, "train": task_train, "psum": task_psum,
         "checkpoint": task_checkpoint}


def _worker(rank, port, q_in, q_out):
    torch.set_num_threads(1)
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=WORLD)
    while True:
        job = q_in.get()
        if job is None:
            break
        name, kw = job
        try:
            out = (rank, True, TASKS[name](**kw))
        except Exception:  # noqa: BLE001 — reported to the test
            out = (rank, False, traceback.format_exc())
        q_out.put(out)
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# The test side
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ranks():
    from repro_torch.launch.mesh import free_port
    ctx = mp.get_context("spawn")
    port = free_port()
    q_out = ctx.Queue()
    qs = [ctx.Queue() for _ in range(WORLD)]
    procs = [ctx.Process(target=_worker, args=(r, port, qs[r], q_out),
                         daemon=True) for r in range(WORLD)]
    for p in procs:
        p.start()

    def run(name, **kw):
        for q in qs:
            q.put((name, kw))
        got = {}
        for _ in range(WORLD):
            rank, ok, out = q_out.get(timeout=TIMEOUT)
            if not ok:
                raise AssertionError(f"rank {rank} failed:\n{out}")
            got[rank] = out
        return got[0]

    yield run
    for q in qs:
        q.put(None)
    for p in procs:
        p.join(timeout=30)
        if p.is_alive():
            p.kill()


@pytest.mark.parametrize("arch,mesh", [
    ("qwen2-7b", (2, 2)),            # query and K/V heads over model
    ("qwen2-7b", (1, 4)),            # K/V heads do not divide
    ("recurrentgemma-2b", (2, 2)),   # one K/V head: it does not divide
    ("recurrentgemma-2b", (1, 4)),   # the query heads do not divide
    ("olmoe-1b-7b", (2, 2)),         # experts over model
    ("olmoe-1b-7b", (1, 4)),
])
def test_sharded_prefill_and_decode(ranks, arch, mesh):
    got = ranks("generate", arch=arch, mesh_shape=mesh)
    assert got["err"] <= 1e-4, got
    assert got["tokens_equal"], got


def test_sharded_fsdp_and_ita(ranks):
    """``parallelism="fsdp"`` (batch over every axis, ZeRO-3 weights; at
    batch 2 over the data axis only, where a decode step's single MoE
    group spans the data ranks and is gathered) and the ITA integer
    attention (int8 caches, the decode kernel's plain version on the
    local heads)."""
    for b in (4, 2):
        got = ranks("generate", arch="olmoe-1b-7b", mesh_shape=(2, 2),
                    parallelism="fsdp", b=b)
        assert got["err"] <= 1e-4 and got["tokens_equal"], (b, got)
    got = ranks("generate", arch="qwen2-7b", mesh_shape=(2, 2),
                attention_impl="ita")
    assert got["err"] <= 1e-4 and got["tokens_equal"], got


@pytest.mark.parametrize("arch,mesh,over", [
    ("qwen2-7b", (2, 2), {}),
    ("olmoe-1b-7b", (2, 2), {}),
    ("phi3-mini-3.8b", (2, 2), {"parallelism": "fsdp"}),
])
def test_sharded_train_step(ranks, arch, mesh, over):
    got = ranks("train", arch=arch, mesh_shape=mesh, **over)
    for want, have in got["losses"]:
        assert abs(want - have) <= 1e-5, got["losses"]
    for want, have in got["grad_norms"]:     # the gradients' scale
        assert abs(want - have) <= 1e-5 * want, got["grad_norms"]
    # AdamW divides each gradient by its running RMS: an element whose
    # gradient is near zero moves by up to lr whatever its last bits, so
    # the parameters are held within a tenth of the learning rate
    assert got["param_err"] <= 3e-5, got


def test_compressed_psum(ranks):
    got = ranks("psum")
    want = np.zeros_like(got["got"])
    for x in got["xs"]:                      # the reference's formula
        scale = np.float32(max(np.abs(x).max(), np.float32(1e-12))) \
            / np.float32(127)
        q = np.clip(np.round(x / scale), -128, 127).astype(np.int8)
        want += np.float32(scale) * q.astype(np.float32)
    np.testing.assert_allclose(got["got"], want, rtol=0, atol=1e-6)
    assert got["mean_equal"]     # make_compressed_grad_allreduce's mean


def test_checkpoint_across_meshes(ranks, tmp_path):
    """Saved at (2, 2), restored at (1, 2) and at world size 1: the same
    bits."""
    got = ranks("checkpoint", directory=str(tmp_path))
    assert got["same"] is True
    from repro_torch.checkpoint.checkpointing import Checkpointer
    full = {n: torch.from_numpy(a) for n, a in got["full"].items()}
    back, _ = Checkpointer(str(tmp_path)).restore(full)
    for n, t in full.items():
        assert torch.equal(back[n], t), n
