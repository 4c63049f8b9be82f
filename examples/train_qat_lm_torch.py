"""QAT training with the PyTorch/CUDA port (``examples/train_qat_lm.py``
in PyTorch), on ``make_host_mesh()``.

Trains a small causal LM on synthetic data twice, once with the ITA QAT
forward (straight-through floored base-2 softmax, fake-quantized Q/K)
and once with float attention, each sharded over the host mesh with
``shard_train_step``; then evaluates the QAT weights through the integer
prefill and reports the gap.

    PYTHONPATH=src python examples/train_qat_lm_torch.py [--device cpu]
    PYTHONPATH=src torchrun --nproc-per-node 4 \\
        examples/train_qat_lm_torch.py --device cpu

Alone the mesh has one rank; under ``torchrun`` it spans the ranks
(data × model, model 2 when the world size is even).
"""

import argparse

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import DataPipeline, SyntheticSource
from repro_torch.launch import sharding as SH
from repro_torch.launch.mesh import init_distributed, make_host_mesh
from repro_torch.launch.steps import shard_train_step
from repro_torch.models import forward, init_caches, init_model
from repro_torch.optim.optimizer import AdamWConfig, init_opt_state

BASE = dict(
    name="qat-demo", family="dense",
    d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
    d_ff=512, vocab_size=512,
    layer_groups=((("attn",), 2),),
    tie_embeddings=True, dtype="float32",
)


def train(cfg, steps, mesh, dev, log, seed=0):
    model = SH.shard_model(init_model(cfg, seed=seed, device=dev), mesh)
    opt = init_opt_state(dict(model.named_parameters()))
    step = shard_train_step(cfg, mesh, AdamWConfig(
        lr=1e-3, total_steps=steps, warmup_steps=min(20, steps)))
    pipe = DataPipeline(SyntheticSource(cfg.vocab_size, seed=1), batch=8,
                        seq_len=64, device=dev, mesh=mesh)
    loss = None
    for i in range(steps):
        opt, m = step(model, opt, pipe.next())
        loss = float(m["loss"])
        if (i + 1) % 50 == 0:
            log(f"  step {i + 1}: loss {loss:.4f}")
    return SH.gather_params(model), loss, pipe


def integer_loss(cfg, model, pipe):
    """Cross entropy of one batch through the integer prefill (the int8
    serve path) of the QAT-trained weights."""
    toks = pipe.next()["tokens"].full_tensor()
    caches = init_caches(cfg, toks.shape[0], toks.shape[1],
                         device=toks.device)
    with torch.no_grad():
        logits, _ = forward(model, toks[:, :-1], cfg, mode="prefill",
                            caches=caches)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, toks[:, 1:, None].long())[..., 0]
    return float((logz - gold).mean())


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--steps", type=int, default=200)
    args = ap.parse_args(argv)
    init_distributed(args.device)
    import torch.distributed as dist
    mesh = make_host_mesh(device_type=args.device)
    dev = torch.device(args.device, torch.cuda.current_device()) \
        if args.device == "cuda" else torch.device("cpu")

    def log(msg):
        if dist.get_rank() == 0:
            print(msg, flush=True)
    log(f"[qat] mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))} on "
        f"{args.device}")
    log("[qat] training with ITA QAT attention (STE integer semantics)")
    cfg_q = ModelConfig(**{**BASE, "attention_impl": "ita"})
    model_q, loss_q, pipe = train(cfg_q, args.steps, mesh, dev, log)
    int_loss = integer_loss(cfg_q, model_q, pipe)
    log("[qat] training with float attention (baseline)")
    _, loss_f, _ = train(ModelConfig(**BASE), args.steps, mesh, dev, log)
    log(f"[qat] float-trained train loss:   {loss_f:.4f}")
    log(f"[qat] QAT-trained train loss:     {loss_q:.4f}")
    log(f"[qat] QAT model on INT serve path: {int_loss:.4f} "
        f"(gap {int_loss - loss_q:+.4f})")
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
