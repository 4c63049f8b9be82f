"""End-to-end serving of the PyTorch/CUDA port
(``examples/serve_quantized.py`` in PyTorch): a small LM served with
batched requests through the ITA integer pipeline — int8 KV cache,
integer streaming softmax at prefill, the decode kernel at each step —
beside a float-attention run of the same weights.

    PYTHONPATH=src python examples/serve_quantized_torch.py [--device cpu]
        [--batch 8 --prompt 48 --gen 24]
"""

import argparse
import time

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import init_model
from repro_torch.runtime.generate import generate

CFG_BASE = dict(
    name="serve-demo", family="dense",
    d_model=256, n_heads=8, n_kv_heads=4, head_dim=32,
    d_ff=1024, vocab_size=2048,
    layer_groups=((("attn",), 4),),
    tie_embeddings=True, dtype="float32",
)

def serve(model, cfg, prompts, gen):
    t0 = time.perf_counter()
    res = generate(model, cfg, prompts, gen, device=model.embed.device)
    return res.tokens, time.perf_counter() - t0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt", type=int, default=48)
    ap.add_argument("--gen", type=int, default=24)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg_f = ModelConfig(**CFG_BASE)
    cfg_q = ModelConfig(**{**CFG_BASE, "attention_impl": "ita"})
    model_f = init_model(cfg_f, seed=0, device=dev)
    model_q = init_model(cfg_q, seed=0, device=dev)  # + the QAT scales
    prompts = torch.randint(0, cfg_f.vocab_size, (args.batch, args.prompt),
                            generator=torch.Generator().manual_seed(0))
    out_f, t_f = serve(model_f, cfg_f, prompts, args.gen)
    out_q, t_q = serve(model_q, cfg_q, prompts, args.gen)

    agree = float((out_f == out_q).float().mean())
    kv_f = cfg_f.n_kv_heads * cfg_f.head_dim * 2 * 4
    kv_q = cfg_f.n_kv_heads * cfg_f.head_dim * 2 * 1
    print(f"[serve] batch={args.batch} prompt={args.prompt} gen={args.gen} "
          f"on {dev}")
    print(f"[serve] float attention: {t_f * 1e3:.0f} ms; ITA integer "
          f"attention: {t_q * 1e3:.0f} ms (first calls, indicative)")
    print(f"[serve] greedy-token agreement float vs ITA-int8: {agree:.2%} "
          "(random weights: near-uniform logits)")
    print(f"[serve] KV cache bytes/token/layer: float32 {kv_f} -> int8 "
          f"{kv_q} (4x smaller)")
    print("[serve] sample (ITA):", out_q[0, :12].tolist())


if __name__ == "__main__":
    main()
