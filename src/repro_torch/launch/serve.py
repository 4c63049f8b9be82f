"""Serving launcher of the port: batched prefill, then the decode loop,
with ITA integer attention over int8 KV rings (``repro.launch.serve``
without ``--continuous``).

    python -m repro_torch.launch.serve --arch qwen2-7b --batch 4 \
        --prompt-len 512 --gen 32

Weights are random from ``--seed`` at the full width of the config (bf16
on the card, about 15.2 GB for qwen2-7b); ``--smoke`` takes the narrow
config. Attention is ITA's int8 pipeline (the float and I-BERT impls
come with their backends). Runs on the card; ``--device cpu`` runs the plain versions on the
CPU. ``--ragged`` serves right-padded prompts of random lengths in
[prompt_len/2, prompt_len]. Continuous batching (``--continuous``) comes
with the next slice of the port.
"""

from __future__ import annotations

import argparse

import torch

from repro_torch import attention as ATT
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.device import resolve_device
from repro_torch.models import init_model
from repro_torch.models.attention import make_spec
from repro_torch.runtime.generate import generate


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="qwen2-7b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--attention-backend", default="",
                    choices=[""] + ATT.list_backends(),
                    help="prefer a registry backend at every call site it "
                         "can serve; capability dispatch fills the rest")
    ap.add_argument("--list-backends", action="store_true",
                    help="print every backend's verdict for this arch's "
                         "decode spec, then exit")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ragged", action="store_true")
    ap.add_argument("--eos-id", type=int, default=None,
                    help="pin sequences to pad after this token, stop "
                         "counting them toward tok/s, and stop once all "
                         "finished")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke, attention_impl="ita",
                     attention_backend=args.attention_backend)
    if args.list_backends:
        spec = make_spec(cfg, mode="decode", causal=cfg.causal,
                         window=cfg.window, q_len=1)
        print(f"[serve] decode spec for {cfg.name}: {spec}")
        for name, verdict in ATT.backend_reasons(spec).items():
            mark = "eligible" if verdict is True else f"no — {verdict}"
            print(f"[serve]   {name:20s} {mark}")
        return None

    dev = resolve_device(args.device)
    model = init_model(cfg, seed=args.seed, device=dev)
    gen = torch.Generator(device="cpu")
    gen.manual_seed(args.seed)
    prompts = torch.randint(0, cfg.vocab_size,
                            (args.batch, args.prompt_len), generator=gen)
    lengths = None
    if args.ragged:
        lengths = torch.randint(max(1, args.prompt_len // 2),
                                args.prompt_len + 1, (args.batch,),
                                generator=gen)
    sampler = torch.Generator(device=dev)
    sampler.manual_seed(args.seed)
    res = generate(model, cfg, prompts, args.gen,
                   temperature=args.temperature, generator=sampler,
                   prompt_lengths=lengths, eos_id=args.eos_id,
                   early_exit=args.eos_id is not None, device=dev)

    print(f"[serve] arch={cfg.name} impl={cfg.attention_impl} device={dev}"
          + (" ragged" if args.ragged else ""))
    if lengths is not None:
        print(f"[serve] prompt lengths: {lengths.tolist()}")
    print(f"[serve] prefill {args.batch}x{args.prompt_len} tokens in "
          f"{res.prefill_s * 1e3:.1f} ms")
    print(f"[serve] decoded {res.decode_steps} steps x{args.batch} "
          f"({res.n_decode_tokens} live tokens) in "
          f"{res.decode_s * 1e3:.1f} ms ({res.decode_tok_s:.1f} tok/s)")
    print("[serve] sample:", res.tokens[0, :12].tolist())
    return res


if __name__ == "__main__":
    main()
