"""Serving launcher of the port (``repro.launch.serve``): batched
prefill, then the decode loop, with ITA integer attention over int8 KV
rings — or, with ``--continuous``, the continuous-batching server over
the paged int8 pool.

    python -m repro_torch.launch.serve --arch qwen2-7b --batch 4 \
        --prompt-len 512 --gen 32
    python -m repro_torch.launch.serve --arch qwen2-7b --continuous \
        --batch 4 --requests 16 --prompt-len 512 --gen 32
    python -m repro_torch.launch.serve --arch gemma2-27b --batch 4 \
        --prompt-len 512 --gen 32
    python -m repro_torch.launch.serve --arch rwkv6-7b --batch 4 \
        --prompt-len 512 --gen 32
    python -m repro_torch.launch.serve --arch whisper-large-v3 --batch 4 \
        --prompt-len 192 --gen 64 --attention-impl ita \
        --attention-backend ita_onepass_pallas

Weights are random from ``--seed`` at the full width of the config (bf16
on the card, about 15.2 GB for qwen2-7b and rwkv6-7b, 5.4 GB for
recurrentgemma-2b and 54.4 GB for gemma2-27b); ``--smoke`` takes the
narrow config. The recurrent archs (``recurrentgemma-2b``,
``rwkv6-7b``) run ``generate()`` on rings or ``--paged``; like the JAX
package, ``--continuous`` refuses them and ``--ragged`` too. The
encoder–decoder archs (``whisper-large-v3``; ``llama-3.2-vision-90b``,
about 180 GB at full width, more than one card) take a random frontend
of (batch, n_frontend_tokens, frontend_dim) drawn from the seed's
generator, as the JAX CLI draws one; ``--continuous`` refuses them as
the JAX package does. At 1500 and 1601 frames the unpinned ITA decode
raises in both packages (its cross cache is no multiple of the 128-key
tile): pin ``--attention-backend ita_onepass_pallas``.
``--attention-impl`` picks the attention arithmetic: ``ita`` (the
default; ITA's int8 pipeline), ``ibert`` (I-BERT's integer softmax on
the same int8 pipeline) or
``float`` (the float softmax over bf16 caches), the paper's baselines.
Runs on the card; ``--device cpu`` runs the plain versions on the CPU.
``--ragged`` serves right-padded prompts of random lengths in
[prompt_len/2, prompt_len]; ``--paged`` swaps the rings for the shared
paged pool (equal tokens); ``--loop stepwise`` runs the decode step's
ops eagerly in place of replaying it from a CUDA graph (``fused``, the
default; equal tokens).

``--continuous`` serves an arrival trace built as the JAX CLI builds it
(Poisson arrivals at ``--rate`` per decode step, prompt lengths in
[prompt_len/2, prompt_len], ``gen`` in [gen/4, gen]; numpy from
``--seed``) through ``--batch`` slots over the paged pool, admitting by
chunked prefill (``--chunk-size``, ``--token-budget``) between
``--segment``-step segments, and reports sustained tok/s, latency and
TTFT. ``--admission stall`` admits by a stop-the-world prefill into a
ring scratch copied into pool pages (the A/B reference; its stop time is
reported as prefill-stall). ``--system-prompt-len N`` prepends one
shared N-token prefix to every prompt and ``--prefix-sharing`` shares
its pages through the pool; ``--priority-classes N`` draws each
request's SLO class from [0, N), ``--preemption`` evicts lower classes
under pool or slot pressure, ``--overload`` multiplies the arrival rate
and ``--aging-steps`` turns on starvation aging. ``--journal-dir DIR``
journals the serve (a write-ahead log of admissions, emitted tokens and
completions, flushed at every segment boundary) and ``--snapshot-every
N`` snapshots the paged pools and the prefix index every N segments
into ``DIR/snapshots``; after a crash (``kill -9``) the same command
with ``--resume`` finishes the trace with the tokens the serve would
have given uncrashed. With a journal, SIGTERM drains the serve: no more
admissions, in-flight requests finish (or, past ``--drain-timeout``
seconds, stop at the next boundary with their progress journaled), and
``--resume`` serves the rest.
"""

from __future__ import annotations

import argparse
import signal

import numpy as np
import torch

from repro_torch import attention as ATT
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.device import resolve_device
from repro_torch.models import init_model
from repro_torch.models.attention import make_spec
from repro_torch.runtime.generate import (ServeRequest, generate,
                                          serve_continuous)
from repro_torch.runtime.journal import ServeDrain


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="qwen2-7b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--attention-impl", default="ita",
                    choices=["float", "ita", "ibert"])
    ap.add_argument("--attention-backend", default="",
                    choices=[""] + ATT.list_backends(),
                    help="prefer a registry backend at every call site it "
                         "can serve; capability dispatch fills the rest")
    ap.add_argument("--list-backends", action="store_true",
                    help="print every backend's verdict for this arch's "
                         "decode and prefill specs, then exit")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--loop", default="fused", choices=["fused", "stepwise"],
                    help="fused = replay the decode step from a CUDA graph "
                         "(captured once); stepwise = its ops eagerly, "
                         "step by step")
    ap.add_argument("--ragged", action="store_true")
    ap.add_argument("--eos-id", type=int, default=None,
                    help="pin sequences to pad after this token, stop "
                         "counting them toward tok/s, and stop once all "
                         "finished")
    ap.add_argument("--paged", action="store_true",
                    help="allocate the KV caches as shared paged pools "
                         "(PagedKVState) instead of per-sequence rings")
    ap.add_argument("--continuous", action="store_true",
                    help="continuous batching over a Poisson arrival "
                         "trace: --batch slots, paged pool, admission "
                         "between --segment-step segments")
    ap.add_argument("--requests", type=int, default=16,
                    help="trace length for --continuous")
    ap.add_argument("--rate", type=float, default=0.25,
                    help="mean arrivals per decode step for --continuous")
    ap.add_argument("--segment", type=int, default=16,
                    help="decode steps per segment (admission "
                         "granularity) for --continuous")
    ap.add_argument("--page-size", type=int, default=128,
                    help="KV pool page size (tokens per page)")
    ap.add_argument("--admission", default="chunked",
                    choices=["chunked", "stall"],
                    help="chunked = prompts prefill in chunks inside the "
                         "segments, interleaved with decode; stall = a "
                         "stop-the-world ragged prefill into a ring scratch "
                         "copied into pool pages (A/B reference)")
    ap.add_argument("--chunk-size", type=int, default=32,
                    help="prompt tokens prefilling per slot per step "
                         "under --admission chunked")
    ap.add_argument("--token-budget", type=int, default=None,
                    help="per-step token budget of the decode-maximal "
                         "scheduler (default slots - 1 + chunk_size)")
    ap.add_argument("--prefix-sharing", action="store_true",
                    help="share identical page-aligned prompt prefixes "
                         "across requests through the paged pool "
                         "(chunked admission only)")
    ap.add_argument("--system-prompt-len", type=int, default=0,
                    help="prepend one common prefix of this many tokens "
                         "to every --continuous request")
    ap.add_argument("--priority-classes", type=int, default=1,
                    help="SLO classes for --continuous: each request draws "
                         "a class in [0, N) (higher = more urgent); "
                         "per-class p95 TTFT and latency are reported")
    ap.add_argument("--preemption", action="store_true",
                    help="under pool or slot pressure, evict lower-class "
                         "requests, which re-enter the queue carrying "
                         "their generated prefix (equal tokens)")
    ap.add_argument("--overload", type=float, default=1.0,
                    help="multiply --rate by this factor (arrivals faster "
                         "than service exercise --preemption)")
    ap.add_argument("--aging-steps", type=int, default=None,
                    help="starvation aging: a waiting request's class "
                         "grows by one every N virtual steps")
    ap.add_argument("--journal-dir", default=None,
                    help="write-ahead request journal and snapshots here "
                         "(--continuous): admissions, emitted tokens and "
                         "completions are journaled at every segment "
                         "boundary (group commit, bounded fsync lag), so a "
                         "crashed serve resumes with equal tokens under "
                         "--resume")
    ap.add_argument("--snapshot-every", type=int, default=0,
                    help="snapshot the paged pools and the prefix index "
                         "every N segments into <journal-dir>/snapshots "
                         "(0 = off); a usable snapshot warm-starts "
                         "--resume, a corrupt one falls back to a cold "
                         "start from the journal")
    ap.add_argument("--resume", action="store_true",
                    help="replay <journal-dir>/journal.jsonl before "
                         "serving: finished requests return without being "
                         "served twice, unfinished ones resume from their "
                         "last journaled boundary (equal tokens)")
    ap.add_argument("--drain-timeout", type=float, default=None,
                    help="on SIGTERM, stop admitting and let in-flight "
                         "requests finish; after this many seconds stop at "
                         "the next segment boundary with their progress "
                         "journaled for --resume")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke,
                     attention_impl=args.attention_impl,
                     attention_backend=args.attention_backend)
    if args.list_backends:
        for mode, q_len in (("decode", 1), ("prefill", args.prompt_len)):
            spec = make_spec(cfg, mode=mode, causal=cfg.causal,
                             window=cfg.window, q_len=q_len)
            print(f"[serve] {mode} spec for {cfg.name}: {spec}")
            for name, verdict in ATT.backend_reasons(spec).items():
                mark = "eligible" if verdict is True else f"no — {verdict}"
                print(f"[serve]   {name:20s} {mark}")
        return None

    dev = resolve_device(args.device)
    model = init_model(cfg, seed=args.seed, device=dev)
    if args.continuous:
        return _continuous(args, cfg, model, dev)
    gen = torch.Generator(device="cpu")
    gen.manual_seed(args.seed)
    prompts = torch.randint(0, cfg.vocab_size,
                            (args.batch, args.prompt_len), generator=gen)
    lengths = None
    if args.ragged:
        lengths = torch.randint(max(1, args.prompt_len // 2),
                                args.prompt_len + 1, (args.batch,),
                                generator=gen)
    frontend = None
    if cfg.frontend_dim:
        frontend = torch.randn((args.batch, cfg.n_frontend_tokens,
                                cfg.frontend_dim), generator=gen)
    sampler = torch.Generator(device=dev)
    sampler.manual_seed(args.seed)
    res = generate(model, cfg, prompts, args.gen, frontend=frontend,
                   temperature=args.temperature, generator=sampler,
                   prompt_lengths=lengths, eos_id=args.eos_id,
                   early_exit=args.eos_id is not None, paged=args.paged,
                   page_size=args.page_size, loop=args.loop, device=dev)

    print(f"[serve] arch={cfg.name} impl={cfg.attention_impl} device={dev}"
          f" loop={args.loop}" + (" ragged" if args.ragged else "")
          + (" paged" if args.paged else ""))
    if lengths is not None:
        print(f"[serve] prompt lengths: {lengths.tolist()}")
    print(f"[serve] prefill {args.batch}x{args.prompt_len} tokens in "
          f"{res.prefill_s * 1e3:.1f} ms")
    print(f"[serve] decoded {res.decode_steps} steps x{args.batch} "
          f"({res.n_decode_tokens} live tokens) in "
          f"{res.decode_s * 1e3:.1f} ms ({res.decode_tok_s:.1f} tok/s)")
    print("[serve] sample:", res.tokens[0, :12].tolist())
    return res


def _continuous(args, cfg, model, dev):
    rng = np.random.default_rng(args.seed)
    rate = max(args.rate, 1e-6) * max(args.overload, 1e-6)
    arrivals = np.cumsum(rng.exponential(1.0 / rate,
                                         args.requests)).astype(int)
    system = rng.integers(0, cfg.vocab_size,
                          args.system_prompt_len).astype(np.int32)
    reqs = [ServeRequest(
        prompt=np.concatenate([system, rng.integers(
            0, cfg.vocab_size, int(rng.integers(
                max(1, args.prompt_len // 2), args.prompt_len + 1))
        ).astype(np.int32)]),
        gen=int(rng.integers(max(2, args.gen // 4), args.gen + 1)),
        arrival=int(t),
        priority=int(rng.integers(0, max(1, args.priority_classes))))
        for t in arrivals]
    drain = old_handler = None
    if args.journal_dir is not None:
        drain = ServeDrain()
        old_handler = signal.signal(signal.SIGTERM,
                                    lambda *_: drain.request())
    try:
        res = serve_continuous(
            model, cfg, reqs, slots=args.batch, segment=args.segment,
            max_len=args.system_prompt_len + args.prompt_len + args.gen,
            page_size=args.page_size, temperature=args.temperature,
            seed=args.seed if args.temperature > 0 else None,
            eos_id=args.eos_id, admission=args.admission,
            chunk_size=args.chunk_size, token_budget=args.token_budget,
            prefix_sharing=args.prefix_sharing, preemption=args.preemption,
            journal_dir=args.journal_dir,
            snapshot_every=args.snapshot_every, resume=args.resume,
            drain=drain, drain_timeout=args.drain_timeout,
            aging_steps=args.aging_steps, device=dev)
    finally:
        if drain is not None:
            signal.signal(signal.SIGTERM, old_handler)
    util = max((u for _, u in res.page_util), default=0.0)
    print(f"[serve] arch={cfg.name} continuous slots={args.batch} "
          f"segment={args.segment} page_size={args.page_size} "
          f"admission={args.admission} chunk={args.chunk_size} "
          f"device={dev}")
    print(f"[serve] {len(res.completed)}/{args.requests} requests, "
          f"{res.steps} steps / {res.segments} segments / "
          f"{res.admission_rounds} admission rounds")
    print(f"[serve] {res.total_tokens} tokens in {res.wall_s:.2f} s "
          f"-> sustained {res.tok_s:.1f} tok/s; latency p50 "
          f"{res.latency_quantile(0.5) * 1e3:.0f} ms p95 "
          f"{res.latency_quantile(0.95) * 1e3:.0f} ms; TTFT p50 "
          f"{res.ttft_quantile(0.5) * 1e3:.0f} ms p95 "
          f"{res.ttft_quantile(0.95) * 1e3:.0f} ms; prefill-stall "
          f"{res.prefill_stall_frac:.0%}; peak page util {util:.0%}")
    if args.prefix_sharing:
        print(f"[serve] prefix sharing: {res.prefix_hits}/"
              f"{len(res.completed)} hits ({res.prefix_hit_rate:.0%}), "
              f"{res.shared_prefix_tokens} prompt tokens adopted from "
              f"shared pages ({res.prefill_tokens} prefilled)")
    if args.journal_dir is not None:
        n_rep = sum(1 for c in res.completed if c.replayed)
        print(f"[serve] journal: dir={args.journal_dir} "
              f"recovered={res.recovered} "
              f"snapshot_restore={res.restored_from_snapshot} "
              f"replayed {n_rep} requests / {res.replayed_tokens} "
              f"tokens, recovery {res.recovery_s * 1e3:.0f} ms, "
              f"snapshot {res.snapshot_bytes / 2**20:.1f} MiB"
              + (" [drained]" if res.drained else ""))
    if args.preemption or args.priority_classes > 1:
        print(f"[serve] preemptions: {res.preemptions}")
        summary = res.class_summary()
        for prio in sorted(summary, reverse=True):
            d = summary[prio]
            aging = (f", aging bound {d['aging_bound_steps']} steps"
                     if "aging_bound_steps" in d else "")
            print(f"[serve]   class {prio}: {d['n']} requests, "
                  f"{d['preemptions']} preemptions, p95 TTFT "
                  f"{d['p95_ttft_s'] * 1e3:.0f} ms, p95 latency "
                  f"{d['p95_latency_s'] * 1e3:.0f} ms, p95 admission delay "
                  f"{d['p95_admit_delay_steps']} steps, max "
                  f"{d['max_admit_delay_steps']}{aging}")
    return res


if __name__ == "__main__":
    main()
