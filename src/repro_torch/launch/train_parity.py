"""One train step of a smoke config on the card against the same step on
the CPU (the plain torch ops), from the same weights and batch: the check
``chip_smoke.py`` phase 12d and ``tests/test_torch_cuda.py`` share.

    from repro_torch.launch.train_parity import train_step_card_vs_cpu
    figs = train_step_card_vs_cpu("phi3-mini-3.8b", "ita")   # raises if off

- ``float``: the loss, nll, grad norm and lr within ``TOL`` (relative;
  the float32 products' order); every parameter after the step held by
  ``hold_params``.
- ``ita`` as is: the loss within ``ITA_LOSS_BOUND``. The QAT output often
  sits on a .5 tie of the ``s_out`` grid and the card sums ``w·v`` in
  another order, so a tie may round the other way.
- ``ita`` with the output's ``s_out`` fake-quant replaced by identity on
  both devices (``output_fake_quant_off``): the loss within ``TOL``, the
  grad norm within ``ITA_NORM_TOL``, every tensor's gradient within
  ``ITA_GRAD_TOL`` of its norm, the QAT scales' ``s_q``/``s_k``
  gradients (the STE backward) within ``SCALE_TOL`` of the CPU's and not
  zero, ``s_v``/``s_out`` exactly zero, and the parameters after the
  step held by ``hold_params``. The STE rounds of ``q/s_q`` and
  ``k/s_k`` meet .5 ties too, and the card's float32 products move
  ``q`` by an ulp: at 2 x 32 tokens no round flips and everything agrees
  within 1e-6 of its scale; at 4 x 512 on an H100 a few integer logits
  differ by one, which moves the gradients by up to 1.4e-3 of a leaf's
  norm, the grad norm by 6e-6 and ``s_q``/``s_k``'s by 1.2e-5 (the
  bounds are about 5-10x these readings).

No fused attention kernel launches in a train step on the card.
"""

from __future__ import annotations

import contextlib

import torch

TOL = 1e-5
ITA_LOSS_BOUND = 5e-3
ITA_NORM_TOL = 1e-4            # relative
ITA_GRAD_TOL = 1e-2            # ||card - CPU|| / ||CPU|| per tensor
# a 0-d scale's gradient is a sum over every Q (K) element of terms that
# cancel to ~1e-2 of their size; absolute, against values of 1e-4..1e-2
SCALE_TOL = 5e-5
OFF_SHARE = 0.01


@contextlib.contextmanager
def output_fake_quant_off():
    """Replace the attention output's ``s_out`` fake-quant (the second of
    each QAT attention call's two; V's is the first, also when remat
    runs the block again in the backward) by identity."""
    from repro_torch.attention import backends
    real = backends._fake_quant
    calls = [0]

    def fake_quant(x, scale):
        calls[0] += 1
        return real(x, scale) if calls[0] % 2 else x
    backends._fake_quant = fake_quant
    try:
        yield
    finally:
        backends._fake_quant = real


def hold_params(cpu_model, card_model, lr, steps=1):
    """Every parameter of ``card_model`` within ``TOL`` of its leaf's
    largest on the CPU, but where a near-zero gradient stepped the other
    way: Adam's first step is about ``sign(g)·lr``, so such an element
    is off by at most ``2·lr`` a step (and its float32 rounding), and
    under ``OFF_SHARE`` of all are. Returns ``(worst relative to scale of the rest, n_off, n)``."""
    n_off = n_all = 0
    worst = 0.0
    for (name, a), b in zip(cpu_model.named_parameters(),
                            card_model.parameters()):
        a = a.detach().float()
        d = (b.detach().float().cpu() - a).abs()
        scale = max(a.abs().max().item(), 1e-30)
        if d.max().item() > TOL * scale + 2 * lr * steps * (1 + TOL):
            raise AssertionError(f"{name} off by {d.max().item()}")
        off = d > TOL * scale
        n_off += int(off.sum())
        n_all += d.numel()
        rest = d[~off]
        if rest.numel():
            worst = max(worst, rest.max().item() / scale)
    if n_off > OFF_SHARE * n_all:
        raise AssertionError(f"{n_off} of {n_all} parameters off")
    return worst, n_off, n_all


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


def _step(cfg, device, tokens, lr, seed):
    """The model from ``seed`` (made on the CPU, moved to ``device``),
    its gradients of one ``loss_fn`` and the model after one
    ``make_train_step`` step from the same start."""
    from repro_torch.kernels.ita_attention import kernel as K
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import init_model, loss_fn
    from repro_torch.optim.optimizer import (AdamWConfig, init_opt_state,
                                             train_params)
    model = init_model(cfg, seed=seed, device="cpu").to(device)
    params = train_params(model)
    K.reset_launches()
    loss, _ = loss_fn(model, {"tokens": tokens.to(device)}, cfg)
    loss.backward()
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
             .detach().float().cpu() for n, p in params.items()}
    for p in params.values():
        p.grad = None
    step = make_train_step(cfg, AdamWConfig(lr=lr, warmup_steps=1,
                                            total_steps=4))
    _, m = step(model, init_opt_state(params), {"tokens": tokens.to(device)})
    if any(K.LAUNCHES.values()):
        raise AssertionError(f"fused kernels launched in a train step: "
                             f"{dict(K.LAUNCHES)}")
    return model, grads, {k: float(v) for k, v in m.items()}


def train_step_card_vs_cpu(arch, impl, *, device="cuda", lr=1e-3,
                           batch=2, seq=32, seed=0):
    """Hold one train step of ``arch``'s smoke config under ``impl`` on
    ``device`` to the CPU's (module docstring); raises
    ``AssertionError`` where they differ. Returns the figures compared."""
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import SyntheticSource
    cfg = get_config(arch, smoke=True, attention_impl=impl)
    tokens = torch.from_numpy(SyntheticSource(cfg.vocab_size, seed=seed)
                              .window(0, batch * (seq + 1))
                              ).view(batch, seq + 1)
    runs = {dev: _step(cfg, dev, tokens, lr, seed)
            for dev in ("cpu", device)}
    (cm, _, cpu), (gm, _, card) = runs["cpu"], runs[device]
    figs = {"loss": card["loss"], "cpu_loss": cpu["loss"],
            "loss_rel": _rel(card["loss"], cpu["loss"]),
            "grad_norm": card["grad_norm"], "cpu_grad_norm": cpu["grad_norm"]}
    if impl != "ita":
        for k in ("loss", "nll", "grad_norm", "lr"):
            if _rel(card[k], cpu[k]) > TOL:
                raise AssertionError(f"{impl} {k}: card {card[k]} vs CPU "
                                     f"{cpu[k]}")
        figs["worst_param"], figs["n_off"], figs["n_params"] = \
            hold_params(cm, gm, lr)
        return figs
    if figs["loss_rel"] > ITA_LOSS_BOUND:
        raise AssertionError(f"ita loss: card {card} vs CPU {cpu}")
    # the QAT backward, with the tie-prone output fake-quant off
    with output_fake_quant_off():
        runs = {dev: _step(cfg, dev, tokens, lr, seed)
                for dev in ("cpu", device)}
    (cm, cg, cpu), (gm, gg, card) = runs["cpu"], runs[device]
    for k, tol in (("loss", TOL), ("grad_norm", ITA_NORM_TOL)):
        if _rel(card[k], cpu[k]) > tol:
            raise AssertionError(f"ita without s_out {k}: card {card[k]} "
                                 f"vs CPU {cpu[k]}")
    worst_grad = worst_scale = 0.0
    for name, want in cg.items():
        got = gg[name]
        err = (got - want).abs().max().item()
        if name.endswith(("s_v", "s_out")):
            if got.abs().max().item() or want.abs().max().item():
                raise AssertionError(f"{name}: gradient not zero")
        elif name.endswith(("s_q", "s_k")):
            if err > SCALE_TOL or not got.item():
                raise AssertionError(f"{name}: gradient {got.item()} vs "
                                     f"CPU {want.item()}")
            worst_scale = max(worst_scale, err)
        else:
            rel = ((got - want).norm() / want.norm().clamp(min=1e-30)).item()
            if rel > ITA_GRAD_TOL:
                raise AssertionError(f"{name}: gradient off by {rel:.2e} "
                                     f"of its norm")
            worst_grad = max(worst_grad, rel)
    worst, n_off, n_all = hold_params(cm, gm, lr)
    figs.update(
        noq_loss_rel=_rel(card["loss"], cpu["loss"]),
        noq_grad_norm_rel=_rel(card["grad_norm"], cpu["grad_norm"]),
        worst_grad=worst_grad, worst_scale_grad=worst_scale,
        worst_param=worst, n_off=n_off, n_params=n_all)
    return figs


def describe(impl, figs) -> str:
    """One line of the figures ``train_step_card_vs_cpu`` returned."""
    line = (f"{impl}: loss {figs['loss']:.7f} vs {figs['cpu_loss']:.7f} "
            f"(rel {figs['loss_rel']:.2e}), grad norm "
            f"{figs['grad_norm']:.6f} vs {figs['cpu_grad_norm']:.6f}")
    if "noq_loss_rel" in figs:
        line += (f"; without the s_out fake-quant: loss rel "
                 f"{figs['noq_loss_rel']:.2e}, grad norm rel "
                 f"{figs['noq_grad_norm_rel']:.2e}, worst gradient "
                 f"{figs['worst_grad']:.2e} of its norm, s_q/s_k "
                 f"{figs['worst_scale_grad']:.2e}")
    return line + (f"; parameters: {figs['n_off']} of {figs['n_params']} "
                   f"stepped the other way, the rest within "
                   f"{figs['worst_param']:.2e} of their scale")
