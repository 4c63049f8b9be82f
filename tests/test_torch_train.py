"""The port's optimizer, data pipeline, train step, ``TrainDriver`` and
train CLI against the JAX package, on the CPU.

- ``lr_schedule``, ``clip_by_global_norm`` and ``adamw_update`` on
  identical inputs within ``ULP`` units in the last place of JAX's
  (XLA:CPU's ``cos`` and ``pow`` may differ from torch's in the last
  bit), and what the global norm scales within ``ULP_SCALED``: a leaf's
  sum of squares takes XLA's order in JAX and torch's in the port, so
  the norm may move by 2 ulp and the clipped values by 4; the updated
  parameters and Adam's moments (differences and sums that cancel near
  zero) within ``MOMENT_TOL`` of the leaf's largest: float32
  leaves without a master copy; bf16 leaves with one; 0-d scales without
  weight decay; the port's bf16 storage of float32 parameters
  (``grad_dtype``) against JAX's float32 leaves.
- ``SyntheticSource`` windows equal to JAX's, ``MemmapSource`` over a
  file the test writes, ``DataPipeline`` batches (tokens and the
  frontend stand-in) equal to JAX's and resumed from ``state_dict``.
- Three ``make_train_step`` steps of phi3-smoke (``float``, lr 1e-3,
  warmup 1) against JAX's: losses, grad norms and learning rates within
  ``1e-5``; parameters within ``1e-5`` of their scale except where a
  gradient within rounding of zero stepped the other way — Adam's first
  steps are about ``sign(g)·lr`` — which moves an element by at most
  ``2·lr`` a step and happens to under 1% of them. The same three steps
  in bfloat16 compute, held to the bf16 noise of the gradients
  (``BF16_METRIC_TOL``, ``BF16_STEP``). ``opt_state_from_jax``
  carries JAX's optimizer state across: a port step from JAX's state
  after step 1 equals JAX's step 2 to the same bounds.
- ``TrainDriver``: 6 straight steps equal bit for bit to 3 steps, a
  checkpoint, a restore and 3 more (parameters and optimizer state);
  ``inject_failure_at`` and the restart; the watchdog delegation; a
  ``master=None`` state and a bf16 state with a master round-trip the
  ``Checkpointer``.
- The ``launch.train`` CLI on the CPU with ``--resume``; without
  ``--device`` the train entry points ask for the card.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import registry as JR
from repro.data.pipeline import DataPipeline as JPipeline
from repro.data.pipeline import MemmapSource as JMemmap
from repro.data.pipeline import SyntheticSource as JSynthetic
from repro.launch.mesh import make_host_mesh
from repro.launch.steps import make_train_step as j_make_train_step
from repro.models import init_model as j_init_model
from repro.optim import optimizer as JO
from repro_torch.checkpoint.checkpointing import Checkpointer
from repro_torch.configs import registry as TR
from repro_torch.data.pipeline import DataPipeline, MemmapSource, \
    SyntheticSource
from repro_torch.launch import train as CLI
from repro_torch.launch.steps import make_train_step
from repro_torch.launch.train_parity import hold_params, train_step_card_vs_cpu
from repro_torch.models import from_jax_params, init_model, jax_named_leaves
from repro_torch.optim import optimizer as TO
from repro_torch.optim.optimizer import opt_state_from_jax
from repro_torch.runtime.fault_tolerance import FTConfig, TrainDriver

ULP = 2
ULP_SCALED = 4
MOMENT_TOL = 1e-6
B, S = 2, 16
LR = 1e-3
STEP_TOL = 1e-5


def _ulps(got, want, maxulp=ULP):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    np.testing.assert_array_max_ulp(got, want, maxulp=maxulp)


def _near(got, want, tol=MOMENT_TOL):
    want = np.asarray(want, np.float32)
    assert np.abs(np.asarray(got) - want).max() \
        <= tol * np.abs(want).max()


def _bf16(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


@pytest.mark.parametrize("cfg", [
    JO.AdamWConfig(), JO.AdamWConfig(warmup_steps=1, total_steps=8),
    JO.AdamWConfig(lr=1e-3, warmup_steps=3, total_steps=20,
                   min_lr_frac=0.0)])
def test_lr_schedule_matches_jax(cfg):
    tcfg = TO.AdamWConfig(**dataclasses.asdict(cfg))
    for step in (0, 1, 2, 3, 5, 7, 8, 9, 50, 99, 100, 101, 5000, 9999,
                 10000, 10001):
        want = JO.lr_schedule(cfg, jnp.asarray(step, jnp.int32))
        got = TO.lr_schedule(tcfg, torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        _ulps(got.numpy(), want)


def _tree(rng, shapes):
    return {n: rng.normal(0, 1, s).astype(np.float32)
            for n, s in sorted(shapes.items())}


SHAPES = {"a": (8, 16), "b": (32,), "c": (4, 4, 4), "s": ()}


@pytest.mark.parametrize("max_norm", [1.0, 100.0])
def test_clip_by_global_norm_matches_jax(max_norm):
    grads = _tree(np.random.default_rng(0), SHAPES)
    jc, jn = JO.clip_by_global_norm({n: jnp.asarray(g)
                                     for n, g in grads.items()}, max_norm)
    tc, tn = TO.clip_by_global_norm({n: torch.from_numpy(g)
                                     for n, g in grads.items()}, max_norm)
    _ulps(tn.numpy(), jn)
    for n in grads:
        _ulps(tc[n].numpy(), jc[n], ULP_SCALED)


def _run_adamw(params, grads_seq, cfg, *, bf16=(), store_bf16=()):
    """Three updates in both packages. ``bf16``: leaves both store in
    bf16; ``store_bf16``: leaves the port stores in bf16 over JAX's
    float32 (``grad_dtype=float32``)."""
    jp = {n: jnp.asarray(a, jnp.bfloat16 if n in bf16 else jnp.float32)
          for n, a in params.items()}
    tp = {n: torch.tensor(np.asarray(a, np.float32)).to(
        torch.bfloat16 if n in bf16 or n in store_bf16 else torch.float32)
        for n, a in params.items()}
    js = JO.init_opt_state(jp)
    ts = TO.init_opt_state(tp)
    tcfg = TO.AdamWConfig(**dataclasses.asdict(cfg))
    for grads in grads_seq:
        jg = {n: jnp.asarray(g).astype(jp[n].dtype) for n, g in grads.items()}
        tg = {n: torch.tensor(g).to(tp[n].dtype)
              for n, g in grads.items()}
        jp, js, jstats = JO.adamw_update(jg, js, jp, cfg)
        ts, tstats = TO.adamw_update(
            tg, ts, tp, tcfg,
            grad_dtype=torch.float32 if store_bf16 else None)
        _ulps(tstats["grad_norm"].numpy(), jstats["grad_norm"])
        _ulps(tstats["lr"].numpy(), jstats["lr"])
    assert int(ts.count) == int(js.count) == len(grads_seq)
    return jp, js, tp, ts


def test_adamw_update_matches_jax_float32():
    rng = np.random.default_rng(1)
    params = _tree(rng, SHAPES)
    grads = [_tree(rng, SHAPES) for _ in range(3)]
    cfg = JO.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10,
                         clip_norm=2.0)
    jp, js, tp, ts = _run_adamw(params, grads, cfg)
    assert js.master is None and ts.master is None
    for n in params:
        _near(tp[n].numpy(), jp[n])
        _near(ts.mu[n].numpy(), js.mu[n])
        _near(ts.nu[n].numpy(), js.nu[n])


def test_adamw_update_matches_jax_bf16_with_master_and_no_decay_on_scalars():
    rng = np.random.default_rng(2)
    params = {n: _bf16(a) for n, a in _tree(rng, SHAPES).items()}
    grads = [{n: _bf16(a) for n, a in _tree(rng, SHAPES).items()}
             for _ in range(3)]
    cfg = JO.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10,
                         weight_decay=0.5)
    jp, js, tp, ts = _run_adamw(params, grads, cfg, bf16=("a", "b", "s"))
    assert js.master is not None and ts.master is not None
    for n in params:
        _near(ts.master[n].numpy(), js.master[n])
        # a stored bf16 leaf is its master's rounding, as in JAX
        want = ts.master[n].numpy()
        np.testing.assert_array_equal(
            tp[n].float().numpy(), _bf16(want) if n != "c" else want)
    # the 0-d leaf took no decay: with the same gradients and decay 0 it
    # lands on the same value
    _, _, tp0, _ = _run_adamw(params, grads,
                              dataclasses.replace(cfg, weight_decay=0.0),
                              bf16=("a", "b", "s"))
    assert torch.equal(tp0["s"], tp["s"])
    assert not torch.equal(tp0["a"], tp["a"])


def test_adamw_port_bf16_storage_of_float32_params_matches_jax():
    """The port's bf16 projections of a float32 ``param_dtype``: master
    == JAX's float32 leaf, the stored value its bf16 rounding."""
    rng = np.random.default_rng(3)
    params = {n: _bf16(a) for n, a in _tree(rng, SHAPES).items()}
    grads = [{n: _bf16(a) for n, a in _tree(rng, SHAPES).items()}
             for _ in range(3)]
    cfg = JO.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=10)
    jp, js, tp, ts = _run_adamw(params, grads, cfg, store_bf16=("a", "c"))
    assert js.master is None and ts.master is not None
    for n in params:
        _near(ts.master[n].numpy(), jp[n])
        want = ts.master[n].numpy()
        if n in ("a", "c"):
            want = _bf16(want)
        np.testing.assert_array_equal(tp[n].float().numpy(), want)


# ---------------------------------------------------------------------------
# Data pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 7])
def test_synthetic_source_windows_equal_jax(seed):
    j, t = JSynthetic(32064, seed=seed), SyntheticSource(32064, seed=seed)
    for start, n in ((0, 33), (12345, 100), (2 ** 40, 17)):
        np.testing.assert_array_equal(t.window(start, n),
                                      j.window(start, n))


def test_memmap_source_windows_equal_jax(tmp_path):
    path = tmp_path / "tokens.bin"
    np.random.default_rng(4).integers(0, 50000, 1000).astype(
        np.uint16).tofile(path)
    j, t = JMemmap(str(path), 50000), MemmapSource(str(path), 50000)
    for start, n in ((0, 34), (990, 34), (5000, 100)):
        got = t.window(start, n)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, j.window(start, n))


def test_pipeline_batches_equal_jax_and_resume():
    mesh = make_host_mesh()
    fe = (6, 8)
    j = JPipeline(JSynthetic(512, seed=3), batch=B, seq_len=S, mesh=mesh,
                  frontend_shape=fe)
    t = DataPipeline(SyntheticSource(512, seed=3), batch=B, seq_len=S,
                     device="cpu", frontend_shape=fe)
    for _ in range(3):
        jb, tb = j.next(), t.next()
        assert tb["tokens"].shape == (B, S + 1)
        assert tb["tokens"].dtype == torch.int32
        for k in ("tokens", "frontend"):
            np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))
    state = t.state_dict()
    assert state == {"step": 3} == j.state_dict()
    want = t.next()
    again = DataPipeline(SyntheticSource(512, seed=3), batch=B, seq_len=S,
                         device="cpu", frontend_shape=fe)
    again.load_state_dict(state)
    assert torch.equal(again.next()["tokens"], want["tokens"])


# ---------------------------------------------------------------------------
# Train steps against JAX
# ---------------------------------------------------------------------------

def _train_case(impl="float", **over):
    jcfg = JR.get_config("phi3-mini-3.8b", smoke=True, attention_impl=impl,
                         **over)
    tcfg = TR.get_config("phi3-mini-3.8b", smoke=True, attention_impl=impl,
                         **over)
    opt = JO.AdamWConfig(lr=LR, warmup_steps=1, total_steps=8)
    params = j_init_model(jax.random.PRNGKey(0), jcfg)
    src = JSynthetic(tcfg.vocab_size, seed=5)
    batches = [src.window(i * B * (S + 1), B * (S + 1)).reshape(B, S + 1)
               for i in range(3)]
    return jcfg, tcfg, opt, params, batches


def _hold_params(model, jparams, tcfg, steps):
    """Parameters within STEP_TOL of their scale but where a near-zero
    gradient stepped the other way: at most 2·lr a step, under 1%."""
    got = dict(model.named_parameters())
    n_off = n_all = 0
    for name, want in jax_named_leaves(jax.tree.map(np.asarray, jparams),
                                       tcfg):
        g = got[name].detach().float().numpy()
        diff = np.abs(g - np.asarray(want, np.float32))
        scale = max(float(np.abs(want).max()), 1e-30)
        off = diff > STEP_TOL * scale
        n_off += int(off.sum())
        n_all += diff.size
        assert diff.max() <= STEP_TOL * scale + 2 * LR * steps, name
    assert n_off <= 0.01 * n_all, (n_off, n_all)
    return n_off, n_all


def test_three_train_steps_match_jax():
    jcfg, tcfg, opt, params, batches = _train_case()
    jstep = jax.jit(j_make_train_step(jcfg, opt))
    jp, js = params, JO.init_opt_state(params)
    model = from_jax_params(jax.tree.map(np.asarray, params), tcfg,
                            device="cpu")
    tstep = make_train_step(tcfg, TO.AdamWConfig(**dataclasses.asdict(opt)))
    ts = TO.init_opt_state(TO.train_params(model))
    for i, tok in enumerate(batches):
        jp, js, jm = jstep(jp, js, {"tokens": jnp.asarray(tok)})
        ts, tm = tstep(model, ts, {"tokens": torch.from_numpy(tok)})
        assert set(tm) == set(jm) == {"loss", "nll", "aux", "grad_norm",
                                      "lr"}
        for k in ("loss", "nll", "grad_norm", "lr"):
            assert abs(float(tm[k]) - float(jm[k])) \
                <= STEP_TOL * abs(float(jm[k])), (i, k)
        n_off, n_all = _hold_params(model, jp, tcfg, i + 1)
        print(f"step {i + 1}: loss {float(tm['loss']):.7f} vs "
              f"{float(jm['loss']):.7f}; {n_off} of {n_all} parameters "
              f"off by more than {STEP_TOL} of their scale")
    assert all(p.grad is None for p in model.parameters())


# bfloat16 compute: JAX compiled to round after every bf16 op (as
# tests/test_torch_train_grad.py); the port's master starts from JAX's
# float32 parameters (``opt_state_from_jax``) and is compared with them.
# The gradients agree to bf16 noise (~1e-2 of a leaf), so Adam's steps
# after the first differ by a few hundredths of lr where they do not flip.
# Readings over the three steps: losses within 4.6e-4, grad norms 2.5e-3,
# 99% of parameters within 0.08·lr·steps, 0.26% stepped the other way.
BF16_METRIC_TOL = 5e-3
BF16_STEP = 0.25 * LR          # an element beyond this a step is "off"


def test_three_bf16_train_steps_match_jax():
    jcfg, tcfg, opt, params, batches = _train_case(dtype="bfloat16")
    jstep = jax.jit(j_make_train_step(jcfg, opt)).lower(
        params, JO.init_opt_state(params),
        {"tokens": jnp.asarray(batches[0])}).compile(
        compiler_options={"xla_allow_excess_precision": False})
    jp, js = params, JO.init_opt_state(params)
    np0 = jax.tree.map(np.asarray, params)
    model = from_jax_params(np0, tcfg, device="cpu")
    ts = opt_state_from_jax(jax.tree.map(np.asarray, js), np0, tcfg, model,
                            device="cpu")
    tstep = make_train_step(tcfg, TO.AdamWConfig(**dataclasses.asdict(opt)))
    for i, tok in enumerate(batches):
        jp, js, jm = jstep(jp, js, {"tokens": jnp.asarray(tok)})
        ts, tm = tstep(model, ts, {"tokens": torch.from_numpy(tok)})
        for k in ("loss", "nll", "grad_norm", "lr"):
            assert abs(float(tm[k]) - float(jm[k])) \
                <= BF16_METRIC_TOL * abs(float(jm[k])), (i, k)
        n_off = n_all = 0
        for name, want in jax_named_leaves(jax.tree.map(np.asarray, jp),
                                           tcfg):
            master = ts.master[name]
            stored = model.get_parameter(name)
            assert torch.equal(stored, master.to(stored.dtype)), name
            diff = np.abs(master.numpy() - np.asarray(want, np.float32))
            assert diff.max() <= 2 * LR * (i + 1) + BF16_STEP, name
            n_off += int((diff > BF16_STEP * (i + 1)).sum())
            n_all += diff.size
        assert n_off <= 0.01 * n_all, (i, n_off, n_all)
        print(f"bf16 step {i + 1}: loss {float(tm['loss']):.7f} vs "
              f"{float(jm['loss']):.7f}; {n_off} of {n_all} parameters "
              f"off by more than {BF16_STEP * (i + 1):.2e}")


@pytest.mark.parametrize("impl", ["float", "ita"])
def test_train_parity_check_passes_the_cpu_against_itself(impl):
    """``train_parity`` (the card-against-CPU check of ``chip_smoke.py``
    12d) runs on the CPU, where both runs are the same plain ops."""
    figs = train_step_card_vs_cpu("phi3-mini-3.8b", impl, device="cpu")
    assert figs["loss_rel"] == 0 and figs["n_off"] == 0
    if impl == "ita":
        assert figs["noq_grad_norm_rel"] == 0 == figs["worst_scale_grad"]


@pytest.mark.parametrize("share, passes", [(0.005, True), (0.02, False)])
def test_hold_params_counts_the_elements_stepped_the_other_way(share,
                                                              passes):
    cfg = TR.get_config("phi3-mini-3.8b", smoke=True)
    a = init_model(cfg, seed=0, device="cpu")
    b = init_model(cfg, seed=0, device="cpu")
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in b.parameters():
            flip = torch.rand(p.shape, generator=g) < share
            p.add_(torch.where(flip, 2 * LR, 0.0).to(p.dtype))
    if passes:
        _, n_off, n_all = hold_params(a, b, LR)
        assert 0 < n_off <= 0.01 * n_all
    else:
        with pytest.raises(AssertionError, match="parameters off"):
            hold_params(a, b, LR)
    with torch.no_grad():
        next(b.parameters()).view(-1)[0] += 3 * LR
    with pytest.raises(AssertionError, match="off by"):
        hold_params(a, b, LR)


def test_opt_state_from_jax_continues_a_jax_run():
    jcfg, tcfg, opt, params, batches = _train_case()
    jstep = jax.jit(j_make_train_step(jcfg, opt))
    p1, s1, _ = jstep(params, JO.init_opt_state(params),
                      {"tokens": jnp.asarray(batches[0])})
    p2, s2, jm = jstep(p1, s1, {"tokens": jnp.asarray(batches[1])})
    np1 = jax.tree.map(np.asarray, p1)
    model = from_jax_params(np1, tcfg, device="cpu")
    ts = opt_state_from_jax(jax.tree.map(np.asarray, s1), np1, tcfg, model,
                            device="cpu")
    assert ts.master is None and int(ts.count) == 1
    tstep = make_train_step(tcfg, TO.AdamWConfig(**dataclasses.asdict(opt)))
    ts, tm = tstep(model, ts, {"tokens": torch.from_numpy(batches[1])})
    assert abs(float(tm["loss"]) - float(jm["loss"])) \
        <= STEP_TOL * float(jm["loss"])
    _hold_params(model, p2, tcfg, 1)
    for name, want in jax_named_leaves(jax.tree.map(np.asarray, s2.mu),
                                       tcfg):
        scale = max(float(np.abs(want).max()), 1e-30)
        assert np.abs(ts.mu[name].numpy() - want).max() \
            <= 2 * (1 - opt.b1) * scale, name


def test_opt_state_from_jax_builds_the_ports_master_for_bf16_storage():
    """bf16 compute: the port stores projections in bf16 and keeps a
    master; JAX (float32 leaves) keeps none, so the master is JAX's
    parameters."""
    jcfg, tcfg, opt, params, _ = _train_case(dtype="bfloat16")
    np0 = jax.tree.map(np.asarray, params)
    model = from_jax_params(np0, tcfg, device="cpu")
    js = jax.tree.map(np.asarray, JO.init_opt_state(params))
    assert js.master is None
    ts = opt_state_from_jax(js, np0, tcfg, model, device="cpu")
    for name, want in jax_named_leaves(np0, tcfg):
        np.testing.assert_array_equal(ts.master[name].numpy(), want)
        assert ts.mu[name].shape == model.get_parameter(name).shape
    assert model.get_parameter("blocks.0.attn.wq").dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# TrainDriver, checkpoints, CLI
# ---------------------------------------------------------------------------

def _driver(tmp_path, ckdir, **ft):
    cfg = TR.get_config("phi3-mini-3.8b", smoke=True, attention_impl="ita")
    model = init_model(cfg, seed=0, device="cpu")
    opt = TO.init_opt_state(TO.train_params(model))
    step = make_train_step(cfg, TO.AdamWConfig(lr=1e-2, total_steps=100,
                                               warmup_steps=2))
    pipe = DataPipeline(SyntheticSource(cfg.vocab_size), batch=B,
                        seq_len=S, device="cpu")
    return TrainDriver(FTConfig(ckpt_dir=str(tmp_path / ckdir), **ft),
                       step, model, opt, pipe)


def _state_tensors(drv):
    from repro_torch.launch.steps import tree_leaves
    return tree_leaves({"params": dict(drv.model.named_parameters()),
                        "opt": drv.opt_state})


def test_train_driver_resume_is_bit_identical(tmp_path):
    """6 straight steps == 3 steps + checkpoint + restore + 3 steps."""
    straight = _driver(tmp_path, "straight", ckpt_every=3, keep=2)
    straight.run(6, log_every=0)
    _driver(tmp_path, "resume", ckpt_every=3, keep=2).run(3, log_every=0)
    resumed = _driver(tmp_path, "resume", ckpt_every=3, keep=2)
    assert resumed.maybe_restore() and resumed.step == 3
    assert resumed.pipeline.state_dict() == {"step": 3}
    resumed.run(6, log_every=0)
    a, b = _state_tensors(straight), _state_tensors(resumed)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert int(resumed.opt_state.count) == 6


def test_failure_injection_and_restart(tmp_path):
    drv = _driver(tmp_path, "ck2", ckpt_every=2, inject_failure_at=5)
    with pytest.raises(RuntimeError, match="injected node failure"):
        drv.run(10, log_every=0)
    drv2 = _driver(tmp_path, "ck2", ckpt_every=2)
    assert drv2.maybe_restore() and drv2.step == 4
    drv2.run(6, log_every=0)
    assert drv2.step == 6
    assert drv2.ckpt.latest_step() == 6


def test_train_driver_delegates_to_shared_watchdog(tmp_path):
    from repro_torch.runtime.watchdog import StragglerWatchdog
    drv = TrainDriver(FTConfig(ckpt_dir=str(tmp_path / "wd"),
                               straggler_factor=3.0),
                      None, None, None, None)
    assert isinstance(drv.wd, StragglerWatchdog)
    assert drv.wd.factor == 3.0
    assert drv.step_times is drv.wd.times        # shared in place
    for _ in range(8):
        drv._watchdog(0.01)
    assert drv.straggler_events == 0
    drv._watchdog(1.0)           # 100x median: one event, streak 1 only
    assert drv.straggler_events == 1
    assert len(drv.step_times) == 9


def test_persistent_straggler_takes_a_protective_checkpoint(tmp_path):
    drv = _driver(tmp_path, "wd2", ckpt_every=100,
                  straggler_ckpt_threshold=2)
    drv.step = 7
    for _ in range(8):
        drv._watchdog(0.01)
    drv._watchdog(1.0)
    assert drv.ckpt.latest_step() is None
    drv._watchdog(1.0)
    drv.ckpt.wait()
    assert drv.ckpt.latest_step() == 7


@pytest.mark.parametrize("bf16", [False, True])
def test_opt_state_round_trips_the_checkpointer(tmp_path, bf16):
    params = {"w": torch.randn(4, 8), "s": torch.tensor(0.05)}
    if bf16:
        params["w"] = params["w"].bfloat16()
    state = TO.init_opt_state(params)
    assert (state.master is None) == (not bf16)
    state.mu["w"].normal_()
    ck = Checkpointer(str(tmp_path / "ck"))
    tree = {"params": params, "opt": state}
    ck.save(3, tree, extra={"pipeline": {"step": 3}}, blocking=True)
    back, meta = ck.restore(tree)
    assert isinstance(back["opt"], TO.OptState)
    assert (back["opt"].master is None) == (not bf16)
    assert meta["extra"]["pipeline"] == {"step": 3}
    for k, v in params.items():
        assert back["params"][k].dtype == v.dtype
        assert torch.equal(back["params"][k], v)
    assert torch.equal(back["opt"].mu["w"], state.mu["w"])
    assert back["opt"].count.dtype == torch.int32


def test_train_cli_on_the_cpu_with_resume(tmp_path, capsys):
    args = ["--arch", "phi3-mini-3.8b", "--smoke", "--device", "cpu",
            "--batch", "2", "--seq", "16", "--attention-impl", "ita",
            "--ckpt-dir", str(tmp_path / "cli"), "--log-every", "1"]
    first = CLI.main(args + ["--steps", "2"])
    assert first.step == 2
    second = CLI.main(args + ["--steps", "4", "--resume"])
    out = capsys.readouterr().out
    assert "[train] resumed from step 2" in out
    assert second.step == 4 and "[train] step 4 loss" in out
    assert second.ckpt.latest_step() == 4
    assert int(second.opt_state.count) == 4


def test_train_entry_points_ask_for_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DataPipeline(SyntheticSource(512), batch=2, seq_len=8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CLI.main(["--arch", "phi3-mini-3.8b", "--smoke", "--steps", "1"])
