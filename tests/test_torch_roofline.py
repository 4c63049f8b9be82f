"""The port's roofline (``repro_torch.roofline``) against the reference,
on the CPU.

- ``param_counts``, ``attention_flops`` and ``model_flops`` equal the
  reference's exactly for all ten configs, full and smoke, at every
  shape of ``SHAPES`` and at ``SMOKE_SHAPE``; ``SHAPES`` and
  ``SMOKE_SHAPE`` are the reference's.
- ``Roofline``'s arithmetic: the compute term split into int8, bf16 and
  float32 at the H100's peaks, the collective term 0 on one card,
  ``mfu`` and ``share``.
- ``op_costs`` on smoke-width steps: a float prefill's matmul FLOPs
  outside the attention equal ``2·n_active·tokens + 2·V·d·tokens``
  exactly for a tied embedding, and that less the untied table's lookup
  (``2·V·d·tokens``, a gather) for an untied one; a decode step counts
  whole 128-row blocks; a train step with per-block remat counts the
  forward, the backward's two products and the recompute
  (``expected_flops``); each ITA kernel's call counts the formula's work
  through its plain version and none of the aten ops inside it.
- The port's count of qwen2-smoke's float prefill against the
  reference's ``hlo_costs.analyze`` of the same step compiled by XLA (the
  file's one JAX compile): FLOPs and the dot operand/result bytes equal,
  no tolerance, and no op family differs at this config. (Under ITA the
  reference's integer products are s8 dots and the port's float32
  matmuls, ``int_matmul``: the same FLOPs filed under another dtype.)
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import base as JB
from repro.configs.registry import ARCH_IDS
from repro.configs.registry import get_config as j_config
from repro.roofline import analysis as JA
from repro_torch.configs import base as TB
from repro_torch.configs.registry import get_config as t_config
from repro_torch.roofline import analysis as TA
from repro_torch.roofline import op_costs as OC
from repro_torch.roofline import render as RR

CONFIGS = [(arch, smoke) for arch in ARCH_IDS for smoke in (False, True)]


def _shapes():
    return list(TB.SHAPES.values()) + [TB.SMOKE_SHAPE]


def test_shapes_equal_reference():
    assert {n: s.__dict__ for n, s in TB.SHAPES.items()} == \
        {n: s.__dict__ for n, s in JB.SHAPES.items()}
    assert TB.SMOKE_SHAPE.__dict__ == JB.SMOKE_SHAPE.__dict__


@pytest.mark.parametrize("arch,smoke", CONFIGS, ids=[
    f"{a}-{'smoke' if s else 'full'}" for a, s in CONFIGS])
def test_roofline_functions_equal_reference(arch, smoke):
    jc, tc = j_config(arch, smoke=smoke), t_config(arch, smoke=smoke)
    assert TA.param_counts(tc) == JA.param_counts(jc)
    for shape in _shapes():
        js = JB.SHAPES.get(shape.name, JB.SMOKE_SHAPE)
        assert TA.model_flops(tc, shape) == JA.model_flops(jc, js)
        for kind in ("train", "prefill", "decode"):
            assert TA.attention_flops(tc, shape.seq_len, shape.global_batch,
                                      kind, kv_len=shape.seq_len) == \
                JA.attention_flops(jc, js.seq_len, js.global_batch, kind,
                                   kv_len=js.seq_len)


def test_roofline_arithmetic():
    hw = TA.HW
    r = TA.Roofline(flops=6e12, hbm_bytes=3.35e9, coll_bytes=1e9,
                    model_flops=3e12, flops_int8=2e12, flops_fp32=1e12)
    assert r.flops_bf16 == 3e12
    assert r.compute_s == pytest.approx(2e12 / hw["peak_int8"]
                                        + 3e12 / hw["peak_bf16"]
                                        + 1e12 / hw["peak_fp32"], rel=1e-12)
    assert r.memory_s == pytest.approx(1e-3, rel=1e-12)
    assert r.collective_s == 0.0                       # one card
    assert r.bottleneck == "compute" and r.step_s == r.compute_s
    assert r.useful_ratio == 0.5
    assert r.mfu(0.1) == pytest.approx(3e12 / (hw["peak_bf16"] * 0.1))
    assert r.share(2 * r.step_s) == pytest.approx(0.5)
    four = TA.Roofline(flops=0, hbm_bytes=0, coll_bytes=4.5e9,
                       model_flops=1, chips=4)
    assert four.collective_s == pytest.approx(0.01)
    assert four.bottleneck == "collective"
    row = r.row()
    assert {"compute_s", "memory_s", "collective_s", "bottleneck",
            "model_flops", "useful_ratio", "flops_int8", "flops_bf16",
            "flops_fp32"} <= set(row)
    # the kernels' bounds: the larger of the two terms
    assert TA.least_ms(3.35e9, 1) == (pytest.approx(1.0), "bytes")
    ms, by = TA.least_ms(1, hw["peak_int8"] * 1e-3)
    assert by == "operations" and ms == pytest.approx(1.0)
    assert TA.weight_floor_ms(3.35e9) == pytest.approx(1.0)
    fp32 = TA.Roofline(flops=1e12, hbm_bytes=0, coll_bytes=0,
                       model_flops=1, flops_fp32=1e12)      # TF32 stays off
    assert fp32.compute_s == pytest.approx(1e12 / hw["peak_fp32"])


def _prefill(cfg, b, s):
    from repro_torch.models import forward, init_caches, init_model
    model = init_model(cfg, seed=0, device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (b, s),
                         generator=torch.Generator().manual_seed(0))
    caches = init_caches(cfg, b, s + 8, device="cpu")
    with torch.inference_mode(), OC.counting() as c:
        _, caches = forward(model, toks, cfg, mode="prefill", caches=caches)
    return model, caches, c


@pytest.mark.parametrize("arch", ["gemma2-27b", "qwen2-7b"])
def test_op_costs_float_prefill_counts_the_analytic_matmuls(arch):
    from repro_torch.models import forward
    cfg = t_config(arch, smoke=True, attention_impl="float")
    b, s = 2, 64                         # 128 rows: whole row blocks
    model, caches, c = _prefill(cfg, b, s)
    tokens = b * s
    counts = TA.param_counts(cfg)
    n_active = counts["backbone_active"] + (
        0 if cfg.tie_embeddings else cfg.vocab_size * cfg.d_model)
    analytic = 2 * n_active * tokens + 2 * cfg.vocab_size * cfg.d_model \
        * tokens
    lookup = 0 if cfg.tie_embeddings else \
        2 * cfg.vocab_size * cfg.d_model * tokens
    assert c.flops["dense"] == analytic - lookup
    shape = TB.ShapeConfig("p", s, b, "prefill")
    assert TA.matmul_term(cfg, shape) == analytic
    assert OC.expected_flops(cfg, shape) == {"dense": analytic - lookup,
                                             "experts": 0.0}
    assert c.flops_by_dtype["fp32"] == c.matmul_flops     # float32 config
    # a decode step of 2 tokens computes one whole 128-row block
    with torch.inference_mode(), OC.counting() as d:
        forward(model, torch.zeros((b, 1), dtype=torch.long), cfg,
                mode="decode", caches=caches, pos0=torch.full((b,), s))
    want = OC.expected_flops(cfg, TB.ShapeConfig("d", s, b, "decode"))
    assert d.flops["dense"] == want["dense"]
    assert want["dense"] == (TA.matmul_term(
        cfg, TB.ShapeConfig("d", s, b, "decode")) - TA.lookup_term(
        cfg, TB.ShapeConfig("d", s, b, "decode"))) * 128 / b


def test_op_costs_train_step_counts_forward_backward_and_remat():
    from repro_torch.data.pipeline import DataPipeline, SyntheticSource
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import init_model
    from repro_torch.optim.optimizer import (AdamWConfig, init_opt_state,
                                             train_params)
    cfg = t_config("phi3-mini-3.8b", smoke=True, attention_impl="ita")
    model = init_model(cfg, seed=0, device="cpu")
    opt = init_opt_state(train_params(model))
    step = make_train_step(cfg, AdamWConfig(lr=1e-3, warmup_steps=1,
                                            total_steps=2))
    batch = DataPipeline(SyntheticSource(cfg.vocab_size, seed=0), batch=2,
                         seq_len=64, device="cpu").next()
    from repro_torch.core import cost_hook
    with OC.counting() as c:
        step(model, opt, batch)
    assert cost_hook._HOOK[0] is None                 # the hook removed
    shape = TB.ShapeConfig("t", 64, 2, "train")
    assert cfg.remat and c.flops["dense"] == \
        OC.expected_flops(cfg, shape)["dense"]
    assert c.flops["attention"] > 0 and c.flops["other"] > 0
    roof = c.roofline(TA.model_flops(cfg, shape))
    assert roof.model_flops == TA.model_flops(cfg, shape)
    assert 0 < roof.useful_ratio <= 1.0


def test_op_costs_moe_decode_counts_the_capacity_buffer():
    cfg = t_config("olmoe-1b-7b", smoke=True, attention_impl="ita")
    model, caches, _ = _prefill(cfg, 2, 64)
    from repro_torch.models import forward
    with torch.inference_mode(), OC.counting() as c:
        forward(model, torch.zeros((2, 1), dtype=torch.long), cfg,
                mode="decode", caches=caches, pos0=torch.full((2,), 64))
    want = OC.expected_flops(cfg, TB.ShapeConfig("d", 64, 2, "decode"))
    assert c.flops["dense"] == want["dense"]
    assert c.flops["experts"] == want["experts"]
    assert c.kernel_calls == {"ita_attention_decode": cfg.n_layers}


def _kernel_calls():
    """One call of each kernel's wrapper through its ``ops`` entry, on
    CPU tensors (the plain versions run), and the formula's work."""
    from repro_torch.kernels.int8_matmul import ops as MO
    from repro_torch.kernels.ita_attention import ops as AO
    from repro_torch.kernels.ita_softmax import ops as SO
    g = torch.Generator().manual_seed(0)

    def i8(*shape):
        return torch.randint(-128, 128, shape, dtype=torch.int8, generator=g)
    b, hq, hkv, sq, skv, d = 2, 4, 2, 8, 256, 32
    sc = dict(s_q=0.05, s_k=0.05, s_v=0.05, s_out=0.02)
    kv_len = torch.tensor([200, 256])
    cases = {
        "ita_attention_onepass": lambda: AO.fused_attention(
            i8(b, hq, sq, d), i8(b, skv, hkv, d), i8(b, skv, hkv, d),
            *sc.values(), kv_len=kv_len, q_offset=kv_len - sq,
            kind="onepass", kv_native=True),
        "ita_attention_decode": lambda: AO.fused_attention(
            i8(b, hq, 1, d), i8(b, skv, hkv, d), i8(b, skv, hkv, d),
            *sc.values(), kv_len=kv_len, q_offset=kv_len - 1, kind="decode",
            kv_native=True),
        "ita_attention_onepass_paged": lambda: AO.fused_attention(
            i8(b, hq, sq, d), i8(5, 128, hkv, d), i8(5, 128, hkv, d),
            *sc.values(), kv_len=kv_len, q_offset=kv_len - sq,
            q_lens=torch.tensor([sq, 3]), kind="onepass",
            page_table=torch.tensor([[3, 1], [0, 4]], dtype=torch.int32)),
        "ita_attention_decode_paged": lambda: AO.fused_attention(
            i8(b, hq, 1, d), i8(5, 128, hkv, d), i8(5, 128, hkv, d),
            *sc.values(), kv_len=kv_len, q_offset=kv_len - 1,
            kind="decode",
            page_table=torch.tensor([[3, 1], [0, 4]], dtype=torch.int32)),
        "twopass": lambda: AO.fused_attention(
            i8(b, hq, 64, d), i8(b, hkv, skv, d), i8(b, hkv, skv, d),
            *sc.values(), kind="twopass", adaptive=False),
        "ita_softmax": lambda: SO.ita_softmax(
            i8(64, 256), torch.rand((64, 256), generator=g) < 0.7),
        "int8_matmul": lambda: MO.int8_matmul(
            i8(64, 256), i8(256, 128), None, 0.01),
        "int8_matmul_ws": lambda: MO.int8_matmul(
            i8(64, 256), i8(256, 128), None, 0.01,
            schedule="weight_stationary"),
    }
    return cases


KERNEL_CASES = ["ita_attention_onepass", "ita_attention_decode",
                "ita_attention_onepass_paged", "ita_attention_decode_paged",
                "twopass", "ita_softmax", "int8_matmul", "int8_matmul_ws"]


@pytest.mark.parametrize("name", KERNEL_CASES)
def test_op_costs_counts_kernels_by_formula_through_plain(name, monkeypatch):
    from repro_torch.kernels.int8_matmul import ops as MO
    from repro_torch.kernels.ita_attention import ops as AO
    from repro_torch.kernels.ita_softmax import ops as SO
    call = _kernel_calls()[name]
    want = {}

    # the formula, fed the call each wrapper receives
    def spy(owner, attr, work):
        fn = getattr(owner, attr)

        def wrapped(*a, **k):
            for kname, w in work(a, k):
                want[kname] = w
            return fn(*a, **k)
        monkeypatch.setattr(owner, attr, wrapped)

    for kname in OC.KERNELS[:4]:
        spy(AO, kname, lambda a, k, kname=kname: [
            (kname, OC.attention_work(kname, a, k))])
    spy(AO, "ita_attention_twopass", lambda a, k: list(
        zip(OC.TWOPASS, OC.twopass_work(a, k), strict=True)))
    spy(SO, "ita_softmax_kernel",
        lambda a, k: [("ita_softmax", OC.softmax_work(a[0], a[1]))])
    spy(MO, "int8_matmul_kernel", lambda a, k: [
        ("int8_matmul_ws" if k["schedule"] == "weight_stationary"
         else "int8_matmul",
         OC.ws_work(a[0].shape[0], a[0].shape[1], a[1].shape[1],
                    k["block_k"])
         if k["schedule"] == "weight_stationary"
         else OC.matmul_work(a[0].shape[0], a[0].shape[1], a[1].shape[1]))])
    with OC.counting() as c:
        call()
    monkeypatch.undo()
    assert want, name
    assert c.matmul_flops == 0 and c.matmuls == 0, c.flops  # inside: none
    assert c.kernel_calls == dict.fromkeys(want, 1)
    assert c.kernel_ops == {k: w[1] for k, w in want.items()}
    assert c.kernel_bytes == {k: w[0] for k, w in want.items()}
    assert all(ops > 0 for ops in c.kernel_ops.values())
    roof = c.roofline(1.0)
    assert roof.flops_int8 == sum(c.kernel_ops.values())


def test_attention_work_counts_visible_pairs():
    """The ring formula by hand: 2 rows of 4 queries, causal, kv_len 6
    and 3 at the rows' last positions."""
    q = torch.zeros((2, 4, 8), dtype=torch.int8)
    k = torch.zeros((2, 16, 8), dtype=torch.int8)
    kw = dict(q_offset=torch.tensor([2, 0]), causal=True)
    nbytes, ops = OC.attention_work("ita_attention_onepass",
                                    (q, k, k, 1.0, 1.0,
                                     torch.tensor([6, 3])), kw)
    # row 0: queries at 2..5 see 3, 4, 5, 6 keys; row 1 at 0..3, kv_len 3:
    # 1, 2, 3, 3
    pairs = (3 + 4 + 5 + 6) + (1 + 2 + 3 + 3)
    assert ops == 4 * pairs * 8
    assert nbytes == q.numel() * 2 + 2 * (6 + 3) * 8 + 2 * 3 * 4 + 2 * 8


def test_op_costs_equal_reference_hlo_costs():
    """qwen2-smoke's prefill at 2 × 256: 512 rows, four 128-row blocks of
    every ``linear``, each of which reads the weight that the reference's
    one ``x @ w`` charges once."""
    from repro.models import forward as j_forward
    from repro.models import init_caches as j_init_caches
    from repro.models import init_model as j_init_model
    from repro.roofline import hlo_costs
    from repro_torch.models import forward, from_jax_params, init_caches
    b, s = 2, 256
    jcfg = j_config("qwen2-7b", smoke=True, attention_impl="float")
    params = j_init_model(jax.random.PRNGKey(0), jcfg)
    toks = np.random.default_rng(0).integers(0, jcfg.vocab_size, (b, s)) \
        .astype(np.int32)
    step = jax.jit(lambda p, t, c: j_forward(p, t, jcfg, mode="prefill",
                                              caches=c))
    hlo = step.lower(params, jnp.asarray(toks),
                     j_init_caches(jcfg, b, s)).compile().as_text()
    ref = hlo_costs.analyze(hlo)
    tcfg = t_config("qwen2-7b", smoke=True, attention_impl="float")
    model = from_jax_params(params, tcfg, device="cpu")
    with torch.inference_mode(), OC.counting() as c:
        forward(model, torch.as_tensor(toks), tcfg, mode="prefill",
                caches=init_caches(tcfg, b, s, device="cpu"))
    assert c.matmul_flops == ref["flops"]
    assert c.matmul_bytes == ref["dot_bytes"]
    assert c.flops_by_dtype["int8"] == ref["flops_int8"] == 0


def test_render_tables(tmp_path):
    rec = dict(path="qwen2-7b (a) decode", card="NVIDIA H100, 700.00 W",
               measured_s=0.01, mfu=0.001, share=0.2,
               families={"dense": 1e9}, kernel_ops=5.0,
               **TA.Roofline(flops=2e9, hbm_bytes=1e9, coll_bytes=0,
                             model_flops=1e9).row())
    log = tmp_path / "chip.log"
    log.write_text("[card] x\n" + json.dumps({"roofline": [rec]}) + "\n"
                   + json.dumps({"ok": True}) + "\n")
    recs = RR.load(log)
    assert recs == [rec]
    table = RR.roofline_table(recs)
    assert "qwen2-7b (a) decode" in table and "**memory**" in table
    assert "1.000e+09" in RR.flops_table(recs)
