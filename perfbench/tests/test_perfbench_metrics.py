"""The metric arithmetic: rates over the whole window, tails over all
requests, the time per output token, the device-time shares, the model
FLOPs on hand-made requests, and the trace's reduction."""

import math
from types import SimpleNamespace as NS

import numpy as np
import pytest
import torch

from perfbench.harness import readers, serve, traffic, work
from perfbench.harness import trace as TRACE

MC = {"d_model": 64, "n_heads": 4, "n_kv_heads": 2, "head_dim": 16,
      "d_ff": 32, "vocab_size": 100, "n_layers": 3, "mlp_type": "swiglu"}


def _run(completed, trace, wall=10.0, steps=100, tr=None, slots=4):
    res = NS(completed=completed, wall_s=wall, steps=steps)
    spec = {"serve": {"slots": slots}}
    return readers.Run(spec=spec, mc=MC, window=serve.Window(res, trace),
                       setup_s=12.5, trace=tr)


def _req(i, plen, gen, arrival=0, admitted=0, finished=10, first=1.0,
         end=3.0):
    return (traffic.Request(np.zeros(plen, np.int32), gen, arrival),
            NS(index=i, tokens=np.zeros(gen, np.int32),
               first_token_s=first, finished_s=end, arrival=arrival,
               admitted_step=admitted, finished_step=finished))


def test_rate_over_whole_window():
    reqs = [_req(i, 10, g) for i, g in enumerate((5, 7, 9))]
    run = _run([c for _, c in reqs], [r for r, _ in reqs], wall=4.0)
    assert readers.read("output_tok_s", run) == pytest.approx(21 / 4.0)


def test_tails_over_all_requests():
    # 40 requests of 5 tokens: request i's time per output token is i ms
    reqs = [_req(i, 10, 5, first=0.0, end=4e-3 * i) for i in range(40)]
    run = _run([c for _, c in reqs], [r for r, _ in reqs])
    # nearest rank: ceil(0.95 * 40) = 38th smallest
    assert readers.read("tpot_p95_ms", run) == pytest.approx(37.0)
    assert readers.p95([]) is None
    assert readers.p95([3.0]) == 3.0


def test_tpot():
    r, c = _req(0, 10, 5, first=2.0, end=4.0)
    run = _run([c], [r])
    assert readers.read("tpot_p95_ms", run) == pytest.approx(500.0)
    r1, c1 = _req(0, 10, 1)
    assert readers.read("tpot_p95_ms", _run([c1], [r1])) is None


def test_scheduler_counts_need_the_traced_run():
    reqs = [_req(i, 10, 4, arrival=i, admitted=i + 3, finished=i + 13)
            for i in range(20)]
    comp, tr = [c for _, c in reqs], [r for r, _ in reqs]
    assert readers.read("slot_occupancy", _run(comp, tr)) is None
    fake = TRACE.Trace({}, {}, 0, 0.0, 1.0, {})
    run = _run(comp, tr, steps=100, tr=fake, slots=4)
    assert readers.read("slot_occupancy", run) == pytest.approx(
        100 * 20 * 10 / 400)
    assert readers.read("step_ms", run) == pytest.approx(100.0)


def test_attention_share():
    tr = TRACE.Trace({"onepass_kernel": 1.0, "decode_kernel": 2.0,
                      "nvjet_x": 5.0},
                     {"onepass_kernel": "void onepass_kernel<1>(int)",
                      "decode_kernel": "void decode_kernel<2>(int)",
                      "nvjet_x": "nvjet_x"}, 3, 8.0, 9.0, {})
    r, c = _req(0, 130, 40)
    assert readers.read("attn_share", _run([c], [r], tr=tr)) == \
        pytest.approx(37.5)


def test_profiler_pause_left_out():
    r, c = _req(0, 9, 4)
    fake = TRACE.Trace({}, {}, 0, 0.0, 1.0, {})
    run = _run([c], [r], wall=12.0, steps=100, tr=fake)
    run.pause_s = 2.0
    assert run.wall_s == 10.0
    assert readers.read("step_ms", run) == pytest.approx(100.0)


def test_model_flops_by_enumeration():
    plen, gen = 9, 4
    per_layer = (64 * 64 + 2 * 64 * 32 + 64 * 64) + 3 * 64 * 32
    fed = plen + gen - 1
    pairs = sum(q + 1 for q in range(plen)) + sum(plen + i
                                                  for i in range(1, gen))
    want = (2 * per_layer * 3 * fed + 2 * 100 * 64 * gen
            + 4 * 4 * 16 * 3 * pairs)
    assert work.request_model_flops(MC, plen, gen) == pytest.approx(want)


def test_mfu_against_bf16_peak():
    r, c = _req(0, 9, 4)
    fake = TRACE.Trace({}, {}, 0, 0.0, 1.0, {})
    run = _run([c], [r], wall=2.0, tr=fake)
    want = 100 * work.request_model_flops(MC, 9, 4) / (2.0 * 989.4e12)
    assert readers.read("mfu", run) == pytest.approx(want)


class _Ev:
    def __init__(self, name, start, dur, dev=True):
        self._n, self._s, self._d, self._dev = name, start, dur, dev

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return (torch.autograd.DeviceType.CUDA if self._dev
                else torch.autograd.DeviceType.CPU)


def test_trace_reduction():
    events = [_Ev("void onepass_kernel<128, 4>(int*)", 0, 100),
              _Ev("nvjet_tst_128x64(x)", 50, 100),      # overlaps
              _Ev("aten::mm", 0, 10_000, dev=False),     # host: ignored
              _Ev("void decode_kernel<8>(int*)", 400, 100),
              _Ev("Memcpy DtoH", 700, 50)]
    t = TRACE.reduce(events, window_s=1e-6)
    assert t.busy_s == pytest.approx(300e-9)
    assert t.device_s == pytest.approx(350e-9)
    assert t.seconds("onepass_kernel|decode_kernel") == pytest.approx(200e-9)
    assert t.gaps == {"after nvjet_tst_128x64 / before decode_kernel":
                      pytest.approx(250e-9),
                      "after decode_kernel / before Memcpy DtoH":
                      pytest.approx(200e-9)}
    bd = t.breakdown()
    assert bd["device_ops"][0][0] in ("onepass_kernel", "nvjet_tst_128x64",
                                      "decode_kernel")
    assert len(bd["idle_gaps"]) == 2
    assert math.isclose(sum(s for _, s in bd["device_ops"]), t.device_s)


def test_gemm_share():
    tr = TRACE.Trace({"nvjet_a": 3.0, "onepass_kernel": 1.0},
                     {"nvjet_a": "nvjet_a", "onepass_kernel": "onepass"},
                     2, 4.0, 5.0, {})
    r, c = _req(0, 9, 4)
    run = _run([c], [r], tr=tr)
    assert readers.read("gemm_share", run) == pytest.approx(75.0)
    assert readers.read("device_idle", run) == pytest.approx(20.0)
