"""The reference against the program's plain path at smoke width on a
tiny trace (the CPU runs the program's kernels as their plain
versions): served tokens sit on the reference's first token at every
position, and the float8 control does not."""

import pytest
import torch

from perfbench.harness import check as CHECK
from perfbench.harness import serve, traffic
from perfbench.harness import spec as SPEC
from perfbench.harness import weights as W
from perfbench.tests.smoke import smoke_spec

CELLS = ["phi3.longctx-batch"]
CPU = torch.device("cpu")


@pytest.fixture(scope="module", params=CELLS)
def served(request):
    spec = smoke_spec(SPEC.cell_spec(request.param), dtype="bfloat16")
    cfg, mc = serve.port_config(spec["config"]), spec["config"]["model"]
    tree = W.make(mc, 2**31 + 17, CPU)
    model = W.serve_model(tree, cfg)
    trace = traffic.generate(spec["traffic"], 17, mc["vocab_size"])
    window = serve.timed(model, cfg, trace, spec["serve"], spec["traffic"],
                         1.0, CPU)
    picked = CHECK.sample(window.result.completed, trace, 17, 4)
    return spec, tree, mc, window, picked


def test_served_tokens_are_the_references_first(served):
    spec, tree, mc, window, picked = served
    assert len(picked) >= 2
    gaps = CHECK.gaps(tree, mc, picked, window.trace)
    assert sum(g.size for g in gaps) >= 8
    assert max(float(g.max()) for g in gaps) == 0.0


def test_control_fails_the_limit(served):
    spec, tree, mc, window, picked = served
    ctrl = CHECK.gaps(tree, mc, picked, window.trace, control="fp8")
    widest = max(float(g.max()) for g in ctrl)
    assert widest > spec["serve"]["check"]["max_logit_gap"]


def test_sample_holds_the_longest(served):
    _, _, _, window, picked = served
    size = {c.index: len(window.trace[c.index].prompt)
            + window.trace[c.index].gen for c in window.result.completed}
    assert size[picked[0].index] == max(size.values())
    assert len({c.index for c in picked}) == len(picked)
