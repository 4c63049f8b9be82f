"""The traffic generator: deterministic per seed, within its parameters,
and the same work under every seed."""

from collections import Counter

import numpy as np
import pytest

from perfbench.harness import spec as SPEC
from perfbench.harness import traffic

# the committed mixes, by file name, and an open loop of log-uniform
# sizes that a later mix file may state (conversation turns)
POISSON = {"requests": 2048, "block": 16,
           "prompt": {"dist": "log_uniform", "min": 128, "max": 2048},
           "output": {"dist": "log_uniform", "min": 32, "max": 512},
           "arrival": {"kind": "poisson", "rate_per_step": 0.19}}
MIXES = ["longctx-batch", "poisson"]


def _mix(name):
    if name == "poisson":
        return dict(POISSON)
    return SPEC.load_json(SPEC.BENCH / "traffic" / f"{name}.json")


@pytest.mark.parametrize("name", MIXES)
def test_same_seed_same_trace(name):
    mix = _mix(name)
    a = traffic.generate(mix, 2**31 + 11, 50304)
    b = traffic.generate(mix, 2**31 + 11, 50304)
    assert len(a) == len(b) == mix["requests"]
    for x, y in zip(a, b, strict=True):
        assert (x.gen, x.arrival) == (y.gen, y.arrival)
        assert np.array_equal(x.prompt, y.prompt)


@pytest.mark.parametrize("name", MIXES)
def test_within_parameters(name):
    mix = _mix(name)
    trace = traffic.generate(mix, 5, 32064)
    plen = np.array([len(r.prompt) for r in trace])
    gen = np.array([r.gen for r in trace])
    arr = np.array([r.arrival for r in trace])
    assert plen.min() >= mix["prompt"]["min"]
    assert plen.max() <= mix["prompt"]["max"]
    assert gen.min() >= mix["output"]["min"]
    assert gen.max() <= mix["output"]["max"]
    assert all(r.prompt.min() >= 0 and r.prompt.max() < 32064
               for r in trace)
    assert np.all(np.diff(arr) >= 0)
    if mix["arrival"]["kind"] == "backlog":
        assert not arr.any()
    else:
        rate = mix["arrival"]["rate_per_step"]
        n = mix["block"]
        # whole blocks hold the same gaps: their mean is 1/rate to within
        # the stratification's truncated tail
        assert abs(arr[n - 1] / n - 1 / rate) < 0.1 / rate


@pytest.mark.parametrize("name", MIXES)
def test_every_seed_same_work(name):
    """A block of any seed holds the same multiset of sizes; the token
    ids differ."""
    mix = _mix(name)
    n = mix["block"]
    a = traffic.generate(mix, 1, 32064)
    b = traffic.generate(mix, 2**31 + 3, 32064)
    for k in range(0, len(a), n):
        sizes_a = Counter((len(r.prompt), r.gen) for r in a[k:k + n])
        sizes_b = Counter((len(r.prompt), r.gen) for r in b[k:k + n])
        assert sizes_a == sizes_b
    assert not np.array_equal(a[0].prompt[:8], b[0].prompt[:8]) or \
        len(a[0].prompt) != len(b[0].prompt)


def test_log_uniform_median():
    mix = _mix("poisson")
    prompt, output, _ = traffic.block_sizes(mix)
    assert 400 <= np.median(prompt) <= 620
    assert 100 <= np.median(output) <= 160
