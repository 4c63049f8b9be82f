"""The port's two decode loops (``generate(loop="fused"|"stepwise")``)
against each other and against the JAX package's ``loop="fused"``, on
the CPU, on the ``genloop-smoke`` config of ``tests/test_generate_loop.py``
(weights made by the JAX package and loaded with ``from_jax_params``).

On the CPU the fused loop runs ``launch.steps.CapturedSteps`` without a
graph: the same step over the same static buffers, with the same
copy-in and copy-back, kept across calls as on the card. So
these tests hold the static-buffer plumbing of the captured loop to the
eager loop; the graph itself is held to the eager step on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 3).

- Greedy tokens (uniform and ragged prompts, unpinned and with the
  ``ita_onepass_pallas`` pin) equal across the two loops, a second fused
  call (the kept step), and the JAX package's fused loop.
- EOS: pads after the first EOS, live-token accounting and early exit
  match the JAX package's while-loop and the stepwise loop.
- Sampled: the fused loop draws what the stepwise loop draws.
- A reused ``caches=`` (ring or paged) holds the same bytes after
  either loop.

The reference runs with an exact ``exp2`` (``tests/test_torch_kernels.py``,
ROADMAP §C).
"""

import dataclasses
import gc

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.base import ModelConfig as JConfig
from repro.models import init_model as j_init_model
from repro.runtime.generate import generate as j_generate
from repro_torch.configs.base import ModelConfig as TConfig
from repro_torch.launch.steps import CapturedSteps
from repro_torch.models import from_jax_params, init_caches
from repro_torch.runtime import generate as G
from repro_torch.runtime.generate import generate

_FIELDS = dict(name="genloop-smoke", family="dense", d_model=64, n_heads=4,
               n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=128,
               layer_groups=((("attn",), 2),), dtype="float32",
               attention_impl="ita")
JCFG, CFG = JConfig(**_FIELDS), TConfig(**_FIELDS)
B, PROMPT, GEN = 2, 12, 8
LENS = [5, 12, 9]


@pytest.fixture(scope="module", autouse=True)
def exact_exp2():
    """Run the reference with exact powers of two (module docstring)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnp, "exp2", lambda x: jnp.ldexp(
            jnp.ones(jnp.shape(x), jnp.float32),
            jnp.asarray(x).astype(jnp.int32)))
        jax.clear_caches()
        yield
    jax.clear_caches()


@pytest.fixture(scope="module")
def weights(exact_exp2):
    params = j_init_model(jax.random.PRNGKey(0), JCFG)
    model = from_jax_params(jax.tree.map(np.asarray, params), CFG,
                            device="cpu")
    return params, model


def _prompts(b=B):
    return np.random.default_rng(0).integers(
        0, CFG.vocab_size, (b, PROMPT)).astype(np.int32)


def _port(model, loop, cfg=CFG, b=B, **kw):
    return generate(model, cfg, torch.from_numpy(_prompts(b)), GEN,
                    max_len=PROMPT + GEN, loop=loop, device="cpu", **kw)


def _jax(params, backend="", b=B, **kw):
    cfg = dataclasses.replace(JCFG, attention_backend=backend)
    return j_generate(params, cfg, jnp.asarray(_prompts(b)), GEN,
                      max_len=PROMPT + GEN, loop="fused", **kw)


@pytest.mark.parametrize("ragged", [False, True], ids=["uniform", "ragged"])
@pytest.mark.parametrize("backend", ["", "ita_onepass_pallas"],
                         ids=["unpinned", "onepass"])
def test_fused_equals_stepwise_and_jax_greedy(weights, backend, ragged):
    params, model = weights
    cfg = dataclasses.replace(CFG, attention_backend=backend)
    b = len(LENS) if ragged else B
    port_kw = dict(prompt_lengths=torch.tensor(LENS)) if ragged else {}
    jax_kw = dict(prompt_lengths=jnp.asarray(LENS, jnp.int32)) \
        if ragged else {}
    fused = _port(model, "fused", cfg, b, **port_kw)
    again = _port(model, "fused", cfg, b, **port_kw)      # the kept step
    step = _port(model, "stepwise", cfg, b, **port_kw)
    want = np.asarray(_jax(params, backend, b, **jax_kw).tokens)
    for res in (fused, again, step):
        np.testing.assert_array_equal(res.tokens.numpy(), want)
        assert res.decode_steps == GEN - 1
        assert res.n_decode_tokens == b * (GEN - 1)
    assert fused.capture_s == again.capture_s == 0.0     # no graph on CPU


def test_eos_early_exit_matches_jax_and_stepwise(weights):
    params, model = weights
    base = _port(model, "fused")
    eos = int(base.tokens[0, 2])                 # row 0 emits it by step 2
    pad = CFG.vocab_size - 1
    want = _jax(params, eos_id=eos, pad_id=pad, early_exit=True)
    runs = [_port(model, loop, eos_id=eos, pad_id=pad, early_exit=exit_)
            for loop in ("fused", "stepwise") for exit_ in (False, True)]
    for res in runs:
        np.testing.assert_array_equal(res.tokens.numpy(),
                                      np.asarray(want.tokens))
        assert res.n_decode_tokens == want.n_decode_tokens \
            < B * (GEN - 1)
    assert runs[1].decode_steps == runs[3].decode_steps \
        == want.decode_steps
    assert runs[0].decode_steps == runs[2].decode_steps == GEN - 1
    toks = runs[0].tokens.numpy()
    for row in toks:
        hits = np.flatnonzero(row == eos)
        if hits.size:
            assert np.all(row[hits[0] + 1:] == pad), row


def test_sampled_fused_equals_stepwise(weights):
    _, model = weights

    def run(loop, seed):
        gen = torch.Generator().manual_seed(seed)
        return _port(model, loop, temperature=0.8, generator=gen).tokens
    a, b = run("fused", 7), run("stepwise", 7)
    assert torch.equal(a, b)
    assert not torch.equal(a, run("fused", 8))       # sampling is live


@pytest.mark.parametrize("paged", [False, True], ids=["ring", "paged"])
def test_reused_caches_hold_the_same_bytes(weights, paged):
    _, model = weights
    kw = dict(paged=True, page_size=16) if paged else {}
    caches = {loop: init_caches(CFG, B, PROMPT + GEN, device="cpu", **kw)
              for loop in ("fused", "stepwise", "fused again")}
    toks = {loop: _port(model, loop.split()[0], caches=c).tokens
            for loop, c in caches.items()}
    assert torch.equal(toks["fused"], toks["stepwise"])
    assert torch.equal(toks["fused again"], toks["stepwise"])
    for loop in ("fused", "fused again"):
        for mine, ref in zip(caches[loop], caches["stepwise"], strict=True):
            assert torch.equal(mine["mix"].k, ref["mix"].k), loop
            assert torch.equal(mine["mix"].v, ref["mix"].v), loop
            assert mine["mix"].k.abs().sum() > 0


def test_fused_step_is_kept_across_calls(weights):
    """A greedy fused loop over caches ``generate`` made keeps its step per
    model, config and shapes, while the model lives; over the caller's
    ``caches=`` it keeps nothing."""
    _, model = weights
    G._DECODE_GRAPHS.clear()
    _port(model, "fused")
    _port(model, "fused")
    assert len(G._DECODE_GRAPHS[model]) == 1
    _port(model, "fused", eos_id=3)                   # another step
    _port(model, "fused", b=3)                        # other shapes
    assert len(G._DECODE_GRAPHS[model]) == 3
    _port(model, "stepwise")
    _port(model, "fused", caches=init_caches(CFG, B, PROMPT + GEN,
                                             device="cpu"))
    assert len(G._DECODE_GRAPHS[model]) == 3
    other = from_jax_params(jax.tree.map(np.asarray, j_init_model(
        jax.random.PRNGKey(1), JCFG)), CFG, device="cpu")
    _port(other, "fused")
    assert len(G._DECODE_GRAPHS) == 2
    del other
    gc.collect()
    assert list(G._DECODE_GRAPHS.keys()) == [model]   # died with its model
    with pytest.raises(ValueError, match="loop="):
        _port(model, "scan")


def test_captured_steps_static_buffers_on_cpu():
    """``CapturedSteps`` on the CPU: the first call takes the carry's own
    tensors as the static buffers (a second view of one storage is
    cloned), later calls copy in tensors that are not static, outputs
    land in the static buffers, a buffer written in place is not copied,
    and a carry of other shapes is refused."""
    def body(carry):
        x, buf, _ = carry
        buf[x.long()] += 1                        # written in place
        return (x + 1, buf, x * 2), (x * 10,)

    graphs = CapturedSteps("cpu")
    x = torch.tensor([0])
    mine = (x, torch.zeros(4, dtype=torch.int64), x)
    carry, (out,) = graphs.run("step", body, mine)
    assert carry[0] is mine[0] and carry[1] is mine[1]    # adopted
    assert carry[2] is not mine[0]                        # shared: cloned
    assert int(mine[0]) == 1 and int(out) == 0 and int(carry[2]) == 0
    carry, (out,) = graphs.run("step", body, carry)
    assert int(carry[0]) == 2 and int(out) == 10 and int(carry[2]) == 2
    fresh = torch.zeros(4, dtype=torch.int64)
    carry, _ = graphs.run("step", body, (torch.tensor([0]), fresh, x))
    assert carry[1] is mine[1] and int(carry[0]) == 1     # copied in
    assert carry[1].tolist() == [1, 0, 0, 0] and fresh.tolist() == [0] * 4
    with pytest.raises(ValueError, match="static buffer"):
        graphs.run("step", body, (torch.tensor([0, 1]), carry[1], x))
