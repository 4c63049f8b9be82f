"""The port end to end against the JAX package, on the CPU: whole-model
logits and greedy ``generate()`` tokens on a ``qwen2-smoke``-width ITA
config, with the JAX package's weights loaded through ``from_jax_params``.

Logits are compared with ``atol=5e-2``: float projections round
differently in XLA and torch, which can flip an int8 quantization by one
step (0.05 at the QAT scales). Greedy tokens must be identical. The
reference runs with an exact ``exp2`` (see ``tests/test_torch_kernels.py``
and ROADMAP §C). Also here: the import check (no JAX, no ``repro`` in the
port) and the entry points' refusal to drop to the CPU by themselves.
"""

import dataclasses
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.registry import get_config as j_config
from repro.models import forward as j_forward
from repro.models import init_caches as j_init_caches
from repro.models import init_model as j_init_model
from repro.runtime.generate import generate as j_generate
from repro_torch.configs.registry import get_config as t_config
from repro_torch.models import forward as t_forward
from repro_torch.models import from_jax_params, init_caches, init_model
from repro_torch.runtime.generate import generate as t_generate

B, S, GEN = 2, 20, 8


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
def weights():
    cfg = j_config("qwen2-7b", smoke=True, attention_impl="ita")
    params = j_init_model(jax.random.PRNGKey(0), cfg)
    tree = jax.tree.map(np.asarray, params)
    return params, from_jax_params(tree, t_config(
        "qwen2-7b", smoke=True, attention_impl="ita"), device="cpu")


def _configs(backend=""):
    return (j_config("qwen2-7b", smoke=True, attention_impl="ita",
                     attention_backend=backend),
            t_config("qwen2-7b", smoke=True, attention_impl="ita",
                     attention_backend=backend))


def _prompts(seed=0):
    return np.random.default_rng(seed).integers(0, 512, (B, S)
                                                ).astype(np.int32)


@pytest.mark.parametrize("backend", ["", "ita_onepass_pallas"])
def test_prefill_and_decode_logits_match_jax(weights, backend):
    params, model = weights
    jcfg, tcfg = _configs(backend)
    tokens = _prompts(1)
    jc = j_init_caches(jcfg, B, S + 4)
    tc = init_caches(tcfg, B, S + 4, device="cpu")
    jl, jc, _ = j_forward(params, jnp.asarray(tokens), jcfg, mode="prefill",
                          caches=jc)
    with torch.inference_mode():
        tl, tc = t_forward(model, torch.from_numpy(tokens), tcfg,
                           mode="prefill", caches=tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=5e-2)
    for step in range(3):
        tok = np.asarray(jnp.argmax(jl[:, -1:], -1)).astype(np.int32)
        pos = np.full((B,), S + step, np.int32)
        jl, jc, _ = j_forward(params, jnp.asarray(tok), jcfg, mode="decode",
                              caches=jc, pos0=jnp.asarray(pos))
        with torch.inference_mode():
            tl, tc = t_forward(model, torch.from_numpy(tok), tcfg,
                               mode="decode", caches=tc,
                               pos0=torch.from_numpy(pos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=5e-2,
                                   err_msg=f"decode step {step}")


GEN_CASES = {
    "unpinned": ("", {}),
    "onepass-pinned": ("ita_onepass_pallas", {}),
    "ring-wrap": ("", {"max_len": 24}),
    "ragged": ("", {"prompt_lengths": np.array([20, 11], np.int32)}),
    "onepass-ragged-wrap": ("ita_onepass_pallas",
                            {"max_len": 26,
                             "prompt_lengths": np.array([9, 20], np.int32)}),
}


@pytest.mark.parametrize("case", list(GEN_CASES))
def test_greedy_tokens_match_jax(weights, case):
    params, model = weights
    backend, kw = GEN_CASES[case]
    jcfg, tcfg = _configs(backend)
    prompts = _prompts(2)
    jres = j_generate(params, jcfg, jnp.asarray(prompts), GEN, loop="fused",
                      **{n: jnp.asarray(a) if isinstance(a, np.ndarray)
                         else a for n, a in kw.items()})
    tres = t_generate(model, tcfg, torch.from_numpy(prompts), GEN,
                      device="cpu", **kw)
    assert np.array_equal(np.asarray(jres.tokens), tres.tokens.numpy())
    assert tres.decode_steps == jres.decode_steps == GEN - 1


def test_eos_early_exit_matches_jax(weights):
    params, model = weights
    jcfg, tcfg = _configs()
    prompts = _prompts(2)
    greedy = t_generate(model, tcfg, prompts, GEN, device="cpu").tokens
    eos = int(greedy[0, 2])
    kw = dict(eos_id=eos, pad_id=0, early_exit=True)
    jres = j_generate(params, jcfg, jnp.asarray(prompts), GEN, **kw)
    tres = t_generate(model, tcfg, prompts, GEN, device="cpu", **kw)
    assert np.array_equal(np.asarray(jres.tokens), tres.tokens.numpy())
    assert tres.n_decode_tokens == jres.n_decode_tokens
    assert tres.decode_steps == jres.decode_steps


def test_sampling_is_seeded_within_the_port(weights):
    _, model = weights
    _, tcfg = _configs()
    prompts = _prompts(3)

    def run(seed):
        g = torch.Generator().manual_seed(seed)
        return t_generate(model, tcfg, prompts, GEN, temperature=0.8,
                          generator=g, device="cpu").tokens

    assert torch.equal(run(4), run(4))
    assert not torch.equal(run(4), run(5))


def test_port_imports_neither_jax_nor_repro():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or "
        "n.startswith('jax.') or n == 'repro' or n.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "for n in ('repro_torch.optim.optimizer', 'repro_torch.data.pipeline',"
        " 'repro_torch.launch.train', 'repro_torch.runtime.fault_tolerance',"
        " 'repro_torch.launch.train_parity'):\n"
        "    assert n in sys.modules, n\n"
        "print(len([n for n in sys.modules if n.startswith('repro_torch')]))"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, env={
                             "PYTHONPATH": str(_src()), "PATH": "/usr/bin"})
    assert int(out.stdout.strip()) >= 20


def _src():
    import pathlib

    import repro_torch
    return pathlib.Path(repro_torch.__file__).resolve().parents[1]


def test_entry_points_do_not_fall_back_to_cpu(weights, monkeypatch):
    """Without ``device=``, every entry point (and the cache and slot
    constructors) asks for the card and raises when CUDA is missing —
    never a silent CPU run."""
    _, model = weights
    _, tcfg = _configs()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from repro_torch.attention import KVCacheState, PagedKVState
    from repro_torch.launch.steps import ServeSlotState
    for call in (lambda: init_model(tcfg),
                 lambda: init_caches(tcfg, 1, 8),
                 lambda: from_jax_params({}, tcfg),
                 lambda: t_generate(model, tcfg, _prompts(), 2),
                 lambda: KVCacheState.init(1, 8, 2, 16),
                 lambda: PagedKVState.init(1, 8, 2, 16),
                 lambda: ServeSlotState.init(2, 8)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    from repro_torch.launch import serve
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--smoke", "--gen", "2"])


def test_serve_cli_runs_on_cpu_when_asked():
    from repro_torch.launch import serve
    res = serve.main(["--smoke", "--device", "cpu", "--batch", "2",
                      "--prompt-len", "12", "--gen", "4", "--ragged"])
    assert res.tokens.shape == (2, 4)
    assert res.tokens.device.type == "cpu"


def test_serve_cli_lists_backend_verdicts(capsys):
    from repro_torch.launch import serve
    assert serve.main(["--list-backends"]) is None
    out = capsys.readouterr().out
    assert "ita_decode_pallas    eligible" in out
    assert "ita_chunked_xla      no — decode rides" in out


def test_unported_config_raises():
    """Every block kind of the reference builds now; an unknown kind
    raises ``ValueError(kind)``, as the reference's ``init_block``
    does."""
    cfg = dataclasses.replace(t_config("qwen2-7b", smoke=True),
                              layer_groups=((("attn_cross",), 1),))
    assert len(init_model(cfg, device="cpu").blocks) == 1
    for make, c in ((lambda c: init_model(c, device="cpu"), cfg),
                    (lambda c: j_init_model(jax.random.PRNGKey(0), c),
                     j_config("qwen2-7b", smoke=True))):
        with pytest.raises(ValueError, match="^mamba$"):
            make(dataclasses.replace(c, layer_groups=((("mamba",), 1),)))
