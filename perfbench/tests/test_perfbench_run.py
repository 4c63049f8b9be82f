"""Whole runs of the harness on the CPU at smoke width (its look for a
card skipped): a cell added by files and a ``BENCHMARK.json`` entry
alone, the refusals, and the faults that ``correct`` has to catch."""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from perfbench import run as RUN
from perfbench.harness import spec as SPEC
from perfbench.tests.smoke import smoke_spec

ROOT = SPEC.ROOT
CPU = torch.device("cpu")


def _measure(spec, seed=2**31 + 29):
    return RUN.measure(spec, seed, 1.0, False, CPU)


def test_new_cell_from_files_only(tmp_path):
    """Copy the benchmark, add a configuration, a mix and a cell as files
    and one entry, and run the new cell: no code changes."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    base = tmp_path / "perfbench"
    cfg = json.loads((base / "configs" / "phi3-mini-3.8b.json").read_text())
    small = dict(d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
                 d_ff=128, vocab_size=512, dtype="bfloat16")
    cfg["model"].update(small, n_layers=2)
    cfg["port_overrides"] = dict(cfg["port_overrides"], **small,
                                 layer_groups=[[["attn"], 2]])
    (base / "configs" / "phi3-tiny.json").write_text(json.dumps(cfg))
    mix = {"requests": 12, "block": 4,
           "prompt": {"dist": "uniform", "min": 10, "max": 40},
           "output": {"dist": "uniform", "min": 3, "max": 9},
           "arrival": {"kind": "poisson", "rate_per_step": 0.3}}
    (base / "traffic" / "tiny-chat.json").write_text(json.dumps(mix))
    cell = {"config": "phi3-tiny", "traffic": "tiny-chat", "slots": 3,
            "segment": 4, "page_size": 128, "num_pages": 8,
            "chunk_size": 16, "warmup_requests": 2,
            "check": {"sample_requests": 3, "min_checked_tokens": 6,
                      "max_logit_gap": 0.1}}
    (base / "workloads" / "tiny.chat.json").write_text(json.dumps(cell))
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "phi3-tiny", "source": "test",
                             "file": "perfbench/configs/phi3-tiny.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "tiny.chat", "config": "phi3-tiny",
                               "traffic": "tiny-chat", "chips": 1,
                               "why": "test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    spec = SPEC.cell_spec("tiny.chat", root=tmp_path)
    assert spec["end_to_end"] == ["output_tok_s", "tpot_p95_ms", "setup_s"]
    out = _measure(spec)
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == set(spec["end_to_end"])
    assert all(m["value"] > 0 for m in out["metrics"].values())
    assert list(out)[-1] == "checks"


def _cli(args, cwd, env=None):
    return subprocess.run([sys.executable, "perfbench/run.py", *args],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=300, env=env)


def test_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = _cli(["--workload", "phi3.longctx-batch", "--seed", "1",
              "--seconds", "1", "--trace", "0"], ROOT, env)
    assert p.returncode == 2
    assert p.stdout == ""
    assert "card" in p.stderr


def test_refuses_without_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _cli(["--workload", "phi3.longctx-batch", "--seed", "1",
              "--seconds", "1", "--trace", "0"], tmp_path)
    assert p.returncode != 0
    assert p.stdout == ""


@pytest.fixture
def phi3_smoke():
    """The cell at smoke width, checked with the cell's own sample."""
    spec = smoke_spec(SPEC.cell_spec("phi3.longctx-batch"),
                      dtype="bfloat16")
    cell = SPEC.cell_spec("phi3.longctx-batch")["serve"]["check"]
    assert spec["serve"]["check"]["sample_requests"] == \
        cell["sample_requests"]
    return spec


def test_sound_run_is_correct(phi3_smoke):
    out = _measure(phi3_smoke)
    assert out["correct"], out["checks"]
    assert out["checks"]["max_logit_gap"]["value"] == 0.0


def _token_altered(monkeypatch):
    from repro_torch.launch import steps
    orig = steps.advance_step_rows

    def altered(logits, *a, **kw):
        nxt, done, rem, n = orig(logits, *a, **kw)
        return (nxt + 1) % logits.shape[-1], done, rem, n
    monkeypatch.setattr(steps, "advance_step_rows", altered)


def _state_unchanged(monkeypatch):
    from repro_torch.attention import PagedKVState
    for name in ("append_chunk", "decode_append"):
        orig = getattr(PagedKVState, name)

        def kept(self, k_q, v_q, *a, _orig=orig, **kw):
            return _orig(self, torch.zeros_like(k_q), torch.zeros_like(v_q),
                         *a, **kw)
        monkeypatch.setattr(PagedKVState, name, kept)


def _half_left_out(monkeypatch):
    from repro_torch.models import layers
    orig = layers.SwiGLU.forward

    def half(self, x):
        y = orig(self, x)
        return torch.cat([y[: y.shape[0] // 2],
                          torch.zeros_like(y[y.shape[0] // 2:])])
    monkeypatch.setattr(layers.SwiGLU, "forward", half)


@pytest.mark.parametrize("fault", [_token_altered, _state_unchanged,
                                   _half_left_out])
def test_faults_are_not_correct(fault, phi3_smoke, monkeypatch):
    fault(monkeypatch)
    out = _measure(phi3_smoke)
    assert not out["correct"], out["checks"]


@pytest.mark.cuda
def test_a_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    p = _cli(["--workload", "phi3.longctx-batch", "--seed",
              str(2**31 + 1), "--seconds", "3", "--trace", "0"], ROOT)
    assert p.returncode == 0, p.stderr[-2000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["platform"] == "gpu"
