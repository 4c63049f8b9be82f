"""The port's examples (``examples/*_torch.py``) run on the CPU, each in
a subprocess at a small size, and print their results."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("script,args,expect", [
    ("quickstart_torch.py", [], "onepass vs twopass int8 agreement"),
    ("serve_quantized_torch.py", ["--batch", "2", "--prompt", "16",
                                  "--gen", "4"], "[serve] sample (ITA)"),
    ("train_qat_lm_torch.py", ["--steps", "1"], "QAT model on INT serve"),
])
def test_example_runs_on_cpu(script, args, expect):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="2")
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / script), "--device", "cpu",
         *args], capture_output=True, text=True, env=env, timeout=300,
        cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert expect in out.stdout, out.stdout
