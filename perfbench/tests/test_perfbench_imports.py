"""Nothing the harness or the reference runs loads JAX or the JAX
package (top-level names compared whole: ``repro_torch`` is not
``repro``), the reference loads nothing of the program, and nothing
reads the JAX package's ``benchmarks/``."""

import re
import subprocess
import sys

from perfbench.harness import spec as SPEC

ROOT = SPEC.ROOT


def _py(code: str) -> str:
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=600,
                       env={"PYTHONPATH": f"{ROOT / 'src'}:{ROOT}",
                            "PATH": "/usr/bin:/bin"})
    assert p.returncode == 0, p.stderr[-3000:]
    return p.stdout.strip().splitlines()[-1]


def test_reference_loads_nothing_of_the_program():
    out = _py("import sys, perfbench.reference.model, "
              "perfbench.harness.check; "
              "print(sorted({m.split('.')[0] for m in sys.modules} & "
              "{'repro', 'repro_torch', 'jax', 'jaxlib', 'flax'}))")
    assert out == "[]"


def test_a_run_loads_no_jax():
    code = """
import sys, torch
from perfbench import run as RUN
from perfbench.harness import spec as SPEC
from perfbench.tests.smoke import smoke_spec
spec = smoke_spec(SPEC.cell_spec("phi3.longctx-batch"))
out = RUN.measure(spec, 3, 1.0, False, torch.device("cpu"))
assert out["correct"], out
print(RUN.forbidden_modules(), "repro_torch" in sys.modules)
"""
    assert _py(code) == "[] True"


def test_forbidden_names_compare_whole():
    from perfbench import run as RUN
    sys.modules.setdefault("repro_torch_lookalike", sys)
    try:
        assert "repro" not in RUN.forbidden_modules() or \
            "repro" in {m.split(".")[0] for m in sys.modules}
    finally:
        sys.modules.pop("repro_torch_lookalike", None)


def test_sources_import_neither_and_read_no_benchmarks():
    bad = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|repro)\b"
                     r"(?!_torch)", re.M)
    for path in (ROOT / "perfbench").rglob("*.py"):
        text = path.read_text()
        assert not bad.search(text), path
        if path.parent.name != "tests":
            assert "benchmarks/" not in text, path
    ref = ROOT / "perfbench" / "reference"
    for path in ref.rglob("*.py"):
        assert not re.search(r"^\s*(import|from)\s+repro_torch\b",
                             path.read_text(), re.M), path
