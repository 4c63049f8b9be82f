"""Static analysis for the port's quantized serving stack
(``repro.analysis``).

- ``repro_torch.analysis.ranges``: the interval interpreter over aten
  graphs traced with ``make_fx`` (the no-overflow verifier).
- ``repro_torch.analysis.verify``: the reference's 18-case certification
  matrix over the port's kernels' plain versions and backends, seeded
  from the declared operand ranges in ``repro_torch.attention.spec``.
- ``repro_torch.analysis.lints``: capture-hygiene lints for the served
  and fused loops (bounded segment variants, each CUDA graph captured
  once, carries updated in place, no host sync in a replay).

CLI: ``python -m repro_torch.analysis`` (see ``--help``).
"""

from repro_torch.analysis.intervals import Interval
from repro_torch.analysis.lints import run_lints
from repro_torch.analysis.ranges import AnalysisResult, analyze_graph
from repro_torch.analysis.verify import build_matrix, run_case, run_verification

__all__ = [
    "AnalysisResult",
    "Interval",
    "analyze_graph",
    "build_matrix",
    "run_case",
    "run_lints",
    "run_verification",
]
