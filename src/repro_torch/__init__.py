"""PyTorch/CUDA port of the ITA reproduction (``repro``), laid out module
for module like it: the port of ``repro/X`` is ``repro_torch/X``.

The port imports torch, numpy and the standard library only — never JAX
and never ``repro``. Its entry points run on the card (``device="cuda"``)
and raise when CUDA is missing; the CPU runs only when a caller asks for
it with ``device="cpu"``, where every kernel wrapper takes its plain
PyTorch version.
"""
