"""The port's roofline on one NVIDIA H100.

- ``repro_torch.roofline.analysis``: the card's peaks (``HW``), the
  ``Roofline`` terms of a step, and the reference's analytic
  ``param_counts`` / ``attention_flops`` / ``model_flops``.
- ``repro_torch.roofline.op_costs``: counts one eager step (every aten
  matmul by dtype and family; the nine kernels by one formula each).
- ``repro_torch.roofline.render``: markdown tables of the records
  ``chip_smoke.py`` prints.
"""
