"""The serving benchmark of ``repro_torch`` on one NVIDIA H100 (see
``run.py``)."""
