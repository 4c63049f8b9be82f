"""The plain PyTorch reference that decides ``correct``: the served
decoder (embedding, RMSNorm, projections, RoPE, int8 Q/K/V, ITA's
DA/DI/EN integer attention, the SwiGLU MLP, the LM head) at the
configuration's stated precision, one request at a time, layer by
layer.

It imports nothing of the program under test (``repro_torch``) and
nothing of the JAX package: ``ita.py`` is a frozen copy of the integer
arithmetic the configuration states, and ``model.py`` builds the
forward from the benchmark's own weight tree.
"""
