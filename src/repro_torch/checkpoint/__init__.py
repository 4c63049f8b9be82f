"""Checkpoints of tensor trees (``repro.checkpoint``): the serve's pool
and prefix-index snapshots."""
