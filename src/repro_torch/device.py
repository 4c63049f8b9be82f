"""Device resolution of the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on. ``"cuda"`` (the default of every
    entry point) raises when CUDA is missing — the port never drops to the
    CPU by itself; the CPU runs only when the caller passes ``"cpu"``."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the port's entry points run on the "
            "card; pass device='cpu' to run the plain versions on the CPU")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"device {dev} is neither cuda nor cpu")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
