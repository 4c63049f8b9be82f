"""Device meshes (``repro.launch.mesh``) as ``torch.distributed``
``DeviceMesh``es with named dimensions.

Single pod: (data=16, model=16) = 256 cards. Multi-pod: (pod=2, data=16,
model=16) = 512; the leading ``pod`` axis is pure data parallelism.

    mesh = make_host_mesh()                  # over the ranks that exist
    mesh = make_production_mesh(multi_pod=True, device_type="cpu")

A mesh needs the default process group of its world size (``torchrun``
sets one up from its environment; ``launch.dryrun`` starts a fake one of
256 or 512 ranks). The rules of ``launch.sharding`` read a mesh only
through ``axis_names`` and ``axis_size``, which also take any object with
``.shape`` (a mapping of axis name to size) and ``.axis_names``, such as
the JAX package's ``AbstractMesh``.
"""

from __future__ import annotations

import math

DATA_AXIS = 16
MODEL_AXIS = 16


def _init(shape, names, device_type):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False, device_type="cuda"):
    shape = (2, DATA_AXIS, MODEL_AXIS) if multi_pod \
        else (DATA_AXIS, MODEL_AXIS)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _init(shape, axes, device_type)


def make_host_mesh(model_axis: int | None = None, device_type="cuda"):
    """(data, model) over the default group's ranks; ``model_axis`` 2
    when unset and the world size is even and above 1."""
    import torch.distributed as dist
    n = dist.get_world_size()
    m = model_axis or (2 if n % 2 == 0 and n > 1 else 1)
    return _init((n // m, m), ("data", "model"), device_type)


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init_distributed(device_type="cuda") -> None:
    """Start the default process group unless one is up: ``torchrun``'s
    (its environment names the rendezvous, the rank and the world size)
    or, outside ``torchrun``, one rank on a free local port. NCCL on the
    card, gloo on the CPU; on the card each rank takes the device of its
    ``LOCAL_RANK``."""
    import os

    import torch
    import torch.distributed as dist
    if dist.is_initialized():
        return
    backend = "nccl" if device_type == "cuda" else "gloo"
    if device_type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    if "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend)
    else:
        dist.init_process_group(
            backend, init_method=f"tcp://127.0.0.1:{free_port()}", rank=0,
            world_size=1)


def axis_names(mesh) -> tuple:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names if names is not None else mesh.axis_names)


def axis_sizes(mesh) -> dict:
    """Axis name -> size."""
    if getattr(mesh, "mesh_dim_names", None) is not None:
        return dict(zip(mesh.mesh_dim_names, mesh.shape, strict=True))
    return dict(mesh.shape)


def axis_size(mesh, axes) -> int:
    """Product of the sizes of ``axes`` (a name, a tuple of names or
    None)."""
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    sizes = axis_sizes(mesh)
    return math.prod(sizes[a] for a in axes)


def fsdp_axes(mesh) -> tuple:
    """The axes parameters and optimizer state are ZeRO-3 sharded over."""
    return ("pod", "data") if "pod" in axis_names(mesh) else ("data",)


def batch_axes(mesh) -> tuple:
    return fsdp_axes(mesh)
