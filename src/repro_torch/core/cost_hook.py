"""One module-level slot for a cost hook, which
``roofline.op_costs.counting()`` fills while it counts a step.

Each kernel wrapper, and each program scope whose matmuls the counter
files apart (``models.layers.linear``, the attention engine's
``dispatch``, the MoE expert FFN), is decorated with ``counted(name)``.
With no hook set, a call costs one more Python frame. With a hook set,
the call becomes ``hook(name, fn, args, kwargs)``. The decorator sits on
the function itself, so a caller cannot miss the hook by importing the
name from another module.
"""

from __future__ import annotations

import functools

_HOOK = [None]


def set_hook(hook) -> None:
    """Install ``hook``; None removes it."""
    _HOOK[0] = hook


def counted(name: str):
    """Decorator: calls of the function go through the hook while one is
    set, as ``hook(name, fn, args, kwargs)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            hook = _HOOK[0]
            if hook is None:
                return fn(*args, **kwargs)
            return hook(name, fn, args, kwargs)
        return call
    return wrap
