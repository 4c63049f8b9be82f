"""Unified quantized-attention engine of the port (``repro.attention``).

    from repro_torch import attention as ATT

    spec = ATT.AttentionSpec(mode="decode", impl="ita", causal=True,
                             window=0, q_len=1)
    scales = ATT.QuantScales.per_tensor(0.05, s_out=0.02)
    out = ATT.dispatch(q, k, v, spec=spec, scales=scales,
                       q_offset=off, kv_len=n)

Importing the package registers the backends of this slice.
"""

from repro_torch.attention.registry import (Backend,  # noqa: F401
                                            BackendUnsupported,
                                            all_backends, backend_reasons,
                                            dispatch, get_backend,
                                            list_backends, register_backend)
from repro_torch.attention.spec import AttentionSpec, QuantScales  # noqa: F401
from repro_torch.attention.state import (KVCacheState,  # noqa: F401
                                         PagedKVState)

from repro_torch.attention import backends as _backends  # noqa: F401,E402

__all__ = [
    "AttentionSpec", "QuantScales", "KVCacheState", "PagedKVState",
    "Backend", "BackendUnsupported", "dispatch", "list_backends",
    "backend_reasons", "register_backend", "get_backend", "all_backends",
]
