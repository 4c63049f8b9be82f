"""Model zoo of the port: decoders of attention blocks with SwiGLU,
GeGLU or mixture-of-experts MLPs, and of recurrent blocks (RG-LRU with
local attention; RWKV6)."""
from repro_torch.models.transformer import (forward,  # noqa: F401
                                            from_jax_params, init_caches,
                                            init_model, moe_aux_loss)
