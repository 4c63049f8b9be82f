"""Model zoo of the port: decoders of attention blocks with SwiGLU,
GeGLU, GELU or mixture-of-experts MLPs, of recurrent blocks (RG-LRU with
local attention; RWKV6) and of cross-attention blocks over a frontend's
memory (whisper's encoder–decoder; llama-vision's gated cross layers)."""
from repro_torch.models.transformer import (forward,  # noqa: F401
                                            from_jax_params, init_caches,
                                            init_model, jax_named_leaves,
                                            loss_fn, moe_aux_loss)
