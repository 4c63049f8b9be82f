"""Mixtral-8x7B [arXiv:2401.04088; hf] — 8-expert top-2 MoE with SWA.

32 layers, d=4096, 32 heads / 8 KV (hd 128), 8 experts (ff 14336) top-2,
vocab 32000, sliding window 4096 (per the assignment). Sub-quadratic via
SWA -> long_500k runs (fixed 4096-entry ring KV cache). A copy of
``repro.configs.mixtral_8x7b``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b", family="moe",
    d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=32000,
    layer_groups=((("swa",), 32),),
    mlp_type="moe", n_experts=8, n_experts_active=2, window=4096,
    rope_theta=1e6, tie_embeddings=False, subquadratic=True,
)

SMOKE = ModelConfig(
    name="mixtral-smoke", family="moe",
    d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=96, vocab_size=512,
    layer_groups=((("swa",), 2),),
    mlp_type="moe", n_experts=4, n_experts_active=2, window=16,
    tie_embeddings=False, subquadratic=True, dtype="float32",
)
