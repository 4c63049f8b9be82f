"""OLMoE-1B-7B [arXiv:2409.02060; hf] — 64-expert top-8 MoE.

16 layers, d=2048, 16 heads (kv=16, hd 128), 64 experts (ff 1024 each)
top-8, vocab 50304. Full attention -> long_500k skipped. A copy of
``repro.configs.olmoe_1b_7b``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b", family="moe",
    d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=1024, vocab_size=50304,
    layer_groups=((("attn",), 16),),
    mlp_type="moe", n_experts=64, n_experts_active=8,
    rope_theta=10000.0, tie_embeddings=False,
    # §Perf winners: pure ZeRO-3 + bf16 params (12x MFU vs TP baseline;
    # grouped a2a dispatch is in the MoE layer itself).
    parallelism="fsdp", param_dtype="bfloat16",
)

SMOKE = ModelConfig(
    name="olmoe-smoke", family="moe",
    d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=32, vocab_size=512,
    layer_groups=((("attn",), 2),),
    mlp_type="moe", n_experts=8, n_experts_active=2,
    tie_embeddings=False, dtype="float32",
)
