"""Phi-3-mini-3.8B [arXiv:2404.14219; unverified] — dense MHA.

32 layers, d=3072, 32 heads (kv=32, hd 96), SwiGLU ff 8192, vocab 32064.
Full attention -> long_500k skipped. A copy of
``repro.configs.phi3_mini_3_8b``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi3-mini-3.8b", family="dense",
    d_model=3072, n_heads=32, n_kv_heads=32, head_dim=96,
    d_ff=8192, vocab_size=32064,
    layer_groups=((("attn",), 32),),
    rope_theta=10000.0, tie_embeddings=False,
)

SMOKE = ModelConfig(
    name="phi3-smoke", family="dense",
    d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=512,
    layer_groups=((("attn",), 2),), tie_embeddings=False, dtype="float32",
)
