"""Llama-3.2-Vision-90B [hf:meta-llama/Llama-3.2-11B-Vision scaled;
unverified] — VLM with cross-attn image layers.

100 layers = (4 self-attn + 1 gated cross-attn) x 20, d=8192, 64 heads /
8 KV (hd 128), SwiGLU ff 28672, vocab 128256. Vision frontend stubbed:
the caller passes precomputed patch embeddings (1601 tokens, dim 1280),
projected into d_model. A copy of ``repro.configs.llama32_vision_90b``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b", family="vlm",
    d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=28672, vocab_size=128256,
    layer_groups=(
        (("attn", "attn", "attn", "attn", "cross"), 20),),
    rope_theta=500000.0, tie_embeddings=False,
    frontend_dim=1280, n_frontend_tokens=1601,
)

SMOKE = ModelConfig(
    name="llama-vision-smoke", family="vlm",
    d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=512,
    layer_groups=((("attn", "attn", "attn", "attn", "cross"), 1),),
    tie_embeddings=False, frontend_dim=32, n_frontend_tokens=16,
    dtype="float32",
)
