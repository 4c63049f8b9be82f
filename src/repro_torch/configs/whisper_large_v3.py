"""Whisper-large-v3 [arXiv:2212.04356; unverified] — audio enc-dec.

32 encoder + 32 decoder layers, d=1280, 20 heads (MHA), GELU MLP,
LayerNorm, sinusoidal positions (conv frontend stubbed: the caller
passes precomputed 1500-frame embeddings, ``generate(frontend=)``).
Decoder layers: self-attn + cross-attn + MLP. A copy of
``repro.configs.whisper_large_v3``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3", family="audio",
    d_model=1280, n_heads=20, n_kv_heads=20, head_dim=64,
    d_ff=5120, vocab_size=51866,
    layer_groups=((("attn_cross",), 32),),
    mlp_type="gelu", norm_type="layernorm", rope_theta=0.0,
    sinusoidal_pos=True, tie_embeddings=True,
    n_encoder_layers=32, frontend_dim=1280, n_frontend_tokens=1500,
    parallelism="fsdp", param_dtype="bfloat16", remat_policy="dots",
)

SMOKE = ModelConfig(
    name="whisper-smoke", family="audio",
    d_model=64, n_heads=2, n_kv_heads=2, head_dim=32,
    d_ff=128, vocab_size=512,
    layer_groups=((("attn_cross",), 2),),
    mlp_type="gelu", norm_type="layernorm", rope_theta=0.0,
    sinusoidal_pos=True, n_encoder_layers=2, frontend_dim=64,
    n_frontend_tokens=16, dtype="float32",
)
