"""Qwen2-7B [arXiv:2407.10671; hf] — dense GQA with QKV bias.

28 layers, d=3584, 28 heads / 4 KV heads (hd 128), SwiGLU ff 18944,
vocab 152064, RoPE theta 1e6. A copy of ``repro.configs.qwen2_7b``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-7b", family="dense",
    d_model=3584, n_heads=28, n_kv_heads=4, head_dim=128,
    d_ff=18944, vocab_size=152064,
    layer_groups=((("attn",), 28),),
    qkv_bias=True, rope_theta=1e6, tie_embeddings=False,
)

SMOKE = ModelConfig(
    name="qwen2-smoke", family="dense",
    d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=512,
    layer_groups=((("attn",), 2),),
    qkv_bias=True, rope_theta=1e6, tie_embeddings=False, dtype="float32",
)
