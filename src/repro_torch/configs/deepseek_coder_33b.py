"""DeepSeek-Coder-33B [arXiv:2401.14196; hf] — llama-arch dense GQA.

62 layers, d=7168, 56 heads / 8 KV heads (hd 128), SwiGLU ff 19200,
vocab 32256. Full attention -> long_500k skipped. A copy of
``repro.configs.deepseek_coder_33b``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-coder-33b", family="dense",
    d_model=7168, n_heads=56, n_kv_heads=8, head_dim=128,
    d_ff=19200, vocab_size=32256,
    layer_groups=((("attn",), 62),),
    rope_theta=100000.0, tie_embeddings=False,
)

SMOKE = ModelConfig(
    name="deepseek-smoke", family="dense",
    d_model=64, n_heads=8, n_kv_heads=2, head_dim=8,
    d_ff=160, vocab_size=512,
    layer_groups=((("attn",), 2),), tie_embeddings=False, dtype="float32",
)
