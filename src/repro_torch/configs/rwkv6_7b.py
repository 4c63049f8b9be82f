"""RWKV6-7B "Finch" [arXiv:2404.05892; hf] — attention-free SSM with
data-dependent decay.

32 layers, d=4096 (64 heads x hd 64 in time-mix), channel-mix ff 14336,
vocab 65536. No softmax attention anywhere, so ITA's softmax has no site
here. Constant-state recurrence. A copy of ``repro.configs.rwkv6_7b``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b", family="ssm",
    d_model=4096, n_heads=64, n_kv_heads=64, head_dim=64,
    d_ff=14336, vocab_size=65536,
    layer_groups=((("rwkv",), 32),),
    mlp_type="rwkv", rope_theta=0.0, tie_embeddings=False,
    subquadratic=True,
)

SMOKE = ModelConfig(
    name="rwkv6-smoke", family="ssm",
    d_model=64, n_heads=2, n_kv_heads=2, head_dim=32,
    d_ff=128, vocab_size=512,
    layer_groups=((("rwkv",), 2),),
    mlp_type="rwkv", rope_theta=0.0, tie_embeddings=False,
    subquadratic=True, dtype="float32",
)
