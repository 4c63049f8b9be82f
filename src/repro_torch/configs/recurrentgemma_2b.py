"""RecurrentGemma-2B [arXiv:2402.19427; hf] — hybrid RG-LRU + local attn 1:2.

26 layers: (RG-LRU, RG-LRU, local-attn) x 8 + (RG-LRU, RG-LRU) tail.
MQA (kv=1), local window 2048, GeGLU MLP, embeddings scaled by sqrt(d).
Sub-quadratic (constant RG-LRU state + windowed attention). A copy of
``repro.configs.recurrentgemma_2b``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b", family="hybrid",
    d_model=2560, n_heads=10, n_kv_heads=1, head_dim=256,
    d_ff=7680, vocab_size=256000,
    layer_groups=((("rglru", "rglru", "local"), 8), (("rglru", "rglru"), 1)),
    mlp_type="geglu", local_window=2048, rnn_width=2560,
    rope_theta=10000.0, embed_scale=True, subquadratic=True,
    parallelism="fsdp", param_dtype="bfloat16",
)

SMOKE = ModelConfig(
    name="recurrentgemma-smoke", family="hybrid",
    d_model=64, n_heads=2, n_kv_heads=1, head_dim=32,
    d_ff=128, vocab_size=512,
    layer_groups=((("rglru", "rglru", "local"), 1), (("rglru", "rglru"), 1)),
    mlp_type="geglu", local_window=16, rnn_width=64,
    embed_scale=True, subquadratic=True, dtype="float32",
)
