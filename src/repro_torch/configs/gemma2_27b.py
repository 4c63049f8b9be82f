"""Gemma2-27B [arXiv:2408.00118; hf] — local+global alternating, softcaps.

46 layers alternating (local window 4096, global), d=4608, 32 heads /
16 KV (hd 128), GeGLU ff 36864, vocab 256000, attn softcap 50, final logit
softcap 30, query scale (d/h)^-0.5 = 144^-0.5, pre+post norms, embeddings
scaled. A copy of ``repro.configs.gemma2_27b``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b", family="dense",
    d_model=4608, n_heads=32, n_kv_heads=16, head_dim=128,
    d_ff=36864, vocab_size=256000,
    layer_groups=((("local", "attn"), 23),),
    mlp_type="geglu", local_window=4096,
    attn_softcap=50.0, logit_softcap=30.0, query_scale=144.0 ** -0.5,
    embed_scale=True,
)

SMOKE = ModelConfig(
    name="gemma2-smoke", family="dense",
    d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=512,
    layer_groups=((("local", "attn"), 1),),
    mlp_type="geglu", local_window=16,
    attn_softcap=50.0, logit_softcap=30.0, query_scale=16.0 ** -0.5,
    embed_scale=True, dtype="float32",
)
