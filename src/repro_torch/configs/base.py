"""Model configuration dataclass (a copy of ``repro.configs.base``).

A ``ModelConfig`` names the layer stack as *layer groups*:
``(pattern, n_periods)`` pairs. Pattern elements name block kinds
(``attn`` global self-attention, ``local``/``swa`` sliding window,
``cross``, ``attn_cross``, ``rglru``, ``rwkv``); this slice of the port
builds ``attn`` groups only. Field names and defaults match the JAX
package, so one config means the same thing in both.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense|moe|hybrid|ssm|audio|vlm
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    layer_groups: tuple[tuple[tuple[str, ...], int], ...]

    mlp_type: str = "swiglu"          # swiglu|geglu|gelu|moe|rwkv
    norm_type: str = "rmsnorm"
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    window: int = 0                   # swa kind
    local_window: int = 0             # local kind
    logit_softcap: float = 0.0
    attn_softcap: float = 0.0
    query_scale: float = 0.0          # 0 -> head_dim**-0.5
    causal: bool = True
    tie_embeddings: bool = True
    embed_scale: bool = False         # multiply embeddings by sqrt(d)
    sinusoidal_pos: bool = False      # whisper-style absolute positions

    # MoE
    n_experts: int = 0
    n_experts_active: int = 0

    # recurrent
    rnn_width: int = 0

    # modality frontend
    frontend_dim: int = 0
    n_frontend_tokens: int = 0
    n_encoder_layers: int = 0

    # ITA integration
    parallelism: str = "tp_fsdp"
    param_dtype: str = "float32"
    attention_impl: str = "float"     # float|ita|ibert
    attention_backend: str = ""       # preferred attention backend ("" = auto)
    softmax_impl: str = "ita_adaptive"  # ita_paper|ita_adaptive
    dtype: str = "bfloat16"
    remat: bool = True
    remat_policy: str = "full"
    ce_chunks: int = 1
    attn_q_chunk: int = 512           # streaming attention block sizes
    attn_kv_chunk: int = 512
    scan_unroll: bool = False

    subquadratic: bool = False

    @property
    def n_layers(self) -> int:
        return sum(len(pat) * n for pat, n in self.layer_groups)

    def compute_dtype(self) -> torch.dtype:
        return {"bfloat16": torch.bfloat16,
                "float32": torch.float32}[self.dtype]
