"""Roofline of one step of the port on one NVIDIA H100
(``repro.roofline.analysis``, rewritten for the card).

Three terms per step, in seconds:

    compute    = int8 ops / int8 peak + bf16 FLOPs / bf16 peak
                 + float32 FLOPs / float32 peak
    memory     = bytes / HBM rate
    collective = collective bytes / NVLink rate  (0 on one card)

The counts come from ``roofline.op_costs``, which counts one eager step
of the port (every aten matmul by dtype, and the nine kernels by one
formula of each call's shapes and masks). ``param_counts``,
``attention_flops`` and ``model_flops`` are the reference's analytic
"useful" FLOPs, copied as they are: the same numbers for the same
config and shape.

Hardware model: H100 SXM5 80 GB, NVIDIA's data-sheet dense peaks at
700 W (no sparsity): 989.4 TFLOP/s bf16, 1978.9 TOP/s int8, 66.9 TFLOP/s
float32 outside the tensor cores (the port keeps TF32 off:
``kernels.common.exact_float32_matmul``), 3.35 TB/s HBM3, 450 GB/s
NVLink per direction. A card set below 700 W runs slower under load: a
share against these peaks is stated beside the card's power limit.
"""

from __future__ import annotations

import dataclasses

HW = {
    "peak_bf16": 989.4e12,
    "peak_int8": 1978.9e12,
    "peak_fp32": 66.9e12,
    "hbm_bw": 3.35e12,
    "link_bw": 450e9,
}


def least_ms(nbytes: float, ops: float, peak: str = "peak_int8"):
    """The least time for ``nbytes`` moved through HBM and ``ops``
    operations at ``HW[peak]``: ``(ms, "bytes" or "operations")``, the
    larger of the two terms."""
    t_bytes = nbytes / HW["hbm_bw"] * 1e3
    t_ops = ops / HW[peak] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def weight_floor_ms(nbytes: float) -> float:
    """Milliseconds to read ``nbytes`` of weights once from HBM."""
    return 1e3 * nbytes / HW["hbm_bw"]


@dataclasses.dataclass
class Roofline:
    flops: float                 # every counted operation (matmul FLOPs
                                 # and the kernels' integer ops)
    hbm_bytes: float             # matmul operands + results, kernel bytes
    coll_bytes: float            # collective operand bytes (0 on one card)
    model_flops: float           # analytic useful FLOPs (``model_flops``)
    chips: int = 1
    flops_int8: float = 0.0      # of ``flops``, on int8 operands
    flops_fp32: float = 0.0      # of ``flops``, on float32/float64 operands

    @property
    def flops_bf16(self):
        return self.flops - self.flops_int8 - self.flops_fp32

    @property
    def compute_s(self):
        return self.flops_int8 / HW["peak_int8"] \
            + self.flops_bf16 / HW["peak_bf16"] \
            + self.flops_fp32 / HW["peak_fp32"]

    @property
    def memory_s(self):
        return self.hbm_bytes / HW["hbm_bw"]

    @property
    def collective_s(self):
        return self.coll_bytes / HW["link_bw"] if self.chips > 1 else 0.0

    @property
    def bottleneck(self):
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_s(self):
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_ratio(self):
        total = self.flops * self.chips
        return self.model_flops / total if total else 0.0

    def mfu(self, measured_s: float) -> float:
        """Model FLOPs utilization: ``model_flops`` over the chips' bf16
        peak times the measured step."""
        return self.model_flops / (HW["peak_bf16"] * self.chips * measured_s)

    def share(self, measured_s: float) -> float:
        """The roofline's share of the measured step: ``step_s`` over it."""
        return self.step_s / measured_s

    def row(self):
        return dict(flops=self.flops, hbm_bytes=self.hbm_bytes,
                    coll_bytes=self.coll_bytes,
                    compute_s=self.compute_s, memory_s=self.memory_s,
                    collective_s=self.collective_s,
                    bottleneck=self.bottleneck,
                    model_flops=self.model_flops,
                    useful_ratio=self.useful_ratio,
                    flops_int8=self.flops_int8, flops_bf16=self.flops_bf16,
                    flops_fp32=self.flops_fp32)


# ---------------------------------------------------------------------------
# Analytic "useful" FLOPs (MODEL_FLOPS): 6·N·D dense / 6·N_active·D MoE,
# plus attention terms (not captured by 6ND).
# ---------------------------------------------------------------------------

def param_counts(cfg) -> dict:
    """Analytic parameter counts (matches init_model to ~1%)."""
    d, f, v = cfg.d_model, cfg.d_ff, cfg.vocab_size
    h, g, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    attn = d * h * hd + 2 * d * g * hd + h * hd * d
    mlp = {"swiglu": 3 * d * f, "geglu": 3 * d * f, "gelu": 2 * d * f,
           "moe": 0, "rwkv": 0}[cfg.mlp_type]
    moe = 3 * d * f * cfg.n_experts + d * cfg.n_experts
    moe_active = 3 * d * f * cfg.n_experts_active + d * cfg.n_experts
    dr = cfg.rnn_width or d
    # 2 input branches + out proj + block-diag gates + conv + lambda
    rglru = 3 * d * dr + 2 * dr * (dr // max(cfg.n_heads, 1)) + 5 * dr
    rwkv_tm = 5 * d * d + d * (5 * 64) + 5 * 64 * d + 2 * d * 64
    rwkv_cm = 2 * d * f + d * d

    total = active = 0
    for pattern, n in cfg.layer_groups:
        for kind in pattern:
            if kind in ("attn", "local", "swa", "enc"):
                blk = attn + (moe if cfg.mlp_type == "moe" else mlp)
                blk_a = attn + (moe_active if cfg.mlp_type == "moe" else mlp)
            elif kind == "cross":
                blk = blk_a = attn + 3 * d * f
            elif kind == "attn_cross":
                blk = blk_a = 2 * attn + 2 * d * f
            elif kind == "rglru":
                blk = blk_a = rglru + 3 * d * f
            elif kind == "rwkv":
                blk = blk_a = rwkv_tm + rwkv_cm
            total += blk * n
            active += blk_a * n
    if cfg.n_encoder_layers:
        total += cfg.n_encoder_layers * (attn + 2 * d * f)
        active += cfg.n_encoder_layers * (attn + 2 * d * f)
    emb = v * d * (1 if cfg.tie_embeddings else 2)
    return {"backbone": total, "backbone_active": active, "embedding": emb,
            "total": total + emb,
            "total_active": active + emb}


def attention_flops(cfg, seq, batch, kind="train", kv_len=None):
    """QK^T + AV flops across all attention layers (2·2·S·Skv·H·hd each,
    causal halving for self-attn in train/prefill)."""
    h, hd = cfg.n_heads, cfg.head_dim
    total = 0.0
    for pattern, n in cfg.layer_groups:
        for k in pattern:
            if k in ("attn", "enc"):
                skv = kv_len if kind == "decode" else seq
                sq = 1 if kind == "decode" else seq
                causal_f = 0.5 if kind != "decode" else 1.0
                total += n * 4 * sq * skv * h * hd * causal_f
            elif k in ("local", "swa"):
                w = cfg.local_window if k == "local" else cfg.window
                skv = min(kv_len or seq, w) if kind == "decode" \
                    else min(seq, w)
                sq = 1 if kind == "decode" else seq
                total += n * 4 * sq * skv * h * hd \
                    * (0.5 if kind != "decode" and seq <= w else 1.0)
            elif k == "cross":
                sq = 1 if kind == "decode" else seq
                total += n * 4 * sq * cfg.n_frontend_tokens * h * hd
            elif k == "attn_cross":
                skv = kv_len if kind == "decode" else seq
                sq = 1 if kind == "decode" else seq
                causal_f = 0.5 if kind != "decode" else 1.0
                total += n * (4 * sq * skv * h * hd * causal_f
                              + 4 * sq * cfg.n_frontend_tokens * h * hd)
    if cfg.n_encoder_layers and kind != "decode":
        total += cfg.n_encoder_layers * 4 * cfg.n_frontend_tokens ** 2 \
            * h * hd
    return total * batch


def model_flops(cfg, shape) -> float:
    """Analytic useful FLOPs for one step of the given shape (global)."""
    counts = param_counts(cfg)
    n_active = counts["backbone_active"] + (
        0 if cfg.tie_embeddings else cfg.vocab_size * cfg.d_model)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        mm = 6 * n_active * tokens \
            + 6 * cfg.vocab_size * cfg.d_model * tokens  # unembed fwd+bwd
        attn = 3 * attention_flops(cfg, shape.seq_len, shape.global_batch,
                                   "train")
        return mm + attn
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2 * n_active * tokens \
            + 2 * cfg.vocab_size * cfg.d_model * tokens \
            + attention_flops(cfg, shape.seq_len, shape.global_batch,
                              "prefill")
    tokens = shape.global_batch                      # decode: 1 token each
    # at decode the encoder does not run and cross-attention K/V come from
    # the prefill-time cache — exclude those parameters
    d, h, g, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    n_dec = n_active
    if cfg.n_encoder_layers:
        n_dec -= cfg.n_encoder_layers * (
            d * h * hd + 2 * d * g * hd + h * hd * d + 2 * d * cfg.d_ff)
    n_cross = sum(n * pattern.count("cross") + n * pattern.count("attn_cross")
                  for pattern, n in cfg.layer_groups)
    n_dec -= n_cross * 2 * d * g * hd                # cached cross K/V proj
    return 2 * n_dec * tokens \
        + 2 * cfg.vocab_size * cfg.d_model * tokens \
        + attention_flops(cfg, 1, shape.global_batch, "decode",
                          kv_len=shape.seq_len)


def matmul_term(cfg, shape) -> float:
    """``model_flops``'s matmul term: all of it but the attention's
    QKᵀ and AV. For an untied embedding it counts the embedding table as
    a matmul too (``n_active`` holds it), which a lookup is not: the
    port's matmuls compute ``matmul_term - lookup_term``."""
    if shape.kind == "decode":
        attn = attention_flops(cfg, 1, shape.global_batch, "decode",
                               kv_len=shape.seq_len)
    else:
        attn = attention_flops(cfg, shape.seq_len, shape.global_batch,
                               shape.kind) * (3 if shape.kind == "train"
                                              else 1)
    return model_flops(cfg, shape) - attn


def lookup_term(cfg, shape) -> float:
    """The untied embedding table's share of ``matmul_term`` (0 when
    tied): ``2·V·d`` a token, three times in a train step."""
    if cfg.tie_embeddings:
        return 0.0
    tokens = shape.global_batch * (1 if shape.kind == "decode"
                                   else shape.seq_len)
    return (6 if shape.kind == "train" else 2) * cfg.vocab_size \
        * cfg.d_model * tokens
