"""The yardstick's arithmetic: the card's bf16 peak and the model FLOPs
a served request needs, counted from its lengths alone, so the count is
the same whatever implements it.

Peak: NVIDIA's data sheet for the H100 SXM5 80 GB at 700 W, dense bf16
without sparsity (a frozen copy of ``repro_torch.roofline.analysis.HW``).

Model FLOPs (``request_model_flops``): a frozen copy of the arithmetic
of ``roofline.analysis.param_counts``/``attention_flops`` for decoder
stacks of global attention, counted per served request. Each prompt
token and each fed-back generated token passes every layer once (two
FLOPs per parameter); each of the
``gen`` tokens costs one unembedding (the prompt's other positions are
never unembedded); attention costs ``4 · H · hd`` FLOPs per (query,
visible key) pair, causal over the prompt and the whole prefix for each
generated token. The embedding lookup is no product and is not counted.
"""

from __future__ import annotations

PEAKS = {
    "bf16_flops": 989.4e12,
}


def active_params(mc: dict) -> int:
    """Parameters a token meets in one decoder layer of global attention
    and a SwiGLU MLP (norm gains and quantization scales are not
    products)."""
    d, h, g, hd, f = (mc[k] for k in ("d_model", "n_heads", "n_kv_heads",
                                      "head_dim", "d_ff"))
    attn = d * h * hd + 2 * d * g * hd + h * hd * d
    return attn + 3 * d * f


def request_model_flops(mc: dict, plen: int, gen: int) -> float:
    """Useful FLOPs of serving one request of ``plen`` prompt tokens and
    ``gen`` generated ones (module docstring)."""
    layers = mc["n_layers"]
    fed = plen + max(gen - 1, 0)                  # tokens through the stack
    dense = 2.0 * active_params(mc) * layers * fed
    unembed = 2.0 * mc["vocab_size"] * mc["d_model"] * gen
    pairs = plen * (plen + 1) / 2 + sum(plen + i for i in range(1, gen))
    attn = 4.0 * mc["n_heads"] * mc["head_dim"] * layers * pairs
    return dense + unembed + attn
