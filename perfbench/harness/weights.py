"""Weights from the seed, made on the device in a few large calls, and
the served model built around them.

``make(mc, seed, device)`` draws every projection from one
``torch.Generator`` on ``device`` into three flat buffers in the
compute dtype, one per scale (``d^-0.5`` for the embedding, the
unembedding, Q/K/V and the gate and up projections; ``(H·hd)^-0.5`` for
the attention output; ``f^-0.5`` for the down projections), with one
``randn`` and one multiply each. Norm gains are zeros (RMSNorm's ``1 +
gain``) and the four quantization scales of every layer are 0.05 in the
parameter dtype. The tree's
leaves are views of those buffers: ``embed``, ``unembed``,
``final_norm`` and ``layers`` (``norm1``, ``wq``, ``wk``, ``wv``,
``wo``, ``s_q``, ``s_k``, ``s_v``, ``s_out``, ``norm2`` and the MLP's
``w_gate``, ``w_up``, ``w_down``).

``serve_model(tree, port_cfg)`` builds the program's ``Transformer`` on
the meta device and makes each of its parameters a view of the same
tree, so the program and the reference read one set of tensors.
"""

from __future__ import annotations

import numpy as np
import torch

SCALE = 0.05
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _leaves(mc: dict):
    """``(layer or None, name, shape, group)`` of every drawn leaf, in
    drawing order; group in ``in``, ``out``, ``down``."""
    d, h, g, hd, f, v = (mc[k] for k in ("d_model", "n_heads", "n_kv_heads",
                                         "head_dim", "d_ff", "vocab_size"))
    yield None, "embed", (v, d), "in"
    yield None, "unembed", (d, v), "in"
    for i in range(mc["n_layers"]):
        yield i, "wq", (d, h * hd), "in"
        yield i, "wk", (d, g * hd), "in"
        yield i, "wv", (d, g * hd), "in"
        yield i, "wo", (h * hd, d), "out"
        yield i, "w_gate", (d, f), "in"
        yield i, "w_up", (d, f), "in"
        yield i, "w_down", (f, d), "down"


def make(mc: dict, seed: int, device) -> dict:
    """The weight tree of ``mc`` under ``seed`` (module docstring)."""
    dev = torch.device(device)
    dt, pdt = DTYPES[mc["dtype"]], DTYPES[mc["param_dtype"]]
    std = {"in": mc["d_model"] ** -0.5,
           "out": (mc["n_heads"] * mc["head_dim"]) ** -0.5,
           "down": mc["d_ff"] ** -0.5}
    leaves = list(_leaves(mc))
    sizes = {grp: 0 for grp in std}
    for _, _, shape, grp in leaves:
        sizes[grp] += int(np.prod(shape))
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed) % 2**64)
    flat = {}
    for grp in ("in", "out", "down"):
        buf = torch.empty(sizes[grp], dtype=dt, device=dev)
        flat[grp] = buf.normal_(0.0, 1.0, generator=gen).mul_(std[grp])
    used = {grp: 0 for grp in flat}
    tree = {"layers": [{} for _ in range(mc["n_layers"])]}
    for layer, name, shape, grp in leaves:
        n = int(np.prod(shape))
        t = flat[grp][used[grp]:used[grp] + n].view(shape)
        used[grp] += n
        (tree if layer is None else tree["layers"][layer])[name] = t
    zeros = torch.zeros((2 * mc["n_layers"] + 1, mc["d_model"]), dtype=pdt,
                        device=dev)
    scales = torch.full((mc["n_layers"], 4), SCALE, dtype=pdt, device=dev)
    tree["final_norm"] = zeros[-1]
    for i, lw in enumerate(tree["layers"]):
        lw["norm1"], lw["norm2"] = zeros[2 * i], zeros[2 * i + 1]
        for j, s in enumerate(("s_q", "s_k", "s_v", "s_out")):
            lw[s] = scales[i, j]
    return tree


def _port_leaf(tree: dict, name: str) -> torch.Tensor:
    """The tree's tensor for the program's parameter ``name``."""
    parts = name.split(".")
    if parts[0] != "blocks":
        return tree[name]
    return tree["layers"][int(parts[1])][parts[-1]]


def serve_model(tree: dict, port_cfg):
    """The program's ``Transformer`` over the tree's tensors."""
    from repro_torch.models.transformer import Transformer
    model = Transformer(port_cfg, device=torch.device("meta"))
    for mod_name, mod in model.named_modules():
        for pname, p in list(mod._parameters.items()):
            full = f"{mod_name}.{pname}" if mod_name else pname
            t = _port_leaf(tree, full)
            if t.shape != p.shape or t.dtype != p.dtype:
                raise ValueError(f"{full}: the tree holds {tuple(t.shape)}/"
                                 f"{t.dtype}, the program wants "
                                 f"{tuple(p.shape)}/{p.dtype}")
            mod._parameters[pname] = torch.nn.Parameter(t,
                                                        requires_grad=False)
    return model
