"""The served decoder in plain PyTorch, one request at a time.

``logits_at(weights, mc, tokens, positions, precision)`` runs the whole
forward of ``tokens`` (a 1-d int tensor: a prompt and the tokens served
after it) and returns the float32 logits at ``positions`` only.
``weights`` is the benchmark's own tree (``harness/weights.py``):
``embed`` (V, d), ``unembed`` (d, V), ``final_norm`` (d,), and per
layer ``norm1``, ``norm2``, ``wq`` (d, H·hd), ``wk``/``wv`` (d, G·hd),
``wo`` (H·hd, d), the 0-d quantization scales ``s_q``, ``s_k``,
``s_v``, ``s_out``, and the MLP: ``w_gate``/``w_up`` (d, f), ``w_down``
(f, d).

The block: ``x + wo(ITA(rope(q8), rope(k8), v8))`` with RMSNorm
(``x · rsqrt(mean x² + 1e-6) · (1 + gain)``) before it, then ``x +
swiglu(rmsnorm(x))``. RoPE rotates the two halves of
each head by ``pos · theta^(-i / (hd/2))``.

``precision``:

- ``"compute"``: the configuration's stated precision, its ``dtype``
  (bfloat16 here): activations stored in it after every operation, each
  product taken in it with float32 accumulation over blocks of 128 rows
  (the last zero-padded), norms, RoPE and the quantizers computed in
  float32 and rounded once. The check's reference.
- ``"fp8"``: the control, one precision below the stated one: as
  ``"compute"``, but every projection of a block (Q, K, V, O and the
  MLP) takes its input rounded through float8 e4m3 per row and its
  weight per tensor, each scaled so its largest magnitude lands on 448
  (norms, ITA arithmetic and LM head as stated).

Each layer's leaves are widened when the layer runs, so the reference
never holds a float32 copy of the model.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from perfbench.reference import ita

E4M3_MAX = 448.0
ROWS = 128
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class Precision:
    def __init__(self, name: str, mc: dict):
        if name not in ("compute", "fp8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name
        self.dt = DTYPES[mc["dtype"]]

    def cast(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.dt)

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """``x (n, K) @ w (K, N)`` in blocks of 128 rows, stored in the
        precision's dtype."""
        if self.name == "fp8":
            x = _fp8(x.float(), -1).to(self.dt)
            w = _fp8(w.float(), None).to(self.dt)
        w = w.to(self.dt)
        return _row_blocks(x.to(self.dt), lambda rows: rows @ w)


def _fp8(x: torch.Tensor, dim) -> torch.Tensor:
    amax = x.abs().amax(dim=dim, keepdim=dim is not None)
    scale = torch.clamp(amax, min=1e-30) / E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def _row_blocks(x: torch.Tensor, fn) -> torch.Tensor:
    """``fn`` over blocks of 128 rows of x (n, K), the last zero-padded."""
    n = x.shape[0]
    pad = (-n) % ROWS
    if pad:
        x = torch.cat([x, x.new_zeros((pad, x.shape[1]))])
    return torch.cat([fn(x[i:i + ROWS]) for i in range(0, n + pad, ROWS)])[:n]


def rmsnorm(x: torch.Tensor, gain: torch.Tensor, p: Precision):
    xf = x.float()
    var = _row_blocks(xf * xf, lambda r: torch.mean(r, dim=-1, keepdim=True))
    return p.cast(xf * torch.rsqrt(var + 1e-6) * (1.0 + gain.float()))


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float, p: Precision):
    """x (S, H, hd), pos (S,)."""
    half = x.shape[-1] // 2
    f = torch.arange(0, half, dtype=torch.float32, device=x.device)
    freq = torch.pow(ita.f32(theta, x.device), -f / ita.f32(half, x.device))
    ang = pos.float()[:, None] * freq
    sin, cos = torch.sin(ang)[:, None, :], torch.cos(ang)[:, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return p.cast(torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1))


def _swiglu(h, wg, wu, wd, p: Precision):
    a = p.cast(F.silu(p.mm(h, wg)))
    return p.mm(p.cast(a * p.mm(h, wu)), wd)


def block(x, lw, mc, pos, p: Precision) -> torch.Tensor:
    s = x.shape[0]
    nh, g, hd = mc["n_heads"], mc["n_kv_heads"], mc["head_dim"]
    h = rmsnorm(x, lw["norm1"], p)
    q = p.mm(h, lw["wq"]).view(s, nh, hd)
    k = p.mm(h, lw["wk"]).view(s, g, hd)
    v = p.mm(h, lw["wv"]).view(s, g, hd)
    q, k = rope(q, pos, mc["rope_theta"], p), rope(k, pos, mc["rope_theta"], p)
    sc = {n: float(lw[n]) for n in ("s_q", "s_k", "s_v", "s_out")}
    lmult, omult = ita.multipliers(sc["s_q"], sc["s_k"], sc["s_v"],
                                   sc["s_out"], hd, x.device)
    out8 = ita.attention(ita.quantize(q, sc["s_q"]).transpose(0, 1),
                         ita.quantize(k, sc["s_k"]).transpose(0, 1),
                         ita.quantize(v, sc["s_v"]).transpose(0, 1),
                         lmult, omult)
    y = p.cast((out8 * ita.f32(sc["s_out"], x.device)).transpose(0, 1))
    x = x + p.mm(y.reshape(s, nh * hd), lw["wo"])
    h = rmsnorm(x, lw["norm2"], p)
    return x + _swiglu(h, lw["w_gate"], lw["w_up"], lw["w_down"], p)


@torch.no_grad()
def logits_at(weights, mc: dict, tokens: torch.Tensor, positions,
              precision: str = "compute") -> torch.Tensor:
    """Float32 logits (len(positions), V) of the forward of ``tokens``."""
    p = Precision(precision, mc)
    dev = weights["embed"].device
    tokens = torch.as_tensor(tokens, device=dev).long()
    pos = torch.arange(tokens.shape[0], device=dev)
    x = p.cast(weights["embed"][tokens])
    for lw in weights["layers"]:
        x = block(x, lw, mc, pos, p)
    sel = torch.as_tensor(positions, device=dev).long()
    x = rmsnorm(x[sel], weights["final_norm"], p)
    return Precision("compute", mc).mm(x, weights["unembed"]).float()
