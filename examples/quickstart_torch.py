"""Quickstart of the PyTorch/CUDA port: the ITA integer softmax and the
attention engine in a minute (``examples/quickstart.py`` in PyTorch).

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]

On the card (the default) the fused attention runs the CUDA kernels; on
the CPU their plain versions.
"""

import argparse

import numpy as np
import torch

from repro_torch import attention as ATT
from repro_torch.core import softmax as S
from repro_torch.core.quant import EPS_MAX
from repro_torch.device import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    dev = resolve_device(ap.parse_args(argv).device)
    rng = np.random.default_rng(0)

    # --- 1. the paper's softmax: shift-only, integer, streaming ----------
    logits = rng.normal(0, 1.0, (4, 256))
    lq = torch.from_numpy(np.clip(np.round(logits / EPS_MAX), -128, 127)
                          .astype(np.int8)).to(dev)
    p_float = S.softmax_float(lq)                # float oracle
    p_ita = S.ita_softmax(lq)                    # paper semantics
    p_adaptive = S.ita_softmax_adaptive(lq)      # per-row adaptive scale
    print("ITA softmax MAE vs float:      %.4f"
          % float((p_ita - p_float).abs().mean()))
    print("adaptive softmax MAE vs float: %.4f"
          % float((p_adaptive - p_float).abs().mean()))

    # --- 2. the attention engine: one spec, capability-dispatched ---------
    b, h, s, d = 1, 4, 256, 64

    def int8(shape):
        return torch.from_numpy(rng.integers(-128, 128, shape,
                                             dtype=np.int8)).to(dev)
    q, k, v = int8((b, h, s, d)), int8((b, h, s, d)), int8((b, h, s, d))
    spec = ATT.AttentionSpec(mode="prefill", impl="ita", causal=True,
                             layout="bhsd", out_dtype="int8")
    scales = ATT.QuantScales.per_tensor(np.float32(0.04),
                                        s_out=np.float32(0.02))
    print("eligible backends:", ATT.list_backends(spec))
    out = ATT.dispatch(q, k, v, spec=spec, scales=scales)  # first eligible
    print("fused attention out:", tuple(out.shape), out.dtype,
          "sample:", out[0, 0, 0, :4].tolist())
    # the paper-faithful two-pass dataflow (the A matrix in memory)
    out2 = ATT.dispatch(q, k, v, spec=spec, scales=scales,
                        backend="ita_twopass_pallas")
    agree = float((out == out2).float().mean())
    print(f"onepass vs twopass int8 agreement: {agree:.3f} "
          "(different EN semantics, same algorithm)")

    # a softcapped decode spec cannot ride the fused kernels: the
    # registry says why, and who serves it instead
    cap_spec = spec.replace(mode="decode", softcap=30.0, layout="bshd",
                            q_len=1)
    print("softcap decode verdicts:")
    for name, verdict in ATT.backend_reasons(cap_spec).items():
        print(f"  {name:20s} {'OK' if verdict is True else verdict}")


if __name__ == "__main__":
    main()
