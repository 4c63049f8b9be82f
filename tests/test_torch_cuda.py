"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: without a card the test skips. It imports neither JAX
nor ``repro``, so it runs where only torch and the CUDA toolkit are
installed: ``python -m pytest -m cuda tests/test_torch_cuda.py``. Each kernel
must equal its plain version on the same CUDA tensors bit for bit: 3D
and 4D rings, GQA, ragged rows and query counts, causal and windowed,
adaptive and paper DI, short rings (one tile of 20) and multi-tile ones.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.common import exact_float32_matmul
from repro_torch.kernels.ita_attention import kernel as K

CASES = [
    # kind, b, hq, hkv, sq, skv, d, block_kv, causal, window, layout
    ("onepass", 2, 2, 2, 16, 48, 16, 128, True, 0, "3d"),
    ("onepass", 2, 4, 2, 40, 256, 16, 128, True, 0, "4d"),
    ("onepass", 1, 4, 1, 32, 256, 32, 64, True, 40, "3d"),
    ("onepass", 1, 2, 1, 8, 128, 16, 64, False, 0, "4d"),
    ("onepass", 1, 4, 2, 64, 512, 128, 256, True, 0, "4d"),
    ("decode", 2, 2, 1, 1, 20, 16, 128, True, 0, "3d"),
    ("decode", 2, 4, 2, 1, 256, 16, 128, True, 0, "4d"),
    ("decode", 1, 4, 2, 4, 256, 32, 64, True, 70, "4d"),
    ("decode", 1, 4, 2, 8, 384, 16, 128, True, 0, "3d"),
    ("decode", 2, 28, 4, 3, 640, 128, 128, True, 0, "4d"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES, ids=[
    f"{c[0]}-{c[10]}-sq{c[4]}-skv{c[5]}-d{c[6]}-w{c[9]}" for c in CASES])
def test_cuda_kernel_matches_plain(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU build)")
    exact_float32_matmul()
    kind, b, hq, hkv, sq, skv, d, bkv, causal, window, layout = case
    rng = np.random.default_rng(b * 1000 + skv + sq)
    bh, rep = b * hq, hq // hkv
    kv_shape = (b, skv, hkv, d) if layout == "4d" else (b * hkv, skv, d)

    def t(a):
        return torch.from_numpy(np.asarray(a)).cuda()

    q = t(rng.integers(-128, 128, (bh, sq, d), dtype=np.int8))
    k = t(rng.integers(-128, 128, kv_shape, dtype=np.int8))
    v = t(rng.integers(-128, 128, kv_shape, dtype=np.int8))
    lmult = t(rng.uniform(0.004, 0.03, bh).astype(np.float32))
    omult = t(rng.uniform(0.5, 2.0, bh).astype(np.float32))
    kv_len = rng.integers(sq, skv + 1, bh).astype(np.int32)
    q_len = rng.integers(1, sq + 1, bh).astype(np.int32) \
        if kind == "onepass" else np.full(bh, sq, np.int32)
    fn = K.ita_attention_onepass if kind == "onepass" \
        else K.ita_attention_decode
    for adaptive in (True, False):
        kw = dict(q_offset=t(np.maximum(kv_len - sq, 0)), q_len=t(q_len),
                  causal=causal, window=window, adaptive=adaptive,
                  block_kv=min(bkv, skv), kv_rep=rep,
                  hq=hq if layout == "4d" else None)
        got = fn(q, k, v, lmult, omult, t(kv_len), **kw)
        want = K.attention_plain(q, k, v, lmult, omult, t(kv_len), **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, want), adaptive
