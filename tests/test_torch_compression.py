"""Gradient compression (``repro_torch.runtime.compression``) against the
JAX package's ``repro.runtime.compression``, bit for bit: the int8
gradients, their scales, the error-feedback residuals over three steps
and the decompressed gradients. (``compressed_psum`` over four ranks is
in ``tests/test_torch_distributed.py``.)"""

import numpy as np

import jax.numpy as jnp

from repro.runtime import compression as JC
from repro_torch.runtime import compression as TC

import torch


def _grads(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((33, 17)).astype(np.float32) * 1e-3,
            "b": rng.standard_normal(17).astype(np.float32),
            "z": np.zeros(5, np.float32)}


def test_ef_compress_decompress_match_reference_bit_for_bit():
    j_ef = JC.init_ef_state({n: jnp.asarray(g) for n, g in _grads(0).items()})
    t_ef = TC.init_ef_state({n: torch.from_numpy(g)
                             for n, g in _grads(0).items()})
    for step in range(3):
        g = _grads(step)
        jq, js, j_ef = JC.ef_compress({n: jnp.asarray(a)
                                       for n, a in g.items()}, j_ef)
        tq, ts, t_ef = TC.ef_compress({n: torch.from_numpy(a)
                                       for n, a in g.items()}, t_ef)
        for n in g:
            np.testing.assert_array_equal(tq[n].numpy(), np.asarray(jq[n]))
            assert tq[n].dtype == torch.int8
            np.testing.assert_array_equal(ts[n].numpy(), np.asarray(js[n]))
            np.testing.assert_array_equal(t_ef[n].numpy(),
                                          np.asarray(j_ef[n]))
        jd, td = JC.ef_decompress(jq, js), TC.ef_decompress(tq, ts)
        for n in g:
            np.testing.assert_array_equal(td[n].numpy(), np.asarray(jd[n]))
