"""The port's int8 matmul (ITA's quantized linear layer) against the JAX
package, on the CPU.

Inputs are made with numpy from a seed and go through
``repro.kernels.int8_matmul`` (the Pallas kernels in interpret mode, or
the plain reference) and through ``repro_torch.kernels.int8_matmul`` on
the CPU, where the kernel wrapper computes the plain version of its
schedule. The bar is bit-exact equality on the int8 grid
(``assert_array_equal``; tolerance 0). The CUDA kernels are held to the
plain versions on the card by ``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.int8_matmul.ops import int8_matmul as j_int8_matmul
from repro.kernels.int8_matmul.ref import int8_matmul_ref as j_ref
from repro_torch.core import quant as TQ
from repro_torch.kernels import common as TC
from repro_torch.kernels.int8_matmul import kernel as TK
from repro_torch.kernels.int8_matmul.ops import int8_matmul
from repro_torch.kernels.int8_matmul.ref import int8_matmul_ref as t_ref

SCHEDULES = ("tpu", "weight_stationary")


def _operands(seed, m, k, n, *, lo=-1000, hi=1000):
    rng = np.random.default_rng(seed)
    x = rng.integers(-128, 128, (m, k), dtype=np.int8)
    w = rng.integers(-128, 128, (k, n), dtype=np.int8)
    b = rng.integers(lo, hi, (n,), dtype=np.int32)
    return x, w, b


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


@pytest.mark.parametrize("m,k,n", [(8, 32, 16), (100, 200, 96),
                                   (256, 128, 128), (33, 65, 17)])
@pytest.mark.parametrize("schedule", SCHEDULES)
def test_int8_matmul_sweep_matches_jax(m, k, n, schedule):
    """``tests/test_kernels.py::test_int8_matmul_sweep``: the JAX wrapper
    (Pallas, interpret mode) and the port's, both padding, with blocks
    32/16/32 and a scalar multiplier."""
    x, w, b = _operands(m * 1000 + k + n, m, k, n)
    mult = np.float32(0.002)
    want = j_int8_matmul(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                         mult, block_m=32, block_n=16, block_k=32,
                         schedule=schedule)
    got = int8_matmul(*_t(x, w, b), mult, block_m=32, block_n=16,
                      block_k=32, schedule=schedule)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    ref = j_ref(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                jnp.broadcast_to(mult, (n,)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_int8_matmul_per_channel_and_batched(schedule):
    """``tests/test_kernels.py::test_int8_matmul_per_channel_and_batched``:
    leading batch dims, per-channel multipliers, no bias."""
    rng = np.random.default_rng(1)
    x = rng.integers(-128, 128, (2, 3, 40), dtype=np.int8)
    w = rng.integers(-128, 128, (40, 24), dtype=np.int8)
    mult = rng.uniform(1e-4, 1e-2, (24,)).astype(np.float32)
    want = j_int8_matmul(jnp.asarray(x), jnp.asarray(w), None,
                         jnp.asarray(mult), block_m=8, block_n=8, block_k=8,
                         schedule=schedule)
    got = int8_matmul(*_t(x, w), None, torch.from_numpy(mult), block_m=8,
                      block_n=8, block_k=8, schedule=schedule)
    assert got.shape == (2, 3, 24)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("m,k,n", [(4, 96, 40), (70, 300, 130)])
def test_use_pallas_false_is_the_plain_reference(m, k, n):
    x, w, b = _operands(2 + m, m, k, n)
    mult = np.random.default_rng(3).uniform(1e-4, 3e-3, n).astype(np.float32)
    want = j_int8_matmul(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                         jnp.asarray(mult), use_pallas=False)
    got = int8_matmul(*_t(x, w, b, mult), use_pallas=False)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        t_ref(*_t(x, w, b, mult)).numpy(),
        np.asarray(j_ref(*(jnp.asarray(a) for a in (x, w, b, mult)))))


@pytest.mark.parametrize("blocks", [(8, 8, 8), (16, 32, 64), (64, 16, 128),
                                    (256, 128, 128)])
def test_blocks_and_schedules_agree(blocks):
    """The accumulator is exact, so every block size and both schedules
    give the same int8 values (and equal the JAX package's)."""
    x, w, b = _operands(4, 50, 136, 44)
    mult = np.random.default_rng(5).uniform(2e-4, 2e-3, 44).astype(
        np.float32)
    bm, bn, bk = blocks
    want = np.asarray(j_int8_matmul(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), jnp.asarray(mult),
        use_pallas=False))
    for schedule in SCHEDULES:
        got = int8_matmul(*_t(x, w, b, mult), block_m=bm, block_n=bn,
                          block_k=bk, schedule=schedule)
        np.testing.assert_array_equal(got.numpy(), want)


def test_plain_product_is_exact_beyond_2_24():
    """K >= 4096 with full-range operands: partial sums pass 2^24 (where
    a float32 product stops being exact) and the plain product still
    equals numpy's int64 product, the JAX package's int32 product and,
    after requant, its int8 values, for both schedules."""
    rng = np.random.default_rng(6)
    m, k, n = 6, 4608, 12
    x = rng.choice(np.array([-128, -127, 127], np.int8), (m, k))
    w = rng.choice(np.array([-128, -127, 127], np.int8), (k, n))
    x[0], w[:, 0] = 127, 127                   # 127·127·4608 = 74,322,432
    x[1], w[:, 1] = -128, 127
    x[2] = rng.integers(-128, 128, k, dtype=np.int8)
    exact = x.astype(np.int64) @ w.astype(np.int64)
    assert np.abs(exact).max() > 2 ** 24
    acc = TQ.int8_matmul_ref(*_t(x, w))
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.numpy(), exact)
    b = rng.integers(-5000, 5000, n, dtype=np.int32)
    mult = np.full(n, 2.0 ** -20, np.float32)
    want = np.asarray(j_ref(*(jnp.asarray(a) for a in (x, w, b, mult))))
    np.testing.assert_array_equal(
        want, np.clip(np.round((exact + b).astype(np.float32) * mult),
                      -128, 127))
    for schedule in SCHEDULES:
        got = int8_matmul(*_t(x, w, b, mult), schedule=schedule)
        np.testing.assert_array_equal(got.numpy(), want)


def test_plain_versions_of_both_schedules():
    """``matmul_plain`` and ``matmul_ws_plain`` (the versions the kernels
    are held to on the card) equal the JAX package's plain reference."""
    x, w, b = _operands(7, 64, 256, 32)
    mult = np.random.default_rng(8).uniform(1e-4, 1e-3, 32).astype(
        np.float32)
    want = np.asarray(j_ref(*(jnp.asarray(a) for a in (x, w, b, mult))))
    tx, tw, tb, tm = _t(x, w, b, mult)
    np.testing.assert_array_equal(TK.matmul_plain(tx, tw, tb, tm).numpy(),
                                  want)
    for bk in (32, 128, 256):
        np.testing.assert_array_equal(
            TK.matmul_ws_plain(tx, tw, tb, tm, block_k=bk).numpy(), want)


def test_cpu_calls_count_no_launch_and_checks_operands():
    TK.reset_launches()
    x, w, b = _t(*_operands(9, 16, 32, 8))
    for schedule in SCHEDULES:
        int8_matmul(x, w, b, 0.01, schedule=schedule)
    assert TK.LAUNCHES == {"int8_matmul": 0, "int8_matmul_ws": 0}
    with pytest.raises(RuntimeError, match="CUDA tensors"):
        TK.kernel_launcher(x, w, b, 0.01)
    with pytest.raises(ValueError, match="multiple of the blocks"):
        TK.int8_matmul_kernel(x[:15], w, b, 0.01, block_m=8)
    with pytest.raises(ValueError, match="schedule"):
        TK.int8_matmul_kernel(x, w, b, 0.01, schedule="output_stationary")
    with pytest.raises(TypeError, match="int8"):
        TK.int8_matmul_kernel(x.int(), w, b, 0.01)


def test_block_defaults_recorded():
    """``tests/test_paged.py::test_block_defaults_recorded`` against the
    port: the matmul entry is 3-wide, read by ``default_matmul_blocks``,
    and ``default_blocks`` refuses it, naming the remedy."""
    for name in ("ita_onepass_pallas", "ita_twopass_pallas",
                 "ita_decode_pallas"):
        assert name in TC.BLOCK_DEFAULTS
        bq, bkv = TC.default_blocks(name)
        assert bkv in (64, 128, 256)
    assert TC.default_blocks("ita_decode_pallas")[0] is None
    assert TC.default_matmul_blocks() == (256, 128, 128)
    with pytest.raises(ValueError, match="default_matmul_blocks"):
        TC.default_blocks("int8_matmul")


def test_kernels_package_exports():
    """``repro_torch.kernels`` exports the three public ops, as
    ``repro.kernels`` does."""
    import repro_torch.kernels as kernels
    from repro_torch.kernels.ita_attention.ops import fused_attention
    from repro_torch.kernels.ita_softmax.ops import ita_softmax
    assert kernels.int8_matmul is int8_matmul
    assert kernels.ita_softmax is ita_softmax
    assert kernels.fused_attention is fused_attention
