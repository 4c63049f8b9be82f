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

from repro.core import quant as JQ
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


@pytest.mark.parametrize("m,k,n", [(8, 32, 16), (70, 300, 132)])
@pytest.mark.parametrize("schedule", SCHEDULES)
def test_k_major_weight_matches_jax(m, k, n, schedule):
    """A weight stored K-major (``w.t().contiguous().t()``: the (K, N)
    view of an (N, K) buffer, the storage the kernels read) gives the JAX
    wrapper's values through ``ops.int8_matmul``, at the JAX test's blocks
    and at the defaults."""
    x, w, b = _operands(11 + m, m, k, n)
    mult = np.random.default_rng(12).uniform(1e-4, 3e-3, n).astype(
        np.float32)
    tx, tw, tb, tm = _t(x, w, b, mult)
    w_km = tw.t().contiguous().t()
    assert not w_km.is_contiguous() and torch.equal(w_km, tw)
    for blocks in (dict(block_m=32, block_n=16, block_k=32), {}):
        want = j_int8_matmul(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                             jnp.asarray(mult), schedule=schedule, **blocks)
        got = int8_matmul(tx, w_km, tb, tm, schedule=schedule, **blocks)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_k_major_buffer_of_the_weight():
    """``kernel.k_major`` hands the kernels the (N, K) buffer: a K-major
    view's own storage (no copy), a transposed copy of a row-major w, and
    an aligned copy of a view at an unaligned offset."""
    w = torch.from_numpy(np.random.default_rng(13).integers(
        -128, 128, (300, 132), dtype=np.int8))
    w_km = w.t().contiguous().t()
    buf = TK.k_major(w_km)
    assert buf.data_ptr() == w_km.data_ptr() and buf.shape == (132, 300)
    assert buf.is_contiguous() and torch.equal(buf, w.t())
    copy = TK.k_major(w)
    assert copy.is_contiguous() and torch.equal(copy, w.t())
    assert copy.data_ptr() != w.data_ptr()
    flat = torch.zeros(132 * 300 + 1, dtype=torch.int8)
    odd = flat[1:].view(132, 300).t()            # K-major, 1 byte off
    odd.copy_(w)
    buf = TK.k_major(odd)
    assert buf.data_ptr() % 16 == 0 and torch.equal(buf, w.t())


@pytest.mark.parametrize("axis,k_major", [(0, True), (-2, True),
                                          (1, False), (None, False)])
def test_quantized_weight_stored_k_major(axis, k_major):
    """``quantize_tensor`` stores a (K, N) weight quantized per output
    channel K-major, so ``kernel.k_major`` hands its own buffer to the
    kernels with no copy; other quantizations stay row-major. The values
    are JAX's either way."""
    w = np.random.default_rng(14).normal(0, 0.02, (96, 40)).astype(
        np.float32)
    tq = TQ.quantize_tensor(torch.from_numpy(w), axis=axis)
    jq = JQ.quantize_tensor(jnp.asarray(w), axis=axis)
    np.testing.assert_array_equal(tq.values.numpy(), np.asarray(jq.values))
    assert tq.values.shape == (96, 40)
    assert tq.values.t().is_contiguous() == k_major
    assert tq.values.is_contiguous() != k_major
    assert (TK.k_major(tq.values).data_ptr() == tq.values.data_ptr()) \
        == k_major


def _cover(extent, size, count):
    """How often each of ``extent`` indices lies in ``count`` ranges of
    ``size``."""
    hits = np.zeros(extent, np.int64)
    for i in range(count):
        assert i * size < extent                 # no empty range
        hits[i * size:(i + 1) * size] += 1
    return hits


# an H100 SXM's streaming multiprocessors, the card the geometries are
# sized for (the wrapper takes the count from the device)
SMS = 132
# layer 0's projections of qwen2-7b at M = 2048 and a decode step (8 rows
# after padding), and odd shapes on both sides of the 16-row switch
GEOMETRY_SHAPES = [(2048, 3584, 3584), (2048, 512, 3584),
                   (2048, 18944, 3584), (2048, 3584, 18944),
                   (8, 3584, 3584), (8, 512, 3584), (8, 18944, 3584),
                   (8, 3584, 18944), (1, 16, 32), (16, 512, 3584),
                   (4, 256, 18944), (8, 64, 100000), (17, 640, 200),
                   (33, 20, 68), (300, 260, 520), (2000, 512, 3584),
                   (100, 96, 200)]


@pytest.mark.parametrize("m,n,k", GEOMETRY_SHAPES)
def test_matmul_geometry_covers_each_output_once(m, n, k):
    """B7a's per-call geometry (``csrc/matmul.cu`` checks it): rows of
    16-byte multiples, each block walking all of K; at most 16 rows take
    the rows kernel, whose column groups cover N exactly once; others
    take wgmma tiles that cover M x N exactly once, 256 wide where such
    tiles number at least the SMs, else 128, whose ring of stages fits a
    block's shared memory."""
    g = TK.matmul_geometry(m, n, k, sms=SMS)
    ld = g["ld"]
    assert ld % 16 == 0 and k <= ld < k + 16
    if g["kind"] == "rows":
        (groups,) = g["grid"]
        assert m <= TK.ROWS_MAX_M and g["bn"] == 0
        assert (_cover(n, TK.ROWS_COLS, groups) == 1).all()
    else:
        tiles_m, tiles_n = g["grid"]
        assert m > TK.ROWS_MAX_M and g["bn"] in (128, 256)
        assert (_cover(m, TK.WGMMA_BM, tiles_m) == 1).all()
        assert (_cover(n, g["bn"], tiles_n) == 1).all()
        assert (g["bn"] == 256) == (-(-n // 256) * tiles_m >= SMS)
        assert g["stages"] >= 4 and g["smem"] <= 232448


@pytest.mark.parametrize("m,n,k,bk", [
    (2048, 3584, 3584, 128), (2048, 512, 3584, 128),
    (2048, 18944, 3584, 128), (2048, 3584, 18944, 128),
    (8, 3584, 18944, 128), (300, 260, 520, 128), (256, 256, 3328, 1664),
    (130, 136, 1000, 200), (2048, 512, 3584, 832), (2048, 512, 3584, 836),
    (512, 256, 2560, 256), (512, 256, 2560, 320), (2048, 18944, 3584, 256),
    (2048, 18944, 3584, 320)])
def test_ws_geometry_covers_each_row_once(m, n, k, bk):
    """B7b's m ranges (multiples of 128 rows) and 128-column tiles cover
    the partial sums exactly once and number at least the SMs where M
    allows; the partial sums are staged in shared memory exactly where the
    blocks outnumber the SMs and two then fit an SM (block_k up to 256),
    and two weight tiles are kept where they fit beside them (block_k up
    to 128) or, unstaged, up to block_k 832."""
    g = TK.ws_geometry(m, n, k, bk, sms=SMS)
    tiles_n, ranges = g["grid"]
    assert g["range_rows"] % 128 == 0 and ranges == g["ranges"]
    assert (_cover(m, g["range_rows"], ranges) == 1).all()
    assert (_cover(n, 128, tiles_n) == 1).all()
    assert tiles_n * ranges >= min(SMS, tiles_n * -(-m // 128))
    assert g["k_tiles"] == -(-k // bk)
    many = tiles_n * ranges > SMS
    assert g["staged"] == (many and bk <= 256)
    assert g["double_w"] == (bk <= 128 if g["staged"] else bk <= 832)
    assert g["smem"] <= (TK.WS_TWO_BLOCKS if g["staged"] else 232448)


@pytest.mark.parametrize("call,match", [
    (lambda: TK.matmul_geometry(8, 8, 30, sms=SMS), "multiples of 4"),
    (lambda: TK.matmul_geometry(8, 6, 32, sms=SMS), "multiples of 4"),
    (lambda: TK.matmul_geometry(0, 8, 32, sms=SMS), "positive"),
    (lambda: TK.ws_geometry(8, 8, 30, 30, sms=SMS), "multiples of 4"),
    (lambda: TK.ws_geometry(8, 8, 32, 6, sms=SMS), "multiples of 4"),
    (lambda: TK.ws_geometry(8, 8, 4096, 1728, sms=SMS),
     "resident weight tile"),
    (lambda: TK.ws_geometry(8, 8, 32, 0, sms=SMS), "positive")],
    ids=["a-k30", "a-n6", "a-m0", "b-k30", "b-bk6", "b-bk1728", "b-bk0"])
def test_geometry_refuses_what_the_kernels_cannot_take(call, match):
    with pytest.raises(ValueError, match=match):
        call()
