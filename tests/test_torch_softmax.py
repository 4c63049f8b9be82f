"""The port's ITA integer softmax and standalone softmax kernel against the
JAX package, on the CPU.

Inputs are made with numpy from a seed and go through ``repro.core.
softmax`` / ``repro.kernels.ita_softmax`` (the Pallas kernel in interpret
mode) and through ``repro_torch`` on the CPU, where the kernel wrapper
computes its plain version. The bar is bit-exact equality: integer
results with ``np.array_equal``, float probabilities (exact multiples of
powers of two) likewise. The reference runs with an exact ``exp2``
(``jnp.ldexp``; see ``tests/test_torch_kernels.py`` and ROADMAP §C).
The CUDA kernel is held to the plain version on the card by
``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import softmax as JS
from repro.kernels.ita_softmax.kernel import ita_softmax_pallas
from repro.kernels.ita_softmax.ops import ita_softmax as j_ita_softmax
from repro.kernels.ita_softmax.ref import ita_softmax_ref as j_ref
from repro_torch.core import softmax as TS
from repro_torch.kernels.ita_softmax import kernel as TK
from repro_torch.kernels.ita_softmax.ops import ita_softmax as t_ita_softmax
from repro_torch.kernels.ita_softmax.ref import ita_softmax_ref as t_ref

from test_softmax_golden import P_ONESHOT, P_STREAM4, ROW_MAX, SIGMA, X


@pytest.fixture(scope="module", autouse=True)
def exact_exp2():
    """Run the reference with exact powers of two (module docstring)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnp, "exp2", lambda x: jnp.ldexp(
            jnp.ones(jnp.shape(x), jnp.float32),
            jnp.asarray(x).astype(jnp.int32)))
        jax.clear_caches()
        yield
    jax.clear_caches()


def _inputs(seed, rows=6, cols=64, masked=True):
    """int8 logits and a bool mask with a fully masked row and a row with
    one live element."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-128, 128, (rows, cols), dtype=np.int8)
    if not masked:
        return x, None
    mask = rng.random((rows, cols)) < 0.7
    mask[0] = False
    mask[1] = False
    mask[1, cols // 2] = True
    return x, mask


def _both(x, mask):
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else torch.from_numpy(mask)
    return (jnp.asarray(x), jm), (torch.from_numpy(x), tm)


def _same(want, got):
    assert np.array_equal(np.asarray(want), got.numpy())


# --------------------------------------------------------------------------
# core/softmax.py
# --------------------------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
def test_helpers_match_jax(masked):
    x, mask = _inputs(0, masked=masked)
    (jx, jm), (tx, tm) = _both(x, mask)
    for axis in (-1, 0):
        jmax = JS._masked_max(jx, jm, axis)
        tmax = TS._masked_max(tx, tm, axis)
        _same(jmax, tmax)
        # masked lanes (where x may pass the max) take the mask shift
        _same(JS._apply_mask_k(JS._k_of(jx, jmax), jm),
              TS._apply_mask_k(TS._k_of(tx, tmax), tm))


@pytest.mark.parametrize("axis", [-1, 0])
@pytest.mark.parametrize("masked", [False, True])
def test_oneshot_softmaxes_match_jax(masked, axis):
    x, mask = _inputs(1, rows=8, cols=40, masked=masked)
    (jx, jm), (tx, tm) = _both(x, mask)
    for want, got in zip(JS.ita_softmax_int(jx, jm, axis),
                         TS.ita_softmax_int(tx, tm, axis), strict=True):
        _same(want, got)
    for want, got in zip(JS.ita_softmax_adaptive_int(jx, jm, axis),
                         TS.ita_softmax_adaptive_int(tx, tm, axis),
                         strict=True):
        _same(want, got)
    _same(JS.ita_softmax(jx, jm, axis), TS.ita_softmax(tx, tm, axis))
    _same(JS.ita_softmax_adaptive(jx, jm, axis),
          TS.ita_softmax_adaptive(tx, tm, axis))


@pytest.mark.parametrize("num_parts", [1, 4, 8])
@pytest.mark.parametrize("masked", [False, True])
def test_streaming_and_bitexact_match_jax(num_parts, masked):
    x, mask = _inputs(2 + num_parts, rows=7, cols=64, masked=masked)
    (jx, jm), (tx, tm) = _both(x, mask)
    _same(JS.ita_softmax_streaming(jx, num_parts, jm),
          TS.ita_softmax_streaming(tx, num_parts, tm))
    _same(JS.ita_softmax_bitexact(jx, num_parts, jm),
          TS.ita_softmax_bitexact(tx, num_parts, tm))


@pytest.mark.parametrize("seed", [0, 1])
def test_da_update_matches_jax(seed):
    rng = np.random.default_rng(seed)
    carry_max = rng.integers(-256, 128, (6, 1)).astype(np.int32)
    carry_sigma = rng.integers(0, 1 << 16, (6, 1)).astype(np.int32)
    part = rng.integers(-128, 128, (6, 32), dtype=np.int8)
    mask = rng.random((6, 32)) < 0.6
    mask[2] = False
    for m in (None, mask):
        want = JS.ita_da_update(jnp.asarray(carry_max),
                                jnp.asarray(carry_sigma), jnp.asarray(part),
                                None if m is None else jnp.asarray(m))
        got = TS.ita_da_update(torch.from_numpy(carry_max),
                               torch.from_numpy(carry_sigma),
                               torch.from_numpy(part),
                               None if m is None else torch.from_numpy(m))
        for w, g in zip(want, got, strict=True):
            _same(w, g)


def test_golden_vectors():
    """The golden vectors of ``tests/test_softmax_golden.py``: one-shot and
    4-part bit-exact silicon mode, Σ and row max."""
    tx = torch.from_numpy(X)
    for parts, want in ((1, P_ONESHOT), (4, P_STREAM4)):
        p = TS.ita_softmax_bitexact(tx, num_parts=parts).double() * 256
        assert torch.equal(p, torch.round(p))
        assert np.array_equal(p.long().numpy(), want)
    p, sigma, row_max = TS.ita_softmax_int(tx)
    assert np.array_equal(p.numpy(), P_ONESHOT)
    assert np.array_equal(sigma[:, 0].numpy(), SIGMA)
    assert np.array_equal(row_max[:, 0].numpy(), ROW_MAX)


def test_adaptive_keeps_long_flat_rows_alive():
    """Rows whose Σ passes 2^16 underflow the paper DI to 0 and keep their
    mass in adaptive mode, in the port as in the JAX package."""
    x = np.zeros((2, 512), np.int8)
    x[1, ::7] = 100
    (jx, _), (tx, _) = _both(x, None)
    paper = TS.ita_softmax(tx)
    adaptive = TS.ita_softmax_adaptive(tx)
    assert paper[0].sum() == 0 and adaptive[0].sum() > 0.5
    _same(JS.ita_softmax_adaptive(jx), adaptive)


# --------------------------------------------------------------------------
# kernels/ita_softmax: ref, plain kernel version, ops
# --------------------------------------------------------------------------

def _softmax_inputs(r, c, seed):
    rng = np.random.default_rng(seed)
    x = rng.integers(-128, 128, (r, c), dtype=np.int8)
    mask = (rng.random((r, c)) > 0.2).astype(np.int8)
    mask[r // 2] = 0                                   # a fully masked row
    return x, mask


@pytest.mark.parametrize("adaptive", [False, True])
@pytest.mark.parametrize("r,c,bc", [(16, 128, 64), (48, 300, 128),
                                    (8, 64, 64), (40, 200, 64),
                                    (128, 512, 128)])
def test_ita_softmax_matches_jax(r, c, bc, adaptive):
    """``ops.ita_softmax`` (padding rows and columns) against the JAX
    wrapper over the Pallas kernel and against both oracles."""
    x, mask = _softmax_inputs(r, c, r * 1000 + c)
    want = j_ita_softmax(jnp.asarray(x), jnp.asarray(mask), block_r=16,
                         block_c=bc, adaptive=adaptive)
    got = t_ita_softmax(torch.from_numpy(x), torch.from_numpy(mask),
                        block_r=16, block_c=bc, adaptive=adaptive)
    _same(want, got)
    pad = (-c) % bc
    xp, mp = np.pad(x, ((0, 0), (0, pad))), np.pad(mask, ((0, 0), (0, pad)))
    parts = (c + pad) // bc
    ref_j = j_ref(jnp.asarray(xp), jnp.asarray(mp), num_parts=parts,
                  adaptive=adaptive)
    ref_t = t_ref(torch.from_numpy(xp), torch.from_numpy(mp),
                  num_parts=parts, adaptive=adaptive)
    _same(ref_j, ref_t)
    assert torch.equal(ref_t[:, :c], got)


@pytest.mark.parametrize("block_c", [32, 128])
@pytest.mark.parametrize("adaptive", [False, True])
def test_plain_kernel_matches_pallas(block_c, adaptive):
    """The kernel wrapper on unpadded blocks: one part (128) and four."""
    x, mask = _softmax_inputs(32, 128, block_c)
    want = ita_softmax_pallas(jnp.asarray(x), jnp.asarray(mask), block_r=8,
                              block_c=block_c, adaptive=adaptive,
                              interpret=True)
    TK.reset_launches()
    got = TK.ita_softmax_kernel(torch.from_numpy(x), torch.from_numpy(mask),
                                block_r=8, block_c=block_c,
                                adaptive=adaptive)
    _same(want, got)
    assert TK.LAUNCHES == {"ita_softmax": 0}      # plain version: no launch


def test_kernel_wrapper_refuses_ragged_blocks():
    x = torch.zeros((8, 100), dtype=torch.int8)
    with pytest.raises(ValueError, match="multiple of the blocks"):
        TK.ita_softmax_kernel(x, torch.ones_like(x), block_c=64)
    with pytest.raises(TypeError, match="int8"):
        TK.ita_softmax_kernel(x, torch.ones_like(x, dtype=torch.bool),
                              block_c=50)
