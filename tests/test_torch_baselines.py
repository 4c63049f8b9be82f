"""The port's baseline softmaxes (``repro_torch.core.softmax``: the float
oracle, I-BERT, Softermax and the QAT STE forward) against
``repro.core.softmax``, on the CPU.

Inputs are made with numpy from a seed, with masks (a fully masked row
and a row with one live element) and several quantization scales.

- I-BERT and the STE forward are bit-exact. Their reference runs with an
  exact ``exp2`` (the ``exact_exp2`` fixture: XLA:CPU approximates
  ``2^n`` beyond 2^12, ROADMAP §C); the int64 copy needs none.
- ``softmax_float`` agrees within 1e-6 absolute: float32 ``exp`` and the
  row sum round differently in XLA and torch.
- Softermax runs without the fixture, which truncates fractional powers:
  ``floor(2^z · 256)`` may then differ by one where ``2^z · 256`` lies
  within an ulp of an integer. The bound is one numerator step, at most
  2^-7 on a probability (each row's denominator is at least 256), on at
  most 0.1% of the elements; a sweep of 5,242,880 elements at the shapes
  below found none that differ.
- The STE gradient from ``torch.autograd`` agrees with ``jax.grad``
  within 1e-6 (relative to the largest entry): the same straight-through
  rules, float32 sums in different orders. ``jax.grad`` runs without the
  fixture (``ldexp`` of a truncated argument has no gradient).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import softmax as JS
from repro_torch.core import softmax as TS

EPS = (JS.EPS_MAX, 0.1, 0.03)


@pytest.fixture
def exact_exp2():
    """Run the reference with exact powers of two (module docstring). The
    functions under test run op by op (no ``jit`` traced ``exp2``), so no
    compile cache needs clearing."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnp, "exp2", lambda x: jnp.ldexp(
            jnp.ones(jnp.shape(x), jnp.float32),
            jnp.asarray(x).astype(jnp.int32)))
        yield


def _inputs(seed, rows=48, cols=96, masked=True, dtype=np.int8):
    rng = np.random.default_rng(seed)
    x = rng.integers(-128, 128, (rows, cols)).astype(dtype)
    if not masked:
        return x, None
    mask = rng.random((rows, cols)) < 0.7
    mask[0] = False
    mask[1] = False
    mask[1, cols // 3] = True
    return x, mask


def _run(jf, tf, x, mask, **kw):
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else torch.from_numpy(mask)
    want = np.asarray(jf(jnp.asarray(x), mask=jm, **kw))
    got = tf(torch.from_numpy(x), mask=tm, **kw).numpy()
    return want, got


def test_ibert_constants_match_reference():
    """I-BERT's x0, b and c are floored from float64 host arithmetic;
    ``x0`` sits on an integer at ``EPS_MAX`` (-ln2 / (ln2/32))."""
    assert TS.ibert_constants() == (-32.0, 124.0, 5950.0)
    for eps in (*EPS, 0.01, 0.2, 1 / 32):
        a, b, _ = JS._IBERT_COEF
        want = (np.floor(JS._IBERT_X0 / eps), np.floor(b / a / eps),
                np.floor(1.0 / a / eps ** 2))
        assert TS.ibert_constants(eps) == want, eps


def test_float_floor_divide_matches_jnp():
    """``torch.div(rounding_mode="floor")`` on float32 integers equals
    ``jnp.floor_divide`` (I-BERT's ``q = x // x0``)."""
    x = np.arange(-2000, 1, dtype=np.float32)
    for d in (-32.0, -7.0, -24.0, -1.0):
        want = np.asarray(jnp.floor_divide(jnp.asarray(x), d))
        got = torch.div(torch.from_numpy(x), torch.tensor(d),
                        rounding_mode="floor").numpy()
        assert np.array_equal(want, got), d


@pytest.mark.parametrize("eps", EPS)
@pytest.mark.parametrize("masked", [False, True])
def test_softmax_float_matches_jax(eps, masked):
    x, mask = _inputs(1, masked=masked)
    want, got = _run(JS.softmax_float, TS.softmax_float, x, mask, eps=eps)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    if masked:
        assert np.isnan(got[0]).all() and np.isnan(want[0]).all()


@pytest.mark.parametrize("eps", EPS)
@pytest.mark.parametrize("masked", [False, True])
def test_ibert_softmax_bit_exact(exact_exp2, eps, masked):
    x, mask = _inputs(2, masked=masked)
    want, got = _run(JS.ibert_softmax, TS.ibert_softmax, x, mask, eps=eps)
    assert np.array_equal(want, got)
    # the int32 logits of the direct backends go through the same path
    x32, _ = _inputs(3, masked=False, dtype=np.int32)
    want, got = _run(JS.ibert_softmax, TS.ibert_softmax, x32, mask, eps=eps)
    assert np.array_equal(want, got)


@pytest.mark.parametrize("eps", EPS)
def test_ibert_softmax_np_exact(eps):
    x, _ = _inputs(4, rows=64, cols=256, masked=False)
    want = JS.ibert_softmax_np(x, eps)
    got = TS.ibert_softmax_np(torch.from_numpy(x), eps).numpy()
    assert got.dtype == np.float64 and np.array_equal(want, got)
    # the float32-held and int64 copies agree (the reference's own check)
    np.testing.assert_allclose(
        TS.ibert_softmax(torch.from_numpy(x), eps).numpy(), got, atol=1e-7)


@pytest.mark.parametrize("eps", EPS)
@pytest.mark.parametrize("masked", [False, True])
def test_softermax_within_one_numerator_step(eps, masked):
    x, mask = _inputs(5, rows=128, cols=256, masked=masked)
    want, got = _run(JS.softermax, TS.softermax, x, mask, eps=eps)
    live = ~np.isnan(want)
    assert np.array_equal(live, ~np.isnan(got))
    diff = np.abs(want[live] - got[live])
    assert diff.max() <= 2.0 ** -7
    assert (diff > 0).mean() <= 1e-3


@pytest.mark.parametrize("masked", [False, True])
def test_ita_softmax_ste_forward_bit_exact(exact_exp2, masked):
    rng = np.random.default_rng(6)
    logits = rng.normal(0, 2.0, (48, 96)).astype(np.float32)
    logits[2, :4] = [0.5 * JS.EPS_MAX, 40.0, -40.0, 1.5 * JS.EPS_MAX]
    _, mask = _inputs(6, masked=masked)
    for eps in EPS:
        want, got = _run(JS.ita_softmax_ste, TS.ita_softmax_ste, logits,
                         mask, eps=eps)
        assert np.array_equal(want, got), eps


@pytest.mark.parametrize("masked", [False, True])
def test_ita_softmax_ste_grad_matches_jax(masked):
    rng = np.random.default_rng(7)
    logits = rng.normal(0, 1.0, (16, 40)).astype(np.float32)
    w = rng.normal(0, 1.0, (16, 40)).astype(np.float32)
    _, mask = _inputs(7, rows=16, cols=40, masked=masked)
    jm = None if mask is None else jnp.asarray(mask)
    want = np.asarray(jax.grad(lambda lg: (JS.ita_softmax_ste(
        lg, mask=jm) * w).sum())(jnp.asarray(logits)))
    t = torch.from_numpy(logits).requires_grad_()
    tm = None if mask is None else torch.from_numpy(mask)
    (TS.ita_softmax_ste(t, mask=tm) * torch.from_numpy(w)).sum().backward()
    got = t.grad.numpy()
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * np.abs(want).max())


def test_mae_vs_float_matches_jax(exact_exp2):
    """The paper's accuracy table on one logit set (§V-C: ITA 0.46%,
    I-BERT 0.35%): the port's MAEs against its float oracle equal the
    JAX package's."""
    rng = np.random.default_rng(8)
    xq = np.clip(np.round(rng.normal(0, 1.0, (256, 256)) / JS.EPS_MAX),
                 -128, 127).astype(np.int8)
    jf = np.asarray(JS.softmax_float(jnp.asarray(xq)))
    tf = TS.softmax_float(torch.from_numpy(xq)).numpy()
    for jp, tp in (
            (np.asarray(JS.ita_softmax(jnp.asarray(xq))),
             TS.ita_softmax(torch.from_numpy(xq)).numpy()),
            (np.asarray(JS.ibert_softmax(jnp.asarray(xq))),
             TS.ibert_softmax(torch.from_numpy(xq)).numpy()),
            (JS.ibert_softmax_np(xq),
             TS.ibert_softmax_np(torch.from_numpy(xq)).numpy())):
        assert np.array_equal(jp, tp)
        mae_j, mae_t = np.abs(jp - jf).mean(), np.abs(tp - tf).mean()
        assert mae_t < 0.01
        assert abs(mae_j - mae_t) < 1e-7
