"""The port's fixed-point core (``repro_torch.core.quant``) on the CPU
against the JAX package's ``repro.core.quant``.

Held EXACTLY equal: ``QFormat.quantize`` / ``quantize_exact`` of every
Table-I format (inputs across and beyond the format limits, on and between
grid points, ties, zeros), ``lpw_exp2`` (the whole Q(6,2) exponent range
and real-valued t) and ``lpw_reciprocal`` (every Q(10,6) PowSum value —
powers of two and the values just below them included — zeros, and real
values); ``qformat_clip_count``, ``fake_quant_int8``, ``percentile_scale``
and ``Int8Calibrator``.

The straight-through gradients (``jax.grad`` against autograd) are held
within 1e-6 relative to the largest gradient: both are the clip's 0/1
mask (1/2 at an exact limit, as JAX's max/min split a tie) times the
unit's slope, computed in float32 by the same operations.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as JQ
from repro_torch.core import quant as TQ

FORMATS = ["inp", "unnormed", "powsum", "recip"]


def _both(x):
    return jnp.asarray(x), torch.from_numpy(np.array(x, np.float32))


def _grid_and_beyond(fmt, rng):
    """Grid points across the format, half-steps (ties), the limits and
    beyond, zeros and random reals."""
    step = 1.0 / fmt.scale
    lo, hi = fmt.min_value, fmt.max_value
    grid = np.arange(lo - 4 * step, hi + 4 * step, step / 2)
    if grid.size > 4096:
        grid = np.concatenate([grid[:1024], grid[-1024:],
                               rng.choice(grid, 2048)])
    reals = rng.uniform(lo - 1, hi + 1, 2048)
    return np.concatenate([grid, reals, [0.0, -0.0, lo, hi, lo - step,
                                         hi + step]]).astype(np.float32)


@pytest.mark.parametrize("name", FORMATS)
def test_quantize_matches_jax(name):
    rng = np.random.default_rng(sum(map(ord, name)))
    jf = getattr(JQ.DEFAULT_BITWIDTHS, name)
    tf = getattr(TQ.DEFAULT_BITWIDTHS, name)
    assert (tf.int_bits, tf.frac_bits, tf.signed) == \
        (jf.int_bits, jf.frac_bits, jf.signed)
    x = _grid_and_beyond(jf, rng)
    jx, tx = _both(x)
    np.testing.assert_array_equal(tf.quantize(tx).numpy(),
                                  np.asarray(jax.jit(jf.quantize)(jx)))
    np.testing.assert_array_equal(tf.quantize_exact(tx).numpy(),
                                  np.asarray(jax.jit(jf.quantize_exact)(jx)))
    # the STE gradient: 1 inside, 1/2 at a limit, 0 beyond
    want = np.asarray(jax.jit(jax.grad(
        lambda v: jnp.sum(jf.quantize(v))))(jx))
    t = tx.clone().requires_grad_()
    tf.quantize(t).sum().backward()
    np.testing.assert_allclose(t.grad.numpy(), want, rtol=0, atol=1e-6)


def test_lpw_exp2_matches_jax():
    rng = np.random.default_rng(1)
    # every exponent x - m of the fixed-point path: Q(6,2) steps in [-64, 0]
    grid = -np.arange(0, 64 * 4 + 1) / 4.0
    reals = -np.abs(rng.normal(size=4096) * 12)
    t = np.concatenate([grid, reals, [0.0, -40.0, -40.25, -41.0, -63.75,
                                      -16.0, -15.0, -1e-7]])
    jt, tt = _both(t.astype(np.float32))
    np.testing.assert_array_equal(TQ.lpw_exp2(tt).numpy(),
                                  np.asarray(jax.jit(JQ.lpw_exp2)(jt)))
    out_fmt = JQ.QFormat(1, 7, signed=False)
    np.testing.assert_array_equal(
        TQ.lpw_exp2(tt, TQ.QFormat(1, 7, signed=False)).numpy(),
        np.asarray(jax.jit(lambda v: JQ.lpw_exp2(v, out_fmt))(jt)))
    # gradient: the LPW slope (x4 per unit of t) under the STE mask
    want = np.asarray(jax.jit(jax.grad(
        lambda v: jnp.sum(JQ.lpw_exp2(v))))(jt))
    x = tt.clone().requires_grad_()
    TQ.lpw_exp2(x).sum().backward()
    scale = np.abs(want).max()
    np.testing.assert_allclose(x.grad.numpy(), want, rtol=0,
                               atol=1e-6 * scale)


def test_lpw_reciprocal_matches_jax():
    rng = np.random.default_rng(2)
    grid = np.arange(0, 2 ** 16) / 64.0        # every Q(10,6) PowSum value
    pow2 = 2.0 ** np.arange(-6, 10)
    below = pow2 - 1 / 64.0
    reals = np.abs(rng.normal(size=4096) * 100)
    d = np.concatenate([grid, pow2, below, reals, [0.0, 2.0 ** -20,
                                                   2.0 ** -21, 1e-9]])
    jd, td = _both(d.astype(np.float32))
    np.testing.assert_array_equal(TQ.lpw_reciprocal(td).numpy(),
                                  np.asarray(jax.jit(JQ.lpw_reciprocal)(jd)))
    # gradient through the mantissa's LPW under the Q(1,7) STE
    pos = np.abs(rng.normal(size=512) * 30).astype(np.float32) + 0.01
    jp, tp = _both(pos)
    want = np.asarray(jax.jit(jax.grad(
        lambda v: jnp.sum(JQ.lpw_reciprocal(v))))(jp))
    x = tp.clone().requires_grad_()
    TQ.lpw_reciprocal(x).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), want, rtol=0,
                               atol=1e-6 * np.abs(want).max())


def test_luts_match_jax():
    for name in ("_EXP2_C_Q", "_EXP2_M_Q", "_RECIP_C", "_RECIP_M"):
        np.testing.assert_array_equal(getattr(TQ, name), getattr(JQ, name))


def test_pow2_exact():
    k = np.arange(-126, 128).astype(np.float32)
    got = TQ.pow2_exact(torch.from_numpy(k)).numpy()
    np.testing.assert_array_equal(got, np.ldexp(np.float32(1),
                                                k.astype(np.int32)))


def test_qformat_clip_count_matches_jax():
    rng = np.random.default_rng(3)
    x = (rng.normal(size=(6, 50)) * 30).astype(np.float32)
    where = rng.random((6, 50)) < 0.7
    jx, tx = _both(x)
    for name in FORMATS:
        jf = getattr(JQ.DEFAULT_BITWIDTHS, name)
        tf = getattr(TQ.DEFAULT_BITWIDTHS, name)
        assert int(TQ.qformat_clip_count(tx, tf)) == \
            int(JQ.qformat_clip_count(jx, jf))
        assert int(TQ.qformat_clip_count(tx, tf, torch.from_numpy(where))) \
            == int(JQ.qformat_clip_count(jx, jf, jnp.asarray(where)))


def test_int8_fake_quant_and_calibration_match_jax():
    rng = np.random.default_rng(4)
    x = (rng.standard_t(3, size=(32, 40)) * 2).astype(np.float32)
    jx, tx = _both(x)
    j_scale = JQ.percentile_scale(jx)
    t_scale = TQ.percentile_scale(tx)
    assert t_scale.item() == float(j_scale)
    assert TQ.percentile_scale(tx, 90.0).item() == \
        float(JQ.percentile_scale(jx, 90.0))
    np.testing.assert_array_equal(TQ.fake_quant_int8(tx, t_scale).numpy(),
                                  np.asarray(JQ.fake_quant_int8(jx, j_scale)))
    scale = 0.05      # saturates the tails: the STE mask is not all ones
    want = np.asarray(jax.grad(
        lambda v: jnp.sum(JQ.fake_quant_int8(v, scale) ** 2))(jx))
    t = tx.clone().requires_grad_()
    (TQ.fake_quant_int8(t, scale) ** 2).sum().backward()
    np.testing.assert_allclose(t.grad.numpy(), want, rtol=0,
                               atol=1e-6 * np.abs(want).max())
    jc, tc = JQ.Int8Calibrator(), TQ.Int8Calibrator()
    with pytest.raises(ValueError):
        tc.scale
    for i in range(3):
        batch = x * (i + 1)
        jc.observe(jnp.asarray(batch))
        tc.observe(torch.from_numpy(batch))
    assert tc.scale == jc.scale


def test_percentile_sorts_past_quantile_limit():
    """``torch.quantile`` refuses more than 2^24 elements; the port's
    percentile sorts by hand, so a large tensor works and agrees with
    numpy's linear interpolation up to the float32 index arithmetic."""
    rng = np.random.default_rng(5)
    x = rng.random(2 ** 24 + 3, dtype=np.float32)
    got = TQ.percentile_scale(torch.from_numpy(x)).item() * 127.0
    want = np.percentile(x, 99.999)
    assert abs(got - want) <= 1e-6
