"""The port's Softermax variants, its fixed-point Softermax and the plain
versions of the row kernels K6 and K7, on the CPU against the JAX package.

Held EXACTLY equal to JAX:

* ``softermax_fixed`` with the Table-I formats and with one point of the
  Table-I ablation (``benchmarks/table1_bitwidth_ablation.py``: Q(1,11)
  numerators, Q(1,5) reciprocal and output), slices of 16 and of 8, rows
  not a multiple of the slice, masked entries and rows whose max is
  <= -17; and ``attention_softmax(impl="softermax_fixed")`` on the last
  and on another axis;
* K7's plain mirror ``softermax_quant_plain`` against the Pallas kernel
  ``softermax_quant_op(..., interpret=True)`` at ``tests/test_kernels.py``'s
  shapes and one with masked entries and a row max <= -17.

Within a tolerance:

* the float variants and ``attention_softmax``'s float impls: 2e-6
  absolute (outputs <= 1; the two packages sum in another order);
* ``softermax_fixed``'s straight-through gradient: 1e-6 of the largest
  gradient (the same float32 operations, summed in another order);
* K6's plain path ``softermax_op`` against the Pallas kernel in interpret
  mode at ``tests/test_kernels.py``'s shapes and tolerances (float32
  2e-5, bfloat16 2e-2 absolute), a bfloat16 output also element by element
  within ``kernels/parity.py``'s 1e-2 of its own size: outputs of 1e-3 to
  1e-2 would pass the absolute bound however wrong; and at rows one short
  of, at and one past the register route's cap (float32 2e-5); K6's
  dispatch rule ``register_route`` as a plain function;
* K7's oracle ``softermax_quant_ref`` within one Q(1,7) step (2^-7) of the
  mirror: it quantizes numerators at the running max
  (``kernels/softermax_quant/ref.py``).

K7's register route, held EXACTLY: its closed-form numerator
``lpw_numerator`` (the Q(6,2) integer k against an integer max m) equals
the LPW unit of both packages on every k in [-128, 127] and m in
[-32, 32]; its arithmetic ``softermax_quant_reg_plain`` (the scores as
integers, numerators from k, the carry on 64 d) equals
``softermax_quant_plain`` and the Pallas kernel in interpret mode at V of
16, 200, 1,024 and 2,048, with masked halves and maxima that jump by 13
and more across slices; its dispatch rule ``register_route`` as a plain
function.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as JQ
from repro.core import softermax as J
from repro.kernels.softermax import softermax_op as jax_softermax_op
from repro.kernels.softermax import \
    softermax_rows_ref as jax_softermax_rows_ref
from repro.kernels.softermax_quant import \
    softermax_quant_op as jax_softermax_quant_op
from repro_torch.core import quant as TQ
from repro_torch.core import softermax as T
from repro_torch.kernels.parity import BF16_RTOL, parity_error
from repro_torch.kernels.softermax import (REG_CAP, register_route,
                                           softermax_op)
from repro_torch.kernels.softermax_quant import (REG_CAP as K7_REG_CAP)
from repro_torch.kernels.softermax_quant import (lpw_numerator,
                                                 softermax_quant_op,
                                                 softermax_quant_plain,
                                                 softermax_quant_ref,
                                                 softermax_quant_reg_plain)
from repro_torch.kernels.softermax_quant import \
    register_route as k7_register_route

FLOAT_ATOL = 2e-6
IMPLS = ["softmax", "base2", "base2_folded", "softermax", "softermax_fixed"]


def _jit_unoptimized(fn):
    """``jax.jit`` with XLA's backend optimization off: the reference
    compiles in a fraction of the CPU time, to the same float32
    operations."""
    return jax.jit(fn, compiler_options={"xla_backend_optimization_level": 0})


def _scores(shape, seed, scale=4.0):
    """Scores with a fully masked row, a half-masked row and a row whose
    max is <= -17 (below which Q(1,15) numerators start to vanish)."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=shape) * scale).astype(np.float32)
    rows = x.reshape(-1, shape[-1])
    rows[0] = -1e9
    rows[1, shape[-1] // 2:] = -1e9
    rows[2] = rows[2] - 30.0
    rows[3, :shape[-1] // 3] = -1e9
    rows[3, shape[-1] // 3:] -= 20.0
    return x


def _both(x):
    return jnp.asarray(x), torch.from_numpy(x.copy())


def _ablation_bitwidths(pkg):
    q = pkg.QFormat
    return pkg.SoftermaxBitwidths(unnormed=q(1, 11, signed=False),
                                  recip=q(1, 5, signed=False),
                                  outp=q(1, 5, signed=False))


@pytest.mark.parametrize("name,jfn,tfn", [
    ("softmax_e", J.softmax_e, T.softmax_e),
    ("softmax_base2", J.softmax_base2, T.softmax_base2),
    ("softmax_base2_folded", lambda x: J.softmax_base2(x, fold_log2e=True),
     lambda x: T.softmax_base2(x, fold_log2e=True)),
    ("softmax_online_e", J.softmax_online, T.softmax_online),
    ("softmax_online_base2", lambda x: J.softmax_online(x, base2=True),
     lambda x: T.softmax_online(x, base2=True)),
    ("softermax", J.softermax, T.softermax),
    ("softermax_online_scan", J.softermax_online_scan,
     T.softermax_online_scan),
    ("softermax_online_scan_16", lambda x: J.softermax_online_scan(x, 16),
     lambda x: T.softermax_online_scan(x, 16)),
])
def test_float_variants_match_jax(name, jfn, tfn):
    x = _scores((3, 4, 150), seed=len(name))
    jx, tx = _both(x)
    want = np.asarray(_jit_unoptimized(jfn)(jx))
    got = tfn(tx).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=FLOAT_ATOL)
    assert np.isfinite(got).all()


@pytest.mark.parametrize("axis", [-1, 1])
@pytest.mark.parametrize("impl", IMPLS)
def test_attention_softmax_matches_jax(impl, axis):
    x = _scores((2, 37, 5, 20), seed=7) if axis == 1 else \
        _scores((2, 5, 20, 37), seed=7)
    jx, tx = _both(x)
    want = np.asarray(_jit_unoptimized(lambda v: J.attention_softmax(
        v, impl=impl, axis=axis))(jx))
    got = T.attention_softmax(tx, impl=impl, axis=axis).numpy()
    if impl == "softermax_fixed":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=FLOAT_ATOL)
    with pytest.raises(ValueError):
        T.attention_softmax(tx, impl="e")


@pytest.mark.parametrize("bits,block,V", [
    ("table1", 16, 37), ("table1", 16, 300), ("table1", 8, 64),
    ("ablation", 16, 64), ("ablation", 8, 37)])
def test_softermax_fixed_matches_jax(bits, block, V):
    x = _scores((12, V), seed=V + block, scale=6.0)
    jx, tx = _both(x)
    jbw = None if bits == "table1" else _ablation_bitwidths(JQ)
    tbw = None if bits == "table1" else _ablation_bitwidths(TQ)
    # the output and the straight-through gradient of a weighted sum of it
    w = np.random.default_rng(V).normal(size=x.shape).astype(np.float32)

    def fwd_vjp(v):
        y, vjp = jax.vjp(lambda a: J.softermax_fixed(
            a, bitwidths=jbw, block=block), v)
        return y, vjp(jnp.asarray(w))[0]

    want, gj = map(np.asarray, _jit_unoptimized(fwd_vjp)(jx))
    got = T.softermax_fixed(tx, bitwidths=tbw, block=block).numpy()
    np.testing.assert_array_equal(got, want)
    t = tx.clone().requires_grad_()
    (T.softermax_fixed(t, bitwidths=tbw, block=block) *
     torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(t.grad.numpy(), gj, rtol=0,
                               atol=1e-6 * np.abs(gj).max())


def test_bitwidths_match_jax():
    for f in dataclasses.fields(JQ.SoftermaxBitwidths):
        jf = getattr(JQ.DEFAULT_BITWIDTHS, f.name)
        tf = getattr(TQ.DEFAULT_BITWIDTHS, f.name)
        assert (jf.int_bits, jf.frac_bits, jf.signed, jf.min_value,
                jf.max_value, jf.scale) == \
            (tf.int_bits, tf.frac_bits, tf.signed, tf.min_value,
             tf.max_value, tf.scale)


# --- K6: the row kernel's plain path against the Pallas kernel ----------

K6_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,bv,intmax", [
    ((4, 128), 128, True), ((8, 1024), 256, True), ((5, 300), 128, True),
    ((16, 64), 128, False), ((3, 7, 130), 128, False),
])
def test_softermax_op_matches_jax_kernel(shape, bv, intmax, dtype):
    x = np.random.default_rng(sum(shape)).normal(size=shape) \
        .astype(np.float32) * 3.0
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = _jit_unoptimized(lambda a: jax_softermax_op(
        a, intmax=intmax, block_v=bv, interpret=True))(jnp.asarray(x, jdt))
    got = softermax_op(torch.from_numpy(x).to(dtype), intmax=intmax)
    assert got.dtype == dtype and got.shape == shape
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=K6_TOL[dtype])
    if dtype == torch.bfloat16:
        held = parity_error(got, torch.from_numpy(want).to(dtype))[1]
        assert held <= BF16_RTOL, held


def test_softermax_op_masked_rows_are_uniform():
    x = np.full((4, 256), -1e9, np.float32)
    want = np.asarray(jax_softermax_op(jnp.asarray(x), interpret=True))
    got = softermax_op(torch.from_numpy(x)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
    np.testing.assert_allclose(got, 1 / 256, rtol=1e-6)


@pytest.mark.parametrize("shape,reg", [
    ((4, 1), True), ((4, 7), True), ((2, 3, 512), True), ((8, 1024), True),
    ((4, REG_CAP - 1), True), ((4, REG_CAP), True),
    ((4, REG_CAP + 1), False), ((2, 4096), False), ((2, 8192), False),
    ((REG_CAP + 1, 4), True)])
def test_register_route_rule(shape, reg):
    """K6's dispatch rule: rows (the last axis) of up to REG_CAP values take
    the register kernel, longer rows the two-pass kernel."""
    assert REG_CAP == 2048
    assert register_route(torch.zeros(shape)) is reg


@pytest.mark.parametrize("intmax", [True, False])
@pytest.mark.parametrize("V", [REG_CAP - 1, REG_CAP, REG_CAP + 1])
def test_softermax_op_matches_jax_kernel_at_the_register_cap(V, intmax):
    """Rows one short of, at and one past the register route's cap, with a
    fully masked, a half-masked and a -30-shifted row: the plain path
    against the JAX closed form, and against the Pallas kernel in
    interpret mode on every row but the fully masked one, which is uniform
    (1/V). The Pallas kernel pads a row to its block_v with NEG_INF, and on
    a fully masked row each pad enters d as 2^0: it gives 1/2560 where V is
    2049 (ROADMAP Queue 3)."""
    x = _scores((4, V), seed=V, scale=3.0)
    got = softermax_op(torch.from_numpy(x), intmax=intmax).numpy()
    closed = np.asarray(jax_softermax_rows_ref(jnp.asarray(x), intmax))
    np.testing.assert_allclose(got, closed, rtol=0,
                               atol=K6_TOL[torch.float32])
    np.testing.assert_allclose(got[0], 1 / V, rtol=1e-6)
    want = _jit_unoptimized(lambda a: jax_softermax_op(
        a, intmax=intmax, block_v=512, interpret=True))(jnp.asarray(x))
    np.testing.assert_allclose(got[1:], np.asarray(want)[1:], rtol=0,
                               atol=K6_TOL[torch.float32])


# --- K7: the fixed-point kernel's mirror against the Pallas kernel -------

@pytest.mark.parametrize("shape", [(6, 64), (4, 300), (8, 37), (2, 16),
                                   (12, 200)])
def test_softermax_quant_plain_matches_jax_kernel(shape):
    rng = np.random.default_rng(shape[1])
    if shape == (12, 200):          # masked entries, row max <= -17
        x = _scores(shape, seed=3, scale=6.0)
    else:
        x = (rng.normal(size=shape) * 6.0).astype(np.float32)
    want = np.asarray(_jit_unoptimized(lambda a: jax_softermax_quant_op(
        a, interpret=True))(jnp.asarray(x)))
    got = softermax_quant_plain(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got * 128, np.round(got * 128))
    assert np.array_equal(softermax_quant_op(torch.from_numpy(x)).numpy(),
                          got)
    ref = softermax_quant_ref(torch.from_numpy(x)).numpy()
    assert np.abs(ref - got).max() <= 2 ** -7


def test_softermax_quant_plain_keeps_dtype_and_shape():
    x = _scores((2, 3, 40), seed=9, scale=6.0)
    t = torch.from_numpy(x)
    got = softermax_quant_plain(t.to(torch.bfloat16))
    assert got.dtype == torch.bfloat16 and got.shape == t.shape
    want = softermax_quant_plain(t.to(torch.bfloat16).float())
    assert torch.equal(got.float(), want)    # Q(1,7) values: exact in bf16


# --- K7's register route: closed-form numerators, its arithmetic, its rule

def test_lpw_numerator_closed_form_equals_the_lpw_unit():
    """Exhaustive: Q15(c[k & 3] * 2^max((k >> 2) - m, -40)) for every
    Q(6,2) integer k and every integer max m in [-32, 32] equals both
    packages' ``lpw_exp2(k / 4 - m)`` (k / 4 - m is exact in float32)."""
    k = np.arange(-128, 128, dtype=np.int32)[:, None]
    m = np.arange(-32, 33, dtype=np.int32)[None]
    t = k.astype(np.float32) / 4 - m.astype(np.float32)
    got = lpw_numerator(torch.from_numpy(k), torch.from_numpy(m)).numpy()
    assert got.shape == (256, 65) and got.dtype == np.float32
    np.testing.assert_array_equal(got,
                                  TQ.lpw_exp2(torch.from_numpy(t)).numpy())
    np.testing.assert_array_equal(got, np.asarray(JQ.lpw_exp2(
        jnp.asarray(t))))
    # at m = 32: the grid's largest score, and the tail that vanishes
    # (shifts of 2^-17 and more; at 2^-16, c[0] = 1 is a tie that rounds
    # to the even 0)
    assert got[255, 64] == TQ.lpw_exp2(torch.tensor(-0.25)).item() > 0.8
    assert (got[:, 64][k[:, 0] <= 64] == 0).all()
    assert (got[:, 64][k[:, 0] >= 68] > 0).all()


def _jump_scores(V, seed):
    """``_scores`` rows (fully masked, half-masked, max <= -17, partly
    masked) plus rows whose running max jumps by 13 and more across the
    16-wide slices: one that climbs by 13.25 per slice from -30, one low
    until its middle slice and then 25 higher."""
    x = _scores((6, V), seed=seed, scale=6.0)
    n = -(-V // 16)
    cols = np.arange(V)
    x[4] = -30.0 + 13.25 * (cols // 16) + 0.5 * np.sin(cols)
    x[5] = np.where(cols // 16 < n // 2, -20.0, 5.0) + np.cos(cols)
    return x


@pytest.mark.parametrize("V", [16, 200, 1024, 2048])
def test_register_route_arithmetic_matches_mirror_and_jax_kernel(V):
    """The register kernel's arithmetic EQUALS the mirror (f32 and bf16
    rows) and the Pallas kernel in interpret mode (f32)."""
    x = _jump_scores(V, seed=V + 1)
    got = softermax_quant_reg_plain(torch.from_numpy(x))
    assert torch.equal(got, softermax_quant_plain(torch.from_numpy(x)))
    want = np.asarray(_jit_unoptimized(lambda a: jax_softermax_quant_op(
        a, interpret=True))(jnp.asarray(x)))
    np.testing.assert_array_equal(got.numpy(), want)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got_b = softermax_quant_reg_plain(xb)
    assert got_b.dtype == torch.bfloat16
    assert torch.equal(got_b, softermax_quant_plain(xb))
    # a row masked in full is 1/V rounded on the Q(1,7) grid, and every
    # output is on that grid
    assert torch.equal(got * 128, torch.round(got * 128))


@pytest.mark.parametrize("shape,reg", [
    ((4, 1), True), ((4, 16), True), ((2, 3, 512), True), ((8, 1024), True),
    ((4, 2047), True), ((4, 2048), True), ((4, 2049), False),
    ((2, 4096), False), ((2049, 4), True)])
def test_fixed_point_register_route_rule(shape, reg):
    """K7's dispatch rule: rows (the last axis) of up to REG_CAP values take
    the register kernel, longer rows the two-pass kernel."""
    assert K7_REG_CAP == 2048
    assert k7_register_route(torch.zeros(shape)) is reg
