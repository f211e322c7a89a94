"""The port's dense flash attention (K3 forward, K4 backward) on the CPU
against the JAX package.

The same inputs, made with numpy, go through the JAX Pallas kernels in
interpret mode (``flash_attention(..., interpret=True, return_stats=True)``,
``flash_attention_bwd(..., interpret=True)``), the JAX oracle
``attention_ref`` (and ``jax.vjp`` of it), and the port's plain versions
and trainable op, which take the plain versions on CPU tensors. Cases:
causal and non-causal, Sq = Sk and Sq < Sk, GQA groups 1 and 2, lengths
that are not multiples of any tile, IntMax on and off.

Tolerance ``atol`` 1e-5 in float32: the sums run in another order (tiles of
64 against the JAX kernel's 32); every IntMax rescale is an exact power of
two, so the row max ``m`` is compared exactly when IntMax is on. The row
statistics are compared as ``m + log2(d)``, the log-normalizer, which does
not depend on where the running max settles.

The numerical contract of the tensor-core kernels (bf16 inputs) is checked
here too, on the CPU: ``split_bf16`` (how ``p`` and ``dS`` enter a bf16
``wgmma``) holds its bounds over a numpy-seeded sweep, and a plain
emulation of the kernels' arithmetic (bf16 inputs, exact products, ``p``
and ``dS`` as three bf16 terms) holds the JAX kernels in interpret mode.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.flash_attention import \
    flash_attention as jax_flash
from repro.kernels.flash_attention.flash_backward import \
    flash_attention_bwd as jax_flash_bwd
from repro.kernels.flash_attention.ops import \
    flash_attention_op as jax_flash_op
from repro.kernels.flash_attention.ref import attention_ref as jax_ref
from repro_torch.kernels.flash_attention import (
    attention_ref, flash_attention, flash_attention_bwd,
    flash_attention_bwd_plain, flash_attention_op, flash_attention_op_refbwd,
    flash_attention_plain, scale_queries, split_bf16, tensor_core_route)
from repro_torch.core.numerics import LN_2, NEG_INF

ATOL = 1e-5
JAX_BLOCK = 32

# (B, Hq, Hkv, Sq, Sk, D, causal)
CASES = [
    (1, 2, 2, 37, 37, 32, True),      # G = 1, odd length
    (2, 4, 2, 13, 45, 16, True),      # G = 2, Sq < Sk: queries at the end
    (1, 2, 1, 20, 33, 32, False),     # non-causal, G = 2, ragged KV tail
    (1, 2, 2, 70, 70, 16, True),      # more than one 64-row KV tile
]
IDS = [f"B{c[0]}-G{c[1] // c[2]}-Sq{c[3]}-Sk{c[4]}-"
       f"{'causal' if c[6] else 'full'}" for c in CASES]


def _inputs(case, seed):
    B, Hq, Hkv, Sq, Sk, D, _ = case
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, Hq, Sq, D)).astype(np.float32)
    k = rng.normal(size=(B, Hkv, Sk, D)).astype(np.float32)
    v = rng.normal(size=(B, Hkv, Sk, D)).astype(np.float32)
    do = rng.normal(size=(B, Hq, Sq, D)).astype(np.float32)
    return q, k, v, do


def _t(*arrays):
    return [torch.from_numpy(a.copy()) for a in arrays]


def _close(a, b, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol,
                               rtol=0)


@pytest.mark.parametrize("intmax", [True, False], ids=["intmax", "base2"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_forward_matches_jax_kernel_and_ref(case, intmax):
    causal = case[6]
    q, k, v, _ = _inputs(case, 1)
    jo, jm, jd = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           causal=causal, intmax=intmax, block_q=JAX_BLOCK,
                           block_k=JAX_BLOCK, interpret=True,
                           return_stats=True)
    ref = jax_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  causal=causal, intmax=intmax)
    to, tm, td = flash_attention_plain(*_t(q, k, v), causal=causal,
                                       intmax=intmax, return_stats=True)
    _close(to, jo)
    _close(to, ref)
    _close(attention_ref(*_t(q, k, v), causal=causal, intmax=intmax), ref)
    lse_j = np.asarray(jm) + np.log2(np.asarray(jd))
    _close(tm.numpy() + np.log2(td.numpy()), lse_j)
    if intmax:
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_backward_matches_jax_kernel_and_vjp(case):
    causal = case[6]
    q, k, v, do = _inputs(case, 2)
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    jo, jm, jd = jax_flash(jq, jk, jv, causal=causal, block_q=JAX_BLOCK,
                           block_k=JAX_BLOCK, interpret=True,
                           return_stats=True)
    jgrads = jax_flash_bwd(jq, jk, jv, jo, jdo, jm, jd, causal=causal,
                           block_q=JAX_BLOCK, block_k=JAX_BLOCK,
                           interpret=True)
    _, vjp = jax.vjp(lambda a, b, c: jax_ref(a, b, c, causal=causal),
                     jq, jk, jv)
    ref_grads = vjp(jdo)
    tq, tk, tv, tdo = _t(q, k, v, do)
    to, tm, td = flash_attention_plain(tq, tk, tv, causal=causal,
                                       return_stats=True)
    tgrads = flash_attention_bwd_plain(tq, tk, tv, to, tdo, tm, td,
                                       causal=causal)
    for t, j, r in zip(tgrads, jgrads, ref_grads):
        _close(t, j)
        _close(t, r)


@pytest.mark.parametrize("intmax", [True, False], ids=["intmax", "base2"])
@pytest.mark.parametrize("case", CASES[1:3], ids=IDS[1:3])
def test_autograd_op_matches_jax_custom_vjp(case, intmax):
    causal = case[6]
    q, k, v, do = _inputs(case, 3)
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    jout, vjp = jax.vjp(
        lambda a, b, c: jax_flash_op(a, b, c, causal, intmax, JAX_BLOCK,
                                     JAX_BLOCK, True), jq, jk, jv)
    jgrads = vjp(jdo)
    before = (flash_attention.launches, flash_attention_bwd.launches)
    for op in (lambda a, b, c: flash_attention_op(a, b, c, causal, intmax),
               lambda a, b, c: flash_attention_op_refbwd(
                   a, b, c, causal=causal, intmax=intmax)):
        tq, tk, tv = (t.requires_grad_() for t in _t(q, k, v))
        out = op(tq, tk, tv)
        out.backward(torch.from_numpy(do))
        _close(out.detach(), jout)
        for t, j in zip((tq.grad, tk.grad, tv.grad), jgrads):
            _close(t, j)
    # CPU tensors take the plain versions: no kernel was launched
    assert (flash_attention.launches, flash_attention_bwd.launches) == before


def test_scale_queries_matches_jax():
    from repro.kernels.flash_attention.ops import \
        scale_queries as jax_scale_queries
    q = np.random.default_rng(4).normal(size=(1, 2, 5, 16)).astype(
        np.float32)
    for base2 in (True, False):
        np.testing.assert_array_equal(
            scale_queries(torch.from_numpy(q), 16, base2).numpy(),
            np.asarray(jax_scale_queries(jnp.asarray(q), 16, base2)))


def test_kernel_wrappers_refuse_cpu_tensors_and_bad_geometry():
    q, k, v, do = _t(*_inputs(CASES[0], 5))
    with pytest.raises(ValueError, match="CUDA tensors only"):
        flash_attention(q, k, v)
    o, m, d = flash_attention_plain(q, k, v, return_stats=True)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        flash_attention_bwd(q, k, v, o, do, m, d)
    with pytest.raises(ValueError, match="Sk >= Sq"):
        flash_attention_op(q, k[:, :, :10], v[:, :, :10])


def _split_sweep(seed):
    """f32 magnitudes from 2^-149 (the smallest subnormal: p far below its
    row's max) to 2^100 (|dS| far above any real one), both signs."""
    rng = np.random.default_rng(seed)
    x = (rng.uniform(1, 2, 20000) * 2.0 ** rng.integers(-149, 100, 20000)
         * rng.choice([-1, 1], 20000)).astype(np.float32)
    edges = np.array([1.0, 2.0 ** -126, 2.0 ** -118, 2.0 ** -110, 3e38,
                      np.nextafter(np.float32(1), np.float32(2))],
                     dtype=np.float32)
    return torch.from_numpy(np.concatenate([x, edges, -edges]))


def test_split_bf16_pair_holds_x_within_2e16():
    """The first two terms, the pair hi + lo, hold x within 2^-16·|x| (each
    bf16 rounding keeps 8 bits), or within 2^-134 (half the smallest bf16
    subnormal) where |x| < 2^-118 and lo falls among bf16's subnormals."""
    x = _split_sweep(6)
    hi, lo, _ = split_bf16(x)
    assert hi.dtype == lo.dtype == torch.bfloat16
    assert torch.equal(hi, x.to(torch.bfloat16))
    err = (hi.double() + lo.double() - x.double()).abs()
    bound = torch.maximum(2.0 ** -16 * x.double().abs(),
                          torch.full_like(err, 2.0 ** -134))
    assert bool((err <= bound).all())
    # the pair is not exact: what the kernels' third term is for
    assert (err > 0).sum().item() > len(x) // 2


def test_split_bf16_three_terms_are_exact():
    """hi + mid + lo = x exactly for |x| >= 2^-110, within 2^-134 below:
    a product of x with a bf16 value is a sum of three exact products."""
    x = _split_sweep(7)
    terms = split_bf16(x)
    assert len(terms) == 3
    assert all(t.dtype == torch.bfloat16 for t in terms)
    err = (sum(t.double() for t in terms) - x.double()).abs()
    normal = x.double().abs() >= 2.0 ** -110
    assert bool((err[normal] == 0).all())
    assert bool((err[~normal] <= 2.0 ** -134).all())


@pytest.mark.parametrize("dtype,D,want", [
    (torch.bfloat16, 16, True), (torch.bfloat16, 64, True),
    (torch.bfloat16, 128, True), (torch.bfloat16, 40, False),
    (torch.bfloat16, 24, False), (torch.float32, 64, False),
    (torch.float32, 128, False)])
def test_tensor_core_route_rule(dtype, D, want):
    """bf16 with D a multiple of 16 up to 128 takes the tensor-core kernels;
    f32 and every other D the CUDA-core kernels."""
    assert tensor_core_route(torch.zeros(1, 1, 1, D, dtype=dtype)) is want


def _bf16(*arrays):
    """float32 tensors holding the arrays rounded to bf16, as the kernels
    read them."""
    return [torch.from_numpy(a).to(torch.bfloat16).float() for a in arrays]


def _split_products(x, b):
    """x @ b with f32 x carried as its three bf16 terms (each product of two
    bf16 values is exact in f32), as the tensor-core kernels compute it."""
    return sum(t.float() @ b for t in split_bf16(x))


def _tc_forward(q, k, v, causal, intmax, block_k=64):
    """The forward kernel's arithmetic: exact scores, the IntMax recurrence
    in f32, each tile's p·V from p's bf16 terms."""
    B, Hq, Sq, D = q.shape
    _, Hkv, Sk, _ = k.shape
    qg = q.reshape(B, Hkv, Hq // Hkv, Sq, D)
    m = torch.full((*qg.shape[:-1], 1), NEG_INF)
    d = torch.zeros_like(m)
    acc = torch.zeros_like(qg)
    rows = torch.arange(Sq)[:, None] + (Sk - Sq)
    for k0 in range(0, Sk, block_k):
        kt = k[:, :, None, k0:k0 + block_k]
        vt = v[:, :, None, k0:k0 + block_k]
        s = qg @ kt.transpose(-1, -2)
        if causal:
            cols = k0 + torch.arange(s.shape[-1])[None]
            s = torch.where(rows >= cols, s, torch.full_like(s, NEG_INF))
        mx = torch.amax(s, dim=-1, keepdim=True)
        m_new = torch.maximum(m, torch.ceil(mx) if intmax else mx)
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new)
        d = d * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + _split_products(p, vt)
        m = m_new
    o = torch.where(d > 0, acc / torch.where(d > 0, d, torch.ones_like(d)),
                    torch.zeros_like(acc))
    return (o.reshape(B, Hq, Sq, D), m.reshape(B, Hq, Sq, 1),
            d.reshape(B, Hq, Sq, 1))


def _tc_backward(q, k, v, o, do, m, d, causal):
    """The backward kernels' arithmetic: exact s and dP, p and dS in f32,
    every product with p or dS from their bf16 terms."""
    B, Hq, Sq, D = q.shape
    _, Hkv, Sk, _ = k.shape

    def grouped(t):
        return t.reshape(B, Hkv, Hq // Hkv, Sq, t.shape[-1])

    qg, og, dog = grouped(q), grouped(o), grouped(do)
    kt, vt = k[:, :, None], v[:, :, None]
    s = qg @ kt.transpose(-1, -2)
    keep = torch.ones(Sq, Sk, dtype=torch.bool)
    if causal:
        keep = torch.arange(Sq)[:, None] + (Sk - Sq) >= torch.arange(Sk)
    p = torch.where(keep, torch.exp2(s - grouped(m)) /
                    torch.clamp(grouped(d), min=1e-30), torch.zeros_like(s))
    delta = torch.sum(dog * og, dim=-1, keepdim=True)
    ds = torch.where(keep, LN_2 * p * (dog @ vt.transpose(-1, -2) - delta),
                     torch.zeros_like(s))
    dq = _split_products(ds, kt)
    dk = _split_products(ds.transpose(-1, -2), qg).sum(2)
    dv = _split_products(p.transpose(-1, -2), dog).sum(2)
    return dq.reshape(B, Hq, Sq, D), dk, dv


@pytest.mark.parametrize("intmax", [True, False], ids=["intmax", "base2"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_tensor_core_arithmetic_matches_jax_kernels(case, intmax):
    """Forward and backward as the tensor-core kernels compute them (bf16
    inputs, exact products, p and dS as three bf16 terms) against the JAX
    kernels in interpret mode on the same bf16-rounded inputs. The terms
    sum to p and dS exactly (|x| >= 2^-110; below, within 2^-134, far under
    any tolerance here), so the only difference is the order of the f32
    sums: ``ATOL``, as in the float32 tests above."""
    causal = case[6]
    q, k, v, do = _bf16(*_inputs(case, 8))
    jq, jk, jv, jdo = (jnp.asarray(t.numpy()) for t in (q, k, v, do))
    jo, jm, jd = jax_flash(jq, jk, jv, causal=causal, intmax=intmax,
                           block_q=JAX_BLOCK, block_k=JAX_BLOCK,
                           interpret=True, return_stats=True)
    o, m, d = _tc_forward(q, k, v, causal, intmax)
    _close(o, jo)
    _close(m + torch.log2(d), np.asarray(jm) + np.log2(np.asarray(jd)))
    if intmax:
        np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
    jgrads = jax_flash_bwd(jq, jk, jv, jo, jdo, jm, jd, causal=causal,
                           block_q=JAX_BLOCK, block_k=JAX_BLOCK,
                           interpret=True)
    grads = _tc_backward(q, k, v, torch.from_numpy(np.array(jo)), do,
                         torch.from_numpy(np.array(jm)),
                         torch.from_numpy(np.array(jd)), causal)
    for t, j in zip(grads, jgrads):
        _close(t, j)
