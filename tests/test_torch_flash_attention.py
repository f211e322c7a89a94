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
    flash_attention_plain, scale_queries)

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
