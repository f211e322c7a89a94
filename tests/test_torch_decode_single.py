"""The port's per-query-head paged decode (K8) against the JAX package.

``paged_decode_single_plain`` against the JAX Pallas kernel
``flash_decode_paged_single`` in interpret mode: float32, bfloat16 and int8
pools, IntMax on and off, GQA groups 1, 2 and 4, a row of length 0, odd
lengths and lengths on block edges, table entries past each row's cover
set to garbage (other rows' blocks). Tolerance ``atol`` 1e-5 on float32
outputs (both sides compute in fp32 and differ in summation order; every
IntMax rescale is an exact power of two); bfloat16 outputs within one
bf16 step. A row of length 0 returns 0, as the TPU kernel does.

Against the port's K1 plain version (``paged_decode_split_ref``) at tiled
and split grids, as the reference holds its grouped kernel to K8
(``tests/test_decode_split.py::test_grouped_equals_legacy_per_head_kernel``).
On CPU tensors the dispatcher takes the plain version and launches nothing.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_decode_paged as jdec
from repro.models.attention import quantize_kv
from repro_torch.kernels import flash_decode_paged as tdec

ATOL = 1e-5


def _inputs(rng, B, G, Hkv, BS, D, W, lens, kv):
    N = B * W + 1
    k = rng.normal(size=(N, Hkv, BS, D)).astype(np.float32)
    v = rng.normal(size=(N, Hkv, BS, D)).astype(np.float32)
    ks = vs = None
    if kv == "int8":
        (kq, ksj), (vq, vsj) = quantize_kv(jnp.asarray(k)), \
            quantize_kv(jnp.asarray(v))
        k, v, ks, vs = (np.array(a) for a in (kq, vq, ksj, vsj))
    bt = rng.permutation(np.arange(1, N)).reshape(B, W).astype(np.int32)
    for b, ln in enumerate(lens):                 # garbage past the cover
        cover = -(-ln // BS)
        bt[b, cover:] = rng.integers(0, N, W - cover)
    q = (rng.normal(size=(B, G * Hkv, D)) / np.sqrt(D)).astype(np.float32)
    return q, k, v, bt, np.asarray(lens, np.int32), ks, vs


def _t(a, dtype=None):
    if a is None:
        return None
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def _j(a, dtype=None):
    if a is None:
        return None
    return jnp.asarray(a) if dtype is None else jnp.asarray(a, dtype)


@pytest.mark.parametrize("kv", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("intmax", [True, False])
@pytest.mark.parametrize("G,Hkv,BS", [(1, 2, 8), (4, 2, 8), (2, 1, 16)])
def test_plain_matches_jax_kernel(kv, intmax, G, Hkv, BS):
    rng = np.random.default_rng(
        [100 * ("f32", "bf16", "int8").index(kv), 10 * G + BS, intmax])
    B, D, W = 3, 16, 5
    lens = [0, BS, W * BS - 3] if G != 4 else [2 * BS + 1, 0, 7]
    q, k, v, bt, ln, ks, vs = _inputs(rng, B, G, Hkv, BS, D, W, lens, kv)
    tdt, jdt = (torch.bfloat16, jnp.bfloat16) if kv == "bf16" else \
        (None, None)
    got = tdec.paged_decode_single_plain(
        _t(q), _t(k, tdt), _t(v, tdt), _t(bt), _t(ln), k_scale=_t(ks),
        v_scale=_t(vs), intmax=intmax)
    want = jdec.flash_decode_paged_single(
        _j(q), _j(k, jdt), _j(v, jdt), _j(bt), _j(ln), k_scale=_j(ks),
        v_scale=_j(vs), intmax=intmax, interpret=True)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    zero = lens.index(0)
    assert np.all(got[zero].numpy() == 0) and np.all(
        np.asarray(want)[zero] == 0)


@pytest.mark.parametrize("intmax", [True, False])
def test_plain_matches_jax_kernel_bf16_queries(intmax):
    """bf16 queries and pools: both sides round the fp32 result once to
    bf16, so they differ by at most one bf16 step."""
    rng = np.random.default_rng(9)
    B, G, Hkv, BS, D, W = 3, 2, 2, 8, 16, 4
    q, k, v, bt, ln, _, _ = _inputs(rng, B, G, Hkv, BS, D, W, [13, 0, 32],
                                    "bf16")
    bf = torch.bfloat16
    got = tdec.paged_decode_single_plain(_t(q, bf), _t(k, bf), _t(v, bf),
                                         _t(bt), _t(ln), intmax=intmax)
    want = jdec.flash_decode_paged_single(
        _j(q, jnp.bfloat16), _j(k, jnp.bfloat16), _j(v, jnp.bfloat16),
        _j(bt), _j(ln), intmax=intmax, interpret=True)
    assert got.dtype == bf
    w = np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), w, rtol=2 ** -7,
                               atol=1e-6)


@pytest.mark.parametrize("T,S", [(1, 1), (2, 2), (4, 3)])
@pytest.mark.parametrize("kv", ["f32", "int8"])
def test_plain_matches_port_k1_plain(T, S, kv):
    rng = np.random.default_rng(31 * T + S)
    B, G, Hkv, BS, D, W = 3, 4, 2, 8, 16, 5
    q, k, v, bt, ln, ks, vs = _inputs(rng, B, G, Hkv, BS, D, W,
                                      [17, 0, 40], kv)
    args = (_t(q), _t(k), _t(v), _t(bt), _t(ln))
    single = tdec.paged_decode_single_plain(*args, k_scale=_t(ks),
                                            v_scale=_t(vs))
    grouped = tdec.paged_decode_split_ref(*args, kv_tile_blocks=T,
                                          split_k=S, k_scale=_t(ks),
                                          v_scale=_t(vs))
    np.testing.assert_allclose(single.numpy(), grouped.numpy(), atol=ATOL)
    assert np.all(single[1].numpy() == 0)


def test_plain_has_no_group_limit():
    """K8 takes any GQA group (K1 holds groups up to 8): a group of 12
    against the gather version on rows of positive length."""
    rng = np.random.default_rng(12)
    q, k, v, bt, ln, _, _ = _inputs(rng, 2, 12, 1, 8, 16, 4, [29, 5], "f32")
    args = (_t(q), _t(k), _t(v), _t(bt), _t(ln))
    np.testing.assert_allclose(
        tdec.paged_decode_single_plain(*args).numpy(),
        tdec.paged_decode_ref(*args).numpy(), atol=ATOL)


@pytest.mark.parametrize("intmax", [True, False])
def test_dispatcher_takes_plain_version_on_cpu(intmax):
    rng = np.random.default_rng(3)
    q, k, v, bt, ln, _, _ = _inputs(rng, 2, 2, 2, 8, 16, 4, [30, 7], "f32")
    args = (_t(q), _t(k), _t(v), _t(bt), _t(ln))
    before = tdec.flash_decode_paged_single.launches
    got = tdec.flash_decode_paged_single_op(*args, intmax=intmax)
    assert tdec.flash_decode_paged_single.launches == before
    assert torch.equal(got, tdec.paged_decode_single_plain(*args,
                                                           intmax=intmax))
    with pytest.raises(ValueError, match="CUDA"):
        tdec.flash_decode_paged_single(*args)
