"""The port's plain versions of the paged kernels against the JAX package.

K1 (paged decode): the port's split-structured version against the JAX
Pallas kernel run in interpret mode and against the JAX split reference,
across kv tile sizes T x split lanes, odd lengths, zombie rows (length 0,
table 0), GQA groups 1 and 2, float32 and int8 pools; the port's gather
version against the JAX gather reference. K2 (paged chunked prefill): the
port's plain and split versions against the interpreted Pallas kernel and
the JAX reference with pos0 > 0, T in {1, 2}, float32 and int8 pools.
Tolerance ``atol`` 1e-5 (float32 sums in another order; every rescale is
an exact power of two). The tile/split geometry and the padded tables are
exactly equal. On CPU tensors the dispatchers take the plain versions.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_decode_paged as jdec
from repro.kernels import flash_prefill_paged as jpre
from repro.models.attention import quantize_kv
from repro_torch.kernels import flash_decode_paged as tdec
from repro_torch.kernels import flash_prefill_paged as tpre

ATOL = 1e-5


def _pools(rng, N, Hkv, BS, D, int8):
    k = rng.normal(size=(N, Hkv, BS, D)).astype(np.float32)
    v = rng.normal(size=(N, Hkv, BS, D)).astype(np.float32)
    if not int8:
        return k, v, None, None
    kq, ks = quantize_kv(jnp.asarray(k))
    vq, vs = quantize_kv(jnp.asarray(v))
    return tuple(np.asarray(a) for a in (kq, vq, ks, vs))


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=ATOL)


@pytest.mark.parametrize("W,T,split", [(7, 1, 1), (7, 1, 2), (7, 1, 3),
                                       (7, 2, 1), (7, 2, 3), (7, 4, 2),
                                       (3, 4, 3)])
def test_split_layout_and_padded_table_equal(W, T, split):
    assert tdec.split_layout(W, T, split) == jdec.split_layout(W, T, split)
    bt = np.arange(1, 2 * W + 1, dtype=np.int32).reshape(2, W)
    Wp = tdec.split_layout(W, T, split)[3]
    np.testing.assert_array_equal(
        tdec.pad_table(_t(bt), Wp).numpy(),
        np.asarray(jnp.pad(jnp.asarray(bt), ((0, 0), (0, Wp - W)))))


@pytest.mark.parametrize("T,split", [(1, 1), (1, 2), (1, 3), (2, 1), (2, 2),
                                     (2, 3), (4, 1), (4, 2), (4, 3)])
@pytest.mark.parametrize("G,int8", [(1, False), (2, True)])
def test_decode_matches_jax_kernel(T, split, G, int8):
    rng = np.random.default_rng(31 * T + split)
    B, Hkv, BS, D, W = 3, 2, 8, 16, 6
    N = B * W + 1
    k, v, ks, vs = _pools(rng, N, Hkv, BS, D, int8)
    bt = rng.permutation(np.arange(1, N))[:B * W].reshape(B, W)
    bt = bt.astype(np.int32)
    bt[1] = 0                                   # zombie row: table 0 ...
    lens = np.array([W * BS - 5, 0, 13], np.int32)  # ... and length 0
    q = (rng.normal(size=(B, G * Hkv, D)) / 4).astype(np.float32)
    got = tdec.paged_decode_split_ref(
        _t(q), _t(k), _t(v), _t(bt), _t(lens), split_k=split,
        kv_tile_blocks=T, k_scale=_t(ks), v_scale=_t(vs))
    kern = jdec.flash_decode_paged(
        _j(q), _j(k), _j(v), _j(bt), _j(lens), k_scale=_j(ks),
        v_scale=_j(vs), kv_tile_blocks=T, split_k=split, interpret=True)
    _close(got, kern)
    _close(got, jdec.paged_decode_split_ref(
        _j(q), _j(k), _j(v), _j(bt), _j(lens), split_k=split,
        kv_tile_blocks=T, k_scale=_j(ks), v_scale=_j(vs)))
    assert np.all(got[1].numpy() == 0)          # zombie: merge identity
    _close(tdec.paged_decode_ref(_t(q), _t(k), _t(v), _t(bt), _t(lens),
                                 k_scale=_t(ks), v_scale=_t(vs)),
           jdec.paged_decode_ref(_j(q), _j(k), _j(v), _j(bt), _j(lens),
                                 k_scale=_j(ks), v_scale=_j(vs)))


@pytest.mark.parametrize("intmax", [True, False])
def test_decode_dispatcher_takes_plain_version_on_cpu(intmax):
    rng = np.random.default_rng(3)
    k, v, _, _ = _pools(rng, 9, 2, 8, 16, False)
    bt = np.arange(1, 9, dtype=np.int32).reshape(2, 4)
    lens = np.array([30, 7], np.int32)
    q = (rng.normal(size=(2, 4, 16)) / 4).astype(np.float32)
    before = tdec.flash_decode_paged.launches
    got = tdec.flash_decode_paged_op(_t(q), _t(k), _t(v), _t(bt), _t(lens),
                                     intmax=intmax, kv_tile_blocks=2,
                                     split_k=2)
    assert tdec.flash_decode_paged.launches == before
    _close(got, jdec.paged_decode_ref(_j(q), _j(k), _j(v), _j(bt),
                                      _j(lens), intmax=intmax))
    with pytest.raises(ValueError):
        tdec.flash_decode_paged(_t(q), _t(k), _t(v), _t(bt), _t(lens))


@pytest.mark.parametrize("T", [1, 2])
@pytest.mark.parametrize("int8", [False, True])
def test_prefill_matches_jax_kernel(T, int8):
    rng = np.random.default_rng(17 + T)
    B, Hkv, G, BS, D, Sq = 2, 2, 2, 8, 16, 11
    pos0 = np.array([5, 22], np.int32)
    W = -(-(int(pos0.max()) + Sq) // BS)
    N = B * W + 1
    k, v, ks, vs = _pools(rng, N, Hkv, BS, D, int8)
    bt = rng.permutation(np.arange(1, N))[:B * W].reshape(B, W)
    bt = bt.astype(np.int32)
    q = (rng.normal(size=(B, G * Hkv, Sq, D)) / 4).astype(np.float32)
    got = tpre.paged_prefill_ref(_t(q), _t(k), _t(v), _t(bt), _t(pos0),
                                 k_scale=_t(ks), v_scale=_t(vs))
    kern = jpre.flash_prefill_paged(
        _j(q), _j(k), _j(v), _j(bt), _j(pos0), k_scale=_j(ks),
        v_scale=_j(vs), kv_tile_blocks=T, block_q=8, interpret=True)
    _close(got, kern)
    _close(got, jpre.paged_prefill_ref(_j(q), _j(k), _j(v), _j(bt),
                                       _j(pos0), k_scale=_j(ks),
                                       v_scale=_j(vs)))


@pytest.mark.parametrize("int8", [False, True])
def test_prefill_split_version_under_chunk_table_contract(int8):
    """The CPU serving path: a chunk at pos0 with the engine's
    chunk-quantized cover table (pad entries = block 0)."""
    rng = np.random.default_rng(23)
    Hkv, G, BS, D, C, pos0 = 2, 2, 8, 16, 16, 40
    cover = -(-(pos0 + C) // BS)
    W = -(-cover // (C // BS)) * (C // BS)
    N = W + 2
    k, v, ks, vs = _pools(rng, N, Hkv, BS, D, int8)
    bt = np.zeros((1, W), np.int32)
    bt[0, :cover] = rng.permutation(np.arange(1, N))[:cover]
    q = (rng.normal(size=(1, G * Hkv, C, D)) / 4).astype(np.float32)
    p0 = np.array([pos0], np.int32)
    tail = 2 * (-(-C // BS)) + 1
    got = tpre.flash_prefill_paged_op(_t(q), _t(k), _t(v), _t(bt), _t(p0),
                                      k_scale=_t(ks), v_scale=_t(vs),
                                      split_tail_blocks=tail)
    _close(got, jpre.paged_prefill_split_ref(
        _j(q), _j(k), _j(v), _j(bt), _j(p0), tail_blocks=tail,
        k_scale=_j(ks), v_scale=_j(vs)))
    _close(got, jpre.paged_prefill_ref(_j(q), _j(k), _j(v), _j(bt),
                                       _j(p0), k_scale=_j(ks),
                                       v_scale=_j(vs)))
