"""K2's tensor-core route (paged chunked prefill on ``wgmma``) on the CPU
against the JAX package.

The CUDA kernel ``csrc/flash_prefill_paged_tc.cu`` runs only on the card.
Its numerical contract is held here: a plain emulation of its arithmetic —
64-row KV tiles gathered through the block table (rows past the padded
table zero-filled and masked), bf16 inputs whose products are exact in
f32, the IntMax recurrence in f32, each tile's p·V from p's three bf16
terms (``split_bf16``) into a fresh accumulator added to the rescaled O,
d summed from the f32 p, the key walk split between two walks (even and
odd tiles) merged exactly — against the JAX Pallas kernel in interpret mode and the JAX
reference, on the same bf16-rounded inputs. Cases: pos0 of 0
and of 37 (not a multiple of the 64-row tile), chunks of 11 and 70 rows
(not multiples of 64), GQA groups 1 and 3, blocks of 8 and 16 rows.

Tolerance ``ATOL`` 1e-5: the three terms sum to p exactly, so the two
sides differ only in the order of their f32 sums (tiles of 64 rows
against the JAX kernel's pool blocks); every IntMax rescale is an exact
power of two.

The dispatch rule ``tc_route`` is checked as a plain function, and the
wrapper's CPU behaviour: the dispatcher takes the plain version, the
kernel wrapper raises.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_prefill_paged as jpre
from repro_torch.core.numerics import NEG_INF
from repro_torch.kernels.flash_attention import split_bf16
from repro_torch.kernels.flash_decode_paged.ref import gather_kv
from repro_torch.kernels.flash_prefill_paged import (flash_prefill_paged,
                                                     flash_prefill_paged_op,
                                                     paged_prefill_ref,
                                                     tc_route)

ATOL = 1e-5
TILE = 64          # KV rows per tile of the tensor-core kernel


def _split_products(x, b):
    """x @ b with f32 x carried as its three bf16 terms (each product of two
    bf16 values is exact in f32), as the tensor-core kernel computes it."""
    return sum(t.float() @ b for t in split_bf16(x))


def _walk(qg, k, v, rows, n_pos, tiles, intmax):
    """One consumer warpgroup's walk over the 64-row KV tiles ``tiles``:
    the IntMax recurrence in f32 (a row whose first tile masks it in full
    keeps max NEG_INF and a finite state that the first live rescale or
    the merge multiplies by exactly 0), each tile's p·V from p's bf16
    terms into a fresh accumulator added to the rescaled O, d from the f32
    p."""
    m = torch.full((*qg.shape[:-1], 1), NEG_INF)
    d = torch.zeros_like(m)
    acc = torch.zeros_like(qg)
    for k0 in tiles:
        s = qg @ k[..., k0:k0 + TILE, :].transpose(-1, -2)
        cols = k0 + torch.arange(TILE)
        dead = (cols > rows) | (cols >= n_pos)
        s = torch.where(dead, torch.full_like(s, NEG_INF), s)
        mx = torch.amax(s, dim=-1, keepdim=True)
        m_new = torch.maximum(m, torch.ceil(mx) if intmax else mx)
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new)
        d = d * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + _split_products(p, v[..., k0:k0 + TILE, :])
        m = m_new
    return m, d, acc


def _tc_prefill(q, k_pool, v_pool, tables, pos0, intmax=True):
    """The tensor-core kernel's arithmetic on float32 tensors holding bf16
    values: q (B, Hq, Sq, D), pools (N, Hkv, BS, D), tables (B, W), pos0
    (B,). Two walks split the tiles (even and odd, as the kernel's two
    consumer warpgroups) and merge exactly; a row's walk past its last
    visible key adds p = 0 and alpha = 1 exactly, so walking every tile
    equals the kernel's skip."""
    B, Hq, Sq, D = q.shape
    _, Hkv, BS, _ = k_pool.shape
    W = tables.shape[1]
    n_pos = W * BS
    n_tiles = -(-n_pos // TILE)
    zeros = torch.zeros((B, Hkv, n_tiles * TILE - n_pos, D))
    k = torch.cat([gather_kv(k_pool, tables), zeros], dim=2)[:, :, None]
    v = torch.cat([gather_kv(v_pool, tables), zeros], dim=2)[:, :, None]
    qg = q.reshape(B, Hkv, Hq // Hkv, Sq, D)
    rows = (pos0[:, None] + torch.arange(Sq)[None])[:, None, None, :, None]
    tiles = range(0, n_pos, TILE)
    (m0, d0, o0), (m1, d1, o1) = (_walk(qg, k, v, rows, n_pos, tiles[w::2],
                                        intmax) for w in (0, 1))
    m = torch.maximum(m0, m1)
    f0, f1 = torch.exp2(m0 - m), torch.exp2(m1 - m)
    d = d0 * f0 + d1 * f1
    acc = o0 * f0 + o1 * f1
    o = torch.where(d > 0, acc / torch.where(d > 0, d, torch.ones_like(d)),
                    torch.zeros_like(acc))
    return o.reshape(B, Hq, Sq, D)


def _bf16(rng, shape, scale=1.0):
    """float32 numpy data holding values rounded to bf16."""
    x = torch.from_numpy((rng.normal(size=shape) * scale).astype(np.float32))
    return x.to(torch.bfloat16).float().numpy()


@pytest.mark.parametrize("intmax", [True, False], ids=["intmax", "base2"])
@pytest.mark.parametrize("BS", [8, 16])
@pytest.mark.parametrize("G", [1, 3])
@pytest.mark.parametrize("Sq", [11, 70])
@pytest.mark.parametrize("pos0", [0, 37])
def test_tensor_core_arithmetic_matches_jax_kernel(pos0, Sq, G, BS, intmax):
    """The emulation against the Pallas kernel in interpret mode and the
    JAX reference: two sequences, one at ``pos0`` and one 29 positions on,
    tables in a shuffled block order whose padded cover is not a multiple
    of the 64-row tile."""
    rng = np.random.default_rng(pos0 + 3 * Sq + 7 * G + BS)
    Hkv, D = 2, 32
    pos = np.array([pos0, pos0 + 29], np.int32)
    W = -(-(int(pos.max()) + Sq) // BS)
    N = 2 * W + 1
    k, v = _bf16(rng, (N, Hkv, BS, D)), _bf16(rng, (N, Hkv, BS, D))
    bt = rng.permutation(np.arange(1, N))[:2 * W].reshape(2, W)
    bt = bt.astype(np.int32)
    q = _bf16(rng, (2, G * Hkv, Sq, D), D ** -0.5)
    got = _tc_prefill(*(torch.from_numpy(a) for a in (q, k, v, bt, pos)),
                      intmax=intmax)
    jargs = [jnp.asarray(a) for a in (q, k, v, bt, pos)]
    kern = jpre.flash_prefill_paged(*jargs, intmax=intmax, block_q=16,
                                    interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(kern), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jpre.paged_prefill_ref(*jargs,
                                                       intmax=intmax)),
        atol=ATOL, rtol=0)


def _pool(dtype, BS=16, D=64, offset=0):
    """A (4, 2, BS, D) pool of ``dtype``, ``offset`` elements into its
    storage (offset 1: off a 16-byte boundary)."""
    n = 4 * 2 * BS * D
    return torch.zeros(n + offset, dtype=dtype)[offset:].view(4, 2, BS, D)


@pytest.mark.parametrize("qdt,kdt,D,BS,offset,want", [
    (torch.bfloat16, torch.bfloat16, 128, 16, 0, True),
    (torch.bfloat16, torch.bfloat16, 64, 8, 0, True),
    (torch.bfloat16, torch.bfloat16, 16, 32, 0, True),
    (torch.bfloat16, torch.bfloat16, 128, 64, 0, True),
    (torch.bfloat16, torch.bfloat16, 36, 16, 0, False),
    (torch.bfloat16, torch.bfloat16, 144, 16, 0, False),
    (torch.bfloat16, torch.bfloat16, 128, 4, 0, False),
    (torch.bfloat16, torch.bfloat16, 128, 24, 0, False),
    (torch.bfloat16, torch.bfloat16, 128, 128, 0, False),
    (torch.bfloat16, torch.bfloat16, 128, 16, 1, False),
    (torch.float32, torch.float32, 128, 16, 0, False),
    (torch.bfloat16, torch.float32, 128, 16, 0, False),
    (torch.float32, torch.bfloat16, 128, 16, 0, False),
    (torch.bfloat16, torch.int8, 128, 16, 0, False)])
def test_tc_route_rule(qdt, kdt, D, BS, offset, want):
    """bf16 q with a bf16 pool, D a multiple of 16 up to 128, BS a multiple
    of 8 dividing 64 and 16-byte-aligned pools take the tensor-core kernel;
    everything else the CUDA-core kernel."""
    q = torch.zeros(1, 4, 3, D, dtype=qdt)
    pool = _pool(kdt, BS, D, offset)
    assert tc_route(q, pool, pool) is want
    assert tc_route(q, pool) is want


def test_prefill_dispatcher_takes_plain_version_on_cpu():
    """On CPU tensors the dispatcher takes the plain version and counts no
    launch on either route; the kernel wrapper raises."""
    rng = np.random.default_rng(5)
    k = torch.from_numpy(_bf16(rng, (5, 2, 16, 64))).to(torch.bfloat16)
    v = torch.from_numpy(_bf16(rng, (5, 2, 16, 64))).to(torch.bfloat16)
    q = torch.from_numpy(_bf16(rng, (1, 4, 9, 64), 0.125)).to(torch.bfloat16)
    bt = torch.tensor([[3, 1, 4]], dtype=torch.int32)
    pos = torch.tensor([30], dtype=torch.int32)
    before = (flash_prefill_paged.launches, flash_prefill_paged.launches_tc)
    got = flash_prefill_paged_op(q, k, v, bt, pos)
    assert (flash_prefill_paged.launches,
            flash_prefill_paged.launches_tc) == before
    assert torch.equal(got, paged_prefill_ref(q, k, v, bt, pos))
    with pytest.raises(ValueError):
        flash_prefill_paged(q, k, v, bt, pos)
