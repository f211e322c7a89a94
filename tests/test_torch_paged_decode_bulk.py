"""The grouped paged decode's bulk-copy route (K1) on the CPU: its lane
layout, its split version and its route rule.

The kernel (``csrc/flash_decode_paged_bulk.cu``) runs only on the card; what
it computes is mirrored here:

* ``lane_blocks`` / ``live_lanes``: lanes split a row's LIVE blocks in equal
  shares of whole blocks — every live block in exactly one lane, lanes
  differing by at most one block, none reaching past ``ceil(len / BS)`` —
  at lengths 0, 1, BS - 1, BS and longer than half the table; the lane
  count follows its rule for a given count of resident blocks;
* ``paged_decode_live_split_ref``, the split version with that layout,
  against the JAX Pallas kernel in interpret mode and the JAX and port
  gather references, float32 and int8 pools, a row longer than half the
  table at split 2, zombie rows (length 0, table 0) and garbage table
  tails. Tolerance ``atol`` 1e-5 (float32 sums in another order; every
  rescale is an exact power of two);
* ``bulk_route``'s decisions on CPU tensors of each dtype and geometry.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_decode_paged as jdec
from repro.models.attention import quantize_kv
from repro_torch.kernels import flash_decode_paged as tdec
from repro_torch.kernels.flash_decode_paged.ops import (LANE_MAX, LANE_MIN,
                                                        MAX_LANES)

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


# ---- the lane layout --------------------------------------------------------

@pytest.mark.parametrize("BS,W", [(16, 8), (8, 13), (4, 40)])
@pytest.mark.parametrize("n", [1, 2, 3, 5, 8, 64])
def test_lane_blocks_cover_the_live_blocks_once(BS, W, n):
    half = W // 2 * BS
    for length in (0, 1, BS - 1, BS, BS + 1, half + 1, W * BS - 1, W * BS,
                   W * BS + 7):
        live = min(-(-length // BS), W)
        lanes = tdec.lane_blocks(length, BS, W, n)
        assert len(lanes) == n
        owner = np.zeros(W, np.int64)
        for start, stop in lanes:
            assert 0 <= start <= stop <= live      # never past the cover
            owner[start:stop] += 1
        assert (owner[:live] == 1).all() and (owner[live:] == 0).all()
        sizes = [stop - start for start, stop in lanes]
        assert max(sizes) - min(sizes) <= 1
        assert sizes == sorted(sizes, reverse=True)  # longer lanes first
        # lanes are contiguous and in order: lane j ends where j + 1 starts
        assert all(a[1] == b[0] for a, b in zip(lanes, lanes[1:]))


@pytest.mark.parametrize("pairs,W,split,resident,want", [
    (64, 64, 1, 396, 4),             # phase 6: a 64-block table
    (64, 128, 1, 396, 6),            # the engine's decode step: one wave
    (64, 512, 1, 396, 6),            # eight 8,192-token rows: one wave
    (64, 2048, 2, 396, 16),          # the full-width bench: 128 a lane
    (64, 2048, 32, 396, 32),         # split_k above both
    (64, 2048, 1, 264, 16), (16, 44, 2, 396, 3), (16, 64, 2, 396, 4),
    (6, 5, 2, 396, 2), (300, 100, 3, 396, 3), (1, 1000, 1, 396, 63),
    (1, 40000, 1, 396, MAX_LANES), (396, 9, 1, 396, 1), (500, 9, 1, 396, 1),
    (2, 1, 4, 396, 1), (8, 3000, 512, 264, MAX_LANES), (512, 4096, 1, 396, 32),
    (64, 129, 1, 0, 2), (3, 7, 9, 396, 7)])
def test_live_lanes_follow_the_rule(pairs, W, split, resident, want):
    """The most of split_k, the lanes that fill one wave of the card's
    resident blocks (at least LANE_MIN table blocks a lane), and the lanes
    that hold a table-long row to LANE_MAX blocks a lane; capped by the
    table width and MAX_LANES."""
    n = tdec.live_lanes(pairs, W, split, resident)
    assert n == want
    assert 1 <= n <= min(W, MAX_LANES)
    if n < min(W, MAX_LANES):
        fill = min(resident // pairs, -(-W // LANE_MIN))
        assert n == max(split, fill, -(-W // LANE_MAX), 1)
        # a table-long row's lanes walk at most LANE_MAX blocks, and as
        # many pairs' lanes as fill the card stay within one wave
        walks = [b - a for a, b in tdec.lane_blocks(W * 16, 16, W, n)]
        assert max(walks) <= LANE_MAX or n == split
        assert n == split or n == -(-W // LANE_MAX) or \
            pairs * n <= resident


# ---- the split version with that layout -------------------------------------

def _case(rng, B, Hkv, G, BS, D, W, lens, int8, garbage=True):
    N = B * W + 1
    k, v, ks, vs = _pools(rng, N, Hkv, BS, D, int8)
    bt = rng.permutation(np.arange(1, N))[:B * W].reshape(B, W)
    bt = bt.astype(np.int32)
    for b, ln in enumerate(lens):
        cover = min(-(-ln // BS), W)
        if garbage:                      # other rows' blocks past the cover
            bt[b, cover:] = rng.integers(0, N, W - cover)
        if ln == 0:
            bt[b] = 0                    # zombie row: table 0
    q = (rng.normal(size=(B, G * Hkv, D)) / 4).astype(np.float32)
    return q, k, v, bt, np.asarray(lens, np.int32), ks, vs


@pytest.mark.parametrize("n_lanes", [1, 2, 3, 6, 8])
@pytest.mark.parametrize("G,int8", [(1, False), (2, True), (3, False)])
def test_live_split_matches_jax_kernel(n_lanes, G, int8):
    """Lengths 0, 1, BS - 1, BS and a row longer than half the table; 8
    lanes over a 6-block table leave lanes without a block."""
    rng = np.random.default_rng(17 * G + n_lanes)
    Hkv, BS, D, W = 2, 8, 16, 6
    lens = [W * BS - 5, 0, 1, BS - 1, BS, (W // 2) * BS + 3]
    q, k, v, bt, ln, ks, vs = _case(rng, len(lens), Hkv, G, BS, D, W, lens,
                                    int8)
    got = tdec.paged_decode_live_split_ref(
        _t(q), _t(k), _t(v), _t(bt), _t(ln), n_lanes=n_lanes,
        k_scale=_t(ks), v_scale=_t(vs))
    kern = jdec.flash_decode_paged(
        _j(q), _j(k), _j(v), _j(bt), _j(ln), k_scale=_j(ks), v_scale=_j(vs),
        kv_tile_blocks=1, split_k=2, interpret=True)
    _close(got, kern)
    assert np.all(got[1].numpy() == 0)          # zombie: merge identity
    want = tdec.paged_decode_ref(_t(q), _t(k), _t(v), _t(bt), _t(ln),
                                 k_scale=_t(ks), v_scale=_t(vs))
    _close(got[2:], want[2:])
    _close(got[0], want[0])


@pytest.mark.parametrize("intmax", [True, False])
@pytest.mark.parametrize("int8", [False, True])
def test_live_split_long_row_at_split_2(intmax, int8):
    """A 16-block table, one row of 13 blocks (more than half the table)
    at split 2: the padded-table layout leaves it in one lane, the live
    layout gives the lanes 7 and 6 blocks. Held to the JAX split reference
    at the same split and to the JAX gather reference."""
    rng = np.random.default_rng(5 + int8)
    Hkv, G, BS, D, W = 2, 2, 4, 16, 16
    lens = [13 * BS - 1, 2 * BS, 1]
    q, k, v, bt, ln, ks, vs = _case(rng, len(lens), Hkv, G, BS, D, W, lens,
                                    int8)
    assert tdec.lane_blocks(lens[0], BS, W, 2) == [(0, 7), (7, 13)]
    got = tdec.paged_decode_live_split_ref(
        _t(q), _t(k), _t(v), _t(bt), _t(ln), n_lanes=2, k_scale=_t(ks),
        v_scale=_t(vs), intmax=intmax)
    _close(got, jdec.paged_decode_split_ref(
        _j(q), _j(k), _j(v), _j(bt), _j(ln), split_k=2, kv_tile_blocks=1,
        k_scale=_j(ks), v_scale=_j(vs), intmax=intmax))
    _close(got, jdec.paged_decode_ref(_j(q), _j(k), _j(v), _j(bt), _j(ln),
                                      k_scale=_j(ks), v_scale=_j(vs),
                                      intmax=intmax))


def test_live_split_reads_no_entry_past_the_cover():
    """Table entries past a row's live blocks may be anything, even out of
    the pool: the live version never reads them (the gather version, given
    the same table cleaned, agrees)."""
    rng = np.random.default_rng(9)
    Hkv, G, BS, D, W = 2, 3, 8, 16, 7
    lens = [3 * BS + 2, 0, W * BS]
    q, k, v, bt, ln, _, _ = _case(rng, len(lens), Hkv, G, BS, D, W, lens,
                                  False, garbage=False)
    dirty = bt.copy()
    dirty[0, 4:] = 10 ** 6
    dirty[1, :] = -7
    got = tdec.paged_decode_live_split_ref(_t(q), _t(k), _t(v), _t(dirty),
                                           _t(ln))
    want = tdec.paged_decode_ref(_t(q), _t(k), _t(v), _t(bt), _t(ln))
    _close(got[[0, 2]], want[[0, 2]])
    assert torch.all(got[1] == 0)


# ---- the route rule ---------------------------------------------------------

_DT = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8,
       "f16": torch.float16}


def _route_case(q_dt, kv_dt, G=3, BS=16, D=128, Hkv=2, shift=0,
                scale_shift=0):
    q = torch.zeros((2, G * Hkv, D), dtype=_DT[q_dt])
    shape = (5, Hkv, BS, D)
    n = int(np.prod(shape))
    flat = torch.zeros(2 * n + 64, dtype=_DT[kv_dt])
    k = flat[shift:shift + n].view(shape)
    v = flat[n + 32:2 * n + 32].view(shape)
    ks = vs = None
    if kv_dt == "int8":
        sflat = torch.zeros(2 * 5 * Hkv * BS + 8)
        m = 5 * Hkv * BS
        ks = sflat[scale_shift:scale_shift + m].view(shape[:3])
        vs = sflat[m + 4:2 * m + 4].view(shape[:3])
    return q, k, v, ks, vs


@pytest.mark.parametrize("q_dt,kv_dt,kw,want", [
    ("f32", "f32", {}, True), ("bf16", "bf16", {}, True),
    ("bf16", "int8", {}, True), ("f32", "int8", {}, True),
    ("f32", "bf16", {}, True), ("bf16", "f32", {}, True),
    ("f16", "bf16", {}, False),                    # q neither f32 nor bf16
    ("bf16", "bf16", dict(G=8), True), ("bf16", "bf16", dict(G=9), False),
    ("bf16", "bf16", dict(D=256), True), ("bf16", "bf16", dict(D=264), False),
    ("bf16", "bf16", dict(D=36), False),           # D not a multiple of 8
    ("f32", "f32", dict(D=8, BS=1), True),         # a 32-byte span
    ("bf16", "bf16", dict(D=8, BS=1), True),       # a 16-byte span
    ("bf16", "int8", dict(D=8, BS=1), False),      # an 8-byte span
    ("bf16", "int8", dict(D=8, BS=2), False),      # 8-byte scale rows
    ("bf16", "int8", dict(D=8, BS=4), True),
    ("bf16", "int8", dict(D=24, BS=12), True),
    ("f32", "f32", dict(shift=1), False),          # K 4 bytes off 16
    ("bf16", "bf16", dict(shift=8), True),         # 16 bytes on
    ("bf16", "int8", dict(scale_shift=1), False),  # scales off 16
    # two ring stages of one pool block must fit a block's shared memory
    ("f32", "f32", dict(BS=128, D=128), False),    # 128 KB a block
    ("bf16", "bf16", dict(BS=128, D=256), False),  # 128 KB a block
    ("f32", "f32", dict(BS=64, D=256), False),     # 128 KB a block
    ("bf16", "bf16", dict(BS=128, D=128), True),   # 64 KB a block
    ("bf16", "int8", dict(BS=128, D=256), True),   # 65 KB a block
    ("f32", "f32", dict(BS=96, D=128), True),      # 96 KB a block
])
def test_bulk_route_decisions(q_dt, kv_dt, kw, want):
    q, k, v, ks, vs = _route_case(q_dt, kv_dt, **kw)
    assert tdec.bulk_route(q, k, v, ks, vs) is want


def test_bulk_route_any_group_for_the_per_head_kernel():
    q, k, v, _, _ = _route_case("f32", "f32", G=12)
    assert not tdec.bulk_route(q, k, v)
    assert tdec.bulk_route(q, k, v, any_group=True)
    q, k, v, _, _ = _route_case("f32", "f32", G=12, D=36)
    assert not tdec.bulk_route(q, k, v, any_group=True)
    q, k, v, _, _ = _route_case("f32", "f32", G=12, BS=128)
    assert not tdec.bulk_route(q, k, v, any_group=True)


def test_cpu_dispatch_counts_no_launch_on_either_route():
    rng = np.random.default_rng(4)
    q, k, v, bt, ln, _, _ = _case(rng, 2, 2, 2, 8, 16, 4, [9, 30], False)
    before = (tdec.flash_decode_paged.launches,
              tdec.flash_decode_paged.launches_bulk,
              tdec.flash_decode_paged_single.launches,
              tdec.flash_decode_paged_single.launches_bulk)
    a = tdec.flash_decode_paged_op(_t(q), _t(k), _t(v), _t(bt), _t(ln),
                                   kv_tile_blocks=2, split_k=2)
    b = tdec.flash_decode_paged_single_op(_t(q), _t(k), _t(v), _t(bt),
                                          _t(ln))
    assert (tdec.flash_decode_paged.launches,
            tdec.flash_decode_paged.launches_bulk,
            tdec.flash_decode_paged_single.launches,
            tdec.flash_decode_paged_single.launches_bulk) == before
    _close(a, b)
    _close(a, tdec.paged_decode_live_split_ref(_t(q), _t(k), _t(v), _t(bt),
                                               _t(ln), n_lanes=2))
    for fn in (tdec.flash_decode_paged, tdec.flash_decode_paged_single):
        with pytest.raises(ValueError):
            fn(_t(q), _t(k), _t(v), _t(bt), _t(ln))
