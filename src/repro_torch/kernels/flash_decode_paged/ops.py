"""Paged decode attention: the CUDA kernels' wrappers and the dispatchers.

``flash_decode_paged`` replaces the Pallas TPU kernel
``repro/kernels/flash_decode_paged/flash_decode_paged.py:150`` with one of
two hand-written Hopper routes, by an explicit rule on dtype, shape and
alignment (``bulk_route``):

* f32 or bf16 queries over an f32, bf16 or int8 pool, GQA group <= 8, D a
  multiple of 8 up to 256, each (pool block, KV head) span of K, V and the
  int8 scales a multiple of 16 bytes, pools and scales at 16-byte-aligned
  addresses, and two ring stages of one pool block within a block's shared
  memory — the bulk-copy kernel (``csrc/flash_decode_paged_bulk.cu``):
  each pool block is one ``cp.async.bulk`` into a ring of stages, the
  lanes split the row's live blocks (``live_lanes``, ``ref.lane_blocks``)
  and merge in the same launch;
* every other geometry — the earlier kernel (``csrc/flash_decode_paged.cu``),
  which splits the padded table and merges in a second kernel.

Both are bound by bytes (see the sources' notes). A failed build or launch
raises, on either route; nothing falls back. Launch counts:
``flash_decode_paged.launches`` counts both routes, ``.launches_bulk`` the
bulk-copy route alone.

``flash_decode_paged_single`` launches the per-query-head kernel (K8),
which replaces the TPU kernel ``flash_decode_paged_single``
(``flash_decode_paged.py:302``): the benchmark baseline the grouped kernel
is measured against, never on the serving path. The same rule at any GQA
group sends it to ``csrc/flash_decode_paged_single_bulk.cu`` (a producer
keeping the next pool blocks in flight), other geometries to
``csrc/flash_decode_paged_single.cu``. Launch counts
``flash_decode_paged_single.launches`` and ``.launches_bulk``.

``flash_decode_paged_op`` is the one dispatcher every caller uses: a CUDA
tensor goes to the kernels, a CPU tensor to the plain PyTorch version
``paged_decode_ref``. There is no fallback between the two. Tile and split
are layout knobs: every setting computes the same attention, so the plain
version ignores them. ``flash_decode_paged_single_op`` dispatches K8 the
same way, to ``plain.paged_decode_single_plain`` on the CPU.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.dtypes import kv_code, q_code
from repro_torch.kernels.flash_decode.ops import lane_scratch
from repro_torch.kernels.flash_decode_paged.plain import \
    paged_decode_single_plain
from repro_torch.kernels.flash_decode_paged.ref import (paged_decode_ref,
                                                        pad_table,
                                                        split_layout)

MAX_GROUP, MAX_HEAD_DIM = 8, 256
MAX_LANES = 256            # split lanes a (sequence, KV head) pair at most
# a table-long row's lane walks at least LANE_MIN and at most LANE_MAX
# table blocks (see live_lanes)
LANE_MIN, LANE_MAX = 16, 128
_QS = (torch.float32, torch.bfloat16)
_ITEMSIZE = {torch.float32: 4, torch.bfloat16: 2, torch.int8: 1}
# the most dynamic shared memory the bulk-copy kernels ask for: a block's
# limit less the reserve for their static arrays (PDB_SMEM_MAX in
# csrc/paged_decode_bulk.cuh)
_RING_MAX = build.SMEM_LIMIT - 1024


def check_operands(name, q, k_pool, v_pool, k_scale, v_scale, *index):
    """Validate what the paged kernels take (shared by both wrappers): plain
    tensors only, as the serving path keeps them."""
    build.refuse_dtensor(name, q, k_pool, v_pool, k_scale, v_scale, *index)
    if not q.is_cuda:
        raise ValueError(f"{name} runs on CUDA tensors only")
    dev = q.get_device()
    for t in (k_pool, v_pool, k_scale, v_scale, *index):
        if t is not None and t.get_device() != dev:
            devs = {t.device for t in (q, k_pool, v_pool, k_scale, v_scale,
                                       *index) if t is not None}
            raise ValueError(f"{name}: operands on several devices: {devs}")
    if k_pool.shape != v_pool.shape or k_pool.dtype != v_pool.dtype:
        raise ValueError(f"{name}: k_pool and v_pool must match in shape "
                         "and dtype")
    if (k_scale is None) != (k_pool.dtype != torch.int8) or \
            (k_scale is None) != (v_scale is None):
        raise ValueError(f"{name}: int8 pools need both scale pools, "
                         "other pools none")
    for t in (k_scale, v_scale):
        if t is not None and (t.dtype != torch.float32 or
                              t.shape != k_pool.shape[:3]):
            raise ValueError(f"{name}: scales must be float32 "
                             f"{tuple(k_pool.shape[:3])}")
    for t in (q, k_pool, v_pool, k_scale, v_scale):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} needs contiguous operands")


@functools.lru_cache(maxsize=None)
def _bulk_shapes(q_dtype, kv_dtype, G: int, BS: int, D: int,
                any_group: bool = False) -> bool:
    """The dtype and shape half of ``bulk_route``."""
    elem = _ITEMSIZE.get(kv_dtype)
    if elem is None:
        return False
    quant = kv_dtype == torch.int8
    block = 2 * BS * D * elem + (2 * BS * 4 if quant else 0)
    return (q_dtype in _QS and (any_group or G <= MAX_GROUP) and
            D <= MAX_HEAD_DIM and D % 8 == 0 and BS * D * elem % 16 == 0 and
            (not quant or BS * 4 % 16 == 0) and 2 * block <= _RING_MAX)


def bulk_route(q, k_pool, v_pool, k_scale=None, v_scale=None, *,
               any_group: bool = False) -> bool:
    """THE dispatch rule of both paged kernels: f32 or bf16 queries, an f32,
    bf16 or int8 pool, GQA group <= 8 (any group for K8, ``any_group``), D
    a multiple of 8 up to 256 (a lane's 8 values are one aligned load),
    each (pool block, KV head) span of K, V and the int8 scales a multiple
    of 16 bytes, two ring stages of one pool block (K, V and scales) within
    a block's shared memory, and pools and scales at 16-byte-aligned
    addresses take the bulk-copy kernel; every other call takes the earlier
    kernel."""
    _, Hkv, BS, D = k_pool.shape
    if not _bulk_shapes(q.dtype, k_pool.dtype, q.shape[1] // max(Hkv, 1), BS,
                       D, any_group):
        return False
    return all(t.data_ptr() % 16 == 0 for t in (k_pool, v_pool, k_scale,
                                                 v_scale) if t is not None)


def live_lanes(pairs: int, W: int, split_k: int, resident: int) -> int:
    """THE lane count of the bulk-copy route for ``pairs`` (sequence, KV
    head) pairs over a table of ``W`` blocks, on a card that holds
    ``resident`` of its blocks at once. Shapes only, never the lengths
    (they live on the card), so each term reads a row as long as the table:

    * fill the card: as many lanes as keep the pairs within one wave of
      resident blocks (a second, partial wave costs more than it gives),
      but no more than give each lane ``LANE_MIN`` table blocks (below
      that a lane's start and its share of the merge outweigh the spread);
    * cut the walk: at least as many lanes as hold a table-long row to
      ``LANE_MAX`` blocks a lane, past the wave: one long row among short
      ones leaves most lanes empty, and its own lanes set the time;
    * at least ``split_k``; never more than ``W`` (a lane without a block
      is pure cost) or ``MAX_LANES``.
    """
    fill = min(resident // max(pairs, 1), -(-W // LANE_MIN))
    want = max(split_k, fill, -(-W // LANE_MAX))
    return max(1, min(W, MAX_LANES, want))


@functools.lru_cache(maxsize=None)
def _resident(device: int, G: int, D: int, BS: int, kv: int, T: int) -> int:
    """Blocks of the bulk-copy kernel the card holds at once at this
    geometry (the compiled kernel's occupancy times the SM count)."""
    with torch.cuda.device(device):
        n = build.load_library().smx_paged_decode_bulk_resident(G, D, BS, kv,
                                                                T)
    if n < 0:
        build.check(-n, "flash_decode_paged (occupancy)")
    if n == 0:
        raise ValueError(f"flash_decode_paged: two stages of {BS} x {D} "
                         "pool blocks do not fit in shared memory")
    return n


@functools.lru_cache(maxsize=None)
def _lanes(device: int, G: int, D: int, BS: int, kv: int, T: int, pairs: int,
           W: int, split_k: int) -> int:
    return live_lanes(pairs, W, split_k, _resident(device, G, D, BS, kv, T))


def bulk_lanes(q, k_pool, block_tables, kv_tile_blocks: int = 1,
               split_k: int = 1) -> int:
    """The lanes a pair the bulk-copy route launches for these operands on
    their card (``live_lanes``)."""
    B, Hq, D = q.shape
    _, Hkv, BS, _ = k_pool.shape
    return _lanes(q.get_device(), Hq // Hkv, D, BS, kv_code(k_pool.dtype),
                  kv_tile_blocks, B * Hkv, block_tables.shape[1], split_k)


@functools.lru_cache(maxsize=None)
def _earlier_fits(G: int, D: int, T: int, BS: int, spl: int) -> bool:
    return build.load_library().smx_paged_decode_smem(
        G, D, T, BS, spl) <= build.SMEM_LIMIT


def _int32(t: torch.Tensor) -> torch.Tensor:
    """``t`` as contiguous int32, cast only where it is not already."""
    if t.dtype == torch.int32 and t.is_contiguous():
        return t
    return t.to(torch.int32).contiguous()


def _launch(q, k_pool, v_pool, block_tables, lengths, k_scale, v_scale,
            intmax, kv_tile_blocks, split_k, bulk=None, lanes=None):
    """One launch of the route ``bulk_route`` picks, or of the one ``bulk``
    names (the bulk-copy kernel or the earlier one), the bulk-copy route on
    ``lanes`` lanes a pair where given (a layout knob, like ``split_k``);
    returns the output and whether the bulk-copy kernel ran."""
    check_operands("flash_decode_paged", q, k_pool, v_pool, k_scale,
                   v_scale, block_tables, lengths)
    B, Hq, D = q.shape
    _, Hkv, BS, Dk = k_pool.shape
    if Dk != D or Hq % Hkv or Hq // Hkv > MAX_GROUP or \
            block_tables.shape[0] != B or tuple(lengths.shape) != (B,):
        raise ValueError(f"unsupported geometry q {tuple(q.shape)}, pool "
                         f"{tuple(k_pool.shape)}, table "
                         f"{tuple(block_tables.shape)}, lengths "
                         f"{tuple(lengths.shape)} (GQA group must be <= 8)")
    if bulk is None:
        bulk = bulk_route(q, k_pool, v_pool, k_scale, v_scale)
    G, W, pairs = Hq // Hkv, block_tables.shape[1], B * Hkv
    kv, qc = kv_code(k_pool.dtype), q_code(q.dtype)
    lens = _int32(lengths)
    lib = build.load_library()
    stream = build.stream_ptr(q.device)
    out = torch.empty_like(q)
    if bulk:
        n = lanes or _lanes(q.get_device(), G, D, BS, kv, kv_tile_blocks,
                            pairs, W, split_k)
        bt = _int32(block_tables)
        acc = m = d = tickets = None
        if n > 1:
            states = pairs * n * G       # acc (states x D), then m, then d
            floats, tk = lane_scratch(q.device, stream, states * (D + 2),
                                      pairs)
            acc = floats.data_ptr()
            m, d, tickets = (acc + 4 * states * D,
                             acc + 4 * states * (D + 1), tk.data_ptr())
        err = lib.smx_paged_decode_bulk(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            build.ptr(k_scale), build.ptr(v_scale), bt.data_ptr(),
            lens.data_ptr(), acc, m, d, tickets, out.data_ptr(), B, Hq, Hkv,
            D, BS, W, kv_tile_blocks, n, qc, kv, int(intmax), stream)
        build.check(err, "flash_decode_paged (bulk copy)")
        return out, True
    T, S, spl, Wp = split_layout(W, kv_tile_blocks, split_k)
    if not _earlier_fits(G, D, T, BS, spl):
        raise ValueError(f"flash_decode_paged: kv_tile_blocks={T} x "
                         f"block_size={BS} rows (x {spl} tiles per lane) do "
                         "not fit in shared memory")
    bt = pad_table(block_tables, Wp)
    f32 = dict(dtype=torch.float32, device=q.device)
    acc = torch.empty((B * Hkv, S, G, D), **f32)
    m = torch.empty((B * Hkv, S, G), **f32)
    d = torch.empty((B * Hkv, S, G), **f32)
    err = lib.smx_paged_decode(
        build.ptr(q), build.ptr(k_pool), build.ptr(v_pool),
        build.ptr(k_scale), build.ptr(v_scale), build.ptr(bt),
        build.ptr(lens), build.ptr(acc), build.ptr(m), build.ptr(d),
        build.ptr(out), B, Hq, Hkv, D, BS, Wp, T, S, spl, qc, kv,
        int(intmax), stream)
    build.check(err, "flash_decode_paged")
    return out, False


def flash_decode_paged(q: torch.Tensor, k_pool: torch.Tensor,
                       v_pool: torch.Tensor, block_tables: torch.Tensor,
                       lengths: torch.Tensor, *, k_scale=None, v_scale=None,
                       intmax: bool = True, kv_tile_blocks: int = 1,
                       split_k: int = 1) -> torch.Tensor:
    """q (B, Hq, D) pre-scaled; pools (N, Hkv, BS, D) f32/bf16/int8; int8
    scales (N, Hkv, BS) f32; tables (B, W); lengths (B,) → (B, Hq, D) in
    q's dtype."""
    out, bulk = _launch(q, k_pool, v_pool, block_tables, lengths, k_scale,
                        v_scale, intmax, kv_tile_blocks, split_k)
    build.count(flash_decode_paged, "launches",
                *(("launches_bulk",) if bulk else ()))
    return out


flash_decode_paged.launches = 0
flash_decode_paged.launches_bulk = 0


def flash_decode_paged_op(q, k_pool, v_pool, block_tables, lengths, *,
                          k_scale=None, v_scale=None, intmax: bool = True,
                          kv_tile_blocks: int = 1,
                          split_k: int = 1) -> torch.Tensor:
    if q.is_cuda:
        return flash_decode_paged(q, k_pool, v_pool, block_tables, lengths,
                                  k_scale=k_scale, v_scale=v_scale,
                                  intmax=intmax,
                                  kv_tile_blocks=kv_tile_blocks,
                                  split_k=split_k)
    return paged_decode_ref(q, k_pool, v_pool, block_tables, lengths,
                            k_scale=k_scale, v_scale=v_scale, intmax=intmax)


def _launch_single(q, k_pool, v_pool, block_tables, lengths, k_scale,
                   v_scale, intmax, bulk=None):
    """One launch of K8 on the route ``bulk_route`` (any group) picks, or
    on the one ``bulk`` names; returns the output and whether the
    bulk-copy kernel ran."""
    check_operands("flash_decode_paged_single", q, k_pool, v_pool, k_scale,
                   v_scale, block_tables, lengths)
    B, Hq, D = q.shape
    _, Hkv, BS, Dk = k_pool.shape
    if Dk != D or Hq % Hkv or D > 256 or block_tables.shape[0] != B or \
            tuple(lengths.shape) != (B,):
        raise ValueError(f"unsupported geometry q {tuple(q.shape)}, pool "
                         f"{tuple(k_pool.shape)}, table "
                         f"{tuple(block_tables.shape)}, lengths "
                         f"{tuple(lengths.shape)} (head dim must be <= 256)")
    if bulk is None:
        bulk = bulk_route(q, k_pool, v_pool, k_scale, v_scale,
                          any_group=True)
    bt, lens = _int32(block_tables), _int32(lengths)
    out = torch.empty_like(q)
    lib = build.load_library()
    fn = lib.smx_paged_decode_single_bulk if bulk else \
        lib.smx_paged_decode_single
    err = fn(build.ptr(q), build.ptr(k_pool), build.ptr(v_pool),
             build.ptr(k_scale), build.ptr(v_scale), build.ptr(bt),
             build.ptr(lens), build.ptr(out), B, Hq, Hkv, D, BS,
             bt.shape[1], q_code(q.dtype), kv_code(k_pool.dtype),
             int(intmax), build.stream_ptr(q.device))
    build.check(err, "flash_decode_paged_single (bulk copy)" if bulk else
                "flash_decode_paged_single")
    return out, bulk


def flash_decode_paged_single(q: torch.Tensor, k_pool: torch.Tensor,
                              v_pool: torch.Tensor, block_tables: torch.Tensor,
                              lengths: torch.Tensor, *, k_scale=None,
                              v_scale=None,
                              intmax: bool = True) -> torch.Tensor:
    """q (B, Hq, D) pre-scaled, float32 or bfloat16; pools (N, Hkv, BS, D)
    f32/bf16/int8; int8 scales (N, Hkv, BS) f32; tables (B, nb); lengths
    (B,) → (B, Hq, D) in q's dtype. Any GQA group size."""
    out, bulk = _launch_single(q, k_pool, v_pool, block_tables, lengths,
                               k_scale, v_scale, intmax)
    build.count(flash_decode_paged_single, "launches",
                *(("launches_bulk",) if bulk else ()))
    return out


flash_decode_paged_single.launches = 0
flash_decode_paged_single.launches_bulk = 0


def flash_decode_paged_single_op(q, k_pool, v_pool, block_tables, lengths, *,
                                 k_scale=None, v_scale=None,
                                 intmax: bool = True) -> torch.Tensor:
    if q.is_cuda:
        return flash_decode_paged_single(q, k_pool, v_pool, block_tables,
                                         lengths, k_scale=k_scale,
                                         v_scale=v_scale, intmax=intmax)
    return paged_decode_single_plain(q, k_pool, v_pool, block_tables,
                                     lengths, k_scale=k_scale,
                                     v_scale=v_scale, intmax=intmax)
