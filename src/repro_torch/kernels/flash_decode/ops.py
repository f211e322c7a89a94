"""Contiguous-cache decode attention (K5): the CUDA kernels' wrapper and
the dispatcher.

``flash_decode`` replaces the Pallas TPU kernel
``repro/kernels/flash_decode/flash_decode.py:71`` with one of two
hand-written Hopper routes, by an explicit rule on dtype, shape and
alignment (``bulk_route``):

* f32 or bf16 queries and cache whose row, ``D`` elements, is a multiple of
  16 bytes, at 16-byte-aligned K and V — the bulk-copy kernel
  (``csrc/flash_decode_bulk.cu``): each split lane's live rows stream into
  a ring of shared-memory stages through ``cp.async.bulk``, lanes lie along
  D, and the last block of each (sequence, KV head) pair merges the split
  lanes in the same launch;
* every other geometry — the earlier kernel (``csrc/flash_decode.cu``),
  whose split lanes a second kernel merges.

Both are bound by bytes (see the sources' notes) and read the cache in
place: no padded copy, no row at or past a sequence's length. A failed
build or launch raises, on either route; nothing falls back. Launch counts:
``flash_decode.launches`` counts both routes, ``.launches_bulk`` the
bulk-copy route alone.

``flash_decode_op`` is the one dispatcher every caller uses: a CUDA tensor
goes to the kernels, a CPU tensor to the plain PyTorch version
``decode_ref``. There is no fallback between the two.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.dtypes import kv_code, q_code
from repro_torch.kernels.flash_decode.ref import decode_ref

WARP_ROWS = 32 * 4         # cache rows one pass of the earlier kernel reads
TARGET_BLOCKS = 2 * 132    # two blocks on each of the H100's 132 SMs
MAX_GROUP, MAX_HEAD_DIM = 8, 256
_FLOATS = (torch.float32, torch.bfloat16)


def bulk_tile_rows(D: int, itemsize: int) -> int:
    """Rows of one tile of the bulk-copy route (``row_geom`` in
    ``csrc/flash_decode_bulk.cu``): a lane holds 8 values of a row, ``cpl``
    16-byte chunks, so ``lpr`` lanes (a power of two) cover a row and a
    warp step ``32 // lpr`` rows; four consumer warps take ``4 // cpl``
    steps a tile — at most 8 KB of K a tile."""
    chunks = D * itemsize // 16
    cpl = itemsize // 2
    lpr = 1
    while lpr * cpl < chunks:
        lpr *= 2
    return 4 * (32 // lpr) * (4 // cpl)


def bulk_route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    """THE dispatch rule: f32 or bf16 queries and cache, a cache row of a
    multiple of 16 bytes, head dim <= 256, GQA group <= 8 and K and V at
    16-byte-aligned addresses take the bulk-copy kernel; every other
    geometry takes the earlier kernel."""
    D = k.shape[-1]
    return (q.dtype in _FLOATS and k.dtype in _FLOATS and
            D * k.element_size() % 16 == 0 and D <= MAX_HEAD_DIM and
            q.shape[1] // k.shape[1] <= MAX_GROUP and
            k.data_ptr() % 16 == 0 and v.data_ptr() % 16 == 0)


@functools.lru_cache(maxsize=None)
def split_lanes(pairs: int, S: int, tile_rows: int = WARP_ROWS):
    """THE split geometry — ``(lane_rows, n_split)``: the cache's ``S`` rows
    are cut into ``n_split`` lanes of ``lane_rows`` rows (whole tiles of
    ``tile_rows``: a pass of the earlier kernel's warps, or a tile of the
    bulk-copy route), one block each per (sequence, KV head) pair, enough
    lanes that the ``pairs`` blocks become about ``TARGET_BLOCKS``. It
    depends on the cache's shape only, never on the lengths (which live on
    the card)."""
    tiles = max(1, -(-S // tile_rows))
    n_split = max(1, min(-(-TARGET_BLOCKS // pairs), tiles))
    lane_rows = -(-tiles // n_split) * tile_rows
    return lane_rows, max(1, -(-S // lane_rows))


@functools.lru_cache(maxsize=None)
def _earlier_fits(G: int, D: int) -> bool:
    """Whether the earlier kernel's shared memory fits a Hopper block."""
    return build.load_library().smx_decode_smem(G, D) <= build.SMEM_LIMIT


_scratch = {}   # (device, stream) -> (float states, merge tickets)


def _lane_scratch(device, stream: int, floats: int, pairs: int):
    """The split lanes' states and the bulk route's merge tickets, kept per
    device and stream and grown on demand: launches on one stream run in
    order, and the kernel leaves every ticket at 0."""
    buf = _scratch.get((device, stream))
    if buf is None or buf[0].numel() < floats or buf[1].numel() < pairs:
        old = (0, 0) if buf is None else (buf[0].numel(), buf[1].numel())
        buf = (torch.empty(max(floats, old[0]), dtype=torch.float32,
                           device=device),
               torch.zeros(max(pairs, old[1]), dtype=torch.int32,
                           device=device))
        _scratch[(device, stream)] = buf
    return buf


def _check(q, k, v, lengths):
    """Raise on operands neither route takes; return (B, Hq, Hkv, S, D)."""
    if not q.is_cuda:
        raise ValueError("flash_decode runs on CUDA tensors only")
    devs = {t.device for t in (q, k, v, lengths)}
    if len(devs) != 1:
        raise ValueError(f"flash_decode: operands on several devices: {devs}")
    if k.shape != v.shape or k.dtype != v.dtype or k.dtype not in _FLOATS:
        raise ValueError("flash_decode: k and v must match in shape and be "
                         "float32 or bfloat16")
    if q.dim() != 3 or k.dim() != 4:
        raise ValueError(f"flash_decode: q {tuple(q.shape)} must be (B, Hq, "
                         f"D) and the cache {tuple(k.shape)} (B, Hkv, S, D)")
    B, Hq, D = q.shape
    _, Hkv, S, Dk = k.shape
    if k.shape[0] != B or Dk != D or Hq % Hkv or \
            Hq // Hkv > MAX_GROUP or D > MAX_HEAD_DIM or \
            tuple(lengths.shape) != (B,):
        raise ValueError(f"flash_decode: unsupported geometry q "
                         f"{tuple(q.shape)}, cache {tuple(k.shape)}, lengths "
                         f"{tuple(lengths.shape)} (GQA group <= {MAX_GROUP}, "
                         f"head dim <= {MAX_HEAD_DIM})")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_decode needs contiguous operands")
    return B, Hq, Hkv, S, D


def _launch(q, k, v, lengths, intmax, bulk=None):
    """One launch of the route ``bulk_route`` picks, or of the one ``bulk``
    names (the bulk-copy kernel or the earlier one); returns the output
    and whether the bulk-copy kernel ran."""
    B, Hq, Hkv, S, D = _check(q, k, v, lengths)
    if bulk is None:
        bulk = bulk_route(q, k, v)
    G, pairs = Hq // Hkv, B * Hkv
    lib = build.load_library()
    if bulk:
        lane_rows, n = split_lanes(pairs, S,
                                   bulk_tile_rows(D, k.element_size()))
    else:
        lane_rows, n = split_lanes(pairs, S)
        if not _earlier_fits(G, D):
            raise ValueError(f"flash_decode: head dim {D} does not fit in "
                             "shared memory")
    lens = lengths if lengths.dtype == torch.int32 and \
        lengths.is_contiguous() else lengths.to(torch.int32).contiguous()
    stream = build.stream_ptr(q.device)
    states = pairs * n * G           # acc (states x D), then m, then d
    floats, tickets = _lane_scratch(q.device, stream, states * (D + 2),
                                    pairs)
    acc = floats.data_ptr()
    out = torch.empty_like(q)
    args = [build.ptr(q), build.ptr(k), build.ptr(v), build.ptr(lens), acc,
            acc + 4 * states * D, acc + 4 * states * (D + 1)]
    if bulk:
        args.append(build.ptr(tickets))
        fn = lib.smx_decode_bulk
    else:
        fn = lib.smx_decode
    err = fn(*args, build.ptr(out), B, Hq, Hkv, S, D, lane_rows, n,
             q_code(q.dtype), kv_code(k.dtype), int(intmax), stream)
    build.check(err, "flash_decode (bulk copy)" if bulk else "flash_decode")
    return out, bulk


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 lengths: torch.Tensor, *,
                 intmax: bool = True) -> torch.Tensor:
    """q (B, Hq, D) pre-scaled; k, v (B, Hkv, S, D) float32 or bfloat16;
    lengths (B,) → (B, Hq, D) in q's dtype."""
    out, bulk = _launch(q, k, v, lengths, intmax)
    if bulk:
        flash_decode.launches_bulk += 1
    flash_decode.launches += 1
    return out


flash_decode.launches = 0
flash_decode.launches_bulk = 0


def flash_decode_op(q, k, v, lengths, *, intmax: bool = True) -> torch.Tensor:
    if q.is_cuda:
        return flash_decode(q, k, v, lengths, intmax=intmax)
    return decode_ref(q, k, v, lengths, intmax=intmax)
