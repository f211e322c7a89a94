// Per-query-head paged single-token decode with Softermax: the bulk-copy
// route (Hopper, sm_90a).
//
// Replaces the Pallas TPU kernel flash_decode_paged_single
// (src/repro/kernels/flash_decode_paged/flash_decode_paged.py:302, body
// _paged_decode_kernel_single at :251) wherever the pool's (block, KV head)
// spans are multiples of 16 bytes at 16-byte-aligned pools and scales and
// D is a multiple of 8 up to 256, at any GQA group
// (kernels/flash_decode_paged/ops.py::bulk_route); every other geometry
// keeps flash_decode_paged_single.cu. It is the benchmark baseline the
// grouped kernel is measured against, so it keeps the dataflow that
// defines it:
//  * one block per (sequence, query head): every query head of a GQA group
//    reads the group's K/V for itself, G times the grouped kernel's bytes;
//  * one pool block per stage, walked in table order; no tile of blocks and
//    no split.
// What changes is how a step is fed and reduced (the walk is
// paged_decode_bulk.cuh's, shared with K1's route, at one query head a
// block):
//  * a producer warp keeps the next live pool blocks in flight, each one
//    bulk copy of K and one of V (and an int8 pool's scale rows), in a ring
//    of up to 8 stages within 128 KB: the walk was one dependent gather a
//    step, 1,025 steps of ~4.8 us for the bench's 16,385-token row;
//  * four consumer warps take the pool blocks in turn, each reducing its
//    block's BS scores and their max with warp shuffles into a private
//    state, the states merged exactly at the end: no block barrier inside
//    the walk;
//  * blocks at or past the length are never read.
// Bound on this card: bytes (a gather with a length-D dot), which the one
// block per query head on the long row cannot reach: its pace is one SM's.
#include "paged_decode_bulk.cuh"

namespace {

constexpr size_t RING_BUDGET = 128 * 1024;  // 8 f32 blocks of 16 x 128

}  // namespace

// Plain C entry point (loaded with ctypes). q_dtype: SMX_F32 | SMX_BF16;
// kv_dtype: SMX_F32 | SMX_BF16 | SMX_I8 (int8 needs both scale pools);
// tables (B, W) int32, read only below each row's live blocks. Returns
// cudaGetLastError() after the launch.
extern "C" int smx_paged_decode_single_bulk(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* tables,
    const void* lengths, void* out, int B, int Hq, int Hkv, int D, int BS,
    int W, int q_dtype, int kv_dtype, int intmax, void* stream) {
  if (B < 0 || !pdb_operands_ok(k_pool, v_pool, k_scale, v_scale, Hq, Hkv,
                                D, BS, W, q_dtype, kv_dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B * Hq == 0) return static_cast<int>(cudaSuccess);
  const PdbGeom g = pdb_geom(1, D, BS, pdb_elem(kv_dtype), 1, 1, RING_BUDGET);
  if (g.smem > PDB_SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
  PdbArgs a = {};
  a.q = q;
  a.k_pool = k_pool;
  a.v_pool = v_pool;
  a.k_scale = static_cast<const float*>(k_scale);
  a.v_scale = static_cast<const float*>(v_scale);
  a.tables = static_cast<const int*>(tables);
  a.lengths = static_cast<const int*>(lengths);
  a.out = out;
  a.q_bf16 = q_dtype == SMX_BF16;
  a.Hblk = Hq;
  a.Hkv = Hkv;
  a.group = Hq / Hkv;
  a.BS = BS;
  a.D = D;
  a.W = W;
  a.T = 1;
  a.nstage = g.nstage;
  a.n_lanes = 1;
  a.intmax = intmax;
  a.stage_bytes = g.stage_bytes;
  return static_cast<int>(pdb_launch_kv<1>(
      kv_dtype, a, dim3(B * Hq, 1), g.smem,
      static_cast<cudaStream_t>(stream)));
}
