// Paged single-token GQA decode attention with Softermax: the bulk-copy
// route (Hopper, sm_90a).
//
// Replaces the Pallas TPU kernel flash_decode_paged
// (src/repro/kernels/flash_decode_paged/flash_decode_paged.py:150, body
// _paged_decode_kernel) wherever the pool's (block, KV head) spans are
// multiples of 16 bytes at 16-byte-aligned pools and scales, D is a
// multiple of 8 up to 256 and the GQA group is at most 8
// (kernels/flash_decode_paged/ops.py::bulk_route); every other geometry
// keeps flash_decode_paged.cu. The function is the same: one pre-scaled
// query token per (sequence, query head) against the sequence's first
// lengths[b] cached rows, read through its block table from an f32, bf16
// or int8 pool (int8 with per-row f32 scales); fp32 math, output in q's
// dtype.
//
// Bound on this card: bytes. Each live KV row is read once and used for G
// dot products and G rows of A·V (at most 4 FMA per byte at G 8), far under
// the compute/bandwidth ridge: no tensor cores. What the design does about
// it (the walk is paged_decode_bulk.cuh's, shared with K8's route):
//  * one block per (sequence, KV head, split lane) holds the whole GQA
//    group, so each live row crosses the bus once;
//  * each pool block of the lane is one 1-D bulk copy of K, one of V (and
//    for int8 one of each scale row) into a 64 KB ring of stages of T pool
//    blocks (kv_tile_blocks, clamped so four stages fit), issued by one
//    producer warp that keeps the ring full, three blocks an SM;
//  * lanes split the row's LIVE blocks, not the padded table: n lanes a
//    (sequence, KV head) pair, chosen by the wrapper from shapes only
//    (kernels/flash_decode_paged/ops.py::live_lanes, sized by this
//    kernel's occupancy, smx_paged_decode_bulk_resident below), each an
//    equal share of whole blocks computed on the device from lengths[b],
//    so a long row spreads over the card and no table entry past the
//    row's blocks is read;
//  * one launch: the lanes merge in it (the ticket scheme of K5), so the
//    wrapper allocates nothing but the output.
// kv_tile_blocks and split_k remain layout knobs: every setting computes
// the same attention.
#include "paged_decode_bulk.cuh"

namespace {

constexpr size_t RING_BUDGET = 64 * 1024;   // three blocks an SM
constexpr int GMAX = 8;

}  // namespace

// Blocks of the route the current device holds at once at this geometry
// (the compiled kernel's occupancy at the ring's shared memory times the SM
// count): 0 if the geometry is off the route or its ring does not fit, a
// negated cudaError_t if the query fails. The wrapper sizes its lanes by it.
extern "C" int smx_paged_decode_bulk_resident(int G, int D, int BS,
                                              int kv_dtype, int T) {
  const int elem = pdb_elem(kv_dtype);
  if (elem == 0 || G < 1 || G > GMAX || D <= 0 || BS <= 0) return 0;
  const PdbGeom g = pdb_geom(G, D, BS, elem, T, 1, RING_BUDGET);
  if (g.smem > PDB_SMEM_MAX) return 0;
  int blocks = 0;
  const cudaError_t err = pdb_by_group(G, [&](auto gb) {
    return pdb_resident_kv<decltype(gb)::value>(kv_dtype, g.smem, &blocks);
  });
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

// Plain C entry point (loaded with ctypes). q_dtype: SMX_F32 | SMX_BF16;
// kv_dtype: SMX_F32 | SMX_BF16 | SMX_I8 (int8 needs both scale pools).
// tables (B, W) int32, read only below each row's live blocks; acc/m/d
// hold the n_lanes lanes' states (n_lanes > 1), tickets (B*Hkv ints) must
// be 0 and are 0 again after the launch. Returns cudaGetLastError() after
// the launch.
extern "C" int smx_paged_decode_bulk(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* tables,
    const void* lengths, void* acc_part, void* m_part, void* d_part,
    void* tickets, void* out, int B, int Hq, int Hkv, int D, int BS, int W,
    int T, int n_lanes, int q_dtype, int kv_dtype, int intmax,
    void* stream) {
  if (B < 0 || n_lanes < 1 || n_lanes > PDB_MAX_LANES ||
      !pdb_operands_ok(k_pool, v_pool, k_scale, v_scale, Hq, Hkv, D, BS, W,
                       q_dtype, kv_dtype) ||
      Hq / Hkv > GMAX || (n_lanes > 1 && tickets == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return static_cast<int>(cudaSuccess);
  const int G = Hq / Hkv;
  const PdbGeom g =
      pdb_geom(G, D, BS, pdb_elem(kv_dtype), T, n_lanes, RING_BUDGET);
  if (g.smem > PDB_SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
  PdbArgs a;
  a.q = q;
  a.k_pool = k_pool;
  a.v_pool = v_pool;
  a.k_scale = static_cast<const float*>(k_scale);
  a.v_scale = static_cast<const float*>(v_scale);
  a.tables = static_cast<const int*>(tables);
  a.lengths = static_cast<const int*>(lengths);
  a.acc_part = static_cast<float*>(acc_part);
  a.m_part = static_cast<float*>(m_part);
  a.d_part = static_cast<float*>(d_part);
  a.tickets = static_cast<int*>(tickets);
  a.out = out;
  a.q_bf16 = q_dtype == SMX_BF16;
  a.Hblk = Hkv;
  a.Hkv = Hkv;
  a.group = G;
  a.BS = BS;
  a.D = D;
  a.W = W;
  a.T = g.T;
  a.nstage = g.nstage;
  a.n_lanes = n_lanes;
  a.intmax = intmax;
  a.stage_bytes = g.stage_bytes;
  const dim3 grid(B * Hkv, n_lanes);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = pdb_by_group(G, [&](auto gb) {
    return pdb_launch_kv<decltype(gb)::value>(kv_dtype, a, grid, g.smem, st);
  });
  return static_cast<int>(err);
}
