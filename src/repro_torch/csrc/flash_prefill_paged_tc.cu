// Paged chunked-prefill GQA attention with Softermax on Hopper's tensor
// cores (sm_90a): the bf16 route of K2.
//
// Replaces the Pallas TPU kernel flash_prefill_paged
// (src/repro/kernels/flash_prefill_paged/flash_prefill_paged.py:136, body
// _paged_prefill_kernel) for bf16 q with a bf16 pool, a head dim D that is
// a multiple of 16 up to 128 and a block size BS that is a multiple of 8
// and divides 64; flash_prefill_paged.cu keeps f32 q or pools, int8 pools
// and every other D or BS. Same function as flash_prefill_paged.cu: chunk
// queries at absolute positions pos0 + i attend the rows the block table
// names under the positional mask kj <= pos0 + i; running IntMax
// m_new = max(m_prev, ceil(rowmax(s))), alpha = 2^(m_prev - m_new) by
// smx_rescale, the finite NEG_INF, d == 0 -> 0; the output in bf16.
//
// Bound on this card: operations (every staged KV tile serves the 64 query
// rows of a block). The parity contract of the dense tensor-core forward
// holds unchanged: bf16 products exact in f32, p into the tensor cores as
// three bf16 terms whose sum is p exactly, a fresh accumulator per tile,
// d summed from the f32 p before the split (softermax_tile.cuh, which both
// kernels run per tile).
//
// Layout: grid (B*Hq, ceil(Sq/64)), the chunk's last query tiles (which see
// the most keys) first; one block takes 64 query positions of ONE query
// head (a GQA group's G heads read the same pool rows from L2): 96 blocks
// for a 256-token chunk of llama3.2-3b. Warps 0-7 are two consumer
// warpgroups that split the block's key walk: warpgroup w takes KV tiles
// w, w + 2, ... for the same 64 rows, and the second's (m, d, o) merges
// into the first's at the end, exactly (each state rescaled by a power of
// two). A row whose first odd tile masks it in full holds a finite state
// with max NEG_INF until a live key or the merge rescales it by exactly 0
// (softermax_tile.cuh). Both warpgroups' softmax steps and products
// interleave on the SM, faster than one consumer (PERF.md). Warps 8-11
// are the producer warpgroup, which gives its registers to the
// consumers (setmaxnreg); one lane loads the block's slice of the table
// into shared memory, the Q tile once by TMA from a 3-D map over
// (B*Hq, Sq, D) (rows past Sq zero-filled, never stored), then gathers
// 64-row KV tiles through the table into a ring of 4 stages (2 per
// consumer, so each stage has one consumer) on full / empty mbarriers: the
// next tiles' gathers are in flight while the current ones are multiplied.
// A 4-D map over one layer's pool (N, Hkv, BS, D) takes one box of 64
// columns x BS rows per pool block, landing at row j*BS of the stage's
// panels (BS a multiple of 8 keeps the 8-row atom of the 128-byte
// swizzle). Blocks past the padded table (Wp) are not copied: their
// coordinate is past the pool, so TMA delivers zeros, and their rows are
// masked. The consumers mask only tiles that cross the diagonal or the end
// of the table; tiles wholly above the block's diagonal are never
// gathered.
#include "common.cuh"
#include "hopper.cuh"
#include "softermax_tile.cuh"

namespace {

constexpr int BM = 64;                    // query rows per block
constexpr int BN = 64;                    // KV rows per tile
constexpr int CONS = 2;                   // consumer warpgroups
constexpr int STAGES = 2 * CONS;
constexpr int THREADS = 128 * (CONS + 1); // + the producer warpgroup
// registers per thread: the producer's give the consumers 232 each
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;

// Shared-memory layout (byte offsets from the 1024-aligned base) for the
// padded head dim DP: Q panels, STAGES x (K panels, V panels), the merge
// scratch, the barriers, then the block's slice of the table. Tile `it`
// sits in stage it % STAGES and goes to consumer it % CONS; STAGES is a
// multiple of CONS, so every stage has one consumer, whose waits see each
// of its phases in order (a consumer that skipped phases could wait on a
// parity the barrier has already passed twice).
template <int DP>
struct PrefillSmem {
  static constexpr int PANELS = DP / 64;
  static constexpr int PANEL_Q = BM * 128;
  static constexpr int PANEL_KV = BN * 128;
  static constexpr int Q = 0;
  static constexpr int KV = PANELS * PANEL_Q;
  static constexpr int STAGE = 2 * PANELS * PANEL_KV;
  // o, m, d (f32) of each thread of the second consumer warpgroup
  static constexpr int MERGE = KV + STAGES * STAGE;
  static constexpr int BAR = MERGE + 128 * (DP / 2 + 4) * 4;
  static constexpr int TABLE = BAR + 8 * (1 + 2 * STAGES);
  static size_t bytes(int Wp) {
    return TABLE + sizeof(int) * static_cast<size_t>(Wp) + 1024;
  }
};

template <int DP>
__global__ void __launch_bounds__(THREADS, 1) paged_prefill_tc_kernel(
    const __grid_constant__ CUtensorMap q_map,    // (B*Hq, Sq, D)
    const __grid_constant__ CUtensorMap k_map,    // (N, Hkv, BS, D)
    const __grid_constant__ CUtensorMap v_map,
    const int* __restrict__ tables,                // (B, Wp)
    const int* __restrict__ q_pos0,                // (B,)
    __nv_bfloat16* __restrict__ out,               // (B*Hq, Sq, D)
    int Hq, int G, int Sq, int D, int BS, int Wp, int N, int intmax) {
  using L = PrefillSmem<DP>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hop_align1024(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::BAR);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + STAGES;
  int* tbl_s = reinterpret_cast<int*>(smem + L::TABLE);

  const int head = blockIdx.x;                   // b * Hq + query head
  const int b = head / Hq;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;
  const int pos0 = q_pos0[b];
  const int n_pos = Wp * BS;
  const int k_end = min(n_pos, pos0 + min(Sq, q0 + BM));
  const int n_tiles = (k_end + BN - 1) / BN;
  const int per_tile = BN / BS;                  // pool blocks per tile
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  for (int t = threadIdx.x; t < min(Wp, n_tiles * per_tile); t += THREADS)
    tbl_s[t] = tables[static_cast<size_t>(b) * Wp + t];
  if (threadIdx.x == 0) {
    hop_mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      hop_mbar_init(&full[s], 1);
      hop_mbar_init(&empty[s], 4);               // lane 0 of each warp
    }
    hop_mbar_init_fence();
  }
  __syncthreads();

  if (warp >= 4 * CONS) {                        // the producer
    hop_regs_dec<PRODUCER_REGS>();
    if (warp == 4 * CONS && lane == 0) {
      const int kvh = (head % Hq) / G;
      hop_mbar_expect_tx(q_full, L::PANELS * L::PANEL_Q);
      for (int p = 0; p < L::PANELS; ++p)
        hop_tma_load(smem + L::Q + p * L::PANEL_Q, &q_map, q_full, 64 * p,
                     q0, head);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % STAGES;
        if (it >= STAGES) hop_mbar_wait(&empty[s], (it / STAGES - 1) & 1);
        uint8_t* st = smem + L::KV + s * L::STAGE;
        hop_mbar_expect_tx(&full[s], L::STAGE);
        for (int j = 0; j < per_tile; ++j) {
          const int blk = it * per_tile + j;
          const int id = blk < Wp ? tbl_s[blk] : N;   // past the table
          for (int p = 0; p < L::PANELS; ++p) {
            uint8_t* dst = st + p * L::PANEL_KV + j * BS * 128;
            hop_tma_load_4d(dst, &k_map, &full[s], 64 * p, 0, kvh, id);
            hop_tma_load_4d(dst + L::PANELS * L::PANEL_KV, &v_map, &full[s],
                            64 * p, 0, kvh, id);
          }
        }
      }
    }
    return;
  }

  // consumer warpgroup wg: chunk rows q0 .. q0 + 63, KV tiles wg, wg +
  // CONS, ...; this thread's rows are row0 and row0 + 8, at absolute
  // positions pos0 + row
  hop_regs_inc<CONSUMER_REGS>();
  const int wg = warp / 4;
  const int row0 = q0 + (warp % 4) * 16 + lane / 4;
  const int col0 = 2 * (lane % 4);
  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
  float m_r[2] = {SMX_NEG_INF, SMX_NEG_INF};
  float d_r[2] = {0.f, 0.f};

  hop_mbar_wait(q_full, 0);
  for (int it = wg; it < n_tiles; it += CONS) {
    const int s = it % STAGES;
    const int k0 = it * BN;
    hop_mbar_wait(&full[s], (it / STAGES) & 1);
    const uint8_t* k_s = smem + L::KV + s * L::STAGE;
    // the positional mask and the end of the table, where the tile
    // crosses them
    const bool edge = k0 + BN > n_pos || k0 + BN - 1 > pos0 + q0;
    hop_softermax_tile<DP>(
        smem + L::Q, L::PANEL_Q, k_s, k_s + L::PANELS * L::PANEL_KV,
        L::PANEL_KV, edge,
        [&](int h, int c) {
          const int col = k0 + c;
          return col >= n_pos || col > pos0 + row0 + 8 * h;
        },
        o, m_r, d_r, intmax);
    __syncwarp();
    if (lane == 0) hop_mbar_arrive(&empty[s]);
  }

  // the second consumer's state merges into the first's: m = max, each
  // state rescaled by 2^(m_w - m) (smx_rescale: exact under IntMax; a
  // state whose max is still NEG_INF drops out). Scratch strided by the
  // 128 threads of a warpgroup.
  float* scratch =
      reinterpret_cast<float*>(smem + L::MERGE) + threadIdx.x % 128;
  if (wg == 1) {
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) scratch[i * 128] = o[i];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      scratch[(DP / 2 + h) * 128] = m_r[h];
      scratch[(DP / 2 + 2 + h) * 128] = d_r[h];
    }
  }
  asm volatile("bar.sync 1, %0;" :: "n"(128 * CONS) : "memory");
  if (wg == 1) return;
  float f[2], g[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float mo = scratch[(DP / 2 + h) * 128];
    const float m = fmaxf(m_r[h], mo);
    f[h] = smx_rescale(m_r[h] - m, intmax);
    g[h] = smx_rescale(mo - m, intmax);
    d_r[h] = d_r[h] * f[h] + scratch[(DP / 2 + 2 + h) * 128] * g[h];
    m_r[h] = m;
  }
#pragma unroll
  for (int i = 0; i < DP / 2; ++i)
    o[i] = o[i] * f[(i >> 1) & 1] + scratch[i * 128] * g[(i >> 1) & 1];

  // o = acc / d (d == 0 -> 0), bf16 pairs
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    if (row >= Sq) continue;
    const size_t r = static_cast<size_t>(head) * Sq + row;
    const float recip = d_r[h] > 0.f ? 1.f / d_r[h] : 0.f;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = 8 * j + col0;
      if (col < D)
        *reinterpret_cast<__nv_bfloat162*>(out + r * D + col) =
            __floats2bfloat162_rn(o[4 * j + 2 * h] * recip,
                                  o[4 * j + 2 * h + 1] * recip);
    }
  }
}

template <int DP>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const void* tables, const void* q_pos0, void* out, int B,
                   int Hq, int Hkv, int Sq, int D, int BS, int Wp, int N,
                   int intmax, cudaStream_t stream) {
  using L = PrefillSmem<DP>;
  CUtensorMap q_map, k_map, v_map;
  cudaError_t err = hop_map_rows(&q_map, q, B * Hq, Sq, D, BM);
  if (err == cudaSuccess) err = hop_map_pool(&k_map, k_pool, N, Hkv, BS, D);
  if (err == cudaSuccess) err = hop_map_pool(&v_map, v_pool, N, Hkv, BS, D);
  if (err != cudaSuccess) return err;
  auto kern = paged_prefill_tc_kernel<DP>;
  const size_t smem = L::bytes(Wp);
  err = smx_smem_limit(kern, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(B * Hq, (Sq + BM - 1) / BM);
  kern<<<grid, THREADS, smem, stream>>>(
      q_map, k_map, v_map, static_cast<const int*>(tables),
      static_cast<const int*>(q_pos0), static_cast<__nv_bfloat16*>(out), Hq,
      Hq / Hkv, Sq, D, BS, Wp, N, intmax);
  return cudaGetLastError();
}

}  // namespace

// Dynamic shared memory one launch needs, for the wrapper's checks.
extern "C" long long smx_paged_prefill_tc_smem(int D, int Wp) {
  return static_cast<long long>(D <= 64 ? PrefillSmem<64>::bytes(Wp)
                                        : PrefillSmem<128>::bytes(Wp));
}

// Plain C entry point (loaded with ctypes). q (B, Hq, Sq, D), pools
// (N, Hkv, BS, D) and out bf16, contiguous, 16-byte aligned; tables (B, Wp)
// and q_pos0 (B,) int32. D a multiple of 16 up to 128; BS a multiple of 8
// that divides 64. Returns cudaGetLastError() after the launch.
extern "C" int smx_paged_prefill_tc(const void* q, const void* k_pool,
                                    const void* v_pool, const void* tables,
                                    const void* q_pos0, void* out, int B,
                                    int Hq, int Hkv, int Sq, int D, int BS,
                                    int Wp, int N, int intmax, void* stream) {
  if (B <= 0 || Sq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Wp <= 0 || N <= 0 ||
      D <= 0 || D % 16 != 0 || D > 128 || BS <= 0 || BS % 8 != 0 ||
      BN % BS != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 64)
    return static_cast<int>(launch<64>(q, k_pool, v_pool, tables, q_pos0, out,
                                       B, Hq, Hkv, Sq, D, BS, Wp, N, intmax,
                                       st));
  return static_cast<int>(launch<128>(q, k_pool, v_pool, tables, q_pos0, out,
                                      B, Hq, Hkv, Sq, D, BS, Wp, N, intmax,
                                      st));
}
