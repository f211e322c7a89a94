// Dense GQA flash-attention forward with Softermax on Hopper's tensor cores
// (sm_90a): the bf16 route of K3.
//
// Replaces the Pallas TPU kernel flash_attention
// (src/repro/kernels/flash_attention/flash_attention.py:99, body
// _flash_kernel) for bf16 q, k, v with a head dim D that is a multiple of
// 16, up to 128; flash_attention.cu keeps f32 and every other D. Same
// function as flash_attention.cu: base-2 exponent, running IntMax
// m_new = max(m_prev, ceil(rowmax(s))), alpha = 2^(m_prev - m_new) by
// smx_rescale, the finite NEG_INF, causal kj <= qi + Sk - Sq (non-causal
// kj < Sk), d == 0 -> 0; o in bf16 and the fp32 row statistics (m, d).
//
// Bound on this card: operations (at training shapes every staged KV tile
// serves 128 query rows). The reference keeps s, p and acc in f32:
//   s = q·k^T  products of bf16 values are exact in f32, so a bf16 wgmma
//              with f32 accumulation computes the reference's s up to the
//              order of the sums.
//   p·V        p is f32. It enters the tensor cores as three bf16 terms
//              p = p_hi + p_mid + p_lo, exact (hop_split3), three wgmmas on
//              the same V tile, so every product is exact. p rounded once
//              to bf16 would lose up to 2^-8 |p|; the pair p_hi + p_lo
//              still 2^-16 |p|, which failed the bf16 parity gate in the
//              backward, where a row's few products cancel. 8·D
//              tensor-core FLOPs per visible (query, key) pair against
//              the 4·D of the function.
//   d          summed from the f32 p, before the split.
//
// Layout: grid (B*Hq, ceil(Sq/128)), the longest query tiles first; one
// block takes 128 query rows of ONE query head (a GQA group's G heads read
// the same KV tiles from L2; stacking them would make G*rows a multiple of
// 64 only for some G). Warps 0-7 are two consumer warpgroups of 64 rows
// each, the wgmma M; warps 8-11 are the producer warpgroup, which gives
// its registers to the consumers (setmaxnreg); one lane loads the Q tile
// once and then 64-row K/V tiles by TMA into a ring of two stages (full /
// empty mbarriers), so the next tile is in flight while the current one is
// multiplied. TMA zero-fills rows past Sk or Sq and columns past D (D
// 16-64 run the 64-column instance, D 80-128 the 128-column one); masked
// and padded columns get NEG_INF scores, so they add p = 0. Per KV tile a
// warpgroup runs hop_softermax_tile (softermax_tile.cuh, shared with K2's
// tensor-core route): S = Q·K^T (wgmma m64n64k16, both operands K-major in
// shared memory), masks only tiles that cross the diagonal or the end of
// the keys, takes the IntMax and the row sums on the accumulator fragment
// (each row lives in one quad of lanes), and computes p·V from p's three
// bf16 terms (register-A wgmma m64nDk16, V MN-major through the transpose
// bit) into a fresh accumulator that is added to the rescaled O on the CUDA
// cores (the tensor cores' f32 sums are coarser than round-to-nearest, so a
// row's whole walk in one accumulator drifts). KV tile 0 comes first, so no
// row meets a fully masked tile while its max is NEG_INF; tiles wholly
// above a warpgroup's diagonal are skipped.
#include "common.cuh"
#include "hopper.cuh"
#include "softermax_tile.cuh"

namespace {

constexpr int CONSUMERS = 2;              // consumer warpgroups
constexpr int BM = 64 * CONSUMERS;        // query rows per block
constexpr int BN = 64;                    // KV rows per tile
constexpr int STAGES = 2;
constexpr int THREADS = CONSUMERS * 128 + 128;   // + the producer warpgroup
// registers per thread: the producer's give the consumers 232 each
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;

// Shared-memory layout (byte offsets from the 1024-aligned base) for the
// padded head dim DP: Q panels, then STAGES x (K panels, V panels), then
// the barriers.
template <int DP>
struct FwdSmem {
  static constexpr int PANELS = DP / 64;
  static constexpr int PANEL_Q = BM * 128;
  static constexpr int PANEL_KV = BN * 128;
  static constexpr int Q = 0;
  static constexpr int KV = PANELS * PANEL_Q;
  static constexpr int STAGE = 2 * PANELS * PANEL_KV;
  static constexpr int BAR = KV + STAGES * STAGE;
  static constexpr int BYTES = BAR + 8 * (1 + 2 * STAGES) + 1024;
};

template <int DP>
__global__ void __launch_bounds__(THREADS, 1) flash_fwd_tc_kernel(
    const __grid_constant__ CUtensorMap q_map,    // (B*Hq, Sq, D)
    const __grid_constant__ CUtensorMap k_map,    // (B*Hkv, Sk, D)
    const __grid_constant__ CUtensorMap v_map,
    __nv_bfloat16* __restrict__ out,               // (B*Hq, Sq, D)
    float* __restrict__ m_out,                     // (B*Hq, Sq)
    float* __restrict__ d_out, int G, int Sq, int Sk, int D, int causal,
    int intmax) {
  using L = FwdSmem<DP>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hop_align1024(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::BAR);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + STAGES;

  const int head = blockIdx.x;                   // b * Hq + query head
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;
  const int q_offset = Sk - Sq;
  const int q_last = min(Sq, q0 + BM) - 1;
  const int k_end = causal ? min(Sk, q_last + q_offset + 1) : Sk;
  const int n_tiles = (k_end + BN - 1) / BN;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    hop_mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      hop_mbar_init(&full[s], 1);
      hop_mbar_init(&empty[s], CONSUMERS * 4);   // lane 0 of each warp
    }
    hop_mbar_init_fence();
  }
  __syncthreads();

  if (warp >= CONSUMERS * 4) {                   // the producer warpgroup
    hop_regs_dec<PRODUCER_REGS>();
    if (warp == CONSUMERS * 4 && lane == 0) {
      hop_mbar_expect_tx(q_full, L::PANELS * L::PANEL_Q);
      for (int p = 0; p < L::PANELS; ++p)
        hop_tma_load(smem + L::Q + p * L::PANEL_Q, &q_map, q_full, 64 * p,
                     q0, head);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % STAGES;
        if (it >= STAGES) hop_mbar_wait(&empty[s], (it / STAGES - 1) & 1);
        uint8_t* st = smem + L::KV + s * L::STAGE;
        hop_mbar_expect_tx(&full[s], L::STAGE);
        for (int p = 0; p < L::PANELS; ++p) {
          hop_tma_load(st + p * L::PANEL_KV, &k_map, &full[s], 64 * p,
                       it * BN, head / G);
          hop_tma_load(st + (L::PANELS + p) * L::PANEL_KV, &v_map, &full[s],
                       64 * p, it * BN, head / G);
        }
      }
    }
    return;
  }

  // consumer warpgroup wg: query rows q0 + 64 wg .. + 63; this thread's
  // rows are row0 (fragment entries 4j, 4j+1) and row0 + 8 (4j+2, 4j+3)
  hop_regs_inc<CONSUMER_REGS>();
  const int wg = warp / 4;
  const int wg_q0 = q0 + 64 * wg;
  const int row0 = wg_q0 + (warp % 4) * 16 + lane / 4;
  const int col0 = 2 * (lane % 4);
  // the KV columns this warpgroup's real rows can see
  const int wg_last = min(Sq, wg_q0 + 64) - 1;
  const int wg_k_end = wg_last < wg_q0 ? 0
                       : causal ? min(Sk, wg_last + q_offset + 1) : Sk;
  const uint8_t* q_s = smem + L::Q + wg * 64 * 128;

  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
  float m_r[2] = {SMX_NEG_INF, SMX_NEG_INF};
  float d_r[2] = {0.f, 0.f};

  hop_mbar_wait(q_full, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % STAGES;
    const int k0 = it * BN;
    hop_mbar_wait(&full[s], (it / STAGES) & 1);
    if (k0 < wg_k_end) {
      const uint8_t* k_s = smem + L::KV + s * L::STAGE;
      // the causal mask and the end of the keys, where the tile crosses them
      const bool edge =
          k0 + BN > Sk || (causal && k0 + BN - 1 > wg_q0 + q_offset);
      hop_softermax_tile<DP>(
          q_s, L::PANEL_Q, k_s, k_s + L::PANELS * L::PANEL_KV, L::PANEL_KV,
          edge,
          [&](int h, int c) {
            const int col = k0 + c;
            return col >= Sk || (causal && col > row0 + 8 * h + q_offset);
          },
          o, m_r, d_r, intmax);
    }
    __syncwarp();
    if (lane == 0) hop_mbar_arrive(&empty[s]);
  }

  // o = acc / d (d == 0 -> 0), bf16 pairs; (m, d) from lane 0 of each quad
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
    if (lane % 4 == 0) {
      m_out[r] = m_r[h];
      d_out[r] = d_r[h];
    }
  }
}

template <int DP>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   void* m, void* d, int B, int Hq, int Hkv, int Sq, int Sk,
                   int D, int causal, int intmax, cudaStream_t stream) {
  CUtensorMap q_map, k_map, v_map;
  cudaError_t err = hop_map_rows(&q_map, q, B * Hq, Sq, D, BM);
  if (err == cudaSuccess) err = hop_map_rows(&k_map, k, B * Hkv, Sk, D, BN);
  if (err == cudaSuccess) err = hop_map_rows(&v_map, v, B * Hkv, Sk, D, BN);
  if (err != cudaSuccess) return err;
  auto kern = flash_fwd_tc_kernel<DP>;
  err = smx_smem_limit(kern, FwdSmem<DP>::BYTES);
  if (err != cudaSuccess) return err;
  dim3 grid(B * Hq, (Sq + BM - 1) / BM);
  kern<<<grid, THREADS, FwdSmem<DP>::BYTES, stream>>>(
      q_map, k_map, v_map, static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(m), static_cast<float*>(d), Hq / Hkv, Sq, Sk, D,
      causal, intmax);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes). q, k, v and out bf16,
// contiguous, 16-byte aligned; m and d fp32 (B, Hq, Sq). D a multiple of 16
// up to 128; causal needs Sk >= Sq. Returns cudaGetLastError() after the
// launch.
extern "C" int smx_flash_fwd_tc(const void* q, const void* k, const void* v,
                                void* out, void* m, void* d, int B, int Hq,
                                int Hkv, int Sq, int Sk, int D, int causal,
                                int intmax, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || Hkv <= 0 || Hq % Hkv != 0 ||
      D <= 0 || D % 16 != 0 || D > 128 || (causal && Sk < Sq))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 64)
    return static_cast<int>(launch<64>(q, k, v, out, m, d, B, Hq, Hkv, Sq,
                                       Sk, D, causal, intmax, st));
  return static_cast<int>(launch<128>(q, k, v, out, m, d, B, Hq, Hkv, Sq, Sk,
                                      D, causal, intmax, st));
}
