// Paged chunked-prefill GQA attention with Softermax (Hopper, sm_90a).
//
// Replaces the Pallas TPU kernel flash_prefill_paged
// (src/repro/kernels/flash_prefill_paged/flash_prefill_paged.py:136,
// body _paged_prefill_kernel). Same function: a chunk of queries at
// absolute positions pos0 .. pos0+Sq-1 attends the KV that the block table
// names (cached prefix, earlier chunks and the chunk's own rows) under the
// positional causal mask kj <= qi, with the Softermax online state carried
// across KV tiles; tiles wholly above the diagonal of a query tile are
// skipped.
//
// Bound on this card: operations. Each gathered KV tile is reused by all
// G*BQ query rows of a block, so arithmetic intensity grows with the query
// tile and is far above the bandwidth ridge at main-path shapes. This
// kernel is the parity route (kernels/flash_prefill_paged/ops.py::tc_route):
// f32 q or pools, int8 pools and every D or BS off the tensor-core route.
// bf16 q with a bf16 pool takes flash_prefill_paged_tc.cu, which keeps the
// f32 p exact on the tensor cores as three bf16 terms (hop_split3). This
// one keeps everything in fp32 on the CUDA cores and spends its design on
// feeding them: a block stages its (G*BQ, D) query tile once and then
// 64-row KV tiles (16-byte loads, all in flight) in shared memory, row
// strides padded by one float so the column-wise reads hit distinct banks;
// each thread computes a 4 x 4 block of scores and an 8 x 4 block of the
// accumulator held in registers, so every shared-memory read feeds several
// multiply-adds; tiles wholly above the diagonal are skipped. The KV tile
// size is internal: T (kv_tile_blocks) is a layout knob that computes the
// same attention and shapes nothing here.
//
// Grid (B*Hkv, ceil(Sq/BQ)); one block owns the G*BQ <= 64 query rows
// (head g, position i) -> row g*BQ + i of one KV head. Per KV tile:
// s = q·K (times k_scale for int8), mask kj <= qi, m_new = max(m_prev,
// ceil(rowmax)), alpha = 2^(m_prev - m_new) (exact under IntMax),
// p = 2^(s - m_new), d = d*alpha + sum(p), acc = acc*alpha +
// (p*v_scale)·V. Finish: acc / d with d == 0 -> 0, cast to q's dtype.
// Query rows past Sq are computed as zeros and never stored.
#include "common.cuh"

namespace {

constexpr int PF_THREADS = 256;
constexpr int KV_ROWS = 64;        // KV rows per tile
constexpr int R_MAX = 64;          // query rows (G*BQ) per block
constexpr int D_MAX = 128;         // head dim the register tiles cover

__host__ __device__ inline size_t prefill_smem_floats(int R, int D) {
  return static_cast<size_t>(R) * (D + 1) +          // q tile
         static_cast<size_t>(KV_ROWS) * (D + 1) +    // K tile
         static_cast<size_t>(KV_ROWS) * D +          // V tile
         static_cast<size_t>(R) * (KV_ROWS + 1) +    // scores / p
         2 * KV_ROWS + 3 * R;                        // scales, m, d, alpha
}

template <typename QT, typename KT>
__global__ void __launch_bounds__(PF_THREADS) paged_prefill_kernel(
    const QT* __restrict__ q,          // (B, Hkv, G, Sq, D)
    const KT* __restrict__ k_pool,     // (N, Hkv, BS, D)
    const KT* __restrict__ v_pool,
    const float* __restrict__ k_scale, // (N, Hkv, BS) or null
    const float* __restrict__ v_scale,
    const int* __restrict__ tables,    // (B, Wp), padded with block 0
    const int* __restrict__ q_pos0,    // (B,)
    QT* __restrict__ out,              // (B, Hkv, G, Sq, D)
    int Hkv, int G, int Sq, int D, int BS, int Wp, int BQ, int intmax) {
  extern __shared__ float smem[];
  const int R = G * BQ, DP = D + 1, SP = KV_ROWS + 1;
  float* q_s = smem;                        // R x DP
  float* k_s = q_s + R * DP;                // KV_ROWS x DP
  float* v_s = k_s + KV_ROWS * DP;          // KV_ROWS x D
  float* p_s = v_s + KV_ROWS * D;           // R x SP
  float* ksc_s = p_s + R * SP;              // KV_ROWS
  float* vsc_s = ksc_s + KV_ROWS;           // KV_ROWS
  float* m_s = vsc_s + KV_ROWS;             // R
  float* d_s = m_s + R;                     // R
  float* alpha_s = d_s + R;                 // R
  int* tbl_s = reinterpret_cast<int*>(alpha_s + R);   // Wp

  const int bh = blockIdx.x;
  const int qt = blockIdx.y;
  const int b = bh / Hkv;
  const int h = bh % Hkv;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const bool quant = k_scale != nullptr;
  const int q_start = q_pos0[b] + qt * BQ;  // absolute position of row i=0

  for (int idx = tid; idx < R * D; idx += blockDim.x) {
    const int row = idx / D, d = idx % D;
    const int g = row / BQ, qi = qt * BQ + row % BQ;
    q_s[row * DP + d] =
        qi < Sq ? smx_to_f32(
                      q[((static_cast<size_t>(bh) * G + g) * Sq + qi) * D + d])
                : 0.f;
  }
  for (int row = tid; row < R; row += blockDim.x) {
    m_s[row] = SMX_NEG_INF;
    d_s[row] = 0.f;
  }
  for (int t = tid; t < Wp; t += blockDim.x)
    tbl_s[t] = tables[static_cast<size_t>(b) * Wp + t];
  __syncthreads();

  // score tile of a thread: rows sr + 16 i, columns sc + 16 j
  const int sc = tid & 15, sr = tid >> 4;
  // accumulator tile of a thread: rows warp + 8 i, columns lane + 32 k
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[i][k] = 0.f;

  const int n_pos = Wp * BS;
  for (int k_start = 0; k_start < n_pos && k_start <= q_start + BQ - 1;
       k_start += KV_ROWS) {
    // tiles run in order from 0 and tile 0 always runs, so every row's
    // running max is finite before a fully masked row can appear
    const int rows = min(KV_ROWS, n_pos - k_start);
    smx_stage_kv(k_pool, v_pool, tbl_s, k_start, rows, Hkv, h, BS, D, k_s,
                 DP, v_s, D);
    for (int r = tid; r < rows; r += blockDim.x) {
      const int p = k_start + r;
      const size_t row =
          (static_cast<size_t>(tbl_s[p / BS]) * Hkv + h) * BS + p % BS;
      ksc_s[r] = quant ? k_scale[row] : 1.f;
      vsc_s[r] = quant ? v_scale[row] : 1.f;
    }
    __syncthreads();

    // scores with the positional causal mask
    {
      float s[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
      for (int d = 0; d < D; ++d) {
        float qv[4], kv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = sr + 16 * i;
          qv[i] = row < R ? q_s[row * DP + d] : 0.f;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) kv[j] = k_s[(sc + 16 * j) * DP + d];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] += qv[i] * kv[j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = sr + 16 * i;
        if (row >= R) continue;
        const int qi = q_start + row % BQ;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = sc + 16 * j;
          if (c >= rows) continue;
          const float v = quant ? s[i][j] * ksc_s[c] : s[i][j];
          p_s[row * SP + c] = (k_start + c <= qi) ? v : SMX_NEG_INF;
        }
      }
    }
    __syncthreads();

    // per row (one warp each, two columns per lane): IntMax, rescale,
    // p = 2^(s - m_new), denominator
    for (int row = warp; row < R; row += PF_THREADS / 32) {
      float* pr = p_s + row * SP;
      const float s0 = lane < rows ? pr[lane] : SMX_NEG_INF;
      const float s1 = lane + 32 < rows ? pr[lane + 32] : SMX_NEG_INF;
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = m_s[row];
      const float m_new = fmaxf(m_prev, intmax ? ceilf(mx) : mx);
      const float p0 = lane < rows ? exp2f(s0 - m_new) : 0.f;
      const float p1 = lane + 32 < rows ? exp2f(s1 - m_new) : 0.f;
      if (lane < rows) pr[lane] = p0;
      if (lane + 32 < rows) pr[lane + 32] = p1;
      float sum = p0 + p1;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float alpha = smx_rescale(m_prev - m_new, intmax);
        alpha_s[row] = alpha;
        m_s[row] = m_new;
        d_s[row] = d_s[row] * alpha + sum;
      }
    }
    __syncthreads();

    // acc = acc*alpha + (p*v_scale)·V on the register tile
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = warp + 8 * i;
      if (row < R) {
        const float a = alpha_s[row];
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[i][k] *= a;
      }
    }
    for (int c = 0; c < rows; ++c) {
      const float vsc = vsc_s[c];
      float vv[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int d = lane + 32 * k;
        vv[k] = d < D ? v_s[c * D + d] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int row = warp + 8 * i;
        const float pv = row < R ? p_s[row * SP + c] * vsc : 0.f;
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[i][k] += pv * vv[k];
      }
    }
    __syncthreads();   // the next tile overwrites k_s / v_s / p_s
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = warp + 8 * i;
    if (row >= R) continue;
    const int g = row / BQ, qi = qt * BQ + row % BQ;
    if (qi >= Sq) continue;
    const float dd = d_s[row];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int d = lane + 32 * k;
      if (d < D)
        out[((static_cast<size_t>(bh) * G + g) * Sq + qi) * D + d] =
            smx_from_f32<QT>(dd > 0.f ? acc[i][k] / dd : 0.f);
    }
  }
}

size_t prefill_smem(int G, int BQ, int D, int Wp) {
  return sizeof(float) * prefill_smem_floats(G * BQ, D) +
         sizeof(int) * static_cast<size_t>(Wp);
}

template <typename QT, typename KT>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const void* k_scale, const void* v_scale,
                   const void* tables, const void* q_pos0, void* out, int B,
                   int Hq, int Hkv, int Sq, int D, int BS, int Wp, int BQ,
                   int intmax, cudaStream_t stream) {
  const int G = Hq / Hkv;
  const size_t smem = prefill_smem(G, BQ, D, Wp);
  auto kern = paged_prefill_kernel<QT, KT>;
  cudaError_t err = smx_smem_limit(kern, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(B * Hkv, (Sq + BQ - 1) / BQ);
  kern<<<grid, PF_THREADS, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(k_pool),
      static_cast<const KT*>(v_pool), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int*>(tables),
      static_cast<const int*>(q_pos0), static_cast<QT*>(out), Hkv, G, Sq, D,
      BS, Wp, BQ, intmax);
  return cudaGetLastError();
}

}  // namespace

// Dynamic shared memory one launch needs, for the wrapper's checks.
extern "C" long long smx_paged_prefill_smem(int G, int BQ, int D, int Wp) {
  return static_cast<long long>(prefill_smem(G, BQ, D, Wp));
}

// Plain C entry point (loaded with ctypes). q_dtype: SMX_F32 | SMX_BF16;
// kv_dtype: SMX_F32 | SMX_BF16 | SMX_I8 (int8 needs both scale pools).
// Returns cudaGetLastError() after the launch.
extern "C" int smx_paged_prefill(const void* q, const void* k_pool,
                                 const void* v_pool, const void* k_scale,
                                 const void* v_scale, const void* tables,
                                 const void* q_pos0, void* out, int B, int Hq,
                                 int Hkv, int Sq, int D, int BS, int Wp,
                                 int BQ, int q_dtype, int kv_dtype,
                                 int intmax, void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0 || BQ <= 0 || (Hq / Hkv) * BQ > R_MAX ||
      D > D_MAX ||
      (kv_dtype == SMX_I8) != (k_scale != nullptr && v_scale != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SMX_ARGS q, k_pool, v_pool, k_scale, v_scale, tables, q_pos0, out, \
    B, Hq, Hkv, Sq, D, BS, Wp, BQ, intmax, st
  cudaError_t err = cudaErrorInvalidValue;
  if (q_dtype == SMX_F32) {
    if (kv_dtype == SMX_F32) err = launch<float, float>(SMX_ARGS);
    else if (kv_dtype == SMX_BF16) err = launch<float, __nv_bfloat16>(SMX_ARGS);
    else if (kv_dtype == SMX_I8) err = launch<float, int8_t>(SMX_ARGS);
  } else if (q_dtype == SMX_BF16) {
    if (kv_dtype == SMX_F32) err = launch<__nv_bfloat16, float>(SMX_ARGS);
    else if (kv_dtype == SMX_BF16)
      err = launch<__nv_bfloat16, __nv_bfloat16>(SMX_ARGS);
    else if (kv_dtype == SMX_I8) err = launch<__nv_bfloat16, int8_t>(SMX_ARGS);
  }
#undef SMX_ARGS
  return static_cast<int>(err);
}
