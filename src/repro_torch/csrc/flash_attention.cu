// Dense GQA flash-attention forward with Softermax (Hopper, sm_90a).
//
// Replaces the Pallas TPU kernel flash_attention
// (src/repro/kernels/flash_attention/flash_attention.py:99, body
// _flash_kernel). Same function: queries q (B, Hq, Sq, D), pre-scaled,
// attend k, v (B, Hkv, Sk, D) with the Softermax online recurrence (base-2
// exponent, running IntMax, exact power-of-two rescales); causal queries
// sit at the end of the KV axis (q_offset = Sk - Sq, row qi sees columns
// kj <= qi + q_offset); non-causal rows see every column kj < Sk. Returns
// o in q's dtype and the fp32 row statistics (m, d) the backward
// (flash_backward.cu) recomputes P from. Rows with d == 0 give 0.
//
// Bound on this card: operations. Every staged KV tile serves a whole
// query tile, so at training shapes the arithmetic intensity is far above
// the bandwidth ridge. Like the reference, all math is fp32 (q, k, v and
// p), so this version runs on the CUDA cores; a bf16-p tensor-core variant
// is a separate parity contract. The design follows flash_prefill_paged.cu:
// a block stages its (G*BQ, D) query tile once (all G query heads of one
// KV head, so each KV tile is read once per group) and then 64-row KV
// tiles (16-byte loads) in shared memory, row strides padded by one float
// so column-wise reads hit distinct banks; each thread computes a 4 x 4
// block of scores and an 8 x 4 block of the accumulator in registers.
// Causal: KV tile 0 always runs first (column 0 is visible to every row
// when Sk >= Sq, so no row's running max is still NEG_INF when a fully
// masked tile arrives), tiles wholly above the diagonal of the query tile
// are skipped, and the query tiles with the most KV tiles are scheduled
// first.
//
// Grid (B*Hkv, ceil(Sq/BQ)); block row g*BQ + i holds head h*G + g at
// query position qt*BQ + i. Per KV tile: s = q·K^T, mask, m_new =
// max(m_prev, ceil(rowmax)), alpha = 2^(m_prev - m_new) (exact under
// IntMax), p = 2^(s - m_new), d = d*alpha + sum(p), acc = acc*alpha + p·V.
// Finish: o = acc * (d > 0 ? 1/d : 0). Rows past Sq are computed on zero
// queries and never stored.
#include "common.cuh"

namespace {

constexpr int FA_THREADS = 256;
constexpr int KV_ROWS = 64;        // KV rows per tile
constexpr int R_MAX = 64;          // query rows (G*BQ) per block
constexpr int D_MAX = 128;         // head dim the register tiles cover

__host__ __device__ inline size_t fwd_smem_floats(int R, int D) {
  return static_cast<size_t>(R) * (D + 1) +          // q tile
         static_cast<size_t>(KV_ROWS) * (D + 1) +    // K tile
         static_cast<size_t>(KV_ROWS) * D +          // V tile
         static_cast<size_t>(R) * (KV_ROWS + 1) +    // scores / p
         3 * static_cast<size_t>(R);                 // m, d, alpha
}

template <typename T>
__global__ void __launch_bounds__(FA_THREADS) flash_fwd_kernel(
    const T* __restrict__ q,        // (B, Hkv, G, Sq, D)
    const T* __restrict__ k,        // (B, Hkv, Sk, D)
    const T* __restrict__ v,
    T* __restrict__ out,            // (B, Hkv, G, Sq, D)
    float* __restrict__ m_out,      // (B, Hkv, G, Sq)
    float* __restrict__ d_out,
    int G, int Sq, int Sk, int D, int BQ, int causal, int intmax) {
  extern __shared__ float smem[];
  const int R = G * BQ, DP = D + 1, SP = KV_ROWS + 1;
  float* q_s = smem;                        // R x DP
  float* k_s = q_s + R * DP;                // KV_ROWS x DP
  float* v_s = k_s + KV_ROWS * DP;          // KV_ROWS x D
  float* p_s = v_s + KV_ROWS * D;           // R x SP
  float* m_s = p_s + R * SP;                // R
  float* d_s = m_s + R;                     // R
  float* alpha_s = d_s + R;                 // R

  const int bh = blockIdx.x;                // b * Hkv + h
  const int qt = gridDim.y - 1 - blockIdx.y;
  const int q0 = qt * BQ;
  const int q_rows = min(BQ, Sq - q0);
  const int q_offset = Sk - Sq;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const T* kb = k + static_cast<size_t>(bh) * Sk * D;
  const T* vb = v + static_cast<size_t>(bh) * Sk * D;

  for (int g = 0; g < G; ++g)
    smx_stage_rows<T>(q + ((static_cast<size_t>(bh) * G + g) * Sq + q0) * D,
                      nullptr, q_rows, BQ, D, q_s + g * BQ * DP, nullptr, DP);
  for (int row = tid; row < R; row += blockDim.x) {
    m_s[row] = SMX_NEG_INF;
    d_s[row] = 0.f;
  }
  __syncthreads();

  // score tile of a thread: rows sr + 16 i, columns sc + 16 j
  const int sc = tid & 15, sr = tid >> 4;
  // accumulator tile of a thread: rows warp + 8 i, columns lane + 32 c
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;

  // the last column any real row of this tile can see
  const int k_end = causal ? min(Sk, q0 + q_rows - 1 + q_offset + 1) : Sk;
  for (int k_start = 0; k_start < k_end; k_start += KV_ROWS) {
    const int rows = min(KV_ROWS, Sk - k_start);
    smx_stage_rows<T>(kb + static_cast<size_t>(k_start) * D, nullptr, rows,
                      rows, D, k_s, nullptr, DP);
    smx_stage_rows<T>(vb + static_cast<size_t>(k_start) * D, nullptr, rows,
                      rows, D, v_s, nullptr, D);
    __syncthreads();

    // scores with the causal mask (or the KV-length bound)
    {
      float s[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
      for (int dd = 0; dd < D; ++dd) {
        float qv[4], kv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = sr + 16 * i;
          qv[i] = row < R ? q_s[row * DP + dd] : 0.f;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = sc + 16 * j;
          kv[j] = c < rows ? k_s[c * DP + dd] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] += qv[i] * kv[j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = sr + 16 * i;
        if (row >= R) continue;
        const int qi = q0 + row % BQ;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = sc + 16 * j;
          if (c >= rows) continue;
          const bool ok = !causal || k_start + c <= qi + q_offset;
          p_s[row * SP + c] = ok ? s[i][j] : SMX_NEG_INF;
        }
      }
    }
    __syncthreads();

    // per row (one warp each, two columns per lane): IntMax, rescale,
    // p = 2^(s - m_new), denominator
    for (int row = warp; row < R; row += FA_THREADS / 32) {
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

    // acc = acc*alpha + p·V on the register tile
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = warp + 8 * i;
      if (row < R) {
        const float a = alpha_s[row];
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][c] *= a;
      }
    }
    for (int c = 0; c < rows; ++c) {
      float vv[4];
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const int dd = lane + 32 * cc;
        vv[cc] = dd < D ? v_s[c * D + dd] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int row = warp + 8 * i;
        const float pv = row < R ? p_s[row * SP + c] : 0.f;
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) acc[i][cc] += pv * vv[cc];
      }
    }
    __syncthreads();   // the next tile overwrites k_s / v_s / p_s
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = warp + 8 * i;
    if (row >= R) continue;
    const int g = row / BQ, qi = q0 + row % BQ;
    if (qi >= Sq) continue;
    const size_t r = (static_cast<size_t>(bh) * G + g) * Sq + qi;
    const float dd = d_s[row];
    const float recip = dd > 0.f ? 1.f / dd : 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int col = lane + 32 * c;
      if (col < D) out[r * D + col] = smx_from_f32<T>(acc[i][c] * recip);
    }
    if (lane == 0) {
      m_out[r] = m_s[row];
      d_out[r] = dd;
    }
  }
}

size_t fwd_smem(int G, int BQ, int D) {
  return sizeof(float) * fwd_smem_floats(G * BQ, D);
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   void* m, void* d, int B, int Hq, int Hkv, int Sq, int Sk,
                   int D, int BQ, int causal, int intmax,
                   cudaStream_t stream) {
  const int G = Hq / Hkv;
  const size_t smem = fwd_smem(G, BQ, D);
  auto kern = flash_fwd_kernel<T>;
  cudaError_t err = smx_smem_limit(kern, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(B * Hkv, (Sq + BQ - 1) / BQ);
  kern<<<grid, FA_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), static_cast<float*>(m),
      static_cast<float*>(d), G, Sq, Sk, D, BQ, causal, intmax);
  return cudaGetLastError();
}

}  // namespace

// Dynamic shared memory one launch needs, for the wrapper's checks.
extern "C" long long smx_flash_fwd_smem(int G, int BQ, int D) {
  return static_cast<long long>(fwd_smem(G, BQ, D));
}

// Plain C entry point (loaded with ctypes). dtype: SMX_F32 | SMX_BF16 for
// q, k, v and out; m and d are fp32 (B, Hq, Sq). Causal needs Sk >= Sq.
// Returns cudaGetLastError() after the launch.
extern "C" int smx_flash_fwd(const void* q, const void* k, const void* v,
                             void* out, void* m, void* d, int B, int Hq,
                             int Hkv, int Sq, int Sk, int D, int BQ,
                             int dtype, int causal, int intmax,
                             void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || Hkv <= 0 || Hq % Hkv != 0 ||
      BQ <= 0 || (Hq / Hkv) * BQ > R_MAX || D <= 0 || D > D_MAX ||
      (causal && Sk < Sq))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == SMX_F32)
    return static_cast<int>(launch<float>(q, k, v, out, m, d, B, Hq, Hkv, Sq,
                                          Sk, D, BQ, causal, intmax, st));
  if (dtype == SMX_BF16)
    return static_cast<int>(launch<__nv_bfloat16>(q, k, v, out, m, d, B, Hq,
                                                  Hkv, Sq, Sk, D, BQ, causal,
                                                  intmax, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
