// Dense GQA flash-attention backward with Softermax (Hopper, sm_90a).
//
// Replaces the Pallas TPU kernels of flash_attention_bwd
// (src/repro/kernels/flash_attention/flash_backward.py:119; bodies
// _dkv_kernel and _dq_kernel). Same function: with P recomputed from the
// forward's saved row statistics,
//
//   p_ij  = 2^(s_ij - m_i) / max(d_i, 1e-30)     (0 where masked)
//   dP_ij = dO_i · V_j        delta_i = dO_i · O_i (computed by the caller)
//   dS_ij = ln2 · p_ij · (dP_ij - delta_i)       the base-2 factor
//   dV_j  = sum_i p_ij dO_i   dK_j = sum_i dS_ij Q_i   dQ_i = sum_j dS_ij K_j
//
// with the forward's masks (causal: kj <= qi + Sk - Sq; non-causal: kj <
// Sk). Outputs are fp32; dK and dV are summed over the G query heads of
// each KV head (GQA) inside the dK/dV kernel. Masked entries give p = 0
// exactly; rows past Sq and columns past Sk are excluded by bounds.
//
// Bound on this card: operations (each pair of kernels recomputes s and dP;
// 14 D multiply-adds per visible (query, key) pair). All math is fp32, as in
// the reference, so both kernels run on the CUDA cores with the layout of
// flash_attention.cu: 64-row tiles in shared memory with rows padded by
// one float, 4 x 4 register tiles of scores and dP per thread, and the
// products with the tile transposed (p^T·dO, dS^T·Q, dS·K) accumulated in
// 8 x 4 register tiles whose left operand is a shared-memory broadcast.
//
// dK/dV kernel: grid (B*Hkv, ceil(Sk/64)); a block holds one 64-row K/V
// tile and walks the G query heads of its KV head and, causally, only the
// 64-row query tiles that can see the tile (kv tile 0, the longest walk,
// is scheduled first). dQ kernel: grid (B*Hkv, ceil(Sq/BQ)); a block holds
// the (G*BQ, D) query and dO tile of one KV head and walks the KV tiles up
// to the diagonal, like the forward.
#include "common.cuh"

namespace {

constexpr int BW_THREADS = 256;
constexpr int TILE = 64;           // KV rows per tile; query rows per dK/dV step
constexpr int R_MAX = 64;          // query rows (G*BQ) per dQ block
constexpr int D_MAX = 128;
constexpr float LN2 = 0.69314718055994530942f;

__host__ __device__ inline size_t dkv_smem_floats(int D) {
  return 4 * static_cast<size_t>(TILE) * (D + 1) +   // K, V, Q, dO tiles
         2 * static_cast<size_t>(TILE) * (TILE + 1) + // p, dS
         3 * static_cast<size_t>(TILE);               // m, d, delta
}

__host__ __device__ inline size_t dq_smem_floats(int R, int D) {
  return 2 * static_cast<size_t>(R) * (D + 1) +      // Q, dO tiles
         2 * static_cast<size_t>(TILE) * (D + 1) +   // K, V tiles
         static_cast<size_t>(R) * (TILE + 1) +       // dS
         3 * static_cast<size_t>(R);                 // m, d, delta
}

// s = A·B^T and dp = C·E^T on a thread's 4 x 4 tile (rows ar + 16 i of A
// and C, rows bc + 16 j of B and E), all row-major with stride ld.
__device__ __forceinline__ void two_scores(const float* a_s, const float* b_s,
                                           const float* c_s, const float* e_s,
                                           int ld, int D, int ar, int bc,
                                           float s[4][4], float dp[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
  for (int dd = 0; dd < D; ++dd) {
    float av[4], bv[4], cv[4], ev[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      av[i] = a_s[(ar + 16 * i) * ld + dd];
      cv[i] = c_s[(ar + 16 * i) * ld + dd];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      bv[j] = b_s[(bc + 16 * j) * ld + dd];
      ev[j] = e_s[(bc + 16 * j) * ld + dd];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] += av[i] * bv[j];
        dp[i][j] += cv[i] * ev[j];
      }
  }
}

template <typename T>
__global__ void __launch_bounds__(BW_THREADS) flash_bwd_dkv_kernel(
    const T* __restrict__ q,         // (B, Hkv, G, Sq, D)
    const T* __restrict__ k,         // (B, Hkv, Sk, D)
    const T* __restrict__ v,
    const T* __restrict__ dout,      // (B, Hkv, G, Sq, D)
    const float* __restrict__ m,     // (B, Hkv, G, Sq)
    const float* __restrict__ d,
    const float* __restrict__ delta,
    float* __restrict__ dk,          // (B, Hkv, Sk, D)
    float* __restrict__ dv,
    int G, int Sq, int Sk, int D, int causal) {
  extern __shared__ float smem[];
  const int DP = D + 1, SP = TILE + 1;
  float* k_s = smem;                        // TILE x DP
  float* v_s = k_s + TILE * DP;
  float* q_s = v_s + TILE * DP;
  float* do_s = q_s + TILE * DP;
  float* p_s = do_s + TILE * DP;            // TILE x SP
  float* ds_s = p_s + TILE * SP;
  float* m_s = ds_s + TILE * SP;            // TILE
  float* d_s = m_s + TILE;
  float* dl_s = d_s + TILE;

  const int bh = blockIdx.x;                // b * Hkv + h
  const int k0 = blockIdx.y * TILE;
  const int k_rows = min(TILE, Sk - k0);
  const int q_offset = Sk - Sq;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int sc = tid & 15, sr = tid >> 4;

  smx_stage_rows<T>(k + (static_cast<size_t>(bh) * Sk + k0) * D,
                    v + (static_cast<size_t>(bh) * Sk + k0) * D, k_rows, TILE,
                    D, k_s, v_s, DP);

  // dK / dV tile of a thread: KV rows warp + 8 i, columns lane + 32 c
  float acc_k[8][4], acc_v[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;

  // causal: query rows below k0 - q_offset see nothing of this tile
  const int q_first = causal ? max(0, k0 - q_offset) : 0;
  for (int g = 0; g < G; ++g) {
    const size_t head = static_cast<size_t>(bh) * G + g;
    for (int q0 = (q_first / TILE) * TILE; q0 < Sq; q0 += TILE) {
      const int q_rows = min(TILE, Sq - q0);
      __syncthreads();   // the previous step's readers are done
      smx_stage_rows<T>(q + (head * Sq + q0) * D, dout + (head * Sq + q0) * D,
                        q_rows, TILE, D, q_s, do_s, DP);
      for (int r = tid; r < TILE; r += blockDim.x) {
        const bool ok = r < q_rows;
        const size_t i = head * Sq + q0 + r;
        m_s[r] = ok ? m[i] : 0.f;
        d_s[r] = ok ? fmaxf(d[i], 1e-30f) : 1.f;
        dl_s[r] = ok ? delta[i] : 0.f;
      }
      __syncthreads();

      float s[4][4], dp[4][4];
      two_scores(q_s, k_s, do_s, v_s, DP, D, sr, sc, s, dp);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = sr + 16 * i;
        const int qi = q0 + r;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = sc + 16 * j;
          const bool ok = r < q_rows && c < k_rows &&
                          (!causal || k0 + c <= qi + q_offset);
          const float p = ok ? exp2f(s[i][j] - m_s[r]) / d_s[r] : 0.f;
          p_s[r * SP + c] = p;
          ds_s[r * SP + c] = ok ? LN2 * p * (dp[i][j] - dl_s[r]) : 0.f;
        }
      }
      __syncthreads();

      // dV += p^T·dO, dK += dS^T·Q
      for (int r = 0; r < q_rows; ++r) {
        float dov[4], qv[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int col = lane + 32 * c;
          dov[c] = col < D ? do_s[r * DP + col] : 0.f;
          qv[c] = col < D ? q_s[r * DP + col] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int kr = warp + 8 * i;
          const float pv = p_s[r * SP + kr];
          const float dsv = ds_s[r * SP + kr];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            acc_v[i][c] += pv * dov[c];
            acc_k[i][c] += dsv * qv[c];
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int kr = warp + 8 * i;
    if (kr >= k_rows) continue;
    const size_t row = (static_cast<size_t>(bh) * Sk + k0 + kr) * D;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int col = lane + 32 * c;
      if (col < D) {
        dk[row + col] = acc_k[i][c];
        dv[row + col] = acc_v[i][c];
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(BW_THREADS) flash_bwd_dq_kernel(
    const T* __restrict__ q,         // (B, Hkv, G, Sq, D)
    const T* __restrict__ k,         // (B, Hkv, Sk, D)
    const T* __restrict__ v,
    const T* __restrict__ dout,
    const float* __restrict__ m,     // (B, Hkv, G, Sq)
    const float* __restrict__ d,
    const float* __restrict__ delta,
    float* __restrict__ dq,          // (B, Hkv, G, Sq, D)
    int G, int Sq, int Sk, int D, int BQ, int causal) {
  extern __shared__ float smem[];
  const int R = G * BQ, DP = D + 1, SP = TILE + 1;
  float* q_s = smem;                        // R x DP
  float* do_s = q_s + R * DP;
  float* k_s = do_s + R * DP;               // TILE x DP
  float* v_s = k_s + TILE * DP;
  float* ds_s = v_s + TILE * DP;            // R x SP
  float* m_s = ds_s + R * SP;               // R
  float* d_s = m_s + R;
  float* dl_s = d_s + R;

  const int bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;
  const int q0 = qt * BQ;
  const int q_rows = min(BQ, Sq - q0);
  const int q_offset = Sk - Sq;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int sc = tid & 15, sr = tid >> 4;

  for (int g = 0; g < G; ++g) {
    const size_t off = ((static_cast<size_t>(bh) * G + g) * Sq + q0) * D;
    smx_stage_rows<T>(q + off, dout + off, q_rows, BQ, D, q_s + g * BQ * DP,
                      do_s + g * BQ * DP, DP);
  }
  for (int row = tid; row < R; row += blockDim.x) {
    const int g = row / BQ, i = row % BQ;
    const bool ok = i < q_rows;
    const size_t idx = (static_cast<size_t>(bh) * G + g) * Sq + q0 + i;
    m_s[row] = ok ? m[idx] : 0.f;
    d_s[row] = ok ? fmaxf(d[idx], 1e-30f) : 1.f;
    dl_s[row] = ok ? delta[idx] : 0.f;
  }

  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;

  const int k_end = causal ? min(Sk, q0 + q_rows + q_offset) : Sk;
  for (int k0 = 0; k0 < k_end; k0 += TILE) {
    const int k_rows = min(TILE, Sk - k0);
    __syncthreads();   // the previous tile's readers are done
    smx_stage_rows<T>(k + (static_cast<size_t>(bh) * Sk + k0) * D,
                      v + (static_cast<size_t>(bh) * Sk + k0) * D, k_rows,
                      TILE, D, k_s, v_s, DP);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int dd = 0; dd < D; ++dd) {
      float qv[4], kv[4], ov[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = sr + 16 * i;
        qv[i] = row < R ? q_s[row * DP + dd] : 0.f;
        ov[i] = row < R ? do_s[row * DP + dd] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = k_s[(sc + 16 * j) * DP + dd];
        vv[j] = v_s[(sc + 16 * j) * DP + dd];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] += qv[i] * kv[j];
          dp[i][j] += ov[i] * vv[j];
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = sr + 16 * i;
      if (row >= R) continue;
      const int qi = q0 + row % BQ;
      const bool row_ok = row % BQ < q_rows;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = sc + 16 * j;
        const bool ok = row_ok && c < k_rows &&
                        (!causal || k0 + c <= qi + q_offset);
        const float p = ok ? exp2f(s[i][j] - m_s[row]) / d_s[row] : 0.f;
        ds_s[row * SP + c] = ok ? LN2 * p * (dp[i][j] - dl_s[row]) : 0.f;
      }
    }
    __syncthreads();

    // dQ += dS·K
    for (int c = 0; c < k_rows; ++c) {
      float kv[4];
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const int col = lane + 32 * cc;
        kv[cc] = col < D ? k_s[c * DP + col] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int row = warp + 8 * i;
        const float dsv = row < R ? ds_s[row * SP + c] : 0.f;
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) acc[i][cc] += dsv * kv[cc];
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = warp + 8 * i;
    if (row >= R) continue;
    const int g = row / BQ, qi = q0 + row % BQ;
    if (qi >= Sq) continue;
    const size_t r = ((static_cast<size_t>(bh) * G + g) * Sq + qi) * D;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int col = lane + 32 * c;
      if (col < D) dq[r + col] = acc[i][c];
    }
  }
}

bool bad_geometry(int B, int Hq, int Hkv, int Sq, int Sk, int D,
                  int causal) {
  return B <= 0 || Sq <= 0 || Sk <= 0 || Hkv <= 0 || Hq % Hkv != 0 ||
         D <= 0 || D > D_MAX || (causal && Sk < Sq);
}

template <typename T>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const float* m, const float* d,
                       const float* delta, float* dk, float* dv, int B,
                       int Hq, int Hkv, int Sq, int Sk, int D, int causal,
                       cudaStream_t stream) {
  const size_t smem = sizeof(float) * dkv_smem_floats(D);
  auto kern = flash_bwd_dkv_kernel<T>;
  cudaError_t err = smx_smem_limit(kern, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(B * Hkv, (Sk + TILE - 1) / TILE);
  kern<<<grid, BW_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), m, d, delta, dk,
      dv, Hq / Hkv, Sq, Sk, D, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const float* m, const float* d,
                      const float* delta, float* dq, int B, int Hq, int Hkv,
                      int Sq, int Sk, int D, int BQ, int causal,
                      cudaStream_t stream) {
  const int G = Hq / Hkv;
  const size_t smem = sizeof(float) * dq_smem_floats(G * BQ, D);
  auto kern = flash_bwd_dq_kernel<T>;
  cudaError_t err = smx_smem_limit(kern, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(B * Hkv, (Sq + BQ - 1) / BQ);
  kern<<<grid, BW_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), m, d, delta, dq,
      G, Sq, Sk, D, BQ, causal);
  return cudaGetLastError();
}

}  // namespace

// Dynamic shared memory of each kernel, for the wrapper's checks.
extern "C" long long smx_flash_bwd_dkv_smem(int D) {
  return static_cast<long long>(sizeof(float) * dkv_smem_floats(D));
}
extern "C" long long smx_flash_bwd_dq_smem(int G, int BQ, int D) {
  return static_cast<long long>(sizeof(float) * dq_smem_floats(G * BQ, D));
}

// Plain C entry points (loaded with ctypes). dtype: SMX_F32 | SMX_BF16 for
// q, k, v and dout; m, d, delta (B, Hq, Sq) and the gradients are fp32.
// Each returns cudaGetLastError() after its launch.
extern "C" int smx_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* dout, const void* m,
                                 const void* d, const void* delta, void* dk,
                                 void* dv, int B, int Hq, int Hkv, int Sq,
                                 int Sk, int D, int dtype, int causal,
                                 void* stream) {
  if (bad_geometry(B, Hq, Hkv, Sq, Sk, D, causal))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* mf = static_cast<const float*>(m);
  const float* df = static_cast<const float*>(d);
  const float* lf = static_cast<const float*>(delta);
  float* dkf = static_cast<float*>(dk);
  float* dvf = static_cast<float*>(dv);
  if (dtype == SMX_F32)
    return static_cast<int>(launch_dkv<float>(q, k, v, dout, mf, df, lf, dkf,
                                              dvf, B, Hq, Hkv, Sq, Sk, D,
                                              causal, st));
  if (dtype == SMX_BF16)
    return static_cast<int>(launch_dkv<__nv_bfloat16>(
        q, k, v, dout, mf, df, lf, dkf, dvf, B, Hq, Hkv, Sq, Sk, D, causal,
        st));
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int smx_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* dout, const void* m,
                                const void* d, const void* delta, void* dq,
                                int B, int Hq, int Hkv, int Sq, int Sk, int D,
                                int BQ, int dtype, int causal, void* stream) {
  if (bad_geometry(B, Hq, Hkv, Sq, Sk, D, causal) || BQ <= 0 ||
      (Hq / Hkv) * BQ > R_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* mf = static_cast<const float*>(m);
  const float* df = static_cast<const float*>(d);
  const float* lf = static_cast<const float*>(delta);
  float* dqf = static_cast<float*>(dq);
  if (dtype == SMX_F32)
    return static_cast<int>(launch_dq<float>(q, k, v, dout, mf, df, lf, dqf,
                                             B, Hq, Hkv, Sq, Sk, D, BQ,
                                             causal, st));
  if (dtype == SMX_BF16)
    return static_cast<int>(launch_dq<__nv_bfloat16>(
        q, k, v, dout, mf, df, lf, dqf, B, Hq, Hkv, Sq, Sk, D, BQ, causal,
        st));
  return static_cast<int>(cudaErrorInvalidValue);
}
