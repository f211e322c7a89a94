// Paged single-token GQA decode attention with Softermax (Hopper, sm_90a).
//
// Replaces the Pallas TPU kernel flash_decode_paged
// (src/repro/kernels/flash_decode_paged/flash_decode_paged.py:150,
// body _paged_decode_kernel). Same function: one query token per sequence,
// a whole GQA group (G query heads) per lane, KV read through the block
// table, split-K lanes that each emit a partial Softermax state
// (m, d, acc), merged by the exact power-of-two combine. The kv tile size T
// only shapes the split geometry (split_layout), as everywhere it is a
// layout knob: the block walks its rows in 32-row chunks.
//
// Bound on this card: bytes. Each KV row is read once and used for G dot
// products of length D, so the arithmetic intensity is ~G/2 FLOP per byte
// (bf16) — two orders of magnitude under the H100's compute/bandwidth
// ridge. The design therefore spends nothing on tensor cores and works on
// latency and waste instead:
//  * one block per (sequence, KV head, split lane) reads each gathered row
//    once for the whole group, and its eight warps walk interleaved 32-row
//    chunks independently, each with its own running (m, d, acc) — no block
//    barrier inside the walk — merged exactly at the end;
//  * in a chunk each lane owns one KV row: it reads the K and V row with
//    16-byte loads, computes its G scores against q in shared memory
//    (broadcast reads), and stages the V row in shared memory for the A·V
//    pass, where lanes own strided output columns;
//  * the lane's whole slice of the block table is read once up front;
//    rows past the sequence length are never read; int8 pools are
//    dequantized after the dot (the row scale multiplies the score, not the
//    row), so they move half the bytes of bf16.
//
// Per chunk (rows r): s = q·K_r in fp32 (times k_scale), masked past the
// length, m_new = max(m, ceil(max_r s)), alpha = 2^(m - m_new) (exact
// under IntMax), p = 2^(s - m_new), d = d*alpha + sum(p), acc = acc*alpha
// + sum_r (p*v_scale)·V_r. A lane whose rows all lie past the length leaves
// the merge identity (NEG_INF, 0, 0). The second kernel merges the split
// lanes (softermax_merge) and normalizes (acc / d, d == 0 -> 0) into q's
// dtype.
#include "common.cuh"

namespace {

constexpr int GMAX = 8;            // largest GQA group the kernel holds
constexpr int DPL_MAX = 8;         // output columns per lane: D <= 256
constexpr int NWARP = 8;
constexpr int DEC_THREADS = 32 * NWARP;

// Shared memory of one decode block, in floats (the table slice follows).
__host__ __device__ inline size_t decode_smem_floats(int G, int D) {
  return static_cast<size_t>(G) * D +              // q
         static_cast<size_t>(NWARP) * 32 * (D + 1) +  // staged V chunks
         static_cast<size_t>(NWARP) * G * D +       // warp acc at the end
         2 * NWARP * G;                              // warp m, d
}

template <typename QT, typename KT>
__global__ void __launch_bounds__(DEC_THREADS) paged_decode_kernel(
    const QT* __restrict__ q,          // (B*Hkv, G, D)
    const KT* __restrict__ k_pool,     // (N, Hkv, BS, D)
    const KT* __restrict__ v_pool,
    const float* __restrict__ k_scale, // (N, Hkv, BS) or null
    const float* __restrict__ v_scale,
    const int* __restrict__ tables,    // (B, Wp), padded with block 0
    const int* __restrict__ lengths,   // (B,)
    float* __restrict__ acc_part,      // (B*Hkv, S, G, D)
    float* __restrict__ m_part,        // (B*Hkv, S, G)
    float* __restrict__ d_part,        // (B*Hkv, S, G)
    int Hkv, int G, int D, int BS, int Wp, int T, int S, int spl,
    int intmax) {
  extern __shared__ float smem[];
  const int DP = D + 1;                       // padded V row stride
  float* q_s = smem;                          // G x D
  float* v_all = q_s + G * D;                 // NWARP x 32 x DP
  float* wacc_s = v_all + NWARP * 32 * DP;    // NWARP x G x D
  float* wm_s = wacc_s + NWARP * G * D;       // NWARP x G
  float* wd_s = wm_s + NWARP * G;             // NWARP x G
  int* tbl_s = reinterpret_cast<int*>(wd_s + NWARP * G);   // spl*T

  const int bh = blockIdx.x;
  const int lane_s = blockIdx.y;
  const int b = bh / Hkv;
  const int h = bh % Hkv;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const bool quant = k_scale != nullptr;
  const int lane_rows = spl * T * BS;
  const int row0 = lane_s * lane_rows;        // first logical row of the lane
  const int row_end = min(row0 + lane_rows, lengths[b]);

  for (int i = tid; i < G * D; i += blockDim.x)
    q_s[i] = smx_to_f32(q[static_cast<size_t>(bh) * G * D + i]);
  const int* lane_tbl = tables + static_cast<size_t>(b) * Wp +
                        static_cast<size_t>(lane_s) * spl * T;
  for (int t = tid; t < spl * T; t += blockDim.x) tbl_s[t] = lane_tbl[t];
  __syncthreads();

  constexpr int VEC = 16 / sizeof(KT);
  const bool vec = D % VEC == 0 &&
                   (reinterpret_cast<uintptr_t>(k_pool) |
                    reinterpret_cast<uintptr_t>(v_pool)) % 16 == 0;
  float* v_s = v_all + warp * 32 * DP;
  float m[GMAX], dl[GMAX], acc[GMAX][DPL_MAX];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    m[g] = SMX_NEG_INF;
    dl[g] = 0.f;                              // this lane's share of d
#pragma unroll
    for (int i = 0; i < DPL_MAX; ++i) acc[g][i] = 0.f;
  }

  for (int c0 = row0 + warp * 32; c0 < row_end; c0 += NWARP * 32) {
    const int lr = c0 + lane - row0;          // this lane's row in the lane
    const bool valid = c0 + lane < row_end;
    float s[GMAX];
#pragma unroll
    for (int g = 0; g < GMAX; ++g) s[g] = 0.f;
    float ksc = 1.f, vsc = 1.f;
    if (valid) {
      const size_t row =
          (static_cast<size_t>(tbl_s[lr / BS]) * Hkv + h) * BS + lr % BS;
      const KT* kr = k_pool + row * D;
      const KT* vr = v_pool + row * D;
      float* vd = v_s + lane * DP;
      if (vec) {
#pragma unroll 4
        for (int d = 0; d < D; d += VEC) {
          const uint4 kw = *reinterpret_cast<const uint4*>(kr + d);
          const uint4 vw = *reinterpret_cast<const uint4*>(vr + d);
          const KT* ke = reinterpret_cast<const KT*>(&kw);
          const KT* ve = reinterpret_cast<const KT*>(&vw);
#pragma unroll
          for (int j = 0; j < VEC; ++j) {
            const float kv = smx_to_f32(ke[j]);
            vd[d + j] = smx_to_f32(ve[j]);
#pragma unroll
            for (int g = 0; g < GMAX; ++g)
              if (g < G) s[g] += q_s[g * D + d + j] * kv;
          }
        }
      } else {
        for (int d = 0; d < D; ++d) {
          const float kv = smx_to_f32(kr[d]);
          vd[d] = smx_to_f32(vr[d]);
#pragma unroll
          for (int g = 0; g < GMAX; ++g)
            if (g < G) s[g] += q_s[g * D + d] * kv;
        }
      }
      if (quant) {
        ksc = k_scale[row];
        vsc = v_scale[row];
      }
    }
    __syncwarp();

    // IntMax over the chunk (ceil after the reduce), exact rescale, p
    float pv[GMAX];
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      if (g < G) {
        const float sg = valid ? (quant ? s[g] * ksc : s[g]) : SMX_NEG_INF;
        float mx = sg;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        const float m_new = fmaxf(m[g], intmax ? ceilf(mx) : mx);
        const float alpha = smx_rescale(m[g] - m_new, intmax);
        const float p = valid ? exp2f(sg - m_new) : 0.f;
        dl[g] = dl[g] * alpha + p;            // d sums p, not p*v_scale
        pv[g] = p * vsc;
#pragma unroll
        for (int i = 0; i < DPL_MAX; ++i) acc[g][i] *= alpha;
        m[g] = m_new;
      }
    }

    // acc += sum_r (p_r * v_scale_r) · V_r; lanes own columns lane + 32i
    const int nrows = min(32, row_end - c0);
    for (int r = 0; r < nrows; ++r) {
      float vv[DPL_MAX];
#pragma unroll
      for (int i = 0; i < DPL_MAX; ++i) {
        const int d = lane + 32 * i;
        vv[i] = d < D ? v_s[r * DP + d] : 0.f;
      }
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        if (g < G) {
          const float pr = __shfl_sync(0xffffffffu, pv[g], r);
#pragma unroll
          for (int i = 0; i < DPL_MAX; ++i) acc[g][i] += pr * vv[i];
        }
      }
    }
    __syncwarp();                             // v_s is rewritten next chunk
  }

  // this warp's state → shared memory, then the exact merge of the warps
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    if (g < G) {
      float x = dl[g];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
      if (lane == 0) {
        wm_s[warp * G + g] = m[g];
        wd_s[warp * G + g] = x;
      }
#pragma unroll
      for (int i = 0; i < DPL_MAX; ++i) {
        const int d = lane + 32 * i;
        if (d < D) wacc_s[(warp * G + g) * D + d] = acc[g][i];
      }
    }
  }
  __syncthreads();
  const size_t part = static_cast<size_t>(bh) * S + lane_s;
  for (int i = tid; i < G * D; i += blockDim.x) {
    const int g = i / D, d = i % D;
    float m_star = wm_s[g];
    for (int w = 1; w < NWARP; ++w) m_star = fmaxf(m_star, wm_s[w * G + g]);
    float dsum = 0.f, asum = 0.f;
    for (int w = 0; w < NWARP; ++w) {
      const float dw = wd_s[w * G + g];
      // a warp that read no row holds the identity and drops out exactly
      const float sc =
          dw > 0.f ? smx_rescale(wm_s[w * G + g] - m_star, intmax) : 0.f;
      dsum += dw * sc;
      asum += wacc_s[(w * G + g) * D + d] * sc;
    }
    acc_part[part * G * D + i] = asum;
    if (d == 0) {
      m_part[part * G + g] = m_star;
      d_part[part * G + g] = dsum;
    }
  }
}

size_t decode_smem(int G, int D, int T, int BS, int spl) {
  (void)BS;
  return sizeof(float) * decode_smem_floats(G, D) +
         sizeof(int) * static_cast<size_t>(spl) * T;
}

template <typename QT, typename KT>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const void* k_scale, const void* v_scale,
                   const void* tables, const void* lengths, void* acc_part,
                   void* m_part, void* d_part, void* out, int B, int Hq,
                   int Hkv, int D, int BS, int Wp, int T, int S, int spl,
                   int intmax, cudaStream_t stream) {
  const size_t smem = decode_smem(Hq / Hkv, D, T, BS, spl);
  const int G = Hq / Hkv;
  auto kern = paged_decode_kernel<QT, KT>;
  cudaError_t err = smx_smem_limit(kern, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(B * Hkv, S);
  kern<<<grid, DEC_THREADS, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(k_pool),
      static_cast<const KT*>(v_pool), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int*>(tables),
      static_cast<const int*>(lengths), static_cast<float*>(acc_part),
      static_cast<float*>(m_part), static_cast<float*>(d_part), Hkv, G, D,
      BS, Wp, T, S, spl, intmax);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  smx_merge_lanes_kernel<QT><<<B * Hkv, DEC_THREADS, 0, stream>>>(
      static_cast<const float*>(acc_part), static_cast<const float*>(m_part),
      static_cast<const float*>(d_part), static_cast<QT*>(out), G, D, S,
      intmax);
  return cudaGetLastError();
}

}  // namespace

// Dynamic shared memory one decode launch needs (the wrapper checks it
// against the card's per-block limit).
extern "C" long long smx_paged_decode_smem(int G, int D, int T, int BS,
                                           int spl) {
  return static_cast<long long>(decode_smem(G, D, T, BS, spl));
}

// Plain C entry point (loaded with ctypes). q_dtype: SMX_F32 | SMX_BF16;
// kv_dtype: SMX_F32 | SMX_BF16 | SMX_I8 (int8 needs both scale pools).
// Returns cudaGetLastError() after the launches.
extern "C" int smx_paged_decode(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* tables,
    const void* lengths, void* acc_part, void* m_part, void* d_part,
    void* out, int B, int Hq, int Hkv, int D, int BS, int Wp, int T, int S,
    int spl, int q_dtype, int kv_dtype, int intmax, void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0 || Hq / Hkv > GMAX || D > 32 * DPL_MAX ||
      (kv_dtype == SMX_I8) != (k_scale != nullptr && v_scale != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SMX_ARGS q, k_pool, v_pool, k_scale, v_scale, tables, lengths, \
    acc_part, m_part, d_part, out, B, Hq, Hkv, D, BS, Wp, T, S, spl, intmax, st
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
