// Per-query-head paged single-token decode with Softermax (Hopper, sm_90a).
//
// Replaces the Pallas TPU kernel flash_decode_paged_single
// (src/repro/kernels/flash_decode_paged/flash_decode_paged.py:302, body
// _paged_decode_kernel_single at :251). It is the benchmark baseline that
// the grouped kernel (flash_decode_paged.cu) is measured against, so it
// keeps the dataflow that defines it:
//  * one block per (sequence, query head): every query head of a GQA group
//    reads the group's K/V for itself, G times the grouped kernel's bytes;
//  * one pool block per serial step, in table order; no tiles, no split.
// Blocks that start at or past the sequence length are skipped, not read
// (their table entries may be garbage).
//
// Inside a step (rows r of the block that lie within the length):
//   s_r = q·K_r in fp32 (times k_scale_r for int8 pools) — each warp owns
//         rows, its lanes read a row with 16-byte loads and reduce by shuffle;
//   m_new = max(m, ceil(max_r s_r)) (IntMax; plain max without it), every
//         thread reducing the block's few scores from shared memory;
//   alpha = 2^(m - m_new), exact under IntMax (ldexpf on the integer
//         difference); p_r = 2^(s_r - m_new);
//   d = d*alpha + sum_r p_r; acc = acc*alpha + sum_r (p_r*v_scale_r) V_r,
//         threads owning output columns.
// At the end out = acc / d, with d == 0 (a row of length 0) mapped to 0.
// Scores past the length never enter, which equals the finite NEG_INF
// mask of the TPU kernel (2^(NEG_INF - m) is 0).
//
// No tensor cores, no tuning: the kernel is a gather with a length-D dot.
#include "common.cuh"

namespace {

constexpr int NWARP = 4;
constexpr int SINGLE_THREADS = 32 * NWARP;
constexpr int COLS_MAX = 2;        // output columns per thread: D <= 256

template <typename QT, typename KT>
__global__ void __launch_bounds__(SINGLE_THREADS) paged_decode_single_kernel(
    const QT* __restrict__ q,          // (B*Hq, D)
    const KT* __restrict__ k_pool,     // (N, Hkv, BS, D)
    const KT* __restrict__ v_pool,
    const float* __restrict__ k_scale, // (N, Hkv, BS) or null
    const float* __restrict__ v_scale,
    const int* __restrict__ tables,    // (B, nb)
    const int* __restrict__ lengths,   // (B,)
    QT* __restrict__ out,              // (B*Hq, D)
    int Hq, int Hkv, int D, int BS, int nb, int intmax) {
  extern __shared__ float smem[];
  float* q_s = smem;                   // D
  float* s_s = q_s + D;                // BS scores of the current block

  const int bh = blockIdx.x;
  const int b = bh / Hq;
  const int h = (bh % Hq) / (Hq / Hkv);   // the query head's KV head
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const bool quant = k_scale != nullptr;
  const int len = lengths[b];
  const int* tbl = tables + static_cast<size_t>(b) * nb;

  for (int i = tid; i < D; i += SINGLE_THREADS)
    q_s[i] = smx_to_f32(q[static_cast<size_t>(bh) * D + i]);
  __syncthreads();

  constexpr int VEC = 16 / sizeof(KT);
  const bool vec = D % VEC == 0 &&
                   reinterpret_cast<uintptr_t>(k_pool) % 16 == 0;
  float m = SMX_NEG_INF, d = 0.f, acc[COLS_MAX];
#pragma unroll
  for (int i = 0; i < COLS_MAX; ++i) acc[i] = 0.f;

  for (int j = 0; j < nb && j * BS < len; ++j) {
    const int rows = min(BS, len - j * BS);
    const size_t row0 = (static_cast<size_t>(tbl[j]) * Hkv + h) * BS;

    for (int r = warp; r < rows; r += NWARP) {
      const KT* kr = k_pool + (row0 + r) * D;
      float part = 0.f;
      if (vec) {
        for (int c = lane * VEC; c < D; c += 32 * VEC) {
          const uint4 w = *reinterpret_cast<const uint4*>(kr + c);
          const KT* e = reinterpret_cast<const KT*>(&w);
#pragma unroll
          for (int t = 0; t < VEC; ++t) part += q_s[c + t] * smx_to_f32(e[t]);
        }
      } else {
        for (int c = lane; c < D; c += 32) part += q_s[c] * smx_to_f32(kr[c]);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, o);
      if (lane == 0) s_s[r] = quant ? part * k_scale[row0 + r] : part;
    }
    __syncthreads();

    float mx = SMX_NEG_INF;
    for (int r = 0; r < rows; ++r) mx = fmaxf(mx, s_s[r]);
    const float m_new = fmaxf(m, intmax ? ceilf(mx) : mx);
    const float alpha = smx_rescale(m - m_new, intmax);
    d *= alpha;
#pragma unroll
    for (int i = 0; i < COLS_MAX; ++i) acc[i] *= alpha;
    for (int r = 0; r < rows; ++r) {
      const float p = exp2f(s_s[r] - m_new);
      d += p;                                  // d sums p, not p*v_scale
      const float pv = quant ? p * v_scale[row0 + r] : p;
      const KT* vr = v_pool + (row0 + r) * D;
#pragma unroll
      for (int i = 0; i < COLS_MAX; ++i) {
        const int c = tid + SINGLE_THREADS * i;
        if (c < D) acc[i] += pv * smx_to_f32(vr[c]);
      }
    }
    m = m_new;
    __syncthreads();                           // s_s is rewritten next step
  }

#pragma unroll
  for (int i = 0; i < COLS_MAX; ++i) {
    const int c = tid + SINGLE_THREADS * i;
    if (c < D)
      out[static_cast<size_t>(bh) * D + c] =
          smx_from_f32<QT>(d > 0.f ? acc[i] / d : 0.f);
  }
}

template <typename QT, typename KT>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const void* k_scale, const void* v_scale,
                   const void* tables, const void* lengths, void* out, int B,
                   int Hq, int Hkv, int D, int BS, int nb, int intmax,
                   cudaStream_t stream) {
  if (B * Hq == 0) return cudaSuccess;
  const size_t smem = sizeof(float) * static_cast<size_t>(D + BS);
  auto kern = paged_decode_single_kernel<QT, KT>;
  cudaError_t err = smx_smem_limit(kern, smem);
  if (err != cudaSuccess) return err;
  kern<<<B * Hq, SINGLE_THREADS, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(k_pool),
      static_cast<const KT*>(v_pool), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int*>(tables),
      static_cast<const int*>(lengths), static_cast<QT*>(out), Hq, Hkv, D,
      BS, nb, intmax);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes). q_dtype: SMX_F32 | SMX_BF16;
// kv_dtype: SMX_F32 | SMX_BF16 | SMX_I8 (int8 needs both scale pools).
// Returns cudaGetLastError() after the launch.
extern "C" int smx_paged_decode_single(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* tables,
    const void* lengths, void* out, int B, int Hq, int Hkv, int D, int BS,
    int nb, int q_dtype, int kv_dtype, int intmax, void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0 || D <= 0 || D > SINGLE_THREADS * COLS_MAX ||
      BS <= 0 ||
      (kv_dtype == SMX_I8) != (k_scale != nullptr && v_scale != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SMX_ARGS q, k_pool, v_pool, k_scale, v_scale, tables, lengths, out, \
    B, Hq, Hkv, D, BS, nb, intmax, st
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
