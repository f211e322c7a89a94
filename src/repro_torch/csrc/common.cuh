// Shared helpers for the Softermax attention kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Finite mask value (repro_torch.core.numerics.NEG_INF): -inf would turn
// the online recurrence's (m_prev - m_new) into nan on fully masked rows.
#define SMX_NEG_INF (-1e9f)

// dtype codes shared with the Python wrappers
enum SmxDtype { SMX_F32 = 0, SMX_BF16 = 1, SMX_I8 = 2 };

__device__ __forceinline__ float smx_to_f32(float x) { return x; }
__device__ __forceinline__ float smx_to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float smx_to_f32(int8_t x) {
  return static_cast<float>(x);
}

template <typename T>
__device__ __forceinline__ T smx_from_f32(float x);
template <>
__device__ __forceinline__ float smx_from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 smx_from_f32<__nv_bfloat16>(
    float x) {
  return __float2bfloat16_rn(x);
}

// The online rescale 2^(m_prev - m_new). Under IntMax both maxima are
// integral, so the factor is an exact power of two: build it with ldexpf
// (an exponent add) instead of trusting an exp2 approximation. The base-2
// ablation (intmax == 0) has non-integral differences and uses exp2f.
__device__ __forceinline__ float smx_rescale(float diff, int intmax) {
  if (intmax) {
    // diff <= 0; below -126 - 23 the factor underflows to 0 anyway
    return diff < -200.f ? 0.f : ldexpf(1.f, static_cast<int>(diff));
  }
  return exp2f(diff);
}

// Stage `rows` gathered KV rows, logical positions pos0 .. pos0+rows-1,
// into shared memory as fp32: position p is pool row
// (tbl[p / BS] * Hkv + h) * BS + p % BS and lands at k_s[r * ldk + d] /
// v_s[r * ldv + d]. Rows are read with 16-byte vector loads where their
// width and the pools' alignment allow it, all issued before any is used,
// so a tile costs about one device-memory round trip.
template <typename KT>
__device__ __forceinline__ void smx_stage_kv(
    const KT* __restrict__ k_pool, const KT* __restrict__ v_pool,
    const int* tbl, int pos0, int rows, int Hkv, int h, int BS, int D,
    float* k_s, int ldk, float* v_s, int ldv) {
  constexpr int VEC = 16 / sizeof(KT);
  const bool vec =
      D % VEC == 0 && (reinterpret_cast<uintptr_t>(k_pool) |
                       reinterpret_cast<uintptr_t>(v_pool)) % 16 == 0;
  const int per_row = vec ? D / VEC : D;
  for (int i = threadIdx.x; i < rows * per_row; i += blockDim.x) {
    const int r = i / per_row, p = pos0 + r;
    const size_t base =
        ((static_cast<size_t>(tbl[p / BS]) * Hkv + h) * BS + p % BS) * D;
    if (vec) {
      const int c = (i % per_row) * VEC;
      const uint4 kr = *reinterpret_cast<const uint4*>(k_pool + base + c);
      const uint4 vr = *reinterpret_cast<const uint4*>(v_pool + base + c);
      const KT* ke = reinterpret_cast<const KT*>(&kr);
      const KT* ve = reinterpret_cast<const KT*>(&vr);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        k_s[r * ldk + c + j] = smx_to_f32(ke[j]);
        v_s[r * ldv + c + j] = smx_to_f32(ve[j]);
      }
    } else {
      const int d = i % per_row;
      k_s[r * ldk + d] = smx_to_f32(k_pool[base + d]);
      v_s[r * ldv + d] = smx_to_f32(v_pool[base + d]);
    }
  }
}

// Stage rows 0 .. rows-1 of one or two contiguous row-major sources (row
// stride D elements) into shared memory as fp32: row r of a lands at
// a_s[r * ld + d], of b (may be null) at b_s[r * ld + d]. Rows rows ..
// pad_rows-1 are zero-filled, so a partial tile never exposes stale or
// uninitialized shared memory to the products. 16-byte vector loads where
// the width and the sources' alignment allow it, all issued before any is
// used.
template <typename T>
__device__ __forceinline__ void smx_stage_rows(
    const T* __restrict__ a, const T* __restrict__ b, int rows, int pad_rows,
    int D, float* a_s, float* b_s, int ld) {
  constexpr int VEC = 16 / sizeof(T);
  const bool vec =
      D % VEC == 0 && (reinterpret_cast<uintptr_t>(a) |
                       reinterpret_cast<uintptr_t>(b)) % 16 == 0;
  const int per_row = vec ? D / VEC : D;
  for (int i = threadIdx.x; i < rows * per_row; i += blockDim.x) {
    const int r = i / per_row;
    if (vec) {
      const int c = (i % per_row) * VEC;
      const size_t off = static_cast<size_t>(r) * D + c;
      const uint4 aw = *reinterpret_cast<const uint4*>(a + off);
      uint4 bw = aw;
      if (b != nullptr) bw = *reinterpret_cast<const uint4*>(b + off);
      const T* ae = reinterpret_cast<const T*>(&aw);
      const T* be = reinterpret_cast<const T*>(&bw);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        a_s[r * ld + c + j] = smx_to_f32(ae[j]);
        if (b != nullptr) b_s[r * ld + c + j] = smx_to_f32(be[j]);
      }
    } else {
      const int d = i % per_row;
      const size_t off = static_cast<size_t>(r) * D + d;
      a_s[r * ld + d] = smx_to_f32(a[off]);
      if (b != nullptr) b_s[r * ld + d] = smx_to_f32(b[off]);
    }
  }
  for (int i = rows * D + threadIdx.x; i < pad_rows * D; i += blockDim.x) {
    const int r = i / D, d = i % D;
    a_s[r * ld + d] = 0.f;
    if (b != nullptr) b_s[r * ld + d] = 0.f;
  }
}

// The second pass of a split decode: softermax_merge of the partial states
// (m, d, acc) of the S split lanes of each (sequence, KV head) block bh, then
// softermax_finalize (acc / d, d == 0 -> 0) into the output's dtype.
// Layouts: acc_part (B*Hkv, S, G, D), m_part / d_part (B*Hkv, S, G), out
// (B*Hkv, G, D). One block per bh.
template <typename QT>
__global__ void smx_merge_lanes_kernel(const float* __restrict__ acc_part,
                                       const float* __restrict__ m_part,
                                       const float* __restrict__ d_part,
                                       QT* __restrict__ out, int G, int D,
                                       int S, int intmax) {
  const int bh = blockIdx.x;
  for (int i = threadIdx.x; i < G * D; i += blockDim.x) {
    const int g = i / D;
    const int d = i % D;
    float m_star = m_part[(static_cast<size_t>(bh) * S) * G + g];
    for (int s = 1; s < S; ++s)
      m_star = fmaxf(m_star, m_part[(static_cast<size_t>(bh) * S + s) * G + g]);
    float dsum = 0.f;
    float asum = 0.f;
    for (int s = 0; s < S; ++s) {
      const size_t p = static_cast<size_t>(bh) * S + s;
      const float dd = d_part[p * G + g];
      // d == 0 marks the identity state: it drops out exactly
      const float sc = dd > 0.f ? smx_rescale(m_part[p * G + g] - m_star, intmax)
                                : 0.f;
      dsum += dd * sc;
      asum += acc_part[(p * G + g) * D + d] * sc;
    }
    const float o = dsum > 0.f ? asum / dsum : 0.f;
    out[(static_cast<size_t>(bh) * G + g) * D + d] = smx_from_f32<QT>(o);
  }
}

// Set the dynamic shared-memory limit of a kernel once it needs more than
// the 48 KB default.
template <typename K>
static cudaError_t smx_smem_limit(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}
