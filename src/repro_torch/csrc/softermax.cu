// Row-wise Softermax (Hopper, sm_90a): the base-2 softmax of each row of a
// (rows, V) matrix with an integer running max (IntMax), or the plain
// base-2 online softmax (intmax == 0).
//
// Replaces the Pallas TPU kernel softermax_rows
// (src/repro/kernels/softermax/softermax.py:81; bodies _unnormed_kernel
// and _normalize_kernel): fp32 math, f32 or bf16 rows in, the same dtype
// out. Two routes, chosen by the row length (kernels/softermax/ops.py::
// register_route): rows of up to REG_CAP values take the register kernel,
// longer rows the two-pass kernel.
//
// Bound on this card: bytes. A row is read and written once with a few
// operations per element (a ceil, a max, an exp2, a multiply), far under
// the H100's compute/bandwidth ridge.
//
// The register kernel (softermax_rows_reg_kernel) reads each row once:
//  * one warp owns one row and holds it in registers, N loads of 16 bytes a
//    lane (or N single values where the row is not a multiple of 16 bytes
//    or not 16-byte aligned), every load issued before any is used;
//  * the lane max, then a warp butterfly; under IntMax the ceil comes after
//    that reduce; one exp2(x - m) per element, kept in registers, and d
//    summed across the warp;
//  * the Normalization Unit multiplies by r = 1/d, rounded once per row
//    (__frcp_rn: within one ulp of the divide), d == 0 -> 0;
//  * slots past the row's end are left out of the max and of d (never
//    filled with NEG_INF: on a fully masked row every real entry is
//    NEG_INF, and a padding NEG_INF would enter d as 2^0 = 1 and spoil the
//    uniform 1/V).
//
// The two-pass kernel (softermax_rows_kernel) takes rows of any length,
// read wide and coalesced:
//  * one warp owns one row; its lanes walk the row in 16-byte loads,
//    neighbouring lanes on neighbouring addresses, and each lane keeps its
//    own running state (m, d): per load, m_new = max(m, ceil(max of the
//    load)), d = d * 2^(m - m_new) + sum 2^(x - m_new);
//  * under IntMax every rescale 2^(m_prev - m_new) has an integer exponent
//    and is built exactly (smx_rescale: an exponent add), so the lanes'
//    states merge exactly in any order (a warp butterfly of shuffles) —
//    what the TPU kernel's sequential grid carries in scratch;
//  * the TPU kernel writes the unnormed 2^(x - m_running) and each block's
//    running max to device memory and reads both back in its normalize
//    pass; here the second pass re-reads the row (from L1/L2: the warp has
//    just read it) and recomputes 2^(x - m) against the final max, so no
//    intermediate goes to device memory;
//  * a fully masked row (every entry NEG_INF) gives the uniform row, as the
//    closed form does (m stays NEG_INF, every 2^(x - m) is 1).
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int WARPS = 8;           // rows per block: one warp each
constexpr int REG_CAP = 2048;      // longest row the register kernel holds

// Fold one group of n values (already fp32) into a lane's running state.
__device__ __forceinline__ void smx_row_update(float& m, float& d,
                                               const float* v, int n,
                                               int intmax) {
  float lm = SMX_NEG_INF;
  for (int j = 0; j < n; ++j) lm = fmaxf(lm, intmax ? ceilf(v[j]) : v[j]);
  const float m_new = fmaxf(m, lm);
  if (m_new > m) d *= smx_rescale(m - m_new, intmax);
  for (int j = 0; j < n; ++j) d += exp2f(v[j] - m_new);
  m = m_new;
}

template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
    softermax_rows_kernel(const T* __restrict__ x, T* __restrict__ out,
                          int rows, int V, int intmax) {
  constexpr int VEC = 16 / sizeof(T);
  const int lane = threadIdx.x % 32;
  const long long row =
      static_cast<long long>(blockIdx.x) * WARPS + threadIdx.x / 32;
  if (row >= rows) return;
  const T* xr = x + row * V;
  T* orow = out + row * V;
  const bool vec = V % VEC == 0 &&
                   (reinterpret_cast<uintptr_t>(x) |
                    reinterpret_cast<uintptr_t>(out)) % 16 == 0;

  // pass 1: each lane's running (m, d) over its share of the row
  float m = SMX_NEG_INF, d = 0.f;
  if (vec) {
#pragma unroll 4
    for (int c = lane * VEC; c < V; c += 32 * VEC) {
      const uint4 raw = *reinterpret_cast<const uint4*>(xr + c);
      const T* e = reinterpret_cast<const T*>(&raw);
      float v[VEC];
#pragma unroll
      for (int j = 0; j < VEC; ++j) v[j] = smx_to_f32(e[j]);
      smx_row_update(m, d, v, VEC, intmax);
    }
  } else {
    for (int c = lane; c < V; c += 32) {
      const float v = smx_to_f32(xr[c]);
      smx_row_update(m, d, &v, 1, intmax);
    }
  }
  // exact merge of the lanes' states; a lane that read nothing holds the
  // identity (NEG_INF, 0) and drops out
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float mo = __shfl_xor_sync(0xffffffffu, m, off);
    const float dn = __shfl_xor_sync(0xffffffffu, d, off);
    const float ms = fmaxf(m, mo);
    d = (d > 0.f ? d * smx_rescale(m - ms, intmax) : 0.f) +
        (dn > 0.f ? dn * smx_rescale(mo - ms, intmax) : 0.f);
    m = ms;
  }

  // pass 2: the Normalization Unit, 2^(x - m) / d (d == 0 -> 0)
  if (vec) {
#pragma unroll 4
    for (int c = lane * VEC; c < V; c += 32 * VEC) {
      const uint4 raw = *reinterpret_cast<const uint4*>(xr + c);
      const T* e = reinterpret_cast<const T*>(&raw);
      uint4 res;
      T* o = reinterpret_cast<T*>(&res);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float y = d > 0.f ? exp2f(smx_to_f32(e[j]) - m) / d : 0.f;
        o[j] = smx_from_f32<T>(y);
      }
      *reinterpret_cast<uint4*>(orow + c) = res;
    }
  } else {
    for (int c = lane; c < V; c += 32) {
      const float y = d > 0.f ? exp2f(smx_to_f32(xr[c]) - m) / d : 0.f;
      orow[c] = smx_from_f32<T>(y);
    }
  }
}

// W: values a load takes (16 bytes' worth, or 1); N: loads a lane holds,
// so N * W * 32 >= V.
template <typename T, int W, int N>
__global__ void __launch_bounds__(WARPS * 32)
    softermax_rows_reg_kernel(const T* __restrict__ x, T* __restrict__ out,
                              int rows, int V, int intmax) {
  using Load = typename std::conditional<W == 1, T, uint4>::type;
  const int lane = threadIdx.x % 32;
  const long long row =
      static_cast<long long>(blockIdx.x) * WARPS + threadIdx.x / 32;
  if (row >= rows) return;
  const Load* xr = reinterpret_cast<const Load*>(x + row * V);
  Load* orow = reinterpret_cast<Load*>(out + row * V);
  const int n_loads = V / W;                 // W divides V on this route

  Load raw[N];
#pragma unroll
  for (int j = 0; j < N; ++j)
    raw[j] = j * 32 + lane < n_loads ? xr[j * 32 + lane] : Load();
  float e[N][W];
  float mx = -INFINITY;                      // padding slots stay out
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const T* v = reinterpret_cast<const T*>(&raw[j]);
#pragma unroll
    for (int i = 0; i < W; ++i) {
      e[j][i] = smx_to_f32(v[i]);
      if (j * 32 + lane < n_loads) mx = fmaxf(mx, e[j][i]);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  if (intmax) mx = ceilf(mx);
  float d = 0.f;
#pragma unroll
  for (int j = 0; j < N; ++j) {
#pragma unroll
    for (int i = 0; i < W; ++i) {
      e[j][i] = j * 32 + lane < n_loads ? exp2f(e[j][i] - mx) : 0.f;
      d += e[j][i];
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    d += __shfl_xor_sync(0xffffffffu, d, off);
  const float r = d > 0.f ? __frcp_rn(d) : 0.f;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    if (j * 32 + lane < n_loads) {
      Load res;
      T* o = reinterpret_cast<T*>(&res);
#pragma unroll
      for (int i = 0; i < W; ++i) o[i] = smx_from_f32<T>(e[j][i] * r);
      orow[j * 32 + lane] = res;
    }
  }
}

// The smallest N of 1, 2, 4, ... that holds n loads a lane, up to the cap.
template <typename T, int W, int N>
cudaError_t launch_reg_n(const void* x, void* out, int rows, int V, int n,
                         int intmax, cudaStream_t st) {
  if constexpr (N * W * 32 < REG_CAP) {
    if (n > N)
      return launch_reg_n<T, W, 2 * N>(x, out, rows, V, n, intmax, st);
  }
  const int blocks = (rows + WARPS - 1) / WARPS;
  softermax_rows_reg_kernel<T, W, N><<<blocks, WARPS * 32, 0, st>>>(
      static_cast<const T*>(x), static_cast<T*>(out), rows, V, intmax);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_reg(const void* x, void* out, int rows, int V,
                       int intmax, cudaStream_t st) {
  constexpr int VEC = 16 / sizeof(T);
  const bool vec = V % VEC == 0 &&
                   (reinterpret_cast<uintptr_t>(x) |
                    reinterpret_cast<uintptr_t>(out)) % 16 == 0;
  if (vec)
    return launch_reg_n<T, VEC, 1>(x, out, rows, V, (V / VEC + 31) / 32,
                                   intmax, st);
  return launch_reg_n<T, 1, 1>(x, out, rows, V, (V + 31) / 32, intmax, st);
}

template <typename T>
cudaError_t launch_rows(const void* x, void* out, int rows, int V,
                        int intmax, cudaStream_t st) {
  const int blocks = (rows + WARPS - 1) / WARPS;
  softermax_rows_kernel<T><<<blocks, WARPS * 32, 0, st>>>(
      static_cast<const T*>(x), static_cast<T*>(out), rows, V, intmax);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes). x, out: (rows, V) contiguous,
// dtype SMX_F32 | SMX_BF16. Returns cudaGetLastError() after the launch.
extern "C" int smx_softermax_rows(const void* x, void* out, int rows, int V,
                                  int dtype, int intmax, void* stream) {
  if (rows <= 0 || V <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == SMX_F32) return launch_rows<float>(x, out, rows, V, intmax, st);
  if (dtype == SMX_BF16)
    return launch_rows<__nv_bfloat16>(x, out, rows, V, intmax, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The register route (rows of V <= REG_CAP). Plain C entry point, as
// smx_softermax_rows.
extern "C" int smx_softermax_rows_reg(const void* x, void* out, int rows,
                                      int V, int dtype, int intmax,
                                      void* stream) {
  if (rows <= 0 || V <= 0 || V > REG_CAP)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == SMX_F32) return launch_reg<float>(x, out, rows, V, intmax, st);
  if (dtype == SMX_BF16)
    return launch_reg<__nv_bfloat16>(x, out, rows, V, intmax, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
