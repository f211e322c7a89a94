// Bit-faithful fixed-point Softermax (Hopper, sm_90a) with the paper's
// Table-I formats, VectorSize 16:
//
//   Q(6,2) input -> IntMax -> LPW 2^x to Q(1,15) -> Q(10,6) PowSum with
//   shift renormalization per 16-wide slice -> LPW reciprocal Q(1,7)
//   -> Q(1,7) output
//
// Replaces the Pallas TPU kernel softermax_quant_rows
// (src/repro/kernels/softermax_quant/softermax_quant.py:67, body
// _quant_kernel); its step-for-step PyTorch mirror is
// repro_torch/kernels/softermax_quant/plain.py, which this kernel equals
// bit for bit. f32 or bf16 rows in (computed in fp32), the same dtype out;
// a row is padded to a multiple of 16 with the Q(6,2) minimum, -32.
//
// Bound on this card: bytes. Each element costs ~60 simple operations in
// two passes, under the bytes of reading and writing it at the H100's
// compute/bandwidth ridge. The design keeps every value on the reference's
// grid and reads the row from device memory once:
//  * one warp owns one row; lane i of a round owns slice base + i (16
//    elements, 16-byte loads), so a round covers 32 slices;
//  * lanes compute their slices' IntMax, the running max after their slice
//    (a warp prefix max carried across rounds) and their local sums
//    sum LPW(x - m_running) in parallel: the Q(1,15) numerators are dyadic
//    with at most 20 significant bits in a slice's sum, so the fp32 sums
//    are exact in any order;
//  * the PowSum carry d = Q(10,6)(d * 2^(m - m_new) + local_d) rounds at
//    every slice and is not associative, so it walks the slices in order
//    (every lane runs the same 32 steps on shuffled values): no split-K,
//    no tree merge;
//  * nothing is skipped: masked scores (NEG_INF, clipped to -32) and pad
//    columns enter PowSum exactly as in the reference;
//  * rounding: rintf (half to even, as torch.round and jnp.round), every
//    product feeding a sum through __fmul_rn/__fadd_rn (no FMA
//    contraction: m*u + c and d*shift + local_d round twice in the
//    reference), the leading-one position by ilogbf (exact, where a log2
//    may be an ulp off), shifts by exponent adds (exact);
//  * the second pass re-reads the row (L1/L2) and recomputes each
//    numerator against the final max, as _quant_kernel does; the output is
//    on the Q(1,7) grid, exact in bf16.
#include "common.cuh"

namespace {

constexpr int WARPS = 8;           // rows per block: one warp each
constexpr int VS = 16;             // the hardware's VectorSize

// Table I
constexpr float INP_MIN = -32.f, INP_MAX = 31.75f, INP_SCALE = 4.f;
constexpr float UN_MAX = 2.f - 0x1p-15f, UN_SCALE = 32768.f;
constexpr float PS_MAX = 1024.f - 0x1p-6f, PS_SCALE = 64.f;
constexpr float R_MAX = 2.f - 0x1p-7f, R_SCALE = 128.f;

// quantize_exact: clip, round half to even on the grid (the scalings by
// scale and 1 / scale are exact: powers of two)
__device__ __forceinline__ float q_round(float x, float lo, float hi,
                                         float scale) {
  x = fminf(fmaxf(x, lo), hi);
  return rintf(x * scale) * (1.f / scale);
}

// the float32 values of the reference's float64 LUTs (repro core.quant)
__device__ __forceinline__ float exp2_c(int s) {
  return s == 0 ? 0x1p+0f : s == 1 ? 0x1.307p+0f : s == 2 ? 0x1.6a0ap+0f
                                                          : 0x1.ae8ap+0f;
}
__device__ __forceinline__ float exp2_m(int s) {
  return s == 0 ? 0x1.838p-3f : s == 1 ? 0x1.ccdp-3f : s == 2 ? 0x1.12p-2f
                                                             : 0x1.45d8p-2f;
}
__device__ __forceinline__ float recip_c(int s) {
  return s == 0 ? 0x1p+0f : s == 1 ? 0x1.99999ap-1f : s == 2 ? 0x1.555556p-1f
                                                             : 0x1.24924ap-1f;
}
__device__ __forceinline__ float recip_m(int s) {
  return s == 0 ? -0x1.99999ap-3f : s == 1 ? -0x1.111112p-3f
                 : s == 2 ? -0x1.861862p-4f : -0x1.24924ap-4f;
}

// lpw_exp2 to Q(1,15) for t <= 0: t = ip + fr, LPW of 2^fr, times 2^ip
// (ip clamped at -40; lpw in [1, 2), so an exponent add is exact)
__device__ __forceinline__ float lpw_exp2_q15(float t) {
  float ip = floorf(t);
  const float xs = (t - ip) * 4.f;
  const int seg = min(max(static_cast<int>(xs), 0), 3);
  const float u = xs - static_cast<float>(seg);
  const float lpw = __fadd_rn(__fmul_rn(exp2_m(seg), u), exp2_c(seg));
  ip = fmaxf(ip, -40.f);
  const float val =
      __int_as_float(__float_as_int(lpw) + (static_cast<int>(ip) << 23));
  return q_round(val, 0.f, UN_MAX, UN_SCALE);
}

// lpw_reciprocal to Q(1,7) mantissa, un-shifted exactly; 0 for d <= 0
__device__ __forceinline__ float lpw_recip_q7(float d) {
  const float safe = fmaxf(d, 0x1p-20f);
  const int e = ilogbf(safe);                     // floor(log2(safe))
  const float mant = ldexpf(safe, -e);            // in [1, 2)
  const float xs = (mant - 1.f) * 4.f;
  const int seg = min(max(static_cast<int>(xs), 0), 3);
  const float u = xs - static_cast<float>(seg);
  const float r = __fadd_rn(__fmul_rn(recip_m(seg), u), recip_c(seg));
  const float val = ldexpf(q_round(r, 0.f, R_MAX, R_SCALE), -e);
  return d > 0.f ? val : 0.f;
}

// The 16 Q(6,2) inputs of slice s (pad columns at and past V hold -32).
template <typename T>
__device__ __forceinline__ void load_slice(const T* xr, int s, int V,
                                           bool vec, float* xq) {
  const int c0 = s * VS;
  if (vec && c0 + VS <= V) {
    constexpr int PER = 16 / sizeof(T);
#pragma unroll
    for (int w = 0; w < VS / PER; ++w) {
      const uint4 raw = *reinterpret_cast<const uint4*>(xr + c0 + w * PER);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < PER; ++j)
        xq[w * PER + j] =
            q_round(smx_to_f32(e[j]), INP_MIN, INP_MAX, INP_SCALE);
    }
  } else {
#pragma unroll
    for (int j = 0; j < VS; ++j)
      xq[j] = c0 + j < V ? q_round(smx_to_f32(xr[c0 + j]), INP_MIN, INP_MAX,
                                   INP_SCALE)
                         : INP_MIN;
  }
}

template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
    softermax_quant_kernel(const T* __restrict__ x, T* __restrict__ out,
                           int rows, int V) {
  const int lane = threadIdx.x % 32;
  const long long row =
      static_cast<long long>(blockIdx.x) * WARPS + threadIdx.x / 32;
  if (row >= rows) return;
  const T* xr = x + row * V;
  T* orow = out + row * V;
  const bool vec = V % (16 / sizeof(T)) == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int n_slices = (V + VS - 1) / VS;

  // pass 1: running IntMax and the sequential PowSum carry
  float m = INP_MIN, d = 0.f;
  for (int base = 0; base < n_slices; base += 32) {
    const int s = base + lane;
    float xq[VS];
    float lm = INP_MIN;                // neutral: every max is >= -32
    if (s < n_slices) {
      load_slice(xr, s, V, vec, xq);
#pragma unroll
      for (int j = 0; j < VS; ++j) lm = fmaxf(lm, ceilf(xq[j]));
    }
    // running max after slice s: inclusive prefix max over the round's
    // lanes, on top of the carried m
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float o = __shfl_up_sync(0xffffffffu, lm, off);
      if (lane >= off) lm = fmaxf(lm, o);
    }
    const float m_new = fmaxf(m, lm);
    float m_prev = __shfl_up_sync(0xffffffffu, m_new, 1);
    if (lane == 0) m_prev = m;
    float local_d = 0.f;               // exact: a sum of dyadic values
    if (s < n_slices) {
#pragma unroll
      for (int j = 0; j < VS; ++j) local_d += lpw_exp2_q15(xq[j] - m_new);
    }
    const int n = min(32, n_slices - base);
    for (int i = 0; i < n; ++i) {      // the carry, slice by slice
      const float mi = __shfl_sync(0xffffffffu, m_new, i);
      const float mp = __shfl_sync(0xffffffffu, m_prev, i);
      const float li = __shfl_sync(0xffffffffu, local_d, i);
      const float shifted = ldexpf(d, static_cast<int>(mp - mi));
      d = q_round(__fadd_rn(shifted, li), 0.f, PS_MAX, PS_SCALE);
    }
    m = __shfl_sync(0xffffffffu, m_new, 31);
  }

  // pass 2: the Normalization Unit against the final max
  const float recip = lpw_recip_q7(d);
  for (int c = lane; c < V; c += 32) {
    const float xq = q_round(smx_to_f32(xr[c]), INP_MIN, INP_MAX, INP_SCALE);
    const float un = lpw_exp2_q15(xq - m);
    const float y = d > 0.f ? q_round(un * recip, 0.f, R_MAX, R_SCALE) : 0.f;
    orow[c] = smx_from_f32<T>(y);
  }
}

template <typename T>
cudaError_t launch_quant(const void* x, void* out, int rows, int V,
                         cudaStream_t st) {
  const int blocks = (rows + WARPS - 1) / WARPS;
  softermax_quant_kernel<T><<<blocks, WARPS * 32, 0, st>>>(
      static_cast<const T*>(x), static_cast<T*>(out), rows, V);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes). x, out: (rows, V) contiguous,
// dtype SMX_F32 | SMX_BF16. Returns cudaGetLastError() after the launch.
extern "C" int smx_softermax_quant(const void* x, void* out, int rows, int V,
                                   int dtype, void* stream) {
  if (rows <= 0 || V <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == SMX_F32) return launch_quant<float>(x, out, rows, V, st);
  if (dtype == SMX_BF16)
    return launch_quant<__nv_bfloat16>(x, out, rows, V, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
