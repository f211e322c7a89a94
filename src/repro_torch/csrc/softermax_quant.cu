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
// Bound on this card: bytes (~20 simple operations per element on the
// register route, ~60 on the two-pass route, both under the bytes of
// reading and writing it at the H100's compute/bandwidth ridge). Two
// routes, chosen by the row length (kernels/softermax_quant/ops.py::
// register_route): rows of up to REG_CAP values take the register kernel,
// which reads the row once; longer rows the two-pass kernel, which reads
// it twice. Both keep every value on the reference's grid:
//  * one warp owns one row;
//  * the PowSum carry d = Q(10,6)(d * 2^(m - m_new) + local_d) rounds at
//    every slice and is not associative, so it walks the slices in order
//    (every lane runs the same steps): no split-K, no tree merge; the local
//    sums sum LPW(x - m_running) are exact in f32 in any order (the Q(1,15)
//    numerators are dyadic, at most 20 significant bits in a slice's sum);
//  * nothing is skipped: masked scores (NEG_INF, clipped to -32) and pad
//    columns enter PowSum exactly as in the reference;
//  * rounding: half to even (rintf, or the sum with 1.5 * 2^23 or 2^23 that
//    leaves the integer in the low mantissa bits; torch.round and
//    jnp.round), no FMA contraction where the reference rounds twice, and
//    exact shifts by exponent adds.
//
// The register kernel (softermax_quant_reg_kernel) reads the row once, with
// 16-byte loads (lane l's load j holds columns (32 j + l) W .. + W - 1, so
// a 16-wide slice spans 16 / W lanes), and keeps it in registers:
//  * a Q(6,2) score is k / 4 for an integer k in [-128, 127] and the running
//    max m is an integer, so the numerator LPW(k / 4 - m) has a closed form:
//    Q15(c[k & 3] * 2^((k >> 2) - m)) (the LPW slope term is 0 on the Q(6,2)
//    grid; plain.py::lpw_numerator). Each value is kept as the f32 bits of
//    c[k & 3] * 2^(15 + (k >> 2)), built once from k (the four c LUT
//    entries picked by one byte permute); against any max m, the bits minus
//    m << 23 are the numerator times 2^15 before its rounding, and one add
//    of 2^23 rounds it: 3 operations per value in pass 1, 6 in pass 2;
//  * pass 1 takes the slice maxima (ceil of the slice's largest Q(6,2)
//    score), the warp's inclusive prefix max over the slices on top of the
//    carried max, and each slice's local sum as an integer in units of
//    2^-15; a slice's carry step (the shift 2^(m_prev - m_new) from exponent
//    bits, the local sum times 64) goes to shared memory, and the warp walks
//    the steps in order on d * 64: min(rint(fma(D, shift, 64 local_d)),
//    65535) (the clip to an integer commutes with the rounding), one fused
//    multiply-add being exact where the reference rounds twice (d * shift
//    is exact). The walk is a chain of dependent steps, so each step is
//    kept short: rint as two adds of 1.5 * 2^23 on the FMA pipe, the loop
//    unrolled (with rintf and a rolled loop the kernel took longer,
//    PERF.md);
//  * pass 2 computes the numerators against the final max from the same
//    registers, times the LPW reciprocal, rounds to Q(1,7) and writes with
//    16-byte stores.
// The two-pass kernel (softermax_quant_kernel) takes rows of any length:
// lane i of a round owns slice base + i (16 elements, 16-byte loads), so a
// round covers 32 slices; it computes every numerator with the LPW unit
// (lpw_exp2_q15) and shuffles the carry's operands slice by slice; its
// second pass re-reads the row (L1/L2) and recomputes each numerator
// against the final max, as _quant_kernel does. The output is on the
// Q(1,7) grid, exact in bf16.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int WARPS = 8;           // rows per block: one warp each
constexpr int VS = 16;             // the hardware's VectorSize
constexpr int REG_CAP = 2048;      // longest row the register kernel holds

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

// ---- the register kernel -------------------------------------------------

// 1.5 * 2^23: a float in [2^23, 2^24) holds an integer in its low mantissa
// bits, so adding it rounds half to even and leaves k in the low bits.
constexpr float ROUND_MAGIC = 0x1.8p23f;
constexpr uint32_t ROUND_BITS = 0x4B400000u;      // its bits
constexpr uint32_t DEAD_BITS = 0x20000000u;       // 2^-63: rounds to 0
// The mantissa bits of the exp2 c LUT (Q(1,15) values in [1, 2), the low
// byte 0), 16 bits each: entries 0, 1 in C_LO, 2, 3 in C_HI.
constexpr uint32_t C_LO = 0x18380000u, C_HI = 0x57453505u;

// From w, the bits of 1.5 * 2^23 + k (k a Q(6,2) score times 4): the f32
// bits of c[k & 3] * 2^(15 + (k >> 2)). c's mantissa by a byte permute
// (selector nibbles 0, 2s, 2s + 1, 0), the exponent by an add: (w & ~3)
// << 21 is (k >> 2) << 23 modulo 2^32.
__device__ __forceinline__ uint32_t numer_bits(uint32_t w) {
  const uint32_t mant = __byte_perm(C_LO, C_HI, (w & 3u) * 544u + 256u);
  return mant + ((w & ~3u) << 21) + (0x3F800000u + (15u << 23));
}

// 2^23 + U, U = Q15(numerator) * 2^15 against the max m: the kept bits
// minus m << 23 are the numerator times 2^15 before its rounding.
__device__ __forceinline__ float numer_rounded(uint32_t bits, uint32_t m23) {
  return __fadd_rn(__uint_as_float(bits - m23), 0x1p23f);
}

// W: values a load takes (16 bytes' worth, or 1); N: loads a lane holds,
// so N * W * 32 >= V. Lane l's load j holds columns (32 j + l) W .. + W - 1.
template <typename T, int W, int N>
__global__ void __launch_bounds__(WARPS * 32)
    softermax_quant_reg_kernel(const T* __restrict__ x, T* __restrict__ out,
                               int rows, int V) {
  using Load = typename std::conditional<W == 1, T, uint4>::type;
  constexpr int L = VS / W;                 // lanes a slice spans
  constexpr int S = 32 / L;                 // slices a load covers
  __shared__ float2 walk_s[WARPS][REG_CAP / VS];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const long long row = static_cast<long long>(blockIdx.x) * WARPS + warp;
  if (row >= rows) return;
  const Load* xr = reinterpret_cast<const Load*>(x + row * V);
  Load* orow = reinterpret_cast<Load*>(out + row * V);
  const int n_loads = V / W;                // W divides V on this route
  const int n_slices = (V + VS - 1) / VS;
  float2* walk = walk_s[warp];

  Load raw[N];
#pragma unroll
  for (int j = 0; j < N; ++j)
    raw[j] = j * 32 + lane < n_loads ? xr[j * 32 + lane] : Load();

  // pass 1: the kept bits, the slice maxima, the running max and the local
  // sums; each slice's carry step into shared memory
  uint32_t bits[N][W];
  int m_carry = static_cast<int>(INP_MIN);
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const T* v = reinterpret_cast<const T*>(&raw[j]);
    float mx = INP_MIN;
#pragma unroll
    for (int i = 0; i < W; ++i) {
      const int c = (j * 32 + lane) * W + i;
      // pad columns (V .. the slice's end) hold -32; past the last slice,
      // nothing: their numerators round to 0 and -32 is the max's identity
      const float xc = c < V ? fminf(fmaxf(smx_to_f32(v[i]), INP_MIN),
                                     INP_MAX)
                             : INP_MIN;
      mx = fmaxf(mx, xc);
      const uint32_t w = __float_as_uint(fmaf(xc, INP_SCALE, ROUND_MAGIC));
      bits[j][i] = c < n_slices * VS ? numer_bits(w) : DEAD_BITS;
    }
    // the slice max ceil(k_max / 4), then the inclusive prefix over the
    // load's slices, on top of the carried max
    int sm = (static_cast<int>(
                  __float_as_uint(fmaf(mx, INP_SCALE, ROUND_MAGIC)) -
                  ROUND_BITS) + 3) >> 2;
#pragma unroll
    for (int off = 1; off < L; off <<= 1)
      sm = max(sm, __shfl_xor_sync(0xffffffffu, sm, off));
#pragma unroll
    for (int off = L; off < 32; off <<= 1) {
      const int o = __shfl_up_sync(0xffffffffu, sm, off);
      if (lane >= off) sm = max(sm, o);
    }
    // (the shuffles read the load's own prefix, so the loads' scans run
    // side by side; only the cheap max chain carries across loads)
    const int before = __shfl_up_sync(0xffffffffu, sm, L);
    const int total = __shfl_sync(0xffffffffu, sm, 31);
    const int m_new = max(m_carry, sm);
    const int m_prev = lane < L ? m_carry : max(m_carry, before);
    m_carry = max(m_carry, total);
    // the local sum, an integer in units of 2^-15 (the 2^23 of each
    // rounded term cancels modulo 2^32)
    const uint32_t m23 = static_cast<uint32_t>(m_new) << 23;
    uint32_t acc = 0u;
#pragma unroll
    for (int i = 0; i < W; ++i)
      acc += __float_as_uint(numer_rounded(bits[j][i], m23));
    int u = static_cast<int>(acc - W * 0x4B000000u);
#pragma unroll
    for (int off = 1; off < L; off <<= 1)
      u += __shfl_xor_sync(0xffffffffu, u, off);
    const int s = j * S + lane / L;
    if (lane % L == 0 && s < n_slices)
      walk[s] = make_float2(
          __uint_as_float(static_cast<uint32_t>(m_prev - m_new + 127) << 23),
          static_cast<float>(u) * 0x1p-9f);      // 64 * local_d
  }
  __syncwarp();

  // the PowSum carry, slice by slice, on D = 64 d (rint by the 1.5 * 2^23
  // sum: D stays below 2^17)
  float D = 0.f;
#pragma unroll 4
  for (int s = 0; s < n_slices; ++s) {
    const float2 step = walk[s];
    const float r = __fadd_rn(__fadd_rn(fmaf(D, step.x, step.y), ROUND_MAGIC),
                              -ROUND_MAGIC);
    D = fminf(r, PS_MAX * PS_SCALE);
  }

  // pass 2: the Normalization Unit against the final max; z = U * recip *
  // 2^-8 is y * 128 exactly (at most 24 significant bits)
  const float r8 = lpw_recip_q7(D * (1.f / PS_SCALE)) * 0x1p-8f;
  const float mr = -0x1p23f * r8;
  const uint32_t m23 = static_cast<uint32_t>(m_carry) << 23;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    if (j * 32 + lane < n_loads) {
      Load res;
      T* o = reinterpret_cast<T*>(&res);
#pragma unroll
      for (int i = 0; i < W; ++i) {
        const float z = fminf(fmaf(numer_rounded(bits[j][i], m23), r8, mr),
                              R_MAX * R_SCALE);
        const float y = fmaf(__fadd_rn(z, 0x1p23f), 1.f / R_SCALE,
                             -0x1p23f / R_SCALE);
        o[i] = smx_from_f32<T>(y);
      }
      orow[j * 32 + lane] = res;
    }
  }
}

// The smallest N of 1, 2, 4, ... that holds n loads a lane, up to the cap.
template <typename T, int W, int N>
cudaError_t launch_reg_n(const void* x, void* out, int rows, int V, int n,
                         cudaStream_t st) {
  if constexpr (N * W * 32 < REG_CAP) {
    if (n > N) return launch_reg_n<T, W, 2 * N>(x, out, rows, V, n, st);
  }
  const int blocks = (rows + WARPS - 1) / WARPS;
  softermax_quant_reg_kernel<T, W, N><<<blocks, WARPS * 32, 0, st>>>(
      static_cast<const T*>(x), static_cast<T*>(out), rows, V);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_reg(const void* x, void* out, int rows, int V,
                       cudaStream_t st) {
  constexpr int VEC = 16 / sizeof(T);
  const bool vec = V % VEC == 0 &&
                   (reinterpret_cast<uintptr_t>(x) |
                    reinterpret_cast<uintptr_t>(out)) % 16 == 0;
  if (vec)
    return launch_reg_n<T, VEC, 1>(x, out, rows, V, (V / VEC + 31) / 32, st);
  return launch_reg_n<T, 1, 1>(x, out, rows, V, (V + 31) / 32, st);
}

// ---- the two-pass kernel's launch -------------------------------------------

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

// The register route (rows of V <= REG_CAP). Plain C entry point, as
// smx_softermax_quant.
extern "C" int smx_softermax_quant_reg(const void* x, void* out, int rows,
                                       int V, int dtype, void* stream) {
  if (rows <= 0 || V <= 0 || V > REG_CAP)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == SMX_F32) return launch_reg<float>(x, out, rows, V, st);
  if (dtype == SMX_BF16)
    return launch_reg<__nv_bfloat16>(x, out, rows, V, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
