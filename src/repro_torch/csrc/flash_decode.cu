// Single-token GQA decode attention over a contiguous KV cache, with
// Softermax (Hopper, sm_90a).
//
// Replaces the Pallas TPU kernel flash_decode
// (src/repro/kernels/flash_decode/flash_decode.py:71, body _decode_kernel):
// one pre-scaled query token per (sequence, query head) against a
// (B, Hkv, S, D) cache whose first lengths[b] rows are live; fp32 math
// throughout (p included), output in q's dtype, f32 or bf16 caches.
//
// Bound on this card: bytes. Each cache row is read once and used for G dot
// products of length D and G rows of A·V, ~G/2 FLOP per byte in bf16 — two
// orders of magnitude under the H100's compute/bandwidth ridge. The design
// spends nothing on tensor cores; it reads the cache once, in place, with
// enough blocks in flight:
//  * the TPU grid (B*Hq, kv_blocks) fetches each K/V block once per query
//    head of a group, G times; here one block owns a (sequence, KV head)
//    pair and all G query heads, so each row is read once;
//  * B*Hkv pairs alone fill under half of the 132 SMs at batch 8, so the
//    rows are cut into split lanes of lane_rows rows, one block each, and
//    inside a block four warps walk interleaved 32-row chunks, each with its
//    own running (m, d, acc) and no block barrier inside the walk;
//  * the cache is read where it lies: no padded copy (the TPU wrapper pads K
//    and V to a block multiple on every call), no row at or past lengths[b]
//    is read, and the partial chunk is masked with the finite NEG_INF;
//  * in a chunk each lane owns one row: it reads the K and V rows with
//    16-byte loads, computes its G scores against q in shared memory
//    (broadcast reads) and stages the V row in shared memory for the A·V
//    pass, where lanes own strided output columns.
//
// Per chunk (rows r): s = q·K_r, m_new = max(m, ceil(max_r s)), alpha =
// 2^(m - m_new) (exact under IntMax: smx_rescale), p = 2^(s - m_new),
// d = d*alpha + sum(p), acc = acc*alpha + sum_r p·V_r. The warps merge
// exactly at the end of the walk (a warp that read no row holds the merge
// identity (NEG_INF, 0, 0) and drops out), and smx_merge_lanes_kernel merges
// the split lanes and normalizes (acc / d, d == 0 -> 0).
#include "common.cuh"

namespace {

constexpr int GMAX = 8;            // largest GQA group the kernel holds
constexpr int NWARP = 4;
constexpr int THREADS = 32 * NWARP;

// Shared memory of one block, in floats. The warps' final acc reuses the
// staged-V region once every warp has finished its walk (G <= 32 rows).
__host__ __device__ inline size_t decode_smem_floats(int G, int D) {
  return static_cast<size_t>(G) * D +                  // q
         static_cast<size_t>(NWARP) * 32 * (D + 1) +   // staged V rows
         2 * NWARP * G;                                // warp m, d
}

// DPL: output columns per lane (D <= 32 * DPL).
template <typename QT, typename KT, int DPL>
__global__ void __launch_bounds__(THREADS) decode_kernel(
    const QT* __restrict__ q,          // (B*Hkv, G, D)
    const KT* __restrict__ k,          // (B*Hkv, S, D)
    const KT* __restrict__ v,
    const int* __restrict__ lengths,   // (B,)
    float* __restrict__ acc_part,      // (B*Hkv, n_split, G, D)
    float* __restrict__ m_part,        // (B*Hkv, n_split, G)
    float* __restrict__ d_part,        // (B*Hkv, n_split, G)
    int Hkv, int G, int S, int D, int lane_rows, int n_split, int intmax) {
  extern __shared__ float smem[];
  const int DP = D + 1;                       // padded V row stride
  float* q_s = smem;                          // G x D
  float* v_all = q_s + G * D;                 // NWARP x 32 x DP
  float* wm_s = v_all + NWARP * 32 * DP;      // NWARP x G
  float* wd_s = wm_s + NWARP * G;             // NWARP x G
  float* wacc_s = v_all;                      // NWARP x G x D, after the walk

  const int bh = blockIdx.x;
  const int lane_s = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int row0 = lane_s * lane_rows;        // first cache row of the lane
  const int row_end = min(row0 + lane_rows, min(lengths[bh / Hkv], S));
  const KT* kb = k + static_cast<size_t>(bh) * S * D;
  const KT* vb = v + static_cast<size_t>(bh) * S * D;

  for (int i = tid; i < G * D; i += blockDim.x)
    q_s[i] = smx_to_f32(q[static_cast<size_t>(bh) * G * D + i]);
  __syncthreads();

  constexpr int VEC = 16 / sizeof(KT);
  const bool vec = D % VEC == 0 &&
                   (reinterpret_cast<uintptr_t>(k) |
                    reinterpret_cast<uintptr_t>(v)) % 16 == 0;
  float* v_s = v_all + warp * 32 * DP;
  float m[GMAX], dl[GMAX], acc[GMAX][DPL];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    m[g] = SMX_NEG_INF;
    dl[g] = 0.f;                              // this lane's share of d
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[g][i] = 0.f;
  }

  for (int c0 = row0 + warp * 32; c0 < row_end; c0 += NWARP * 32) {
    const int r = c0 + lane;                  // this lane's cache row
    const bool valid = r < row_end;
    float s[GMAX];
#pragma unroll
    for (int g = 0; g < GMAX; ++g) s[g] = 0.f;
    if (valid) {
      const KT* kr = kb + static_cast<size_t>(r) * D;
      const KT* vr = vb + static_cast<size_t>(r) * D;
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
    }
    __syncwarp();

    // IntMax over the chunk (ceil after the reduce), exact rescale, p
    float pv[GMAX];
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      pv[g] = 0.f;
      if (g < G) {
        const float sg = valid ? s[g] : SMX_NEG_INF;
        float mx = sg;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        const float m_new = fmaxf(m[g], intmax ? ceilf(mx) : mx);
        const float alpha = smx_rescale(m[g] - m_new, intmax);
        const float p = valid ? exp2f(sg - m_new) : 0.f;
        dl[g] = dl[g] * alpha + p;
        pv[g] = p;
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc[g][i] *= alpha;
        m[g] = m_new;
      }
    }

    // acc += sum_r p_r · V_r; lanes own columns lane + 32i
    const int nrows = min(32, row_end - c0);
    for (int rr = 0; rr < nrows; ++rr) {
      float vv[DPL];
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int d = lane + 32 * i;
        vv[i] = d < D ? v_s[rr * DP + d] : 0.f;
      }
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        if (g < G) {
          const float pr = __shfl_sync(0xffffffffu, pv[g], rr);
#pragma unroll
          for (int i = 0; i < DPL; ++i) acc[g][i] += pr * vv[i];
        }
      }
    }
    __syncwarp();                             // v_s is rewritten next chunk
  }

  // every warp is done with its staged V rows: the region takes the warps'
  // states, then the exact merge of the warps
  __syncthreads();
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
      for (int i = 0; i < DPL; ++i) {
        const int d = lane + 32 * i;
        if (d < D) wacc_s[(warp * G + g) * D + d] = acc[g][i];
      }
    }
  }
  __syncthreads();
  const size_t part = static_cast<size_t>(bh) * n_split + lane_s;
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

size_t decode_smem(int G, int D) {
  return sizeof(float) * decode_smem_floats(G, D);
}

template <typename QT, typename KT, int DPL>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* lengths, void* acc_part, void* m_part,
                   void* d_part, void* out, int B, int Hq, int Hkv, int S,
                   int D, int lane_rows, int n_split, int intmax,
                   cudaStream_t stream) {
  const int G = Hq / Hkv;
  const size_t smem = decode_smem(G, D);
  auto kern = decode_kernel<QT, KT, DPL>;
  cudaError_t err = smx_smem_limit(kern, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(B * Hkv, n_split);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(k),
      static_cast<const KT*>(v), static_cast<const int*>(lengths),
      static_cast<float*>(acc_part), static_cast<float*>(m_part),
      static_cast<float*>(d_part), Hkv, G, S, D, lane_rows, n_split, intmax);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  smx_merge_lanes_kernel<QT><<<B * Hkv, THREADS, 0, stream>>>(
      static_cast<const float*>(acc_part), static_cast<const float*>(m_part),
      static_cast<const float*>(d_part), static_cast<QT*>(out), G, D,
      n_split, intmax);
  return cudaGetLastError();
}

template <typename QT, typename KT>
cudaError_t launch_d(const void* q, const void* k, const void* v,
                     const void* lengths, void* acc_part, void* m_part,
                     void* d_part, void* out, int B, int Hq, int Hkv, int S,
                     int D, int lane_rows, int n_split, int intmax,
                     cudaStream_t stream) {
  if (D <= 128)
    return launch<QT, KT, 4>(q, k, v, lengths, acc_part, m_part, d_part, out,
                             B, Hq, Hkv, S, D, lane_rows, n_split, intmax,
                             stream);
  return launch<QT, KT, 8>(q, k, v, lengths, acc_part, m_part, d_part, out, B,
                           Hq, Hkv, S, D, lane_rows, n_split, intmax, stream);
}

}  // namespace

// Dynamic shared memory one decode launch needs (the wrapper checks it
// against the card's per-block limit).
extern "C" long long smx_decode_smem(int G, int D) {
  return static_cast<long long>(decode_smem(G, D));
}

// Plain C entry point (loaded with ctypes). q_dtype, kv_dtype: SMX_F32 |
// SMX_BF16. The cache rows are cut into n_split lanes of lane_rows rows
// (n_split * lane_rows >= S). Returns cudaGetLastError() after the launches.
extern "C" int smx_decode(const void* q, const void* k, const void* v,
                          const void* lengths, void* acc_part, void* m_part,
                          void* d_part, void* out, int B, int Hq, int Hkv,
                          int S, int D, int lane_rows, int n_split,
                          int q_dtype, int kv_dtype, int intmax,
                          void* stream) {
  if (B <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Hq / Hkv > GMAX || D <= 0 ||
      D > 256 || lane_rows <= 0 || n_split <= 0 ||
      static_cast<long long>(lane_rows) * n_split < S)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SMX_ARGS q, k, v, lengths, acc_part, m_part, d_part, out, B, Hq, Hkv, \
    S, D, lane_rows, n_split, intmax, st
  cudaError_t err = cudaErrorInvalidValue;
  if (q_dtype == SMX_F32) {
    if (kv_dtype == SMX_F32) err = launch_d<float, float>(SMX_ARGS);
    else if (kv_dtype == SMX_BF16)
      err = launch_d<float, __nv_bfloat16>(SMX_ARGS);
  } else if (q_dtype == SMX_BF16) {
    if (kv_dtype == SMX_F32) err = launch_d<__nv_bfloat16, float>(SMX_ARGS);
    else if (kv_dtype == SMX_BF16)
      err = launch_d<__nv_bfloat16, __nv_bfloat16>(SMX_ARGS);
  }
#undef SMX_ARGS
  return static_cast<int>(err);
}
