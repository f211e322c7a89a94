// Single-token GQA decode attention over a contiguous KV cache, with
// Softermax: the bulk-copy route (Hopper, sm_90a).
//
// Replaces the Pallas TPU kernel flash_decode
// (src/repro/kernels/flash_decode/flash_decode.py:71, body _decode_kernel)
// wherever a cache row is a multiple of 16 bytes and K and V sit at 16-byte
// aligned addresses (kernels/flash_decode/ops.py::bulk_route); every other
// geometry keeps flash_decode.cu. The function is the same: one pre-scaled
// query token per (sequence, query head) against a (B, Hkv, S, D) cache
// whose first lengths[b] rows are live; fp32 math, output in q's dtype, f32
// or bf16 queries and caches.
//
// Bound on this card: bytes. Each cache row is read once and used for G dot
// products and G rows of A·V, at most 4 FMA per byte at G 8 — far under the
// compute/bandwidth ridge, so no tensor cores. The design keeps enough bytes
// in flight and the CUDA cores out of the loads' way:
//  * one block per (sequence, KV head, split lane) holds all G query heads;
//    the lane's live rows [row0, row_end) are one contiguous span of K and
//    one of V, so each tile of them is a 1-D bulk async copy (cp.async.bulk,
//    no tensor map, marked evict-first in L2) into a ring of NSTAGE stages
//    in the cache's own dtype, issued by one producer thread and completed
//    on mbarriers; exactly the live rows are copied, none at or past
//    lengths[b];
//  * the ring holds 48 KB a block and an SM runs two or three blocks: more
//    than the ~32 KB an SM must keep in flight to reach 3.35 TB/s at ~1 us
//    of latency (Little's law over 132 SMs); a deeper ring measured slower;
//  * four consumer warps take each tile's rows in steps. Lanes lie along D:
//    a lane holds 8 values of a row, so lpr lanes cover a row and a warp
//    step reads 32 / lpr whole rows, 512 contiguous bytes; q and the
//    accumulator stay in registers as f32, and a score is summed across
//    its row's lanes with shuffles, one level at a time for all of the
//    tile's scores together; the walk has no branch (rows past the tile's
//    end are read as its last row and get p = 0);
//  * per tile and warp (rows r): s = q·K_r, m_new = max(m, ceil(max_r s))
//    (IntMax: ceil after the reduce), alpha = 2^(m - m_new) exact
//    (smx_rescale, applied only where the max moved), p = 2^(s - m_new),
//    d = d*alpha + sum(p), acc = acc*alpha + sum_r p·V_r;
//  * the split lanes merge in the same launch: each block writes its state
//    (m, d, acc), then the last block of its pair to finish — told by an
//    atomic ticket taken after a fence — merges all of them in lane order
//    0..n-1 and normalizes (acc / d, d == 0 -> 0), so the result does not
//    depend on the order of arrival. It sets the ticket back to 0, so the
//    scratch needs no clearing between launches.
#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int GMAX = 8;              // largest GQA group
constexpr int NWARP = 4;             // consumer warps
constexpr int THREADS = 32 * (NWARP + 1);   // + one producer warp
constexpr int NSTAGE = 3;
constexpr int TILE_STEPS = 4;        // warp steps a tile at a chunk a lane
constexpr int TILE_BYTES = NWARP * 32 * 16 * TILE_STEPS;   // of K, at most
constexpr int SMEM = NSTAGE * 2 * TILE_BYTES;

// 16-byte chunks a lane holds of a row: 8 values, so q and acc take 16 G
// registers (a row of D <= 256 needs at most 32 lanes). Three blocks run on
// an SM up to G 5 (128 registers a thread), two above.
__host__ __device__ constexpr int chunks_per_lane(int elem) {
  return elem / 2;
}

__host__ __device__ constexpr int blocks_per_sm(int G) {
  return G <= 5 ? 3 : 2;
}

// How the consumers lay a row of `chunks` 16-byte chunks over a warp: lpr
// lanes (a power of two, <= 32) a row, cpl chunks a lane (chunk li + c*lpr
// of lane li), rpw rows a warp step, TILE_STEPS / cpl steps a tile of NWARP
// warps: a tile is at most TILE_BYTES. Mirrored by kernels/flash_decode/ops.py.
struct RowGeom {
  int chunks, lpr, rpw, tile;
};

__host__ __device__ inline RowGeom row_geom(int D, int elem, int cpl) {
  RowGeom g;
  g.chunks = D * elem / 16;
  g.lpr = 1;
  while (g.lpr * cpl < g.chunks) g.lpr <<= 1;
  g.rpw = 32 / g.lpr;
  g.tile = NWARP * g.rpw * (TILE_STEPS / cpl);
  return g;
}

__device__ __forceinline__ float load_q(const void* q, int bf16, size_t i) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(q)[i])
              : static_cast<const float*>(q)[i];
}

__device__ __forceinline__ void store_out(void* out, int bf16, size_t i,
                                          float x) {
  if (bf16)
    static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(x);
  else
    static_cast<float*>(out)[i] = x;
}

// G: the GQA group; CPL: 16-byte chunks a lane holds of a row
// (chunks_per_lane).
template <typename KT, int G, int CPL>
__global__ void __launch_bounds__(THREADS, blocks_per_sm(G))
    decode_bulk_kernel(
    const void* __restrict__ q,        // (B*Hkv, G, D), f32 or bf16
    const KT* __restrict__ k,          // (B*Hkv, S, D)
    const KT* __restrict__ v,
    const int* __restrict__ lengths,   // (B,)
    float* __restrict__ acc_part,      // (B*Hkv, n_split, G, D)
    float* __restrict__ m_part,        // (B*Hkv, n_split, G)
    float* __restrict__ d_part,        // (B*Hkv, n_split, G)
    int* __restrict__ tickets,         // (B*Hkv,), 0 between launches
    void* __restrict__ out,            // (B*Hkv, G, D) in q's dtype
    int q_bf16, int Hkv, int S, int D, int lane_rows, int n_split,
    int intmax) {
  constexpr int VEC = 16 / sizeof(KT);
  constexpr int NV = CPL * VEC;        // values a lane holds of a row
  constexpr int NST = TILE_STEPS / CPL; // warp steps a tile
  extern __shared__ __align__(128) uint8_t ring[];
  __shared__ uint64_t full[NSTAGE], empty[NSTAGE];
  __shared__ float wm_s[NWARP * G], wd_s[NWARP * G], gm_s[G], gd_s[G];
  __shared__ int last_s;
  float* wacc_s = reinterpret_cast<float*>(ring);   // after the walk

  const RowGeom rg = row_geom(D, sizeof(KT), CPL);
  const int bh = blockIdx.x;
  const int lane_s = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int row0 = lane_s * lane_rows;
  const int row_end = min(row0 + lane_rows, min(lengths[bh / Hkv], S));
  const int n_tiles =
      row_end > row0 ? (row_end - row0 + rg.tile - 1) / rg.tile : 0;
  const size_t row_bytes = static_cast<size_t>(D) * sizeof(KT);
  const uint8_t* kb =
      reinterpret_cast<const uint8_t*>(k) + static_cast<size_t>(bh) * S *
      row_bytes;
  const uint8_t* vb =
      reinterpret_cast<const uint8_t*>(v) + static_cast<size_t>(bh) * S *
      row_bytes;

  // the consumers' state; the producer warp leaves it alone
  const int grp = lane / rg.lpr;             // this lane's row of a step
  const int li = lane % rg.lpr;
  float qv[G][NV], acc[G][NV], m[G], dl[G];

  if (tid == 0) {
    for (int s = 0; s < NSTAGE; ++s) {
      hop_mbar_init(&full[s], 1);
      hop_mbar_init(&empty[s], NWARP);
    }
    hop_mbar_init_fence();
  }
  __syncthreads();

  if (warp == NWARP) {
    // the producer: keep the ring full, a stage refilled once every
    // consumer warp has released it
    if (lane == 0) {
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % NSTAGE;
        if (t >= NSTAGE) hop_mbar_wait(&empty[s], (t / NSTAGE - 1) & 1);
        const int r = row0 + t * rg.tile;
        const uint32_t bytes =
            static_cast<uint32_t>(min(rg.tile, row_end - r) * row_bytes);
        uint8_t* dst = ring + s * 2 * TILE_BYTES;
        hop_mbar_expect_tx(&full[s], 2 * bytes);
        hop_bulk_load(dst, kb + r * row_bytes, bytes, &full[s]);
        hop_bulk_load(dst + TILE_BYTES, vb + r * row_bytes, bytes,
                      &full[s]);
      }
    }
    __syncwarp();
  } else {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      m[g] = SMX_NEG_INF;
      dl[g] = 0.f;                           // this lane's row group's d
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        const int chunk = li + c * rg.lpr;
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          qv[g][c * VEC + e] =
              chunk < rg.chunks
                  ? load_q(q, q_bf16, (static_cast<size_t>(bh) * G + g) * D +
                                          chunk * VEC + e)
                  : 0.f;
          acc[g][c * VEC + e] = 0.f;
        }
      }
    }
    // A lane reads chunk min(li + c*lpr, chunks - 1) of row min(r, nrows - 1)
    // of the tile: always a copied row, and no branch in the walk. A chunk
    // past the row's end meets q = 0 and its acc is never written; a row
    // past the tile's end gets p = 0.
    int coff[CPL];
#pragma unroll
    for (int c = 0; c < CPL; ++c)
      coff[c] = min(li + c * rg.lpr, rg.chunks - 1) * 16;

    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % NSTAGE;
      hop_mbar_wait(&full[s], (t / NSTAGE) & 1);
      const uint8_t* ks = ring + s * 2 * TILE_BYTES;
      const uint8_t* vs = ks + TILE_BYTES;
      const int nrows = min(rg.tile, row_end - (row0 + t * rg.tile));
      bool valid[NST];
      int roff[NST];                         // within the stage
#pragma unroll
      for (int j = 0; j < NST; ++j) {
        const int r = (j * NWARP + warp) * rg.rpw + grp;
        valid[j] = r < nrows;
        roff[j] = min(r, nrows - 1) * D * static_cast<int>(sizeof(KT));
      }

      // scores of this warp's rows, summed across each row's lanes
      float p[NST][G];
#pragma unroll
      for (int j = 0; j < NST; ++j) {
#pragma unroll
        for (int g = 0; g < G; ++g) p[j][g] = 0.f;
#pragma unroll
        for (int c = 0; c < CPL; ++c) {
          const uint4 w =
              *reinterpret_cast<const uint4*>(ks + roff[j] + coff[c]);
          const KT* ke = reinterpret_cast<const KT*>(&w);
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            const float kv = smx_to_f32(ke[e]);
#pragma unroll
            for (int g = 0; g < G; ++g) p[j][g] += qv[g][c * VEC + e] * kv;
          }
        }
      }
      // summed across each row's lanes: a level at a time, every value of
      // the level issued together
      for (int o = rg.lpr >> 1; o > 0; o >>= 1) {
#pragma unroll
        for (int j = 0; j < NST; ++j)
#pragma unroll
          for (int g = 0; g < G; ++g)
            p[j][g] += __shfl_xor_sync(0xffffffffu, p[j][g], o);
      }

      // IntMax over the warp's rows of the tile (ceil after the reduce),
      // exact rescale where the max moved (warp-uniform), p
      float mx[G];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        mx[g] = SMX_NEG_INF;
#pragma unroll
        for (int j = 0; j < NST; ++j)
          mx[g] = fmaxf(mx[g], valid[j] ? p[j][g] : SMX_NEG_INF);
      }
      for (int o = 16; o >= rg.lpr; o >>= 1) {
#pragma unroll
        for (int g = 0; g < G; ++g)
          mx[g] = fmaxf(mx[g], __shfl_xor_sync(0xffffffffu, mx[g], o));
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float m_new = fmaxf(m[g], intmax ? ceilf(mx[g]) : mx[g]);
        if (m_new != m[g]) {
          const float alpha = smx_rescale(m[g] - m_new, intmax);
          dl[g] *= alpha;
#pragma unroll
          for (int i = 0; i < NV; ++i) acc[g][i] *= alpha;
          m[g] = m_new;
        }
#pragma unroll
        for (int j = 0; j < NST; ++j) {
          p[j][g] = valid[j] ? exp2f(p[j][g] - m[g]) : 0.f;
          dl[g] += p[j][g];
        }
      }

      // acc += sum_r p_r · V_r over this lane's chunks
#pragma unroll
      for (int j = 0; j < NST; ++j) {
#pragma unroll
        for (int c = 0; c < CPL; ++c) {
          const uint4 w =
              *reinterpret_cast<const uint4*>(vs + roff[j] + coff[c]);
          const KT* ve = reinterpret_cast<const KT*>(&w);
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            const float vv = smx_to_f32(ve[e]);
#pragma unroll
            for (int g = 0; g < G; ++g)
              acc[g][c * VEC + e] += p[j][g] * vv;
          }
        }
      }
      __syncwarp();
      if (lane == 0) hop_mbar_arrive(&empty[s]);
    }

    // the warp's rows share m: their d and acc add up, a level at a time
    for (int o = 16; o >= rg.lpr; o >>= 1) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        dl[g] += __shfl_xor_sync(0xffffffffu, dl[g], o);
#pragma unroll
        for (int i = 0; i < NV; ++i)
          acc[g][i] += __shfl_xor_sync(0xffffffffu, acc[g][i], o);
      }
    }
  }
  // every warp is done with the ring before it takes the warps' states
  __syncthreads();
  if (warp < NWARP) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (lane == 0) {
        wm_s[warp * G + g] = m[g];
        wd_s[warp * G + g] = dl[g];
      }
      if (grp == 0) {
#pragma unroll
        for (int c = 0; c < CPL; ++c) {
          const int chunk = li + c * rg.lpr;
          if (chunk < rg.chunks) {
#pragma unroll
            for (int e = 0; e < VEC; ++e)
              wacc_s[(warp * G + g) * D + chunk * VEC + e] =
                  acc[g][c * VEC + e];
          }
        }
      }
    }
  }
  __syncthreads();

  // the exact merge of the warps: each query head's factors once (a warp
  // that read no row holds the identity and drops out exactly), then this
  // lane's state (m, d, acc)
  if (tid < G) {
    float m_star = wm_s[tid];
    for (int w = 1; w < NWARP; ++w) m_star = fmaxf(m_star, wm_s[w * G + tid]);
    float dsum = 0.f;
    for (int w = 0; w < NWARP; ++w) {
      const float dw = wd_s[w * G + tid];
      const float sc =
          dw > 0.f ? smx_rescale(wm_s[w * G + tid] - m_star, intmax) : 0.f;
      dsum += dw * sc;
      wd_s[w * G + tid] = sc;
    }
    gm_s[tid] = m_star;
    gd_s[tid] = dsum;
  }
  __syncthreads();
  const size_t part = static_cast<size_t>(bh) * n_split + lane_s;
  for (int i = tid; i < G * D; i += THREADS) {
    const int g = i / D;
    float asum = 0.f;
#pragma unroll
    for (int w = 0; w < NWARP; ++w)
      asum += wacc_s[w * G * D + i] * wd_s[w * G + g];
    if (n_split == 1)
      store_out(out, q_bf16, static_cast<size_t>(bh) * G * D + i,
                gd_s[g] > 0.f ? asum / gd_s[g] : 0.f);
    else
      acc_part[part * G * D + i] = asum;
  }
  if (tid < G && n_split > 1) {
    m_part[part * G + tid] = gm_s[tid];
    d_part[part * G + tid] = gd_s[tid];
  }
  if (n_split == 1) return;

  // the last lane of the pair to finish merges them all, in lane order
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const int prev = atomicAdd(&tickets[bh], 1);
    last_s = prev == n_split - 1;
    if (last_s) tickets[bh] = 0;             // ready for the next launch
  }
  __syncthreads();
  if (!last_s) return;
  __threadfence();
  // the first PRE lanes' acc of this thread's first columns, loaded while
  // the lanes' (m, d) come into the ring and each query head's merge
  // factors and d are summed in lane order
  constexpr int PRE = 8;
  const size_t p0 = static_cast<size_t>(bh) * n_split;
  const int nvec = G * D / 4;                // D is a multiple of 4 here
  const float4* acc4 = reinterpret_cast<const float4*>(acc_part);
  float4 pre[PRE];
#pragma unroll
  for (int s = 0; s < PRE; ++s)
    if (s < n_split && tid < nvec)
      pre[s] = __ldcg(&acc4[(p0 + s) * nvec + tid]);
  float* lm_s = reinterpret_cast<float*>(ring);   // n_split x G: m
  float* lf_s = lm_s + n_split * G;               // d, then the factors
  float* dsum_s = lf_s + n_split * G;             // G
  for (int i = tid; i < n_split * G; i += THREADS) {
    lm_s[i] = __ldcg(&m_part[p0 * G + i]);
    lf_s[i] = __ldcg(&d_part[p0 * G + i]);
  }
  __syncthreads();
  if (tid < G) {
    float m_star = lm_s[tid];
    for (int s = 1; s < n_split; ++s)
      m_star = fmaxf(m_star, lm_s[s * G + tid]);
    float dsum = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const float dd = lf_s[s * G + tid];
      // d == 0 marks the identity state: it drops out exactly
      const float sc =
          dd > 0.f ? smx_rescale(lm_s[s * G + tid] - m_star, intmax) : 0.f;
      dsum += dd * sc;
      lf_s[s * G + tid] = sc;
    }
    dsum_s[tid] = dsum;
  }
  __syncthreads();
  for (int i = tid; i < nvec; i += THREADS) {
    const int g = 4 * i / D;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    auto add = [&](const float4& x, int s) {
      const float sc = lf_s[s * G + g];
      a.x += x.x * sc;
      a.y += x.y * sc;
      a.z += x.z * sc;
      a.w += x.w * sc;
    };
#pragma unroll
    for (int s = 0; s < PRE; ++s)
      if (s < n_split)
        add(i == tid ? pre[s] : __ldcg(&acc4[(p0 + s) * nvec + i]), s);
    for (int s = PRE; s < n_split; ++s)
      add(__ldcg(&acc4[(p0 + s) * nvec + i]), s);
    const float dsum = dsum_s[g];
    const size_t o = static_cast<size_t>(bh) * G * D + 4 * i;
    store_out(out, q_bf16, o, dsum > 0.f ? a.x / dsum : 0.f);
    store_out(out, q_bf16, o + 1, dsum > 0.f ? a.y / dsum : 0.f);
    store_out(out, q_bf16, o + 2, dsum > 0.f ? a.z / dsum : 0.f);
    store_out(out, q_bf16, o + 3, dsum > 0.f ? a.w / dsum : 0.f);
  }
}

template <typename KT, int G>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* lengths, void* acc_part, void* m_part,
                   void* d_part, void* tickets, void* out, int q_bf16, int B,
                   int Hkv, int S, int D, int lane_rows, int n_split,
                   int intmax, cudaStream_t stream) {
  auto kern = decode_bulk_kernel<KT, G, chunks_per_lane(sizeof(KT))>;
  // the ring and the static shared memory pass the 48 KB default
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return err;
  kern<<<dim3(B * Hkv, n_split), THREADS, SMEM, stream>>>(
      q, static_cast<const KT*>(k), static_cast<const KT*>(v),
      static_cast<const int*>(lengths), static_cast<float*>(acc_part),
      static_cast<float*>(m_part), static_cast<float*>(d_part),
      static_cast<int*>(tickets), out, q_bf16, Hkv, S, D, lane_rows,
      n_split, intmax);
  return cudaGetLastError();
}

template <typename KT>
cudaError_t launch_g(int G, const void* q, const void* k, const void* v,
                     const void* lengths, void* acc_part, void* m_part,
                     void* d_part, void* tickets, void* out, int q_bf16,
                     int B, int Hkv, int S, int D, int lane_rows,
                     int n_split, int intmax, cudaStream_t st) {
#define SMX_ARGS q, k, v, lengths, acc_part, m_part, d_part, tickets, out, \
    q_bf16, B, Hkv, S, D, lane_rows, n_split, intmax, st
  switch (G) {
    case 1: return launch<KT, 1>(SMX_ARGS);
    case 2: return launch<KT, 2>(SMX_ARGS);
    case 3: return launch<KT, 3>(SMX_ARGS);
    case 4: return launch<KT, 4>(SMX_ARGS);
    case 5: return launch<KT, 5>(SMX_ARGS);
    case 6: return launch<KT, 6>(SMX_ARGS);
    case 7: return launch<KT, 7>(SMX_ARGS);
    default: return launch<KT, 8>(SMX_ARGS);
  }
#undef SMX_ARGS
}

}  // namespace

// Rows of one tile of this route at head dim D and cache element size
// `elem` bytes (the wrapper cuts the split lanes in whole tiles).
extern "C" int smx_decode_bulk_tile(int D, int elem) {
  return row_geom(D, elem, chunks_per_lane(elem)).tile;
}

// Plain C entry point (loaded with ctypes). q_dtype, kv_dtype: SMX_F32 |
// SMX_BF16. The cache rows are cut into n_split lanes of lane_rows rows
// (n_split * lane_rows >= S); acc/m/d hold the lanes' states, tickets
// (B*Hkv ints) must be 0 and are 0 again after the launch. Returns
// cudaGetLastError() after the launch.
extern "C" int smx_decode_bulk(const void* q, const void* k, const void* v,
                               const void* lengths, void* acc_part,
                               void* m_part, void* d_part, void* tickets,
                               void* out, int B, int Hq, int Hkv, int S,
                               int D, int lane_rows, int n_split,
                               int q_dtype, int kv_dtype, int intmax,
                               void* stream) {
  const int elem = kv_dtype == SMX_F32 ? 4 : kv_dtype == SMX_BF16 ? 2 : 0;
  if (B <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Hq / Hkv > GMAX || D <= 0 ||
      D > 256 || elem == 0 || D * elem % 16 != 0 ||
      (q_dtype != SMX_F32 && q_dtype != SMX_BF16) || lane_rows <= 0 ||
      n_split <= 0 || static_cast<long long>(lane_rows) * n_split < S ||
      (2 * n_split + 1) * GMAX * 4 > SMEM ||
      (reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v)) %
              16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int G = Hq / Hkv;
  const int q_bf16 = q_dtype == SMX_BF16;
#define SMX_ARGS G, q, k, v, lengths, acc_part, m_part, d_part, tickets, out, \
    q_bf16, B, Hkv, S, D, lane_rows, n_split, intmax, st
  const cudaError_t err = elem == 2 ? launch_g<__nv_bfloat16>(SMX_ARGS)
                                    : launch_g<float>(SMX_ARGS);
#undef SMX_ARGS
  return static_cast<int>(err);
}
