// The bulk-copy walk of paged single-token decode with Softermax (Hopper,
// sm_90a), shared by the grouped kernel's route (flash_decode_paged_bulk.cu,
// K1) and the per-query-head kernel's route
// (flash_decode_paged_single_bulk.cu, K8). Each .cu instantiates it in its
// own translation unit (the anonymous namespace keeps the copies apart).
//
// A block owns GB query heads of one sequence that share a KV head: K1 a
// whole GQA group (GB = G), K8 one query head (GB = 1, every head of a
// group reading the group's K/V for itself). A block's split lane walks
// whole pool blocks of the row's LIVE blocks (ceil(len / BS), at most the
// table width): no table entry at or past them is read.
//  * The pool is (N, Hkv, BS, D), so each (pool block, KV head) of K or V is
//    one contiguous span of BS·D elements, and of an int8 pool's scales one
//    of BS floats: the producer warp reads the lane's slice of the block
//    table 32 entries at a time (the next 32 in flight behind them) and
//    issues one 1-D cp.async.bulk per span (no tensor map, evict-first in
//    L2) into a ring of stages of T pool blocks, completed on mbarriers.
//  * Four consumer warps take the stages in turn (stage t to warp t % 4),
//    each walking a whole stage and releasing it alone: a warp's chain of
//    loads, shuffles, max and exp per stage is long, so four stages are
//    reduced at once (warps sharing every stage's rows waited that chain
//    out once a stage, and measured slower). Inside a warp the
//    layout is K5's (flash_decode_bulk.cu): lanes lie along D, 8 values a
//    lane, q and the accumulator in f32 registers, each shuffle-reduction
//    level issued for a whole sub-tile of NST warp steps at once. A stage's
//    rows are contiguous in shared memory (its blocks side by side); a step
//    whose rows all lie past the stage's live rows is skipped, its rows get
//    p = 0.
//  * Per sub-tile and warp (rows r): s = q·K_r (times k_scale_r for int8,
//    after the dot), m_new = max(m, ceil(max_r s)) (IntMax: ceil after the
//    reduce), alpha = 2^(m - m_new) exact (smx_rescale, only where the max
//    moved), p = 2^(s - m_new), d = d·alpha + sum p,
//    acc = acc·alpha + sum_r (p·v_scale_r)·V_r. The warps keep private
//    states, merged exactly at the end: no block barrier inside the walk.
//  * Split lanes (K1) merge in the same launch by K5's ticket scheme: the
//    last lane of a pair to finish merges all of them in lane order
//    0..n-1, normalizes (acc / d, d == 0 -> 0) and sets the ticket back to
//    0. A lane with no live block holds the identity (NEG_INF, 0, 0), so a
//    row of length 0 comes out exactly 0.
#pragma once

#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int PDB_NWARP = 4;                        // consumer warps
constexpr int PDB_THREADS = 32 * (PDB_NWARP + 1);   // + one producer warp
constexpr int PDB_NSTAGE_MAX = 8;
constexpr int PDB_NV = 8;                           // values a lane holds
constexpr int PDB_MAX_LANES = 256;                  // split lanes a pair
// A block's shared memory on Hopper (227 KB) less a reserve for the
// kernel's static arrays: the most dynamic shared memory a launch asks for.
constexpr size_t PDB_SMEM_MAX = 227 * 1024 - 1024;

__host__ __device__ constexpr int pdb_blocks_per_sm(int GB) {
  return GB <= 5 ? 3 : 2;
}

// Warp steps a sub-tile (a step reads 8 values a lane of each of its
// rows): as many as the registers hold beside q and acc, 16 GB of them.
template <int GB>
__host__ __device__ constexpr int pdb_steps() {
  return GB <= 4 ? 8 : 4;
}

// Bytes of one pool block of one KV head in a stage: K, V and an int8
// pool's two scale rows.
__host__ __device__ inline size_t pdb_block_bytes(int BS, int D, int elem) {
  return 2 * static_cast<size_t>(BS) * D * elem +
         (elem == 1 ? 2 * static_cast<size_t>(BS) * 4 : 0);
}

// The ring: T pool blocks a stage (clamped so a stage for each consumer
// warp fits the budget), as many stages as the budget holds (2, 3, 4 or
// 8), and the dynamic shared memory, which the end of the walk reuses for
// the warps' states and the split lanes' merge.
struct PdbGeom {
  int T, nstage;
  size_t stage_bytes, smem;
};

inline PdbGeom pdb_geom(int GB, int D, int BS, int elem, int T, int n_lanes,
                        size_t ring_budget) {
  PdbGeom g;
  const size_t blk = pdb_block_bytes(BS, D, elem);
  // blocks a stage, so that each consumer warp can hold one
  size_t fit = ring_budget / (PDB_NWARP * blk);
  if (fit < 1) fit = 1;
  g.T = T < 1 ? 1 : T;
  if (static_cast<size_t>(g.T) > fit) g.T = static_cast<int>(fit);
  g.stage_bytes = g.T * blk;
  // 2, 3, 4 or 8 stages: a multiple of the warps that consume them
  const size_t ns = ring_budget / g.stage_bytes;
  g.nstage = ns >= 8 ? 8 : ns >= 4 ? 4 : ns >= 2 ? static_cast<int>(ns) : 2;
  size_t smem = g.nstage * g.stage_bytes;
  const size_t warps = static_cast<size_t>(PDB_NWARP) * GB * D * 4;
  const size_t merge = (2 * static_cast<size_t>(n_lanes) + 1) * GB * 4;
  if (warps > smem) smem = warps;
  if (merge > smem) smem = merge;
  g.smem = smem;
  return g;
}

struct PdbArgs {
  const void* q;               // (B*Hq, D), f32 or bf16
  const void* k_pool;          // (N, Hkv, BS, D)
  const void* v_pool;
  const float* k_scale;        // (N, Hkv, BS), int8 pools only
  const float* v_scale;
  const int* tables;           // (B, W)
  const int* lengths;          // (B,)
  float* acc_part;             // (B*Hblk, n, GB, D); n > 1 only
  float* m_part;               // (B*Hblk, n, GB)
  float* d_part;
  int* tickets;                // (B*Hblk,), 0 between launches
  void* out;                   // (B*Hq, D) in q's dtype
  int q_bf16, Hblk, Hkv, group, BS, D, W, T, nstage, n_lanes, intmax;
  size_t stage_bytes;
};

__device__ __forceinline__ float pdb_load_q(const void* q, int bf16,
                                            size_t i) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(q)[i])
              : static_cast<const float*>(q)[i];
}

__device__ __forceinline__ void pdb_store(void* out, int bf16, size_t i,
                                          float x) {
  if (bf16)
    static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(x);
  else
    static_cast<float*>(out)[i] = x;
}

// 8 consecutive values of a staged row as f32 (one aligned load: D is a
// multiple of 8).
__device__ __forceinline__ void pdb_load8(const float* p, float (&x)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

__device__ __forceinline__ void pdb_load8(const __nv_bfloat16* p,
                                          float (&x)[8]) {
  const uint4 w = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&w);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void pdb_load8(const int8_t* p, float (&x)[8]) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  const int8_t* e = reinterpret_cast<const int8_t*>(&w);
#pragma unroll
  for (int i = 0; i < 8; ++i) x[i] = static_cast<float>(e[i]);
}

template <typename KT, int GB>
__global__ void __launch_bounds__(PDB_THREADS, pdb_blocks_per_sm(GB))
    paged_decode_bulk_kernel(const PdbArgs a) {
  constexpr bool QUANT = sizeof(KT) == 1;
  constexpr int NST = pdb_steps<GB>();
  extern __shared__ __align__(128) uint8_t ring[];
  __shared__ uint64_t full[PDB_NSTAGE_MAX], empty[PDB_NSTAGE_MAX];
  __shared__ float wm_s[PDB_NWARP * GB], wd_s[PDB_NWARP * GB], gm_s[GB],
      gd_s[GB];
  __shared__ int last_s;
  float* wacc_s = reinterpret_cast<float*>(ring);   // after the walk

  const int bh = blockIdx.x;                 // (sequence, head slot)
  const int lane_s = blockIdx.y;             // split lane
  const int b = bh / a.Hblk;
  const int h = (bh % a.Hblk) * GB / a.group;   // the KV head
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int BS = a.BS, D = a.D, T = a.T, nstage = a.nstage;
  const int n_lanes = a.n_lanes;

  // the lane's share of the live blocks: nblk blocks from blk0, lanes
  // differing by at most one block (kernels/flash_decode_paged/ref.py::
  // lane_blocks mirrors it)
  const int len = max(0, min(a.lengths[b], a.W * BS));
  const int nb = (len + BS - 1) / BS;
  const int base = nb / n_lanes, rem = nb % n_lanes;
  const int blk0 = lane_s * base + min(lane_s, rem);
  const int nblk = base + (lane_s < rem ? 1 : 0);
  const int lane_rows = max(0, min((blk0 + nblk) * BS, len) - blk0 * BS);
  const int n_stages = (nblk + T - 1) / T;
  const int stage_rows = T * BS;
  const size_t span = static_cast<size_t>(BS) * D * sizeof(KT);
  const size_t kv_bytes = static_cast<size_t>(T) * span;

  if (tid == 0) {
    for (int s = 0; s < nstage; ++s) {
      hop_mbar_init(&full[s], 1);
      hop_mbar_init(&empty[s], 1);
    }
    hop_mbar_init_fence();
  }
  __syncthreads();

  // the consumers' state; the producer warp leaves it alone
  int lpr = 1;
  while (lpr * PDB_NV < D) lpr <<= 1;
  const int rpw = 32 / lpr;                  // rows a warp step
  const int sub_rows = NST * rpw;
  const int grp = lane / lpr;                // this lane's row of a step
  const int col = (lane % lpr) * PDB_NV;     // its first column
  float qv[GB][PDB_NV], acc[GB][PDB_NV], m[GB], dl[GB];

  if (warp == PDB_NWARP) {
    // the producer: the table slice 32 entries at a time, a stage refilled
    // once every consumer warp has released it
    const int* tbl = a.tables + static_cast<size_t>(b) * a.W + blk0;
    const size_t blk_tx = pdb_block_bytes(BS, D, sizeof(KT));
    const uint8_t* kp = static_cast<const uint8_t*>(a.k_pool);
    const uint8_t* vp = static_cast<const uint8_t*>(a.v_pool);
    int ent = lane < nblk ? tbl[lane] : 0;
    int nxt = 32 + lane < nblk ? tbl[32 + lane] : 0;
    for (int t = 0; t < n_stages; ++t) {
      const int s = t % nstage;
      if (t >= nstage) hop_mbar_wait(&empty[s], (t / nstage - 1) & 1);
      const int i0 = t * T, i1 = min(i0 + T, nblk);
      uint8_t* dst = ring + s * a.stage_bytes;
      if (lane == 0)
        hop_mbar_expect_tx(&full[s], static_cast<uint32_t>((i1 - i0) *
                                                           blk_tx));
      for (int i = i0; i < i1; ++i) {
        if (i > 0 && i % 32 == 0) {          // the next 32 entries
          ent = nxt;
          nxt = i + 32 + lane < nblk ? tbl[i + 32 + lane] : 0;
        }
        const int phys = __shfl_sync(0xffffffffu, ent, i % 32);
        if (lane == 0) {
          const size_t kvh = static_cast<size_t>(phys) * a.Hkv + h;
          const int r = i - i0;
          hop_bulk_load(dst + r * span, kp + kvh * span,
                        static_cast<uint32_t>(span), &full[s]);
          hop_bulk_load(dst + kv_bytes + r * span, vp + kvh * span,
                        static_cast<uint32_t>(span), &full[s]);
          if (QUANT) {
            uint8_t* sc = dst + 2 * kv_bytes + r * BS * 4;
            hop_bulk_load(sc, a.k_scale + kvh * BS,
                          static_cast<uint32_t>(BS * 4), &full[s]);
            hop_bulk_load(sc + stage_rows * 4, a.v_scale + kvh * BS,
                          static_cast<uint32_t>(BS * 4), &full[s]);
          }
        }
      }
    }
    __syncwarp();
  } else {
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      m[g] = SMX_NEG_INF;
      dl[g] = 0.f;                           // this lane's row group's d
#pragma unroll
      for (int e = 0; e < PDB_NV; ++e) {
        qv[g][e] = col < D ? pdb_load_q(a.q, a.q_bf16,
                                        (static_cast<size_t>(bh) * GB + g) *
                                            D + col + e)
                           : 0.f;
        acc[g][e] = 0.f;
      }
    }
    // a lane past the row's end reads the row's last 8 values: q = 0 there
    // and its acc is never written
    const int ccol = min(col, D - PDB_NV);

    // stage t goes to warp t % ncons: a warp waits on a stage only after it
    // consumed the one its slot held before, so a slot's phases cannot
    // alias (nstage is a multiple of ncons)
    const int ncons = min(PDB_NWARP, nstage);
    for (int t = warp; warp < ncons && t < n_stages; t += ncons) {
      const int s = t % nstage;
      hop_mbar_wait(&full[s], (t / nstage) & 1);
      const KT* ks = reinterpret_cast<const KT*>(ring + s * a.stage_bytes);
      const KT* vs = reinterpret_cast<const KT*>(ring + s * a.stage_bytes +
                                                 kv_bytes);
      const float* kss = reinterpret_cast<const float*>(
          ring + s * a.stage_bytes + 2 * kv_bytes);
      const float* vss = kss + stage_rows;
      const int nrows = min(stage_rows, lane_rows - t * stage_rows);
      for (int r0 = 0; r0 < nrows; r0 += sub_rows) {
        const int left = nrows - r0;
        bool valid[NST], any[NST];
        int rr[NST];
#pragma unroll
        for (int j = 0; j < NST; ++j) {
          const int first = j * rpw;
          any[j] = first < left;               // warp-uniform
          valid[j] = first + grp < left;
          rr[j] = r0 + min(first + grp, left - 1);
        }

        // scores of this warp's rows, summed across each row's lanes a
        // level at a time, every value of the level issued together
        float p[NST][GB];
#pragma unroll
        for (int j = 0; j < NST; ++j) {
#pragma unroll
          for (int g = 0; g < GB; ++g) p[j][g] = 0.f;
          if (any[j]) {
            float kv[PDB_NV];
            pdb_load8(ks + static_cast<size_t>(rr[j]) * D + ccol, kv);
#pragma unroll
            for (int e = 0; e < PDB_NV; ++e)
#pragma unroll
              for (int g = 0; g < GB; ++g) p[j][g] += qv[g][e] * kv[e];
          }
        }
        for (int o = lpr >> 1; o > 0; o >>= 1) {
#pragma unroll
          for (int j = 0; j < NST; ++j)
#pragma unroll
            for (int g = 0; g < GB; ++g)
              p[j][g] += __shfl_xor_sync(0xffffffffu, p[j][g], o);
        }
        if (QUANT) {                         // dequantize after the dot
#pragma unroll
          for (int j = 0; j < NST; ++j) {
            const float sc = kss[rr[j]];
#pragma unroll
            for (int g = 0; g < GB; ++g) p[j][g] *= sc;
          }
        }

        // IntMax over the warp's rows (ceil after the reduce), the exact
        // rescale where the max moved (warp-uniform), p
        float mx[GB];
#pragma unroll
        for (int g = 0; g < GB; ++g) {
          mx[g] = SMX_NEG_INF;
#pragma unroll
          for (int j = 0; j < NST; ++j)
            mx[g] = fmaxf(mx[g], valid[j] ? p[j][g] : SMX_NEG_INF);
        }
        for (int o = 16; o >= lpr; o >>= 1) {
#pragma unroll
          for (int g = 0; g < GB; ++g)
            mx[g] = fmaxf(mx[g], __shfl_xor_sync(0xffffffffu, mx[g], o));
        }
#pragma unroll
        for (int g = 0; g < GB; ++g) {
          const float m_new = fmaxf(m[g], a.intmax ? ceilf(mx[g]) : mx[g]);
          if (m_new != m[g]) {
            const float alpha = smx_rescale(m[g] - m_new, a.intmax);
            dl[g] *= alpha;
#pragma unroll
            for (int e = 0; e < PDB_NV; ++e) acc[g][e] *= alpha;
            m[g] = m_new;
          }
#pragma unroll
          for (int j = 0; j < NST; ++j) {
            p[j][g] = valid[j] ? exp2f(p[j][g] - m[g]) : 0.f;
            dl[g] += p[j][g];                // d sums p, not p·v_scale
          }
        }

        // acc += sum_r (p_r·v_scale_r)·V_r over this lane's columns
#pragma unroll
        for (int j = 0; j < NST; ++j) {
          if (any[j]) {
            float vv[PDB_NV];
            pdb_load8(vs + static_cast<size_t>(rr[j]) * D + ccol, vv);
            const float w = QUANT ? vss[rr[j]] : 1.f;
#pragma unroll
            for (int g = 0; g < GB; ++g) {
              const float pw = p[j][g] * w;
#pragma unroll
              for (int e = 0; e < PDB_NV; ++e) acc[g][e] += pw * vv[e];
            }
          }
        }
      }
      __syncwarp();
      if (lane == 0) hop_mbar_arrive(&empty[s]);
    }

    // the warp's row groups share m: their d and acc add up
    for (int o = 16; o >= lpr; o >>= 1) {
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        dl[g] += __shfl_xor_sync(0xffffffffu, dl[g], o);
#pragma unroll
        for (int e = 0; e < PDB_NV; ++e)
          acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], o);
      }
    }
  }
  // every warp is done with the ring before it takes the warps' states
  __syncthreads();
  if (warp < PDB_NWARP) {
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      if (lane == 0) {
        wm_s[warp * GB + g] = m[g];
        wd_s[warp * GB + g] = dl[g];
      }
      if (grp == 0 && col < D) {
#pragma unroll
        for (int e = 0; e < PDB_NV; ++e)
          wacc_s[(warp * GB + g) * D + col + e] = acc[g][e];
      }
    }
  }
  __syncthreads();

  // the exact merge of the warps: each query head's factors once (a warp
  // that read no row holds the identity and drops out exactly)
  if (tid < GB) {
    float m_star = wm_s[tid];
    for (int w = 1; w < PDB_NWARP; ++w)
      m_star = fmaxf(m_star, wm_s[w * GB + tid]);
    float dsum = 0.f;
    for (int w = 0; w < PDB_NWARP; ++w) {
      const float dw = wd_s[w * GB + tid];
      const float sc =
          dw > 0.f ? smx_rescale(wm_s[w * GB + tid] - m_star, a.intmax) : 0.f;
      dsum += dw * sc;
      wd_s[w * GB + tid] = sc;
    }
    gm_s[tid] = m_star;
    gd_s[tid] = dsum;
  }
  __syncthreads();
  const size_t part = static_cast<size_t>(bh) * n_lanes + lane_s;
  for (int i = tid; i < GB * D; i += PDB_THREADS) {
    const int g = i / D;
    float asum = 0.f;
#pragma unroll
    for (int w = 0; w < PDB_NWARP; ++w)
      asum += wacc_s[w * GB * D + i] * wd_s[w * GB + g];
    if (n_lanes == 1)
      pdb_store(a.out, a.q_bf16, static_cast<size_t>(bh) * GB * D + i,
                gd_s[g] > 0.f ? asum / gd_s[g] : 0.f);
    else
      a.acc_part[part * GB * D + i] = asum;
  }
  if (n_lanes == 1) return;
  if (tid < GB) {
    a.m_part[part * GB + tid] = gm_s[tid];
    a.d_part[part * GB + tid] = gd_s[tid];
  }

  // the last lane of the pair to finish merges them all, in lane order
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const int prev = atomicAdd(&a.tickets[bh], 1);
    last_s = prev == n_lanes - 1;
    if (last_s) a.tickets[bh] = 0;           // ready for the next launch
  }
  __syncthreads();
  if (!last_s) return;
  __threadfence();
  const size_t p0 = static_cast<size_t>(bh) * n_lanes;
  const int nvec = GB * D / 4;               // D is a multiple of 8 here
  const float4* acc4 = reinterpret_cast<const float4*>(a.acc_part);
  float* lm_s = reinterpret_cast<float*>(ring);   // n x GB: m
  float* lf_s = lm_s + n_lanes * GB;              // d, then the factors
  float* dsum_s = lf_s + n_lanes * GB;            // GB
  for (int i = tid; i < n_lanes * GB; i += PDB_THREADS) {
    lm_s[i] = __ldcg(&a.m_part[p0 * GB + i]);
    lf_s[i] = __ldcg(&a.d_part[p0 * GB + i]);
  }
  __syncthreads();
  if (tid < GB) {
    float m_star = lm_s[tid];
    for (int s = 1; s < n_lanes; ++s)
      m_star = fmaxf(m_star, lm_s[s * GB + tid]);
    float dsum = 0.f;
    for (int s = 0; s < n_lanes; ++s) {
      const float dd = lf_s[s * GB + tid];
      // d == 0 marks the identity state: it drops out exactly
      const float sc =
          dd > 0.f ? smx_rescale(lm_s[s * GB + tid] - m_star, a.intmax) : 0.f;
      dsum += dd * sc;
      lf_s[s * GB + tid] = sc;
    }
    dsum_s[tid] = dsum;
  }
  __syncthreads();
  for (int i = tid; i < nvec; i += PDB_THREADS) {
    const int g = 4 * i / D;
    float4 acc4s = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s = 0; s < n_lanes; ++s) {
      const float sc = lf_s[s * GB + g];
      if (sc == 0.f) continue;               // an identity lane
      const float4 x = __ldcg(&acc4[(p0 + s) * nvec + i]);
      acc4s.x += x.x * sc;
      acc4s.y += x.y * sc;
      acc4s.z += x.z * sc;
      acc4s.w += x.w * sc;
    }
    const float dsum = dsum_s[g];
    const size_t o = static_cast<size_t>(bh) * GB * D + 4 * i;
    pdb_store(a.out, a.q_bf16, o, dsum > 0.f ? acc4s.x / dsum : 0.f);
    pdb_store(a.out, a.q_bf16, o + 1, dsum > 0.f ? acc4s.y / dsum : 0.f);
    pdb_store(a.out, a.q_bf16, o + 2, dsum > 0.f ? acc4s.z / dsum : 0.f);
    pdb_store(a.out, a.q_bf16, o + 3, dsum > 0.f ? acc4s.w / dsum : 0.f);
  }
}

// Set an instantiation's dynamic shared-memory limit, once per device.
template <typename KT, int GB>
cudaError_t pdb_prepare() {
  static unsigned done = 0;                  // a bit per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 32 && (done >> dev & 1u))) return err;
  err = cudaFuncSetAttribute(paged_decode_bulk_kernel<KT, GB>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(PDB_SMEM_MAX));
  if (err == cudaSuccess && dev < 32) done |= 1u << dev;
  return err;
}

// Launch one instantiation on `grid`.
template <typename KT, int GB>
cudaError_t pdb_launch(const PdbArgs& a, dim3 grid, size_t smem,
                       cudaStream_t stream) {
  cudaError_t err = pdb_prepare<KT, GB>();
  if (err != cudaSuccess) return err;
  paged_decode_bulk_kernel<KT, GB><<<grid, PDB_THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

// Blocks of one instantiation the current device holds at once at `smem`
// bytes of dynamic shared memory: the occupancy of the compiled kernel
// (registers, launch bounds, shared memory) times the SM count.
template <typename KT, int GB>
cudaError_t pdb_resident(size_t smem, int* blocks) {
  cudaError_t err = pdb_prepare<KT, GB>();
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, paged_decode_bulk_kernel<KT, GB>, PDB_THREADS, smem);
  *blocks = sms * per_sm;
  return err;
}

// The same two, for the pool's element type.
template <int GB>
cudaError_t pdb_launch_kv(int kv_dtype, const PdbArgs& a, dim3 grid,
                          size_t smem, cudaStream_t stream) {
  switch (kv_dtype) {
    case SMX_F32: return pdb_launch<float, GB>(a, grid, smem, stream);
    case SMX_BF16: return pdb_launch<__nv_bfloat16, GB>(a, grid, smem, stream);
    case SMX_I8: return pdb_launch<int8_t, GB>(a, grid, smem, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <int GB>
cudaError_t pdb_resident_kv(int kv_dtype, size_t smem, int* blocks) {
  switch (kv_dtype) {
    case SMX_F32: return pdb_resident<float, GB>(smem, blocks);
    case SMX_BF16: return pdb_resident<__nv_bfloat16, GB>(smem, blocks);
    case SMX_I8: return pdb_resident<int8_t, GB>(smem, blocks);
    default: return cudaErrorInvalidValue;
  }
}

// Calls f(std::integral_constant<int, G>()) for a GQA group G of 1..8.
template <typename F>
cudaError_t pdb_by_group(int G, F&& f) {
  switch (G) {
    case 1: return f(std::integral_constant<int, 1>());
    case 2: return f(std::integral_constant<int, 2>());
    case 3: return f(std::integral_constant<int, 3>());
    case 4: return f(std::integral_constant<int, 4>());
    case 5: return f(std::integral_constant<int, 5>());
    case 6: return f(std::integral_constant<int, 6>());
    case 7: return f(std::integral_constant<int, 7>());
    default: return f(std::integral_constant<int, 8>());
  }
}

inline int pdb_elem(int kv_dtype) {
  return kv_dtype == SMX_F32 ? 4 : kv_dtype == SMX_BF16 ? 2
                                 : kv_dtype == SMX_I8 ? 1 : 0;
}

// The checks both entry points make before a launch: dtypes, D a multiple
// of 8 up to 256, 16-byte spans and 16-byte-aligned pools and scales.
inline bool pdb_operands_ok(const void* k_pool, const void* v_pool,
                            const void* k_scale, const void* v_scale,
                            int Hq, int Hkv, int D, int BS, int W,
                            int q_dtype, int kv_dtype) {
  const int elem = pdb_elem(kv_dtype);
  const bool quant = kv_dtype == SMX_I8;
  return elem != 0 && (q_dtype == SMX_F32 || q_dtype == SMX_BF16) &&
         Hkv > 0 && Hq % Hkv == 0 && D > 0 && D <= 256 && D % 8 == 0 &&
         BS > 0 && W > 0 && static_cast<size_t>(BS) * D * elem % 16 == 0 &&
         (!quant || BS * 4 % 16 == 0) &&
         quant == (k_scale != nullptr && v_scale != nullptr) &&
         (reinterpret_cast<uintptr_t>(k_pool) |
          reinterpret_cast<uintptr_t>(v_pool) |
          reinterpret_cast<uintptr_t>(k_scale) |
          reinterpret_cast<uintptr_t>(v_scale)) % 16 == 0;
}

}  // namespace
