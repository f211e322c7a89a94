// Dense GQA flash-attention backward with Softermax on Hopper's tensor cores
// (sm_90a): the bf16 route of K4.
//
// Replaces the Pallas TPU kernels of flash_attention_bwd
// (src/repro/kernels/flash_attention/flash_backward.py:119; bodies
// _dkv_kernel and _dq_kernel) for bf16 q, k, v, dO with a head dim D that
// is a multiple of 16, up to 128; flash_backward.cu keeps f32 and every
// other D. Same function as flash_backward.cu, with P recomputed from the
// forward's row statistics:
//
//   p_ij  = 2^(s_ij - m_i) / max(d_i, 1e-30)     (0 where masked)
//   dS_ij = ln2 · p_ij · (dP_ij - delta_i),  dP = dO·V^T, delta = Σ dO·O
//   dV_j  = sum_i p_ij dO_i   dK_j = sum_i dS_ij Q_i   dQ_i = sum_j dS_ij K_j
//
// with the forward's masks; dq, dk, dv are written in bf16, dK and dV
// summed over the G query heads of each KV head inside the kernel. The
// reference's two-kernel split is kept: no atomics, deterministic sums.
//
// Bound on this card: operations. s and dP are products of bf16 inputs,
// exact per product in a bf16 wgmma with f32 accumulation. p and dS are f32
// in the reference; they enter the tensor cores only as three bf16 terms
// x = hi + mid + lo, exact (hop_split3): dS has terms of both signs that
// nearly cancel in dK and dQ, where one bf16 rounding (up to 2^-8) would
// show, and so would the pair hi + lo (up to 2^-16, measured beyond the
// bf16 parity gate on a row with 7 visible keys). The tensor cores' f32
// sums are coarser than round-to-nearest (a chain of steps in one
// accumulator drifts; measured beyond the same gate), so nothing
// accumulates there for long: dP,
// which dS reads as dP - delta, is summed one k16 step per fresh
// accumulator on the CUDA cores (dp_steps), and every gradient product goes
// to a fresh accumulator per tile that is added to the sums on the CUDA
// cores. Tensor-core work per visible (query, key) pair: 2·D each for s and
// dP in both kernels and 6·D each for dV, dK and dQ: 26·D against the
// function's 10·D.
//
// dK/dV kernel: grid (B*Hkv, ceil(Sk/128)), KV tile 0 (the longest causal
// walk) first. A block holds 128 K and V rows of one KV head (two consumer
// warpgroups of 64, the wgmma M) and walks the G query heads' 32-row query
// tiles that can see them; a producer warpgroup (its registers given to the
// consumers by setmaxnreg) loads K/V once and the Q/dO tiles by TMA into a
// ring of four stages. Per tile a warpgroup computes S^T = K·Q^T and
// dP^T = V·dO^T (wgmma m64n32k16, K-major), so p^T and dS^T land in
// registers as the A operand of dV += p^T·dO and dK += dS^T·Q (register-A
// wgmma m64n64k16 per 64 output columns, dO and Q MN-major through the
// transpose bit). The rows' m, d, delta come from global memory (L1).
//
// dQ kernel: grid (B*Hq, ceil(Sq/128)), the longest query tiles first. A
// block holds 128 rows of Q and dO of one query head (two warpgroups) and
// walks 64-row K/V tiles up to its diagonal through a two-stage TMA ring:
// S = Q·K^T, dP = dO·V^T (m64n64k16), then dQ += dS·K with K MN-major. TMA
// zero-fills rows past Sq or Sk and columns past D; such entries are masked
// to p = 0 exactly.
#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int CONSUMERS = 2;              // consumer warpgroups
constexpr int THREADS = CONSUMERS * 128 + 128;   // + the producer warpgroup
// registers per thread: the producer's give the consumers 232 each
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr float LN2 = 0.69314718055994530942f;

// dK/dV kernel: 128 KV rows per block, 32 query rows per step
constexpr int KV_ROWS = 64 * CONSUMERS;
constexpr int BQ = 32;
constexpr int DKV_STAGES = 4;

template <int DP>
struct DkvSmem {
  static constexpr int PANELS = DP / 64;
  static constexpr int PANEL_KV = KV_ROWS * 128;
  static constexpr int PANEL_Q = BQ * 128;
  static constexpr int K = 0;
  static constexpr int V = PANELS * PANEL_KV;
  static constexpr int QD = 2 * PANELS * PANEL_KV;     // STAGES x (Q, dO)
  static constexpr int STAGE = 2 * PANELS * PANEL_Q;
  static constexpr int BAR = QD + DKV_STAGES * STAGE;
  static constexpr int BYTES = BAR + 8 * (1 + 2 * DKV_STAGES) + 1024;
};

// dQ kernel: 128 query rows per block, 64 KV rows per tile
constexpr int Q_ROWS = 64 * CONSUMERS;
constexpr int BN = 64;
constexpr int DQ_STAGES = 2;

template <int DP>
struct DqSmem {
  static constexpr int PANELS = DP / 64;
  static constexpr int PANEL_Q = Q_ROWS * 128;
  static constexpr int PANEL_KV = BN * 128;
  static constexpr int Q = 0;
  static constexpr int DO = PANELS * PANEL_Q;
  static constexpr int KV = 2 * PANELS * PANEL_Q;      // STAGES x (K, V)
  static constexpr int STAGE = 2 * PANELS * PANEL_KV;
  static constexpr int BAR = KV + DQ_STAGES * STAGE;
  static constexpr int BYTES = BAR + 8 * (1 + 2 * DQ_STAGES) + 1024;
};

__device__ __forceinline__ void init_barriers(uint64_t* once, uint64_t* full,
                                              uint64_t* empty, int stages) {
  if (threadIdx.x == 0) {
    hop_mbar_init(once, 1);
    for (int s = 0; s < stages; ++s) {
      hop_mbar_init(&full[s], 1);
      hop_mbar_init(&empty[s], CONSUMERS * 4);   // lane 0 of each warp
    }
    hop_mbar_init_fence();
  }
  __syncthreads();
}

// dP = A·B^T (m64 x nN, both K-major, the reduction over DP columns), one
// k16 step at a time into a fresh accumulator, the steps summed on the CUDA
// cores. dS reads dP - delta, which cancels to ~0 where a row's p sits on
// one key; a chain of steps in one tensor-core accumulator drifts (its f32
// sums are coarser than round-to-nearest) by several times the error of an
// fp32 sum, which missed the bf16 gate at elements whose true value is 0.
// Two accumulators alternate, so a step runs while the last one is added.
// Waits for every committed group.
template <int N, int DP, int PANEL_A, int PANEL_B>
__device__ __forceinline__ void dp_steps(float (&dp)[N / 2],
                                         const uint8_t* a_s,
                                         const uint8_t* b_s) {
  float t[2][N / 2];
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const int col = (kk % 4) * 32;
    hop_wgmma_fence();
    HopMma<N>::ss(t[kk % 2],
                  hop_desc(a_s + (kk / 4) * PANEL_A + col, 16, 1024),
                  hop_desc(b_s + (kk / 4) * PANEL_B + col, 16, 1024), 0);
    hop_wgmma_commit();
    if (kk > 0) {
      hop_wgmma_wait<1>();
      hop_fence_regs(t[(kk - 1) % 2]);
#pragma unroll
      for (int i = 0; i < N / 2; ++i)
        dp[i] = kk == 1 ? t[0][i] : dp[i] + t[(kk - 1) % 2][i];
    }
  }
  hop_wgmma_wait<0>();
  hop_fence_regs(t[(DP / 16 - 1) % 2]);
#pragma unroll
  for (int i = 0; i < N / 2; ++i) dp[i] += t[(DP / 16 - 1) % 2][i];
}

template <int DP>
__global__ void __launch_bounds__(THREADS, 1) flash_bwd_dkv_tc_kernel(
    const __grid_constant__ CUtensorMap q_map,    // (B*Hq, Sq, D)
    const __grid_constant__ CUtensorMap do_map,
    const __grid_constant__ CUtensorMap k_map,    // (B*Hkv, Sk, D)
    const __grid_constant__ CUtensorMap v_map,
    const float* __restrict__ m,                  // (B*Hq, Sq)
    const float* __restrict__ d, const float* __restrict__ delta,
    __nv_bfloat16* __restrict__ dk,               // (B*Hkv, Sk, D)
    __nv_bfloat16* __restrict__ dv, int G, int Sq, int Sk, int D,
    int causal) {
  using L = DkvSmem<DP>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hop_align1024(smem_raw);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + L::BAR);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + DKV_STAGES;

  const int bh = blockIdx.x;                     // b * Hkv + KV head
  const int k0 = blockIdx.y * KV_ROWS;
  const int q_offset = Sk - Sq;
  // causal: query rows below k0 - q_offset see nothing of this block
  const int t_first = causal ? max(0, k0 - q_offset) / BQ : 0;
  const int n_qt = (Sq + BQ - 1) / BQ;
  const int n_steps = G * (n_qt - t_first);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  init_barriers(kv_full, full, empty, DKV_STAGES);

  if (warp >= CONSUMERS * 4) {                   // the producer warpgroup
    hop_regs_dec<PRODUCER_REGS>();
    if (warp == CONSUMERS * 4 && lane == 0) {
      hop_mbar_expect_tx(kv_full, 2 * L::PANELS * L::PANEL_KV);
      for (int p = 0; p < L::PANELS; ++p) {
        hop_tma_load(smem + L::K + p * L::PANEL_KV, &k_map, kv_full, 64 * p,
                     k0, bh);
        hop_tma_load(smem + L::V + p * L::PANEL_KV, &v_map, kv_full, 64 * p,
                     k0, bh);
      }
      for (int it = 0; it < n_steps; ++it) {
        const int s = it % DKV_STAGES;
        const int head = bh * G + it / (n_qt - t_first);
        const int q0 = (t_first + it % (n_qt - t_first)) * BQ;
        if (it >= DKV_STAGES)
          hop_mbar_wait(&empty[s], (it / DKV_STAGES - 1) & 1);
        uint8_t* st = smem + L::QD + s * L::STAGE;
        hop_mbar_expect_tx(&full[s], L::STAGE);
        for (int p = 0; p < L::PANELS; ++p) {
          hop_tma_load(st + p * L::PANEL_Q, &q_map, &full[s], 64 * p, q0,
                       head);
          hop_tma_load(st + (L::PANELS + p) * L::PANEL_Q, &do_map, &full[s],
                       64 * p, q0, head);
        }
      }
    }
    return;
  }

  // consumer warpgroup wg: KV rows k0 + 64 wg .. + 63; this thread's rows
  // are kr0 (fragment entries 4j, 4j+1) and kr0 + 8 (4j+2, 4j+3), its
  // query columns 8j + col0 + {0, 1}
  hop_regs_inc<CONSUMER_REGS>();
  const int wg = warp / 4;
  const int wg_k0 = k0 + 64 * wg;
  const int kr0 = wg_k0 + (warp % 4) * 16 + lane / 4;
  const int col0 = 2 * (lane % 4);
  // the first query row that sees any real row of this warpgroup
  const int wg_q_first = wg_k0 >= Sk ? Sq : causal ? wg_k0 - q_offset : 0;
  const uint8_t* k_s = smem + L::K + wg * 64 * 128;
  const uint8_t* v_s = smem + L::V + wg * 64 * 128;

  float acc_k[DP / 2], acc_v[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc_k[i] = acc_v[i] = 0.f;

  hop_mbar_wait(kv_full, 0);
  for (int it = 0; it < n_steps; ++it) {
    const int s = it % DKV_STAGES;
    const size_t head = static_cast<size_t>(bh) * G + it / (n_qt - t_first);
    const int q0 = (t_first + it % (n_qt - t_first)) * BQ;
    hop_mbar_wait(&full[s], (it / DKV_STAGES) & 1);
    if (q0 + BQ - 1 >= wg_q_first) {
      const uint8_t* q_s = smem + L::QD + s * L::STAGE;
      const uint8_t* do_s = q_s + L::PANELS * L::PANEL_Q;

      // S^T = K·Q^T, then dP^T = V·dO^T a step at a time
      float st[BQ / 2], dpt[BQ / 2];
      hop_wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const int off = (kk / 4) * L::PANEL_KV + (kk % 4) * 32;
        const int qoff = (kk / 4) * L::PANEL_Q + (kk % 4) * 32;
        HopMma<BQ>::ss(st, hop_desc(k_s + off, 16, 1024),
                       hop_desc(q_s + qoff, 16, 1024), kk > 0);
      }
      hop_wgmma_commit();
      // the query rows' statistics, fetched while the products run
      float mq[BQ / 4], dq[BQ / 4], lq[BQ / 4];
#pragma unroll
      for (int c = 0; c < BQ / 4; ++c) {
        const int qi = q0 + 8 * (c / 2) + col0 + (c & 1);
        const bool ok = qi < Sq;
        const size_t r = head * Sq + (ok ? qi : 0);
        mq[c] = ok ? __ldg(m + r) : 0.f;
        dq[c] = ok ? fmaxf(__ldg(d + r), 1e-30f) : 1.f;
        lq[c] = ok ? __ldg(delta + r) : 0.f;
      }
      dp_steps<BQ, DP, L::PANEL_KV, L::PANEL_Q>(dpt, v_s, do_s);
      hop_fence_regs(st);

      // p^T and dS^T in place of S^T and dP^T
#pragma unroll
      for (int i = 0; i < BQ / 2; ++i) {
        const int c = 2 * (i / 4) + (i & 1);
        const int qi = q0 + 8 * (i / 4) + col0 + (i & 1);
        const int kj = kr0 + 8 * ((i >> 1) & 1);
        const bool ok = qi < Sq && kj < Sk &&
                        (!causal || kj <= qi + q_offset);
        const float p = ok ? exp2f(st[i] - mq[c]) / dq[c] : 0.f;
        st[i] = p;
        dpt[i] = ok ? LN2 * p * (dpt[i] - lq[c]) : 0.f;
      }

      // dV += p^T·dO, dK += dS^T·Q, p and dS each as three exact bf16
      // terms (hop_split3). Each 64-column half of each product goes to a
      // fresh accumulator that is added to the sums on the CUDA cores (a
      // long run into one tensor-core accumulator drifts); halves keep the
      // registers of the sums, the fresh tile and the terms within bounds.
      uint32_t pf[3][BQ / 16][4], sf[3][BQ / 16][4];
      hop_split_frags(st, pf);
      hop_split_frags(dpt, sf);
#pragma unroll
      for (int g = 0; g < 2 * L::PANELS; ++g) {
        const bool is_v = g < L::PANELS;           // dV halves, then dK's
        const int half = g % L::PANELS;
        const uint8_t* b_s = (is_v ? do_s : q_s) + half * L::PANEL_Q;
        float t[32];
        hop_wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk) {
          const uint64_t b = hop_desc(b_s + kk * 16 * 128, L::PANEL_Q, 1024);
#pragma unroll
          for (int u = 0; u < 3; ++u)
            HopMma<64>::rs(t, is_v ? pf[u][kk] : sf[u][kk], b, kk + u);
        }
        hop_wgmma_commit();
        hop_wgmma_wait<0>();
        hop_fence_regs(t);
        hop_fence_regs(pf);
        hop_fence_regs(sf);
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          if (is_v)
            acc_v[32 * half + i] += t[i];
          else
            acc_k[32 * half + i] += t[i];
        }
      }
    }
    __syncwarp();
    if (lane == 0) hop_mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int kj = kr0 + 8 * h;
    if (kj >= Sk) continue;
    const size_t r = (static_cast<size_t>(bh) * Sk + kj) * D;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = 8 * j + col0;
      if (col < D) {
        *reinterpret_cast<__nv_bfloat162*>(dk + r + col) =
            __floats2bfloat162_rn(acc_k[4 * j + 2 * h],
                                  acc_k[4 * j + 2 * h + 1]);
        *reinterpret_cast<__nv_bfloat162*>(dv + r + col) =
            __floats2bfloat162_rn(acc_v[4 * j + 2 * h],
                                  acc_v[4 * j + 2 * h + 1]);
      }
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(THREADS, 1) flash_bwd_dq_tc_kernel(
    const __grid_constant__ CUtensorMap q_map,    // (B*Hq, Sq, D)
    const __grid_constant__ CUtensorMap do_map,
    const __grid_constant__ CUtensorMap k_map,    // (B*Hkv, Sk, D)
    const __grid_constant__ CUtensorMap v_map,
    const float* __restrict__ m,                  // (B*Hq, Sq)
    const float* __restrict__ d, const float* __restrict__ delta,
    __nv_bfloat16* __restrict__ dq,               // (B*Hq, Sq, D)
    int G, int Sq, int Sk, int D, int causal) {
  using L = DqSmem<DP>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hop_align1024(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::BAR);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + DQ_STAGES;

  const int head = blockIdx.x;                   // b * Hq + query head
  const int q0 = (gridDim.y - 1 - blockIdx.y) * Q_ROWS;
  const int q_offset = Sk - Sq;
  const int q_last = min(Sq, q0 + Q_ROWS) - 1;
  const int k_end = causal ? min(Sk, q_last + q_offset + 1) : Sk;
  const int n_tiles = (k_end + BN - 1) / BN;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  init_barriers(q_full, full, empty, DQ_STAGES);

  if (warp >= CONSUMERS * 4) {                   // the producer warpgroup
    hop_regs_dec<PRODUCER_REGS>();
    if (warp == CONSUMERS * 4 && lane == 0) {
      hop_mbar_expect_tx(q_full, 2 * L::PANELS * L::PANEL_Q);
      for (int p = 0; p < L::PANELS; ++p) {
        hop_tma_load(smem + L::Q + p * L::PANEL_Q, &q_map, q_full, 64 * p,
                     q0, head);
        hop_tma_load(smem + L::DO + p * L::PANEL_Q, &do_map, q_full, 64 * p,
                     q0, head);
      }
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % DQ_STAGES;
        if (it >= DQ_STAGES)
          hop_mbar_wait(&empty[s], (it / DQ_STAGES - 1) & 1);
        uint8_t* st = smem + L::KV + s * L::STAGE;
        hop_mbar_expect_tx(&full[s], L::STAGE);
        for (int p = 0; p < L::PANELS; ++p) {
          hop_tma_load(st + p * L::PANEL_KV, &k_map, &full[s], 64 * p,
                       it * BN, head / G);
          hop_tma_load(st + (L::PANELS + p) * L::PANEL_KV, &v_map, &full[s],
                       64 * p, it * BN, head / G);
        }
      }
    }
    return;
  }

  // consumer warpgroup wg: query rows q0 + 64 wg .. + 63; this thread's
  // rows are row0 (entries 4j, 4j+1) and row0 + 8 (4j+2, 4j+3)
  hop_regs_inc<CONSUMER_REGS>();
  const int wg = warp / 4;
  const int wg_q0 = q0 + 64 * wg;
  const int row0 = wg_q0 + (warp % 4) * 16 + lane / 4;
  const int col0 = 2 * (lane % 4);
  const int wg_last = min(Sq, wg_q0 + 64) - 1;
  const int wg_k_end = wg_last < wg_q0 ? 0
                       : causal ? min(Sk, wg_last + q_offset + 1) : Sk;
  const uint8_t* q_s = smem + L::Q + wg * 64 * 128;
  const uint8_t* do_s = smem + L::DO + wg * 64 * 128;

  float m_r[2], d_r[2], l_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    const bool ok = row < Sq;
    const size_t r = static_cast<size_t>(head) * Sq + (ok ? row : 0);
    m_r[h] = ok ? m[r] : 0.f;
    d_r[h] = ok ? fmaxf(d[r], 1e-30f) : 1.f;
    l_r[h] = ok ? delta[r] : 0.f;
  }
  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;

  hop_mbar_wait(q_full, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % DQ_STAGES;
    const int k0 = it * BN;
    hop_mbar_wait(&full[s], (it / DQ_STAGES) & 1);
    if (k0 < wg_k_end) {
      const uint8_t* k_s = smem + L::KV + s * L::STAGE;
      const uint8_t* v_s = k_s + L::PANELS * L::PANEL_KV;

      // S = Q·K^T, then dP = dO·V^T a step at a time
      float sc[BN / 2], dp[BN / 2];
      hop_wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const int qoff = (kk / 4) * L::PANEL_Q + (kk % 4) * 32;
        const int off = (kk / 4) * L::PANEL_KV + (kk % 4) * 32;
        HopMma<BN>::ss(sc, hop_desc(q_s + qoff, 16, 1024),
                       hop_desc(k_s + off, 16, 1024), kk > 0);
      }
      hop_wgmma_commit();
      dp_steps<BN, DP, L::PANEL_Q, L::PANEL_KV>(dp, do_s, v_s);
      hop_fence_regs(sc);

      // dS in place of dP
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        const int h = (i >> 1) & 1;
        const int row = row0 + 8 * h;
        const int col = k0 + 8 * (i / 4) + col0 + (i & 1);
        const bool ok = row < Sq && col < Sk &&
                        (!causal || col <= row + q_offset);
        const float p = ok ? exp2f(sc[i] - m_r[h]) / d_r[h] : 0.f;
        dp[i] = ok ? LN2 * p * (dp[i] - l_r[h]) : 0.f;
      }

      // dQ += dS·K, dS as three exact bf16 terms (hop_split3), into a fresh
      // accumulator added to dQ on the CUDA cores (a long run into one
      // tensor-core accumulator drifts)
      uint32_t sf[3][BN / 16][4];
      hop_split_frags(dp, sf);
      float t[DP / 2];
      hop_wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        const uint64_t b_k = hop_desc(k_s + kk * 16 * 128, L::PANEL_KV, 1024);
#pragma unroll
        for (int u = 0; u < 3; ++u) HopMma<DP>::rs(t, sf[u][kk], b_k, kk + u);
      }
      hop_wgmma_commit();
      hop_wgmma_wait<0>();
      hop_fence_regs(t);
      hop_fence_regs(sf);
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) acc[i] += t[i];
    }
    __syncwarp();
    if (lane == 0) hop_mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    if (row >= Sq) continue;
    const size_t r = (static_cast<size_t>(head) * Sq + row) * D;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = 8 * j + col0;
      if (col < D)
        *reinterpret_cast<__nv_bfloat162*>(dq + r + col) =
            __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
}

bool bad_geometry(int B, int Hq, int Hkv, int Sq, int Sk, int D,
                  int causal) {
  return B <= 0 || Sq <= 0 || Sk <= 0 || Hkv <= 0 || Hq % Hkv != 0 ||
         D <= 0 || D % 16 != 0 || D > 128 || (causal && Sk < Sq);
}

// The four tensor maps both kernels read, boxes of `q_box` query rows and
// `kv_box` KV rows.
cudaError_t make_maps(CUtensorMap maps[4], const void* q, const void* dout,
                      const void* k, const void* v, int B, int Hq, int Hkv,
                      int Sq, int Sk, int D, int q_box, int kv_box) {
  cudaError_t err = hop_map_rows(&maps[0], q, B * Hq, Sq, D, q_box);
  if (err == cudaSuccess)
    err = hop_map_rows(&maps[1], dout, B * Hq, Sq, D, q_box);
  if (err == cudaSuccess)
    err = hop_map_rows(&maps[2], k, B * Hkv, Sk, D, kv_box);
  if (err == cudaSuccess)
    err = hop_map_rows(&maps[3], v, B * Hkv, Sk, D, kv_box);
  return err;
}

template <int DP>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const float* m, const float* d,
                       const float* delta, void* dk, void* dv, int B, int Hq,
                       int Hkv, int Sq, int Sk, int D, int causal,
                       cudaStream_t stream) {
  CUtensorMap maps[4];
  cudaError_t err =
      make_maps(maps, q, dout, k, v, B, Hq, Hkv, Sq, Sk, D, BQ, KV_ROWS);
  if (err != cudaSuccess) return err;
  auto kern = flash_bwd_dkv_tc_kernel<DP>;
  err = smx_smem_limit(kern, DkvSmem<DP>::BYTES);
  if (err != cudaSuccess) return err;
  dim3 grid(B * Hkv, (Sk + KV_ROWS - 1) / KV_ROWS);
  kern<<<grid, THREADS, DkvSmem<DP>::BYTES, stream>>>(
      maps[0], maps[1], maps[2], maps[3], m, d, delta,
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv),
      Hq / Hkv, Sq, Sk, D, causal);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const float* m, const float* d,
                      const float* delta, void* dq, int B, int Hq, int Hkv,
                      int Sq, int Sk, int D, int causal,
                      cudaStream_t stream) {
  CUtensorMap maps[4];
  cudaError_t err =
      make_maps(maps, q, dout, k, v, B, Hq, Hkv, Sq, Sk, D, Q_ROWS, BN);
  if (err != cudaSuccess) return err;
  auto kern = flash_bwd_dq_tc_kernel<DP>;
  err = smx_smem_limit(kern, DqSmem<DP>::BYTES);
  if (err != cudaSuccess) return err;
  dim3 grid(B * Hq, (Sq + Q_ROWS - 1) / Q_ROWS);
  kern<<<grid, THREADS, DqSmem<DP>::BYTES, stream>>>(
      maps[0], maps[1], maps[2], maps[3], m, d, delta,
      static_cast<__nv_bfloat16*>(dq), Hq / Hkv, Sq, Sk, D, causal);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry points (loaded with ctypes). q, k, v, dout bf16, contiguous,
// 16-byte aligned; m, d, delta fp32 (B, Hq, Sq); the gradients bf16. D a
// multiple of 16 up to 128; causal needs Sk >= Sq. Each returns
// cudaGetLastError() after its launch.
extern "C" int smx_flash_bwd_dkv_tc(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const void* m, const void* d,
                                    const void* delta, void* dk, void* dv,
                                    int B, int Hq, int Hkv, int Sq, int Sk,
                                    int D, int causal, void* stream) {
  if (bad_geometry(B, Hq, Hkv, Sq, Sk, D, causal))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* mf = static_cast<const float*>(m);
  const float* df = static_cast<const float*>(d);
  const float* lf = static_cast<const float*>(delta);
  if (D <= 64)
    return static_cast<int>(launch_dkv<64>(q, k, v, dout, mf, df, lf, dk, dv,
                                           B, Hq, Hkv, Sq, Sk, D, causal,
                                           st));
  return static_cast<int>(launch_dkv<128>(q, k, v, dout, mf, df, lf, dk, dv,
                                          B, Hq, Hkv, Sq, Sk, D, causal, st));
}

extern "C" int smx_flash_bwd_dq_tc(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* m, const void* d,
                                   const void* delta, void* dq, int B, int Hq,
                                   int Hkv, int Sq, int Sk, int D, int causal,
                                   void* stream) {
  if (bad_geometry(B, Hq, Hkv, Sq, Sk, D, causal))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* mf = static_cast<const float*>(m);
  const float* df = static_cast<const float*>(d);
  const float* lf = static_cast<const float*>(delta);
  if (D <= 64)
    return static_cast<int>(launch_dq<64>(q, k, v, dout, mf, df, lf, dq, B,
                                          Hq, Hkv, Sq, Sk, D, causal, st));
  return static_cast<int>(launch_dq<128>(q, k, v, dout, mf, df, lf, dq, B,
                                         Hq, Hkv, Sq, Sk, D, causal, st));
}
