// One KV tile of the Softermax online recurrence for a consumer warpgroup on
// Hopper's tensor cores: the step the dense flash forward
// (flash_attention_tc.cu, K3) and the paged chunked prefill
// (flash_prefill_paged_tc.cu, K2) share. They differ only in where the
// tiles come from and in the mask.
//
// Per 64-row KV tile, with Q and K staged as K-major bf16 panels and V as
// MN-major panels (128-byte swizzle, hopper.cuh):
//   S = Q·K^T   wgmma m64n64k16; products of bf16 values are exact in f32;
//   mask        only where the caller says the tile crosses the mask
//               (`edge`): dead(h, c) names a dead column c of the thread's
//               row h; a dead score becomes the finite NEG_INF, so it adds
//               p = 0;
//   IntMax      m_new = max(m_prev, ceil(rowmax(s))) and the rescale
//               alpha = 2^(m_prev - m_new) (smx_rescale: exact), on the
//               accumulator fragment, each row living in one quad of lanes;
//               a row that meets a tile masking it in full while its max is
//               still NEG_INF takes p = 2^0 there: a finite state with max
//               NEG_INF, which the first rescale against a live max (a
//               factor of exactly 0) or a merge erases (K2's split walk);
//   d           d * alpha + the row sum of the f32 p, before the split;
//   p·V         p enters the tensor cores as three bf16 terms whose sum is
//               p exactly (hop_split3), three register-A wgmmas on the same
//               V tile, into a fresh accumulator that is added to the
//               rescaled O on the CUDA cores (the tensor cores' f32 sums are
//               coarser than round-to-nearest, so a whole walk in one
//               accumulator drifts, where one tile stays within a few ulps).
// The thread's rows are row0 (fragment entries 4j, 4j+1) and row0 + 8
// (4j+2, 4j+3); its columns 8j + 2 (lane % 4) + {0, 1}.
#pragma once

#include "common.cuh"
#include "hopper.cuh"

template <int DP, typename Dead>
__device__ __forceinline__ void hop_softermax_tile(
    const uint8_t* q_s, int panel_q, const uint8_t* k_s, const uint8_t* v_s,
    int panel_kv, bool edge, Dead dead, float (&o)[DP / 2], float (&m_r)[2],
    float (&d_r)[2], int intmax) {
  constexpr int BN = 64;                  // KV rows per tile
  const int col0 = 2 * (threadIdx.x % 4);

  // S = Q·K^T
  float sc[BN / 2];
  hop_wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const int off = (kk % 4) * 32;
    HopMma<BN>::ss(sc, hop_desc(q_s + (kk / 4) * panel_q + off, 16, 1024),
                   hop_desc(k_s + (kk / 4) * panel_kv + off, 16, 1024),
                   kk > 0);
  }
  hop_wgmma_commit();
  hop_wgmma_wait<0>();
  hop_fence_regs(sc);

  if (edge) {
#pragma unroll
    for (int i = 0; i < BN / 2; ++i)
      if (dead((i >> 1) & 1, 8 * (i / 4) + col0 + (i & 1)))
        sc[i] = SMX_NEG_INF;
  }

  // IntMax, the rescale, p = 2^(s - m_new) and the row sums
  float mx[2] = {SMX_NEG_INF, SMX_NEG_INF};
#pragma unroll
  for (int i = 0; i < BN / 2; ++i)
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
  float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    const float m_new = fmaxf(m_r[h], intmax ? ceilf(mx[h]) : mx[h]);
    alpha[h] = smx_rescale(m_r[h] - m_new, intmax);
    m_r[h] = m_new;
  }
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) {
    const int h = (i >> 1) & 1;
    sc[i] = exp2f(sc[i] - m_r[h]);
    sum[h] += sc[i];
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
    d_r[h] = d_r[h] * alpha[h] + sum[h];
  }

  // O = O·alpha + p·V with p = p_hi + p_mid + p_lo exactly
  uint32_t pf[3][BN / 16][4];
  hop_split_frags(sc, pf);
  float pv[DP / 2];
  hop_wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
    const uint64_t b_v = hop_desc(v_s + kk * 16 * 128, panel_kv, 1024);
#pragma unroll
    for (int t = 0; t < 3; ++t) HopMma<DP>::rs(pv, pf[t][kk], b_v, kk + t);
  }
  hop_wgmma_commit();
  hop_wgmma_wait<0>();
  hop_fence_regs(pv);
  hop_fence_regs(pf);
#pragma unroll
  for (int i = 0; i < DP / 2; ++i)
    o[i] = fmaf(o[i], alpha[(i >> 1) & 1], pv[i]);
}
