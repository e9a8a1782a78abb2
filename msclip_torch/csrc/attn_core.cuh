// The bf16 attention of one 64-row query tile of one (sample, head), on
// wgmma, shared by the attention forward (K1, attention_fwd.cu) and the
// fused attention half-block (K5 and its tuning variants E1, halfblock.cuh).
// Each source includes it into its own anonymous namespace, so nothing here
// is exported.
//
// The caller has put the head's Q, K and V into shared memory as LP rows of
// 64 bf16 each in the 128-byte swizzle (hopper.cuh sw128), rows past L
// zero, each tile 1024-byte aligned, and made them visible to the async
// proxy (fence_proxy_async, then a barrier). One warpgroup runs the tile:
// S = Q K^T as wgmma.m64n64k16 per 64 keys (m64n16k16 for a last 16), Q
// from registers and K from shared memory through its K-major descriptor;
// the scale, the additive fp32 mask and an exact fp32 softmax on the
// accumulator registers (a row's keys sit in the four lanes of a quad; keys
// past L get -inf); exp is expf, as torch's softmax; the weights are
// divided by the row sum as IEEE division rounds (hopper.cuh rcp_rn,
// div_rn) or, with Recip, multiplied by the sum's rounded reciprocal; the
// weights, rounded to bf16 in registers, are the A operand of O = P V as
// wgmma.m64n64k16 against V read through the transposed (N-major)
// descriptor. The output is rounded once and staged through the warp's own
// Q rows, so that each lane stores whole 16-byte chunks. A warp whose 16
// rows all lie past L reads no Q, skips the softmax and writes nothing.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <cstdint>

#include "hopper.cuh"

namespace {

// The padded length LP of the bf16 attention tile at sequence length L, the
// one rule of K1, K5 and E1 (the towers' 50 -> 64, 77 -> 80, 197 -> 208);
// ops/block_fused.py padded_len mirrors it, held to it by a test
__host__ __device__ constexpr int padded_len(int L) {
  return L <= 64 ? 64 : L <= 80 ? 80 : L <= 128 ? 128 : L <= 208 ? 208 : 256;
}

// q_s: the Q tile (generic pointer); sk, sv: the K and V tiles (shared
// addresses); mk: the fp32 [L, L] mask or null; qt: the query tile (rows
// 64 qt ..); out_b: output row 0 of the head's 64 columns, rows ld_out
// elements apart. Called by all 128 threads of one warpgroup.
template <int LP, bool Recip = false>
__device__ __forceinline__ void attn_query_tile(unsigned char* q_s, uint32_t sk, uint32_t sv,
                                                const float* mk, int L, float scale, int qt,
                                                __nv_bfloat16* out_b, long long ld_out) {
  constexpr int NC = LP / 16;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3;
  const int rb = qt * 64 + warp * 16;  // this warp's 16 query rows
  const int r0 = rb + g, r1 = r0 + 8;  // this lane's two
  const bool live = rb < L;

  // Q fragments (mma A layout) of the four 16-column steps; a warp with
  // no row < L feeds zeros
  uint32_t qa[4][4];
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    qa[ks][0] = qa[ks][1] = qa[ks][2] = qa[ks][3] = 0u;
    if (live) {
      qa[ks][0] = *reinterpret_cast<const uint32_t*>(q_s + sw128(r0, 2 * ks) + 4 * c);
      qa[ks][1] = *reinterpret_cast<const uint32_t*>(q_s + sw128(r1, 2 * ks) + 4 * c);
      qa[ks][2] = *reinterpret_cast<const uint32_t*>(q_s + sw128(r0, 2 * ks + 1) + 4 * c);
      qa[ks][3] = *reinterpret_cast<const uint32_t*>(q_s + sw128(r1, 2 * ks + 1) + 4 * c);
    }
  }

  // S = Q K^T, 64 keys per product and a last one of 16 where LP is
  // not a multiple of 64; s[8 t + 4 j + 2 i + e] is row r0 + 8 i, key
  // 16 t + 8 j + 2 c + e (a 64-key accumulator is four 16-key ones)
  float s[NC * 8];
#pragma unroll
  for (int e = 0; e < NC * 8; ++e) s[e] = 0.f;
  const uint64_t dk = desc_k_major(sk);
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
#pragma unroll
    for (int q = 0; q < NC / 4; ++q)
      wgmma_m64n64k16<0>(s + 32 * q, qa[ks], desc_add(dk, q * 8192 + ks * 32), ks);
#pragma unroll
    for (int t = NC / 4 * 4; t < NC; ++t)
      wgmma_m64n16k16(s + 8 * t, qa[ks], desc_add(dk, t * 2048 + ks * 32), ks);
  }
  wgmma_commit();
  wgmma_wait<0>();
#pragma unroll
  for (int e = 0; e < NC * 8; ++e) fence_operand(s[e]);

  // scale, mask, exact fp32 softmax of each row; the weights rounded to
  // bf16 as the A fragments of P V: p[t] = {(r0, keys 16t + 2c..),
  // (r1, ..), (r0, keys 16t + 8 + 2c..), (r1, ..)}
  uint32_t p[NC][4];
  if (live) {
    // v = s D^-1/2 (+ mask). D^-1/2 is a power of two, so the product
    // is exact: with a mask one fma rounds as the product and the sum
    // do; without one the scale waits for the exponent's argument,
    // fma(s, D^-1/2, -max D^-1/2), which rounds as v - max does.
    float sc = 1.f;
    if (mk != nullptr) {
      // rows past L read row L - 1 and are not written
      const float* mr0 = mk + min(r0, L - 1) * L;
      const float* mr1 = mk + min(r1, L - 1) * L;
#pragma unroll
      for (int t = 0; t < NC; ++t)
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int j = min(16 * t + 8 * (e >> 2) + 2 * c + (e & 1), L - 1);
          s[8 * t + e] = fmaf(s[8 * t + e], scale, ((e & 2) ? mr1 : mr0)[j]);
        }
    } else {
      sc = scale;
    }
#pragma unroll
    for (int t = 0; t < NC; ++t) {
      if (16 * t + 16 > L) {  // keys past L get -inf
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (16 * t + 8 * (e >> 2) + 2 * c + (e & 1) >= L) s[8 * t + e] = -CUDART_INF_F;
      }
    }
    float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F;
#pragma unroll
    for (int t = 0; t < NC; ++t)
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        if (e & 2) m1 = fmaxf(m1, s[8 * t + e]);
        else m0 = fmaxf(m0, s[8 * t + e]);
      }
    m0 = quad_max(m0);
    m1 = quad_max(m1);
    // exp(v - max) with expf, as torch's softmax (and jnp.exp) computes it
    const float n0 = -m0 * sc, n1 = -m1 * sc;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int t = 0; t < NC; ++t) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float x = expf(fmaf(s[8 * t + e], sc, (e & 2) ? n1 : n0));
        s[8 * t + e] = x;
        if (e & 2) sum1 += x;
        else sum0 += x;
      }
    }
    sum0 = quad_sum(sum0);
    sum1 = quad_sum(sum1);
    const float inv0 = rcp_rn(sum0), inv1 = rcp_rn(sum1);
    if constexpr (Recip) {
      // e (1 / sum): the reciprocal rounded once (as __fdiv_rn(1, sum)),
      // then one rounded product a weight
#pragma unroll
      for (int t = 0; t < NC; ++t) {
        p[t][0] = pack_bf16(__fmul_rn(s[8 * t + 0], inv0), __fmul_rn(s[8 * t + 1], inv0));
        p[t][1] = pack_bf16(__fmul_rn(s[8 * t + 2], inv1), __fmul_rn(s[8 * t + 3], inv1));
        p[t][2] = pack_bf16(__fmul_rn(s[8 * t + 4], inv0), __fmul_rn(s[8 * t + 5], inv0));
        p[t][3] = pack_bf16(__fmul_rn(s[8 * t + 6], inv1), __fmul_rn(s[8 * t + 7], inv1));
      }
    } else {
#pragma unroll
      for (int t = 0; t < NC; ++t) {
        p[t][0] = pack_bf16(div_rn(s[8 * t + 0], sum0, inv0), div_rn(s[8 * t + 1], sum0, inv0));
        p[t][1] = pack_bf16(div_rn(s[8 * t + 2], sum1, inv1), div_rn(s[8 * t + 3], sum1, inv1));
        p[t][2] = pack_bf16(div_rn(s[8 * t + 4], sum0, inv0), div_rn(s[8 * t + 5], sum0, inv0));
        p[t][3] = pack_bf16(div_rn(s[8 * t + 6], sum1, inv1), div_rn(s[8 * t + 7], sum1, inv1));
      }
    }
  } else {
#pragma unroll
    for (int t = 0; t < NC; ++t) p[t][0] = p[t][1] = p[t][2] = p[t][3] = 0u;
  }

  // O = P V: 16 keys a step, V through its transposed descriptor
  float o[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) o[e] = 0.f;
  const uint64_t dv = desc_mn_major(sv);
  wgmma_fence();
#pragma unroll
  for (int t = 0; t < NC; ++t) wgmma_m64n64k16<1>(o, p[t], desc_add(dv, t * 2048), t);
  wgmma_commit();
  wgmma_wait<0>();
#pragma unroll
  for (int e = 0; e < 32; ++e) fence_operand(o[e]);

  // rounded once; staged through this warp's own Q rows (read above
  // into qa) so that each lane stores whole 16-byte chunks
  if (live) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      *reinterpret_cast<uint32_t*>(q_s + sw128(r0, j) + 4 * c) = pack_bf16(o[4 * j], o[4 * j + 1]);
      *reinterpret_cast<uint32_t*>(q_s + sw128(r1, j) + 4 * c) =
          pack_bf16(o[4 * j + 2], o[4 * j + 3]);
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = rb + i * 4 + (lane >> 3), ch = lane & 7;
      if (row < L)
        *reinterpret_cast<uint4*>(out_b + (long long)row * ld_out + ch * 8) =
            *reinterpret_cast<const uint4*>(q_s + sw128(row, ch));
    }
  }
}

}  // namespace
