// Fused multi-head attention backward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel msclip_tpu/ops/attention.py
// (_attn_bwd_kernel, launched from _fused_attention_bwd). Given the QKV
// projection output in its native [B, L, 3E] layout and the gradient g of
// the attention output [B, L, E], it recomputes the softmax weights per
// sample and head and writes dqkv [B, L, 3E]:
//
//     S  = q k^T * D^-1/2 [+ mask]      W  = softmax(S)  (fp32)
//     dV = Wc^T g                       dW = g v^T
//     dS = ((dW - rowsum(dW * W)) * W)  rounded to the input type
//     dQ = dS k * D^-1/2                dK = dS^T q * D^-1/2
//
// Rounding follows the TPU kernel: every product takes input-type values
// and sums in fp32; Wc = W rounded to the input type before dV; dS rounded
// before dQ and dK; the softmax (exact, the whole row at once, the weights
// divided by the row sum), the rowsum(dW * W) term and the scale stay fp32;
// the outputs are rounded once. exp is expf and the division rounds as
// IEEE division does (hopper.cuh rcp_rn, div_rn), as in torch's softmax. A
// -inf in the mask gives a weight of exactly 0 (exp(-inf) = 0), so dS is 0
// there and no NaN appears (a row needs one finite score, as the causal
// mask leaves).
//
// Bound on an H100 SXM: memory. Each launch reads 4E and writes 3E values
// per token and does 5 products of 2*L*D flops per query row and head. At
// the ViT-B/32 train shape (B=256, L=50, E=768, H=12) in bf16: 137.6 MB of
// I/O, 41 us at 3.35 TB/s, against 2.4 us of matrix work at 989 TFLOP/s;
// the text tower's (L=77, causal) 211 MB, 63 us.
//
// Two kernels, chosen by the input type:
//
// * bfloat16, what the design does about the bound:
//   - Persistent blocks over (sample, head) units with a two-stage
//     cp.async ring, as the forward (attention_fwd.cu): while the block
//     computes unit u, unit u + grid's Q, K, V and g (128-byte head slices,
//     zero-filled past L) are in flight. Each is a [LP, 64] bf16 tile in the
//     128-byte swizzle, so the eight rows an ldmatrix reads hit distinct
//     banks. At LP = 256 the four tiles take 128 KB, so that bucket has one
//     stage (no main path runs it). The mask is copied into shared memory
//     once per block where it fits beside the ring (LP <= 80, the train
//     shapes); above that it is read from device memory.
//   - Tensor cores through mma.sync m16n8k16 (bf16 in, fp32 accumulators),
//     one warp per 16-row tile. Every operand comes from shared memory
//     through ldmatrix, the operands whose sums run over rows (K for dQ, g
//     and Q for dV and dK, and the stored Wc and dS read as dV's and dK's A
//     operands) through ldmatrix.trans: no 16-bit gathers and no transposed
//     copies. wgmma is not used here: dV and dK need Wc^T and dS^T as their
//     A operand, which wgmma reads only from shared memory in the 128-byte
//     layouts, and the operands live at most a few microseconds per unit.
//   - Five products where LP <= 128 (every train shape: 50 -> 64, 77 -> 80).
//     Phase 1, one warp per query tile: S = Q K^T and dW = g V^T once each
//     into registers, the softmax, D_i = rowsum(dW * W) from that one dW,
//     dS; Wc and dS go to shared memory as [LP, LP + 8] bf16 (28 KB at
//     LP = 80), and dQ = dS K takes dS from registers. Phase 2, after a
//     barrier: dV = Wc^T g and dK = dS^T Q, one warp per key tile and output,
//     2 LP / 16 items on 6 warps (LP = 64, two blocks an SM, which leaves
//     168 registers a thread: at 8 warps the 128 left spill), 10 (LP = 80)
//     or 8; no cross-warp sums and no atomics.
//   - Where Wc and dS do not fit beside the ring (LP = 208, ViT-B/16; 256)
//     the block keeps the recomputation, and phase 1 streams the keys 16
//     at a time: 16 x LP fp32 weights in registers beside dQ's
//     accumulators spilled at 255 registers a thread. Its four passes make
//     S again each time (the row max, the row sum, D_i with dW, then dS
//     with dW again and dQ) and leave max, sum, D_i and 1 / sum per row in
//     shared memory; phase 2 recomputes S^T and dW^T per 16 queries. Eleven
//     products, on no main path (B/16 is eval only); at L=197 the 13 tiles
//     run on 7 warps (two rounds, as 8 warps would).
//   - ptxas reports no spills for any bf16 instantiation (chip_smoke.py
//     phase 2 fails on one).
// * float32: CUDA cores, exact fp32 (no TF32). One block of 8 warps per
//   (sample, head); a warp takes one row at a time. Phase 1 stages K and V
//   in shared memory (rows padded to D + 1 floats: 32 lanes reading 32 rows
//   hit 32 banks), lane l owns keys l, l + 32, ...; phase 2 stages Q and g in
//   the same space, lane l owns queries l, l + 32, .... Row sums for dQ, dK
//   and dV take the row's weights from the lanes with shuffles while lane l
//   owns output columns l and l + 32. 140 KB at L = 256.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr int kMaxSeq = 256;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---------------------------------------------------------------------------
// bfloat16: persistent blocks, cp.async ring, mma.sync with ldmatrix
// ---------------------------------------------------------------------------

typedef __nv_bfloat16 bf16;

// per padded length LP: warps, ring stages, whether Wc and dS are stored
// (five products) or recomputed, whether the mask goes to shared memory,
// and the blocks an SM is expected to hold (the register budget)
template <int LP>
struct BwdShape {
  static constexpr bool kStore = LP <= 128;
  static constexpr int NW = LP == 64 ? 6 : LP == 80 ? 10 : LP == 128 ? 8 : LP == 208 ? 7 : 8;
  static constexpr int kStages = LP <= 208 ? 2 : 1;
  static constexpr bool kMaskSmem = LP <= 80;
  static constexpr int kMinBlocks = LP <= 64 ? 2 : 1;
  static constexpr int WS = LP + 8;  // row stride of the stored Wc and dS
  // bytes from a 1024-byte aligned base: the ring, then Wc and dS (or the
  // four fp32 row statistics), then the mask
  static constexpr uint32_t q = 0, k = LP * 128, v = 2 * LP * 128, g = 3 * LP * 128,
                            stage = 4 * LP * 128;
  static constexpr uint32_t extra = kStages * stage;
  static constexpr uint32_t extra_bytes =
      kStore ? 2u * LP * WS * sizeof(bf16) : 4u * LP * sizeof(float);
  // dynamic shared memory: alignment slack, the ring, Wc and dS or the
  // statistics, and room for the mask of the bucket's longest L where it is
  // staged
  static constexpr size_t smem(bool mask) {
    return 1024 + extra + extra_bytes + (mask && kMaskSmem ? sizeof(float) * LP * LP : 0);
  }
};

// acc[2 i + h] += a (a 16-query x 16-key dS fragment) times K's rows
// 16 kt.. at d tiles 2 (dp0 + i) + h: B is K read down its columns
// (ldmatrix.trans)
template <int NDP>
__device__ __forceinline__ void dq_accumulate(float (&acc)[2 * NDP][4], const uint32_t (&a)[4],
                                              uint32_t sk, int kt, int dp0, int lane) {
#pragma unroll
  for (int i = 0; i < NDP; ++i) {
    uint32_t bk[4];
    ldmatrix_x4_trans(bk, sk + sw128(16 * kt + (lane & 15), 2 * (dp0 + i) + (lane >> 4)));
    mma_16816(acc[2 * i], a, bk[0], bk[1]);
    mma_16816(acc[2 * i + 1], a, bk[2], bk[3]);
  }
}

// rows j0 and j1 (< L) of an mma accumulator of NDT d tiles, times f and
// rounded, to out (row stride rs)
template <int NDT>
__device__ __forceinline__ void store_rows(bf16* out, const float (&acc)[NDT][4], float f, int j0,
                                           int j1, int L, long long rs, int c) {
#pragma unroll
  for (int dt = 0; dt < NDT; ++dt) {
    if (j0 < L)
      *reinterpret_cast<uint32_t*>(out + (long long)j0 * rs + dt * 8 + 2 * c) =
          pack_bf16(acc[dt][0] * f, acc[dt][1] * f);
    if (j1 < L)
      *reinterpret_cast<uint32_t*>(out + (long long)j1 * rs + dt * 8 + 2 * c) =
          pack_bf16(acc[dt][2] * f, acc[dt][3] * f);
  }
}

template <int LP>
__global__ void __launch_bounds__(BwdShape<LP>::NW * 32, BwdShape<LP>::kMinBlocks)
attention_bwd_bf16_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ gout,
                          const float* __restrict__ mask, bf16* __restrict__ dqkv, int B, int L,
                          int E, int H, float scale) {
  using Sh = BwdShape<LP>;
  constexpr int NW = Sh::NW, NT = LP / 8, WS = Sh::WS;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* base_ptr = smem_raw + (base - raw);
  // stored variant: Wc and dS; recomputing variant: max, sum, D_i and the
  // sum's rounded reciprocal per row
  bf16* w_s = reinterpret_cast<bf16*>(base_ptr + Sh::extra);
  bf16* ds_s = w_s + LP * WS;
  float* max_s = reinterpret_cast<float*>(base_ptr + Sh::extra);
  float* sum_s = max_s + LP;
  float* dd_s = sum_s + LP;
  float* inv_s = dd_s + LP;


  const int units = B * H;
  const long long rs = 3LL * E;  // row stride of qkv and dqkv

  // unit u's Q, K, V and g (rows 0..LP, zeros past L) into ring stage st
  auto stage_unit = [&](int u, int st) {
    const int b = u / H, h = u % H;
    const bf16* src = qkv + (long long)b * L * rs + h * 64;
    const bf16* gsrc = gout + (long long)b * L * E + h * 64;
    const uint32_t sb = base + st * Sh::stage;
    for (int idx = threadIdx.x; idx < 4 * LP * 8; idx += blockDim.x) {
      const int which = idx / (LP * 8), rem = idx % (LP * 8);
      const int row = rem >> 3, ch = rem & 7;
      const bool ok = row < L;
      const int r = ok ? row : 0;
      const bf16* p = which < 3 ? src + (long long)r * rs + which * E + ch * 8
                                : gsrc + (long long)r * E + ch * 8;
      cp_async16(sb + which * LP * 128 + sw128(row, ch), p, ok);
    }
  };

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3;

  int u = blockIdx.x;
  if (Sh::kStages == 2) {
    if (u < units) stage_unit(u, 0);
    cp_async_commit();
  }
  // the mask, the same [L, L] for every unit, is copied while the first
  // unit's copies are in flight
  const float* mk = mask;
  if (mask != nullptr && Sh::kMaskSmem) {
    float* ms = reinterpret_cast<float*>(base_ptr + Sh::extra + Sh::extra_bytes);
    for (int i = threadIdx.x; i < L * L; i += blockDim.x) ms[i] = mask[i];
    mk = ms;  // published by the first barrier of the unit loop
  }
  for (int it = 0; u < units; ++it, u += gridDim.x) {
    const int st = Sh::kStages == 2 ? it & 1 : 0;
    if (Sh::kStages == 2) {
      if (u + (int)gridDim.x < units) stage_unit(u + gridDim.x, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();  // unit u has landed; unit u + grid stays in flight
    } else {
      stage_unit(u, 0);
      cp_async_commit();
      cp_async_wait<0>();
    }
    __syncthreads();

    const uint32_t sq = base + st * Sh::stage + Sh::q, sk = base + st * Sh::stage + Sh::k;
    const uint32_t sv = base + st * Sh::stage + Sh::v, sg = base + st * Sh::stage + Sh::g;
    const int b = u / H, h = u % H;
    bf16* dq_b = dqkv + (long long)b * L * rs + h * 64;
    const int n16 = (L + 15) / 16;  // 16-row tiles that hold a row < L

    // ---- phase 1: query tiles -> softmax, D_i, dS, dQ ----
    for (int qt = warp; qt < n16; qt += NW) {
      const int rb = qt * 16, r0 = rb + g, r1 = r0 + 8;

      // dW = g V^T for the key tiles 2 np, 2 np + 1 (16 keys)
      auto dw_pair = [&](int np, float (&dw0)[4], float (&dw1)[4]) {
        dw0[0] = dw0[1] = dw0[2] = dw0[3] = 0.f;
        dw1[0] = dw1[1] = dw1[2] = dw1[3] = 0.f;
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          uint32_t a[4], bv[4];
          ldmatrix_x4(a, sg + sw128(rb + (lane & 15), 2 * ks + (lane >> 4)));
          ldmatrix_x4(bv, sv + sw128(16 * np + (lane & 7) + ((lane >> 4) << 3),
                                     2 * ks + ((lane >> 3) & 1)));
          mma_16816(dw0, a, bv[0], bv[1]);
          mma_16816(dw1, a, bv[2], bv[3]);
        }
      };
      // the scores of key tile nt scaled and masked, x = {(r0, 8nt + 2c),
      // (r0, +1), (r1, 8nt + 2c), (r1, +1)}; keys past L get -inf
      auto scale_mask = [&](int nt, float (&x)[4]) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = 8 * nt + 2 * c + (e & 1);
          const int r = e < 2 ? r0 : r1;
          float v = -CUDART_INF_F;
          if (j < L) {
            v = x[e] * scale;
            if (mk != nullptr && r < L) v += mk[r * L + j];
          }
          x[e] = v;
        }
      };
      const bool ok0 = r0 < L, ok1 = r1 < L;  // rows past L get weight 0
      float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F, sum0 = 0.f, sum1 = 0.f;
      float dd0 = 0.f, dd1 = 0.f;
      float dq[8][4];  // dQ's accumulators, zeroed where the passes need them
      if constexpr (Sh::kStore) {
        // S = Q K^T over every key tile of 8 into registers
        float s[NT][4];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          uint32_t a[4];
          ldmatrix_x4(a, sq + sw128(rb + (lane & 15), 2 * ks + (lane >> 4)));
#pragma unroll
          for (int np = 0; np < NT / 2; ++np) {
            uint32_t bk[4];
            ldmatrix_x4(bk, sk + sw128(16 * np + (lane & 7) + ((lane >> 4) << 3),
                                       2 * ks + ((lane >> 3) & 1)));
            mma_16816(s[2 * np], a, bk[0], bk[1]);
            mma_16816(s[2 * np + 1], a, bk[2], bk[3]);
          }
        }
        // exact fp32 softmax of each row
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          scale_mask(nt, s[nt]);
          m0 = fmaxf(m0, fmaxf(s[nt][0], s[nt][1]));
          m1 = fmaxf(m1, fmaxf(s[nt][2], s[nt][3]));
        }
        m0 = quad_max(m0);
        m1 = quad_max(m1);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float x = expf(s[nt][e] - (e < 2 ? m0 : m1));
            s[nt][e] = x;
            if (e < 2) sum0 += x;
            else sum1 += x;
          }
        }
        sum0 = quad_sum(sum0);
        sum1 = quad_sum(sum1);
        const float inv0 = rcp_rn(sum0), inv1 = rcp_rn(sum1);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          s[nt][0] = ok0 ? div_rn(s[nt][0], sum0, inv0) : 0.f;
          s[nt][1] = ok0 ? div_rn(s[nt][1], sum0, inv0) : 0.f;
          s[nt][2] = ok1 ? div_rn(s[nt][2], sum1, inv1) : 0.f;
          s[nt][3] = ok1 ? div_rn(s[nt][3], sum1, inv1) : 0.f;
        }
        // s now holds W. dW once, D_i from it, then dS; Wc and dS to shared
        // memory, and dQ = dS K one 16-key step at a time as its dS
        // fragments are made, over the steps that hold a key < L
        float dw[NT][4];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) dw[nt][0] = dw[nt][1] = dw[nt][2] = dw[nt][3] = 0.f;
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          uint32_t a[4];
          ldmatrix_x4(a, sg + sw128(rb + (lane & 15), 2 * ks + (lane >> 4)));
#pragma unroll
          for (int np = 0; np < NT / 2; ++np) {
            uint32_t bv[4];
            ldmatrix_x4(bv, sv + sw128(16 * np + (lane & 7) + ((lane >> 4) << 3),
                                       2 * ks + ((lane >> 3) & 1)));
            mma_16816(dw[2 * np], a, bv[0], bv[1]);
            mma_16816(dw[2 * np + 1], a, bv[2], bv[3]);
          }
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          dd0 += dw[nt][0] * s[nt][0] + dw[nt][1] * s[nt][1];
          dd1 += dw[nt][2] * s[nt][2] + dw[nt][3] * s[nt][3];
        }
        dd0 = quad_sum(dd0);
        dd1 = quad_sum(dd1);
#pragma unroll
        for (int dt = 0; dt < 8; ++dt) dq[dt][0] = dq[dt][1] = dq[dt][2] = dq[dt][3] = 0.f;
#pragma unroll
        for (int kt = 0; kt < NT / 2; ++kt) {
          uint32_t a[4];  // dS rounded: the A fragment of dQ's key step kt
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int nt = 2 * kt + half, col = 8 * nt + 2 * c;
            a[2 * half] = pack_bf16((dw[nt][0] - dd0) * s[nt][0], (dw[nt][1] - dd0) * s[nt][1]);
            a[2 * half + 1] =
                pack_bf16((dw[nt][2] - dd1) * s[nt][2], (dw[nt][3] - dd1) * s[nt][3]);
            *reinterpret_cast<uint32_t*>(ds_s + r0 * WS + col) = a[2 * half];
            *reinterpret_cast<uint32_t*>(ds_s + r1 * WS + col) = a[2 * half + 1];
            *reinterpret_cast<uint32_t*>(w_s + r0 * WS + col) = pack_bf16(s[nt][0], s[nt][1]);
            *reinterpret_cast<uint32_t*>(w_s + r1 * WS + col) = pack_bf16(s[nt][2], s[nt][3]);
          }
          if (16 * kt < L) dq_accumulate<4>(dq, a, sk, kt, 0, lane);
        }
      } else {
        // The 16 x LP weights do not fit in registers beside the rest, so
        // each pass walks the keys 16 at a time and makes S again: the row
        // max, the row sum, D_i, then dS and dQ. The weights come out of
        // the same operations in every pass, so the passes agree to the bit.
        uint32_t qa[4][4];
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          ldmatrix_x4(qa[ks], sq + sw128(rb + (lane & 15), 2 * ks + (lane >> 4)));
        auto s_pair = [&](int np, float (&x0)[4], float (&x1)[4]) {
          x0[0] = x0[1] = x0[2] = x0[3] = 0.f;
          x1[0] = x1[1] = x1[2] = x1[3] = 0.f;
#pragma unroll
          for (int ks = 0; ks < 4; ++ks) {
            uint32_t bk[4];
            ldmatrix_x4(bk, sk + sw128(16 * np + (lane & 7) + ((lane >> 4) << 3),
                                       2 * ks + ((lane >> 3) & 1)));
            mma_16816(x0, qa[ks], bk[0], bk[1]);
            mma_16816(x1, qa[ks], bk[2], bk[3]);
          }
          scale_mask(2 * np, x0);
          scale_mask(2 * np + 1, x1);
        };
        for (int np = 0; np < n16; ++np) {
          float x0[4], x1[4];
          s_pair(np, x0, x1);
          m0 = fmaxf(m0, fmaxf(fmaxf(x0[0], x0[1]), fmaxf(x1[0], x1[1])));
          m1 = fmaxf(m1, fmaxf(fmaxf(x0[2], x0[3]), fmaxf(x1[2], x1[3])));
        }
        m0 = quad_max(m0);
        m1 = quad_max(m1);
        for (int np = 0; np < n16; ++np) {
          float x0[4], x1[4];
          s_pair(np, x0, x1);
          sum0 += expf(x0[0] - m0) + expf(x0[1] - m0) + expf(x1[0] - m0) +
                  expf(x1[1] - m0);
          sum1 += expf(x0[2] - m1) + expf(x0[3] - m1) + expf(x1[2] - m1) +
                  expf(x1[3] - m1);
        }
        sum0 = quad_sum(sum0);
        sum1 = quad_sum(sum1);
        const float inv0 = rcp_rn(sum0), inv1 = rcp_rn(sum1);
        // W and dW of keys 16 np ..
        auto w_dw_pair = [&](int np, float (&w0)[4], float (&w1)[4], float (&dw0)[4],
                             float (&dw1)[4]) {
          s_pair(np, w0, w1);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool ok = e < 2 ? ok0 : ok1;
            const float m = e < 2 ? m0 : m1, sm = e < 2 ? sum0 : sum1, inv = e < 2 ? inv0 : inv1;
            w0[e] = ok ? div_rn(expf(w0[e] - m), sm, inv) : 0.f;
            w1[e] = ok ? div_rn(expf(w1[e] - m), sm, inv) : 0.f;
          }
          dw_pair(np, dw0, dw1);
        };
        for (int np = 0; np < n16; ++np) {
          float w0[4], w1[4], dw0[4], dw1[4];
          w_dw_pair(np, w0, w1, dw0, dw1);
          dd0 += dw0[0] * w0[0] + dw0[1] * w0[1] + dw1[0] * w1[0] + dw1[1] * w1[1];
          dd1 += dw0[2] * w0[2] + dw0[3] * w0[3] + dw1[2] * w1[2] + dw1[3] * w1[3];
        }
        dd0 = quad_sum(dd0);
        dd1 = quad_sum(dd1);
#pragma unroll
        for (int dt = 0; dt < 8; ++dt) dq[dt][0] = dq[dt][1] = dq[dt][2] = dq[dt][3] = 0.f;
        for (int np = 0; np < n16; ++np) {
          float w0[4], w1[4], dw0[4], dw1[4];
          w_dw_pair(np, w0, w1, dw0, dw1);
          uint32_t a[4];  // dS rounded: the A fragment of dQ's key step np
          a[0] = pack_bf16((dw0[0] - dd0) * w0[0], (dw0[1] - dd0) * w0[1]);
          a[1] = pack_bf16((dw0[2] - dd1) * w0[2], (dw0[3] - dd1) * w0[3]);
          a[2] = pack_bf16((dw1[0] - dd0) * w1[0], (dw1[1] - dd0) * w1[1]);
          a[3] = pack_bf16((dw1[2] - dd1) * w1[2], (dw1[3] - dd1) * w1[3]);
          dq_accumulate<4>(dq, a, sk, np, 0, lane);
        }
        if (c == 0) {
          max_s[r0] = m0;
          sum_s[r0] = sum0;
          dd_s[r0] = dd0;
          inv_s[r0] = inv0;
          max_s[r1] = m1;
          sum_s[r1] = sum1;
          dd_s[r1] = dd1;
          inv_s[r1] = inv1;
        }
      }
      store_rows(dq_b, dq, scale, r0, r1, L, rs, c);
    }
    __syncthreads();

    // ---- phase 2: key tiles -> dV and dK, summed over the queries ----
    if constexpr (Sh::kStore) {
      // item i: key tile i / 2, dV (i even: Wc^T g) or dK (i odd: dS^T Q);
      // A is the stored Wc or dS read down its columns, B is g or Q read
      // down theirs, both through ldmatrix.trans
      for (int item = warp; item < 2 * n16; item += NW) {
        const int kb = (item >> 1) * 16, is_dk = item & 1;
        const uint32_t a_s = smem_u32(is_dk ? ds_s : w_s);
        const uint32_t b_s = is_dk ? sq : sg;
        float acc[8][4];
#pragma unroll
        for (int dt = 0; dt < 8; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
        for (int qs = 0; qs < n16; ++qs) {
          uint32_t a[4];
          ldmatrix_x4_trans(a, a_s + ((16 * qs + (lane & 7) + ((lane >> 4) << 3)) * WS + kb +
                                      ((lane >> 3) & 1) * 8) *
                                         (uint32_t)sizeof(bf16));
#pragma unroll
          for (int dp = 0; dp < 4; ++dp) {
            uint32_t bb[4];
            ldmatrix_x4_trans(bb, b_s + sw128(16 * qs + (lane & 15), 2 * dp + (lane >> 4)));
            mma_16816(acc[2 * dp], a, bb[0], bb[1]);
            mma_16816(acc[2 * dp + 1], a, bb[2], bb[3]);
          }
        }
        store_rows(dq_b + (is_dk ? E : 2 * E), acc, is_dk ? scale : 1.f, kb + g, kb + g + 8, L,
                   rs, c);
      }
    } else {
      // S^T = K Q^T and dW^T = V g^T recomputed per 16 queries; W^T from the
      // stored max and sum, dS^T from D_i
      for (int kt = warp; kt < n16; kt += NW) {
        const int kb = kt * 16, j0 = kb + g, j1 = j0 + 8;
        float dk[8][4], dv[8][4];
#pragma unroll
        for (int dt = 0; dt < 8; ++dt) {
          dk[dt][0] = dk[dt][1] = dk[dt][2] = dk[dt][3] = 0.f;
          dv[dt][0] = dv[dt][1] = dv[dt][2] = dv[dt][3] = 0.f;
        }
        for (int qs = 0; qs < n16; ++qs) {
          float st[2][4] = {}, dwt[2][4] = {};
#pragma unroll
          for (int ks = 0; ks < 4; ++ks) {
            uint32_t ka[4], va[4], bq[4], bg[4];
            ldmatrix_x4(ka, sk + sw128(kb + (lane & 15), 2 * ks + (lane >> 4)));
            ldmatrix_x4(va, sv + sw128(kb + (lane & 15), 2 * ks + (lane >> 4)));
            const int row = 16 * qs + (lane & 7) + ((lane >> 4) << 3);
            const int ch = 2 * ks + ((lane >> 3) & 1);
            ldmatrix_x4(bq, sq + sw128(row, ch));
            ldmatrix_x4(bg, sg + sw128(row, ch));
            mma_16816(st[0], ka, bq[0], bq[1]);
            mma_16816(st[1], ka, bq[2], bq[3]);
            mma_16816(dwt[0], va, bg[0], bg[1]);
            mma_16816(dwt[1], va, bg[2], bg[3]);
          }
          // st[half][e]: key j0 (e < 2) or j1, query 16 qs + 8 half + 2c + (e & 1)
          uint32_t aw[4], ads[4];
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            float wv[4], dsv[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int i = 16 * qs + 8 * half + 2 * c + (e & 1);
              const int j = e < 2 ? j0 : j1;
              float wt = 0.f;
              if (i < L && j < L) {
                float x = st[half][e] * scale;
                if (mk != nullptr) x += mk[i * L + j];
                wt = div_rn(expf(x - max_s[i]), sum_s[i], inv_s[i]);
              }
              wv[e] = wt;
              dsv[e] = i < L ? (dwt[half][e] - dd_s[i]) * wt : 0.f;
            }
            aw[2 * half] = pack_bf16(wv[0], wv[1]);
            aw[2 * half + 1] = pack_bf16(wv[2], wv[3]);
            ads[2 * half] = pack_bf16(dsv[0], dsv[1]);
            ads[2 * half + 1] = pack_bf16(dsv[2], dsv[3]);
          }
          // dV += Wc^T g, dK += dS^T Q: B read down its columns
#pragma unroll
          for (int dp = 0; dp < 4; ++dp) {
            uint32_t bg[4], bq[4];
            ldmatrix_x4_trans(bg, sg + sw128(16 * qs + (lane & 15), 2 * dp + (lane >> 4)));
            ldmatrix_x4_trans(bq, sq + sw128(16 * qs + (lane & 15), 2 * dp + (lane >> 4)));
            mma_16816(dv[2 * dp], aw, bg[0], bg[1]);
            mma_16816(dv[2 * dp + 1], aw, bg[2], bg[3]);
            mma_16816(dk[2 * dp], ads, bq[0], bq[1]);
            mma_16816(dk[2 * dp + 1], ads, bq[2], bq[3]);
          }
        }
        store_rows(dq_b + E, dk, scale, j0, j1, L, rs, c);
        store_rows(dq_b + 2 * E, dv, 1.f, j0, j1, L, rs, c);
      }
    }
    __syncthreads();  // the stage, Wc, dS and the statistics are free again
  }
}

template <int LP>
cudaError_t launch_bf16_lp(const void* qkv, const void* g, const float* mask, void* dqkv, int B,
                           int L, int E, int H, cudaStream_t stream) {
  auto kernel = attention_bwd_bf16_kernel<LP>;
  constexpr int threads = BwdShape<LP>::NW * 32;
  static const size_t smem[2] = {BwdShape<LP>::smem(false), BwdShape<LP>::smem(true)};
  static int per_sm[2] = {0, 0};
  const int with_mask = mask != nullptr;
  int grid;
  cudaError_t err = persistent_grid(kernel, threads, smem, per_sm, with_mask, B * H, &grid);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem[with_mask], stream>>>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(g), mask,
      static_cast<bf16*>(dqkv), B, L, E, H, 1.0f / sqrtf(64.0f));
  return cudaGetLastError();
}

// the padded lengths of K1's buckets: 50 -> 64, 77 -> 80, 197 -> 208
cudaError_t launch_bf16(const void* qkv, const void* g, const float* mask, void* dqkv, int B,
                        int L, int E, int H, cudaStream_t stream) {
  if (L <= 64) return launch_bf16_lp<64>(qkv, g, mask, dqkv, B, L, E, H, stream);
  if (L <= 80) return launch_bf16_lp<80>(qkv, g, mask, dqkv, B, L, E, H, stream);
  if (L <= 128) return launch_bf16_lp<128>(qkv, g, mask, dqkv, B, L, E, H, stream);
  if (L <= 208) return launch_bf16_lp<208>(qkv, g, mask, dqkv, B, L, E, H, stream);
  return launch_bf16_lp<256>(qkv, g, mask, dqkv, B, L, E, H, stream);
}

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kF32Warps = 8;

// D: head width (multiple of 32). KPL: rows per lane, ceil(L / 32) rounded
// up to the instantiated bound.
template <int D, int KPL>
__global__ void __launch_bounds__(kF32Warps * 32)
attention_bwd_f32_kernel(const float* __restrict__ qkv,
                         const float* __restrict__ gout,
                         const float* __restrict__ mask,
                         float* __restrict__ dqkv, int L, int E, int H,
                         float scale) {
  constexpr int DP = D + 1;    // padded staged row
  constexpr int CPL = D / 32;  // output columns per lane
  extern __shared__ float smem[];
  float* a_s = smem;                   // [L, D+1]: K, then Q
  float* b_s = a_s + L * DP;           // [L, D+1]: V, then g
  float* row_s = b_s + L * DP;         // [warps, 2, D]
  float* max_s = row_s + kF32Warps * 2 * D;
  float* sum_s = max_s + L;
  float* dd_s = sum_s + L;

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const long long row_stride = 3LL * E;
  const float* base = qkv + (long long)b * L * row_stride + h * D;
  const float* gbase = gout + (long long)b * L * E + h * D;
  float* dq_b = dqkv + (long long)b * L * row_stride + h * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* x_w = row_s + warp * 2 * D;  // this warp's row of q (k) ...
  float* y_w = x_w + D;               // ... and of g (v)

  // ---- phase 1: query rows -> statistics, D_i, dQ; K, V staged ----
  for (int idx = threadIdx.x; idx < L * D; idx += blockDim.x) {
    const int j = idx / D, d = idx % D;
    const float* row = base + j * row_stride;
    a_s[j * DP + d] = row[E + d];
    b_s[j * DP + d] = row[2 * E + d];
  }
  __syncthreads();
  for (int i = warp; i < L; i += kF32Warps) {
#pragma unroll
    for (int cc = 0; cc < CPL; ++cc) {
      x_w[lane + 32 * cc] = base[i * row_stride + lane + 32 * cc];
      y_w[lane + 32 * cc] = gbase[(long long)i * E + lane + 32 * cc];
    }
    __syncwarp();
    float w[KPL], dw[KPL];
    float m = -CUDART_INF_F;
#pragma unroll
    for (int t = 0; t < KPL; ++t) {
      const int j = t * 32 + lane;
      w[t] = -CUDART_INF_F;
      dw[t] = 0.f;
      if (j < L) {
        const float* k_row = a_s + j * DP;
        const float* v_row = b_s + j * DP;
        float acc = 0.f, dacc = 0.f;
#pragma unroll 16
        for (int d = 0; d < D; ++d) {
          acc = fmaf(x_w[d], k_row[d], acc);
          dacc = fmaf(y_w[d], v_row[d], dacc);
        }
        float s = acc * scale;
        if (mask != nullptr) s += mask[i * L + j];
        w[t] = s;
        dw[t] = dacc;
      }
      m = fmaxf(m, w[t]);
    }
    m = warp_max(m);
    float sum = 0.f;
#pragma unroll
    for (int t = 0; t < KPL; ++t) {
      const int j = t * 32 + lane;
      w[t] = j < L ? expf(w[t] - m) : 0.f;
      sum += w[t];
    }
    sum = warp_sum(sum);
    float dd = 0.f;
#pragma unroll
    for (int t = 0; t < KPL; ++t) {
      w[t] /= sum;
      dd += dw[t] * w[t];
    }
    dd = warp_sum(dd);
    float acc[CPL];
#pragma unroll
    for (int cc = 0; cc < CPL; ++cc) acc[cc] = 0.f;
#pragma unroll
    for (int t = 0; t < KPL; ++t) {
      const float dsv = (dw[t] - dd) * w[t];
      const int n = min(32, L - t * 32);
      for (int jj = 0; jj < n; ++jj) {
        const float x = __shfl_sync(0xffffffffu, dsv, jj);
        const float* k_row = a_s + (t * 32 + jj) * DP;
#pragma unroll
        for (int cc = 0; cc < CPL; ++cc) acc[cc] = fmaf(x, k_row[lane + 32 * cc], acc[cc]);
      }
    }
    float* o_row = dq_b + (long long)i * row_stride;
#pragma unroll
    for (int cc = 0; cc < CPL; ++cc) o_row[lane + 32 * cc] = acc[cc] * scale;
    if (lane == 0) {
      max_s[i] = m;
      sum_s[i] = sum;
      dd_s[i] = dd;
    }
    __syncwarp();
  }
  __syncthreads();

  // ---- phase 2: key rows -> dK, dV; Q, g staged in the same space ----
  for (int idx = threadIdx.x; idx < L * D; idx += blockDim.x) {
    const int j = idx / D, d = idx % D;
    a_s[j * DP + d] = base[j * row_stride + d];
    b_s[j * DP + d] = gbase[(long long)j * E + d];
  }
  __syncthreads();
  for (int j = warp; j < L; j += kF32Warps) {
#pragma unroll
    for (int cc = 0; cc < CPL; ++cc) {
      x_w[lane + 32 * cc] = base[j * row_stride + E + lane + 32 * cc];
      y_w[lane + 32 * cc] = base[j * row_stride + 2 * E + lane + 32 * cc];
    }
    __syncwarp();
    float w[KPL], dsv[KPL];
#pragma unroll
    for (int t = 0; t < KPL; ++t) {
      const int i = t * 32 + lane;
      w[t] = 0.f;
      dsv[t] = 0.f;
      if (i < L) {
        const float* q_row = a_s + i * DP;
        const float* g_row = b_s + i * DP;
        float acc = 0.f, dacc = 0.f;
#pragma unroll 16
        for (int d = 0; d < D; ++d) {
          acc = fmaf(q_row[d], x_w[d], acc);
          dacc = fmaf(g_row[d], y_w[d], dacc);
        }
        float s = acc * scale;
        if (mask != nullptr) s += mask[i * L + j];
        w[t] = expf(s - max_s[i]) / sum_s[i];
        dsv[t] = (dacc - dd_s[i]) * w[t];
      }
    }
    float dk[CPL], dv[CPL];
#pragma unroll
    for (int cc = 0; cc < CPL; ++cc) dk[cc] = dv[cc] = 0.f;
#pragma unroll
    for (int t = 0; t < KPL; ++t) {
      const int n = min(32, L - t * 32);
      for (int ii = 0; ii < n; ++ii) {
        const float wi = __shfl_sync(0xffffffffu, w[t], ii);
        const float di = __shfl_sync(0xffffffffu, dsv[t], ii);
        const float* q_row = a_s + (t * 32 + ii) * DP;
        const float* g_row = b_s + (t * 32 + ii) * DP;
#pragma unroll
        for (int cc = 0; cc < CPL; ++cc) {
          dv[cc] = fmaf(wi, g_row[lane + 32 * cc], dv[cc]);
          dk[cc] = fmaf(di, q_row[lane + 32 * cc], dk[cc]);
        }
      }
    }
    float* o_row = dq_b + (long long)j * row_stride;
#pragma unroll
    for (int cc = 0; cc < CPL; ++cc) {
      o_row[E + lane + 32 * cc] = dk[cc] * scale;
      o_row[2 * E + lane + 32 * cc] = dv[cc];
    }
    __syncwarp();
  }
}

template <int D, int KPL>
cudaError_t launch_f32(const void* qkv, const void* g, const float* mask, void* dqkv,
                       int B, int L, int E, int H, cudaStream_t stream) {
  auto kernel = attention_bwd_f32_kernel<D, KPL>;
  const size_t smem = sizeof(float) * (2 * (size_t)L * (D + 1) +
                                       (size_t)kF32Warps * 2 * D + 3 * (size_t)L);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const float scale = 1.0f / sqrtf((float)D);
  kernel<<<B * H, kF32Warps * 32, smem, stream>>>(
      static_cast<const float*>(qkv), static_cast<const float*>(g), mask,
      static_cast<float*>(dqkv), L, E, H, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32_len(const void* qkv, const void* g, const float* mask,
                           void* dqkv, int B, int L, int E, int H,
                           cudaStream_t stream) {
  if (L <= 64) return launch_f32<D, 2>(qkv, g, mask, dqkv, B, L, E, H, stream);
  if (L <= 128) return launch_f32<D, 4>(qkv, g, mask, dqkv, B, L, E, H, stream);
  return launch_f32<D, 8>(qkv, g, mask, dqkv, B, L, E, H, stream);
}

}  // namespace

// qkv: [B, L, 3E], g: [B, L, E], dqkv: [B, L, 3E], all contiguous, 16-byte
// aligned and of one dtype (0 = float32, 1 = bfloat16). mask: fp32 [L, L]
// or null. Every MS-CLIP tower has heads of width 64. Returns the launch's
// cudaError_t (0 on success); the caller has checked the shapes.
extern "C" int msclip_attention_bwd(const void* qkv, const void* g, const float* mask,
                                    void* dqkv, int B, int L, int E, int H, int dtype,
                                    void* stream) {
  if (B <= 0 || L <= 0 || L > kMaxSeq || H <= 0 || E % H != 0 || E / H != 64)
    return (int)cudaErrorInvalidValue;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(dtype == 1 ? launch_bf16(qkv, g, mask, dqkv, B, L, E, H, s)
                          : launch_f32_len<64>(qkv, g, mask, dqkv, B, L, E, H, s));
}

extern "C" const char* msclip_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
