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
// before dQ and dK; the softmax, the rowsum(dW * W) term and the scale stay
// fp32; the outputs are rounded to the input type. A -inf in the mask gives
// a weight of exactly 0 (exp(-inf) = 0), so dS is 0 there and no NaN
// appears (a row needs one finite score, as the causal mask leaves).
//
// Bound on an H100 SXM: memory. Each launch reads 4E and writes 3E values
// per token and does 5 products of 2*L*D flops per query row and head. At
// the ViT-B/32 train shape (B=256, L=50, E=768, H=12) in bf16: 137.6 MB of
// I/O, 41 us at 3.35 TB/s, against 2.4 us of matrix work at 989 TFLOP/s.
// What the design does about it: q, k, v and g are read from device memory
// once into shared memory and each dqkv element is written once; scores,
// weights and their gradients live only in registers.
//
// The dK/dV reduction. dQ rows belong to query rows, but dV and dK sum over
// every query row. One block per (sample, head) runs two phases:
//
//   1. query phase: warps own query rows (tiles). Each computes its rows'
//      scores, the softmax max and sum, D_i = rowsum(dW * W), and dQ (which
//      sums over keys, all of them at hand), and leaves max, sum and D_i in
//      shared memory.
//   2. key phase, after a barrier: warps own key rows (tiles). Each
//      recomputes the transposed scores S^T and dW^T of its keys against
//      every query, takes W^T from the stored max and sum, dS^T from D_i,
//      and sums dV and dK over the queries in registers. No atomics, and
//      nothing but the three per-row statistics crosses warps.
//
// The scores are computed twice (and dW three times in bf16, see below):
// seven products instead of the minimum five, traded for a design with no
// cross-warp reduction. Both recomputations use the same operands in the
// same order as the first, so the weights agree with those of phase 1.
//
// Two kernels, chosen by the input type:
//
// * bfloat16: tensor cores through mma.sync m16n8k16 (bf16 in, fp32
//   accumulators), one warp per 16-row tile, up to 8 warps. Q, K, V and g of
//   the head sit in shared memory as [LP, D + 8] bf16 rows (L padded with
//   zero rows to LP, a multiple of 16): 147 KB at L = 256. Operands that the
//   products need transposed (K for dQ, g and Q for dV and dK, whose sums
//   run over rows) are gathered as two 16-bit loads from two rows instead
//   of one 32-bit load, so no transposed copy is kept. In phase 1 a warp
//   keeps its 16 x LP weights in registers, walks the keys once to sum D_i
//   (dW tile by tile) and once more to form dS (dW recomputed) and feed it,
//   still in registers, as the A operand of dQ. In phase 2 a warp walks the
//   queries 16 at a time, so its registers do not grow with L.
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

namespace {

constexpr int kMaxSeq = 256;
constexpr int kMaxWarps = 8;

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

// sum over the four lanes of a quad (the lanes that hold one row of an
// mma.sync accumulator tile)
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
  return v;
}

// ---------------------------------------------------------------------------
// bfloat16: tensor cores
// ---------------------------------------------------------------------------

// D = A(16x16, row) * B(16x8, col) + D, bf16 inputs, fp32 accumulators.
// Fragments (g = lane / 4, c = lane % 4): a0 = A(g, 2c..2c+1),
// a1 = A(g+8, 2c..), a2 = A(g, 2c+8..), a3 = A(g+8, 2c+8..);
// b0 = B(2c..2c+1, g), b1 = B(2c+8.., g); d = {D(g, 2c), D(g, 2c+1),
// D(g+8, 2c), D(g+8, 2c+1)}. Each 32-bit register holds two bf16, the
// lower column (or row of B) in the low half.
__device__ __forceinline__ void mma_16816(float (&d)[4], uint32_t a0, uint32_t a1,
                                          uint32_t a2, uint32_t a3, uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// two consecutive bf16 of one row
__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// the same column of two consecutive rows (row stride ``stride``): the
// B fragment of a product whose sum runs over rows
__device__ __forceinline__ uint32_t ld_col2(const __nv_bfloat16* p, int stride) {
  const uint16_t* u = reinterpret_cast<const uint16_t*>(p);
  return (uint32_t)u[0] | ((uint32_t)u[stride] << 16);
}

// Shared memory, in bf16 elements: Q, K, V and g of the head as [LP, D + 8]
// rows (the +8 pad makes the fragment loads of a warp hit 32 distinct
// banks, for the row loads and the two-row column loads alike), then three
// fp32 statistics per query row: softmax max, softmax sum, D_i.
template <int D, int LP>
struct BwdLayout {
  static constexpr int ds = D + 8;
  static constexpr size_t bytes =
      sizeof(__nv_bfloat16) * 4 * LP * ds + sizeof(float) * 3 * LP;
};

// NT: key tiles of 8, LP = 8 NT a multiple of 16 that covers L.
template <int D, int NT>
__global__ void __launch_bounds__(kMaxWarps * 32)
attention_bwd_bf16_kernel(const __nv_bfloat16* __restrict__ qkv,
                          const __nv_bfloat16* __restrict__ gout,
                          const float* __restrict__ mask,
                          __nv_bfloat16* __restrict__ dqkv, int L, int E, int H,
                          float scale) {
  constexpr int LP = 8 * NT;
  using Lay = BwdLayout<D, LP>;
  constexpr int ds = Lay::ds;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* k_s = q_s + LP * ds;
  __nv_bfloat16* v_s = k_s + LP * ds;
  __nv_bfloat16* g_s = v_s + LP * ds;
  float* max_s = reinterpret_cast<float*>(g_s + LP * ds);
  float* sum_s = max_s + LP;
  float* dd_s = sum_s + LP;

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const long long row_stride = 3LL * E;
  const __nv_bfloat16* base = qkv + (long long)b * L * row_stride + h * D;
  const __nv_bfloat16* gbase = gout + (long long)b * L * E + h * D;
  constexpr int kVecPerRow = D / 8;  // 16-byte vectors of 8 bf16
  for (int idx = threadIdx.x; idx < LP * kVecPerRow; idx += blockDim.x) {
    const int j = idx / kVecPerRow, c8 = 8 * (idx % kVecPerRow);
    uint4 q = make_uint4(0, 0, 0, 0), k = q, v = q, gg = q;
    if (j < L) {  // rows past L are zeros
      const __nv_bfloat16* row = base + j * row_stride + c8;
      q = *reinterpret_cast<const uint4*>(row);
      k = *reinterpret_cast<const uint4*>(row + E);
      v = *reinterpret_cast<const uint4*>(row + 2 * E);
      gg = *reinterpret_cast<const uint4*>(gbase + (long long)j * E + c8);
    }
    *reinterpret_cast<uint4*>(q_s + j * ds + c8) = q;
    *reinterpret_cast<uint4*>(k_s + j * ds + c8) = k;
    *reinterpret_cast<uint4*>(v_s + j * ds + c8) = v;
    *reinterpret_cast<uint4*>(g_s + j * ds + c8) = gg;
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c = lane % 4;
  const int n_tiles = (L + 15) / 16, n_warps = blockDim.x / 32;
  __nv_bfloat16* dq_b = dqkv + (long long)b * L * row_stride + h * D;

  // ---- phase 1: query tiles -> softmax statistics, D_i, dQ ----
  for (int rt = warp; rt < n_tiles; rt += n_warps) {
    const int r0 = rt * 16 + g, r1 = r0 + 8;  // this lane's two query rows
    const __nv_bfloat16* q0 = q_s + r0 * ds + 2 * c;
    const __nv_bfloat16* q1 = q_s + r1 * ds + 2 * c;
    const __nv_bfloat16* g0 = g_s + r0 * ds + 2 * c;
    const __nv_bfloat16* g1 = g_s + r1 * ds + 2 * c;

    // S = Q K^T, tile nt holding keys 8 nt .. 8 nt + 7
    float w[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      w[nt][0] = w[nt][1] = w[nt][2] = w[nt][3] = 0.f;
      const __nv_bfloat16* kr = k_s + (nt * 8 + g) * ds + 2 * c;
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
        mma_16816(w[nt], ld32(q0 + 16 * ks), ld32(q1 + 16 * ks),
                  ld32(q0 + 16 * ks + 8), ld32(q1 + 16 * ks + 8),
                  ld32(kr + 16 * ks), ld32(kr + 16 * ks + 8));
    }
    // scale, mask, fp32 softmax; padded keys get weight 0
    float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = nt * 8 + 2 * c + e;
        float v0 = -CUDART_INF_F, v1 = -CUDART_INF_F;
        if (j < L) {
          v0 = w[nt][e] * scale;
          v1 = w[nt][2 + e] * scale;
          if (mask != nullptr) {
            if (r0 < L) v0 += mask[r0 * L + j];
            if (r1 < L) v1 += mask[r1 * L + j];
          }
        }
        w[nt][e] = v0;
        w[nt][2 + e] = v1;
        m0 = fmaxf(m0, v0);
        m1 = fmaxf(m1, v1);
      }
    }
    m0 = quad_max(m0);
    m1 = quad_max(m1);
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = nt * 8 + 2 * c + e;
        w[nt][e] = j < L ? expf(w[nt][e] - m0) : 0.f;
        w[nt][2 + e] = j < L ? expf(w[nt][2 + e] - m1) : 0.f;
        sum0 += w[nt][e];
        sum1 += w[nt][2 + e];
      }
    }
    sum0 = quad_sum(sum0);
    sum1 = quad_sum(sum1);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      w[nt][0] /= sum0;
      w[nt][1] /= sum0;
      w[nt][2] /= sum1;
      w[nt][3] /= sum1;
    }

    // D_i = rowsum(dW * W), dW = G V^T one key tile at a time
    float dd0 = 0.f, dd1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      float dw[4] = {0.f, 0.f, 0.f, 0.f};
      const __nv_bfloat16* vr = v_s + (nt * 8 + g) * ds + 2 * c;
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
        mma_16816(dw, ld32(g0 + 16 * ks), ld32(g1 + 16 * ks),
                  ld32(g0 + 16 * ks + 8), ld32(g1 + 16 * ks + 8),
                  ld32(vr + 16 * ks), ld32(vr + 16 * ks + 8));
      dd0 += dw[0] * w[nt][0] + dw[1] * w[nt][1];
      dd1 += dw[2] * w[nt][2] + dw[3] * w[nt][3];
    }
    dd0 = quad_sum(dd0);
    dd1 = quad_sum(dd1);

    // dQ = dS K: dW recomputed per 16-key step, dS rounded to bf16 and fed
    // as the A fragment (tiles 2 kt, 2 kt + 1 as they stand); B is K read
    // down its columns
    float dq[D / 8][4];
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) dq[dt][0] = dq[dt][1] = dq[dt][2] = dq[dt][3] = 0.f;
#pragma unroll
    for (int kt = 0; kt < NT / 2; ++kt) {
      uint32_t a[4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int nt = 2 * kt + half;
        float dw[4] = {0.f, 0.f, 0.f, 0.f};
        const __nv_bfloat16* vr = v_s + (nt * 8 + g) * ds + 2 * c;
#pragma unroll
        for (int ks = 0; ks < D / 16; ++ks)
          mma_16816(dw, ld32(g0 + 16 * ks), ld32(g1 + 16 * ks),
                    ld32(g0 + 16 * ks + 8), ld32(g1 + 16 * ks + 8),
                    ld32(vr + 16 * ks), ld32(vr + 16 * ks + 8));
        a[2 * half] = pack_bf16((dw[0] - dd0) * w[nt][0], (dw[1] - dd0) * w[nt][1]);
        a[2 * half + 1] = pack_bf16((dw[2] - dd1) * w[nt][2], (dw[3] - dd1) * w[nt][3]);
      }
      const __nv_bfloat16* kc = k_s + (kt * 16 + 2 * c) * ds + g;
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt)
        mma_16816(dq[dt], a[0], a[1], a[2], a[3], ld_col2(kc + dt * 8, ds),
                  ld_col2(kc + 8 * ds + dt * 8, ds));
    }
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      if (r0 < L)
        *reinterpret_cast<uint32_t*>(dq_b + (long long)r0 * row_stride + dt * 8 + 2 * c) =
            pack_bf16(dq[dt][0] * scale, dq[dt][1] * scale);
      if (r1 < L)
        *reinterpret_cast<uint32_t*>(dq_b + (long long)r1 * row_stride + dt * 8 + 2 * c) =
            pack_bf16(dq[dt][2] * scale, dq[dt][3] * scale);
    }
    if (c == 0) {
      max_s[r0] = m0;
      sum_s[r0] = sum0;
      dd_s[r0] = dd0;
      max_s[r1] = m1;
      sum_s[r1] = sum1;
      dd_s[r1] = dd1;
    }
  }
  __syncthreads();

  // ---- phase 2: key tiles -> dV, dK, summed over the queries ----
  __nv_bfloat16* dk_b = dq_b + E;
  __nv_bfloat16* dv_b = dq_b + 2 * E;
  for (int kt2 = warp; kt2 < n_tiles; kt2 += n_warps) {
    const int j0 = kt2 * 16 + g, j1 = j0 + 8;  // this lane's two key rows
    const __nv_bfloat16* k0 = k_s + j0 * ds + 2 * c;
    const __nv_bfloat16* k1 = k_s + j1 * ds + 2 * c;
    const __nv_bfloat16* v0 = v_s + j0 * ds + 2 * c;
    const __nv_bfloat16* v1 = v_s + j1 * ds + 2 * c;
    float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      dk[dt][0] = dk[dt][1] = dk[dt][2] = dk[dt][3] = 0.f;
      dv[dt][0] = dv[dt][1] = dv[dt][2] = dv[dt][3] = 0.f;
    }
    for (int qt = 0; qt < n_tiles; ++qt) {
      // S^T = K Q^T and dW^T = V G^T for 16 queries (two tiles of 8)
      uint32_t aw[4], ads[4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float st[4] = {0.f, 0.f, 0.f, 0.f}, dwt[4] = {0.f, 0.f, 0.f, 0.f};
        const int qrow = qt * 16 + half * 8 + g;
        const __nv_bfloat16* qr = q_s + qrow * ds + 2 * c;
        const __nv_bfloat16* gr = g_s + qrow * ds + 2 * c;
#pragma unroll
        for (int ks = 0; ks < D / 16; ++ks) {
          mma_16816(st, ld32(k0 + 16 * ks), ld32(k1 + 16 * ks),
                    ld32(k0 + 16 * ks + 8), ld32(k1 + 16 * ks + 8),
                    ld32(qr + 16 * ks), ld32(qr + 16 * ks + 8));
          mma_16816(dwt, ld32(v0 + 16 * ks), ld32(v1 + 16 * ks),
                    ld32(v0 + 16 * ks + 8), ld32(v1 + 16 * ks + 8),
                    ld32(gr + 16 * ks), ld32(gr + 16 * ks + 8));
        }
        // st[e]: key j0 (e < 2) or j1, query qt*16 + half*8 + 2c + (e & 1)
        float wv[4], dsv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = qt * 16 + half * 8 + 2 * c + (e & 1);
          const int j = e < 2 ? j0 : j1;
          float wt = 0.f;
          if (i < L && j < L) {
            float s = st[e] * scale;
            if (mask != nullptr) s += mask[i * L + j];
            wt = expf(s - max_s[i]) / sum_s[i];
          }
          wv[e] = wt;
          dsv[e] = i < L ? (dwt[e] - dd_s[i]) * wt : 0.f;
        }
        aw[2 * half] = pack_bf16(wv[0], wv[1]);
        aw[2 * half + 1] = pack_bf16(wv[2], wv[3]);
        ads[2 * half] = pack_bf16(dsv[0], dsv[1]);
        ads[2 * half + 1] = pack_bf16(dsv[2], dsv[3]);
      }
      // dV += Wc^T G, dK += dS^T Q: B is G (Q) read down its columns
      const __nv_bfloat16* gc = g_s + (qt * 16 + 2 * c) * ds + g;
      const __nv_bfloat16* qc = q_s + (qt * 16 + 2 * c) * ds + g;
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        mma_16816(dv[dt], aw[0], aw[1], aw[2], aw[3], ld_col2(gc + dt * 8, ds),
                  ld_col2(gc + 8 * ds + dt * 8, ds));
        mma_16816(dk[dt], ads[0], ads[1], ads[2], ads[3], ld_col2(qc + dt * 8, ds),
                  ld_col2(qc + 8 * ds + dt * 8, ds));
      }
    }
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      if (j0 < L) {
        *reinterpret_cast<uint32_t*>(dk_b + (long long)j0 * row_stride + dt * 8 + 2 * c) =
            pack_bf16(dk[dt][0] * scale, dk[dt][1] * scale);
        *reinterpret_cast<uint32_t*>(dv_b + (long long)j0 * row_stride + dt * 8 + 2 * c) =
            pack_bf16(dv[dt][0], dv[dt][1]);
      }
      if (j1 < L) {
        *reinterpret_cast<uint32_t*>(dk_b + (long long)j1 * row_stride + dt * 8 + 2 * c) =
            pack_bf16(dk[dt][2] * scale, dk[dt][3] * scale);
        *reinterpret_cast<uint32_t*>(dv_b + (long long)j1 * row_stride + dt * 8 + 2 * c) =
            pack_bf16(dv[dt][2], dv[dt][3]);
      }
    }
  }
}

template <int D, int NT>
cudaError_t launch_bf16_nt(const void* qkv, const void* g, const float* mask,
                           void* dqkv, int B, int L, int E, int H,
                           cudaStream_t stream) {
  auto kernel = attention_bwd_bf16_kernel<D, NT>;
  const size_t smem = BwdLayout<D, 8 * NT>::bytes;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int n_tiles = (L + 15) / 16;
  const int warps = n_tiles < kMaxWarps ? n_tiles : kMaxWarps;
  const float scale = 1.0f / sqrtf((float)D);
  kernel<<<B * H, warps * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(qkv), static_cast<const __nv_bfloat16*>(g),
      mask, static_cast<__nv_bfloat16*>(dqkv), L, E, H, scale);
  return cudaGetLastError();
}

// the padded lengths of K1's buckets: 50 -> 64, 77 -> 80, 197 -> 208
template <int D>
cudaError_t launch_bf16(const void* qkv, const void* g, const float* mask, void* dqkv,
                        int B, int L, int E, int H, cudaStream_t stream) {
  if (L <= 64) return launch_bf16_nt<D, 8>(qkv, g, mask, dqkv, B, L, E, H, stream);
  if (L <= 80) return launch_bf16_nt<D, 10>(qkv, g, mask, dqkv, B, L, E, H, stream);
  if (L <= 128) return launch_bf16_nt<D, 16>(qkv, g, mask, dqkv, B, L, E, H, stream);
  if (L <= 208) return launch_bf16_nt<D, 26>(qkv, g, mask, dqkv, B, L, E, H, stream);
  return launch_bf16_nt<D, 32>(qkv, g, mask, dqkv, B, L, E, H, stream);
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
  return (int)(dtype == 1 ? launch_bf16<64>(qkv, g, mask, dqkv, B, L, E, H, s)
                          : launch_f32_len<64>(qkv, g, mask, dqkv, B, L, E, H, s));
}

extern "C" const char* msclip_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
