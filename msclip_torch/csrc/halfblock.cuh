// Device code shared by the fused attention half-block kernels for Hopper
// (sm_90a): K5 (block_fused.cu) and its tuning variants E1 and the core +
// out-projection kernel E2 (halfblock_tuning.cu). Each source includes it
// into its own anonymous namespace, so nothing here is exported.
//
// What lives here: element types and their roundings, cp.async and the
// bf16 mma.sync product, the warp and block GEMMs over shared-memory tiles
// (WarpMma, Tile, block_gemm, gemm_pass, gemm_192), LayerNorm of rows of
// 768 (layer_norm_rows), one head's fp32 attention on the CUDA cores
// (AttnHead), and K5's body over one group of samples on them
// (attention_halfblock_rows) with its out-projection epilogue
// (out_projection_residual): the fp32 K5, E1 and E2 run these. K5's and
// E1's bf16 body is on wgmma fed by TMA (attention_halfblock_group: the
// tensor maps HalfMaps, the mbarrier ring Ring, wgmma_gemm, qkv_head and
// out_projection_wgmma, with K1's attention from attn_core.cuh); E2's bf16
// body (core_out_group) is that attention on q/k/v tiles copied straight
// from its qkv, and the same out-projection. K6's bf16 body
// (block_fused.cu) runs wgmma_gemm and out_projection_wgmma on its own
// tensor maps. block_fused.cu's header comment has the design and the
// rounding points.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <cuda.h>
#include <cstdint>
#include <type_traits>

#include "attn_core.cuh"
#include "hopper.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kE = 768;            // width
constexpr int kHeads = 12;
constexpr int kD = 64;             // head width
constexpr int kQkv = 3 * kD;       // one head's q, k and v columns
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxSeq = 256;
constexpr int kGroupRows = 128;    // GEMM rows per pass of the mma.sync body (GROUP_ROWS)

// ---------------------------------------------------------------------------
// element types
// ---------------------------------------------------------------------------

template <typename T>
__device__ __forceinline__ float to_f(T v);
template <>
__device__ __forceinline__ float to_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f<bf16>(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16_rn(v); }

// round an fp32 result to T and back (a no-op for fp32)
template <typename T>
__device__ __forceinline__ float round_to(float v) { return to_f<T>(from_f<T>(v)); }

// Eight consecutive elements in their type: one 16-byte register tuple for
// bf16, two for fp32.
template <typename T>
struct Vec8;

template <>
struct Vec8<bf16> {
  uint4 raw;
  __device__ __forceinline__ void load(const bf16* p) { raw = *reinterpret_cast<const uint4*>(p); }
  __device__ __forceinline__ void store(bf16* p) const { *reinterpret_cast<uint4*>(p) = raw; }
  __device__ __forceinline__ float get(int i) const {
    return __bfloat162float(reinterpret_cast<const bf16*>(&raw)[i]);
  }
  __device__ __forceinline__ void set(int i, float v) {
    reinterpret_cast<bf16*>(&raw)[i] = __float2bfloat16_rn(v);
  }
};

template <>
struct Vec8<float> {
  float4 raw[2];
  __device__ __forceinline__ void load(const float* p) {
    raw[0] = reinterpret_cast<const float4*>(p)[0];
    raw[1] = reinterpret_cast<const float4*>(p)[1];
  }
  __device__ __forceinline__ void store(float* p) const {
    reinterpret_cast<float4*>(p)[0] = raw[0];
    reinterpret_cast<float4*>(p)[1] = raw[1];
  }
  __device__ __forceinline__ float get(int i) const { return reinterpret_cast<const float*>(raw)[i]; }
  __device__ __forceinline__ void set(int i, float v) { reinterpret_cast<float*>(raw)[i] = v; }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// ---------------------------------------------------------------------------
// PTX: asynchronous copies and the bf16 mma.sync product
// ---------------------------------------------------------------------------

// 16 bytes global -> shared at a generic pointer, or 16 zero bytes when
// !valid (hopper.cuh has the form that takes a shared address)
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  cp_async16(smem_u32(smem), gmem, valid);
}

// D = A(16x16, row) * B(16x8, col) + D, bf16 inputs, fp32 accumulators.
// Fragments (g = lane / 4, c = lane % 4): a0 = A(g, 2c..2c+1),
// a1 = A(g+8, 2c..), a2 = A(g, 2c+8..), a3 = A(g+8, 2c+8..);
// b0 = B(2c..2c+1, g), b1 = B(2c+8.., g); d = {D(g, 2c), D(g, 2c+1),
// D(g+8, 2c), D(g+8, 2c+1)}. Each 32-bit register holds two bf16, the
// lower column (or row of B) in the low half.
__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// ---------------------------------------------------------------------------
// Warp products over one staged chunk: acc[i][j] += A(m-tile i) W(n-tile j)^T
// ---------------------------------------------------------------------------
//
// Both operands sit in shared memory row-major with the reduction index k
// contiguous (W is a [out, in] weight: its row n is output column n), with
// a row stride of LD elements (the chunk plus 16 bytes, so that the eight
// rows a warp reads at once start in eight distinct bank quads). a points
// at row 0 of the warp's first m-tile; its m-tile i starts i * WM * 16 rows
// later. w points at row 0 of the warp's first n-tile; n-tile j follows at
// 8 j rows. The accumulator layout is mma.sync's for both types: acc[..][0]
// = D(g, 2c), [1] = D(g, 2c + 1), [2] = D(g + 8, 2c), [3] = D(g + 8, 2c + 1).

template <typename T, int KC, int LD, int MPW, int NPW, int WM>
struct WarpMma;

template <int KC, int LD, int MPW, int NPW, int WM>
struct WarpMma<bf16, KC, LD, MPW, NPW, WM> {
  static __device__ __forceinline__ void run(float (&acc)[MPW][NPW][4], const bf16* a,
                                             const bf16* w, int lane) {
    const int g = lane >> 2, c = lane & 3;
#pragma unroll
    for (int ks = 0; ks < KC / 16; ++ks) {
      uint32_t af[MPW][4];
#pragma unroll
      for (int i = 0; i < MPW; ++i) {
        const bf16* p = a + (i * WM * 16 + g) * LD + 16 * ks + 2 * c;
        af[i][0] = ld32(p);
        af[i][1] = ld32(p + 8 * LD);
        af[i][2] = ld32(p + 8);
        af[i][3] = ld32(p + 8 * LD + 8);
      }
#pragma unroll
      for (int j = 0; j < NPW; ++j) {
        const bf16* q = w + (j * 8 + g) * LD + 16 * ks + 2 * c;
        const uint32_t b0 = ld32(q), b1 = ld32(q + 8);
#pragma unroll
        for (int i = 0; i < MPW; ++i)
          mma_bf16(acc[i][j], af[i][0], af[i][1], af[i][2], af[i][3], b0, b1);
      }
    }
  }
};

__device__ __forceinline__ float dot4(const float4& a, const float4& b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// fp32 on the CUDA cores: each lane computes the four accumulator elements
// that mma.sync would give it, four k at a time from 16-byte loads.
template <int KC, int LD, int MPW, int NPW, int WM>
struct WarpMma<float, KC, LD, MPW, NPW, WM> {
  static __device__ __forceinline__ void run(float (&acc)[MPW][NPW][4], const float* a,
                                             const float* w, int lane) {
    const int g = lane >> 2, c = lane & 3;
#pragma unroll
    for (int k4 = 0; k4 < KC / 4; ++k4) {
      float4 a0[MPW], a1[MPW];
#pragma unroll
      for (int i = 0; i < MPW; ++i) {
        const float* p = a + (i * WM * 16 + g) * LD + 4 * k4;
        a0[i] = *reinterpret_cast<const float4*>(p);
        a1[i] = *reinterpret_cast<const float4*>(p + 8 * LD);
      }
#pragma unroll
      for (int j = 0; j < NPW; ++j) {
        const float* q = w + (j * 8 + 2 * c) * LD + 4 * k4;
        const float4 w0 = *reinterpret_cast<const float4*>(q);
        const float4 w1 = *reinterpret_cast<const float4*>(q + LD);
#pragma unroll
        for (int i = 0; i < MPW; ++i) {
          acc[i][j][0] = dot4(a0[i], w0, acc[i][j][0]);
          acc[i][j][1] = dot4(a0[i], w1, acc[i][j][1]);
          acc[i][j][2] = dot4(a1[i], w0, acc[i][j][2]);
          acc[i][j][3] = dot4(a1[i], w1, acc[i][j][3]);
        }
      }
    }
  }
};

// ---------------------------------------------------------------------------
// Block GEMM: acc += A[rows, K] W[N, K]^T, both staged through shared memory
// ---------------------------------------------------------------------------
//
// The 8 warps form a WM x WN grid: warp (wm, wn) owns m-tiles wm, wm + WM,
// ... (MPW of them) and n-tiles wn NPW .. wn NPW + NPW - 1, so the block
// covers ROWS = 16 MPW WM rows and N = 8 NPW WN columns. Row r of A is
// a + r lda, rows r >= a_rows read as zeros; row n of W is w_row(n). K is
// walked in chunks of KCB bytes a row through a ring of three stages: while
// chunk kc is multiplied, chunks kc + 1 and kc + 2 are in flight
// (cp.async), and one barrier a chunk both publishes chunk kc and frees the
// stage of chunk kc - 1 for chunk kc + 2.

template <typename T, int KCB, int MPW, int NPW, int WM>
struct Tile {
  static constexpr int WN = kWarps / WM;
  static constexpr int KC = KCB / (int)sizeof(T);
  static constexpr int LD = KC + 16 / (int)sizeof(T);
  static constexpr int ROWS = 16 * MPW * WM;
  static constexpr int N = 8 * NPW * WN;
  static constexpr int VPR = KCB / 16;  // 16-byte vectors per row and chunk
  static constexpr int STAGE = (ROWS + N) * LD;
  static constexpr int STAGES = 3;
  static constexpr size_t smem_bytes = STAGES * (size_t)STAGE * sizeof(T);
};

template <typename T, int KCB, int MPW, int NPW, int WM, typename WRow>
__device__ void block_gemm(float (&acc)[MPW][NPW][4], const T* __restrict__ a, int lda,
                           int a_rows, WRow w_row, int K, unsigned char* smem) {
  using Tl = Tile<T, KCB, MPW, NPW, WM>;
  constexpr int LD = Tl::LD, ROWS = Tl::ROWS, VPR = Tl::VPR, EPV = 16 / (int)sizeof(T);
  T* stage = reinterpret_cast<T*>(smem);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp % WM, wn = warp / WM;
  const int n_chunks = K / Tl::KC;

  auto load = [&](int kc, int buf) {
    T* sa = stage + buf * Tl::STAGE;
    const int k0 = kc * Tl::KC;
    for (int idx = threadIdx.x; idx < (ROWS + Tl::N) * VPR; idx += kThreads) {
      const int r = idx / VPR, e = (idx % VPR) * EPV;
      if (r < ROWS) {
        const bool ok = r < a_rows;
        cp_async16(sa + r * LD + e, a + (size_t)(ok ? r : 0) * lda + k0 + e, ok);
      } else {
        cp_async16(sa + r * LD + e, w_row(r - ROWS) + k0 + e, true);
      }
    }
  };

  // one commit group a chunk (empty past the last), so that "all but the
  // newest group done" always means "chunk kc has landed"
  load(0, 0);
  cp_async_commit();
  if (n_chunks > 1) load(1, 1);
  cp_async_commit();
  for (int kc = 0; kc < n_chunks; ++kc) {
    cp_async_wait<1>();
    __syncthreads();  // chunk kc visible to all; every warp is past kc - 1
    if (kc + 2 < n_chunks) load(kc + 2, (kc + 2) % Tl::STAGES);
    cp_async_commit();
    const T* sa = stage + (kc % Tl::STAGES) * Tl::STAGE;
    WarpMma<T, Tl::KC, LD, MPW, NPW, WM>::run(acc, sa + wm * 16 * LD,
                                              sa + (ROWS + wn * NPW * 8) * LD, lane);
  }
  cp_async_wait<0>();
  __syncthreads();  // the caller's next GEMM refills every stage
}

// f(row, col, value) for each accumulator element of this thread, with row
// and col within the block's tile
template <int MPW, int NPW, int WM, typename F>
__device__ __forceinline__ void for_each_acc(const float (&acc)[MPW][NPW][4], F f) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp % WM, wn = warp / WM, g = lane >> 2, c = lane & 3;
#pragma unroll
  for (int i = 0; i < MPW; ++i) {
#pragma unroll
    for (int j = 0; j < NPW; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        f((wm + i * WM) * 16 + g + (e >> 1) * 8, (wn * NPW + j) * 8 + 2 * c + (e & 1),
          acc[i][j][e]);
    }
  }
}

template <int MPW, int NPW>
__device__ __forceinline__ void zero(float (&acc)[MPW][NPW][4]) {
#pragma unroll
  for (int i = 0; i < MPW; ++i)
#pragma unroll
    for (int j = 0; j < NPW; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;
}

// One pass of at most ROWS rows: acc = A W^T, then epi(row, col, value) for
// the rows below n.
template <typename T, int MPW, int NPW, int WM, typename WRow, typename Epi>
__device__ void gemm_pass(const T* a, int n, WRow w_row, unsigned char* smem, Epi epi) {
  float acc[MPW][NPW][4];
  zero(acc);
  block_gemm<T, 128, MPW, NPW, WM>(acc, a, kE, n, w_row, kE, smem);
  for_each_acc<MPW, NPW, WM>(acc, [&](int r, int col, float v) {
    if (r < n) epi(r, col, v);
  });
}

// K5's GEMMs: A [rows, 768] (row stride 768) times 192 rows of W, in passes
// of at most 128 rows, each pass with the warp grid that wastes the fewest
// padded rows: 64 rows as 2 x 4 warps, 80 as 1 x 8, 128 as 2 x 4.
template <typename T, typename WRow, typename Epi>
__device__ void gemm_192(const T* a, int rows, WRow w_row, unsigned char* smem, Epi epi) {
  for (int r0 = 0; r0 < rows; r0 += kGroupRows) {
    const int n = min(rows - r0, kGroupRows);
    const T* ar = a + (size_t)r0 * kE;
    auto epi_r = [&](int r, int col, float v) { epi(r0 + r, col, v); };
    if (n > 80)
      gemm_pass<T, 4, 6, 2>(ar, n, w_row, smem, epi_r);
    else if (n > 64)
      gemm_pass<T, 5, 3, 1>(ar, n, w_row, smem, epi_r);
    else
      gemm_pass<T, 2, 6, 2>(ar, n, w_row, smem, epi_r);
  }
}

constexpr size_t kGemmSmem = Tile<float, 128, 4, 6, 2>::smem_bytes;  // the largest pass
static_assert(Tile<bf16, 128, 4, 6, 2>::smem_bytes == kGemmSmem, "same bytes for both types");
static_assert(Tile<float, 128, 5, 3, 1>::N == kQkv && Tile<float, 128, 2, 6, 2>::N == kQkv &&
                  Tile<float, 128, 4, 6, 2>::N == kQkv,
              "every pass covers 192 columns");

// ---------------------------------------------------------------------------
// LayerNorm of rows of 768, one warp a row, into h (row stride 768)
// ---------------------------------------------------------------------------

template <typename T>
__device__ void layer_norm_rows(const T* __restrict__ x, const T* __restrict__ w,
                                const T* __restrict__ b, T* __restrict__ h, int rows, float eps) {
  constexpr int C = kE / 8 / 32;  // 8-element chunks per lane
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < rows; r += kWarps) {
    const T* xr = x + (size_t)r * kE;
    Vec8<T> v[C];
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < C; ++j) {
      v[j].load(xr + (lane + 32 * j) * 8);
#pragma unroll
      for (int i = 0; i < 8; ++i) sum = __fadd_rn(sum, v[j].get(i));
    }
    const float mean = __fdiv_rn(warp_sum(sum), (float)kE);
    float sq = 0.f;
#pragma unroll
    for (int j = 0; j < C; ++j) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float d = __fsub_rn(v[j].get(i), mean);
        sq = __fadd_rn(sq, __fmul_rn(d, d));
      }
    }
    const float rstd = rsqrtf(__fadd_rn(__fdiv_rn(warp_sum(sq), (float)kE), eps));
#pragma unroll
    for (int j = 0; j < C; ++j) {
      const int off = (lane + 32 * j) * 8;
      Vec8<T> wc, bc, out;
      wc.load(w + off);
      bc.load(b + off);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float normed = round_to<T>(__fmul_rn(__fsub_rn(v[j].get(i), mean), rstd));
        out.set(i, __fadd_rn(round_to<T>(__fmul_rn(wc.get(i), normed)), bc.get(i)));
      }
      out.store(h + (size_t)r * kE + off);
    }
  }
}

// ---------------------------------------------------------------------------
// One head's fp32 attention to ctx (row stride 768, offset to the head's
// columns). K1's arithmetic and layout. q, k and v point at row 0 of the
// head's columns, each row ld elements after the last: K5's workspace
// q/k/v [L, 192] (ld 192), or a qkv [L, 2304] as K1 reads it (ld 2304).
// Recip normalizes the softmax as e * (1 / sum) instead of e / sum. (The
// bf16 bodies run K1's wgmma attention from attn_core.cuh.)
// ---------------------------------------------------------------------------

template <typename T, int A, bool Recip = false>
struct AttnHead;

// fp32, CUDA cores. KPL keys per lane (L <= 32 KPL). K_h ([L, D + 1]: 32
// lanes reading 32 keys hit 32 banks) and V_h ([L, D]) in shared memory;
// each warp walks query rows, lane l owning keys l, l + 32, ..., so that
// the scores stay in registers; for PV lane l owns output columns l, l + 32
// and the weights are broadcast with shuffles.
template <int KPL, bool Recip>
struct AttnHead<float, KPL, Recip> {
  static constexpr int DP = kD + 1, CPL = kD / 32;
  static constexpr size_t smem_bytes =
      sizeof(float) * ((size_t)32 * KPL * DP + (size_t)32 * KPL * kD + kWarps * kD);

  static __device__ void run(const float* __restrict__ q, const float* __restrict__ k,
                             const float* __restrict__ v, int ld, const float* __restrict__ mask,
                             float* __restrict__ ctx, int L, float scale, unsigned char* smem) {
    float* k_s = reinterpret_cast<float*>(smem);
    float* v_s = k_s + L * DP;
    float* q_s = v_s + L * kD;
    for (int idx = threadIdx.x; idx < L * kD; idx += kThreads) {
      const int j = idx / kD, d = idx % kD;
      k_s[j * DP + d] = k[(size_t)j * ld + d];
      v_s[j * kD + d] = v[(size_t)j * ld + d];
    }
    __syncthreads();

    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    float* q_w = q_s + warp * kD;
    for (int i = warp; i < L; i += kWarps) {
      const float* q_row = q + (size_t)i * ld;
#pragma unroll
      for (int c = 0; c < CPL; ++c) q_w[lane + 32 * c] = q_row[lane + 32 * c];
      __syncwarp();

      float s[KPL];
      float m = -CUDART_INF_F;
#pragma unroll
      for (int t = 0; t < KPL; ++t) {
        const int j = t * 32 + lane;
        s[t] = -CUDART_INF_F;
        if (j < L) {
          const float* k_row = k_s + j * DP;
          float acc = 0.f;
#pragma unroll 16
          for (int d = 0; d < kD; ++d) acc = fmaf(q_w[d], k_row[d], acc);
          float sc = acc * scale;
          if (mask != nullptr) sc += mask[i * L + j];
          s[t] = sc;
        }
        m = fmaxf(m, s[t]);
      }
      m = warp_max(m);
      float sum = 0.f;
#pragma unroll
      for (int t = 0; t < KPL; ++t) {
        const int j = t * 32 + lane;
        s[t] = j < L ? expf(s[t] - m) : 0.f;
        sum += s[t];
      }
      sum = warp_sum(sum);
      if constexpr (Recip) {
        const float inv = __fdiv_rn(1.f, sum);
#pragma unroll
        for (int t = 0; t < KPL; ++t) s[t] = __fmul_rn(s[t], inv);
      } else {
#pragma unroll
        for (int t = 0; t < KPL; ++t) s[t] /= sum;
      }

      float acc[CPL];
#pragma unroll
      for (int c = 0; c < CPL; ++c) acc[c] = 0.f;
#pragma unroll
      for (int t = 0; t < KPL; ++t) {
        const int n = min(32, L - t * 32);
        for (int jj = 0; jj < n; ++jj) {
          const float w = __shfl_sync(0xffffffffu, s[t], jj);
          const float* v_row = v_s + (t * 32 + jj) * kD;
#pragma unroll
          for (int c = 0; c < CPL; ++c) acc[c] = fmaf(w, v_row[lane + 32 * c], acc[c]);
        }
      }
      float* o_row = ctx + (size_t)i * kE;
#pragma unroll
      for (int c = 0; c < CPL; ++c) o_row[lane + 32 * c] = acc[c];
      __syncwarp();
    }
  }
};

// ---------------------------------------------------------------------------
// K5's body
// ---------------------------------------------------------------------------

constexpr float kScale = 0.125f;  // kD^-1/2

// The numeric variants of the attention half-block (the JAX bodies of
// experiments/halfblock_tuning.py): kBase is K5's function (v0, v2, v3);
// kQkvRounded rounds the qkv GEMM before adding its bias in T (v1);
// kReciprocal normalizes the softmax as e * (1 / sum) (v2c); kNoHeads
// replaces the attention by ctx = v + 1e-4 q + 1e-4 k in T (v2a).
enum Variant : int { kBase = 0, kQkvRounded = 1, kReciprocal = 2, kNoHeads = 3 };

// ob = xb + (ctx W_out^T + b_out) for rows of 768: the out-projection over
// four column tiles of 192, the fp32 bias added before the rounding to T and
// the residual added in T in its epilogue.
template <typename T>
__device__ void out_projection_residual(const T* ctx, int rows, const T* __restrict__ w_out,
                                        const float* __restrict__ b_out, const T* __restrict__ xb,
                                        T* __restrict__ ob, unsigned char* smem) {
  for (int n0 = 0; n0 < kE; n0 += kQkv) {
    auto w_row = [&](int n) { return w_out + (size_t)(n0 + n) * kE; };
    gemm_192<T>(ctx, rows, w_row, smem, [&](int r, int col, float v) {
      const size_t o = (size_t)r * kE + n0 + col;
      const float y = round_to<T>(__fadd_rn(v, b_out[n0 + col]));
      ob[o] = from_f<T>(__fadd_rn(to_f<T>(xb[o]), y));
    });
  }
}

// K5's body over one group of rows (whole samples of L tokens, contiguous in
// xb and ob): LN1 into h; per head the [rows, 768] x [768, 192] q/k/v GEMM
// into qkv, then the head's attention (or v2a's blend) into ctx; last the
// out-projection with bias and residual. h, ctx [rows, 768] and qkv [rows,
// 192] are the block's workspace.
template <typename T, int A, int V>
__device__ void attention_halfblock_rows(const T* __restrict__ xb, const T* __restrict__ ln_w,
                                         const T* __restrict__ ln_b, const T* __restrict__ w_in,
                                         const float* __restrict__ b_in,
                                         const T* __restrict__ w_out,
                                         const float* __restrict__ b_out,
                                         const float* __restrict__ mask, T* __restrict__ ob, T* h,
                                         T* ctx, T* qkv, int rows, int L, float eps,
                                         unsigned char* smem) {
  layer_norm_rows<T>(xb, ln_w, ln_b, h, rows, eps);
  __syncthreads();

  for (int hh = 0; hh < kHeads; ++hh) {
    // row n of the head's [192, 768] weight: q, k or v row n % 64
    auto w_row = [&](int n) {
      return w_in + ((size_t)(n / kD) * kE + hh * kD + n % kD) * kE;
    };
    gemm_192<T>(h, rows, w_row, smem, [&](int r, int col, float v) {
      const float bias = b_in[(col / kD) * kE + hh * kD + col % kD];
      const float y = V == kQkvRounded ? __fadd_rn(round_to<T>(v), round_to<T>(bias))
                                       : __fadd_rn(v, bias);
      qkv[r * kQkv + col] = from_f<T>(y);
    });
    __syncthreads();
    if constexpr (V == kNoHeads) {
      const float c = round_to<T>(1e-4f);  // the coefficient in T, as JAX's weak scalar
      for (int i = threadIdx.x; i < rows * kD; i += kThreads) {
        const T* row = qkv + (size_t)(i / kD) * kQkv + i % kD;
        const float t = round_to<T>(
            __fadd_rn(to_f<T>(row[2 * kD]), round_to<T>(__fmul_rn(c, to_f<T>(row[0])))));
        ctx[(size_t)(i / kD) * kE + hh * kD + i % kD] =
            from_f<T>(__fadd_rn(t, round_to<T>(__fmul_rn(c, to_f<T>(row[kD])))));
      }
      __syncthreads();
    } else {
      for (int r0 = 0; r0 < rows; r0 += L) {  // attention sample by sample
        const T* q = qkv + (size_t)r0 * kQkv;
        AttnHead<T, A, V == kReciprocal>::run(q, q + kD, q + 2 * kD, kQkv, mask,
                                              ctx + (size_t)r0 * kE + hh * kD, L, kScale, smem);
        __syncthreads();
      }
    }
  }
  out_projection_residual<T>(ctx, rows, w_out, b_out, xb, ob, smem);
  // the next group's LayerNorm overwrites h, which the last GEMM's trailing
  // barrier has released
}

// ---------------------------------------------------------------------------
// K5's bf16 body on wgmma (K5 and E1)
// ---------------------------------------------------------------------------
//
// A block owns a group of ns whole samples, at most 256 rows (one sample
// when L > 128), whose rows are contiguous in x and out. LN1 of its rows
// goes to its slice h of a device-memory workspace. Then for each head one
// GEMM [rows, 768] x [768, 192] (the head's q, k and v rows of the
// in-projection) on wgmma, each weight tile staged once for all the
// group's rows; its epilogue adds the fp32 bias, rounds, and writes q, k
// and v as one swizzled [LP, 64] tile per sample into the shared memory
// the GEMM's ring held, rows past L zero. The two warpgroups then take the
// group's (sample, 64-row query tile) units in turn through K1's attention
// (attn_core.cuh), writing the head's context columns to the slice ctx.
// Last, the out-projection [rows, 768] x [768, 768] as four GEMMs of 192
// columns, the bias and the residual in their epilogue.
//
// The GEMMs' operands come by TMA: thread 0 loads each 64-wide K chunk of
// the activation rows (h or ctx, through a tensor map over the workspace)
// and of the 192 weight rows (three 64-row boxes of w_in or w_out) into a
// ring of four stages, two chunks ahead, each stage with a "full" mbarrier
// that counts the bytes landing and an "empty" one that every thread
// arrives on once its products of the stage are done. No block barrier
// runs inside a GEMM.

// the bf16 group's limits; ops/block_fused.py (WGMMA_ROWS, TILE_ROWS)
// plans the groups with them, held to these by a test
constexpr int kWgRows = 256;                   // rows of a bf16 group
constexpr int kWgTileRows = 512;               // its padded q/k/v rows (ns LP)
constexpr int kChunk = 64;                     // K of a staged chunk: one swizzle row
constexpr int kChunks = kE / kChunk;
constexpr int kBoxRows = 128;                  // activation rows a TMA box holds
constexpr uint32_t kStageA = kWgRows * 128;    // a chunk's activation rows
constexpr uint32_t kStageW = kQkv * 128;       // a chunk's 192 weight rows
constexpr uint32_t kStageBytes = kStageA + kStageW;
constexpr int kStages = 4;
// chunks in flight ahead of the one multiplied; the products of the
// kStages - kPrefetch - 1 chunks before it may still run
constexpr int kPrefetch = 2;
// dynamic shared memory: alignment slack, the ring, its 2 kStages mbarriers
constexpr size_t kWgmmaSmem = 1024 + (size_t)kStages * kStageBytes + 16 * kStages;
static_assert(3u * kWgTileRows * 128 <= kStages * kStageBytes, "q/k/v tiles fit in the ring");
static_assert(kWgmmaSmem <= 232448, "one block's shared memory");

// dynamic shared memory of the K5, E1 and E2 kernels at attention tile A:
// the bf16 ring, or the fp32 body's larger of one head's attention and a
// GEMM pass
template <typename T, int A>
constexpr size_t halfblock_smem() {
  if constexpr (std::is_same<T, bf16>::value) return kWgmmaSmem;
  else return AttnHead<T, A>::smem_bytes > kGemmSmem ? AttnHead<T, A>::smem_bytes : kGemmSmem;
}

// Whether ns samples of length L make a bf16 group: at most 256 rows and
// 512 padded tile rows, or one sample.
__host__ __device__ constexpr bool bf16_group_fits(int ns, int L) {
  return ns == 1 || (ns >= 1 && ns * L <= kWgRows && ns * padded_len(L) <= kWgTileRows);
}

// The tensor maps of the bf16 body, kernel parameters (__grid_constant__):
// the workspace as rows of 768 in boxes of 128 rows, w_in and w_out in
// boxes of 64 rows, each box 64 columns wide in the 128-byte swizzle.
struct HalfMaps {
  CUtensorMap ws, w_in, w_out;
};

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// A map of `rows` bf16 rows of `width` (768 unless given) at base in boxes
// of 64 columns x box_rows, through the driver's encoder (fetched once from
// the runtime, so the library does not link against the driver).
inline cudaError_t tile_map(CUtensorMap* map, const void* base, long long rows, int box_rows,
                            int width = kE) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault,
                                              &found);
#endif
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) return cudaErrorNotSupported;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint64_t dims[2] = {(cuuint64_t)width, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)width * sizeof(bf16)};
  const cuuint32_t box[2] = {(cuuint32_t)kChunk, (cuuint32_t)box_rows};
  const cuuint32_t steps[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims,
                            strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The maps of one launch: the workspace's slots x slot elements, w_in
// [2304, 768] and w_out [768, 768].
inline cudaError_t half_maps(HalfMaps* maps, const void* ws, long long slots, long long slot,
                             const void* w_in, const void* w_out) {
  cudaError_t err;
  if ((err = tile_map(&maps->ws, ws, slots * slot / kE, kBoxRows)) != cudaSuccess) return err;
  if ((err = tile_map(&maps->w_in, w_in, 3 * kE, kD)) != cudaSuccess) return err;
  return tile_map(&maps->w_out, w_out, kE, kD);
}

// The block's ring: stage s at base + s kStageBytes, its full and empty
// mbarriers at bars + 8 s and bars + 8 (kStages + s); `it` counts the
// chunks this block's GEMMs have gone through (every thread keeps it).
struct Ring {
  uint32_t base, bars, it;
  unsigned char* ptr;  // base as a generic pointer
  __device__ uint32_t full(int s) const { return bars + 8 * s; }
  __device__ uint32_t empty(int s) const { return bars + 8 * (kStages + s); }
};

// The ring of the block's dynamic shared memory, its mbarriers initialized
// (full: thread 0's arrival and the bytes; empty: every thread). Ends in a
// block barrier.
__device__ __forceinline__ Ring make_ring(unsigned char* smem_raw) {
  const uint32_t raw = smem_u32(smem_raw);
  Ring ring;
  ring.base = (raw + 1023u) & ~1023u;
  ring.ptr = smem_raw + (ring.base - raw);
  ring.bars = ring.base + kStages * kStageBytes;
  ring.it = 0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(ring.full(s), 1);
      mbar_init(ring.empty(s), kThreads);
    }
    mbar_fence_init();
  }
  __syncthreads();
  return ring;
}

// acc = A W^T over the group, K = 64 KCH: A the rows a_row0 .. a_row0 +
// 128 MPW of *amap (the group's rows first; the products of the rows past
// them are not used), W the 192 rows w_row0 + t w_step + (0 .. 64), t < 3,
// of *wmap. Warpgroup w owns the 64-row m-tiles w + 2 i (i < MPW),
// wgmma.m64n192k16 with both operands from shared memory (K-major,
// 128-byte swizzle). Thread 0 keeps kPrefetch chunks in flight; each
// warpgroup leaves one chunk's products running while it waits for the
// next chunk.
template <int MPW, int KCH = kChunks>
__device__ __forceinline__ void wgmma_gemm(float (&acc)[MPW][kQkv / 2], const CUtensorMap* amap,
                                           int a_row0, const CUtensorMap* wmap, int w_row0,
                                           int w_step, Ring& ring) {
  const int wg = threadIdx.x >> 7;
  const uint32_t it0 = ring.it;
#pragma unroll
  for (int i = 0; i < MPW; ++i)
#pragma unroll
    for (int e = 0; e < kQkv / 2; ++e) acc[i][e] = 0.f;

  // thread 0: chunk kc into its stage, once every thread has released it
  auto load = [&](int kc) {
    const uint32_t j = it0 + kc, s = j % kStages;
    mbar_wait(ring.empty(s), ((j / kStages) & 1) ^ 1);
    mbar_arrive_expect_tx(ring.full(s), (128 * MPW + kQkv) * 128);
    const uint32_t sa = ring.base + s * kStageBytes;
#pragma unroll
    for (int m = 0; m < MPW; ++m)
      tma_load_2d(sa + m * kBoxRows * 128, amap, ring.full(s), kc * kChunk,
                  a_row0 + m * kBoxRows);
#pragma unroll
    for (int t = 0; t < 3; ++t)
      tma_load_2d(sa + kStageA + t * kD * 128, wmap, ring.full(s), kc * kChunk,
                  w_row0 + t * w_step);
  };

  if (threadIdx.x == 0) {
    for (int kc = 0; kc < kPrefetch; ++kc) load(kc);
  }
  for (int kc = 0; kc < KCH; ++kc) {
    if (threadIdx.x == 0 && kc + kPrefetch < KCH) load(kc + kPrefetch);
    const uint32_t j = it0 + kc, s = j % kStages;
    mbar_wait(ring.full(s), (j / kStages) & 1);
    __syncwarp();
    const uint32_t sa = ring.base + s * kStageBytes;
    const uint64_t db = desc_k_major(sa + kStageA);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kChunk / 16; ++ks) {
#pragma unroll
      for (int i = 0; i < MPW; ++i)
        wgmma_m64n192k16_ss(acc[i], desc_add(desc_k_major(sa + (wg + 2 * i) * 8192), ks * 32),
                            desc_add(db, ks * 32));
    }
    wgmma_commit();
    wgmma_wait<kStages - kPrefetch - 1>();
    if (kc > 0) mbar_arrive(ring.empty((j - 1) % kStages));
  }
  wgmma_wait<0>();
  mbar_arrive(ring.empty((it0 + KCH - 1) % kStages));
  ring.it = it0 + KCH;
#pragma unroll
  for (int i = 0; i < MPW; ++i)
#pragma unroll
    for (int e = 0; e < kQkv / 2; ++e) fence_operand(acc[i][e]);
}

// The rows of this thread's accumulators: row(i, hi) of m-tile i, and the
// first of each column pair, col(j) = 8 j + 2 c; the pair is
// acc[i][4 j + 2 hi] and acc[i][4 j + 2 hi + 1].
__device__ __forceinline__ int acc_row(int i, int hi) {
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  return (wg + 2 * i) * 64 + 16 * warp + (lane >> 2) + 8 * hi;
}

__device__ __forceinline__ int acc_col(int j) { return 8 * j + 2 * (threadIdx.x & 3); }

// One head's q/k/v GEMM (h the workspace rows from h_row0) and its
// epilogue: the fp32 bias added (v1: the product and the bias each rounded
// first), the result rounded to bf16 and written as the group's swizzled
// tiles in the ring: q of sample s at tile s, k at ns + s, v at 2 ns + s,
// each [LP, 64], rows L .. LP - 1 zero. v2a instead writes ctx = v + 1e-4 q
// + 1e-4 k, each operation rounded, to the head's columns of ctx. Ends
// with a barrier after which the tiles are visible to wgmma.
template <int MPW, int LP, int V>
__device__ void qkv_head(const HalfMaps& maps, int h_row0, int ns, int L, int hh,
                         const float* __restrict__ b_in, bf16* ctx, Ring& ring) {
  const int rows = ns * L;
  float acc[MPW][kQkv / 2];
  // rows hh 64 .. of the q, k and v blocks of w_in, 768 rows apart
  wgmma_gemm<MPW>(acc, &maps.ws, h_row0, &maps.w_in, hh * kD, kE, ring);
  __syncthreads();  // every warpgroup's products are done: the ring is free
  unsigned char* tiles = ring.ptr;

#pragma unroll
  for (int i = 0; i < MPW; ++i) {
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int r = acc_row(i, hi);
      if (r >= rows) continue;
      const float* a = acc[i] + 2 * hi;
      if constexpr (V == kNoHeads) {
        const float cf = round_to<bf16>(1e-4f);  // the coefficient in bf16, as JAX's weak scalar
        bf16* o = ctx + (size_t)r * kE + hh * kD;
#pragma unroll
        for (int j = 0; j < kD / 8; ++j) {
          const int d = acc_col(j);
          float y[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float q = round_to<bf16>(__fadd_rn(a[4 * j + e], b_in[hh * kD + d + e]));
            const float k = round_to<bf16>(__fadd_rn(a[4 * (j + 8) + e], b_in[kE + hh * kD + d + e]));
            const float v =
                round_to<bf16>(__fadd_rn(a[4 * (j + 16) + e], b_in[2 * kE + hh * kD + d + e]));
            const float t = round_to<bf16>(__fadd_rn(v, round_to<bf16>(__fmul_rn(cf, q))));
            y[e] = __fadd_rn(t, round_to<bf16>(__fmul_rn(cf, k)));
          }
          *reinterpret_cast<uint32_t*>(o + d) = pack_bf16(y[0], y[1]);
        }
      } else {
        const int s = r / L, jr = r - s * L;
#pragma unroll
        for (int j = 0; j < kQkv / 8; ++j) {
          const int col = acc_col(j), which = col / kD, d = col % kD;
          const float* bias = b_in + which * kE + hh * kD + d;
          float y[2];
#pragma unroll
          for (int e = 0; e < 2; ++e)
            y[e] = V == kQkvRounded ? __fadd_rn(round_to<bf16>(a[4 * j + e]), round_to<bf16>(bias[e]))
                                    : __fadd_rn(a[4 * j + e], bias[e]);
          *reinterpret_cast<uint32_t*>(tiles + (which * ns + s) * LP * 128 + sw128(jr, d >> 3) +
                                       (d & 7) * 2) = pack_bf16(y[0], y[1]);
        }
      }
    }
  }
  if constexpr (V != kNoHeads) {
    // padded rows are zero: keys past L get weight 0 against finite V
    const int pad = LP - L;
    for (int idx = threadIdx.x; idx < 3 * ns * pad * 8; idx += kThreads) {
      const int ch = idx & 7, t = (idx >> 3) / pad, jr = L + (idx >> 3) % pad;
      *reinterpret_cast<uint4*>(tiles + t * LP * 128 + sw128(jr, ch)) = make_uint4(0, 0, 0, 0);
    }
  }
  fence_proxy_async();
  __syncthreads();
}

// ob = xb + (A W^T + b_out) for the group's rows, rows of 768: A the rows
// from a_row0 of *amap, 64 KCH wide (K5's and E2's ctx, the workspace rows
// of maps.ws; K6's hidden rows), W [768, 64 KCH] through *wmap; four GEMMs
// of 192 output columns, the fp32 bias added before the rounding to bf16
// and the residual added in bf16 in their epilogue.
template <int MPW, int KCH = kChunks>
__device__ void out_projection_wgmma(const CUtensorMap* amap, int a_row0, const CUtensorMap* wmap,
                                     int rows, const float* __restrict__ b_out,
                                     const bf16* __restrict__ xb, bf16* __restrict__ ob,
                                     Ring& ring) {
  for (int n0 = 0; n0 < kE; n0 += kQkv) {
    float acc[MPW][kQkv / 2];
    wgmma_gemm<MPW, KCH>(acc, amap, a_row0, wmap, n0, kD, ring);
#pragma unroll
    for (int i = 0; i < MPW; ++i) {
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int r = acc_row(i, hi);
        if (r >= rows) continue;
#pragma unroll
        for (int j = 0; j < kQkv / 8; ++j) {
          const int col = n0 + acc_col(j);
          const size_t o = (size_t)r * kE + col;
          const __nv_bfloat162 xv = *reinterpret_cast<const __nv_bfloat162*>(xb + o);
          const float y0 = round_to<bf16>(__fadd_rn(acc[i][4 * j + 2 * hi], b_out[col]));
          const float y1 = round_to<bf16>(__fadd_rn(acc[i][4 * j + 2 * hi + 1], b_out[col + 1]));
          *reinterpret_cast<uint32_t*>(ob + o) =
              pack_bf16(__fadd_rn(__low2float(xv), y0), __fadd_rn(__high2float(xv), y1));
        }
      }
    }
  }
}

// K5's bf16 body over one group of ns samples (rows contiguous in xb and
// ob), at attention tile LP and numeric variant V. h and ctx [ns L, 768]
// are the block's workspace slice, rows h_row0 and h_row0 + S L of
// maps.ws (S the group size, ns <= S); ring the block's (make_ring).
template <int LP, int V>
__device__ void attention_halfblock_group(const HalfMaps& maps, const bf16* __restrict__ xb,
                                          const bf16* __restrict__ ln_w,
                                          const bf16* __restrict__ ln_b,
                                          const float* __restrict__ b_in,
                                          const float* __restrict__ b_out,
                                          const float* __restrict__ mask, bf16* __restrict__ ob,
                                          bf16* h, bf16* ctx, int h_row0, int ctx_row0, int ns,
                                          int L, float eps, Ring& ring) {
  const int rows = ns * L, wg = threadIdx.x >> 7;

  layer_norm_rows<bf16>(xb, ln_w, ln_b, h, rows, eps);
  fence_proxy_async_global();  // h is read by TMA
  __syncthreads();
  for (int hh = 0; hh < kHeads; ++hh) {
    if (rows > 128)
      qkv_head<2, LP, V>(maps, h_row0, ns, L, hh, b_in, ctx, ring);
    else
      qkv_head<1, LP, V>(maps, h_row0, ns, L, hh, b_in, ctx, ring);
    if constexpr (V != kNoHeads) {
      // the warpgroups take the (sample, query tile) units in turn
      const int nqt = (L + 63) / 64;
      for (int u = wg; u < ns * nqt; u += 2) {
        const int s = u / nqt, qt = u - s * nqt;
        attn_query_tile<LP, V == kReciprocal>(
            ring.ptr + s * LP * 128, ring.base + (ns + s) * LP * 128,
            ring.base + (2 * ns + s) * LP * 128, mask, L, kScale, qt,
            ctx + (size_t)s * L * kE + hh * kD, kE);
      }
    }
    // ctx's columns are written (and read by TMA later); the ring is free
    // for TMA again
    fence_proxy_async_global();
    fence_proxy_async();
    __syncthreads();
  }
  if (rows > 128)
    out_projection_wgmma<2>(&maps.ws, ctx_row0, &maps.w_out, rows, b_out, xb, ob, ring);
  else
    out_projection_wgmma<1>(&maps.ws, ctx_row0, &maps.w_out, rows, b_out, xb, ob, ring);
  // the next group's LayerNorm ends in a barrier before the next GEMM
  // refills the ring
}

// ---------------------------------------------------------------------------
// E2's bf16 body: the attention core and the out-projection on a qkv
// computed outside the kernel
// ---------------------------------------------------------------------------
//
// For each head, the group's q, k and v columns of qkv [ns L, 2304] (the
// head's 64 columns of each third) are copied by cp.async straight into the
// ring's shared memory as K5's tiles: q of sample s at tile s, k at ns + s,
// v at 2 ns + s, each [LP, 64] in the 128-byte swizzle, rows L .. LP - 1
// zero-filled by the copy. Where two heads' tiles fit in the ring, the
// copies of head hh + 1 run while head hh's attention does. The two
// warpgroups take the group's (sample, query tile) units in turn through
// K1's attention (attn_query_tile), into the head's columns of ctx. Last,
// out_projection_wgmma, K5's. One block barrier a head; none inside the
// GEMMs.

// bytes of one head's q, k and v tiles for ns samples at tile length LP
__host__ __device__ constexpr uint32_t head_tile_bytes(int ns, int LP) {
  return 3u * ns * LP * 128;
}

// E2's bf16 body over one group of ns samples (rows contiguous in xb, ob
// and in qkvb, whose rows are 2304 wide), at attention tile LP. ctx [ns L,
// 768] is the block's workspace slice, rows ctx_row0 .. of maps.ws; ring
// the block's (make_ring).
template <int LP>
__device__ void core_out_group(const HalfMaps& maps, const bf16* __restrict__ xb,
                               const bf16* __restrict__ qkvb, const float* __restrict__ b_out,
                               bf16* __restrict__ ob, bf16* ctx, int ctx_row0, int ns, int L,
                               Ring& ring) {
  constexpr int ld = 3 * kE;
  const int rows = ns * L, wg = threadIdx.x >> 7, nqt = (L + 63) / 64;
  const uint32_t tile_bytes = head_tile_bytes(ns, LP);
  const bool two = 2 * tile_bytes <= kStages * kStageBytes;

  // head hh's tiles into buffer buf of the ring, one commit group
  auto stage = [&](int hh, int buf) {
    const uint32_t base = ring.base + buf * tile_bytes;
    for (int idx = threadIdx.x; idx < 3 * ns * LP * 8; idx += kThreads) {
      const int ch = idx & 7, r = (idx >> 3) % LP, t = (idx >> 3) / LP;
      const int which = t / ns, s = t - which * ns;
      const bool ok = r < L;
      cp_async16(base + t * LP * 128 + sw128(r, ch),
                 qkvb + (size_t)(s * L + (ok ? r : 0)) * ld + which * kE + hh * kD + ch * 8, ok);
    }
    cp_async_commit();
  };

  __syncthreads();  // the previous group's GEMMs are done with the ring
  stage(0, 0);
  for (int hh = 0; hh < kHeads; ++hh) {
    const int buf = two ? hh & 1 : 0;
    if (two && hh + 1 < kHeads) {
      stage(hh + 1, buf ^ 1);  // its buffer's last reader, head hh - 1, is done
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_proxy_async();
    __syncthreads();  // head hh's tiles are visible to every thread and to wgmma
    const uint32_t tiles = ring.base + buf * tile_bytes;
    for (int u = wg; u < ns * nqt; u += 2) {
      const int s = u / nqt, qt = u - s * nqt;
      attn_query_tile<LP, false>(ring.ptr + buf * tile_bytes + s * LP * 128,
                                 tiles + (ns + s) * LP * 128, tiles + (2 * ns + s) * LP * 128,
                                 nullptr, L, kScale, qt, ctx + (size_t)s * L * kE + hh * kD, kE);
    }
    __syncthreads();  // every unit of head hh is done with its buffer
    if (!two && hh + 1 < kHeads) stage(hh + 1, 0);
  }
  // ctx is read by TMA; the ring's generic writes come before TMA refills it
  fence_proxy_async_global();
  fence_proxy_async();
  __syncthreads();
  if (rows > 128)
    out_projection_wgmma<2>(&maps.ws, ctx_row0, &maps.w_out, rows, b_out, xb, ob, ring);
  else
    out_projection_wgmma<1>(&maps.ws, ctx_row0, &maps.w_out, rows, b_out, xb, ob, ring);
}

}  // namespace
