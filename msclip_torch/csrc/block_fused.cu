// Fused pre-LN half-blocks of the transformer trunk, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of msclip_tpu/ops/block_fused.py:
//
// * K5, fused_attention_halfblock (body _attn_half_kernel):
//       out = x + out_proj(MHA(LN1(x)))
//   LayerNorm, the q/k/v projections with bias, per-head attention with an
//   optional additive fp32 [L, L] mask, the out-projection with bias and
//   the residual, in one launch;
// * K6, fused_mlp_halfblock (body _mlp_half_kernel):
//       out = x + c_proj(QuickGELU(c_fc(LN2(x))))
//   in one launch.
//
// Every product, the six projection GEMMs included, is computed inside the
// kernels. Widths are the ViT-B trunk's: E = 768, 12 heads of 64, F = 3072.
//
// Rounding follows the TPU kernels step by step (ops/block_fused.py has the
// plain torch versions that the card checks hold the kernels against):
// LayerNorm statistics in fp32, the normalized value rounded to the input
// type before the affine in that type; each projection is an fp32 sum of
// input-type products, its fp32 bias added before the result is rounded to
// the input type; scores are fp32, scaled after the product, the mask added
// after the scale, softmax in fp32, the weights rounded to the input type
// before the fp32 PV sum; QuickGELU (x * sigmoid(1.702 x)) in fp32 before
// the rounding; the residual added in the input type.
//
// Bound on an H100 SXM: operations. K5 at ViT-B/32 (B=256, L=50), bf16, is
// 62.4 GFLOP (60.4 in the four projections), 63 us at 989 TFLOP/s, against
// 44 MB of I/O (13 us at 3.35 TB/s); K6 there is 121 GFLOP, 122 us. What
// the design does about it: bf16 products run on the tensor cores
// (mma.sync m16n8k16, fp32 accumulators); every weight tile and activation
// tile is staged into shared memory by cp.async through a three-stage
// ring; a block takes as many short samples at once as fill a GEMM pass of
// 128 rows, so that each weight tile it stages serves up to 128 tokens; x
// is read from device memory once and the output written once. fp32
// products run on the CUDA cores in full fp32 (fused multiply-adds, no
// TF32) with the same tiling and accumulator layout. PERF.md has the times
// against the bound.
//
// Design, and what lives where:
//
// * K5: a block owns a group of S = max(1, 128 / L) samples at a time (2
//   at L=50, 1 at L=77 and L=197; a persistent grid of resident blocks
//   walks the batch), whose S L rows are contiguous in x. It writes their
//   LN1(x) into its own slice of a device-memory workspace (one sample's h
//   is 77 KB at L=50, 303 KB at L=197: too large for shared memory beside
//   the GEMM tiles). Then for each head it runs one GEMM of [S L, 768] x
//   [768, 192] (the head's q, k and v rows of the in-projection) whose
//   epilogue adds the fp32 bias, rounds and writes the head's q/k/v
//   [S L, 192] to the workspace; sample by sample, stages them into shared
//   memory as K1 (csrc/attention_fwd.cu) does and runs K1's attention
//   (bf16: the 16 x LP score tile in mma.sync registers, the weights fed
//   back as the A operand of PV; fp32: a warp per query row), writing the
//   head's context columns into a second workspace slice. Last, the
//   out-projection GEMM [S L, 768] x [768, 768] over four column tiles of
//   192, with the bias and the residual in its epilogue. GEMM rows go in
//   passes of at most 128 (two at L > 128). The block's slices (h, ctx,
//   q/k/v: 3.4 KB a token in bf16) stay in the 50 MB L2 at the image and
//   text shapes.
// * K6: a block owns 32 token rows at a time. LN2 of its rows goes to its
//   workspace slice; then for each of 24 chunks of 128 hidden columns, a
//   GEMM [32, 768] x [768, 128] whose epilogue adds the bias and takes the
//   fp32 QuickGELU, rounded into a [32, 128] workspace tile, and a GEMM
//   [32, 128] x [128, 768] accumulated across the chunks into [32, 768]
//   fp32 registers; the epilogue adds the bias and the residual.
//
// Later work: wgmma with TMA-fed rings, h kept in distributed shared memory
// of a cluster instead of the workspace, and more rows per block for K6.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <cstdint>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kE = 768;            // width
constexpr int kHeads = 12;
constexpr int kD = 64;             // head width
constexpr int kF = 4 * kE;         // MLP hidden width
constexpr int kQkv = 3 * kD;       // one head's q, k and v columns
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxSeq = 256;
constexpr int kGroupRows = 128;    // GEMM rows per pass of K5
constexpr int kMlpRows = 32;       // token rows per K6 tile
constexpr int kFChunk = 128;       // hidden columns per K6 chunk

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
// PTX: asynchronous copies and the bf16 tensor-core product
// ---------------------------------------------------------------------------

// 16 bytes global -> shared, or 16 zero bytes when !valid (src-size 0)
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most one committed group is still in flight
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
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
    cp_async_wait_one();
    __syncthreads();  // chunk kc visible to all; every warp is past kc - 1
    if (kc + 2 < n_chunks) load(kc + 2, (kc + 2) % Tl::STAGES);
    cp_async_commit();
    const T* sa = stage + (kc % Tl::STAGES) * Tl::STAGE;
    WarpMma<T, Tl::KC, LD, MPW, NPW, WM>::run(acc, sa + wm * 16 * LD,
                                              sa + (ROWS + wn * NPW * 8) * LD, lane);
  }
  cp_async_wait_all();
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
// One head's attention from the workspace q/k/v [L, 192] to ctx (row stride
// 768, offset to the head's columns). K1's arithmetic and layout.
// ---------------------------------------------------------------------------

template <typename T, int A>
struct AttnHead;

// bf16, tensor cores. NTK key tiles of 8: the padded length LP = 8 NTK is a
// multiple of 16 and covers L. Q_h and K_h as [LP, D + 8] rows, V_h
// transposed as [D, LP + 8]; warp w takes the 16-row query tiles w, w + 8, ...
template <int NTK>
struct AttnHead<bf16, NTK> {
  static constexpr int LP = 8 * NTK, DS = kD + 8, VS = LP + 8;
  static constexpr size_t smem_bytes = sizeof(bf16) * (2 * LP * DS + kD * VS);

  static __device__ void run(const bf16* __restrict__ qkv, const float* __restrict__ mask,
                             bf16* __restrict__ ctx, int L, float scale, unsigned char* smem) {
    bf16* q_s = reinterpret_cast<bf16*>(smem);
    bf16* k_s = q_s + LP * DS;
    bf16* vt_s = k_s + LP * DS;
    constexpr int kVecPerRow = kD / 8;
    for (int idx = threadIdx.x; idx < LP * kVecPerRow; idx += kThreads) {
      const int j = idx / kVecPerRow, c8 = 8 * (idx % kVecPerRow);
      uint4 q = make_uint4(0, 0, 0, 0), k = q, v = q;
      if (j < L) {  // rows past L are zeros: padded keys get weight 0
        const bf16* row = qkv + j * kQkv + c8;
        q = *reinterpret_cast<const uint4*>(row);
        k = *reinterpret_cast<const uint4*>(row + kD);
        v = *reinterpret_cast<const uint4*>(row + 2 * kD);
      }
      *reinterpret_cast<uint4*>(q_s + j * DS + c8) = q;
      *reinterpret_cast<uint4*>(k_s + j * DS + c8) = k;
      const bf16* ve = reinterpret_cast<const bf16*>(&v);
#pragma unroll
      for (int e = 0; e < 8; ++e) vt_s[(c8 + e) * VS + j] = ve[e];
    }
    __syncthreads();

    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int g = lane / 4, c = lane % 4;
    const int n_tiles = (L + 15) / 16;
    for (int rt = warp; rt < n_tiles; rt += kWarps) {
      const int r0 = rt * 16 + g, r1 = r0 + 8;  // this lane's two query rows
      const bf16* q0 = q_s + r0 * DS + 2 * c;
      const bf16* q1 = q_s + r1 * DS + 2 * c;

      float s[NTK][4];
#pragma unroll
      for (int nt = 0; nt < NTK; ++nt) {
        s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
        const bf16* kr = k_s + (nt * 8 + g) * DS + 2 * c;
#pragma unroll
        for (int ks = 0; ks < kD / 16; ++ks)
          mma_bf16(s[nt], ld32(q0 + 16 * ks), ld32(q1 + 16 * ks), ld32(q0 + 16 * ks + 8),
                   ld32(q1 + 16 * ks + 8), ld32(kr + 16 * ks), ld32(kr + 16 * ks + 8));
      }

      float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F;
#pragma unroll
      for (int nt = 0; nt < NTK; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = nt * 8 + 2 * c + e;
          float v0 = -CUDART_INF_F, v1 = -CUDART_INF_F;
          if (j < L) {
            v0 = s[nt][e] * scale;
            v1 = s[nt][2 + e] * scale;
            if (mask != nullptr) {
              if (r0 < L) v0 += mask[r0 * L + j];
              if (r1 < L) v1 += mask[r1 * L + j];
            }
          }
          s[nt][e] = v0;
          s[nt][2 + e] = v1;
          m0 = fmaxf(m0, v0);
          m1 = fmaxf(m1, v1);
        }
      }
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, o));
        m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, o));
      }
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int nt = 0; nt < NTK; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = nt * 8 + 2 * c + e;
          s[nt][e] = j < L ? expf(s[nt][e] - m0) : 0.f;
          s[nt][2 + e] = j < L ? expf(s[nt][2 + e] - m1) : 0.f;
          sum0 += s[nt][e];
          sum1 += s[nt][2 + e];
        }
      }
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        sum0 += __shfl_xor_sync(0xffffffffu, sum0, o);
        sum1 += __shfl_xor_sync(0xffffffffu, sum1, o);
      }
      uint32_t p[NTK][2];
#pragma unroll
      for (int nt = 0; nt < NTK; ++nt) {
        p[nt][0] = pack_bf16(s[nt][0] / sum0, s[nt][1] / sum0);
        p[nt][1] = pack_bf16(s[nt][2] / sum1, s[nt][3] / sum1);
      }

      float o_acc[kD / 8][4];
#pragma unroll
      for (int dt = 0; dt < kD / 8; ++dt) o_acc[dt][0] = o_acc[dt][1] = o_acc[dt][2] = o_acc[dt][3] = 0.f;
#pragma unroll
      for (int kt = 0; kt < NTK / 2; ++kt) {
#pragma unroll
        for (int dt = 0; dt < kD / 8; ++dt) {
          const bf16* vr = vt_s + (dt * 8 + g) * VS + kt * 16 + 2 * c;
          mma_bf16(o_acc[dt], p[2 * kt][0], p[2 * kt][1], p[2 * kt + 1][0], p[2 * kt + 1][1],
                   ld32(vr), ld32(vr + 8));
        }
      }

#pragma unroll
      for (int dt = 0; dt < kD / 8; ++dt) {
        if (r0 < L)
          *reinterpret_cast<uint32_t*>(ctx + (size_t)r0 * kE + dt * 8 + 2 * c) =
              pack_bf16(o_acc[dt][0], o_acc[dt][1]);
        if (r1 < L)
          *reinterpret_cast<uint32_t*>(ctx + (size_t)r1 * kE + dt * 8 + 2 * c) =
              pack_bf16(o_acc[dt][2], o_acc[dt][3]);
      }
    }
  }
};

// fp32, CUDA cores. KPL keys per lane (L <= 32 KPL). K_h ([L, D + 1]: 32
// lanes reading 32 keys hit 32 banks) and V_h ([L, D]) in shared memory;
// each warp walks query rows, lane l owning keys l, l + 32, ..., so that
// the scores stay in registers; for PV lane l owns output columns l, l + 32
// and the weights are broadcast with shuffles.
template <int KPL>
struct AttnHead<float, KPL> {
  static constexpr int DP = kD + 1, CPL = kD / 32;
  static constexpr size_t smem_bytes =
      sizeof(float) * ((size_t)32 * KPL * DP + (size_t)32 * KPL * kD + kWarps * kD);

  static __device__ void run(const float* __restrict__ qkv, const float* __restrict__ mask,
                             float* __restrict__ ctx, int L, float scale, unsigned char* smem) {
    float* k_s = reinterpret_cast<float*>(smem);
    float* v_s = k_s + L * DP;
    float* q_s = v_s + L * kD;
    for (int idx = threadIdx.x; idx < L * kD; idx += kThreads) {
      const int j = idx / kD, d = idx % kD;
      const float* row = qkv + j * kQkv;
      k_s[j * DP + d] = row[kD + d];
      v_s[j * kD + d] = row[2 * kD + d];
    }
    __syncthreads();

    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    float* q_w = q_s + warp * kD;
    for (int i = warp; i < L; i += kWarps) {
      const float* q_row = qkv + i * kQkv;
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
          float v = acc * scale;
          if (mask != nullptr) v += mask[i * L + j];
          s[t] = v;
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
#pragma unroll
      for (int t = 0; t < KPL; ++t) s[t] /= sum;

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
// K5
// ---------------------------------------------------------------------------

// Samples a block takes at once: as many as fill one GEMM pass of 128
// rows (2 at L=50), at least one. Their rows are contiguous in x and out.
__host__ __device__ constexpr int samples_per_group(int L) {
  return L < kGroupRows ? kGroupRows / L : 1;
}

// workspace elements of one block: h, ctx [S L, 768] and q/k/v [S L, 192]
// for its S samples
__host__ __device__ constexpr long long attn_slot_elems(int L) {
  return (long long)samples_per_group(L) * L * (2 * kE + kQkv);
}

template <typename T, int A>
__global__ void __launch_bounds__(kThreads)
attention_halfblock_kernel(const T* __restrict__ x, const T* __restrict__ ln_w,
                           const T* __restrict__ ln_b, const T* __restrict__ w_in,
                           const float* __restrict__ b_in, const T* __restrict__ w_out,
                           const float* __restrict__ b_out, const float* __restrict__ mask,
                           T* __restrict__ out, T* __restrict__ ws, int B, int L, float eps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int S = samples_per_group(L);
  T* h = ws + blockIdx.x * attn_slot_elems(L);
  T* ctx = h + (size_t)S * L * kE;
  T* qkv = ctx + (size_t)S * L * kE;
  const float scale = 0.125f;  // kD^-1/2

  for (int b0 = blockIdx.x * S; b0 < B; b0 += gridDim.x * S) {
    const int rows = min(S, B - b0) * L;  // the group's tokens, contiguous
    const T* xb = x + (size_t)b0 * L * kE;
    layer_norm_rows<T>(xb, ln_w, ln_b, h, rows, eps);
    __syncthreads();

    for (int hh = 0; hh < kHeads; ++hh) {
      // row n of the head's [192, 768] weight: q, k or v row n % 64
      auto w_row = [&](int n) {
        return w_in + ((size_t)(n / kD) * kE + hh * kD + n % kD) * kE;
      };
      gemm_192<T>(h, rows, w_row, smem_raw, [&](int r, int col, float v) {
        const float bias = b_in[(col / kD) * kE + hh * kD + col % kD];
        qkv[r * kQkv + col] = from_f<T>(__fadd_rn(v, bias));
      });
      __syncthreads();
      for (int r0 = 0; r0 < rows; r0 += L) {  // attention sample by sample
        AttnHead<T, A>::run(qkv + (size_t)r0 * kQkv, mask,
                            ctx + (size_t)r0 * kE + hh * kD, L, scale, smem_raw);
        __syncthreads();
      }
    }

    T* ob = out + (size_t)b0 * L * kE;
    for (int n0 = 0; n0 < kE; n0 += kQkv) {
      auto w_row = [&](int n) { return w_out + (size_t)(n0 + n) * kE; };
      gemm_192<T>(ctx, rows, w_row, smem_raw, [&](int r, int col, float v) {
        const size_t o = (size_t)r * kE + n0 + col;
        const float y = round_to<T>(__fadd_rn(v, b_out[n0 + col]));
        ob[o] = from_f<T>(__fadd_rn(to_f<T>(xb[o]), y));
      });
    }
    // the next sample's LayerNorm overwrites h, which the last GEMM's
    // trailing barrier has released
  }
}

// ---------------------------------------------------------------------------
// K6
// ---------------------------------------------------------------------------

// workspace elements of one block: h [32, 768] and the GELU tile [32, 128]
__host__ __device__ constexpr long long mlp_slot_elems() { return (long long)kMlpRows * (kE + kFChunk); }

using FcTile = Tile<float, 128, 2, 2, 1>;    // [32, 768] x [768, 128]
using ProjTile = Tile<float, 64, 2, 12, 1>;  // [32, 128] x [128, 768]
static_assert(FcTile::ROWS == kMlpRows && FcTile::N == kFChunk, "c_fc tile");
static_assert(ProjTile::ROWS == kMlpRows && ProjTile::N == kE, "c_proj tile");
constexpr size_t kMlpSmem =
    ProjTile::smem_bytes > FcTile::smem_bytes ? ProjTile::smem_bytes : FcTile::smem_bytes;

template <typename T>
__global__ void __launch_bounds__(kThreads)
mlp_halfblock_kernel(const T* __restrict__ x, const T* __restrict__ ln_w,
                     const T* __restrict__ ln_b, const T* __restrict__ w_fc,
                     const float* __restrict__ b_fc, const T* __restrict__ w_proj,
                     const float* __restrict__ b_proj, T* __restrict__ out, T* __restrict__ ws,
                     int rows, float eps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* h = ws + blockIdx.x * mlp_slot_elems();
  T* mid = h + (size_t)kMlpRows * kE;

  for (int t = blockIdx.x; t * kMlpRows < rows; t += gridDim.x) {
    const int r0 = t * kMlpRows, n = min(kMlpRows, rows - r0);
    const T* xt = x + (size_t)r0 * kE;
    layer_norm_rows<T>(xt, ln_w, ln_b, h, n, eps);
    __syncthreads();

    float acc[2][12][4];
    zero(acc);
    for (int f0 = 0; f0 < kF; f0 += kFChunk) {
      float fc[2][2][4];
      zero(fc);
      block_gemm<T, 128, 2, 2, 1>(fc, h, kE, n, [&](int j) { return w_fc + (size_t)(f0 + j) * kE; },
                                  kE, smem_raw);
      for_each_acc<2, 2, 1>(fc, [&](int r, int col, float v) {
        const float m = __fadd_rn(v, b_fc[f0 + col]);
        const float sig = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(__fmul_rn(-1.702f, m))));
        mid[r * kFChunk + col] = from_f<T>(__fmul_rn(m, sig));
      });
      __syncthreads();  // the GELU tile is complete before it is staged
      block_gemm<T, 64, 2, 12, 1>(acc, mid, kFChunk, n,
                                  [&](int j) { return w_proj + (size_t)j * kF + f0; }, kFChunk,
                                  smem_raw);
    }
    T* ot = out + (size_t)r0 * kE;
    for_each_acc<2, 12, 1>(acc, [&](int r, int col, float v) {
      if (r < n) {
        const size_t o = (size_t)r * kE + col;
        const float y = round_to<T>(__fadd_rn(v, b_proj[col]));
        ot[o] = from_f<T>(__fadd_rn(to_f<T>(xt[o]), y));
      }
    });
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

// Blocks in the persistent grid: as many as are resident at once, at most
// one per unit of work and one per workspace slice.
template <typename K>
cudaError_t grid_size(K kernel, size_t smem, int work, int slots, int* grid) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  int g = per_sm * sms;
  if (g > work) g = work;
  if (g > slots) g = slots;
  *grid = g;
  return cudaSuccess;
}

template <typename T, int A>
cudaError_t launch_attn(const void* x, const void* ln_w, const void* ln_b, const void* w_in,
                        const float* b_in, const void* w_out, const float* b_out,
                        const float* mask, void* out, void* ws, int slots, int B, int L,
                        float eps, cudaStream_t stream) {
  auto kernel = attention_halfblock_kernel<T, A>;
  const size_t attn = AttnHead<T, A>::smem_bytes;
  const size_t smem = attn > kGemmSmem ? attn : kGemmSmem;
  const int S = samples_per_group(L);
  int grid = 0;
  cudaError_t err = grid_size(kernel, smem, (B + S - 1) / S, slots, &grid);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(ln_w), static_cast<const T*>(ln_b),
      static_cast<const T*>(w_in), b_in, static_cast<const T*>(w_out), b_out, mask,
      static_cast<T*>(out), static_cast<T*>(ws), B, L, eps);
  return cudaGetLastError();
}

// the padded lengths of the shapes the towers use, as K1: bf16 50 -> 64,
// 77 -> 80, 197 -> 208; fp32 keys per lane
cudaError_t dispatch_attn(bool bf, const void* x, const void* ln_w, const void* ln_b,
                          const void* w_in, const float* b_in, const void* w_out,
                          const float* b_out, const float* mask, void* out, void* ws, int slots,
                          int B, int L, float eps, cudaStream_t s) {
#define MSCLIP_ATTN(T, A) \
  launch_attn<T, A>(x, ln_w, ln_b, w_in, b_in, w_out, b_out, mask, out, ws, slots, B, L, eps, s)
  if (bf) {
    if (L <= 64) return MSCLIP_ATTN(bf16, 8);
    if (L <= 80) return MSCLIP_ATTN(bf16, 10);
    if (L <= 128) return MSCLIP_ATTN(bf16, 16);
    if (L <= 208) return MSCLIP_ATTN(bf16, 26);
    return MSCLIP_ATTN(bf16, 32);
  }
  if (L <= 64) return MSCLIP_ATTN(float, 2);
  if (L <= 128) return MSCLIP_ATTN(float, 4);
  return MSCLIP_ATTN(float, 8);
#undef MSCLIP_ATTN
}

template <typename T>
cudaError_t launch_mlp(const void* x, const void* ln_w, const void* ln_b, const void* w_fc,
                       const float* b_fc, const void* w_proj, const float* b_proj, void* out,
                       void* ws, int slots, int rows, float eps, cudaStream_t stream) {
  auto kernel = mlp_halfblock_kernel<T>;
  int grid = 0;
  cudaError_t err =
      grid_size(kernel, kMlpSmem, (rows + kMlpRows - 1) / kMlpRows, slots, &grid);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, kMlpSmem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(ln_w), static_cast<const T*>(ln_b),
      static_cast<const T*>(w_fc), b_fc, static_cast<const T*>(w_proj), b_proj,
      static_cast<T*>(out), static_cast<T*>(ws), rows, eps);
  return cudaGetLastError();
}

}  // namespace

// Workspace elements (of the input type) of one block: K5 (mlp = 0) at
// sequence length L, or K6 (mlp = 1).
extern "C" long long msclip_halfblock_slot_elems(int mlp, int L) {
  return mlp ? mlp_slot_elems() : attn_slot_elems(L);
}

// K5. x, out: [B, L, 768]; ln_w, ln_b: [768]; w_in: [2304, 768] (q, k, v
// rows); w_out: [768, 768]; all of one dtype (0 = float32, 1 = bfloat16),
// contiguous and 16-byte aligned. b_in [2304] and b_out [768]: fp32. mask:
// fp32 [L, L] or null. ws: slots x msclip_halfblock_slot_elems(0, L)
// elements of the dtype. Returns the launch's cudaError_t (0 on success);
// the caller has checked the shapes.
extern "C" int msclip_attention_halfblock(const void* x, const void* ln_w, const void* ln_b,
                                          const void* w_in, const float* b_in,
                                          const void* w_out, const float* b_out,
                                          const float* mask, void* out, void* ws, int slots,
                                          int B, int L, float eps, int dtype, void* stream) {
  if (B <= 0 || L <= 0 || L > kMaxSeq || slots <= 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  return (int)dispatch_attn(dtype == 1, x, ln_w, ln_b, w_in, b_in, w_out, b_out, mask, out, ws,
                            slots, B, L, eps, static_cast<cudaStream_t>(stream));
}

// K6. x, out: [rows, 768]; ln_w, ln_b: [768]; w_fc: [3072, 768]; w_proj:
// [768, 3072]; one dtype as above. b_fc [3072] and b_proj [768]: fp32. ws:
// slots x msclip_halfblock_slot_elems(1, 0) elements of the dtype.
extern "C" int msclip_mlp_halfblock(const void* x, const void* ln_w, const void* ln_b,
                                    const void* w_fc, const float* b_fc, const void* w_proj,
                                    const float* b_proj, void* out, void* ws, int slots,
                                    int rows, float eps, int dtype, void* stream) {
  if (rows <= 0 || slots <= 0 || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(dtype == 1 ? launch_mlp<bf16>(x, ln_w, ln_b, w_fc, b_fc, w_proj, b_proj, out, ws,
                                             slots, rows, eps, s)
                          : launch_mlp<float>(x, ln_w, ln_b, w_fc, b_fc, w_proj, b_proj, out, ws,
                                              slots, rows, eps, s));
}

extern "C" const char* msclip_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
