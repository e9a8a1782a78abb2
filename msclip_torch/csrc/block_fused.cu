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
// kernels. The width E is a template parameter, instantiated at the two
// widths of the repo's transformer towers: E = 768 (ViT-B's trunk and the
// MS-CLIP text tower; 12 heads of 64, F = 3072) and E = 512 (the text tower
// of b32.yaml and RN50; 8 heads of 64, F = 2048). Every other width is
// refused at launch.
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
// 44 MB of I/O (13 us at 3.35 TB/s); at the text chunk (1024 x 77, causal)
// 381 GFLOP (372 in the projections), 386 us; K6 at ViT-B/32 is 121 GFLOP,
// 122 us, and at the text chunk 744 GFLOP, 752 us. x is read from device
// memory once and the output written once; the weights are read once from
// device memory and again from the L2 by every group of samples, so the
// bytes that bound a block are the weight and activation tiles it stages
// from the L2.
//
// Design, and what lives where (the numbers at E = 768; at E = 512 the
// same design with E / 64 = 8 heads and E / 64 K chunks, the q/k/v GEMM of
// a head still 192 columns, but every GEMM over E or F = 4E output columns
// in column tiles of 128, because 192 divides neither 512 nor 2048
// (out_cols in halfblock.cuh): bf16 on wgmma.m64n128k16, fp32 in passes of
// 128 columns; fp32 K6's c_proj tile is [32, 128] x [128, 512]):
//
// * K5, bf16 (halfblock.cuh attention_halfblock_group): a persistent grid,
//   one block of two warpgroups an SM (225 KB of shared memory), walks the
//   batch in groups of S whole samples: as many as fit 256 GEMM rows and
//   512 padded attention rows (5 at L=50, 3 at L=77, 1 at L > 128), but no
//   more than spread the batch over every SM (the caller's S: 2 at
//   256 x 50, 3 at 1024 x 77). The group's LN1(x) goes to the block's
//   slice h of a device-memory workspace (77 KB a sample at L=50). Then for
//   each head one GEMM [S L, 768] x [768, 192] (the head's q, k and v rows
//   of the in-projection) on wgmma.m64n192k16, both operands from shared
//   memory in the 128-byte swizzle, fed by TMA through a four-stage ring
//   of 64-wide K chunks (up to 32 KB of rows and 24 KB of weights a
//   stage, two chunks ahead; one thread issues the loads, and full and
//   empty mbarriers a stage replace block barriers); each warpgroup holds
//   one or two 64-row m-tiles of fp32 accumulators (96 or 192 registers a
//   thread), so each weight tile staged serves up to 256 rows (231 at
//   L=77, where the mma.sync design served 77). The epilogue
//   adds the fp32 bias, rounds, and writes q, k and v as swizzled [LP, 64]
//   tiles per sample into the shared memory the ring held; the two
//   warpgroups then run the group's (sample, 64-row query tile) units at
//   once, each through K1's wgmma attention (attn_core.cuh), into the
//   slice ctx. Last, the out-projection [S L, 768] x [768, 768] as four
//   such GEMMs of 192 columns, the bias and the residual in the epilogue.
//   L2 -> SM bytes a launch (weight and activation tiles; chip_smoke.py
//   staged_l2_bytes): 16 GEMMs of (128 or 256 + 192) x 768 bf16 a group,
//   3.76 GB at 1024 x 77 (the mma.sync design: 6.77 GB, one sample a
//   group) and 1.01 GB at 256 x 50 (0.92 GB: two samples a group in
//   both, the TMA boxes reading 128 rows for 100).
// * K5, fp32: CUDA cores in full fp32 (fused multiply-adds, no TF32), the
//   mma.sync design's tiling (halfblock.cuh attention_halfblock_rows): a
//   group of S = max(1, 128 / L) samples, q/k/v [S L, 192] of each head
//   through the workspace, K1's fp32 attention one sample at a time on the
//   whole block (a warp per query row), GEMM passes of at most 128 rows
//   through a three-stage ring.
// * K6, bf16 (mlp_group_wgmma): K5's machinery over groups of token rows.
//   A persistent grid, one block of two warpgroups an SM, walks groups of
//   256 rows (two 64-row m-tiles a warpgroup) and then of 128 (one), so
//   that each weight tile staged serves up to 256 rows. LN2 of the group's
//   rows goes to the block's slice h of the workspace. Then 16 GEMMs
//   [rows, 768] x [768, 192] over w_fc (K-major like w_in) on
//   wgmma.m64n192k16 fed by TMA through the four-stage ring; their
//   epilogue adds the fp32 bias, takes QuickGELU in fp32 (the hardware 2^x
//   and reciprocal: a few ulps of fp32, far below the bf16 rounding that
//   follows), rounds, and writes the hidden rows [rows, 3072] to the
//   block's slice mid. Last, 4 GEMMs [rows, 3072] x [3072, 192] over w_proj
//   (48 K chunks each), the bias and the residual in their epilogue: K5's
//   out-projection (out_projection_wgmma). The wave: 256 x 50 is 12,800
//   rows, 100 groups of 128 for 132 SMs, and a group of 97 rows would cost
//   as much as one of 128 (the m-tile is 64 rows a warpgroup, and both
//   warpgroups wait on the same weight tiles); so the plan (Python,
//   ops/block_fused.mlp_plan, checked by the kernel) takes as many whole
//   rounds of 256-row groups as every SM can have, and the rest in
//   groups of 128: the busiest block takes ceil(rows / 128 / SMs) units
//   of 128 rows, the least any split into whole m-tile pairs allows, and
//   256-row groups halve the weight bytes each row stages from the L2.
//   The hidden rows' trip through the workspace (mid, 6 KB a row, written
//   once and read by TMA once: 157 MB at 256 x 50, most of it past the
//   50 MB L2) is the price of keeping 192 columns of fp32 accumulators a
//   tile in registers.
// * K6, fp32: CUDA cores in full fp32, a block owns 32 token rows at a
//   time. LN2 of its rows goes to its workspace slice; then for each of 24
//   chunks of 128 hidden columns, a GEMM [32, 768] x [768, 128] whose
//   epilogue adds the bias and takes the fp32 QuickGELU, rounded into a
//   [32, 128] workspace tile, and a GEMM [32, 128] x [128, 768]
//   accumulated across the chunks into [32, 768] fp32 registers; the
//   epilogue adds the bias and the residual; rings of three stages.
//
// The device code K5 shares with the tuning kernels E1 and E2
// (halfblock_tuning.cu) lives in halfblock.cuh: the GEMMs, LayerNorm, the
// per-head attention and K5's bodies over a group of samples.
//
// Later work: overlapping one head's attention with the next head's GEMM
// (and one GEMM's epilogue with the next GEMM's loads), weight tiles
// multicast to a cluster of blocks, h kept in distributed shared memory
// instead of the workspace.

#include "halfblock.cuh"

namespace {

constexpr int kMlpRows = 32;       // token rows per fp32 K6 tile
constexpr int kFChunk = 128;       // hidden columns per fp32 K6 chunk
// the bf16 K6 groups' rows; ops/block_fused.py (MLP_BIG_ROWS,
// MLP_SMALL_ROWS) plans the groups with them, held to these by a test
constexpr int kMlpBigRows = 256;   // two 64-row m-tiles a warpgroup
constexpr int kMlpSmallRows = 128; // one
static_assert(kMlpBigRows == kWgRows && kMlpSmallRows == kBoxRows, "the ring's row tiles");

// ---------------------------------------------------------------------------
// K5 (its body, attention_halfblock_rows, is in halfblock.cuh)
// ---------------------------------------------------------------------------

// workspace elements of one block at S samples of length L: h and ctx
// [S L, E], and for the fp32 body q/k/v [S L, 192]
template <typename T, int E>
__host__ __device__ constexpr long long attn_slot_elems(int S, int L) {
  return (long long)S * L * (2 * E + (std::is_same<T, bf16>::value ? 0 : kQkv));
}

template <typename T, int A, int E>
__global__ void __launch_bounds__(kThreads)
attention_halfblock_kernel(const __grid_constant__ HalfMaps maps, const T* __restrict__ x,
                           const T* __restrict__ ln_w, const T* __restrict__ ln_b,
                           const T* __restrict__ w_in, const float* __restrict__ b_in,
                           const T* __restrict__ w_out, const float* __restrict__ b_out,
                           const float* __restrict__ mask, T* __restrict__ out,
                           T* __restrict__ ws, long long slot, int B, int L, int S, float eps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* h = ws + blockIdx.x * slot;
  T* ctx = h + (size_t)S * L * E;

  if constexpr (std::is_same<T, bf16>::value) {
    Ring ring = make_ring(smem_raw);
    const int h_row0 = (int)(blockIdx.x * slot / E), ctx_row0 = h_row0 + S * L;
    for (int b0 = blockIdx.x * S; b0 < B; b0 += gridDim.x * S) {
      const size_t off = (size_t)b0 * L * E;  // the group's rows, contiguous
      attention_halfblock_group<8 * A, kBase, E>(maps, x + off, ln_w, ln_b, b_in, b_out, mask,
                                                 out + off, h, ctx, h_row0, ctx_row0,
                                                 min(S, B - b0), L, eps, ring);
    }
  } else {
    for (int b0 = blockIdx.x * S; b0 < B; b0 += gridDim.x * S) {
      const size_t off = (size_t)b0 * L * E;
      attention_halfblock_rows<T, A, kBase, E>(x + off, ln_w, ln_b, w_in, b_in, w_out, b_out,
                                               mask, out + off, h, ctx, ctx + (size_t)S * L * E,
                                               min(S, B - b0) * L, L, eps, smem_raw);
    }
  }
}

// ---------------------------------------------------------------------------
// K6
// ---------------------------------------------------------------------------

// fp32 workspace elements of one block: h [32, E] and the GELU tile [32, 128]
template <int E>
__host__ __device__ constexpr long long mlp_slot_elems() {
  return (long long)kMlpRows * (E + kFChunk);
}

using FcTile = Tile<float, 128, 2, 2, 1>;  // [32, E] x [E, 128]
template <int E>
using ProjTile = Tile<float, 64, 2, E / 64, 1>;  // [32, 128] x [128, E]
static_assert(FcTile::ROWS == kMlpRows && FcTile::N == kFChunk, "c_fc tile");
static_assert(ProjTile<768>::ROWS == kMlpRows && ProjTile<768>::N == 768 &&
                  ProjTile<512>::N == 512,
              "c_proj tile");
// fp32 K6's dynamic shared memory at width E
template <int E>
constexpr size_t mlp_smem() {
  return ProjTile<E>::smem_bytes > FcTile::smem_bytes ? ProjTile<E>::smem_bytes
                                                      : FcTile::smem_bytes;
}

// The bf16 groups of a launch over `rows` token rows: `big` groups of 256
// rows first, then groups of 128 (the last one ragged); group g starts at
// row *r0 and holds *n rows. Block i of the grid takes groups i, i + grid,
// ... (ops/block_fused.mlp_plan plans them; a CPU test walks them).
__device__ __forceinline__ int mlp_groups(int rows, int big) {
  return big + (rows - big * kMlpBigRows + kMlpSmallRows - 1) / kMlpSmallRows;
}

__device__ __forceinline__ void mlp_group(int g, int rows, int big, int* r0, int* n) {
  *r0 = g < big ? g * kMlpBigRows : big * kMlpBigRows + (g - big) * kMlpSmallRows;
  *n = g < big ? kMlpBigRows : min(kMlpSmallRows, rows - *r0);
}

// The tensor maps of the bf16 K6, kernel parameters (__grid_constant__):
// the workspace's h (rows of E) and mid (rows of F = 4E) in boxes of 128
// rows, w_fc [F, E] and w_proj [E, F] in boxes of 64 rows, each box 64
// columns wide in the 128-byte swizzle.
struct MlpMaps {
  CUtensorMap h, mid, w_fc, w_proj;
};

// QuickGELU of an fp32 c_fc output, m sigmoid(1.702 m) = m / (1 + e^(-1.702
// m)), in fp32 from the hardware 2^x and reciprocal (__expf, __fdividef:
// a few ulps of fp32 off, against a bf16 rounding after it); e^(-1.702 m)
// infinite or 1 + e >= 2^126 gives -0 for finite m < 0, NaN stays NaN
__device__ __forceinline__ float quick_gelu_fast(float m) {
  return __fdividef(m, __fadd_rn(1.0f, __expf(__fmul_rn(-1.702f, m))));
}

// K6's bf16 body over one group of n rows (contiguous in xb and ob), h
// already its LayerNorm: the workspace rows from slot_row0 of maps.h and
// maps.mid; mid the slot's first hidden row (row stride F = 4E).
template <int MPW, int E>
__device__ void mlp_group_wgmma(const MlpMaps& maps, int slot_row0, int n,
                                const float* __restrict__ b_fc, const float* __restrict__ b_proj,
                                const bf16* __restrict__ xb, bf16* __restrict__ ob, bf16* mid,
                                Ring& ring) {
  constexpr int F = 4 * E, NF = out_cols(F);
  // 16 slabs of NF hidden columns: 192 at E = 768, 128 at 512
  for (int f0 = 0; f0 < F; f0 += NF) {
    float acc[MPW][NF / 2];
    wgmma_gemm<MPW, E / kChunk, NF>(acc, &maps.h, slot_row0, &maps.w_fc, f0, kD, ring);
#pragma unroll
    for (int i = 0; i < MPW; ++i) {
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int r = acc_row(i, hi);
        if (r >= n) continue;
        bf16* o = mid + (size_t)r * F + f0;
#pragma unroll
        for (int j = 0; j < NF / 8; ++j) {
          const int col = acc_col(j);
          const float2 bias = *reinterpret_cast<const float2*>(b_fc + f0 + col);
          const float y0 = quick_gelu_fast(__fadd_rn(acc[i][4 * j + 2 * hi], bias.x));
          const float y1 = quick_gelu_fast(__fadd_rn(acc[i][4 * j + 2 * hi + 1], bias.y));
          *reinterpret_cast<uint32_t*>(o + col) = pack_bf16(y0, y1);
        }
      }
    }
  }
  fence_proxy_async_global();  // mid is read by TMA
  __syncthreads();
  out_projection_wgmma<MPW, F / kChunk, E>(&maps.mid, slot_row0, &maps.w_proj, n, b_proj, xb, ob,
                                          ring);
  // the next group's LayerNorm writes only h, which these GEMMs do not read
}

// bf16: the groups of mlp_group, h and mid [slots slot_rows, E | 4E] the
// workspace (block i's slot the rows from i slot_rows); fp32: tiles of 32
// rows, each block's slot mlp_slot_elems<E>() elements.
template <typename T, int E>
__global__ void __launch_bounds__(kThreads)
mlp_halfblock_kernel(const __grid_constant__ MlpMaps maps, const T* __restrict__ x,
                     const T* __restrict__ ln_w, const T* __restrict__ ln_b,
                     const T* __restrict__ w_fc, const float* __restrict__ b_fc,
                     const T* __restrict__ w_proj, const float* __restrict__ b_proj,
                     T* __restrict__ out, T* __restrict__ ws, int rows, int big, int slot_rows,
                     float eps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];

  if constexpr (std::is_same<T, bf16>::value) {
    Ring ring = make_ring(smem_raw);
    const int slot_row0 = blockIdx.x * slot_rows;
    bf16* h = ws + (size_t)slot_row0 * E;
    bf16* mid = ws + (size_t)gridDim.x * slot_rows * E + (size_t)slot_row0 * 4 * E;
    const int groups = mlp_groups(rows, big);
    for (int g = blockIdx.x; g < groups; g += gridDim.x) {
      int r0, n;
      mlp_group(g, rows, big, &r0, &n);
      const size_t off = (size_t)r0 * E;
      layer_norm_rows<bf16, E>(x + off, ln_w, ln_b, h, n, eps);
      fence_proxy_async_global();  // h is read by TMA
      __syncthreads();
      if (n > kMlpSmallRows)
        mlp_group_wgmma<2, E>(maps, slot_row0, n, b_fc, b_proj, x + off, out + off, mid, ring);
      else
        mlp_group_wgmma<1, E>(maps, slot_row0, n, b_fc, b_proj, x + off, out + off, mid, ring);
    }
  } else {
    constexpr int F = 4 * E;
    T* h = ws + blockIdx.x * mlp_slot_elems<E>();
    T* mid = h + (size_t)kMlpRows * E;

    for (int t = blockIdx.x; t * kMlpRows < rows; t += gridDim.x) {
      const int r0 = t * kMlpRows, n = min(kMlpRows, rows - r0);
      const T* xt = x + (size_t)r0 * E;
      layer_norm_rows<T, E>(xt, ln_w, ln_b, h, n, eps);
      __syncthreads();

      float acc[2][E / 64][4];
      zero(acc);
      for (int f0 = 0; f0 < F; f0 += kFChunk) {
        float fc[2][2][4];
        zero(fc);
        block_gemm<T, 128, 2, 2, 1>(fc, h, E, n, [&](int j) { return w_fc + (size_t)(f0 + j) * E; },
                                    E, smem_raw);
        for_each_acc<2, 2, 1>(fc, [&](int r, int col, float v) {
          const float m = __fadd_rn(v, b_fc[f0 + col]);
          const float sig = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(__fmul_rn(-1.702f, m))));
          mid[r * kFChunk + col] = from_f<T>(__fmul_rn(m, sig));
        });
        __syncthreads();  // the GELU tile is complete before it is staged
        block_gemm<T, 64, 2, E / 64, 1>(acc, mid, kFChunk, n,
                                        [&](int j) { return w_proj + (size_t)j * F + f0; },
                                        kFChunk, smem_raw);
      }
      T* ot = out + (size_t)r0 * E;
      for_each_acc<2, E / 64, 1>(acc, [&](int r, int col, float v) {
        if (r < n) {
          const size_t o = (size_t)r * E + col;
          const float y = round_to<T>(__fadd_rn(v, b_proj[col]));
          ot[o] = from_f<T>(__fadd_rn(to_f<T>(xt[o]), y));
        }
      });
    }
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

template <typename T, int A, int E>
cudaError_t launch_attn(const void* x, const void* ln_w, const void* ln_b, const void* w_in,
                        const float* b_in, const void* w_out, const float* b_out,
                        const float* mask, void* out, void* ws, long long slot, int slots, int B,
                        int L, int S, float eps, cudaStream_t stream) {
  auto kernel = attention_halfblock_kernel<T, A, E>;
  constexpr size_t smem = halfblock_smem<T, A>();
  // the bf16 body addresses the workspace as rows of E (its tensor map)
  if (slot < attn_slot_elems<T, E>(S, L) || (std::is_same<T, bf16>::value && slot % E != 0))
    return cudaErrorInvalidValue;
  HalfMaps maps{};
  cudaError_t err;
  if (std::is_same<T, bf16>::value &&
      (err = half_maps(&maps, ws, slots, slot, w_in, w_out, E)) != cudaSuccess)
    return err;
  int grid = 0;
  if ((err = grid_size(kernel, smem, (B + S - 1) / S, slots, &grid)) != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(
      maps, static_cast<const T*>(x), static_cast<const T*>(ln_w), static_cast<const T*>(ln_b),
      static_cast<const T*>(w_in), b_in, static_cast<const T*>(w_out), b_out, mask,
      static_cast<T*>(out), static_cast<T*>(ws), slot, B, L, S, eps);
  return cudaGetLastError();
}

// bf16: the instantiation at K1's padded_len(L) (attn_core.cuh); fp32:
// keys per lane
template <int E>
cudaError_t dispatch_attn(bool bf, const void* x, const void* ln_w, const void* ln_b,
                          const void* w_in, const float* b_in, const void* w_out,
                          const float* b_out, const float* mask, void* out, void* ws,
                          long long slot, int slots, int B, int L, int S, float eps,
                          cudaStream_t s) {
#define MSCLIP_ATTN(T, A)                                                                    \
  launch_attn<T, A, E>(x, ln_w, ln_b, w_in, b_in, w_out, b_out, mask, out, ws, slot, slots, B, \
                       L, S, eps, s)
  if (bf) {
    switch (padded_len(L)) {  // A = LP / 8
      case 64: return MSCLIP_ATTN(bf16, 8);
      case 80: return MSCLIP_ATTN(bf16, 10);
      case 128: return MSCLIP_ATTN(bf16, 16);
      case 208: return MSCLIP_ATTN(bf16, 26);
      default: return MSCLIP_ATTN(bf16, 32);
    }
  }
  if (L <= 64) return MSCLIP_ATTN(float, 2);
  if (L <= 128) return MSCLIP_ATTN(float, 4);
  return MSCLIP_ATTN(float, 8);
#undef MSCLIP_ATTN
}

// K6: bf16 on `slots` blocks, one a workspace slot, over the groups of
// mlp_group; fp32 on the persistent grid of 32-row tiles.
template <typename T, int E>
cudaError_t launch_mlp(const void* x, const void* ln_w, const void* ln_b, const void* w_fc,
                       const float* b_fc, const void* w_proj, const float* b_proj, void* out,
                       void* ws, int slots, int slot_rows, int big, int rows, float eps,
                       cudaStream_t stream) {
  constexpr int F = 4 * E;
  auto kernel = mlp_halfblock_kernel<T, E>;
  MlpMaps maps{};
  int grid = 0;
  size_t smem = mlp_smem<E>();
  cudaError_t err;
  if (std::is_same<T, bf16>::value) {
    // the plan of ops/block_fused.mlp_plan: 256-row groups only whole and
    // only with 256-row slots
    if ((slot_rows != kMlpSmallRows && slot_rows != kMlpBigRows) || big < 0 ||
        (big > 0 && slot_rows != kMlpBigRows) || (long long)big * kMlpBigRows > rows)
      return cudaErrorInvalidValue;
    const long long ws_rows = (long long)slots * slot_rows;
    const bf16* h = static_cast<const bf16*>(ws);
    if ((err = tile_map(&maps.h, h, ws_rows, kBoxRows, E)) != cudaSuccess ||
        (err = tile_map(&maps.mid, h + ws_rows * E, ws_rows, kBoxRows, F)) != cudaSuccess ||
        (err = tile_map(&maps.w_fc, w_fc, F, kD, E)) != cudaSuccess ||
        (err = tile_map(&maps.w_proj, w_proj, E, kD, F)) != cudaSuccess)
      return err;
    smem = kWgmmaSmem;
    if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)smem)) != cudaSuccess)
      return err;
    grid = slots;
  } else {
    if (slot_rows != kMlpRows || big != 0) return cudaErrorInvalidValue;
    if ((err = grid_size(kernel, smem, (rows + kMlpRows - 1) / kMlpRows, slots, &grid)) !=
        cudaSuccess)
      return err;
  }
  kernel<<<grid, kThreads, smem, stream>>>(
      maps, static_cast<const T*>(x), static_cast<const T*>(ln_w), static_cast<const T*>(ln_b),
      static_cast<const T*>(w_fc), b_fc, static_cast<const T*>(w_proj), b_proj,
      static_cast<T*>(out), static_cast<T*>(ws), rows, big, slot_rows, eps);
  return cudaGetLastError();
}

template <int E>
cudaError_t dispatch_mlp(bool bf, const void* x, const void* ln_w, const void* ln_b,
                         const void* w_fc, const float* b_fc, const void* w_proj,
                         const float* b_proj, void* out, void* ws, int slots, int slot_rows,
                         int big, int rows, float eps, cudaStream_t s) {
  return bf ? launch_mlp<bf16, E>(x, ln_w, ln_b, w_fc, b_fc, w_proj, b_proj, out, ws, slots,
                                  slot_rows, big, rows, eps, s)
            : launch_mlp<float, E>(x, ln_w, ln_b, w_fc, b_fc, w_proj, b_proj, out, ws, slots,
                                   slot_rows, big, rows, eps, s);
}

}  // namespace

// K5. x, out: [B, L, E]; ln_w, ln_b: [E]; w_in: [3E, E] (q, k, v rows);
// w_out: [E, E]; E = 512 or 768 (heads of 64); all of one dtype (0 =
// float32, 1 = bfloat16), contiguous and 16-byte aligned. b_in [3E] and
// b_out [E]: fp32. mask: fp32 [L, L] or null. A block takes S samples at a
// time (bf16: at most 256 rows and 512 padded attention rows, or one
// sample); ws holds slots slices of slot elements of the dtype, each at
// least h and ctx [S L, E] (and q/k/v [S L, 192] in fp32). Returns the
// launch's cudaError_t (0 on success); the caller has checked the shapes.
extern "C" int msclip_attention_halfblock(const void* x, const void* ln_w, const void* ln_b,
                                          const void* w_in, const float* b_in,
                                          const void* w_out, const float* b_out,
                                          const float* mask, void* out, void* ws,
                                          long long slot, int slots, int B, int L, int S, int E,
                                          float eps, int dtype, void* stream) {
  if (B <= 0 || L <= 0 || L > kMaxSeq || slots <= 0 || S <= 0 || (dtype != 0 && dtype != 1) ||
      (dtype == 1 && !bf16_group_fits(S, L)) || (E != 512 && E != 768))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(E == 512 ? dispatch_attn<512>(dtype == 1, x, ln_w, ln_b, w_in, b_in, w_out, b_out,
                                             mask, out, ws, slot, slots, B, L, S, eps, s)
                        : dispatch_attn<768>(dtype == 1, x, ln_w, ln_b, w_in, b_in, w_out, b_out,
                                             mask, out, ws, slot, slots, B, L, S, eps, s));
}

// K6. x, out: [rows, E]; ln_w, ln_b: [E]; w_fc: [4E, E]; w_proj: [E, 4E];
// E = 512 or 768; one dtype as above, 16-byte aligned. b_fc [4E] and
// b_proj [E]: fp32. The plan is ops/block_fused.mlp_plan's. bf16: `big`
// groups of 256 rows, then groups of 128, on `slots` blocks; ws holds h
// [slots slot_rows, E] and then mid [slots slot_rows, 4E], slot_rows 256
// where big > 0, else 128. fp32: big 0, slot_rows 32, and ws holds slots
// slices of 32 (E + 128) elements.
extern "C" int msclip_mlp_halfblock(const void* x, const void* ln_w, const void* ln_b,
                                    const void* w_fc, const float* b_fc, const void* w_proj,
                                    const float* b_proj, void* out, void* ws, int slots,
                                    int slot_rows, int big, int rows, int E, float eps, int dtype,
                                    void* stream) {
  if (rows <= 0 || slots <= 0 || (dtype != 0 && dtype != 1) || (E != 512 && E != 768))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(E == 512 ? dispatch_mlp<512>(dtype == 1, x, ln_w, ln_b, w_fc, b_fc, w_proj, b_proj,
                                            out, ws, slots, slot_rows, big, rows, eps, s)
                        : dispatch_mlp<768>(dtype == 1, x, ln_w, ln_b, w_fc, b_fc, w_proj, b_proj,
                                            out, ws, slots, slot_rows, big, rows, eps, s));
}

extern "C" const char* msclip_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
