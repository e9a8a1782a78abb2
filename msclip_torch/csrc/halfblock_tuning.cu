// The attention half-block's tuning kernels, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of experiments/halfblock_tuning.py, the
// JAX package's tool for tuning the fused half-block:
//
// * E1, make_attn_half (bodies attn_kern_v0, v1, v2, v3, v2a, v2c):
//       out = x + out_proj(MHA(LN1(x)))
//   K5's function without a mask, at the rounding points of one of four
//   numeric variants (Variant in halfblock.cuh): the base (v0, v2 and v3,
//   which differ on the TPU only in Mosaic layouts), the qkv GEMM rounded
//   before its bias is added (v1), the softmax as e * (1 / sum) (v2c), and
//   no attention, ctx = v + 1e-4 q + 1e-4 k (v2a, the script's stub that
//   isolates the GEMMs' cost);
// * E2, make_hybrid_b (body core_out_kern):
//       out = x + (ctx(qkv) W_out^T + b_out)
//   the attention core, the out-projection and the residual from a qkv
//   [B, L, 2304] that a library GEMM computed outside the kernel.
//
// Both are K5's device code (halfblock.cuh): E1 is K5's body with the
// variant as a template flag (bf16: attention_halfblock_group on wgmma;
// fp32: attention_halfblock_rows on the CUDA cores). E2 in bf16 is K5's
// attention and out-projection without its LayerNorm and qkv GEMM
// (core_out_group): per head the group's q, k and v columns are copied
// straight from qkv into K1's swizzled tiles, then K1's wgmma attention and
// K5's TMA-fed wgmma out-projection; E2 in fp32 is the mma.sync design's
// per-head attention reading the head's columns from qkv (row stride 2304,
// as K1 reads it) and its out-projection epilogue on the CUDA cores.
// Widths are ViT-B's: E = 768, 12 heads of 64; any B and 0 < L <= 256; no
// mask (the JAX functions take none).
//
// The grid is the script's: B / tb blocks, block b taking samples
// [b tb, (b + 1) tb) (the caller guarantees B % tb == 0). A block walks its
// samples in groups of G <= tb that the caller gives: in bf16 K5's group
// (at most 256 rows and 512 padded attention rows, one sample at L > 128;
// bf16_group_fits, which the kernels check), in fp32 the mma.sync design's
// min(tb, max(1, 128 / L)). With tb = 8, 16 or 32 (the script's batch
// tiles) at B = 256 the grid has 32, 16 or 8 blocks for the card's 132
// SMs; the default tb is K5's group, 128 blocks at L = 50 on 132 SMs.
//
// Bound on an H100 SXM, B = 256, L = 50, bf16: E1 is K5's 62.4 GFLOP
// (60.4 without attention, v2a), 63 us at 989 TFLOP/s against 44 MB of
// I/O; E2 is 17.1 GFLOP (15.1 in the out-projection), 17 us, against
// 99.5 MB of I/O (x, the 3E-wide qkv and out: 30 us at 3.35 TB/s), so E2
// is bound by bytes. What the design does about it: x and qkv are read
// once and the output written once; each w_out tile is staged once for
// the group's up to 256 rows; ctx goes through a block-private workspace
// slice that stays in the L2; one head's q/k/v copies overlap the previous
// head's attention where two heads' tiles fit in shared memory (groups of
// up to 298 padded rows: 2 samples at L = 50, one at L = 197). PERF.md
// has the times against the bound.

#include "halfblock.cuh"

#include <type_traits>

namespace {

// workspace elements of one block at G samples a group: E1's h, ctx [G L,
// 768] (and in fp32 q/k/v [G L, 192]); E2's ctx [G L, 768]
template <typename T>
__host__ __device__ constexpr long long variant_slot_elems(int G, int L) {
  return (long long)G * L * (2 * kE + (std::is_same<T, bf16>::value ? 0 : kQkv));
}

__host__ __device__ constexpr long long core_out_slot_elems(int G, int L) {
  return (long long)G * L * kE;
}

// ---------------------------------------------------------------------------
// E1
// ---------------------------------------------------------------------------

template <typename T, int A, int V>
__global__ void __launch_bounds__(kThreads)
attn_half_variant_kernel(const __grid_constant__ HalfMaps maps, const T* __restrict__ x,
                         const T* __restrict__ ln_w, const T* __restrict__ ln_b,
                         const T* __restrict__ w_in, const float* __restrict__ b_in,
                         const T* __restrict__ w_out, const float* __restrict__ b_out,
                         T* __restrict__ out, T* __restrict__ ws, long long slot, int L, int tb,
                         int G, float eps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* h = ws + blockIdx.x * slot;
  T* ctx = h + (size_t)G * L * kE;
  const int first = blockIdx.x * tb, end = first + tb;
  if constexpr (std::is_same<T, bf16>::value) {
    Ring ring = make_ring(smem_raw);
    const int h_row0 = (int)(blockIdx.x * slot / kE), ctx_row0 = h_row0 + G * L;
    for (int b0 = first; b0 < end; b0 += G) {
      const size_t off = (size_t)b0 * L * kE;
      attention_halfblock_group<8 * A, V>(maps, x + off, ln_w, ln_b, b_in, b_out, nullptr,
                                          out + off, h, ctx, h_row0, ctx_row0, min(G, end - b0),
                                          L, eps, ring);
    }
  } else {
    for (int b0 = first; b0 < end; b0 += G) {
      const size_t off = (size_t)b0 * L * kE;
      attention_halfblock_rows<T, A, V>(x + off, ln_w, ln_b, w_in, b_in, w_out, b_out, nullptr,
                                        out + off, h, ctx, ctx + (size_t)G * L * kE,
                                        min(G, end - b0) * L, L, eps, smem_raw);
    }
  }
}

// ---------------------------------------------------------------------------
// E2
// ---------------------------------------------------------------------------

template <typename T, int A>
__global__ void __launch_bounds__(kThreads)
core_out_kernel(const __grid_constant__ HalfMaps maps, const T* __restrict__ x,
                const T* __restrict__ qkv, const T* __restrict__ w_out,
                const float* __restrict__ b_out, T* __restrict__ out, T* __restrict__ ws,
                long long slot, int L, int tb, int G) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int ld = 3 * kE;  // qkv's row: q | k | v, each 12 heads of 64
  T* ctx = ws + blockIdx.x * slot;
  const int first = blockIdx.x * tb, end = first + tb;
  if constexpr (std::is_same<T, bf16>::value) {
    Ring ring = make_ring(smem_raw);
    const int ctx_row0 = (int)(blockIdx.x * slot / kE);
    for (int b0 = first; b0 < end; b0 += G) {
      const size_t off = (size_t)b0 * L * kE;
      core_out_group<8 * A>(maps, x + off, qkv + (size_t)b0 * L * ld, b_out, out + off, ctx,
                            ctx_row0, min(G, end - b0), L, ring);
    }
  } else {
    for (int b0 = first; b0 < end; b0 += G) {
      const int rows = min(G, end - b0) * L;
      const T* qb = qkv + (size_t)b0 * L * ld;
      for (int hh = 0; hh < kHeads; ++hh) {
        for (int r0 = 0; r0 < rows; r0 += L) {  // attention sample by sample
          const T* q = qb + (size_t)r0 * ld + hh * kD;
          AttnHead<T, A>::run(q, q + kE, q + 2 * kE, ld, nullptr,
                              ctx + (size_t)r0 * kE + hh * kD, L, kScale, smem_raw);
          __syncthreads();
        }
      }
      const size_t off = (size_t)b0 * L * kE;
      out_projection_residual<T>(ctx, rows, w_out, b_out, x + off, out + off, smem_raw);
    }
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

// Allow the kernel its dynamic shared memory and check that a block fits.
template <typename K>
cudaError_t prepare(K kernel, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  return per_sm < 1 ? cudaErrorInvalidConfiguration : cudaSuccess;
}

// f(T{}, integral_constant<int, A>{}) at the attention tile of length L, as
// K5 (bf16 padded lengths 64, 80, 128, 208, 256; fp32 keys per lane)
template <typename F>
cudaError_t with_tile(bool bf, int L, F f) {
  using std::integral_constant;
  if (bf) {
    switch (padded_len(L)) {  // A = LP / 8
      case 64: return f(bf16{}, integral_constant<int, 8>{});
      case 80: return f(bf16{}, integral_constant<int, 10>{});
      case 128: return f(bf16{}, integral_constant<int, 16>{});
      case 208: return f(bf16{}, integral_constant<int, 26>{});
      default: return f(bf16{}, integral_constant<int, 32>{});
    }
  }
  if (L <= 64) return f(float{}, integral_constant<int, 2>{});
  if (L <= 128) return f(float{}, integral_constant<int, 4>{});
  return f(float{}, integral_constant<int, 8>{});
}

struct VariantArgs {
  const void *x, *ln_w, *ln_b, *w_in;
  const float* b_in;
  const void* w_out;
  const float* b_out;
  void *out, *ws;
  long long slot;
  int B, L, tb, G;
  float eps;
  cudaStream_t stream;
};

template <typename T, int A, int V>
cudaError_t launch_variant(const VariantArgs& a) {
  auto kernel = attn_half_variant_kernel<T, A, V>;
  constexpr bool bf = std::is_same<T, bf16>::value;
  constexpr size_t smem = halfblock_smem<T, A>();
  if (a.G > a.tb || (bf && !bf16_group_fits(a.G, a.L)) ||
      a.slot < variant_slot_elems<T>(a.G, a.L) || (bf && a.slot % kE != 0))
    return cudaErrorInvalidValue;
  HalfMaps maps{};
  cudaError_t err;
  if (bf && (err = half_maps(&maps, a.ws, a.B / a.tb, a.slot, a.w_in, a.w_out)) != cudaSuccess)
    return err;
  if ((err = prepare(kernel, smem)) != cudaSuccess) return err;
  kernel<<<a.B / a.tb, kThreads, smem, a.stream>>>(
      maps, static_cast<const T*>(a.x), static_cast<const T*>(a.ln_w), static_cast<const T*>(a.ln_b),
      static_cast<const T*>(a.w_in), a.b_in, static_cast<const T*>(a.w_out), a.b_out,
      static_cast<T*>(a.out), static_cast<T*>(a.ws), a.slot, a.L, a.tb, a.G, a.eps);
  return cudaGetLastError();
}

template <int V>
cudaError_t dispatch_variant(bool bf, const VariantArgs& a) {
  return with_tile(bf, a.L, [&](auto t, auto tile) {
    return launch_variant<decltype(t), decltype(tile)::value, V>(a);
  });
}

template <typename T, int A>
cudaError_t launch_core_out(const void* x, const void* qkv, const void* w_out,
                            const float* b_out, void* out, void* ws, long long slot, int B,
                            int L, int tb, int G, cudaStream_t stream) {
  auto kernel = core_out_kernel<T, A>;
  constexpr bool bf = std::is_same<T, bf16>::value;
  constexpr size_t smem = halfblock_smem<T, A>();
  if (G > tb || (bf && !bf16_group_fits(G, L)) || slot < core_out_slot_elems(G, L) ||
      (bf && slot % kE != 0))
    return cudaErrorInvalidValue;
  HalfMaps maps{};
  cudaError_t err;
  if (bf) {  // the workspace's B / tb slices, and w_out
    if ((err = tile_map(&maps.ws, ws, B / tb * slot / kE, kBoxRows)) != cudaSuccess) return err;
    if ((err = tile_map(&maps.w_out, w_out, kE, kD)) != cudaSuccess) return err;
  }
  if ((err = prepare(kernel, smem)) != cudaSuccess) return err;
  kernel<<<B / tb, kThreads, smem, stream>>>(
      maps, static_cast<const T*>(x), static_cast<const T*>(qkv), static_cast<const T*>(w_out),
      b_out, static_cast<T*>(out), static_cast<T*>(ws), slot, L, tb, G);
  return cudaGetLastError();
}

bool bad_shape(int B, int L, int tb, int G, int dtype) {
  return B <= 0 || L <= 0 || L > kMaxSeq || tb <= 0 || B % tb != 0 || G <= 0 ||
         (dtype != 0 && dtype != 1);
}

}  // namespace

// E1. x, out: [B, L, 768]; ln_w, ln_b: [768]; w_in: [2304, 768] (q, k, v
// rows); w_out: [768, 768]; all of one dtype (0 = float32, 1 = bfloat16),
// contiguous and 16-byte aligned. b_in [2304] and b_out [768]: fp32.
// variant: a Variant of halfblock.cuh. B % tb == 0; block b takes samples
// [b tb, (b + 1) tb) in groups of G <= tb (bf16: at most 256 rows and 512
// padded attention rows, or one sample); ws holds B / tb slices of slot
// elements of the dtype, each at least h and ctx [G L, 768] (and q/k/v
// [G L, 192] in fp32). Returns the launch's cudaError_t (0 on success);
// the caller has checked the shapes.
extern "C" int msclip_attention_halfblock_variant(const void* x, const void* ln_w,
                                                  const void* ln_b, const void* w_in,
                                                  const float* b_in, const void* w_out,
                                                  const float* b_out, void* out, void* ws,
                                                  long long slot, int B, int L, int tb, int G,
                                                  float eps, int variant, int dtype,
                                                  void* stream) {
  if (bad_shape(B, L, tb, G, dtype)) return (int)cudaErrorInvalidValue;
  const VariantArgs a{x,   ln_w, ln_b, w_in, b_in, w_out, b_out, out, ws,
                      slot, B,   L,    tb,   G,    eps,   static_cast<cudaStream_t>(stream)};
  const bool bf = dtype == 1;
  switch (variant) {
    case kBase: return (int)dispatch_variant<kBase>(bf, a);
    case kQkvRounded: return (int)dispatch_variant<kQkvRounded>(bf, a);
    case kReciprocal: return (int)dispatch_variant<kReciprocal>(bf, a);
    case kNoHeads:  // no attention: one tile for every L
      return (int)(bf ? launch_variant<bf16, 8, kNoHeads>(a) : launch_variant<float, 2, kNoHeads>(a));
    default: return (int)cudaErrorInvalidValue;
  }
}

// E2. x, out: [B, L, 768]; qkv: [B, L, 2304] (q | k | v columns); w_out:
// [768, 768]; one dtype as above. b_out [768]: fp32. B % tb == 0; groups of
// G <= tb samples (bf16: at most 256 rows and 512 padded attention rows, or
// one sample); ws holds B / tb slices of slot elements, each at least ctx
// [G L, 768] (bf16: a whole number of rows of 768).
extern "C" int msclip_core_out_halfblock(const void* x, const void* qkv, const void* w_out,
                                         const float* b_out, void* out, void* ws, long long slot,
                                         int B, int L, int tb, int G, int dtype, void* stream) {
  if (bad_shape(B, L, tb, G, dtype)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)with_tile(dtype == 1, L, [&](auto t, auto tile) {
    return launch_core_out<decltype(t), decltype(tile)::value>(x, qkv, w_out, b_out, out, ws,
                                                               slot, B, L, tb, G, s);
  });
}

extern "C" const char* msclip_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
