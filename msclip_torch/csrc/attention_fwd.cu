// Fused multi-head attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel msclip_tpu/ops/attention.py
// (_attn_kernel, launched from _fused_attention_fwd_impl). Computes, per
// sample and head,
//
//     out_h = softmax(q_h k_h^T * D^-1/2 [+ mask]) v_h
//
// straight from the QKV projection output in its native [B, L, 3E] layout
// (the head slice is an offset inside the kernel) and writes [B, L, E].
// Arithmetic follows the TPU kernel: products of the input type summed in
// fp32, the scale applied to the fp32 scores after the product, the fp32
// additive [L, L] mask (causal -inf) added after that, an exact softmax in
// fp32 (the whole row at once, not a running max; the weights divided by
// the row sum), the weights rounded to the input type before the PV
// product, which again sums in fp32, and the result rounded once.
//
// Bound on an H100 SXM: memory. Each launch reads 3E and writes E values per
// token and does 4*L*D multiply-adds per token and head. At ViT-B/32
// (L=50, E=768, H=12), B=256, bf16: 78.6 MB of I/O, 23.5 us at 3.35 TB/s,
// against 2.0 us of matrix work at 989 TFLOP/s. The text tower (L=77,
// causal) with a chunk of 1024 prompts moves 484 MB, 145 us; ViT-B/16
// (L=197), B=256, moves 310 MB, 92.5 us. Beside the bytes, the softmax's
// elementwise work (about ten instructions per score) is the next limit at
// L=197: 256 x 12 x 256 x 208 padded scores take ~50 us of the SMs' fp32
// issue rate. PERF.md has the times against the bound.
//
// Two kernels, chosen by the input type:
//
// * bfloat16 (the production dtype), what the design does about the bound:
//   - Persistent blocks over (sample, head) units: the grid is the SMs
//     times the blocks that fit, each block walks units u, u + grid, ...
//     through a two-stage ring in shared memory. While the block computes
//     unit u, every thread has its share of unit u + grid's Q, K and V in
//     flight as 16-byte cp.async copies (zero-filled past L), so each SM
//     keeps one unit's bytes (24-78 KB) in flight behind its compute. Each
//     unit is the 128-byte head slices of the rows at stride 3E; q, k and v
//     are read from device memory once and each output element is written
//     once, through a 16-byte store per lane.
//   - Tensor cores through wgmma. A tile is a 128-byte-swizzled [rows, 64]
//     bf16 array (cp.async writes the swizzle itself: chunk c of row r to
//     r * 128 + ((c ^ (r & 7)) * 16)). One warpgroup takes a 64-row query
//     tile: S = Q K^T as wgmma.m64n64k16 per 64 keys (and m64n16k16 for a
//     last 16), Q from registers and K from shared memory through its
//     K-major descriptor; the scale, the
//     mask and the softmax on the accumulator registers (a row's keys sit
//     in the four lanes of a quad, two shuffles per reduction; padded keys
//     get -inf); the weights, rounded to bf16 in registers, are the A
//     operand of O = P V as wgmma.m64n64k16 against V in shared memory read
//     through the transposed (N-major) descriptor: no transposed copy and
//     no scalar stores. exp is expf, as in torch's softmax. The division by
//     the row sum rounds as IEEE division does, without its slow-path call,
//     which would serialize the wgmma: the reciprocal of the sum rounded
//     once per row (fp64 Newton steps), then per weight a multiplication
//     and one fma correction of the quotient (hopper.cuh rcp_rn, div_rn).
//     This per-tile body lives in attn_core.cuh (attn_query_tile), which
//     the fused attention half-block (K5, halfblock.cuh) runs too.
//   - Tiles per warpgroup, by padded length LP (keys and staged query rows
//     padded to 16, query tiles of 64): LP=64 one warpgroup, 4 blocks an
//     SM; LP=80 (the text tower), 128, 208 (ViT-B/16) and 256 two, taking
//     tiles wg, wg + 2, .... A warp whose 16 rows all lie past L reads no Q
//     and skips the softmax. At LP=208 three warpgroups would leave each
//     168 registers, and ptxas then spills and serializes the wgmma.
//   - The softmax is the elementwise work that bounds L=197: per score an
//     fma (the scale and mask), a max, an fma and expf (about eight
//     instructions), a sum, and the division (three); the checks for keys
//     past L run only in the last 16-key step.
//   - The mask is the same [L, L] for every unit: a block copies it into
//     shared memory once when LP <= 128 (23.7 KB at L=77) and reads it there;
//     at LP > 128 (no main path has a mask there) it reads device memory.
//     Key steps masked on every row are not skipped: at the text shape,
//     which is bytes-bound, they are 1 of 10 score steps.
//   - ptxas reports no spills for any bf16 instantiation (chip_smoke.py
//     phase 2 fails on one).
// * float32: CUDA cores, exact fp32 (no TF32). One block of 8 warps per
//   (sample, head) stages K_h and V_h in shared memory as fp32 (K rows
//   padded to D+1 floats so 32 lanes reading 32 keys hit 32 banks); each
//   warp walks query rows, lane l owning keys l, l+32, ..., so the scores
//   stay in registers and softmax takes two warp reductions; for PV lane
//   l owns output columns l, l+32, ... and the weights are broadcast with
//   shuffles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <cstdint>

#include "attn_core.cuh"
#include "hopper.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
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
// bfloat16: persistent blocks, cp.async ring, wgmma
// ---------------------------------------------------------------------------

typedef __nv_bfloat16 bf16;

constexpr int kMaskSmemMaxLP = 128;  // the mask goes to shared memory up to here

// One ring stage, in bytes from a 1024-byte aligned base: Q, K and V as LP
// rows of 64 bf16 each in the 128-byte swizzle. Query tiles have 64 rows;
// a warp whose 16 rows lie past LP has no row < L and reads no Q.
template <int LP>
struct FwdLayout {
  static constexpr int NQT = (LP + 63) / 64;  // query tiles of 64 rows
  static constexpr uint32_t q = 0, k = LP * 128, v = 2 * LP * 128, stage = 3 * LP * 128;
  // dynamic shared memory: alignment slack, two stages, and room for the
  // mask of the bucket's longest L where it is staged
  static constexpr size_t smem(bool mask) {
    return 1024 + 2 * (size_t)stage + (mask && LP <= kMaskSmemMaxLP ? sizeof(float) * LP * LP : 0);
  }
};

// warpgroups a block runs, and blocks an SM is expected to hold (the
// register budget the compiler gets)
template <int LP>
struct FwdShape {
  static constexpr int NWG = LP <= 64 ? 1 : 2;
  static constexpr int kMinBlocks = LP <= 64 ? 4 : LP <= 80 ? 2 : 1;
};

template <int LP>
__global__ void __launch_bounds__(FwdShape<LP>::NWG * 128, FwdShape<LP>::kMinBlocks)
attention_fwd_bf16_kernel(const bf16* __restrict__ qkv, const float* __restrict__ mask,
                          bf16* __restrict__ out, int B, int L, int E, int H, float scale) {
  using Lay = FwdLayout<LP>;
  constexpr int NWG = FwdShape<LP>::NWG, NQT = Lay::NQT;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* base_ptr = smem_raw + (base - raw);


  const int units = B * H;
  const long long rs = 3LL * E;  // row stride of qkv

  // unit u's Q, K and V (rows 0..LP) into ring stage st; rows past L are
  // zeros
  auto stage_unit = [&](int u, int st) {
    const bf16* src = qkv + (long long)(u / H) * L * rs + (u % H) * 64;
    const uint32_t sb = base + st * Lay::stage;
    for (int idx = threadIdx.x; idx < 3 * LP * 8; idx += blockDim.x) {
      const int which = idx / (LP * 8), rem = idx % (LP * 8);
      const int row = rem >> 3, ch = rem & 7;
      const bool ok = row < L;
      cp_async16(sb + which * LP * 128 + sw128(row, ch),
                 src + (long long)(ok ? row : 0) * rs + which * E + ch * 8, ok);
    }
  };

  const int wg = threadIdx.x >> 7;

  int u = blockIdx.x;
  if (u < units) stage_unit(u, 0);
  cp_async_commit();
  // the mask, the same [L, L] for every unit, is copied while the first
  // unit's copies are in flight
  const float* mk = mask;
  if (mask != nullptr && LP <= kMaskSmemMaxLP) {
    float* ms = reinterpret_cast<float*>(base_ptr + 2 * Lay::stage);
    for (int i = threadIdx.x; i < L * L; i += blockDim.x) ms[i] = mask[i];
    mk = ms;  // published by the first barrier of the unit loop
  }
  for (int it = 0; u < units; ++it, u += gridDim.x) {
    const int st = it & 1;
    if (u + (int)gridDim.x < units) stage_unit(u + gridDim.x, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // unit u has landed; unit u + grid stays in flight
    fence_proxy_async();
    __syncthreads();

    const uint32_t sk = base + st * Lay::stage + Lay::k;
    const uint32_t sv = base + st * Lay::stage + Lay::v;
    unsigned char* q_s = base_ptr + st * Lay::stage + Lay::q;
    const int b = u / H, h = u % H;

    bf16* out_b = out + (long long)b * L * E + h * 64;
    for (int qt = wg; qt < NQT; qt += NWG)
      attn_query_tile<LP>(q_s, sk, sv, mk, L, scale, qt, out_b, E);
    __syncthreads();  // stage st is free for unit u + 2 grid
  }
}

template <int LP>
cudaError_t launch_bf16_lp(const void* qkv, const float* mask, void* out, int B, int L, int E,
                           int H, cudaStream_t stream) {
  auto kernel = attention_fwd_bf16_kernel<LP>;
  constexpr int threads = FwdShape<LP>::NWG * 128;
  static const size_t smem[2] = {FwdLayout<LP>::smem(false), FwdLayout<LP>::smem(true)};
  static int per_sm[2] = {0, 0};
  const int with_mask = mask != nullptr;
  int grid;
  cudaError_t err = persistent_grid(kernel, threads, smem, per_sm, with_mask, B * H, &grid);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem[with_mask], stream>>>(static_cast<const bf16*>(qkv), mask,
                                          static_cast<bf16*>(out), B, L, E, H,
                                          1.0f / sqrtf(64.0f));
  return cudaGetLastError();
}

// the instantiation at padded_len(L) (attn_core.cuh)
cudaError_t launch_bf16(const void* qkv, const float* mask, void* out, int B, int L, int E,
                        int H, cudaStream_t stream) {
  switch (padded_len(L)) {
    case 64: return launch_bf16_lp<64>(qkv, mask, out, B, L, E, H, stream);
    case 80: return launch_bf16_lp<80>(qkv, mask, out, B, L, E, H, stream);
    case 128: return launch_bf16_lp<128>(qkv, mask, out, B, L, E, H, stream);
    case 208: return launch_bf16_lp<208>(qkv, mask, out, B, L, E, H, stream);
    default: return launch_bf16_lp<256>(qkv, mask, out, B, L, E, H, stream);
  }
}

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------

// D: head width (multiple of 32). KPL: keys per lane, ceil(L / 32) rounded
// up to the instantiated bound.
template <int D, int KPL>
__global__ void __launch_bounds__(kThreads)
attention_fwd_f32_kernel(const float* __restrict__ qkv,
                         const float* __restrict__ mask,
                         float* __restrict__ out, int L, int E, int H,
                         float scale) {
  constexpr int DP = D + 1;   // padded K row
  constexpr int CPL = D / 32; // output columns per lane
  extern __shared__ float smem[];
  float* k_s = smem;                 // [L, D+1]
  float* v_s = k_s + L * DP;         // [L, D]
  float* q_s = v_s + L * D;          // [kWarps, D]

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const long long row_stride = 3LL * E;
  const float* base = qkv + (long long)b * L * row_stride + h * D;

  for (int idx = threadIdx.x; idx < L * D; idx += kThreads) {
    const int j = idx / D, d = idx % D;
    const float* row = base + j * row_stride;
    k_s[j * DP + d] = row[E + d];
    v_s[j * D + d] = row[2 * E + d];
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* q_w = q_s + warp * D;
  float* out_b = out + (long long)b * L * E + h * D;

  for (int i = warp; i < L; i += kWarps) {
    const float* q_row = base + i * row_stride;
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
        for (int d = 0; d < D; ++d) acc = fmaf(q_w[d], k_row[d], acc);
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
        const float* v_row = v_s + (t * 32 + jj) * D;
#pragma unroll
        for (int c = 0; c < CPL; ++c) acc[c] = fmaf(w, v_row[lane + 32 * c], acc[c]);
      }
    }
    float* o_row = out_b + (long long)i * E;
#pragma unroll
    for (int c = 0; c < CPL; ++c) o_row[lane + 32 * c] = acc[c];
    __syncwarp();
  }
}

template <int D, int KPL>
cudaError_t launch_f32(const void* qkv, const float* mask, void* out, int B, int L,
                   int E, int H, cudaStream_t stream) {
  auto kernel = attention_fwd_f32_kernel<D, KPL>;
  const size_t smem = sizeof(float) * ((size_t)L * (D + 1) + (size_t)L * D + kWarps * D);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const float scale = 1.0f / sqrtf((float)D);
  kernel<<<B * H, kThreads, smem, stream>>>(static_cast<const float*>(qkv), mask,
                                            static_cast<float*>(out), L, E, H, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32_len(const void* qkv, const float* mask, void* out, int B,
                         int L, int E, int H, cudaStream_t stream) {
  if (L <= 64) return launch_f32<D, 2>(qkv, mask, out, B, L, E, H, stream);
  if (L <= 128) return launch_f32<D, 4>(qkv, mask, out, B, L, E, H, stream);
  return launch_f32<D, 8>(qkv, mask, out, B, L, E, H, stream);
}

cudaError_t dispatch(const void* qkv, const float* mask, void* out, int B, int L,
                     int E, int H, bool bf16, cudaStream_t stream) {
  // every MS-CLIP tower has heads of width 64 (vision heads = width / 64)
  if (E / H != 64) return cudaErrorInvalidValue;
  return bf16 ? launch_bf16(qkv, mask, out, B, L, E, H, stream)
              : launch_f32_len<64>(qkv, mask, out, B, L, E, H, stream);
}

}  // namespace

// qkv: [B, L, 3E] contiguous and 16-byte aligned, out: [B, L, E]
// contiguous, same dtype (0 = float32, 1 = bfloat16). mask: fp32 [L, L] or
// null. Returns the launch's cudaError_t (0 on success); the caller has
// checked the shapes.
extern "C" int msclip_attention_fwd(const void* qkv, const float* mask, void* out,
                                    int B, int L, int E, int H, int dtype,
                                    void* stream) {
  if (B <= 0 || L <= 0 || L > kMaxSeq || H <= 0 || E % H != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  return (int)dispatch(qkv, mask, out, B, L, E, H, dtype == 1, s);
}

extern "C" const char* msclip_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
