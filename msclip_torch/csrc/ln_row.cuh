// The LayerNorm row body shared by K3 (quant.cu: LayerNorm, then the int8
// quantizer) and K7 (block_chain.cu: LayerNorm in the compute dtype, alone
// or after the out-projection's bias and the residual add): the
// fp32-island LayerNorm of layers.layer_norm, one warp a row.
//
// Arithmetic: mean = sum(x) / E, var = sum((x - mean)^2) / E, both in fp32
// and two-pass (not E[x^2] - mean^2); n = (x - mean) * rsqrt(var + eps),
// rounded to the input type; h = w n + b in the input type, rounded after
// the multiply and again after the add (bf16: to bf16 after each fp32 op,
// as torch and XLA do; fp32: no fused multiply-add). The rsqrt is rsqrtf,
// which torch's rsqrt runs on the card too. Only the order of the sums
// differs from torch's.
//
// Layout: lane l of the row's warp holds the 8-element chunks l, l + 32, ...
// (three at E = 768, two at 512) as fp32 in registers from the first pass
// on (16-byte loads of bf16, neighbouring lanes on neighbouring addresses).
// Each chunk sums its elements as a tree into a partial sum of its own, so
// that the row's sums run as independent chains and not as one serial chain
// of 24; the squares of the second pass are fused multiply-adds. In bf16 the
// affine runs on packed bf16x2 (Affine), w and b as loaded. The weight and
// bias (E values each) are read by every row from L1/L2.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kChunk = 8;          // elements per lane (or thread) and chunk
constexpr int kLnWarps = 8;        // rows a block: one a warp
constexpr int kLnMaxChunks = 16;   // per lane: E <= 32 * 16 * 8 = 4096

// Eight consecutive elements of a row in their input type: one 16-byte
// register tuple for bf16, two for fp32.
template <typename T>
struct Chunk;

template <>
struct Chunk<__nv_bfloat16> {
  uint4 raw;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    raw = *reinterpret_cast<const uint4*>(p);
  }
  __device__ __forceinline__ float get(int i) const {
    const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
    return __bfloat162float(h[i]);
  }
  __device__ __forceinline__ const __nv_bfloat162* pairs() const {
    return reinterpret_cast<const __nv_bfloat162*>(&raw);
  }
  __device__ __forceinline__ __nv_bfloat162* pairs() { return reinterpret_cast<__nv_bfloat162*>(&raw); }
  __device__ __forceinline__ void store(__nv_bfloat16* p) const {
    *reinterpret_cast<uint4*>(p) = raw;
  }
  // eight values that are bf16 already (exact conversions), one 16-byte store
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float (&v)[kChunk]) {
    uint4 out;
    __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
    for (int i = 0; i < kChunk; i += 2) h2[i / 2] = __floats2bfloat162_rn(v[i], v[i + 1]);
    *reinterpret_cast<uint4*>(p) = out;
  }
};

template <>
struct Chunk<float> {
  float4 raw[2];
  __device__ __forceinline__ void load(const float* p) {
    raw[0] = reinterpret_cast<const float4*>(p)[0];
    raw[1] = reinterpret_cast<const float4*>(p)[1];
  }
  __device__ __forceinline__ float get(int i) const {
    return reinterpret_cast<const float*>(raw)[i];
  }
  __device__ __forceinline__ void store(float* p) const {
    reinterpret_cast<float4*>(p)[0] = raw[0];
    reinterpret_cast<float4*>(p)[1] = raw[1];
  }
  static __device__ __forceinline__ void store(float* p, const float (&v)[kChunk]) {
    reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
  }
};

// NaN-propagating max, as torch's amax and clamp_min take it (fmaxf drops
// a NaN operand)
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// The affine on one chunk: h = w n + b with n = (x - mean) rstd (v holds
// x - mean, then h), n rounded to the input type, the product and the sum
// each rounded to it; amax takes max |h|, NaN-propagating (K3 reads it;
// K7 does not, and the compiler drops it there).
template <typename T>
struct Affine;

// bf16 on packed bf16x2: one rounding of n pair by pair, then the product
// and the sum each rounded once to bf16. That equals torch's fp32 product
// (or sum) rounded to bf16: a rounding through a format of p' >= 2p + 2
// significant bits and then to p bits is the one rounding (Figueroa; fp32's
// 24 against bf16's 8), and a product in fp32's subnormal range, the one
// place fp32 is narrower, makes an h below 2^-100, which quantizes to 0
// under a scale of at least 1e-8 and leaves a row's scale at its floor.
template <>
struct Affine<__nv_bfloat16> {
  __nv_bfloat162 amax2 = __float2bfloat162_rn(0.0f);
  __device__ __forceinline__ void run(float (&v)[kChunk], const Chunk<__nv_bfloat16>& w,
                                      const Chunk<__nv_bfloat16>& b, float rstd) {
    const __nv_bfloat162* w2 = reinterpret_cast<const __nv_bfloat162*>(&w.raw);
    const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(&b.raw);
#pragma unroll
    for (int i = 0; i < kChunk; i += 2) {
      const __nv_bfloat162 n2 = __floats2bfloat162_rn(__fmul_rn(v[i], rstd),
                                                      __fmul_rn(v[i + 1], rstd));
      const __nv_bfloat162 h2 = __hadd2_rn(__hmul2_rn(w2[i / 2], n2), b2[i / 2]);
      amax2 = __hmax2_nan(amax2, __habs2(h2));
      v[i] = __low2float(h2);
      v[i + 1] = __high2float(h2);
    }
  }
  __device__ __forceinline__ float amax() const {
    return max_nan(__low2float(amax2), __high2float(amax2));
  }
};

// fp32: each op an fp32 op of its own (no fused multiply-add)
template <>
struct Affine<float> {
  float amax_ = 0.0f;
  __device__ __forceinline__ void run(float (&v)[kChunk], const Chunk<float>& w,
                                      const Chunk<float>& b, float rstd) {
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      v[i] = __fadd_rn(__fmul_rn(w.get(i), __fmul_rn(v[i], rstd)), b.get(i));
      amax_ = max_nan(amax_, fabsf(v[i]));
    }
  }
  __device__ __forceinline__ float amax() const { return amax_; }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_max_nan(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = max_nan(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// the sum of a chunk's eight values as a tree of depth three
__device__ __forceinline__ float tree_sum8(const float (&v)[kChunk]) {
  return __fadd_rn(__fadd_rn(__fadd_rn(v[0], v[1]), __fadd_rn(v[2], v[3])),
                   __fadd_rn(__fadd_rn(v[4], v[5]), __fadd_rn(v[6], v[7])));
}

// the lane's chunks of row xr into v (C: chunks a lane the instantiation
// holds; chunk lane + 32 j exists while it is below E / 8)
template <typename T, int C>
__device__ __forceinline__ void ln_load(float (&v)[C][kChunk], const T* __restrict__ xr, int lane,
                                        int n_chunks) {
#pragma unroll
  for (int j = 0; j < C; ++j) {
    if (lane + 32 * j < n_chunks) {
      Chunk<T> c;
      c.load(xr + (lane + 32 * j) * kChunk);
#pragma unroll
      for (int i = 0; i < kChunk; ++i) v[j][i] = c.get(i);
    }
  }
}

// The LayerNorm of the warp's row, held in v (x as fp32, each lane its
// chunks): on return v holds h = w n + b, each value exact in T, and
// affine its abs-max.
template <typename T, int C>
__device__ __forceinline__ void ln_row(float (&v)[C][kChunk], const T* __restrict__ w,
                                       const T* __restrict__ b, Affine<T>& affine, int lane,
                                       int E, float eps) {
  const int n_chunks = E / kChunk;
  float sum = 0.0f;
#pragma unroll
  for (int j = 0; j < C; ++j)
    if (lane + 32 * j < n_chunks) sum = __fadd_rn(sum, tree_sum8(v[j]));
  const float mean = __fdiv_rn(warp_sum(sum), (float)E);

  float sq[C];
#pragma unroll
  for (int j = 0; j < C; ++j) {
    sq[j] = 0.0f;
    if (lane + 32 * j < n_chunks) {
#pragma unroll
      for (int i = 0; i < kChunk; ++i) {
        v[j][i] = __fsub_rn(v[j][i], mean);
        sq[j] = fmaf(v[j][i], v[j][i], sq[j]);
      }
    }
  }
  float sq_all = 0.0f;
#pragma unroll
  for (int j = 0; j < C; ++j) sq_all = __fadd_rn(sq_all, sq[j]);
  const float rstd = rsqrtf(__fadd_rn(__fdiv_rn(warp_sum(sq_all), (float)E), eps));

#pragma unroll
  for (int j = 0; j < C; ++j) {
    const int c = lane + 32 * j;
    if (c < n_chunks) {
      Chunk<T> wc, bc;
      wc.load(w + c * kChunk);
      bc.load(b + c * kChunk);
      affine.run(v[j], wc, bc, rstd);
    }
  }
}

// The fewest chunks a lane, of the instantiations built, that cover a row of
// E: 1, 2, 3, 4, 8, 12 or 16 (3 at E = 768, 2 at 512 and 12 at 3072, with no
// idle lane). Launch(Int<C>) launches the instantiation for C.
template <int C>
struct Int {
  static constexpr int value = C;
};

template <typename Launch>
cudaError_t dispatch_ln_chunks(int E, Launch launch) {
  const int need = (E / kChunk + 31) / 32;
  if (need <= 1) return launch(Int<1>{});
  if (need <= 2) return launch(Int<2>{});
  if (need <= 3) return launch(Int<3>{});
  if (need <= 4) return launch(Int<4>{});
  if (need <= 8) return launch(Int<8>{});
  if (need <= 12) return launch(Int<12>{});
  return launch(Int<kLnMaxChunks>{});
}

}  // namespace
