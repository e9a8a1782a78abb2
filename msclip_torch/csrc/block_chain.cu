// The trunk block's elementwise chain (K7), for Hopper (sm_90a).
//
// Replaces no TPU kernel: XLA fuses this chain into the GEMMs' neighbours on
// the TPU, while PyTorch's eager ops run it as ~28 full-tensor passes a
// block, most on their non-vectorised broadcast path. layers.
// transformer_block runs these five kernels in its place where no autograd
// graph is recorded; the GEMMs stay cuBLAS and the attention core K1:
//
//   h  = ln(x; ln_1)                          LN1
//   qkv = bias(h W_in^T; in_proj_bias)        the qkv projection's bias
//   x1, h2 = bias_residual_ln(a W_out^T; out_proj_bias, x; ln_2)
//        x1 = x + (y + b), h2 = LN2(x1)       out-projection bias, residual, LN2
//   m  = bias_gelu(h2 W_fc^T; c_fc.bias)      QuickGELU(y + b)
//   out = bias_residual(m W_proj^T; c_proj.bias, x1)   x1 + (y + b)
//
// Rounding follows the eager ops step by step (ops/block_chain.py's plain
// versions, layers.layer_norm, linear and quick_gelu): torch computes each op
// in fp32 and rounds it to the tensor's type (bf16 or fp32) where it stores:
//
// * y + b, x + t: in bf16 one packed bf16x2 add (__hadd2_rn), which rounds
//   the exact sum once, as torch's fp32 sum rounded to bf16 does (a
//   rounding through fp32's 24 bits and then to bf16's 8 is the one
//   rounding: 24 >= 2 * 8 + 2, Figueroa; sums in the subnormal range are
//   exact in fp32); in fp32 an fp32 add;
// * QuickGELU t * sigmoid(1.702 t): t1 = round(t * 1.702f) in fp32 (torch
//   casts the Python scalar to fp32, so the product is not a bf16 product),
//   s = round(1 / (1 + expf(-t1))) with an IEEE division and CUDA's expf,
//   as torch's sigmoid kernel computes it, then round(t * s), in bf16 one
//   packed bf16x2 product (the card test holds it on every bf16 t);
// * the LayerNorm: ln_row.cuh, K3's row body; only the order of its sums
//   differs from torch's, so n = (x - mean) rstd may land an ulp away.
//
// nvcc is never given --use_fast_math; each op that must round on its own is
// an _rn intrinsic, which nvcc does not contract.
//
// Bound on an H100 SXM: memory (a few operations an element). At the B/16
// image tower (50,432 rows, E = 768), bf16, bytes read once and written
// once: ln 155 MB, bias (2,304 wide) 465 MB, bias_residual_ln 310 MB,
// bias_gelu (3,072 wide) 620 MB, bias_residual 232 MB: 1.78 GB a block,
// 0.53 ms at 3.35 TB/s (the biases and LayerNorm weights, read by every row
// from L1/L2, not counted).
//
// Design: the LayerNorms run one warp a row (ln_row.cuh), the row in
// registers between its two passes, so x is read once. The bias kernels walk
// the flat tensor in 8-element chunks, 16-byte loads and stores, neighbouring
// threads on neighbouring chunks, four chunks a thread with every load issued
// before the first use; the bias chunk comes from L1 by the chunk's column.
// In bf16 every rounding that can be a packed bf16x2 op is one: the card
// converts fp32 to bf16 at a quarter of its fp32 rate (16 a clock an SM,
// as MUFU's ex2 and rcp), and QuickGELU with a conversion at each of its
// four roundings ran at 0.52 of the bytes' bound at B/16, against 0.88 in
// fp32 (PERF.md, K7). Now it converts twice a pair (t1 and s).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

#include "ln_row.cuh"

namespace {

constexpr int kThreads = 256;  // bias kernels: threads a block
constexpr int kUnroll = 4;     // chunks a thread

enum BiasKind { kBias = 0, kBiasGelu = 1, kBiasResidual = 2 };

__device__ __forceinline__ float sigmoid(float u) {
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-u)));
}

// QuickGELU of a pair of bf16 values, rounded as the eager bf16 ops round
__device__ __forceinline__ __nv_bfloat162 quick_gelu2(__nv_bfloat162 t) {
  const float2 tf = __bfloat1622float2(t);
  const float2 t1 = __bfloat1622float2(
      __floats2bfloat162_rn(__fmul_rn(tf.x, 1.702f), __fmul_rn(tf.y, 1.702f)));
  return __hmul2_rn(t, __floats2bfloat162_rn(sigmoid(t1.x), sigmoid(t1.y)));
}

// One chunk of y + b (kBias), QuickGELU(y + b) (kBiasGelu) or x + (y + b)
// (kBiasResidual)
template <int kKind>
__device__ __forceinline__ Chunk<__nv_bfloat16> bias_chunk(const Chunk<__nv_bfloat16>& y,
                                                           const Chunk<__nv_bfloat16>& b,
                                                           const Chunk<__nv_bfloat16>& x) {
  Chunk<__nv_bfloat16> out;
#pragma unroll
  for (int i = 0; i < kChunk / 2; ++i) {
    __nv_bfloat162 t = __hadd2_rn(y.pairs()[i], b.pairs()[i]);
    if (kKind == kBiasGelu) t = quick_gelu2(t);
    if (kKind == kBiasResidual) t = __hadd2_rn(x.pairs()[i], t);
    out.pairs()[i] = t;
  }
  return out;
}

template <int kKind>
__device__ __forceinline__ Chunk<float> bias_chunk(const Chunk<float>& y, const Chunk<float>& b,
                                                   const Chunk<float>& x) {
  float v[kChunk];
#pragma unroll
  for (int i = 0; i < kChunk; ++i) {
    v[i] = __fadd_rn(y.get(i), b.get(i));
    if (kKind == kBiasGelu) v[i] = __fmul_rn(v[i], sigmoid(__fmul_rn(v[i], 1.702f)));
    if (kKind == kBiasResidual) v[i] = __fadd_rn(x.get(i), v[i]);
  }
  Chunk<float> out;
  out.raw[0] = make_float4(v[0], v[1], v[2], v[3]);
  out.raw[1] = make_float4(v[4], v[5], v[6], v[7]);
  return out;
}

// bias, bias_gelu, bias_residual over y [rows, N] (chunks = rows * N / 8
// chunks of 8; n8 = N / 8 chunks a row), the bias b [N], x [rows, N] for the
// residual
template <typename T, int kKind>
__global__ void __launch_bounds__(kThreads)
bias_kernel(const T* __restrict__ y, const T* __restrict__ b, const T* __restrict__ x,
            T* __restrict__ out, unsigned chunks, unsigned n8) {
  const unsigned first = blockIdx.x * (kThreads * kUnroll) + threadIdx.x;
  Chunk<T> yc[kUnroll], bc[kUnroll], xc[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const unsigned c = first + u * kThreads;
    if (c < chunks) {
      yc[u].load(y + (size_t)c * kChunk);
      bc[u].load(b + (c % n8) * kChunk);
      if (kKind == kBiasResidual) xc[u].load(x + (size_t)c * kChunk);
    }
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const unsigned c = first + u * kThreads;
    if (c < chunks) bias_chunk<kKind>(yc[u], bc[u], xc[u]).store(out + (size_t)c * kChunk);
  }
}

// ln (residual = false): h = LN(x). bias_residual_ln (residual = true): x1 =
// x + (y + yb) to x1_out, then h = LN(x1). One warp a row.
template <typename T, int C, bool kResidual>
__global__ void __launch_bounds__(kLnWarps * 32)
ln_kernel(const T* __restrict__ x, const T* __restrict__ y, const T* __restrict__ yb,
          const T* __restrict__ w, const T* __restrict__ b, T* __restrict__ x1_out,
          T* __restrict__ h_out, int rows, int E, float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kLnWarps + (threadIdx.x >> 5);
  if (row >= rows) return;  // the whole warp leaves together
  const int n_chunks = E / kChunk;
  const size_t base = (size_t)row * E;

  float v[C][kChunk];
  if (kResidual) {
    Chunk<T> xc[C], yc[C], bc[C];
#pragma unroll
    for (int j = 0; j < C; ++j) {
      const int c = lane + 32 * j;
      if (c < n_chunks) {
        xc[j].load(x + base + c * kChunk);
        yc[j].load(y + base + c * kChunk);
        bc[j].load(yb + c * kChunk);
      }
    }
#pragma unroll
    for (int j = 0; j < C; ++j) {
      const int c = lane + 32 * j;
      if (c < n_chunks) {
        const Chunk<T> x1 = bias_chunk<kBiasResidual>(yc[j], bc[j], xc[j]);
        x1.store(x1_out + base + c * kChunk);
#pragma unroll
        for (int i = 0; i < kChunk; ++i) v[j][i] = x1.get(i);
      }
    }
  } else {
    ln_load<T, C>(v, x + base, lane, n_chunks);
  }
  Affine<T> affine;
  ln_row<T, C>(v, w, b, affine, lane, E, eps);
#pragma unroll
  for (int j = 0; j < C; ++j) {
    const int c = lane + 32 * j;
    if (c < n_chunks) Chunk<T>::store(h_out + base + c * kChunk, v[j]);
  }
}

template <typename T, bool kResidual>
cudaError_t launch_ln(const void* x, const void* y, const void* yb, const void* w,
                      const void* b, void* x1_out, void* h_out, int rows, int E, float eps,
                      cudaStream_t stream) {
  const int blocks = (rows + kLnWarps - 1) / kLnWarps;
  return dispatch_ln_chunks(E, [&](auto c) {
    ln_kernel<T, decltype(c)::value, kResidual><<<blocks, kLnWarps * 32, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(y), static_cast<const T*>(yb),
        static_cast<const T*>(w), static_cast<const T*>(b), static_cast<T*>(x1_out),
        static_cast<T*>(h_out), rows, E, eps);
    return cudaGetLastError();
  });
}

template <typename T, int kKind>
cudaError_t launch_bias(const void* y, const void* b, const void* x, void* out, long long rows,
                        int N, cudaStream_t stream) {
  const unsigned chunks = (unsigned)(rows * (N / kChunk));
  const unsigned per_block = kThreads * kUnroll;
  bias_kernel<T, kKind><<<(chunks + per_block - 1) / per_block, kThreads, 0, stream>>>(
      static_cast<const T*>(y), static_cast<const T*>(b), static_cast<const T*>(x),
      static_cast<T*>(out), chunks, (unsigned)(N / kChunk));
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_bias(int kind, const void* y, const void* b, const void* x, void* out,
                          long long rows, int N, cudaStream_t st) {
  switch (kind) {
    case kBias: return launch_bias<T, kBias>(y, b, x, out, rows, N, st);
    case kBiasGelu: return launch_bias<T, kBiasGelu>(y, b, x, out, rows, N, st);
    default: return launch_bias<T, kBiasResidual>(y, b, x, out, rows, N, st);
  }
}

template <bool kResidual>
cudaError_t dispatch_ln(const void* x, const void* y, const void* yb, const void* w,
                        const void* b, void* x1_out, void* h_out, int rows, int E, float eps,
                        int dtype, cudaStream_t st) {
  return dtype == 1 ? launch_ln<__nv_bfloat16, kResidual>(x, y, yb, w, b, x1_out, h_out, rows,
                                                           E, eps, st)
                    : launch_ln<float, kResidual>(x, y, yb, w, b, x1_out, h_out, rows, E,
                                                  eps, st);
}

bool bad_ln_shape(int rows, int E, int dtype) {
  return rows <= 0 || E <= 0 || E % kChunk != 0 || E > 32 * kLnMaxChunks * kChunk ||
         (dtype != 0 && dtype != 1);
}

}  // namespace

// Every pointer 16-byte aligned and contiguous, every tensor of one dtype
// (0 = float32, 1 = bfloat16); rows x E, E % 8 == 0 and E <= 4096; w, b:
// [E]. Each returns the launch's cudaError_t (0 on success); the caller has
// checked shapes and alignment.

// h = LN(x)
extern "C" int msclip_block_ln(const void* x, const void* w, const void* b, void* h, int rows,
                               int E, float eps, int dtype, void* stream) {
  if (bad_ln_shape(rows, E, dtype)) return (int)cudaErrorInvalidValue;
  return (int)dispatch_ln<false>(x, nullptr, nullptr, w, b, nullptr, h, rows, E, eps, dtype,
                                 static_cast<cudaStream_t>(stream));
}

// x1 = x + (y + yb), h = LN(x1); y, x, x1, h: [rows, E], yb: [E]
extern "C" int msclip_block_bias_residual_ln(const void* y, const void* yb, const void* x,
                                             const void* w, const void* b, void* x1, void* h,
                                             int rows, int E, float eps, int dtype,
                                             void* stream) {
  if (bad_ln_shape(rows, E, dtype)) return (int)cudaErrorInvalidValue;
  return (int)dispatch_ln<true>(x, y, yb, w, b, x1, h, rows, E, eps, dtype,
                                static_cast<cudaStream_t>(stream));
}

// kind 0: out = y + b; 1: out = QuickGELU(y + b); 2: out = x + (y + b). y,
// x, out: [rows, N], b: [N]; N % 8 == 0 and rows * N / 8 < 2^31.
extern "C" int msclip_block_bias(int kind, const void* y, const void* b, const void* x,
                                 void* out, long long rows, int N, int dtype, void* stream) {
  if (rows <= 0 || N <= 0 || N % kChunk != 0 || rows * (N / kChunk) >= (1LL << 31) ||
      kind < 0 || kind > 2 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(dtype == 1 ? dispatch_bias<__nv_bfloat16>(kind, y, b, x, out, rows, N, st)
                          : dispatch_bias<float>(kind, y, b, x, out, rows, N, st));
}

extern "C" const char* msclip_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
