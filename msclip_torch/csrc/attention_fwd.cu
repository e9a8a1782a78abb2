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
// additive [L, L] mask (causal -inf) added after that, softmax in fp32, the
// normalised weights rounded to the input type before the PV product, which
// again sums in fp32, and the result rounded to the input type.
//
// Bound on an H100 SXM: memory. Each launch reads 3E and writes E values per
// token and does 4*L*D multiply-adds per token and head. At ViT-B/32
// (L=50, E=768, H=12), B=256, bf16: 78.6 MB of I/O, 23.5 us at 3.35 TB/s,
// against 2.0 us of matrix work at 989 TFLOP/s. The text tower (L=77,
// causal) with a chunk of 1024 prompts moves 484 MB, 145 us; ViT-B/16
// (L=197), B=256, moves 310 MB, 92.5 us. What the design does about it:
// each q, k and v element is read from device memory once and each output
// element written once; scores and weights live only in registers (bf16)
// or registers and shared memory (fp32). PERF.md has the times against
// the bound.
//
// Two kernels, chosen by the input type:
//
// * bfloat16 (the production dtype): tensor cores through mma.sync
//   m16n8k16 (bf16 in, fp32 accumulators). One block per (sample, head),
//   one warp per 16-row query tile (up to 8 warps). The block copies Q_h,
//   K_h and V_h (V_h transposed) into shared memory with 16-byte loads,
//   zero-padding L up to a multiple of 16. Each warp computes its 16 x L
//   score tile S = Q K^T into registers, takes the fp32 softmax there (a
//   row sits in the four lanes of a quad: two shuffles per reduction;
//   padded keys get -inf, the mask is added after the scale), rounds the
//   weights to bf16, and feeds them, still in registers, as the A operand
//   of O = P V. At L=256 the block uses 107 KB of shared memory, so the
//   launch raises the block's dynamic shared-memory limit with
//   cudaFuncSetAttribute.
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
// bfloat16: tensor cores (mma.sync m16n8k16, scores kept in registers)
// ---------------------------------------------------------------------------

constexpr int kTcMaxWarps = 8;

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

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Shared-memory layout, in bf16 elements: Q_h and K_h as [LP, D + 8] rows,
// V_h transposed as [D, LP + 8]. The +8 pads make the fragment loads of a
// warp (8 rows x 4 words) hit 32 distinct banks.
template <int D, int LP>
struct TcLayout {
  static constexpr int ds = D + 8, vs = LP + 8;
  static constexpr size_t bytes = sizeof(__nv_bfloat16) * (2 * LP * ds + D * vs);
};

// NT: key tiles of 8, so that the padded length LP = 8 NT is a multiple of
// 16 and covers L. One block per (sample, head); warp w takes the 16-row
// query tiles w, w + warps, ...
template <int D, int NT>
__global__ void __launch_bounds__(kTcMaxWarps * 32)
attention_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ qkv,
                          const float* __restrict__ mask,
                          __nv_bfloat16* __restrict__ out, int L, int E, int H,
                          float scale) {
  constexpr int LP = 8 * NT;
  using Lay = TcLayout<D, LP>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* k_s = q_s + LP * Lay::ds;
  __nv_bfloat16* vt_s = k_s + LP * Lay::ds;

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const long long row_stride = 3LL * E;
  const __nv_bfloat16* base = qkv + (long long)b * L * row_stride + h * D;
  constexpr int kVecPerRow = D / 8;  // 16-byte vectors of 8 bf16
  for (int idx = threadIdx.x; idx < LP * kVecPerRow; idx += blockDim.x) {
    const int j = idx / kVecPerRow, c8 = 8 * (idx % kVecPerRow);
    uint4 q = make_uint4(0, 0, 0, 0), k = q, v = q;
    if (j < L) {  // rows past L are zeros: padded keys get weight 0
      const __nv_bfloat16* row = base + j * row_stride + c8;
      q = *reinterpret_cast<const uint4*>(row);
      k = *reinterpret_cast<const uint4*>(row + E);
      v = *reinterpret_cast<const uint4*>(row + 2 * E);
    }
    *reinterpret_cast<uint4*>(q_s + j * Lay::ds + c8) = q;
    *reinterpret_cast<uint4*>(k_s + j * Lay::ds + c8) = k;
    const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
    for (int e = 0; e < 8; ++e) vt_s[(c8 + e) * Lay::vs + j] = ve[e];
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c = lane % 4;
  const int n_tiles = (L + 15) / 16, n_warps = blockDim.x / 32;
  __nv_bfloat16* out_b = out + (long long)b * L * E + h * D;

  for (int rt = warp; rt < n_tiles; rt += n_warps) {
    const int r0 = rt * 16 + g, r1 = r0 + 8;  // this lane's two query rows
    const __nv_bfloat16* q0 = q_s + r0 * Lay::ds + 2 * c;
    const __nv_bfloat16* q1 = q_s + r1 * Lay::ds + 2 * c;

    // S = Q K^T, tile nt holding keys 8 nt .. 8 nt + 7
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const __nv_bfloat16* kr = k_s + (nt * 8 + g) * Lay::ds + 2 * c;
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
        mma_16816(s[nt], ld32(q0 + 16 * ks), ld32(q1 + 16 * ks),
                  ld32(q0 + 16 * ks + 8), ld32(q1 + 16 * ks + 8),
                  ld32(kr + 16 * ks), ld32(kr + 16 * ks + 8));
    }

    // scale, mask, fp32 softmax over each row; a row's 8 NT values sit in
    // the 4 lanes of one quad
    float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
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
    for (int nt = 0; nt < NT; ++nt) {
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
    // normalised weights rounded to bf16: p[nt][0] row r0, p[nt][1] row r1
    uint32_t p[NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      p[nt][0] = pack_bf16(s[nt][0] / sum0, s[nt][1] / sum0);
      p[nt][1] = pack_bf16(s[nt][2] / sum1, s[nt][3] / sum1);
    }

    // O = P V: the score tiles 2 kt, 2 kt + 1 are the A fragment of key
    // step kt as they stand; B comes from the transposed V_h
    float o_acc[D / 8][4];
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) o_acc[dt][0] = o_acc[dt][1] = o_acc[dt][2] = o_acc[dt][3] = 0.f;
#pragma unroll
    for (int kt = 0; kt < NT / 2; ++kt) {
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        const __nv_bfloat16* vr = vt_s + (dt * 8 + g) * Lay::vs + kt * 16 + 2 * c;
        mma_16816(o_acc[dt], p[2 * kt][0], p[2 * kt][1], p[2 * kt + 1][0],
                  p[2 * kt + 1][1], ld32(vr), ld32(vr + 8));
      }
    }

#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      if (r0 < L)
        *reinterpret_cast<uint32_t*>(out_b + (long long)r0 * E + dt * 8 + 2 * c) =
            pack_bf16(o_acc[dt][0], o_acc[dt][1]);
      if (r1 < L)
        *reinterpret_cast<uint32_t*>(out_b + (long long)r1 * E + dt * 8 + 2 * c) =
            pack_bf16(o_acc[dt][2], o_acc[dt][3]);
    }
  }
}

template <int D, int NT>
cudaError_t launch_bf16_nt(const void* qkv, const float* mask, void* out, int B,
                           int L, int E, int H, cudaStream_t stream) {
  auto kernel = attention_fwd_bf16_kernel<D, NT>;
  const size_t smem = TcLayout<D, 8 * NT>::bytes;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int n_tiles = (L + 15) / 16;
  const int warps = n_tiles < kTcMaxWarps ? n_tiles : kTcMaxWarps;
  const float scale = 1.0f / sqrtf((float)D);
  kernel<<<B * H, warps * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(qkv), mask,
      static_cast<__nv_bfloat16*>(out), L, E, H, scale);
  return cudaGetLastError();
}

// the padded lengths of the shapes the towers use: 50 -> 64, 77 -> 80,
// 197 -> 208
template <int D>
cudaError_t launch_bf16(const void* qkv, const float* mask, void* out, int B,
                        int L, int E, int H, cudaStream_t stream) {
  if (L <= 64) return launch_bf16_nt<D, 8>(qkv, mask, out, B, L, E, H, stream);
  if (L <= 80) return launch_bf16_nt<D, 10>(qkv, mask, out, B, L, E, H, stream);
  if (L <= 128) return launch_bf16_nt<D, 16>(qkv, mask, out, B, L, E, H, stream);
  if (L <= 208) return launch_bf16_nt<D, 26>(qkv, mask, out, B, L, E, H, stream);
  return launch_bf16_nt<D, 32>(qkv, mask, out, B, L, E, H, stream);
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
  return bf16 ? launch_bf16<64>(qkv, mask, out, B, L, E, H, stream)
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
