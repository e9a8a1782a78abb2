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
// The device code K5 shares with the tuning kernels E1 and E2
// (halfblock_tuning.cu) lives in halfblock.cuh: the GEMMs, LayerNorm, the
// per-head attention and K5's body over a group of samples.
//
// Later work: wgmma with TMA-fed rings, h kept in distributed shared memory
// of a cluster instead of the workspace, and more rows per block for K6.

#include "halfblock.cuh"

namespace {

constexpr int kF = 4 * kE;         // MLP hidden width
constexpr int kMlpRows = 32;       // token rows per K6 tile
constexpr int kFChunk = 128;       // hidden columns per K6 chunk

// ---------------------------------------------------------------------------
// K5 (its body, attention_halfblock_rows, is in halfblock.cuh)
// ---------------------------------------------------------------------------

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

  for (int b0 = blockIdx.x * S; b0 < B; b0 += gridDim.x * S) {
    const int rows = min(S, B - b0) * L;  // the group's tokens, contiguous
    const size_t off = (size_t)b0 * L * kE;
    attention_halfblock_rows<T, A, kBase>(x + off, ln_w, ln_b, w_in, b_in, w_out, b_out, mask,
                                          out + off, h, ctx, qkv, rows, L, eps, smem_raw);
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
