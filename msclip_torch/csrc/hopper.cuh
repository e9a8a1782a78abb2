// Hopper (sm_90a) building blocks shared by the attention forward (K1,
// attention_fwd.cu), the attention backward (K2, attention_bwd.cu) and the
// fused attention half-block (K5 and E1, halfblock.cuh), as raw PTX. Each
// source includes it into its own anonymous namespace, so nothing here is
// exported.
//
// What lives here: asynchronous copies (cp.async with zero fill, the proxy
// fence that hands their data to wgmma), mbarriers and TMA loads of
// tensor-map tiles (K5), the 128-byte swizzle of a tile of
// 64 bf16 columns, wgmma shared-memory descriptors, the two warpgroup
// products K1 runs (m64n16k16 and m64n64k16, A from registers) and the one
// K5 runs (m64n192k16, both operands from shared memory), ldmatrix
// (plain and transposed) and the bf16 mma.sync product K2 runs, and the
// softmax's pieces: quad reductions, and the division by the row sum as the
// IEEE division rounds it, without its slow-path call.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <cstdint>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// asynchronous copies
// ---------------------------------------------------------------------------

// 16 bytes global -> shared, or 16 zero bytes when !valid (src-size 0)
__device__ __forceinline__ void cp_async16(uint32_t smem, const void* gmem, bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem), "l"(gmem), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups of this thread are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// make this thread's generic-proxy writes to shared memory (cp.async,
// st.shared) visible to the async proxy that wgmma reads through; a block
// barrier after it publishes them to the other threads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// mbarriers and the tensor memory accelerator (TMA)
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// make the initialized mbarriers visible (a block barrier follows)
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// arrive, and expect `bytes` more of asynchronous copies in this phase
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `parity` has completed (a fresh barrier
// counts its phase before 0, parity 1, as completed). A wait that never
// ends traps, so that a fault shows as a launch error and not a hang.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t spins = 0;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (spins == (1u << 24)) asm volatile("trap;");
  }
}

// TMA: the box at (c0, c1) (innermost coordinate first) of the tensor map
// at `map` (a kernel parameter) to shared memory at dst, counted on bar
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const void* map, uint32_t bar, int c0,
                                            int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// order this thread's generic writes to global memory before later reads
// of it by the async proxy (TMA); a block barrier after it publishes them
__device__ __forceinline__ void fence_proxy_async_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// the 128-byte swizzle
// ---------------------------------------------------------------------------

// A tile of rows of 64 bf16 (128 bytes) stored so that 16-byte chunk c of
// row r sits at r * 128 + ((c ^ (r & 7)) * 16) from a 1024-byte aligned
// base: wgmma's 128B swizzle mode, and conflict-free for eight lanes that
// read one chunk of eight consecutive rows (ldmatrix, 16-byte loads).
__device__ __forceinline__ uint32_t sw128(int row, int chunk) {
  return (uint32_t)(row * 128 + ((chunk ^ (row & 7)) << 4));
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

// Shared-memory matrix descriptor, 128B swizzle: start address, leading and
// stride byte offsets (all >> 4) and the swizzle mode in bits 62-63.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

// B operand stored K-major (each of the N rows holds its K values, as a
// key row of K holds its head's 64 values): rows in 8-row groups 1024 bytes
// apart; the leading offset is unused within one 128-byte swizzle row. A
// step of 16 along K is +32 bytes on the start address: desc_add(d, 32).
__device__ __forceinline__ uint64_t desc_k_major(uint32_t addr) {
  return wgmma_desc(addr, 16, 1024);
}

// B operand stored N-major (each of the K rows holds its N = 64 values, as
// a key row of V holds its head's columns), read transposed: K rows in
// 8-row groups 1024 bytes apart. N = 64 is one swizzle atom, so the offset
// between atoms along N is never used; both offsets carry 1024. A step of
// 16 along K is +2048 bytes on the start address.
__device__ __forceinline__ uint64_t desc_mn_major(uint32_t addr) {
  return wgmma_desc(addr, 1024, 1024);
}

// the descriptor of the same layout `bytes` further on (a multiple of 16
// that keeps the address inside shared memory, so the 14-bit field does
// not carry)
__device__ __forceinline__ uint64_t desc_add(uint64_t desc, uint32_t bytes) {
  return desc + (bytes >> 4);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving accesses of an accumulator across the
// asynchronous products that write it
__device__ __forceinline__ void fence_operand(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}

// D(64 x 16) = A(64 x 16) B(16 x 16) (+ D if accumulate): A from
// registers (the mma.sync A fragment of each warp's 16 rows), B K-major
// through its descriptor, bf16 in, fp32 accumulators. Accumulator layout
// (warp w of the warpgroup, g = lane / 4, c = lane % 4):
// d[4j + 2i + e] = D(16 w + g + 8 i, 8 j + 2 c + e).
__device__ __forceinline__ void wgmma_m64n16k16(float* d, const uint32_t (&a)[4],
                                                uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

// D(64 x 64) = A(64 x 16) B(16 x 64) (+ D if accumulate): A from
// registers, B through its descriptor, K-major (TRANS_B 0) or N-major read
// transposed (TRANS_B 1); the same accumulator layout with j = 0..7 over
// the 32 floats at d.
template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n64k16(float* d, const uint32_t (&a)[4],
                                                uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate),
        "n"(TRANS_B));
}

// D(64 x N) += A(64 x 16) B(16 x N), both operands from shared memory,
// K-major through their descriptors (desc_k_major: rows of 64 bf16 in the
// 128-byte swizzle, 8-row groups 1024 bytes apart; a step of 16 along K is
// +32 bytes on both), bf16 in, fp32 accumulators in the layout of
// wgmma_m64n16k16 with j = 0 .. N / 8 - 1 over the N / 2 floats at d. The
// projections of the fused attention half-block (halfblock.cuh) run on
// these: A a tile of activation rows, B a tile of [out, in] weight rows.
__device__ __forceinline__ void wgmma_m64n192k16_ss(float* d, uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, "
      "%96, %97, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// ---------------------------------------------------------------------------
// ldmatrix and mma.sync
// ---------------------------------------------------------------------------

// Four 8x8 bf16 matrices; lane l gives the address of row l % 8 of matrix
// l / 8 and gets r[m] = matrix m's (l / 4, 2 (l % 4) .. +1), or with .trans
// its (2 (l % 4) .. +1, l / 4): the same column of two consecutive rows.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// D = A(16x16, row) * B(16x8, col) + D, bf16 inputs, fp32 accumulators.
// Fragments (g = lane / 4, c = lane % 4): a0 = A(g, 2c..2c+1),
// a1 = A(g+8, 2c..), a2 = A(g, 2c+8..), a3 = A(g+8, 2c+8..);
// b0 = B(2c..2c+1, g), b1 = B(2c+8.., g); d = {D(g, 2c), D(g, 2c+1),
// D(g+8, 2c), D(g+8, 2c+1)}. Each 32-bit register holds two bf16, the
// lower column (or row of B) in the low half.
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---------------------------------------------------------------------------
// softmax pieces
// ---------------------------------------------------------------------------

// reductions over the four lanes of a quad (the lanes that hold one row of
// an mma.sync or wgmma accumulator)
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// 1 / y rounded to nearest, for a softmax row sum (1 <= y <= 256): the
// hardware approximation (within about 2^-23), two Newton steps in fp64
// (within about 2^-51), then one rounding to fp32. 1 / y lies at least
// 2^-49 (relative) from every midpoint of two fp32 values, so that rounding
// is the rounding of 1 / y; no slow path. IEEE division and __frcp_rn carry
// a call to one, and one call in a function makes ptxas serialize every
// wgmma of it.
__device__ __forceinline__ float rcp_rn(float y) {
  float r0;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r0) : "f"(y));
  const double yd = y;
  double r = r0;
  r = fma(r, fma(-yd, r, 1.0), r);
  r = fma(r, fma(-yd, r, 1.0), r);
  return __double2float_rn(r);
}

// x / y rounded to nearest (IEEE division), given r = rcp_rn(y), one per
// row: q = x r, the exact residual x - q y, and q + residual r (Markstein's
// correction, which rounds the quotient when r is the rounded reciprocal);
// three instructions a weight. For normal quotients; a weight below 2^-126
// needs scores 87 apart.
__device__ __forceinline__ float div_rn(float x, float y, float r) {
  const float q = x * r;
  return fmaf(fmaf(-q, y, x), r, q);
}

// Persistent grid of a kernel launched with one of two dynamic shared-memory
// sizes (smem[0] without the mask, smem[1] with it): every call raises the
// kernel's limit on the current device to the larger (the attribute belongs
// to one device's context) and returns that device's SMs times the blocks
// that fit, or the units if fewer. The blocks an SM holds at each size are
// counted on the first call into per_sm (the caller's static state); on
// another card they only size the walk, which covers every unit whatever
// the grid.
template <typename Kernel>
cudaError_t persistent_grid(Kernel kernel, int threads, const size_t (&smem)[2], int (&per_sm)[2],
                            int which, int units, int* grid) {
  int dev, sms;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  const size_t most = smem[0] > smem[1] ? smem[0] : smem[1];
  if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)most)) != cudaSuccess)
    return err;
  if (per_sm[0] == 0) {
    int n[2];
    for (int k = 0; k < 2; ++k) {
      if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n[k], kernel, threads, smem[k])) !=
          cudaSuccess)
        return err;
      if (n[k] < 1) return cudaErrorInvalidConfiguration;
    }
    per_sm[1] = n[1];
    per_sm[0] = n[0];
  }
  *grid = units < sms * per_sm[which] ? units : sms * per_sm[which];
  return cudaSuccess;
}

}  // namespace
