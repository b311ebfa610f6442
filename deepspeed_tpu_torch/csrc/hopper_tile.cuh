// Hopper building blocks shared by the port's TMA + wgmma kernels
// (tile_matmul.cu, flash_fwd.cu, flash_bwd.cu, evoformer_flash.cu,
// sparse_flash.cu, paged_*.cu, and lora_delta.cu's bulk copies;
// hopper_selftest.cu checks each alone).
//
//   * 1-D bulk copies (cp.async.bulk, no tensor map) completing on an
//     mbarrier, and an expect_tx that does not arrive (a warp announces
//     the bytes, then each lane issues its copies and arrives); a load
//     with acquire semantics at device scope (a counter other CTAs
//     release into).
//   * Tensor maps (TMA descriptors), encoded on the host with the CUDA driver's
//     cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint so
//     that the libraries link no libcuda; a kernel takes a map as a
//     `__grid_constant__ const CUtensorMap` parameter.
//   * TMA tile loads (2-D, 3-D and 4-D cp.async.bulk.tensor, bf16 or f32
//     elements) into shared memory, completing on an mbarrier (init,
//     arrive.expect_tx, arrive, try_wait.parity on the phase bit of a ring
//     slot).
//   * wgmma: shared-memory matrix descriptors for the 32, 64 and 128 byte
//     swizzles that TMA writes, fence / commit / wait, and
//     wgmma.mma_async m64nNk16, bf16 in, f32 accumulators in registers,
//     A from shared memory (`wgmma_ss`, N 16, 32, 64, 80, 96, 128;
//     K-major or, TA = 1, MN-major) or from registers (`wgmma_rs`, N 32,
//     64, 80, 96, 128), B
//     K-major (TB = 0) or MN-major (TB = 1, the transpose bit that 16-bit
//     types allow).
//
// Layouts (16-bit elements).  A TMA box whose inner extent is R bytes
// (R = 32, 64 or 128, with the swizzle of the same width) lands as rows
// of R bytes, 16-byte chunk j of row r stored at chunk j ^ f(r):
// f(r) = r % 8 (128 B), (r / 2) % 4 (64 B), (r / 4) % 2 (32 B); a box
// starts on a multiple of 8 R bytes.  wgmma reads such tiles through a
// descriptor (start, LBO, SBO, layout):
//   K-major operand (the contraction dim contiguous: rows of R bytes, one
//   row per M or N index): SBO = 8 R, the step between 8-row groups; LBO
//   unused; the k16 slice kk starts 32 kk bytes into the row (within R).
//   MN-major operand (the M or N dim contiguous: one row of R bytes per
//   contraction index): SBO = 8 R, the step between groups of 8
//   contraction rows; LBO = the step between R-byte column blocks of the
//   M or N dim (a tile wider than R is stored as several boxes); the k16
//   slice kk starts 16 R kk bytes in.
// Accumulators of m64nN: thread t of the warpgroup holds, for n8 block j,
// d[4j + e] at row 16 (t / 32) + (t % 32) / 4 + 8 (e / 2), column
// 8 j + 2 (t % 4) + e % 2, the layout of mma.sync's m16n8 C fragment per
// warp.  A from registers takes the m16n8k16 A fragment of the warp's 16
// rows (so an S accumulator becomes the P operand without a shuffle).
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dstt {
namespace hopper {

// ---------------------------------------------------------------------
// host: tensor maps
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// Swizzle widths, as CUtensorMapSwizzle counts them.
enum Swizzle { SW_NONE = 0, SW32 = 1, SW64 = 2, SW128 = 3 };

// A tensor map of `rank` dims (innermost first) of bf16 or f32 elements,
// byte strides of dims 1 .. rank-1, the box in elements, zero fill past
// every edge.  Returns 0 or a CUDA error code.
inline int make_map(CUtensorMap* map, CUtensorMapDataType type,
                    const void* base, int rank, const uint64_t* dims,
                    const uint64_t* strides, const uint32_t* box,
                    Swizzle swizzle) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  cuuint64_t d[5], s[4];
  cuuint32_t b[5], e[5];
  for (int i = 0; i < rank; ++i) {
    d[i] = dims[i];
    b[i] = box[i];
    e[i] = 1;
    if (i + 1 < rank) s[i] = strides[i];
  }
  CUresult r = fn(map, type, (cuuint32_t)rank, const_cast<void*>(base), d,
                  s, b, e, CU_TENSOR_MAP_INTERLEAVE_NONE,
                  static_cast<CUtensorMapSwizzle>(swizzle),
                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

inline int make_map_bf16(CUtensorMap* map, const void* base, int rank,
                         const uint64_t* dims, const uint64_t* strides,
                         const uint32_t* box, Swizzle swizzle) {
  return make_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, base, rank, dims,
                  strides, box, swizzle);
}

// ---------------------------------------------------------------------
// device: shared memory, mbarriers, TMA
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The first 1024-byte boundary at or after p: the start of a dynamic
// shared memory buffer that holds 128-byte-swizzled boxes (allocate 1 KB
// more than the tiles need).
__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// after the inits, before any other thread uses the barriers (then a
// __syncthreads)
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival that also expects `bytes` of TMA transactions
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Wait until the phase of parity `parity` has completed.  A new barrier
// is in phase 0: waiting on parity 1 returns at once (a ring's producer
// starts its "slot is free" waits there).  A wait that has not ended
// after 2^35 clock cycles (some 17 s) traps: a ring that lost an arrival
// faults the launch instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  long long t0 = 0;
  for (int tries = 0;; ++tries) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (tries == 0) {
      t0 = clock64();
    } else if ((tries & 1023) == 0 && clock64() - t0 > (1LL << 35)) {
      __trap();
    }
  }
}

// TMA loads of one box at element coordinates (innermost first); the box
// lands at `dst` (aligned to the swizzle's 8-row repeat) and completes
// its bytes on `bar`.  Elements past the tensor's edges are zero.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// A 1-D bulk copy (cp.async.bulk, no tensor map) of `bytes` from global
// memory to shared memory, completing its bytes on `bar`: both addresses
// 16-byte aligned, `bytes` a multiple of 16.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Expect `bytes` more of transactions on `bar` without arriving (a
// producer warp announces the bytes, then its lanes issue the copies and
// arrive).
__device__ __forceinline__ void mbar_expect_tx_only(uint64_t* bar,
                                                    uint32_t bytes) {
  asm volatile(
      "mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// A load with acquire semantics at device scope (the reader's side of a
// counter that other CTAs release into).
__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

// Barrier `id` (1-15; 0 is __syncthreads) over `threads` threads, a
// multiple of 32: a sync among some warps of a warp-specialised CTA.
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Arrive at barrier `id` without waiting (a `named_sync` of the same id
// and count elsewhere completes when all `threads` have come).
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Make this thread's ordinary shared-memory writes visible to the async
// proxy (a wgmma operand written by the threads, not by TMA); then a
// barrier among the writers before the wgmma is issued.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

// ---------------------------------------------------------------------
// device: wgmma
// Shared-memory matrix descriptor of a tile written by TMA with
// `swizzle`; lbo / sbo in bytes (see the layouts above).
__device__ __forceinline__ uint64_t smem_desc(const void* p, Swizzle swizzle,
                                              uint32_t lbo, uint32_t sbo) {
  const uint64_t layout = swizzle == SW128 ? 1 : swizzle == SW64 ? 2
                          : swizzle == SW32 ? 3 : 0;
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
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

// Keep the compiler from moving reads or writes of accumulator registers
// across a wgmma fence or wait (the asm statements do not name them).
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int R>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d[64 x N] (+)= A[64 x 16] B[16 x N]: A and B by descriptor; scale_d 0
// overwrites d.  TB: 0 = B K-major, 1 = B MN-major; TA the same for A
// (1 = A MN-major: M contiguous, the transpose that 16-bit types allow).
template <int TB, int TA = 0>
__device__ __forceinline__ void wgmma_ss_n16(float (&d)[8], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}"
      ", %8, %9, p, 1, 1, %12, %11;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TB), "n"(TA));
}

template <int TB, int TA = 0>
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}"
      ", %16, %17, p, 1, 1, %20, %19;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TB), "n"(TA));
}

template <int TB>
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}"
      ", {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
        "n"(TB));
}

template <int TB, int TA = 0>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}"
      ", %32, %33, p, 1, 1, %36, %35;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TB), "n"(TA));
}

template <int TB>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}"
      ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
        "n"(TB));
}

template <int TB, int TA = 0>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
      ", %64, %65, p, 1, 1, %68, %67;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
        "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TB), "n"(TA));
}

template <int TB>
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
      ", {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
        "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
        "n"(TB));
}

// N 80 and 96: the P V products of head dims 80 and 96 (RowTile)
template <int TB, int TA = 0>
__device__ __forceinline__ void wgmma_ss_n80(float (&d)[40], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %42, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
      "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, "
      "%25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, "
      "%37, %38, %39}"
      ", %40, %41, p, 1, 1, %44, %43;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TB), "n"(TA));
}

template <int TB>
__device__ __forceinline__ void wgmma_rs_n80(float (&d)[40],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
      "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, "
      "%25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, "
      "%37, %38, %39}"
      ", {%40, %41, %42, %43}, %44, p, 1, 1, %46;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
        "n"(TB));
}

template <int TB, int TA = 0>
__device__ __forceinline__ void wgmma_ss_n96(float (&d)[48], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
      "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, "
      "%25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, "
      "%37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}"
      ", %48, %49, p, 1, 1, %52, %51;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TB), "n"(TA));
}

template <int TB>
__device__ __forceinline__ void wgmma_rs_n96(float (&d)[48],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
      "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, "
      "%25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, "
      "%37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}"
      ", {%48, %49, %50, %51}, %52, p, 1, 1, %54;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
        "n"(TB));
}

template <int N, int TB, int TA = 0>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int scale_d) {
  static_assert(N == 16 || N == 32 || N == 64 || N == 80 || N == 96 ||
                    N == 128,
                "wgmma N");
  if constexpr (N == 16) wgmma_ss_n16<TB, TA>(d, da, db, scale_d);
  if constexpr (N == 32) wgmma_ss_n32<TB, TA>(d, da, db, scale_d);
  if constexpr (N == 64) wgmma_ss_n64<TB, TA>(d, da, db, scale_d);
  if constexpr (N == 80) wgmma_ss_n80<TB, TA>(d, da, db, scale_d);
  if constexpr (N == 96) wgmma_ss_n96<TB, TA>(d, da, db, scale_d);
  if constexpr (N == 128) wgmma_ss_n128<TB, TA>(d, da, db, scale_d);
}

// The same with A from registers: the warp's m16n8k16 A fragment (rows
// 16 w + g and + 8, columns 2 t, + 1 and + 8, + 9 of the k16 slice).
template <int N, int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  static_assert(N == 32 || N == 64 || N == 80 || N == 96 || N == 128,
                "wgmma N");
  if constexpr (N == 32) wgmma_rs_n32<TB>(d, a, db, scale_d);
  if constexpr (N == 64) wgmma_rs_n64<TB>(d, a, db, scale_d);
  if constexpr (N == 80) wgmma_rs_n80<TB>(d, a, db, scale_d);
  if constexpr (N == 96) wgmma_rs_n96<TB>(d, a, db, scale_d);
  if constexpr (N == 128) wgmma_rs_n128<TB>(d, a, db, scale_d);
}

// ---------------------------------------------------------------------
// attention tiles of D bf16 columns
// Rows of D bf16 as TMA boxes of CH columns, NCH boxes a row, RB bytes a
// box row, every box with the swizzle of its width: the widest of 64
// (128-byte swizzle), 32 (64-byte) and 16 columns (32-byte) that divides
// D.  So D 64 and 128 take 64-column boxes, D 32 one 32-column box, D 96
// three 32-column boxes and D 80 five 16-column boxes: one swizzle a
// tile, and the same descriptors (a K-major k16 slice at 32 kk bytes into
// its box; an MN-major N dim in CH-column blocks LBO apart, so wgmma's N
// = D is 5 or 3 such blocks).  Padding D 80 / 96 to 128 columns would
// cost 1.6x / 1.33x the shared memory and tensor-core work; narrower
// boxes cost more TMA issues and a narrower swizzle.
template <int D>
struct RowTile {
  static_assert(D == 32 || D == 64 || D == 80 || D == 96 || D == 128,
                "head dim");
  static constexpr int CH = D % 64 == 0 ? 64 : D % 32 == 0 ? 32 : 16;
  static constexpr int NCH = D / CH;
  static constexpr int RB = CH * 2;
  static constexpr Swizzle SW = RB == 128 ? SW128 : RB == 64 ? SW64 : SW32;
  // the swizzle's row pattern (the layouts at the top): 16-byte chunk j
  // of box row r is stored at chunk j ^ row_xor(r)
  __host__ __device__ static constexpr int row_xor(int r) {
    return RB == 128 ? (r & 7) : RB == 64 ? ((r >> 1) & 3) : ((r >> 2) & 1);
  }
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// acc [64 x N] = A [64 x D] B [N x D]^T for one warpgroup, both operands
// K-major in D-column boxes: A's rows start at `a` in boxes of `a_rows`
// rows, B's N rows fill boxes of N rows at `b`.
template <int D, int N>
__device__ __forceinline__ void issue_abt(float (&acc)[N / 2],
                                          const uint8_t* a, int a_rows,
                                          const uint8_t* b) {
  using T = RowTile<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int ch = kk * 16 / T::CH, within = (kk * 16 % T::CH) * 2;
    const uint64_t da = smem_desc(a + ch * a_rows * T::RB + within, T::SW,
                                  16, 8 * T::RB);
    const uint64_t db = smem_desc(b + ch * N * T::RB + within, T::SW, 16,
                                  8 * T::RB);
    wgmma_ss<N, 0>(acc, da, db, kk > 0);
  }
}

// acc [64 x D] += A [64 x 64] B [64 x D]: A from registers (the bf16
// fragments of four k16 slices), B MN-major in D-column boxes of 64 rows
// (the contraction index) at `b`.
template <int D>
__device__ __forceinline__ void issue_rs(float (&acc)[D / 2],
                                         const uint32_t (&a)[4][4],
                                         const uint8_t* b) {
  using T = RowTile<D>;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t db = smem_desc(b + kk * 16 * T::RB, T::SW, 64 * T::RB,
                                  8 * T::RB);
    wgmma_rs<D, 1>(acc, a[kk], db, 1);
  }
}

// Byte offset at which a tile of R-byte rows written with the R-byte
// swizzle (R = 32, 64, 128; base aligned to 8 R) keeps logical byte
// offset `off`: 16-byte chunk bits 4.. XOR row-group bits 7.. (the
// layouts above), for tiles that threads write as wgmma operands.
template <Swizzle SWZ>
__device__ __forceinline__ uint32_t swizzled(uint32_t off) {
  constexpr uint32_t mask = SWZ == SW128 ? 7 : SWZ == SW64 ? 3 : 1;
  return off ^ (((off >> 7) & mask) << 4);
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A [64 x 64] f32 accumulator as the bf16 A fragments of four k16 slices.
__device__ __forceinline__ void pack_frags(uint32_t (&a)[4][4],
                                           const float (&s)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = pack_bf16x2(s[8 * kk], s[8 * kk + 1]);
    a[kk][1] = pack_bf16x2(s[8 * kk + 2], s[8 * kk + 3]);
    a[kk][2] = pack_bf16x2(s[8 * kk + 4], s[8 * kk + 5]);
    a[kk][3] = pack_bf16x2(s[8 * kk + 6], s[8 * kk + 7]);
    fence_regs(a[kk]);
  }
}

// Accumulator element i of m64n64 for thread (warp w, g, t): row
// 16 w + g + 8 (i % 4 / 2), column 8 (i / 4) + 2 t + i % 2.
__device__ __forceinline__ int acc_col(int i, int t) {
  return 8 * (i >> 2) + 2 * t + (i & 1);
}

}  // namespace hopper
}  // namespace dstt
