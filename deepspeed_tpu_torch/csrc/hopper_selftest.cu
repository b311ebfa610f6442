// Checks of hopper_tile.cuh's building blocks one at a time, on the card
// (tests/test_torch_port_cuda.py calls them; no kernel of the port's
// paths lives here).  A wrong swizzle or descriptor gives wrong numbers,
// not a fault, so each block is held against a plain computation before
// a kernel is built on it:
//
//   dstt_selftest_tma, dstt_selftest_tma_f32: one TMA box of a bf16 or
//     f32 tensor (2-D to 4-D, any swizzle) into shared memory, copied out
//     byte for byte, so the caller can check the swizzle pattern and the
//     zero fill at the edges;
//   dstt_selftest_wgmma: one warpgroup's out [64, N] f32 = A [64, 64] @ B
//     over four k16 steps (N 16, 32, 64, 80, 96 or 128: 80 and 96 are
//     the P V products of head dims 80 and 96), A and B loaded by TMA
//     with the given swizzle, A from shared memory (K-major, or MN-major:
//     the transposed operand of a [K, M] tile) or, at N 32-128, from
//     registers, B K-major ([N, 64]) or MN-major ([64, N]);
//   dstt_selftest_bulk_rows: 1-D bulk copies (cp.async.bulk) of gathered
//     byte ranges, one per row, into shared memory at a row pitch (the
//     LoRA kernel's x rows), copied out;
//   dstt_selftest_sparse_scores: one step of the block-sparse forward's
//     score tile: Q's owned blocks and one step's gathered K blocks by
//     TMA (a -1 entry loads zeros from past S), S = Q K^T by wgmma
//     m64n64, then sparse_tile.cuh's owner mask, the 64 x 64 tile
//     copied out (masked entries NEG_INF).
#include "hopper_tile.cuh"
#include "sparse_tile.cuh"

namespace {

using bf16 = __nv_bfloat16;
namespace hp = dstt::hopper;

__global__ void tma_box_kernel(const __grid_constant__ CUtensorMap map,
                               uint8_t* __restrict__ dst, int bytes, int rank,
                               int c0, int c1, int c2, int c3) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* box = hp::align1024(smem_raw);
  __shared__ __align__(8) uint64_t bar;
  if (threadIdx.x == 0) {
    hp::mbar_init(&bar, 1);
    hp::mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    hp::mbar_expect_tx(&bar, (uint32_t)bytes);
    if (rank == 2)
      hp::tma_load_2d(box, &map, &bar, c0, c1);
    else if (rank == 3)
      hp::tma_load_3d(box, &map, &bar, c0, c1, c2);
    else
      hp::tma_load_4d(box, &map, &bar, c0, c1, c2, c3);
  }
  hp::mbar_wait(&bar, 0);
  for (int i = threadIdx.x; i < bytes; i += blockDim.x) dst[i] = box[i];
}

// Shared layout: A as 64 / CH boxes [64 rows][CH] (rows M for K-major,
// rows K for MN-major), B as boxes of R-byte rows: K-major [N rows][CH]
// per K chunk, MN-major [64 K rows][CH] per N chunk; CH = R / 2 elements
// for an R-byte swizzle.  a_mode: 0 A K-major in shared memory, 1 A from
// registers, 2 A MN-major in shared memory.
template <int N, int TB>
__global__ void __launch_bounds__(128)
wgmma_tile_kernel(const __grid_constant__ CUtensorMap amap,
                  const __grid_constant__ CUtensorMap bmap,
                  const bf16* __restrict__ a_gmem, float* __restrict__ out,
                  int swizzle, int a_mode) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* base = hp::align1024(smem_raw);
  __shared__ __align__(8) uint64_t bar;
  const hp::Swizzle sw = static_cast<hp::Swizzle>(swizzle);
  const int R = sw == hp::SW128 ? 128 : sw == hp::SW64 ? 64 : 32;
  const int CH = R / 2;
  uint8_t* As = base;                  // 64 x 64 bf16 = 8 KB
  uint8_t* Bs = base + 64 * 64 * 2;    // 64 x N bf16
  const int tid = threadIdx.x;
  if (tid == 0) {
    hp::mbar_init(&bar, 1);
    hp::mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    hp::mbar_expect_tx(&bar, (64 * 64 + 64 * N) * 2);
    for (int c = 0; c < 64 / CH; ++c)
      hp::tma_load_2d(As + c * 64 * R, &amap, &bar, c * CH, 0);
    if (TB == 0) {
      for (int c = 0; c < 64 / CH; ++c)
        hp::tma_load_2d(Bs + c * N * R, &bmap, &bar, c * CH, 0);
    } else {
      for (int c = 0; c < N / CH; ++c)
        hp::tma_load_2d(Bs + c * 64 * R, &bmap, &bar, c * CH, 0);
    }
  }
  hp::mbar_wait(&bar, 0);

  float d[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) d[i] = 0.f;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  hp::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int chunk = kk * 16 / CH, within = (kk * 16 % CH) * 2;
    uint64_t db;
    if (TB == 0)
      db = hp::smem_desc(Bs + chunk * N * R + within, sw, 16, 8 * R);
    else
      db = hp::smem_desc(Bs + kk * 16 * R, sw, 64 * R, 8 * R);
    if (a_mode == 0) {
      const uint64_t da =
          hp::smem_desc(As + chunk * 64 * R + within, sw, 16, 8 * R);
      hp::wgmma_ss<N, TB>(d, da, db, 1);
    } else if (a_mode == 2) {
      const uint64_t da = hp::smem_desc(As + kk * 16 * R, sw, 64 * R, 8 * R);
      hp::wgmma_ss<N, TB, 1>(d, da, db, 1);
    } else if constexpr (N != 16) {   // a_mode 1: no register form at N 16
      const bf16* ar = a_gmem + (16 * warp + g) * 64 + kk * 16 + 2 * t;
      uint32_t a[4];
      a[0] = *reinterpret_cast<const uint32_t*>(ar);
      a[1] = *reinterpret_cast<const uint32_t*>(ar + 8 * 64);
      a[2] = *reinterpret_cast<const uint32_t*>(ar + 8);
      a[3] = *reinterpret_cast<const uint32_t*>(ar + 8 * 64 + 8);
      hp::wgmma_rs<N, TB>(d, a, db, 1);
    }
  }
  hp::wgmma_commit();
  hp::wgmma_wait<0>();
  hp::fence_regs(d);
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = 16 * warp + g + 8 * (e / 2);
      const int col = 8 * j + 2 * t + (e % 2);
      out[row * N + col] = d[4 * j + e];
    }
  }
}

template <int N, int TB>
int launch_wgmma(const void* a, const void* b, void* out, int swizzle,
                 int a_mode, cudaStream_t st) {
  const int R = swizzle == hp::SW128 ? 128 : swizzle == hp::SW64 ? 64 : 32;
  const uint32_t CH = R / 2;
  CUtensorMap amap, bmap;
  const uint64_t adims[2] = {64, 64}, astr[1] = {64 * 2};
  const uint32_t abox[2] = {CH, 64};
  int rc = hp::make_map_bf16(&amap, a, 2, adims, astr, abox,
                             static_cast<hp::Swizzle>(swizzle));
  if (rc) return rc;
  if (TB == 0) {   // b [N, 64]
    const uint64_t dims[2] = {64, (uint64_t)N}, str[1] = {64 * 2};
    const uint32_t box[2] = {CH, (uint32_t)N};
    rc = hp::make_map_bf16(&bmap, b, 2, dims, str, box,
                           static_cast<hp::Swizzle>(swizzle));
  } else {         // b [64, N]
    const uint64_t dims[2] = {(uint64_t)N, 64}, str[1] = {(uint64_t)N * 2};
    const uint32_t box[2] = {CH, 64};
    rc = hp::make_map_bf16(&bmap, b, 2, dims, str, box,
                           static_cast<hp::Swizzle>(swizzle));
  }
  if (rc) return rc;
  const int smem = 1024 + (64 * 64 + 64 * N) * 2;
  cudaError_t e = cudaFuncSetAttribute(
      wgmma_tile_kernel<N, TB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  wgmma_tile_kernel<N, TB><<<1, 128, smem, st>>>(
      amap, bmap, static_cast<const bf16*>(a), static_cast<float*>(out),
      swizzle, a_mode);
  return (int)cudaGetLastError();
}

template <int TB>
int wgmma_by_n(int N, const void* a, const void* b, void* out, int swizzle,
               int a_mode, cudaStream_t st) {
  switch (N) {
    case 16: return launch_wgmma<16, TB>(a, b, out, swizzle, a_mode, st);
    case 32: return launch_wgmma<32, TB>(a, b, out, swizzle, a_mode, st);
    case 64: return launch_wgmma<64, TB>(a, b, out, swizzle, a_mode, st);
    case 80: return launch_wgmma<80, TB>(a, b, out, swizzle, a_mode, st);
    case 96: return launch_wgmma<96, TB>(a, b, out, swizzle, a_mode, st);
    case 128: return launch_wgmma<128, TB>(a, b, out, swizzle, a_mode, st);
  }
  return (int)cudaErrorInvalidValue;
}

// One TMA box of a contiguous bf16 (es 2) or f32 (es 4) tensor: `rank` (2
// to 4) dims innermost first, the box, the box's start coordinates (may
// run past the edges), swizzle 0-3 (none, 32, 64, 128 B).  dst gets the
// box's shared memory image, prod(box) elements.
int tma_box(const void* src, void* dst, int rank, const long long* dims,
            const int* box, const int* coords, int swizzle, int es,
            cudaStream_t stream) {
  if (rank < 2 || rank > 4) return (int)cudaErrorInvalidValue;
  uint64_t d[4], s[3];
  uint32_t b[4];
  uint64_t stride = es;
  int bytes = es;
  for (int i = 0; i < rank; ++i) {
    d[i] = (uint64_t)dims[i];
    b[i] = (uint32_t)box[i];
    bytes *= box[i];
    if (i > 0) s[i - 1] = stride;
    stride *= d[i];
  }
  CUtensorMap map;
  int rc = hp::make_map(
      &map, es == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                    : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      src, rank, d, s, b, static_cast<hp::Swizzle>(swizzle));
  if (rc) return rc;
  const int smem = 1024 + bytes;
  cudaError_t e = cudaFuncSetAttribute(
      tma_box_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  tma_box_kernel<<<1, 128, smem, stream>>>(
      map, static_cast<uint8_t*>(dst), bytes, rank, coords[0], coords[1],
      rank > 2 ? coords[2] : 0, rank > 3 ? coords[3] : 0);
  return (int)cudaGetLastError();
}


// n <= 32 ranges of `bytes` bytes at src + rows[i] * src_pitch + col0 into
// shared memory at i * dst_pitch (lane i copies range i), then to dst.
__global__ void bulk_rows_kernel(const uint8_t* __restrict__ src,
                                 uint8_t* __restrict__ dst,
                                 const int* __restrict__ rows, int n,
                                 long src_pitch, int col0, int bytes,
                                 int dst_pitch) {
  extern __shared__ __align__(128) uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bar;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    hp::mbar_init(&bar, 32);
    hp::mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    if (lane == 0) hp::mbar_expect_tx_only(&bar, (uint32_t)(n * bytes));
    __syncwarp();
    if (lane < n)
      hp::bulk_load(smem_raw + lane * dst_pitch,
                    src + rows[lane] * src_pitch + col0, bytes, &bar);
    hp::mbar_arrive(&bar);
  }
  hp::mbar_wait(&bar, 0);
  for (int i = threadIdx.x; i < n * dst_pitch; i += blockDim.x)
    dst[i] = smem_raw[i];
}

// One step of the forward's score tile at D 64: q, k [1, S, 1, 64] bf16,
// owned query blocks o0..o3 (the first 64 / BLK; -1 loads zeros), the
// step's 64 / BLK entries `ents`; out [64, 64] f32.
template <int BLK>
__global__ void __launch_bounds__(160)
sparse_scores_kernel(const __grid_constant__ CUtensorMap qmap,
                     const __grid_constant__ CUtensorMap kmap,
                     const int* __restrict__ ents, int4 own,
                     float* __restrict__ out, int S, int causal,
                     float scale_log2) {
  constexpr int G = 64 / BLK;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* Qs = hp::align1024(smem_raw);
  uint8_t* Ks = Qs + 64 * 64 * 2;
  __shared__ __align__(8) uint64_t bar;
  const int tid = threadIdx.x;
  const int owners[4] = {own.x, own.y, own.z, own.w};
  if (tid == 0) {
    hp::mbar_init(&bar, 1);
    hp::mbar_fence_init();
  }
  __syncthreads();
  if (tid == 128) {
    hp::mbar_expect_tx(&bar, 2 * 64 * 64 * 2);
    for (int r = 0; r < G; ++r)
      hp::tma_load_4d(Qs + r * BLK * 128, &qmap, &bar, 0, 0,
                      owners[r] >= 0 ? owners[r] * BLK : S, 0);
    dstt::sparse::gather_boxes<64, BLK>(Ks, &kmap, &bar, ents, 0, 0, S);
  }
  if (tid >= 128) return;
  hp::mbar_wait(&bar, 0);
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  int obit[2], qpos[2], ent[G];
  for (int hh = 0; hh < 2; ++hh) {
    const int r = 16 * warp + g + 8 * hh;
    obit[hh] = r / BLK;
    qpos[hh] = owners[r / BLK] * BLK + r % BLK;
  }
  for (int i = 0; i < G; ++i) ent[i] = ents[i];
  float sc[32];
  hp::wgmma_fence();
  hp::issue_abt<64, 64>(sc, Qs, 64, Ks);
  hp::wgmma_commit();
  hp::wgmma_wait<0>();
  hp::fence_regs(sc);
  dstt::sparse::mask_scores<BLK>(sc, ent, obit, qpos, t, causal,
                                 scale_log2);
  for (int i = 0; i < 32; ++i)
    out[(16 * warp + g + 8 * ((i >> 1) & 1)) * 64 + hp::acc_col(i, t)] =
        sc[i];
}

template <int BLK>
int launch_scores(const void* q, const void* k, const void* ents, int4 own,
                  void* out, int S, int causal, float scale_log2,
                  cudaStream_t st) {
  CUtensorMap qmap, kmap;
  const uint64_t dims[4] = {64, 1, (uint64_t)S, 1};
  const uint64_t strides[3] = {128, 128, (uint64_t)S * 128};
  const uint32_t box[4] = {64, 1, BLK, 1};
  int rc = hp::make_map_bf16(&qmap, q, 4, dims, strides, box, hp::SW128);
  if (!rc) rc = hp::make_map_bf16(&kmap, k, 4, dims, strides, box, hp::SW128);
  if (rc) return rc;
  const int smem = 1024 + 2 * 64 * 64 * 2;
  cudaError_t e = cudaFuncSetAttribute(
      sparse_scores_kernel<BLK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  sparse_scores_kernel<BLK><<<1, 160, smem, st>>>(
      qmap, kmap, static_cast<const int*>(ents), own,
      static_cast<float*>(out), S, causal, scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace

// One TMA box of a contiguous tensor (see tma_box), bf16 and f32.
extern "C" int dstt_selftest_tma(const void* src, void* dst, int rank,
                                 const long long* dims, const int* box,
                                 const int* coords, int swizzle,
                                 void* stream) {
  return tma_box(src, dst, rank, dims, box, coords, swizzle, 2,
                 static_cast<cudaStream_t>(stream));
}

extern "C" int dstt_selftest_tma_f32(const void* src, void* dst, int rank,
                                     const long long* dims, const int* box,
                                     const int* coords, int swizzle,
                                     void* stream) {
  return tma_box(src, dst, rank, dims, box, coords, swizzle, 4,
                 static_cast<cudaStream_t>(stream));
}

// out [64, N] f32 = A @ (b_mn ? b [64, N] : b [N, 64]^T), bf16 row-major
// inputs, A = a [64, 64] (a_mode 0: from shared memory, 1: from
// registers, N 32-128 only) or a^T (a_mode 2: a [K, M] read MN-major);
// N 16, 32, 64, 80, 96 or 128 (an MN-major B's N a multiple of the
// swizzle's width in elements); swizzle 1-3 (32, 64, 128 B).
extern "C" int dstt_selftest_wgmma(const void* a, const void* b, void* out,
                                   int N, int b_mn, int a_mode, int swizzle,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (swizzle < 1 || swizzle > 3 || a_mode < 0 || a_mode > 2 ||
      (N == 16 && a_mode == 1))
    return (int)cudaErrorInvalidValue;
  return b_mn ? wgmma_by_n<1>(N, a, b, out, swizzle, a_mode, st)
              : wgmma_by_n<0>(N, a, b, out, swizzle, a_mode, st);
}

// n <= 32 gathered byte ranges (see bulk_rows_kernel): rows [n] int32 on
// the card; src_pitch, col0, bytes and dst_pitch multiples of 16; dst
// gets n * dst_pitch bytes.
extern "C" int dstt_selftest_bulk_rows(const void* src, void* dst,
                                       const void* rows, int n,
                                       long long src_pitch, int col0,
                                       int bytes, int dst_pitch,
                                       void* stream) {
  if (n < 1 || n > 32 || bytes < 16 || bytes % 16 || col0 % 16 ||
      src_pitch % 16 || dst_pitch % 16 || dst_pitch < bytes)
    return (int)cudaErrorInvalidValue;
  const int smem = n * dst_pitch;
  cudaError_t e = cudaFuncSetAttribute(
      bulk_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  bulk_rows_kernel<<<1, 128, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(src), static_cast<uint8_t*>(dst),
      static_cast<const int*>(rows), n, (long)src_pitch, col0, bytes,
      dst_pitch);
  return (int)cudaGetLastError();
}

// One step of the block-sparse forward's masked score tile at D 64 (see
// sparse_scores_kernel): block 16, 32 or 64; owned o0..o3.
extern "C" int dstt_selftest_sparse_scores(const void* q, const void* k,
                                           const void* ents, int o0, int o1,
                                           int o2, int o3, void* out, int S,
                                           int block, int causal,
                                           float scale_log2, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int4 own = make_int4(o0, o1, o2, o3);
  if (S <= 0 || S % block) return (int)cudaErrorInvalidValue;
  if (block == 16)
    return launch_scores<16>(q, k, ents, own, out, S, causal, scale_log2, st);
  if (block == 32)
    return launch_scores<32>(q, k, ents, own, out, S, causal, scale_log2, st);
  if (block == 64)
    return launch_scores<64>(q, k, ents, own, out, S, causal, scale_log2, st);
  return (int)cudaErrorInvalidValue;
}
