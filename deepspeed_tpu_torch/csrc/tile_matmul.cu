// Tile GEMM of the fused tensor-parallel ring, for Hopper (sm_90a).
//
// Replaces the TPU kernel deepspeed_tpu/ops/tp_matmul.py `_pallas_matmul`
// (pallas_call body `_mm_kernel`):
//   out [M, N] f32 = x [M, K] @ w [K, N]
// with x and w both bf16 or both f32, and an f32 sum over K.  It is the
// per-hop GEMM of `ag_matmul` / `matmul_rs` and of the decode lm head.
//
// The TPU kernel picks its (bm, bk, bn) blocks from MXU-aligned candidates
// and refuses other shapes; here every M, K and N >= 0 is served: the
// ragged edges of M, N and K are zero-filled in shared memory and masked
// at the store.  The grid is (N tiles, M tiles) with both axes walked by
// grid-stride loops, so no shape meets the 65535 limit of the y axis.
//
// bf16 (tile_matmul_mma): one CTA = four warps over a BM x 64 output tile,
// BM = 16 when M <= 16 (the decode hops: the four warps split the 64
// columns) and 64 otherwise (one 16-row slab per warp).  K streams through
// shared memory in 32-row stages, STAGES of them in flight with cp.async
// (16-byte copies where K and N are multiples of 8 and the pointers are
// 16-byte aligned; element copies otherwise).  Products on the tensor cores
// with mma.sync m16n8k16, f32 accumulators in registers; x's A fragments
// read from its row-major tile, w's B fragments with ldmatrix.trans from
// its row-major [k][n] tile (the flash kernels' P.V layout, attn_tile.cuh).
//
// f32 (tile_matmul_f32): one CTA = 256 threads over a 32 x 64 tile, each
// thread 2 x 4 outputs, exact f32 FMAs on the CUDA cores.
//
// Each output element is summed over K in one thread in a fixed order (no
// split-K, no atomics), so a rerun is bit-identical.
//
// What bounds it on the H100: bytes at the decode hops.  A hop's rows are
// the decode batch over tp (2-16), so w (K x N bf16, 16.8-22.5 MB at
// Llama-2-7B's hops) is read once while the tensor cores idle: 2 M
// operations per byte of w, far below the card's ~295.  The design keeps
// every byte of w read exactly once per call (each CTA owns its columns
// for the whole of K) with several stages in flight per CTA; at a prefill
// hop (M = 64-1024) the same kernel runs on the tensor cores with
// 64-row tiles.  TMA, wgmma and split-K are left for a later change.
#include "attn_tile.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 128;      // four warps (bf16 kernel)
constexpr int BN = 64;            // output columns per tile
constexpr int KT = 32;            // K rows per stage
constexpr int STAGES = 4;         // stages in flight
constexpr int LDA = KT + 8;       // x tile row pitch (bf16), 80 bytes
constexpr int LDB = BN + 8;       // w tile row pitch (bf16), 144 bytes
constexpr int MAX_GRID_Y = 65535;

constexpr int F_THREADS = 256;    // f32 kernel
constexpr int FBM = 32;
constexpr int FKT = 32;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  // src-size 0 writes 16 zero bytes and reads nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// One stage: x rows [m0, m0+BM) x K [k0, k0+KT) into As, w K rows
// [k0, k0+KT) x columns [n0, n0+BN) into Bs, zeros past each edge.
template <int BM, bool VEC>
__device__ __forceinline__ void load_stage(bf16* As, bf16* Bs,
                                           const bf16* __restrict__ x,
                                           const bf16* __restrict__ w,
                                           int M, int K, int N, int m0,
                                           int n0, int k0, int tid) {
  if (VEC) {
    // K and N are multiples of 8: a 16-byte chunk is wholly in or out
    for (int c = tid; c < BM * (KT / 8); c += THREADS) {
      const int r = c / (KT / 8), kc = (c % (KT / 8)) * 8;
      const bool ok = m0 + r < M && k0 + kc < K;
      cp_async16(As + r * LDA + kc,
                 ok ? x + (long)(m0 + r) * K + k0 + kc : x, ok);
    }
    for (int c = tid; c < KT * (BN / 8); c += THREADS) {
      const int r = c / (BN / 8), nc = (c % (BN / 8)) * 8;
      const bool ok = k0 + r < K && n0 + nc < N;
      cp_async16(Bs + r * LDB + nc,
                 ok ? w + (long)(k0 + r) * N + n0 + nc : w, ok);
    }
  } else {
    const bf16 zero = __float2bfloat16(0.f);
    for (int c = tid; c < BM * KT; c += THREADS) {
      const int r = c / KT, kk = c % KT;
      As[r * LDA + kk] = (m0 + r < M && k0 + kk < K)
                             ? x[(long)(m0 + r) * K + k0 + kk]
                             : zero;
    }
    for (int c = tid; c < KT * BN; c += THREADS) {
      const int r = c / BN, nn = c % BN;
      Bs[r * LDB + nn] = (k0 + r < K && n0 + nn < N)
                             ? w[(long)(k0 + r) * N + n0 + nn]
                             : zero;
    }
  }
}

template <int BM>
__host__ __device__ constexpr int stage_elems() {
  return BM * LDA + KT * LDB;
}

template <int BM, bool VEC>
__global__ void __launch_bounds__(THREADS)
tile_matmul_mma(const bf16* __restrict__ x, const bf16* __restrict__ w,
                float* __restrict__ out, int M, int K, int N) {
  constexpr int WM = BM / 16;          // warps along M (1 or 4)
  constexpr int WN = 4 / WM;           // warps along N (4 or 1)
  constexpr int WCOLS = BN / WN;       // columns per warp (16 or 64)
  constexpr int NT = WCOLS / 8;        // n8 tiles per warp (2 or 8)
  constexpr int STAGE = stage_elems<BM>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp % WM, wn = warp / WM;
  const int tiles_m = (M + BM - 1) / BM, tiles_n = (N + BN - 1) / BN;
  const int nk = (K + KT - 1) / KT;

  for (int tm = blockIdx.y; tm < tiles_m; tm += gridDim.y) {
    for (int tn = blockIdx.x; tn < tiles_n; tn += gridDim.x) {
      const int m0 = tm * BM, n0 = tn * BN;
      float acc[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

      for (int s = 0; s < STAGES - 1; ++s) {
        if (s < nk) {
          bf16* As = smem + s * STAGE;
          load_stage<BM, VEC>(As, As + BM * LDA, x, w, M, K, N, m0, n0,
                              s * KT, tid);
        }
        cp_async_commit();
      }
      for (int kt = 0; kt < nk; ++kt) {
        cp_async_wait<STAGES - 2>();
        // stage kt has landed for every thread, and every thread is done
        // reading stage kt - 1, which the prefetch below overwrites
        __syncthreads();
        const int pf = kt + STAGES - 1;
        if (pf < nk) {
          bf16* As = smem + (pf % STAGES) * STAGE;
          load_stage<BM, VEC>(As, As + BM * LDA, x, w, M, K, N, m0, n0,
                              pf * KT, tid);
        }
        cp_async_commit();

        const bf16* As = smem + (kt % STAGES) * STAGE;
        const bf16* Bs = As + BM * LDA;
#pragma unroll
        for (int kk = 0; kk < KT / 16; ++kk) {
          uint32_t a[4];
          const bf16* ar = As + (wm * 16 + g) * LDA + kk * 16 + 2 * t;
          a[0] = dstt::ld_u32(ar);
          a[1] = dstt::ld_u32(ar + 8 * LDA);
          a[2] = dstt::ld_u32(ar + 8);
          a[3] = dstt::ld_u32(ar + 8 * LDA + 8);
          const bf16* br =
              Bs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDB +
              wn * WCOLS + (lane >> 4) * 8;
#pragma unroll
          for (int n = 0; n < NT / 2; ++n) {
            uint32_t b[4];
            dstt::ldmatrix_x4_trans(b, br + n * 16);
            dstt::mma_bf16(acc[2 * n], a, b[0], b[1]);
            dstt::mma_bf16(acc[2 * n + 1], a, b[2], b[3]);
          }
        }
      }
      cp_async_wait<0>();
      // the next tile's prologue overwrites stages others may still read
      __syncthreads();

      // acc[j][0..1]: row g, columns 8j + 2t, +1; acc[j][2..3]: row g + 8
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int col = n0 + wn * WCOLS + j * 8 + 2 * t;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = m0 + wm * 16 + g + 8 * h;
          if (row >= M) continue;
          float* o = out + (long)row * N + col;
          if (col < N) o[0] = acc[j][2 * h];
          if (col + 1 < N) o[1] = acc[j][2 * h + 1];
        }
      }
    }
  }
}

__global__ void __launch_bounds__(F_THREADS)
tile_matmul_f32(const float* __restrict__ x, const float* __restrict__ w,
                float* __restrict__ out, int M, int K, int N) {
  __shared__ float As[FBM][FKT + 1];
  __shared__ float Bs[FKT][BN];
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int tiles_m = (M + FBM - 1) / FBM, tiles_n = (N + BN - 1) / BN;
  for (int tm = blockIdx.y; tm < tiles_m; tm += gridDim.y) {
    for (int tn = blockIdx.x; tn < tiles_n; tn += gridDim.x) {
      const int m0 = tm * FBM, n0 = tn * BN;
      // thread (ty, tx): rows ty and ty + 16, columns tx + 16j
      float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      for (int k0 = 0; k0 < K; k0 += FKT) {
        for (int c = tid; c < FBM * FKT; c += F_THREADS) {
          const int r = c / FKT, kk = c % FKT;
          As[r][kk] = (m0 + r < M && k0 + kk < K)
                          ? x[(long)(m0 + r) * K + k0 + kk]
                          : 0.f;
        }
        for (int c = tid; c < FKT * BN; c += F_THREADS) {
          const int r = c / BN, nn = c % BN;
          Bs[r][nn] = (k0 + r < K && n0 + nn < N)
                          ? w[(long)(k0 + r) * N + n0 + nn]
                          : 0.f;
        }
        __syncthreads();
#pragma unroll 8
        for (int kk = 0; kk < FKT; ++kk) {
          const float a0 = As[ty][kk], a1 = As[ty + 16][kk];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float b = Bs[kk][tx + 16 * j];
            acc[0][j] = fmaf(a0, b, acc[0][j]);
            acc[1][j] = fmaf(a1, b, acc[1][j]);
          }
        }
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = m0 + ty + 16 * i;
        if (row >= M) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = n0 + tx + 16 * j;
          if (col < N) out[(long)row * N + col] = acc[i][j];
        }
      }
    }
  }
}

int grid_y(long tiles) {
  return (int)(tiles < MAX_GRID_Y ? tiles : MAX_GRID_Y);
}

template <int BM, bool VEC>
int launch_mma(const void* x, const void* w, void* out, int M, int K, int N,
               cudaStream_t st) {
  const long tiles_m = (M + BM - 1) / BM, tiles_n = (N + BN - 1) / BN;
  const int smem = STAGES * stage_elems<BM>() * (int)sizeof(bf16);
  tile_matmul_mma<BM, VEC><<<dim3((unsigned)tiles_n, grid_y(tiles_m)),
                             THREADS, smem, st>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<float*>(out), M, K, N);
  return (int)cudaGetLastError();
}

}  // namespace

// out [M, N] f32 = x [M, K] @ w [K, N], row-major and contiguous.  dtype:
// 0 = float32, 1 = bfloat16 (x and w alike).  vec: 1 when K and N are
// multiples of 8 and x and w start on 16-byte boundaries (16-byte copies).
// Returns cudaGetLastError() after the launch.
extern "C" int dstt_tile_matmul(const void* x, const void* w, void* out,
                                int M, int K, int N, int dtype, int vec,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0 || K < 0) return (int)cudaErrorInvalidValue;
  if (dtype == 1) {
    if (M <= 16)
      return vec ? launch_mma<16, true>(x, w, out, M, K, N, st)
                 : launch_mma<16, false>(x, w, out, M, K, N, st);
    return vec ? launch_mma<64, true>(x, w, out, M, K, N, st)
               : launch_mma<64, false>(x, w, out, M, K, N, st);
  }
  if (dtype == 0) {
    const long tiles_m = (M + FBM - 1) / FBM, tiles_n = (N + BN - 1) / BN;
    tile_matmul_f32<<<dim3((unsigned)tiles_n, grid_y(tiles_m)), F_THREADS,
                      0, st>>>(static_cast<const float*>(x),
                               static_cast<const float*>(w),
                               static_cast<float*>(out), M, K, N);
    return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidValue;
}
