// Grouped GEMM of exact top-k MoE serving, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the reference computes this product with XLA's
// `lax.ragged_dot` (deepspeed_tpu/models/transformer.py `_moe_inference`,
// the three expert products of a swiglu layer), outside any Pallas kernel.
// It is written by hand because every PyTorch form fails on the serving
// path: a loop over experts reads the group sizes on the host (which a
// captured decode group may not do), a padded dense form multiplies E/k
// times the work, and `torch._grouped_mm` is a private library call.
//
//   out [M, N] f32: rows [off[g], off[g+1]) of x [M, K] times w[g] [K, N]
//
// x holds the token-expert assignments sorted by group (bf16 or f32), w the
// experts' stacked weights [G, K, N] in the stored layout (no transposed
// copy), off [G+1] int32 lives on the device and is read only here: the
// grid is fixed by the host-known M, G and N, so nothing is read back.
// Rows outside [off[0], off[G]) are left as the caller set them (the
// wrapper zeroes the output).
//
// Tiles: a CTA owns one (group, row tile, 64-column tile).  blockIdx.x
// walks the column tiles; blockIdx.y is a row-tile slot j < ceil(M / BM) +
// G (a bound on sum_g ceil(rows_g / BM)), and each CTA finds its group and
// row tile by walking the groups' tile counts in `off`.  Slots past the
// last tile exit at once, so an empty group costs nothing.  Partial tiles
// are masked: rows past the group's end and columns past N load zeros and
// are not written.  Every output element is one CTA's sum over K in a fixed
// order, with no atomics, so a rerun is bit-identical.
//
// moe_grouped_mma (bf16): four warps over a BM x 64 output tile (BM 16 for
// the decode shapes, where a group holds a few rows, 64 for prefill), K
// streamed through shared memory in 32-row stages, STAGES in flight with
// cp.async (16-byte copies where K and N are multiples of 8 and the bases
// 16-byte aligned, element copies otherwise), mma.sync m16n8k16 with f32
// accumulation: exact bf16 products summed in f32.  The stage loop is the
// tile GEMM's (tile_matmul.cu, `tile_matmul_mma`), with one change: each
// 32-row stage is summed on the tensor cores into zeroed registers and
// then added to the running sum with f32 adds.  A chain of mma.sync
// accumulations over K 14336 (Mixtral's down product) measured 1.6e-5
// max|plain| on the H100 against the plain f32 product, 3.6x the CUDA-core
// kernel's error, near the 2e-5 limit; the two-level sum keeps the tensor
// cores' share of the rounding to 32-term sums.
//
// moe_grouped_f32 (f32): 256 threads over a 32 x 64 tile, each thread 2 x
// 4 outputs, f32 FMAs on the CUDA cores.
//
// What bounds it on the H100: bytes at decode (a few rows a group: every
// expert a token picked is read once, 2 bytes a weight for BM operations
// at most), operations at prefill.  This is the simple kernel: no TMA, no
// wgmma, no split of K, so a decode product with few groups leaves SMs
// without enough bytes in flight; PERF.md holds its time beside its bound.
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

using dstt::cp_async16;
using dstt::cp_async_commit;
using dstt::cp_async_wait;

// Row-tile slot j -> (group g, rows [r0, r1)) of its tile, or false when
// j is past the last tile.  Offsets are clamped into [0, M] and made
// nondecreasing, so no row outside x or out is ever touched.
__device__ __forceinline__ bool find_tile(const int* __restrict__ off,
                                          int G, int M, int BM, long j,
                                          int& g_out, int& r0, int& r1) {
  int prev = min(max(__ldg(off), 0), M);
  for (int g = 0; g < G; ++g) {
    const int s = prev;
    const int e = min(max(__ldg(off + g + 1), s), M);
    prev = e;
    const long n = (e - s + BM - 1) / BM;
    if (j < n) {
      g_out = g;
      r0 = s + (int)j * BM;
      r1 = e;
      return true;
    }
    j -= n;
  }
  return false;
}

// One stage: x rows [m0, min(m0+BM, m1)) x K [k0, k0+KT) into As, w K rows
// [k0, k0+KT) x columns [n0, n0+BN) into Bs, zeros past each edge.
template <int BM, bool VEC>
__device__ __forceinline__ void load_stage(bf16* As, bf16* Bs,
                                           const bf16* __restrict__ x,
                                           const bf16* __restrict__ w,
                                           int m1, int K, int N, int m0,
                                           int n0, int k0, int tid) {
  if (VEC) {
    for (int c = tid; c < BM * (KT / 8); c += THREADS) {
      const int r = c / (KT / 8), kc = (c % (KT / 8)) * 8;
      const bool ok = m0 + r < m1 && k0 + kc < K;
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
      As[r * LDA + kk] = (m0 + r < m1 && k0 + kk < K)
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
moe_grouped_mma(const bf16* __restrict__ x, const bf16* __restrict__ w,
            const int* __restrict__ off, float* __restrict__ out, int M,
            int K, int N, int G, long slots) {
  constexpr int WM = BM / 16;          // warps along M (1 or 4)
  constexpr int WN = 4 / WM;           // warps along N (4 or 1)
  constexpr int WCOLS = BN / WN;       // columns per warp (16 or 64)
  constexpr int NT = WCOLS / 8;        // n8 tiles per warp (2 or 8)
  constexpr int STAGE = stage_elems<BM>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g8 = lane >> 2, t = lane & 3;
  const int wm = warp % WM, wn = warp / WM;
  const int n0 = blockIdx.x * BN;
  const int nk = (K + KT - 1) / KT;

  for (long j = blockIdx.y; j < slots; j += gridDim.y) {
    int grp, m0, m1;
    if (!find_tile(off, G, M, BM, j, grp, m0, m1)) return;
    const bf16* wg = w + (long)grp * K * N;
    float acc[NT][4];
#pragma unroll
    for (int q = 0; q < NT; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[q][e] = 0.f;

    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < nk) {
        bf16* As = smem + s * STAGE;
        load_stage<BM, VEC>(As, As + BM * LDA, x, wg, m1, K, N, m0, n0,
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
        load_stage<BM, VEC>(As, As + BM * LDA, x, wg, m1, K, N, m0, n0,
                            pf * KT, tid);
      }
      cp_async_commit();

      const bf16* As = smem + (kt % STAGES) * STAGE;
      const bf16* Bs = As + BM * LDA;
      // this stage's products on the tensor cores, then added to the
      // running sum on the CUDA cores (see the header)
      float part[NT][4];
#pragma unroll
      for (int q = 0; q < NT; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[q][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk) {
        uint32_t a[4];
        const bf16* ar = As + (wm * 16 + g8) * LDA + kk * 16 + 2 * t;
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
          dstt::mma_bf16(part[2 * n], a, b[0], b[1]);
          dstt::mma_bf16(part[2 * n + 1], a, b[2], b[3]);
        }
      }
#pragma unroll
      for (int q = 0; q < NT; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[q][e] += part[q][e];
    }
    cp_async_wait<0>();
    // the next tile's prologue overwrites stages others may still read
    __syncthreads();

    // acc[q][0..1]: row g8, columns 8q + 2t, +1; acc[q][2..3]: row g8 + 8
#pragma unroll
    for (int q = 0; q < NT; ++q) {
      const int col = n0 + wn * WCOLS + q * 8 + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm * 16 + g8 + 8 * h;
        if (row >= m1) continue;
        float* o = out + (long)row * N + col;
        if (col < N) o[0] = acc[q][2 * h];
        if (col + 1 < N) o[1] = acc[q][2 * h + 1];
      }
    }
  }
}

__global__ void __launch_bounds__(F_THREADS)
moe_grouped_f32(const float* __restrict__ x, const float* __restrict__ w,
            const int* __restrict__ off, float* __restrict__ out, int M,
            int K, int N, int G, long slots) {
  __shared__ float As[FBM][FKT + 1];
  __shared__ float Bs[FKT][BN];
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int n0 = blockIdx.x * BN;
  for (long j = blockIdx.y; j < slots; j += gridDim.y) {
    int grp, m0, m1;
    if (!find_tile(off, G, M, FBM, j, grp, m0, m1)) return;
    const float* wg = w + (long)grp * K * N;
    // thread (ty, tx): rows ty and ty + 16, columns tx + 16 c
    float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    for (int k0 = 0; k0 < K; k0 += FKT) {
      for (int c = tid; c < FBM * FKT; c += F_THREADS) {
        const int r = c / FKT, kk = c % FKT;
        As[r][kk] = (m0 + r < m1 && k0 + kk < K)
                        ? x[(long)(m0 + r) * K + k0 + kk]
                        : 0.f;
      }
      for (int c = tid; c < FKT * BN; c += F_THREADS) {
        const int r = c / BN, nn = c % BN;
        Bs[r][nn] = (k0 + r < K && n0 + nn < N)
                        ? wg[(long)(k0 + r) * N + n0 + nn]
                        : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < FKT; ++kk) {
        const float a0 = As[ty][kk], a1 = As[ty + 16][kk];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float b = Bs[kk][tx + 16 * c];
          acc[0][c] = fmaf(a0, b, acc[0][c]);
          acc[1][c] = fmaf(a1, b, acc[1][c]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = m0 + ty + 16 * i;
      if (row >= m1) continue;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = n0 + tx + 16 * c;
        if (col < N) out[(long)row * N + col] = acc[i][c];
      }
    }
  }
}

unsigned grid_y(long slots) {
  return (unsigned)(slots < MAX_GRID_Y ? slots : MAX_GRID_Y);
}

template <int BM, bool VEC>
int launch_mma(const void* x, const void* w, const void* off, void* out,
               int M, int K, int N, int G, cudaStream_t st) {
  const long slots = (M + BM - 1) / BM + (long)G;
  const int smem = STAGES * stage_elems<BM>() * (int)sizeof(bf16);
  const dim3 grid((unsigned)((N + BN - 1) / BN), grid_y(slots));
  moe_grouped_mma<BM, VEC><<<grid, THREADS, smem, st>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<const int*>(off), static_cast<float*>(out), M, K, N, G,
      slots);
  return (int)cudaGetLastError();
}

}  // namespace

// out [M, N] f32 = x [M, K] @ w[g] [K, N] on rows [off[g], off[g+1]) of
// each group g < G; x, w, out row-major and contiguous, off
// [G+1] int32 on the device (nondecreasing, from 0 to M for a full cover).
// dtype: 0 = float32, 1 = bfloat16 (x and w alike).  bm: the bf16 row tile,
// 16 or 64.  vec: 1 when K and N are multiples of 8 and x and w start on
// 16-byte boundaries.  Returns cudaGetLastError() after the launch.
extern "C" int dstt_moe_grouped(const void* x, const void* w,
                                const void* off, void* out, int M, int K,
                                int N, int G, int dtype, int bm, int vec,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0 || K < 0 || G <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == 1) {
    if (bm == 16)
      return vec ? launch_mma<16, true>(x, w, off, out, M, K, N, G, st)
                 : launch_mma<16, false>(x, w, off, out, M, K, N, G, st);
    if (bm == 64)
      return vec ? launch_mma<64, true>(x, w, off, out, M, K, N, G, st)
                 : launch_mma<64, false>(x, w, off, out, M, K, N, G, st);
    return (int)cudaErrorInvalidValue;
  }
  if (dtype == 0) {
    const long slots = (M + FBM - 1) / FBM + (long)G;
    const dim3 grid((unsigned)((N + BN - 1) / BN), grid_y(slots));
    moe_grouped_f32<<<grid, F_THREADS, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<const int*>(off), static_cast<float*>(out), M, K, N, G,
        slots);
    return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidValue;
}
