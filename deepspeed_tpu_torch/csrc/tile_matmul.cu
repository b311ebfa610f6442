// Tile GEMM of the fused tensor-parallel ring, for Hopper (sm_90a).
//
// Replaces the TPU kernel deepspeed_tpu/ops/tp_matmul.py `_pallas_matmul`
// (pallas_call body `_mm_kernel`):
//   out [M, N] f32 = x [M, K] @ w [K, N]
// with x and w both bf16 or both f32, and an f32 sum over K.  It is the
// per-hop GEMM of `ag_matmul` / `matmul_rs` and of the decode lm head.
// The TPU kernel picks its (bm, bk, bn) blocks from MXU-aligned candidates
// and refuses other shapes; here every M, K and N >= 0 is served.
//
// Four kernels; the host plan `ops/tp_matmul.py:tile_plan` picks one per
// shape (a documented dispatch: each has its own launch count) and the
// split count.  Every output element is summed over K in a fixed order
// (K tiles in order inside a split, splits 0..s-1 in order after), with
// no float atomics, so a rerun is bit-identical.
//
// What bounds it on the H100: bytes at the decode hops (M = 2-16 rows,
// the decode batch over tp): w (K x N bf16, 16.8-22.5 MB at Llama-2-7B's
// hops) is read once while the tensor cores idle, 2 M operations per
// byte against the card's ~295.  At the prefill hops (M 64-1024) w is
// still the larger operand up to M ~ 300; beyond, the tensor cores.
//
// tile_matmul_stream (bf16, M <= 16, TMA-able: the decode hops):
// split-K.  A CTA owns 128 output columns and one K range (the plan
// makes column tiles x splits >= 2 x 132 CTAs, so some 4-8 MB of w are
// in flight on the card, the Little's-law need of 3.35 TB/s at ~1 us).
// One producer thread streams the range's w tiles (64 K rows x 128
// columns, two 128-byte-swizzled TMA boxes, 16 KB) through a 4-slot
// mbarrier ring; four consumer warps wait on a slot's barrier, run
// mma.sync m16n8k16 (ldmatrix.trans on the swizzled tile) and free the
// slot; no CTA-wide barrier per slot.  x's K slice (M rows) is staged
// once.  f32 partials go to a [splits, M, N] workspace; the CTA that
// takes the last ticket of its column tile (an integer atomic, reset by
// that CTA) sums splits 0..s-1 in order into out.
//
// tile_matmul_wgmma (bf16, M > 16, TMA-able: the prefill hops): a
// 128 x 128 output tile per CTA, one producer warp (TMA: x as a K-major A box
// [128 rows][64 k], w as two MN-major B boxes [64 k][64 n], 128-byte
// swizzle, 32 KB a slot, 6 slots) and two consumer warpgroups, each
// wgmma m64n128k16 on 64 rows (B through the transpose bit) with one
// slot's products left in flight while the next slot's issue.  Where
// the output tiles would leave most SMs idle (M 128-256 at these N) the
// plan splits K as above, through the same ticketed fixed-order sum.
//
// tile_matmul_mma (bf16 shapes TMA cannot take: K or N not a multiple
// of 8, a pointer off the 16-byte boundary, K = 0): one CTA = four warps
// over a BM x 64 output tile (BM 16 or 64), K streamed through shared
// memory in 32-row stages, STAGES in flight with cp.async (16-byte
// copies where allowed, element copies otherwise), mma.sync m16n8k16.
// The grid is (N tiles, M tiles) walked by grid-stride loops, so no
// shape meets the 65535 limit of the y axis.
//
// tile_matmul_f32 (f32): one CTA = 256 threads over a 32 x 64 tile, each
// thread 2 x 4 outputs, exact f32 FMAs on the CUDA cores.
#include "attn_tile.cuh"
#include "hopper_tile.cuh"
#include "split_k.cuh"

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

// ---------------------------------------------------------------------
// TMA variants (bf16, K and N multiples of 8, 16-byte aligned bases)
namespace hp = dstt::hopper;
using dstt::split_range;
using dstt::sum_partials;

constexpr int SPLIT_KT = 64;          // K rows per ring slot (both)

// Split-K, first half: store this CTA's f32 accumulators (NJ n8 blocks
// acc[j][0..3] at rows r0 and r0 + 8, columns col0 + 8 j (+ 2 t, + 1))
// to out (one split) or to its partial ws[split]; with several splits,
// take a ticket of the output tile and return whether this CTA took the
// last one (then it sums the partials).  `bar_id`/`threads` name the
// consumers' barrier.
template <int NJ>
__device__ __forceinline__ bool store_partial(
    const float (*acc)[4], float* __restrict__ out, float* __restrict__ ws,
    int* __restrict__ ticket, int* last, int M, int N, int r0, int col0,
    int split, int splits, int bar_id, int threads, bool leader) {
  float* dst = splits == 1 ? out : ws + (long)split * M * N;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + 8 * h, col = col0 + 8 * j;
      if (row < M && col < N)
        *reinterpret_cast<float2*>(dst + (long)row * N + col) =
            make_float2(acc[j][2 * h], acc[j][2 * h + 1]);
    }
  }
  return splits > 1 &&
         dstt::take_ticket(ticket, last, splits, bar_id, threads, leader);
}

// ---- tile_matmul_stream: split-K stream for M <= 16 ---------------
constexpr int ST_BN = 128;                     // columns per CTA
constexpr int ST_BOX = SPLIT_KT * 64 * 2;      // one [64 k][64 n] box, 8 KB
constexpr int ST_SLOT = 2 * ST_BOX;            // 16 KB
constexpr int ST_STAGES = 4;
constexpr int ST_THREADS = 160;                // 4 consumer warps + producer

// three CTAs an SM (ptxas keeps the registers at 128), so the plan's
// 2-3 x 132 CTAs run in one wave
__global__ void __launch_bounds__(ST_THREADS, 3)
tile_matmul_stream(const __grid_constant__ CUtensorMap wmap,
            const bf16* __restrict__ x, float* __restrict__ out,
            float* __restrict__ ws, int* __restrict__ tickets, int M, int K,
            int N, int splits, int ldx) {
  extern __shared__ __align__(1024) uint8_t smem_tma[];
  uint8_t* ring = hp::align1024(smem_tma);
  bf16* xs = reinterpret_cast<bf16*>(ring + ST_STAGES * ST_SLOT);
  __shared__ __align__(8) uint64_t full[ST_STAGES], empty[ST_STAGES];
  __shared__ int last;
  const int tn = blockIdx.x, split = blockIdx.y;
  const int nkt = (K + SPLIT_KT - 1) / SPLIT_KT;
  int t0, t1;
  split_range(split, splits, nkt, t0, t1);
  const int nk = t1 - t0, k0 = t0 * SPLIT_KT, n0 = tn * ST_BN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    for (int s = 0; s < ST_STAGES; ++s) {
      hp::mbar_init(&full[s], 1);
      hp::mbar_init(&empty[s], 4);
    }
    hp::mbar_fence_init();
  }
  __syncthreads();

  if (warp == 4) {   // producer: one thread keeps the ring full
    if (lane == 0) {
      for (int i = 0; i < nk; ++i) {
        const int s = i % ST_STAGES;
        hp::mbar_wait(&empty[s], ((i / ST_STAGES) & 1) ^ 1);
        hp::mbar_expect_tx(&full[s], ST_SLOT);
        uint8_t* slot = ring + s * ST_SLOT;
        const int kr = k0 + i * SPLIT_KT;
        hp::tma_load_2d(slot, &wmap, &full[s], n0, kr);
        hp::tma_load_2d(slot + ST_BOX, &wmap, &full[s], n0 + 64, kr);
      }
    }
    return;
  }

  // consumers: stage x[:, k0 : k0 + nk*KT] once (zeros past K; K % 8 == 0
  // so a 16-byte chunk is wholly in or out)
  const int kl = nk * SPLIT_KT, cpr = kl / 8;
  for (int c = tid; c < M * cpr; c += 128) {
    const int r = c / cpr, kc = (c % cpr) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (k0 + kc < K)
      v = *reinterpret_cast<const uint4*>(x + (long)r * K + k0 + kc);
    *reinterpret_cast<uint4*>(xs + r * ldx + kc) = v;
  }
  hp::named_sync(1, 128);

  const int g = lane >> 2, t = lane & 3;
  const int cbase = 4 * (warp & 1);   // first 16-byte chunk in the box
  float acc[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  const bool lo = g < M, hi = g + 8 < M;
  for (int i = 0; i < nk; ++i) {
    const int s = i % ST_STAGES;
    hp::mbar_wait(&full[s], (i / ST_STAGES) & 1);
    const uint8_t* tile = ring + s * ST_SLOT + (warp >> 1) * ST_BOX;
#pragma unroll
    for (int kk = 0; kk < SPLIT_KT / 16; ++kk) {
      const int kc = i * SPLIT_KT + kk * 16 + 2 * t;
      uint32_t a[4];
      a[0] = lo ? dstt::ld_u32(xs + g * ldx + kc) : 0u;
      a[1] = hi ? dstt::ld_u32(xs + (g + 8) * ldx + kc) : 0u;
      a[2] = lo ? dstt::ld_u32(xs + g * ldx + kc + 8) : 0u;
      a[3] = hi ? dstt::ld_u32(xs + (g + 8) * ldx + kc + 8) : 0u;
      const int row = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const int chunk = cbase + 2 * n + (lane >> 4);
        uint32_t b[4];
        dstt::ldmatrix_x4_trans(
            b, tile + row * 128 + ((chunk ^ (row & 7)) << 4));
        dstt::mma_bf16(acc[2 * n], a, b[0], b[1]);
        dstt::mma_bf16(acc[2 * n + 1], a, b[2], b[3]);
      }
    }
    __syncwarp();
    if (lane == 0) hp::mbar_arrive(&empty[s]);
  }
  if (store_partial<4>(acc, out, ws, tickets + tn, &last, M, N, g,
                       n0 + 32 * warp + 2 * t, split, splits, 1, 128,
                       tid == 0)) {
    sum_partials<ST_BN, 8>(out, ws, tickets + tn, M, N, 0, M, n0, splits,
                           tid, 128);
  }
}

// ---- tile_matmul_wgmma: TMA + wgmma for M > 16 --------------------
constexpr int WG_BM = 128, WG_BN = 128;
constexpr int WG_A = WG_BM * SPLIT_KT * 2;     // [128 m][64 k], 16 KB
constexpr int WG_BOX = SPLIT_KT * 64 * 2;      // [64 k][64 n], 8 KB
constexpr int WG_SLOT = WG_A + 2 * WG_BOX;     // 32 KB
constexpr int WG_STAGES = 6;
constexpr int WG_THREADS = 384;                // producer + 2 consumer WGs

__global__ void __launch_bounds__(WG_THREADS, 1)
tile_matmul_wgmma(const __grid_constant__ CUtensorMap xmap,
           const __grid_constant__ CUtensorMap wmap, float* __restrict__ out,
           float* __restrict__ ws, int* __restrict__ tickets, int M, int K,
           int N, int splits) {
  extern __shared__ __align__(1024) uint8_t smem_tma[];
  uint8_t* ring = hp::align1024(smem_tma);
  __shared__ __align__(8) uint64_t full[WG_STAGES], empty[WG_STAGES];
  __shared__ int last;
  const int tn = blockIdx.x, tm = blockIdx.y, split = blockIdx.z;
  const int nkt = (K + SPLIT_KT - 1) / SPLIT_KT;
  int t0, t1;
  split_range(split, splits, nkt, t0, t1);
  const int nk = t1 - t0, m0 = tm * WG_BM, n0 = tn * WG_BN;
  const int tid = threadIdx.x, wg = tid >> 7;
  if (tid == 0) {
    for (int s = 0; s < WG_STAGES; ++s) {
      hp::mbar_init(&full[s], 1);
      hp::mbar_init(&empty[s], 8);
    }
    hp::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {   // producer
    if (tid == 0) {
      for (int i = 0; i < nk; ++i) {
        const int s = i % WG_STAGES;
        hp::mbar_wait(&empty[s], ((i / WG_STAGES) & 1) ^ 1);
        hp::mbar_expect_tx(&full[s], WG_SLOT);
        uint8_t* slot = ring + s * WG_SLOT;
        const int kr = (t0 + i) * SPLIT_KT;
        hp::tma_load_2d(slot, &xmap, &full[s], kr, m0);
        hp::tma_load_2d(slot + WG_A, &wmap, &full[s], n0, kr);
        hp::tma_load_2d(slot + WG_A + WG_BOX, &wmap, &full[s], n0 + 64, kr);
      }
    }
    return;
  }

  const int c = wg - 1, ltid = tid - 128;
  const int warp = (ltid >> 5) & 3, lane = ltid & 31;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  for (int i = 0; i < nk; ++i) {
    const int s = i % WG_STAGES;
    hp::mbar_wait(&full[s], (i / WG_STAGES) & 1);
    const uint8_t* slot = ring + s * WG_SLOT;
    hp::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < SPLIT_KT / 16; ++kk) {
      // A: K-major rows of 128 B, this warpgroup's 64 rows; B: MN-major,
      // 16 k rows per step, the two 64-column boxes 8 KB apart
      const uint64_t da =
          hp::smem_desc(slot + c * 64 * 128 + kk * 32, hp::SW128, 16, 1024);
      const uint64_t db = hp::smem_desc(slot + WG_A + kk * 16 * 128,
                                        hp::SW128, WG_BOX, 1024);
      hp::wgmma_ss<128, 1>(acc, da, db, 1);
    }
    hp::wgmma_commit();
    // the previous slot's products are done: free it
    hp::wgmma_wait<1>();
    if (i > 0 && lane == 0)
      hp::mbar_arrive(&empty[(i - 1) % WG_STAGES]);
  }
  hp::wgmma_wait<0>();
  hp::fence_regs(acc);
  const int g = lane >> 2, t = lane & 3;
  int* ticket = tickets + tm * gridDim.x + tn;
  if (store_partial<16>(reinterpret_cast<const float(*)[4]>(acc), out, ws,
                        ticket, &last, M, N, m0 + 64 * c + 16 * warp + g,
                        n0 + 2 * t, split, splits, 1, 256, ltid == 0)) {
    sum_partials<WG_BN, 8>(out, ws, ticket, M, N, m0, min(WG_BM, M - m0),
                           n0, splits, ltid, 256);
  }
}

int launch_stream(const void* x, const void* w, void* out, void* ws,
                  void* tickets, int M, int K, int N, int splits,
                  cudaStream_t st) {
  CUtensorMap wmap;
  const uint64_t dims[2] = {(uint64_t)N, (uint64_t)K};
  const uint64_t strides[1] = {(uint64_t)N * 2};
  const uint32_t box[2] = {64, SPLIT_KT};
  int rc = hp::make_map_bf16(&wmap, w, 2, dims, strides, box, hp::SW128);
  if (rc) return rc;
  const int nkt = (K + SPLIT_KT - 1) / SPLIT_KT;
  const int ldx = (nkt + splits - 1) / splits * SPLIT_KT + 8;
  const int smem = 1024 + ST_STAGES * ST_SLOT + M * ldx * 2;
  // three CTAs an SM at the decode hops' M: ask for the largest shared
  // memory carveout, or the CUDA driver may leave room for two
  cudaError_t e = cudaFuncSetAttribute(
      tile_matmul_stream, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(tile_matmul_stream,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return (int)e;
  tile_matmul_stream<<<dim3((unsigned)((N + ST_BN - 1) / ST_BN), splits),
                ST_THREADS, smem, st>>>(
      wmap, static_cast<const bf16*>(x), static_cast<float*>(out),
      static_cast<float*>(ws), static_cast<int*>(tickets), M, K, N, splits,
      ldx);
  return (int)cudaGetLastError();
}

int launch_wgmma(const void* x, const void* w, void* out, void* ws,
                 void* tickets, int M, int K, int N, int splits,
                 cudaStream_t st) {
  CUtensorMap xmap, wmap;
  const uint64_t xdims[2] = {(uint64_t)K, (uint64_t)M};
  const uint64_t xstr[1] = {(uint64_t)K * 2};
  const uint32_t xbox[2] = {SPLIT_KT, WG_BM};
  int rc = hp::make_map_bf16(&xmap, x, 2, xdims, xstr, xbox, hp::SW128);
  if (rc) return rc;
  const uint64_t wdims[2] = {(uint64_t)N, (uint64_t)K};
  const uint64_t wstr[1] = {(uint64_t)N * 2};
  const uint32_t wbox[2] = {64, SPLIT_KT};
  rc = hp::make_map_bf16(&wmap, w, 2, wdims, wstr, wbox, hp::SW128);
  if (rc) return rc;
  const long tiles_m = (M + WG_BM - 1) / WG_BM;
  if (tiles_m > MAX_GRID_Y) return (int)cudaErrorInvalidValue;
  const int smem = 1024 + WG_STAGES * WG_SLOT;
  cudaError_t e = cudaFuncSetAttribute(
      tile_matmul_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  tile_matmul_wgmma<<<dim3((unsigned)((N + WG_BN - 1) / WG_BN),
                           (unsigned)tiles_m, splits),
               WG_THREADS, smem, st>>>(
      xmap, wmap, static_cast<float*>(out), static_cast<float*>(ws),
      static_cast<int*>(tickets), M, K, N, splits);
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

// The TMA variants, as the host plan (tp_matmul.tile_plan) chose them:
// variant 0 = tile_matmul_stream (M <= 16), 1 = tile_matmul_wgmma; bf16
// x [M, K] and w [K, N] with K and N multiples of 8 and 16-byte aligned
// bases; splits in [1, ceil(K / 64)]; with splits > 1, ws is f32
// [splits, M, N] and tickets holds one zeroed int per output tile (left
// zeroed).  Returns cudaGetLastError() after the launch.
extern "C" int dstt_tile_matmul_tma(const void* x, const void* w, void* out,
                                    void* ws, void* tickets, int M, int K,
                                    int N, int variant, int splits,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nkt = (K + SPLIT_KT - 1) / SPLIT_KT;
  if (M <= 0 || K <= 0 || N <= 0 || K % 8 || N % 8 || splits < 1 ||
      splits > nkt || splits > MAX_GRID_Y ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w)) % 16 ||
      (splits > 1 && (ws == nullptr || tickets == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (variant == 0 && M <= 16)
    return launch_stream(x, w, out, ws, tickets, M, K, N, splits, st);
  if (variant == 1)
    return launch_wgmma(x, w, out, ws, tickets, M, K, N, splits, st);
  return (int)cudaErrorInvalidValue;
}
