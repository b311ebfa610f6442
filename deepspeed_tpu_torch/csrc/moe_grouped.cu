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
// grid is fixed by the host-known M, G, N and K, so nothing is read back.
// A CTA owns one (group, row tile, column tile[, K split]); it finds its
// group and row tile by walking the groups' tile counts in `off`
// (`find_tile`), and row-tile slots past the last tile exit at once, so
// an empty group costs nothing.  Every output element is summed over K in
// a fixed order, with no float atomics, so a rerun is bit-identical.
//
// Four kernels; the host plan `ops/moe_grouped.py:grouped_plan` picks one
// per shape (each has its own launch count) with its row tile and split.
//
// What bounds them on the H100: bytes, at every serving shape.  At decode
// a group holds a few rows, so each expert a token picked is read once, 2
// bytes a weight for at most 2 x rows operations.  At the prefill shapes
// too (Mixtral-8x7B's 512 rows over 8 experts: ~64 rows a group, 0.94 GB
// of weights against 60 GFLOP, 0.28 ms of bytes against 0.06 ms of
// tensor-core time), as long as each expert's weight is streamed from
// device memory once and the tensor cores keep up with the stream.
//
// moe_grouped_wgmma<TOK> (prefill: row tiles TOK of 32, 64 or 128) and
// moe_grouped_stream (decode: TOK 16), bf16 shapes TMA can read, share one
// warp-specialised body.  The weight tile sits on wgmma's
// 64-row M side and the group's x rows on its N side (TOK, any multiple
// of 8: the plan sizes it so one row tile covers a typical group, so an
// expert's weight is streamed once): out^T [128 cols, TOK rows] = w[g]^T
// x^T.  One producer warp keeps TMA loads in flight through an mbarrier
// ring: per 64-row K slot, x's [TOK rows][64 k] box (K-major B) and w's
// two [64 k][64 cols] boxes of a 3-D map [G, K, N] (MN-major A, the
// transpose bit bf16 allows; a K-edge box reads zeros, never the next
// expert's rows), 128-byte swizzle.  Two consumer warpgroups each run
// wgmma m64nTOKk16 on 64 of the CTA's 128 columns.  x rows past the
// group's end are loaded and multiplied, never written (each output row
// depends only on its x row).  The grid is (row-tile slot, column tile,
// K split): the slot is the fastest axis, so a group's row tiles run back
// to back on one weight strip, which then hits L2.  Each 64-row K slot
// is summed on the tensor cores into zeroed accumulators and then added
// to the running sum in f32, so the tensor cores' share of the rounding
// is a 64-term sum (a long chain read 1.6e-5 max|plain| at K 14336, near
// the 2e-5 limit).  Where the plan's tiles fall short of a wave, K is
// split: each split stores an f32 partial to a workspace and takes an
// integer ticket; the last CTA of a tile adds the partials in split order
// (split_k.cuh).  The stream keeps 4 slots a CTA and three CTAs an SM
// (bytes in flight on every SM); the wgmma kernel 6-8 slots and one CTA.
// Rows outside [off[0], off[G]) are written as zeros by the first slot's
// CTAs, so the wrapper allocates `out` without a fill.  On an H100 80GB
// HBM3 at 700.00 W they reach 78-91% of the bytes bound at Mixtral-8x7B's
// and Qwen1.5-MoE's decode and prefill shapes (PERF.md row 20).  Tried
// and dropped there: loading and multiplying half the row tile where a
// group's last tile holds TOK / 2 rows or fewer (2-5% slower at prefill:
// the compiler serialised the two wgmma shapes).
//
// moe_grouped_mma (bf16 shapes TMA cannot take: K or N not a multiple of
// 8, a base off the 16-byte boundary): four warps over a BM x 64 output
// tile (BM 16 where a group holds fewer than 32 rows on average, 64
// otherwise), blockIdx.x the column tile and blockIdx.y the row-tile
// slot (grid-stride past 65535), K streamed through shared memory in
// 32-row stages, STAGES in flight with cp.async (16-byte copies where K
// and N are multiples of 8 and the bases 16-byte aligned, element copies
// otherwise), mma.sync m16n8k16, each 32-row stage summed on the tensor
// cores into zeroed registers and then added in f32.  Rows outside
// [off[0], off[G]) are left as the caller set them (the wrapper zeroes).
//
// moe_grouped_f32 (f32): 256 threads over a 32 x 64 tile, each thread 2 x
// 4 outputs, f32 FMAs on the CUDA cores.
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
               int M, int K, int N, int G, long slots, int n_tiles,
               cudaStream_t st) {
  const int smem = STAGES * stage_elems<BM>() * (int)sizeof(bf16);
  const dim3 grid((unsigned)n_tiles, grid_y(slots));
  moe_grouped_mma<BM, VEC><<<grid, THREADS, smem, st>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<const int*>(off), static_cast<float*>(out), M, K, N, G,
      slots);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------
// TMA + wgmma kernels (bf16, K and N multiples of 8, 16-byte aligned bases)
namespace hp = dstt::hopper;

constexpr int TK = 64;                     // K rows per ring slot
constexpr int TBN = 128;                   // output columns per CTA
constexpr int WBOX = TK * 64 * 2;          // one [64 k][64 cols] w box, 8 KB
constexpr int TMA_THREADS = 288;           // 2 consumer warpgroups + producer
constexpr int STREAM_TOK = 16;             // the stream's row tile
constexpr int STREAM_STAGES = 4;           // 4 x 18 KB: three CTAs an SM

// Ring slots of the wgmma kernel at row tile TOK: some 192 KB a CTA.
template <int TOK>
__host__ __device__ constexpr int wgmma_stages() {
  return TOK == 128 ? 6 : 8;
}

template <int TOK>
__host__ __device__ constexpr int slot_bytes() {
  return TOK * TK * 2 + 2 * WBOX;   // x box [TOK][64 k], two w boxes
}

// Rows [0, off[0]) and [off[G], M) of columns [n0, n0 + TBN) are zero
// (ragged_dot's rows past its groups); offsets clamped as find_tile does.
__device__ __forceinline__ void zero_outside(const int* __restrict__ off,
                                             int G, int M, int N, int n0,
                                             float* __restrict__ out,
                                             int tid, int threads) {
  const int s = min(max(__ldg(off), 0), M);
  int e = s;
  for (int g = 1; g <= G; ++g) e = min(max(__ldg(off + g), e), M);
  const int cols = min(TBN, N - n0);
  const long n = (long)(s + M - e) * cols;
  for (long i = tid; i < n; i += threads) {
    const int r = (int)(i / cols), cc = (int)(i % cols);
    out[(long)(r < s ? r : e + (r - s)) * N + n0 + cc] = 0.f;
  }
}

template <int TOK, int STAGES>
__device__ __forceinline__ void grouped_tma_body(
    const CUtensorMap* xmap, const CUtensorMap* wmap,
    const int* __restrict__ off, float* __restrict__ out,
    float* __restrict__ ws, int* __restrict__ tickets, int M, int K, int N,
    int G, int splits) {
  constexpr int XB = TOK * TK * 2, SLOT = slot_bytes<TOK>();
  extern __shared__ __align__(1024) uint8_t smem_tma[];
  uint8_t* ring = hp::align1024(smem_tma);
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  __shared__ int last;
  const long slot_id = blockIdx.x;
  const int tn = blockIdx.y, split = blockIdx.z, n0 = tn * TBN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (slot_id == 0 && split == 0 && warp < 8)
    zero_outside(off, G, M, N, n0, out, tid, 256);
  int grp, m0, m1;
  if (!find_tile(off, G, M, TOK, slot_id, grp, m0, m1)) return;
  const int nkt = (K + TK - 1) / TK;
  int t0, t1;
  dstt::split_range(split, splits, nkt, t0, t1);
  const int nk = t1 - t0;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hp::mbar_init(&full[s], 1);
      hp::mbar_init(&empty[s], 8);
    }
    hp::mbar_fence_init();
  }
  __syncthreads();

  if (warp == 8) {   // producer: one thread keeps the ring full
    if (lane == 0) {
      for (int i = 0; i < nk; ++i) {
        const int s = i % STAGES;
        hp::mbar_wait(&empty[s], ((i / STAGES) & 1) ^ 1);
        hp::mbar_expect_tx(&full[s], SLOT);
        uint8_t* slot = ring + s * SLOT;
        const int kr = (t0 + i) * TK;
        hp::tma_load_2d(slot, xmap, &full[s], kr, m0);
        hp::tma_load_3d(slot + XB, wmap, &full[s], n0, kr, grp);
        hp::tma_load_3d(slot + XB + WBOX, wmap, &full[s], n0 + 64, kr, grp);
      }
    }
    return;
  }

  // consumer warpgroup c: columns [n0 + 64 c, + 64) x the tile's TOK rows
  const int c = warp >> 2, w4 = warp & 3, g = lane >> 2, t = lane & 3;
  float acc[TOK / 2], part[TOK / 2];
#pragma unroll
  for (int q = 0; q < TOK / 2; ++q) acc[q] = part[q] = 0.f;
  for (int i = 0; i < nk; ++i) {
    const int s = i % STAGES;
    hp::mbar_wait(&full[s], (i / STAGES) & 1);
    const uint8_t* slot = ring + s * SLOT;
    hp::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk) {
      // A: the w box MN-major (a row of 64 columns per k), 16 k rows a
      // step; B: x rows K-major, the k16 slice 32 kk bytes into the row
      const uint64_t da = hp::smem_desc(slot + XB + c * WBOX + kk * 16 * 128,
                                        hp::SW128, WBOX, 1024);
      const uint64_t db = hp::smem_desc(slot + kk * 32, hp::SW128, 16, 1024);
      hp::wgmma_ss<TOK, 0, 1>(part, da, db, kk > 0);
    }
    hp::wgmma_commit();
    hp::wgmma_wait<0>();
    hp::fence_regs(part);
    // the slot is read: free it, then add its sum in f32
    __syncwarp();
    if (lane == 0) hp::mbar_arrive(&empty[s]);
#pragma unroll
    for (int q = 0; q < TOK / 2; ++q) acc[q] += part[q];
  }

  // acc[4 j + e]: column 64 c + 16 w4 + g + 8 (e / 2), row 8 j + 2 t + e % 2
  float* dst = splits == 1 ? out : ws + (long)split * M * N;
#pragma unroll
  for (int j = 0; j < TOK / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = m0 + 8 * j + 2 * t + (e & 1);
      const int col = n0 + 64 * c + 16 * w4 + g + 8 * (e >> 1);
      if (row < m1 && col < N) dst[(long)row * N + col] = acc[4 * j + e];
    }
  }
  if (splits == 1) return;
  int* ticket = tickets + slot_id * gridDim.y + tn;
  if (dstt::take_ticket(ticket, &last, splits, 1, 256, tid == 0))
    // this tile's rows only: m1 is the group's end, and the group's later
    // row tiles merge their own rows once their splits have stored them
    dstt::sum_partials<TBN, 8>(out, ws, ticket, M, N, m0, min(m1 - m0, TOK),
                               n0, splits, tid, 256);
}

template <int TOK>
__global__ void __launch_bounds__(TMA_THREADS, 1)
moe_grouped_wgmma(const __grid_constant__ CUtensorMap xmap,
                  const __grid_constant__ CUtensorMap wmap,
                  const int* __restrict__ off, float* __restrict__ out,
                  float* __restrict__ ws, int* __restrict__ tickets, int M,
                  int K, int N, int G, int splits) {
  grouped_tma_body<TOK, wgmma_stages<TOK>()>(&xmap, &wmap, off, out, ws,
                                              tickets, M, K, N, G, splits);
}

__global__ void __launch_bounds__(TMA_THREADS, 3)
moe_grouped_stream(const __grid_constant__ CUtensorMap xmap,
                   const __grid_constant__ CUtensorMap wmap,
                   const int* __restrict__ off, float* __restrict__ out,
                   float* __restrict__ ws, int* __restrict__ tickets, int M,
                   int K, int N, int G, int splits) {
  grouped_tma_body<STREAM_TOK, STREAM_STAGES>(&xmap, &wmap, off, out, ws,
                                              tickets, M, K, N, G, splits);
}

using TmaKernel = void (*)(CUtensorMap, CUtensorMap, const int*, float*,
                           float*, int*, int, int, int, int, int);

int launch_tma(TmaKernel kernel, int tok, int stages, const void* x,
               const void* w, const void* off, void* out, void* ws,
               void* tickets, int M, int K, int N, int G, long slots,
               int n_tiles, int splits, cudaStream_t st) {
  CUtensorMap xmap, wmap;
  const uint64_t xdims[2] = {(uint64_t)K, (uint64_t)M};
  const uint64_t xstr[1] = {(uint64_t)K * 2};
  const uint32_t xbox[2] = {TK, (uint32_t)tok};
  int rc = hp::make_map_bf16(&xmap, x, 2, xdims, xstr, xbox, hp::SW128);
  if (rc) return rc;
  // w as [G, K, N]: a box past K reads zeros, not the next expert's rows
  const uint64_t wdims[3] = {(uint64_t)N, (uint64_t)K, (uint64_t)G};
  const uint64_t wstr[2] = {(uint64_t)N * 2, (uint64_t)K * N * 2};
  const uint32_t wbox[3] = {64, TK, 1};
  rc = hp::make_map_bf16(&wmap, w, 3, wdims, wstr, wbox, hp::SW128);
  if (rc) return rc;
  const int smem = 1024 + stages * (tok * TK * 2 + 2 * WBOX);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  // the stream's three CTAs an SM need the largest shared carveout
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)slots, (unsigned)n_tiles, (unsigned)splits);
  kernel<<<grid, TMA_THREADS, smem, st>>>(
      xmap, wmap, static_cast<const int*>(off), static_cast<float*>(out),
      static_cast<float*>(ws), static_cast<int*>(tickets), M, K, N, G,
      splits);
  return (int)cudaGetLastError();
}

}  // namespace

// The grid of every kernel is the host plan's (moe_grouped.grouped_plan):
// `slots` row-tile slots, at least as many as the row tiles of any
// offsets (their CTAs find no tile and exit), and `n_tiles` column tiles
// of `bn` columns; a launch refuses a column tile other than the kernel's
// or columns that do not cover N.

// out [M, N] f32 = x [M, K] @ w[g] [K, N] on rows [off[g], off[g+1]) of
// each group g < G; x, w, out row-major and contiguous, off
// [G+1] int32 on the device (nondecreasing, from 0 to M for a full cover).
// dtype: 0 = float32 (row tile bm 32), 1 = bfloat16 (x and w alike; bm 16
// or 64).  vec: 1 when K and N are multiples of 8 and x and w start on
// 16-byte boundaries.  Column tiles of bn = 64.  Returns
// cudaGetLastError() after the launch.
extern "C" int dstt_moe_grouped(const void* x, const void* w,
                                const void* off, void* out, int M, int K,
                                int N, int G, int dtype, int bm, int vec,
                                long slots, int n_tiles, int bn,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0 || K < 0 || G <= 0 || slots < 1 || bn != BN ||
      n_tiles > MAX_GRID_Y || (long)n_tiles * BN < N)
    return (int)cudaErrorInvalidValue;
  if (dtype == 1) {
    if (bm == 16)
      return vec ? launch_mma<16, true>(x, w, off, out, M, K, N, G, slots,
                                        n_tiles, st)
                 : launch_mma<16, false>(x, w, off, out, M, K, N, G, slots,
                                         n_tiles, st);
    if (bm == 64)
      return vec ? launch_mma<64, true>(x, w, off, out, M, K, N, G, slots,
                                        n_tiles, st)
                 : launch_mma<64, false>(x, w, off, out, M, K, N, G, slots,
                                         n_tiles, st);
    return (int)cudaErrorInvalidValue;
  }
  if (dtype == 0 && bm == FBM) {
    const dim3 grid((unsigned)n_tiles, grid_y(slots));
    moe_grouped_f32<<<grid, F_THREADS, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<const int*>(off), static_cast<float*>(out), M, K, N, G,
        slots);
    return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidValue;
}

// The TMA + wgmma kernels, as the host plan (moe_grouped.grouped_plan)
// chose them: tok 16 = moe_grouped_stream, 32 / 64 / 128 =
// moe_grouped_wgmma<tok>; bf16 x [M, K] and w [G, K, N] with K and N
// multiples of 8 and 16-byte aligned bases, off as above; every row of
// out is written (zeros outside [off[0], off[G])).  The grid is (slots,
// n_tiles column tiles of bn = 128, splits), splits in [1, ceil(K / 64)];
// with splits > 1, ws is f32 [splits, M, N] and tickets holds one zeroed
// int per (slot, column tile), slots x n_tiles, left zeroed.  Returns
// cudaGetLastError() after the launch.
extern "C" int dstt_moe_grouped_tma(const void* x, const void* w,
                                    const void* off, void* out, void* ws,
                                    void* tickets, int M, int K, int N,
                                    int G, int tok, long slots, int n_tiles,
                                    int bn, int splits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nkt = (K + TK - 1) / TK;
  if (M <= 0 || K <= 0 || N <= 0 || G <= 0 || K % 8 || N % 8 ||
      splits < 1 || splits > nkt || splits > MAX_GRID_Y || slots < 1 ||
      slots > 0x7fffffffL || bn != TBN || n_tiles > MAX_GRID_Y ||
      (long)n_tiles * TBN < N ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w)) % 16 ||
      (splits > 1 && (ws == nullptr || tickets == nullptr)))
    return (int)cudaErrorInvalidValue;
  switch (tok) {
    case STREAM_TOK:
      return launch_tma(moe_grouped_stream, tok, STREAM_STAGES, x, w, off,
                        out, ws, tickets, M, K, N, G, slots, n_tiles,
                        splits, st);
    case 32:
      return launch_tma(moe_grouped_wgmma<32>, tok, wgmma_stages<32>(),
                        x, w, off, out, ws, tickets, M, K, N, G, slots,
                        n_tiles, splits, st);
    case 64:
      return launch_tma(moe_grouped_wgmma<64>, tok, wgmma_stages<64>(),
                        x, w, off, out, ws, tickets, M, K, N, G, slots,
                        n_tiles, splits, st);
    case 128:
      return launch_tma(moe_grouped_wgmma<128>, tok, wgmma_stages<128>(),
                        x, w, off, out, ws, tickets, M, K, N, G, slots,
                        n_tiles, splits, st);
  }
  return (int)cudaErrorInvalidValue;
}
