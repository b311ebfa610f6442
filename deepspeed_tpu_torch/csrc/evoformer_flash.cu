// Evoformer attention for Hopper (sm_90a): MSA row and triangle attention
// with a mask bias and a pair bias, forward and backward.
//
// Replaces the TPU kernels of deepspeed_tpu/ops/evoformer_flash.py:
//   evo_fwd_*: `evoformer_flash_forward` (pallas_call at :156, `_kernel`)
//     and `evoformer_flash_forward_dmajor` (:613, `_kernel_dmajor`): the
//     D-major staging is the TPU's lane-padding rule for D < 64 and has no
//     counterpart here, so one forward serves both;
//   evo_dq_*: `_bwd_dq_kernel` (:379);
//   evo_dkv_*: `_bwd_dkv_kernel` (:405) and, as its epilogue, the mask-bias
//     gradient `_bwd_db1_kernel` (:479);
// dq and dk/dv come as three pairs (`ops.evoformer_flash.bwd_variant`
// names the one inputs take): TMA + wgmma for bf16 at D 32, 64 and 128
// (evo_dq_wgmma, evo_dkv_wgmma), mma.sync through registers for bf16 at
// every other D (evo_dq_mma, evo_dkv_mma: D 8, the extra-MSA width, would
// run 4x padded on wgmma, whose products contract D in whole 16-column
// steps of a swizzled row) and the CUDA cores for f32.
//   evo_db2_*: the pair-bias gradient `_bwd_db2_kernel` (:442).
//
// Layout (the JAX public one, no transposes): q, k, v, out, dO, dq, dk, dv
// [B, N, L, H, D]; the mask bias b1 [B, N, 1, 1, L] read as [B*N, L], the
// pair bias b2 [B, 1, H, L, L] read as [B, H, L, L], each f32 or bf16 (its
// gradient is written in its dtype); lse and delta [B*N, H, L] f32.  Any L
// (the tails are masked in the kernels), D % 8 == 0 up to 128.
//
// The score of query i and key j in row bn, head h is
//   s = q.k * scale + b1[bn, j] + b2[bn / N, h, i, j]
// (added in that order, as the TPU kernels do).  Scores at or below -5e29
// are re-masked to P = 0, the running max starts at the -1e30 sentinel
// and l is floored at 1e-9, so a row whose every key carries the -1e30
// mask gives out 0, lse = -1e30 and zero gradients; the -1e9 mask of
// AlphaFold-class models is not re-masked (a row masked everywhere with it
// gives a uniform softmax, as the JAX paths do).  The TPU kernels scale q
// in f32 before q.k; the tensor-core kernels here scale the f32 product
// instead (a difference within the bf16 rounding of q); the f32 kernels
// scale q first.
//
//   forward, grid (ceil(L/64), H, B*N): one CTA per 64-row query tile of
//     one (row, head) stages K, V and its b1 key row 256 keys at a time
//     (one barrier pair per 256 keys), and each warp then walks the 64-key
//     tiles on its own with an online softmax in f32 (m, l and the output
//     in registers), adding the pair bias from device memory into its
//     score fragment (the JAX kernel's [bq, bk] copies of b1 are TPU
//     tiling); out and lse = m + log(l);
//   dq (mma), same grid: delta = rowsum(dO * O) of its rows from out as
//     stored (written to `delta` for the other two kernels, which run
//     after it on the stream), then K and V staged as in the forward, and
//     per 16-key slice P = exp(s - lse), dP = dO V^T, dS = P (dP - delta),
//     dQ += dS K; dq = dQ * scale, written once;
//   dk/dv (mma), grid (ceil(L/64), B*N): one CTA per 64-key tile of a row
//     walks the heads and, for each, the 64-query tiles (Q, dO, lse, delta
//     and the pair-bias tile staged in shared memory): P^T and dS^T as
//     above, dV += P^T dO, dK += dS^T Q in f32 registers, written once per
//     head; with db1 asked for, each lane also sums dS over the heads and
//     queries of its two keys in a fixed order, and the four lanes of a
//     key add with two shuffles: db1 written once;
//   dq and dk/dv (wgmma): the same work and order of sums, warp-
//     specialised (see evo_dq_wgmma and evo_dkv_wgmma below);
//   db2, grid (ceil(L/64) query tiles, ceil(L/64) key tiles, B*H): one CTA
//     per [64, 64] tile of the pair bias (held in shared memory for every
//     row) walks the N rows and sums dS in f32 registers: G groups of four
//     warps take the rows n = g, g + G, ... and group 0 adds the groups'
//     partial tiles in the order g = 0 .. G-1.  The reference CUTLASS
//     kernel sums with float atomics, whose order changes from run to
//     run; here nothing accumulates with atomics, so two runs give the
//     same bits.
// The B*N (B*H) axis of each grid stops at the 65535 limit of the y and z
// axes: each kernel is a grid-stride loop over its slices (`*_slice` is
// one slice's work), so any B*N is served.
//
// The bf16 mma forms (the forward, db2, and dq and dk/dv where D is not
// 32, 64 or 128) run on the tensor cores (mma.sync m16n8k16, f32
// accumulate): four warps of 16 rows, the tiles staged in shared memory as bf16 rows of
// DP + 8 elements, where DP is D rounded up to 16, 32, 64 or 128 and the
// columns past D are zero (D 8, the extra-MSA stack's width, runs as 16);
// P and dS are rounded to bf16 and reused from the accumulator registers
// as the A operand.  f32 runs on the CUDA cores with exact f32 products:
// one warp per query row (key row in dk/dv), a lane per key (query) of a
// 32-wide chunk for the scores and the D columns over the lanes for the
// products.
//
// What bounds it on the H100 at AlphaFold 2's MSA row attention (q/k/v
// [1, 128, 256, 8, 32] bf16): bytes.  The forward moves ~69 MB (0.021 ms
// at 3.35 TB/s) against 8.6 GFLOP (0.009 ms at 989 TFLOP/s); dq and dk/dv
// each ~0.031 ms of bytes.  The mma forms reload K/V per query tile (from
// L2) and the pair bias per row n, stage operands with no copy/compute
// overlap (the loads of a chunk wait at a barrier), and at D 32 spend as
// many instructions on the softmax and the biases as on the products; the
// db2 kernel has B*H*(L/64)^2 CTAs (128 at that shape), each walking the N
// rows, and is bound by the latency of its loads.  The wgmma pair streams
// every operand by TMA behind the products (a producer warp and an
// mbarrier ring), keeps the pair-bias tile in bf16 or f32 as given (no
// per-tile widening pass) and runs two (dk/dv) or three (dq) CTAs an SM;
// what holds it at ~3x its bound is each tile's chain of products,
// exponentials and bias reads (PERF.md).
#include "attn_tile.cuh"
#include "hopper_tile.cuh"

namespace {

using bf16 = __nv_bfloat16;
namespace hp = dstt::hopper;
using dstt::acc_to_a;
using dstt::frag_a;
using dstt::mma_abt;
using dstt::mma_rowmajor_b;
using dstt::warp_max;
using dstt::warp_sum;
using dstt::zero16;

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int TILE = 64;         // query rows and keys of a tile
constexpr int THREADS = 128;     // four warps of 16 rows
constexpr int F32_WARPS = 8;
constexpr int MAX_D = 128;
constexpr int NC = MAX_D / 32;   // f32 kernels: columns a lane may own

// The problem and its biases (null when absent).
struct Evo {
  int B, N, L, H, D;
  float scale;
  const void* b1;   // [B*N, L]
  const void* b2;   // [B, H, L, L]
  int b1_bf16, b2_bf16;
};

__device__ __forceinline__ float ld_any(const void* p, long i, int is_bf16) {
  return is_bf16 ? __bfloat162float(static_cast<const bf16*>(p)[i])
                 : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ void st_any(void* p, long i, float x,
                                       int is_bf16) {
  if (is_bf16)
    static_cast<bf16*>(p)[i] = __float2bfloat16_rn(x);
  else
    static_cast<float*>(p)[i] = x;
}

// The biased score of query i and key j (both < L) in row bn, head h,
// from the scaled product x.
__device__ __forceinline__ float biased(const Evo& e, float x, int bn, int h,
                                        int i, int j) {
  if (e.b1) x += ld_any(e.b1, (long)bn * e.L + j, e.b1_bf16);
  if (e.b2)
    x += ld_any(e.b2, ((long)(bn / e.N * e.H + h) * e.L + i) * e.L + j,
                e.b2_bf16);
  return x;
}

// P of a biased score against the row's lse (natural units); 0 at or
// below the mask level.
__device__ __forceinline__ float prob(float x, float lse) {
  return x > NEG_INF * 0.5f ? exp2f((x - lse) * LOG2E) : 0.f;
}

// ---------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------
constexpr int CHUNK = 256;       // keys staged at once (forward, dq)
constexpr int LDB = TILE + 4;    // f32 bias tile rows in shared memory

// Rows [0, n) of D bf16 (global row stride `stride`) into a `rows`-row
// shared tile of DP + 8, zero past row n and past column D; the `nthr`
// threads numbered `tid` share the copy.
template <int DP>
__device__ __forceinline__ void stage(bf16* dst, const bf16* src, long stride,
                                      int n, int D, int rows, int tid,
                                      int nthr) {
  constexpr int LD = DP + 8;
  constexpr int NV = DP / 8;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int i = tid; i < rows * NV; i += nthr) {
    const int row = i / NV;
    const int c = (i % NV) * 8;
    *reinterpret_cast<uint4*>(dst + row * LD + c) =
        row < n && c < D
            ? *reinterpret_cast<const uint4*>(src + row * stride + c)
            : zero;
  }
}

// b1[bn, k0 .. k0 + n) as f32 (0 where absent or past L).
__device__ __forceinline__ void stage_b1(float* B1s, const Evo& e, int bn,
                                         int k0, int n, int tid, int nthr) {
  for (int j = tid; j < n; j += nthr)
    B1s[j] = e.b1 && k0 + j < e.L
                 ? ld_any(e.b1, (long)bn * e.L + k0 + j, e.b1_bf16)
                 : 0.f;
}

// x[j][c] += b2[row(c), col(j, c)] of one row-major [L, L] plane p
// (nothing past L); the dtype branch sits outside the loops, so a lane's
// loads are independent.
template <int NJ, typename T>
__device__ __forceinline__ void add_b2_as(float (*x)[4], const T* p, int L,
                                          const int* row, int col0, int t) {
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int r = row[c >> 1];
      const int cc = col0 + 8 * j + 2 * t + (c & 1);
      if (r < L && cc < L) {
        if constexpr (std::is_same<T, bf16>::value)
          x[j][c] += __bfloat162float(p[(long)r * L + cc]);
        else
          x[j][c] += p[(long)r * L + cc];
      }
    }
}

// The pair bias added into a lane's score fragment, straight from device
// memory: query rows `row[0..1]` (the lane's rows g, g + 8 of its warp)
// and key columns col0 + 8j + 2t + {0, 1}.
template <int NJ>
__device__ __forceinline__ void add_b2(float (*x)[4], const Evo& e, int b,
                                       int h, const int* row, int col0,
                                       int t) {
  if (e.b2 == nullptr) return;
  const long plane = ((long)b * e.H + h) * e.L * e.L;
  if (e.b2_bf16)
    add_b2_as<NJ>(x, static_cast<const bf16*>(e.b2) + plane, e.L, row, col0,
                  t);
  else
    add_b2_as<NJ>(x, static_cast<const float*>(e.b2) + plane, e.L, row,
                  col0, t);
}

// The pair bias tile b2[b, h, q0 .. q0 + TILE, k0 .. k0 + TILE) as f32,
// B2s[query * LDB + key] (0 where absent or past L).  The dtype branch
// sits outside the copy loops, so each thread's loads are independent;
// where L is a multiple of 16 bytes' worth of elements, 16-byte loads.
__device__ __forceinline__ void widen(float* x, uint4 raw, const bf16*) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void widen(float* x, uint4 raw, const float*) {
  const float4 f = *reinterpret_cast<const float4*>(&raw);
  x[0] = f.x;
  x[1] = f.y;
  x[2] = f.z;
  x[3] = f.w;
}

template <typename T>
__device__ __forceinline__ void stage_b2_as(float* B2s, const T* p, int L,
                                            int q0, int k0, int tid,
                                            int nthr) {
  constexpr int VEC = 16 / sizeof(T);
  if (L % VEC == 0) {   // every row starts on a 16-byte boundary
    for (int i = tid; i < TILE * TILE / VEC; i += nthr) {
      const int r = i / (TILE / VEC), c = (i % (TILE / VEC)) * VEC;
      float x[VEC];
      if (q0 + r < L && k0 + c < L) {
        widen(x, *reinterpret_cast<const uint4*>(p + (long)(q0 + r) * L +
                                                 k0 + c),
              p);
      } else {
#pragma unroll
        for (int u = 0; u < VEC; ++u) x[u] = 0.f;
      }
#pragma unroll
      for (int u = 0; u < VEC; u += 4)
        *reinterpret_cast<float4*>(B2s + r * LDB + c + u) =
            make_float4(x[u], x[u + 1], x[u + 2], x[u + 3]);
    }
    return;
  }
#pragma unroll 8
  for (int i = tid; i < TILE * TILE; i += nthr) {
    const int r = i / TILE, c = i % TILE;
    float x = 0.f;
    if (q0 + r < L && k0 + c < L) {
      if constexpr (std::is_same<T, bf16>::value)
        x = __bfloat162float(p[(long)(q0 + r) * L + k0 + c]);
      else
        x = p[(long)(q0 + r) * L + k0 + c];
    }
    B2s[r * LDB + c] = x;
  }
}

__device__ __forceinline__ void stage_b2(float* B2s, const Evo& e, int b,
                                         int h, int q0, int k0, int tid,
                                         int nthr) {
  if (e.b2 == nullptr) {
    for (int i = tid; i < TILE * LDB; i += nthr) B2s[i] = 0.f;
    return;
  }
  const long plane = ((long)b * e.H + h) * e.L * e.L;
  if (e.b2_bf16)
    stage_b2_as(B2s, static_cast<const bf16*>(e.b2) + plane, e.L, q0, k0,
                tid, nthr);
  else
    stage_b2_as(B2s, static_cast<const float*>(e.b2) + plane, e.L, q0, k0,
                tid, nthr);
}

// Bytes of dynamic shared memory: `own` TILE-row and `chunk` CHUNK-row
// bf16 tiles, and `f32` floats.
template <int DP>
__host__ __device__ constexpr int mma_smem(int own, int chunk, int f32) {
  return (own * TILE + chunk * CHUNK) * (DP + 8) * 2 + f32 * 4;
}

// The forward: Q's fragments in registers; K, V and b1 staged CHUNK keys
// at a time (one barrier pair per chunk, one chunk for L <= 256); each
// warp then walks the chunk's 64-key tiles on its own, adding the pair
// bias from device memory into its score fragment.
template <int DP>
__device__ __forceinline__ void
evo_fwd_mma_slice(const bf16* __restrict__ q, const bf16* __restrict__ k,
            const bf16* __restrict__ v, bf16* __restrict__ o,
            float* __restrict__ lse, Evo e, int bn) {
  constexpr int LD = DP + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + TILE * LD;
  bf16* Vs = Ks + CHUNK * LD;
  float* B1s = reinterpret_cast<float*>(Vs + CHUNK * LD);

  const int q0 = blockIdx.x * TILE, h = blockIdx.y;
  const int L = e.L, D = e.D, tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = (tid >> 5) * 16 + g;   // rows r0 and r0 + 8
  const long stride = (long)e.H * D;
  const long head = (long)bn * L * stride + (long)h * D;
  const int qi[2] = {q0 + r0, q0 + r0 + 8};

  stage<DP>(Qs, q + head + (long)q0 * stride, stride, L - q0, D, TILE, tid,
            THREADS);
  __syncthreads();
  uint32_t qa[DP / 16][4];
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) frag_a(qa[kk], Qs, LD, r0, kk * 16, t);

  float oacc[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) oacc[n][c] = 0.f;
  float m[2] = {NEG_INF, NEG_INF};   // running max (natural units)
  float l[2] = {0.f, 0.f};           // this lane's partial row sums

  for (int c0 = 0; c0 < L; c0 += CHUNK) {
    __syncthreads();   // the previous chunk's readers are done
    stage<DP>(Ks, k + head + (long)c0 * stride, stride, L - c0, D, CHUNK,
              tid, THREADS);
    stage<DP>(Vs, v + head + (long)c0 * stride, stride, L - c0, D, CHUNK,
              tid, THREADS);
    stage_b1(B1s, e, bn, c0, CHUNK, tid, THREADS);
    __syncthreads();
    for (int t0 = 0; t0 < min(CHUNK, L - c0); t0 += TILE) {
      const int k0 = c0 + t0;
      float s[TILE / 8][4];
#pragma unroll
      for (int j = 0; j < TILE / 8; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[j][c] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
#pragma unroll
        for (int j = 0; j < TILE / 8; ++j) {
          const bf16* kr = Ks + (t0 + j * 8 + g) * LD + kk * 16 + 2 * t;
          dstt::mma_bf16(s[j], qa[kk], dstt::ld_u32(kr),
                         dstt::ld_u32(kr + 8));
        }
      // s[j][0..1]: row r0, keys k0+8j+2t+{0,1}; s[j][2..3]: row r0+8;
      // the score is (s * scale + b1) + b2, as the TPU kernels add it
#pragma unroll
      for (int j = 0; j < TILE / 8; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          s[j][c] = s[j][c] * e.scale + B1s[t0 + 8 * j + 2 * t + (c & 1)];
      add_b2<TILE / 8>(s, e, bn / e.N, h, qi, k0, t);
      float tmax[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int j = 0; j < TILE / 8; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (k0 + 8 * j + 2 * t + (c & 1) >= L || qi[c >> 1] >= L)
            s[j][c] = NEG_INF;
          tmax[c >> 1] = fmaxf(tmax[c >> 1], s[j][c]);
        }
      float alpha[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        tmax[hh] = fmaxf(tmax[hh],
                         __shfl_xor_sync(0xffffffffu, tmax[hh], 1));
        tmax[hh] = fmaxf(tmax[hh],
                         __shfl_xor_sync(0xffffffffu, tmax[hh], 2));
        const float m_new = fmaxf(m[hh], tmax[hh]);
        alpha[hh] = exp2f((m[hh] - m_new) * LOG2E);
        m[hh] = m_new;
        l[hh] *= alpha[hh];
      }
#pragma unroll
      for (int j = 0; j < TILE / 8; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[j][c] = prob(s[j][c], m[c >> 1]);
          l[c >> 1] += s[j][c];
        }
#pragma unroll
      for (int n = 0; n < DP / 8; ++n) {
        oacc[n][0] *= alpha[0];
        oacc[n][1] *= alpha[0];
        oacc[n][2] *= alpha[1];
        oacc[n][3] *= alpha[1];
      }
#pragma unroll
      for (int kk = 0; kk < TILE / 16; ++kk) {
        uint32_t pa[4];
        acc_to_a(pa, s + 2 * kk);
        mma_rowmajor_b<DP>(oacc, pa, Vs + (t0 + kk * 16) * LD, LD, lane);
      }
    }
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
    if (qi[hh] >= L) continue;
    const float lsafe = fmaxf(l[hh], 1e-9f);
    const float inv = 1.f / lsafe;
    bf16* orow = o + head + (long)qi[hh] * stride;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n)
      if (n * 8 < D)
        *reinterpret_cast<__nv_bfloat162*>(orow + n * 8 + 2 * t) =
            __floats2bfloat162_rn(oacc[n][2 * hh] * inv,
                                  oacc[n][2 * hh + 1] * inv);
    if (t == 0) lse[((long)bn * e.H + h) * L + qi[hh]] = m[hh] + logf(lsafe);
  }
}

template <int DP>
__global__ void __launch_bounds__(THREADS)
evo_fwd_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
            const bf16* __restrict__ v, bf16* __restrict__ o,
            float* __restrict__ lse, Evo e) {
  for (int bn = blockIdx.z; bn < e.B * e.N; bn += gridDim.z) {
    evo_fwd_mma_slice<DP>(q, k, v, o, lse, e, bn);
    __syncthreads();   // the next slice restages shared memory
  }
}

// delta = rowsum(dO * O) of the staged dO rows [0, n) against O in device
// memory: two threads a row (TILE rows, THREADS threads), 8 columns a
// load, the pair adding with one shuffle.
template <int DP>
__device__ __forceinline__ float tile_delta(const bf16* dOs, const bf16* o,
                                            long stride, int n, int D) {
  constexpr int LD = DP + 8;
  const int row = threadIdx.x >> 1;
  float part = 0.f;
  if (row < n) {
    for (int c = (threadIdx.x & 1) * 8; c < D; c += 16) {
      const uint4 a = *reinterpret_cast<const uint4*>(dOs + row * LD + c);
      const uint4 b = *reinterpret_cast<const uint4*>(o + row * stride + c);
      const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
      const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
      for (int c2 = 0; c2 < 4; ++c2) {
        const float2 xf = __bfloat1622float2(x[c2]);
        const float2 yf = __bfloat1622float2(y[c2]);
        part += xf.x * yf.x + xf.y * yf.y;
      }
    }
  }
  return part + __shfl_xor_sync(0xffffffffu, part, 1);
}

// dq: Q and dO staged once; K, V and b1 CHUNK keys at a time, the warps
// walking the chunk's 16-key slices on their own.
template <int DP>
__device__ __forceinline__ void
evo_dq_mma_slice(const bf16* __restrict__ q, const bf16* __restrict__ k,
           const bf16* __restrict__ v, const bf16* __restrict__ o,
           const bf16* __restrict__ dout, const float* __restrict__ lse,
           bf16* __restrict__ dq, float* __restrict__ delta, Evo e, int bn) {
  constexpr int LD = DP + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dOs = Qs + TILE * LD;
  bf16* Ks = dOs + TILE * LD;
  bf16* Vs = Ks + CHUNK * LD;
  float* B1s = reinterpret_cast<float*>(Vs + CHUNK * LD);
  float* lse_s = B1s + CHUNK;
  float* delta_s = lse_s + TILE;

  const int q0 = blockIdx.x * TILE, h = blockIdx.y;
  const int L = e.L, D = e.D, tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = (tid >> 5) * 16 + g;
  const long stride = (long)e.H * D;
  const long head = (long)bn * L * stride + (long)h * D;
  const long qbase = head + (long)q0 * stride;
  const long rowoff = ((long)bn * e.H + h) * L + q0;   // lse / delta
  const int nrows = min(TILE, L - q0);

  stage<DP>(Qs, q + qbase, stride, nrows, D, TILE, tid, THREADS);
  stage<DP>(dOs, dout + qbase, stride, nrows, D, TILE, tid, THREADS);
  for (int r = tid; r < TILE; r += THREADS)
    lse_s[r] = r < nrows ? lse[rowoff + r] : 0.f;
  __syncthreads();
  {
    const float dl = tile_delta<DP>(dOs, o + qbase, stride, nrows, D);
    const int row = tid >> 1;
    if ((tid & 1) == 0) {
      delta_s[row] = dl;
      if (row < nrows) delta[rowoff + row] = dl;
    }
  }
  __syncthreads();
  const float lse_r[2] = {lse_s[r0], lse_s[r0 + 8]};
  const float delta_r[2] = {delta_s[r0], delta_s[r0 + 8]};
  const int qi[2] = {q0 + r0, q0 + r0 + 8};

  float dqacc[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) dqacc[n][c] = 0.f;

  for (int c0 = 0; c0 < L; c0 += CHUNK) {
    __syncthreads();   // the previous chunk's readers are done
    stage<DP>(Ks, k + head + (long)c0 * stride, stride, L - c0, D, CHUNK,
              tid, THREADS);
    stage<DP>(Vs, v + head + (long)c0 * stride, stride, L - c0, D, CHUNK,
              tid, THREADS);
    stage_b1(B1s, e, bn, c0, CHUNK, tid, THREADS);
    __syncthreads();
    for (int kc = 0; kc < min(CHUNK, L - c0); kc += 16) {
      const int k0 = c0 + kc;
      float s[2][4], dp[2][4];
      zero16(s);
      zero16(dp);
      mma_abt<DP>(s, Qs, Ks, LD, r0, kc, g, t);
      mma_abt<DP>(dp, dOs, Vs, LD, r0, kc, g, t);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          s[j][c] = s[j][c] * e.scale + B1s[kc + 8 * j + 2 * t + (c & 1)];
      add_b2<2>(s, e, bn / e.N, h, qi, k0, t);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int hh = c >> 1;
          const float p = k0 + 8 * j + 2 * t + (c & 1) < L && qi[hh] < L
                              ? prob(s[j][c], lse_r[hh])
                              : 0.f;
          s[j][c] = p * (dp[j][c] - delta_r[hh]);   // dS
        }
      uint32_t da[4];
      acc_to_a(da, s);
      mma_rowmajor_b<DP>(dqacc, da, Ks + kc * LD, LD, lane);
    }
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    if (qi[hh] >= L) continue;
    bf16* row = dq + head + (long)qi[hh] * stride;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n)
      if (n * 8 < D)
        *reinterpret_cast<__nv_bfloat162*>(row + n * 8 + 2 * t) =
            __floats2bfloat162_rn(dqacc[n][2 * hh] * e.scale,
                                  dqacc[n][2 * hh + 1] * e.scale);
  }
}

template <int DP>
__global__ void __launch_bounds__(THREADS)
evo_dq_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
           const bf16* __restrict__ v, const bf16* __restrict__ o,
           const bf16* __restrict__ dout, const float* __restrict__ lse,
           bf16* __restrict__ dq, float* __restrict__ delta, Evo e) {
  for (int bn = blockIdx.z; bn < e.B * e.N; bn += gridDim.z) {
    evo_dq_mma_slice<DP>(q, k, v, o, dout, lse, dq, delta, e, bn);
    __syncthreads();   // the next slice restages shared memory
  }
}

// dk/dv: per head, K and V of the CTA's 64 keys staged once; per 64-query
// tile, Q, dO, lse, delta and the pair-bias tile (as f32) staged in
// shared memory, one barrier pair a tile.
template <int DP>
__device__ __forceinline__ void
evo_dkv_mma_slice(const bf16* __restrict__ q, const bf16* __restrict__ k,
            const bf16* __restrict__ v, const bf16* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            bf16* __restrict__ dk, bf16* __restrict__ dv, void* db1, Evo e,
            int bn) {
  constexpr int LD = DP + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + TILE * LD;
  bf16* Qs = Vs + TILE * LD;
  bf16* dOs = Qs + TILE * LD;
  float* B2s = reinterpret_cast<float*>(dOs + TILE * LD);
  float* lse_s = B2s + TILE * LDB;
  float* delta_s = lse_s + TILE;

  const int k0 = blockIdx.x * TILE;
  const int L = e.L, D = e.D, tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = (tid >> 5) * 16 + g;   // key rows r0 and r0 + 8
  const long stride = (long)e.H * D;
  const int kj[2] = {k0 + r0, k0 + r0 + 8};
  // b1 of this lane's keys, the same for every head and query
  float b1r[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
    b1r[hh] = e.b1 && kj[hh] < L
                  ? ld_any(e.b1, (long)bn * L + kj[hh], e.b1_bf16)
                  : 0.f;
  float db1acc[2] = {0.f, 0.f};

  for (int h = 0; h < e.H; ++h) {
    const long head = (long)bn * L * stride + (long)h * D;
    __syncthreads();   // the previous head's readers are done
    stage<DP>(Ks, k + head + (long)k0 * stride, stride, L - k0, D, TILE,
              tid, THREADS);
    stage<DP>(Vs, v + head + (long)k0 * stride, stride, L - k0, D, TILE,
              tid, THREADS);
    float dkacc[DP / 8][4], dvacc[DP / 8][4];
#pragma unroll
    for (int n = 0; n < DP / 8; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) dkacc[n][c] = dvacc[n][c] = 0.f;

    for (int q0 = 0; q0 < L; q0 += TILE) {
      const long qbase = head + (long)q0 * stride;
      const long rowoff = ((long)bn * e.H + h) * L + q0;
      const int nrows = min(TILE, L - q0);
      __syncthreads();   // the previous query tile's readers are done
      stage<DP>(Qs, q + qbase, stride, nrows, D, TILE, tid, THREADS);
      stage<DP>(dOs, dout + qbase, stride, nrows, D, TILE, tid, THREADS);
      stage_b2(B2s, e, bn / e.N, h, q0, k0, tid, THREADS);
      for (int i = tid; i < TILE; i += THREADS) {
        lse_s[i] = i < nrows ? lse[rowoff + i] : 0.f;
        delta_s[i] = i < nrows ? delta[rowoff + i] : 0.f;
      }
      __syncthreads();
      for (int qc = 0; qc < TILE; qc += 16) {
        float st[2][4], dpt[2][4];
        zero16(st);
        zero16(dpt);
        mma_abt<DP>(st, Ks, Qs, LD, r0, qc, g, t);
        mma_abt<DP>(dpt, Vs, dOs, LD, r0, qc, g, t);
        // st[j][0..1]: key r0, queries qc+8j+2t+{0,1}; [2..3]: key r0+8
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int hk = c >> 1;
            const int ii = qc + 8 * j + 2 * t + (c & 1);
            const float p =
                kj[hk] < L && q0 + ii < L
                    ? prob((st[j][c] * e.scale + b1r[hk]) +
                               B2s[ii * LDB + r0 + 8 * hk],
                           lse_s[ii])
                    : 0.f;
            const float ds = p * (dpt[j][c] - delta_s[ii]);
            db1acc[hk] += ds;
            dpt[j][c] = ds;   // dS^T
            st[j][c] = p;     // P^T
          }
        uint32_t pa[4], dsa[4];
        acc_to_a(pa, st);
        acc_to_a(dsa, dpt);
        mma_rowmajor_b<DP>(dvacc, pa, dOs + qc * LD, LD, lane);
        mma_rowmajor_b<DP>(dkacc, dsa, Qs + qc * LD, LD, lane);
      }
    }

#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      if (kj[hh] >= L) continue;
      bf16* dkr = dk + head + (long)kj[hh] * stride;
      bf16* dvr = dv + head + (long)kj[hh] * stride;
#pragma unroll
      for (int n = 0; n < DP / 8; ++n)
        if (n * 8 < D) {
          *reinterpret_cast<__nv_bfloat162*>(dkr + n * 8 + 2 * t) =
              __floats2bfloat162_rn(dkacc[n][2 * hh] * e.scale,
                                    dkacc[n][2 * hh + 1] * e.scale);
          *reinterpret_cast<__nv_bfloat162*>(dvr + n * 8 + 2 * t) =
              __floats2bfloat162_rn(dvacc[n][2 * hh], dvacc[n][2 * hh + 1]);
        }
    }
  }

  if (db1 == nullptr) return;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float x = db1acc[hh];
    x += __shfl_xor_sync(0xffffffffu, x, 1);
    x += __shfl_xor_sync(0xffffffffu, x, 2);
    if (t == 0 && kj[hh] < L) st_any(db1, (long)bn * L + kj[hh], x, e.b1_bf16);
  }
}

template <int DP>
__global__ void __launch_bounds__(THREADS)
evo_dkv_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
            const bf16* __restrict__ v, const bf16* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            bf16* __restrict__ dk, bf16* __restrict__ dv, void* db1, Evo e) {
  for (int bn = blockIdx.y; bn < e.B * e.N; bn += gridDim.y) {
    evo_dkv_mma_slice<DP>(q, k, v, dout, lse, delta, dk, dv, db1, e, bn);
    __syncthreads();   // the next slice restages shared memory
  }
}

// db2 runs G groups of four warps in one CTA: group g takes the rows
// n = g, g + G, ... with its own tiles in shared memory (named barrier
// g + 1), and at the end group 0 adds the groups' partial sums in the
// order g = 0 .. G-1.  G is 4 up to DP 32 and 2 above (registers: 128 a
// thread at 512 threads).
template <int DP>
__host__ __device__ constexpr int db2_groups() {
  return DP <= 32 ? 4 : 2;
}

template <int DP>
__host__ __device__ constexpr int db2_group_smem() {
  return 4 * TILE * (DP + 8) * 2 + 3 * TILE * 4;
}

template <int DP>
__host__ __device__ constexpr int db2_smem() {
  return db2_groups<DP>() * db2_group_smem<DP>() + TILE * LDB * 4 +
         (db2_groups<DP>() - 1) * (TILE * TILE / THREADS) * THREADS * 4;
}

__device__ __forceinline__ void group_sync(int grp) {
  asm volatile("bar.sync %0, %1;" ::"r"(grp + 1), "n"(THREADS) : "memory");
}

template <int DP>
__device__ __forceinline__ void
evo_db2_mma_slice(const bf16* __restrict__ q, const bf16* __restrict__ k,
            const bf16* __restrict__ v, const bf16* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            void* db2, Evo e, int bh) {
  constexpr int LD = DP + 8;
  constexpr int G = db2_groups<DP>();
  constexpr int NACC = TILE * TILE / THREADS;   // accumulators a thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int grp = threadIdx.x / THREADS, tid = threadIdx.x % THREADS;
  unsigned char* own = smem_raw + grp * db2_group_smem<DP>();
  bf16* Qs = reinterpret_cast<bf16*>(own);
  bf16* dOs = Qs + TILE * LD;
  bf16* Ks = dOs + TILE * LD;
  bf16* Vs = Ks + TILE * LD;
  float* lse_s = reinterpret_cast<float*>(Vs + TILE * LD);
  float* delta_s = lse_s + TILE;
  float* B1s = delta_s + TILE;
  float* B2s = reinterpret_cast<float*>(smem_raw + G * db2_group_smem<DP>());
  float* red = B2s + TILE * LDB;   // [G - 1][NACC][THREADS]

  const int q0 = blockIdx.x * TILE, k0 = blockIdx.y * TILE;
  const int b = bh / e.H, h = bh % e.H;
  const int L = e.L, D = e.D;
  const int lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = (tid >> 5) * 16 + g;
  const long stride = (long)e.H * D;
  const int qi[2] = {q0 + r0, q0 + r0 + 8};
  const int nrows = min(TILE, L - q0);

  // the pair bias tile is the same for every row n
  stage_b2(B2s, e, b, h, q0, k0, threadIdx.x, THREADS * G);
  __syncthreads();
  float acc[TILE / 8][4];
#pragma unroll
  for (int j = 0; j < TILE / 8; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[j][c] = 0.f;

  for (int n = grp; n < e.N; n += G) {
    const int bn = b * e.N + n;
    const long head = (long)bn * L * stride + (long)h * D;
    const long rowoff = ((long)bn * e.H + h) * L + q0;
    group_sync(grp);   // the group's previous row is read
    stage<DP>(Qs, q + head + (long)q0 * stride, stride, nrows, D, TILE,
              tid, THREADS);
    stage<DP>(dOs, dout + head + (long)q0 * stride, stride, nrows, D, TILE,
              tid, THREADS);
    stage<DP>(Ks, k + head + (long)k0 * stride, stride, L - k0, D, TILE,
              tid, THREADS);
    stage<DP>(Vs, v + head + (long)k0 * stride, stride, L - k0, D, TILE,
              tid, THREADS);
    stage_b1(B1s, e, bn, k0, TILE, tid, THREADS);
    for (int i = tid; i < TILE; i += THREADS) {
      lse_s[i] = i < nrows ? lse[rowoff + i] : 0.f;
      delta_s[i] = i < nrows ? delta[rowoff + i] : 0.f;
    }
    group_sync(grp);
    const float lse_r[2] = {lse_s[r0], lse_s[r0 + 8]};
    const float delta_r[2] = {delta_s[r0], delta_s[r0 + 8]};
#pragma unroll
    for (int kc = 0; kc < TILE; kc += 16) {
      float s[2][4], dp[2][4];
      zero16(s);
      zero16(dp);
      mma_abt<DP>(s, Qs, Ks, LD, r0, kc, g, t);
      mma_abt<DP>(dp, dOs, Vs, LD, r0, kc, g, t);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int hh = c >> 1;
          const int kl = kc + 8 * j + 2 * t + (c & 1);
          if (k0 + kl < L && qi[hh] < L) {
            float x = s[j][c] * e.scale;
            x += B1s[kl];
            x += B2s[(r0 + 8 * hh) * LDB + kl];
            acc[kc / 8 + j][c] += prob(x, lse_r[hh]) *
                                  (dp[j][c] - delta_r[hh]);
          }
        }
    }
  }

  __syncthreads();
  if (grp > 0)
#pragma unroll
    for (int j = 0; j < TILE / 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        red[((grp - 1) * NACC + j * 4 + c) * THREADS + tid] = acc[j][c];
  __syncthreads();
  if (grp > 0) return;
#pragma unroll
  for (int j = 0; j < TILE / 8; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float x = acc[j][c];
      for (int gg = 1; gg < G; ++gg)
        x += red[((gg - 1) * NACC + j * 4 + c) * THREADS + tid];
      const int i = qi[c >> 1];
      const int key = k0 + 8 * j + 2 * t + (c & 1);
      if (i < L && key < L)
        st_any(db2, ((long)bh * L + i) * L + key, x, e.b2_bf16);
    }
}

template <int DP>
__global__ void __launch_bounds__(THREADS * db2_groups<DP>())
evo_db2_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
            const bf16* __restrict__ v, const bf16* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            void* db2, Evo e) {
  for (int bh = blockIdx.z; bh < e.B * e.H; bh += gridDim.z) {
    evo_db2_mma_slice<DP>(q, k, v, dout, lse, delta, db2, e, bh);
    __syncthreads();   // the next slice restages shared memory
  }
}

// ---------------------------------------------------------------------
// bf16 on TMA + wgmma (D 32, 64, 128), warp-specialised
// ---------------------------------------------------------------------
constexpr int WS = 3;              // ring slots
constexpr int RT = 64;             // ring tile rows: queries (dk/dv), keys (dq)
constexpr int SMEM_MAX = 232448;   // shared memory a CTA may have

// The pair bias as a wgmma kernel reads it: absent, bf16 or f32.
enum BiasKind { B2_NONE = 0, B2_BF16 = 1, B2_F32 = 2 };

template <int BK>
struct BiasTile {
  static constexpr int ES = BK == B2_F32 ? 4 : 2;   // bytes an element
  static constexpr int COLS = 128 / ES;   // keys a box row (128-byte swizzle)
  __host__ __device__ static constexpr int bytes(int rows, int keys) {
    return BK == B2_NONE ? 0 : rows * keys * ES;
  }
};

// Byte offset of pair-bias element (row r, key c) of a tile of `rows` rows
// stored as 128-byte-swizzled TMA boxes of COLS keys (box b at
// b * rows * 128): 16-byte chunk j of row r lands at chunk j ^ (r % 8).
template <int BK>
__device__ __forceinline__ int bias_at(int r, int c, int rows) {
  constexpr int ES = BiasTile<BK>::ES, COLS = BiasTile<BK>::COLS;
  const int byte = (c % COLS) * ES;
  return (c / COLS) * rows * 128 + r * 128 +
         ((((byte >> 4) ^ r) & 7) << 4) + (byte & 15);
}

// One bias element, and two of consecutive keys (c even), as f32.
template <int BK>
__device__ __forceinline__ float bias1(const uint8_t* tile, int off) {
  if constexpr (BK == B2_BF16)
    return __bfloat162float(*reinterpret_cast<const bf16*>(tile + off));
  else
    return *reinterpret_cast<const float*>(tile + off);
}

template <int BK>
__device__ __forceinline__ float2 bias2(const uint8_t* tile, int off) {
  if constexpr (BK == B2_BF16)
    return __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(tile + off));
  else
    return *reinterpret_cast<const float2*>(tile + off);
}

// A CTA of one consumer warpgroup (64 rows: keys in dk/dv, query rows in
// dq) and one producer warp after it (a second warpgroup sharing K and V,
// or Q and dO, at one CTA an SM was slower for both kernels); shared
// memory in bytes.
constexpr int WG_THREADS = 128 + 32;
constexpr int ROWS = 64;

template <int D, int BK>
struct EvoWg {
  static constexpr int OWN = ROWS * D * 2;   // K or V (dk/dv); Q or dO (dq)
  static constexpr int TILE = RT * D * 2;    // Q or dO (dk/dv); K or V (dq)
  static constexpr int BIAS = BiasTile<BK>::bytes(RT, ROWS);
  static constexpr int SLOT = 2 * TILE + BIAS;
  // dk/dv double-buffers K and V across heads; dq holds one Q and dO
  static constexpr int DKV_SMEM = 1024 + 4 * OWN + WS * SLOT;
  static constexpr int DQ_SMEM = 1024 + 2 * OWN + WS * SLOT;
};

// CTAs an SM that each kernel's registers are sized for (the launch
// bound caps every thread's registers, the producer warp's as a
// consumer's): at D 32 two (dk/dv) or three (dq); otherwise ptxas takes
// what it needs (D 64 spills at those caps).
template <int D>
constexpr int dkv_blocks() {
  return D == 32 ? 2 : 1;
}

template <int D>
constexpr int dq_blocks() {
  return D == 32 ? 3 : 1;
}

// The score's P from x = s * scale + b1 + b2 and the row's lse (natural
// units): 0 at or below the mask level, and where lse is +inf (rows past
// L).
__device__ __forceinline__ float wg_prob(float x, float lse) {
  return x > NEG_INF * 0.5f ? hp::ex2((x - lse) * LOG2E) : 0.f;
}

// dk/dv (+ db1), grid (ceil(L / 64), B*N slices): one CTA per 64 keys of
// one row bn walks the H heads and, for each, the 64-query tiles of the
// row.  The producer warp (after the consumers) loads K and V of a head
// (a 2-slot buffer, so the next head's arrive while this one runs) and
// streams each tile's Q, dO and pair-bias boxes [64 queries, 64 keys]
// through a WS-slot ring by TMA from one lane, while its 32 lanes stage
// the tile's lse and delta (+inf and 0 past L, loaded a tile ahead).  The
// consumer warpgroup: S^T = K Q^T and dP^T = V dO^T (wgmma), P^T =
// exp(S^T scale + b1 + b2^T - lse) with the bias read transposed from its
// swizzled tile, dS^T = P^T (dP^T - delta), dV += P^T dO and dK += dS^T Q
// (P^T, dS^T as the register A operand); dK scale and dV written once per
// head, db1 summed over heads and queries in a fixed order and written
// once.  Keys past L are computed and not written.
template <int D, int BK>
__global__ void __launch_bounds__(WG_THREADS, dkv_blocks<D>())
evo_dkv_wgmma(const __grid_constant__ CUtensorMap qmap,
              const __grid_constant__ CUtensorMap kmap,
              const __grid_constant__ CUtensorMap vmap,
              const __grid_constant__ CUtensorMap dmap,
              const __grid_constant__ CUtensorMap bmap,
              const float* __restrict__ lse, const float* __restrict__ delta,
              bf16* __restrict__ dk, bf16* __restrict__ dv, void* db1,
              Evo e) {
  using W = EvoWg<D, BK>;
  using T = hp::RowTile<D>;
  extern __shared__ __align__(1024) uint8_t smem_tma[];
  uint8_t* KV = hp::align1024(smem_tma);   // buffer u: K, then V
  uint8_t* ring = KV + 4 * W::OWN;         // slot s: Q, dO, bias
  __shared__ __align__(16) float lse_s[WS][RT], dl_s[WS][RT];
  __shared__ __align__(8) uint64_t kv_full[2], kv_empty[2], full[WS],
      empty[WS];
  const int L = e.L, H = e.H;
  const int k0 = blockIdx.x * ROWS;
  const int n_qt = (L + RT - 1) / RT;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    for (int u = 0; u < 2; ++u) {
      hp::mbar_init(&kv_full[u], 1);
      hp::mbar_init(&kv_empty[u], 4);   // one arrival a consumer warp
    }
    for (int s = 0; s < WS; ++s) {
      hp::mbar_init(&full[s], 1 + 32);      // expect_tx + the warp's lanes
      hp::mbar_init(&empty[s], 4);
    }
    hp::mbar_fence_init();
  }
  __syncthreads();

  // slices walk grid-stride; both roles count heads and tiles alike
  for (int bn = blockIdx.y, it = 0; bn < e.B * e.N;
       bn += gridDim.y, ++it) {
    const int h0 = it * H, j0 = it * H * n_qt;
    if (warp == 4) {   // the producer warp
      const int b = bn / e.N;
      // each lane's rows of the next tile's lse and delta, loaded while
      // the warp waits for its slot
      float nl[RT / 32], nd[RT / 32];
      auto fetch = [&](int j) {
        const long base = ((long)bn * H + j / n_qt) * L;
#pragma unroll
        for (int i = 0; i < RT / 32; ++i) {
          const int row = j % n_qt * RT + lane + 32 * i;
          nl[i] = row < L ? lse[base + row] : INFINITY;
          nd[i] = row < L ? delta[base + row] : 0.f;
        }
      };
      fetch(0);
      for (int j = 0; j < H * n_qt; ++j) {
        const int h = j / n_qt, qt = j % n_qt;
        const int jc = j0 + j, s = jc % WS;
        uint8_t* Qs = ring + s * W::SLOT;
        if (qt == 0 && lane == 0) {   // K and V of head h
          const int hc = h0 + h, u = hc & 1;
          uint8_t* Ks = KV + u * 2 * W::OWN;
          hp::mbar_wait(&kv_empty[u], ((hc >> 1) & 1) ^ 1);
          hp::mbar_expect_tx(&kv_full[u], 2 * W::OWN);
          for (int c = 0; c < T::NCH; ++c) {
            hp::tma_load_4d(Ks + c * ROWS * T::RB, &kmap, &kv_full[u],
                            c * T::CH, h, k0, bn);
            hp::tma_load_4d(Ks + W::OWN + c * ROWS * T::RB, &vmap,
                            &kv_full[u], c * T::CH, h, k0, bn);
          }
        }
        __syncwarp();
        hp::mbar_wait(&empty[s], ((jc / WS) & 1) ^ 1);
        if (lane == 0) {
          hp::mbar_expect_tx(&full[s], W::SLOT);
          for (int c = 0; c < T::NCH; ++c) {
            hp::tma_load_4d(Qs + c * RT * T::RB, &qmap, &full[s], c * T::CH,
                            h, qt * RT, bn);
            hp::tma_load_4d(Qs + W::TILE + c * RT * T::RB, &dmap, &full[s],
                            c * T::CH, h, qt * RT, bn);
          }
          if constexpr (BK != B2_NONE) {
            constexpr int COLS = BiasTile<BK>::COLS;
            for (int c = 0; c < ROWS / COLS; ++c)
              hp::tma_load_4d(Qs + 2 * W::TILE + c * RT * 128, &bmap,
                              &full[s], k0 + c * COLS, qt * RT, h, b);
          }
        }
#pragma unroll
        for (int i = 0; i < RT / 32; ++i) {
          lse_s[s][lane + 32 * i] = nl[i];
          dl_s[s][lane + 32 * i] = nd[i];
        }
        hp::mbar_arrive(&full[s]);
        if (j + 1 < H * n_qt) fetch(j + 1);
      }
    } else {
      const int g = lane >> 2, t = lane & 3;
      const int kl = 16 * warp + g;   // keys k0 + kl, + 8
      float b1r[2], db1acc[2] = {0.f, 0.f};
#pragma unroll
      for (int hk = 0; hk < 2; ++hk) {
        const int key = k0 + kl + 8 * hk;
        b1r[hk] = e.b1 && key < L
                      ? ld_any(e.b1, (long)bn * L + key, e.b1_bf16)
                      : 0.f;
      }
      float dka[D / 2], dva[D / 2], st[32], dpt[32];
      uint32_t pa[4][4], da[4][4];
      for (int h = 0; h < H; ++h) {
        const int hc = h0 + h, u = hc & 1;
        const uint8_t* ka = KV + u * 2 * W::OWN;
        const uint8_t* va = ka + W::OWN;
#pragma unroll
        for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;
        hp::mbar_wait(&kv_full[u], (hc >> 1) & 1);
        for (int qt = 0; qt < n_qt; ++qt) {
          const int jc = j0 + h * n_qt + qt, s = jc % WS;
          const uint8_t* Qs = ring + s * W::SLOT;
          const uint8_t* dOs = Qs + W::TILE;
          const uint8_t* Bs = Qs + 2 * W::TILE;
          hp::mbar_wait(&full[s], (jc / WS) & 1);
          hp::wgmma_fence();
          hp::issue_abt<D, RT>(st, ka, ROWS, Qs);
          hp::wgmma_commit();
          hp::issue_abt<D, RT>(dpt, va, ROWS, dOs);
          hp::wgmma_commit();
          hp::wgmma_wait<1>();
          hp::fence_regs(st);
          // element i: key kl + 8 (i / 2 % 2), query 8 (i / 4) + 2 t + i % 2
          // (two queries a float2 of lse and delta); in the swizzled bias
          // tile, query rows 8 apart lie 1024 bytes apart, so four offsets
          // serve all 32
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            const float2 l2 = *reinterpret_cast<const float2*>(
                &lse_s[s][8 * (i >> 2) + 2 * t]);
            float x = st[i] * e.scale + b1r[(i >> 1) & 1];
            if constexpr (BK != B2_NONE)
              x += bias1<BK>(Bs + (i >> 2) * 1024,
                             bias_at<BK>(2 * t + (i & 1),
                                         kl + 8 * ((i >> 1) & 1), RT));
            st[i] = wg_prob(x, i & 1 ? l2.y : l2.x);
          }
          hp::wgmma_wait<0>();
          hp::fence_regs(dpt);
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            const float2 d2 = *reinterpret_cast<const float2*>(
                &dl_s[s][8 * (i >> 2) + 2 * t]);
            const float ds = st[i] * (dpt[i] - (i & 1 ? d2.y : d2.x));
            db1acc[(i >> 1) & 1] += ds;
            dpt[i] = ds;
          }
          hp::pack_frags(pa, st);
          hp::pack_frags(da, dpt);
          hp::wgmma_fence();
          hp::issue_rs<D>(dva, pa, dOs);
          hp::issue_rs<D>(dka, da, Qs);
          hp::wgmma_commit();
          hp::wgmma_wait<0>();
          hp::fence_regs(dva);
          hp::fence_regs(dka);
          __syncwarp();
          if (lane == 0) hp::mbar_arrive(&empty[s]);
        }
        __syncwarp();
        if (lane == 0) hp::mbar_arrive(&kv_empty[u]);
#pragma unroll
        for (int hk = 0; hk < 2; ++hk) {
          const int key = k0 + kl + 8 * hk;
          if (key >= L) continue;
          const long off = (((long)bn * L + key) * H + h) * D;
#pragma unroll
          for (int n = 0; n < D / 8; ++n) {
            *reinterpret_cast<__nv_bfloat162*>(dk + off + 8 * n + 2 * t) =
                __floats2bfloat162_rn(dka[4 * n + 2 * hk] * e.scale,
                                      dka[4 * n + 2 * hk + 1] * e.scale);
            *reinterpret_cast<__nv_bfloat162*>(dv + off + 8 * n + 2 * t) =
                __floats2bfloat162_rn(dva[4 * n + 2 * hk],
                                      dva[4 * n + 2 * hk + 1]);
          }
        }
      }
#pragma unroll
      for (int hk = 0; hk < 2; ++hk) {
        float x = db1acc[hk];
        x += __shfl_xor_sync(0xffffffffu, x, 1);
        x += __shfl_xor_sync(0xffffffffu, x, 2);
        const int key = k0 + kl + 8 * hk;
        if (db1 != nullptr && t == 0 && key < L)
          st_any(db1, (long)bn * L + key, x, e.b1_bf16);
      }
    }
    __syncthreads();   // the slice's buffers are free for the next
  }
}

// rowsum(dO * O) over D / 4 columns (one thread's quarter of a row).
template <int D>
__device__ __forceinline__ float quarter_dot(const bf16* o, const bf16* d) {
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < D / 4; c += 8) {
    const uint4 a = *reinterpret_cast<const uint4*>(o + c);
    const uint4 b = *reinterpret_cast<const uint4*>(d + c);
    const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
    const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 xf = __bfloat1622float2(x[i]);
      const float2 yf = __bfloat1622float2(y[i]);
      s += xf.x * yf.x + xf.y * yf.y;
    }
  }
  return s;
}

// dq (+ delta), grid (ceil(L / 64), H, B*N slices): one CTA per 64 query
// rows of one (row, head).  The producer warp loads Q and dO once and
// streams 64-key tiles of K, V and the pair bias [64 rows, 64 keys] by
// TMA through a WS-slot ring, while its lanes stage each tile's b1 as f32
// (-1e30 past L, so those keys get P = 0; loaded a tile ahead).  The
// consumer warpgroup first takes delta = rowsum(dO * O) of its rows from
// device memory (four threads a row, written for the dk/dv and db2
// kernels), then per tile S = Q K^T and dP = dO V^T (wgmma), P = exp(S
// scale + b1 + b2 - lse), dS = P (dP - delta) and dQ += dS K (dS as the
// register A operand, K MN-major); dQ scale written once.
template <int D, int BK>
__global__ void __launch_bounds__(WG_THREADS, dq_blocks<D>())
evo_dq_wgmma(const __grid_constant__ CUtensorMap qmap,
             const __grid_constant__ CUtensorMap kmap,
             const __grid_constant__ CUtensorMap vmap,
             const __grid_constant__ CUtensorMap dmap,
             const __grid_constant__ CUtensorMap bmap,
             const bf16* __restrict__ o, const bf16* __restrict__ dout,
             const float* __restrict__ lse, bf16* __restrict__ dq,
             float* __restrict__ delta, Evo e) {
  using W = EvoWg<D, BK>;
  using T = hp::RowTile<D>;
  extern __shared__ __align__(1024) uint8_t smem_tma[];
  uint8_t* Qs = hp::align1024(smem_tma);
  uint8_t* dOs = Qs + W::OWN;
  uint8_t* ring = dOs + W::OWN;   // slot s: K, V, bias
  __shared__ __align__(16) float b1_s[WS][RT];
  __shared__ __align__(8) uint64_t q_full, full[WS], empty[WS];
  const int L = e.L, H = e.H;
  const int q0 = blockIdx.x * ROWS, h = blockIdx.y;
  const int n_kt = (L + RT - 1) / RT;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    hp::mbar_init(&q_full, 1);
    for (int s = 0; s < WS; ++s) {
      hp::mbar_init(&full[s], 1 + 32);      // expect_tx + the warp's lanes
      hp::mbar_init(&empty[s], 4);      // one arrival a consumer warp
    }
    hp::mbar_fence_init();
  }
  __syncthreads();

  for (int bn = blockIdx.z, it = 0; bn < e.B * e.N;
       bn += gridDim.z, ++it) {
    const int j0 = it * n_kt;
    if (warp == 4) {   // the producer warp
      const int b = bn / e.N;
      if (lane == 0) {
        hp::mbar_expect_tx(&q_full, 2 * W::OWN);
        for (int c = 0; c < T::NCH; ++c) {
          hp::tma_load_4d(Qs + c * ROWS * T::RB, &qmap, &q_full,
                          c * T::CH, h, q0, bn);
          hp::tma_load_4d(dOs + c * ROWS * T::RB, &dmap, &q_full,
                          c * T::CH, h, q0, bn);
        }
      }
      __syncwarp();
      // each lane's keys of the next tile's b1 (-1e30 past L), loaded
      // while the warp waits for its slot
      float nb[RT / 32];
      auto fetch = [&](int kt) {
#pragma unroll
        for (int i = 0; i < RT / 32; ++i) {
          const int key = kt * RT + lane + 32 * i;
          nb[i] = key >= L ? NEG_INF
                  : e.b1   ? ld_any(e.b1, (long)bn * L + key, e.b1_bf16)
                           : 0.f;
        }
      };
      fetch(0);
      for (int kt = 0; kt < n_kt; ++kt) {
        const int jc = j0 + kt, s = jc % WS;
        uint8_t* Ks = ring + s * W::SLOT;
        hp::mbar_wait(&empty[s], ((jc / WS) & 1) ^ 1);
        if (lane == 0) {
          hp::mbar_expect_tx(&full[s], W::SLOT);
          for (int c = 0; c < T::NCH; ++c) {
            hp::tma_load_4d(Ks + c * RT * T::RB, &kmap, &full[s], c * T::CH,
                            h, kt * RT, bn);
            hp::tma_load_4d(Ks + W::TILE + c * RT * T::RB, &vmap, &full[s],
                            c * T::CH, h, kt * RT, bn);
          }
          if constexpr (BK != B2_NONE) {
            constexpr int COLS = BiasTile<BK>::COLS;
            for (int c = 0; c < RT / COLS; ++c)
              hp::tma_load_4d(Ks + 2 * W::TILE + c * ROWS * 128, &bmap,
                              &full[s], kt * RT + c * COLS, q0, h, b);
          }
        }
#pragma unroll
        for (int i = 0; i < RT / 32; ++i) b1_s[s][lane + 32 * i] = nb[i];
        hp::mbar_arrive(&full[s]);
        if (kt + 1 < n_kt) fetch(kt + 1);
      }
    } else {
      const int g = lane >> 2, t = lane & 3;
      const int rl = 16 * warp + g;   // rows q0 + rl, + 8
      float lse_r[2], dl[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = q0 + rl + 8 * hh;
        const long li = ((long)bn * H + h) * L + row;
        const long off = (((long)bn * L + row) * H + h) * D + t * (D / 4);
        float part = row < L ? quarter_dot<D>(o + off, dout + off) : 0.f;
        part += __shfl_xor_sync(0xffffffffu, part, 1);
        part += __shfl_xor_sync(0xffffffffu, part, 2);
        dl[hh] = part;
        lse_r[hh] = row < L ? lse[li] : INFINITY;
        if (t == 0 && row < L) delta[li] = part;
      }
      const uint8_t* qa = Qs;
      const uint8_t* da_s = dOs;
      float dqa[D / 2], sc[32], dp[32];
      uint32_t dsa[4][4];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) dqa[i] = 0.f;
      hp::mbar_wait(&q_full, it & 1);
      for (int kt = 0; kt < n_kt; ++kt) {
        const int jc = j0 + kt, s = jc % WS;
        const uint8_t* Ks = ring + s * W::SLOT;
        const uint8_t* Vs = Ks + W::TILE;
        const uint8_t* Bs = Ks + 2 * W::TILE;
        hp::mbar_wait(&full[s], (jc / WS) & 1);
        hp::wgmma_fence();
        hp::issue_abt<D, RT>(sc, qa, ROWS, Ks);
        hp::wgmma_commit();
        hp::issue_abt<D, RT>(dp, da_s, ROWS, Vs);
        hp::wgmma_commit();
        hp::wgmma_wait<1>();
        hp::fence_regs(sc);
#pragma unroll
        for (int i = 0; i < 32; i += 2) {
          const int col = hp::acc_col(i, t);   // the tile's key (even)
          const int hh = (i >> 1) & 1;
          const float2 b1p =
              *reinterpret_cast<const float2*>(&b1_s[s][col]);
          float x0 = sc[i] * e.scale + b1p.x;
          float x1 = sc[i + 1] * e.scale + b1p.y;
          if constexpr (BK != B2_NONE) {
            // row rl + 8 hh: g in the swizzle, the rest 128 bytes a row
            const float2 bb =
                bias2<BK>(Bs + (rl - g + 8 * hh) * 128,
                          bias_at<BK>(g, col, ROWS));
            x0 += bb.x;
            x1 += bb.y;
          }
          sc[i] = wg_prob(x0, lse_r[hh]);
          sc[i + 1] = wg_prob(x1, lse_r[hh]);
        }
        hp::wgmma_wait<0>();
        hp::fence_regs(dp);
#pragma unroll
        for (int i = 0; i < 32; ++i) dp[i] = sc[i] * (dp[i] - dl[(i >> 1) & 1]);
        hp::pack_frags(dsa, dp);
        hp::wgmma_fence();
        hp::issue_rs<D>(dqa, dsa, Ks);
        hp::wgmma_commit();
        hp::wgmma_wait<0>();
        hp::fence_regs(dqa);
        __syncwarp();
        if (lane == 0) hp::mbar_arrive(&empty[s]);
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = q0 + rl + 8 * hh;
        if (row >= L) continue;
        bf16* out = dq + (((long)bn * L + row) * H + h) * D;
#pragma unroll
        for (int n = 0; n < D / 8; ++n)
          *reinterpret_cast<__nv_bfloat162*>(out + 8 * n + 2 * t) =
              __floats2bfloat162_rn(dqa[4 * n + 2 * hh] * e.scale,
                                    dqa[4 * n + 2 * hh + 1] * e.scale);
      }
    }
    __syncthreads();   // Q, dO and the ring are free for the next slice
  }
}

// ---------------------------------------------------------------------
// f32 on the CUDA cores: one warp per row, F32_WARPS rows a CTA
// ---------------------------------------------------------------------
__device__ __forceinline__ float dot(const float* a, const float* b, int D) {
  float acc = 0.f;
  for (int d = 0; d < D; d += 4) {
    const float4 x = *reinterpret_cast<const float4*>(a + d);
    const float4 y = *reinterpret_cast<const float4*>(b + d);
    acc += x.x * y.x + x.y * y.y + x.z * y.z + x.w * y.w;
  }
  return acc;
}

__device__ __forceinline__ void
evo_fwd_f32_slice(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, float* __restrict__ o,
            float* __restrict__ lse, Evo e, int bn) {
  __shared__ __align__(16) float qs_all[F32_WARPS][MAX_D];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i = blockIdx.x * F32_WARPS + warp;
  if (i >= e.L) return;
  const int h = blockIdx.y, L = e.L, D = e.D;
  const long stride = (long)e.H * D;
  const long head = (long)bn * L * stride + (long)h * D;
  float* qs = qs_all[warp];
  for (int d = lane; d < D; d += 32)
    qs[d] = q[head + (long)i * stride + d] * e.scale;
  __syncwarp();

  float m = NEG_INF, l = 0.f, acc[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) acc[c] = 0.f;
  for (int c0 = 0; c0 < L; c0 += 32) {
    const int key = c0 + lane;
    float x = NEG_INF;
    if (key < L)
      x = biased(e, dot(qs, k + head + (long)key * stride, D), bn, h, i, key);
    const float m_new = fmaxf(m, warp_max(x));
    const float p = x > NEG_INF * 0.5f ? expf(x - m_new) : 0.f;
    const float alpha = expf(m - m_new);
    l = l * alpha + warp_sum(p);
    m = m_new;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[c] *= alpha;
    const int nk = min(32, L - c0);
    for (int cc = 0; cc < nk; ++cc) {
      const float pc = __shfl_sync(0xffffffffu, p, cc);
      const float* vrow = v + head + (long)(c0 + cc) * stride;
#pragma unroll
      for (int c = 0; c < NC; ++c)
        if (lane + 32 * c < D) acc[c] += pc * vrow[lane + 32 * c];
    }
  }
  const float lsafe = fmaxf(l, 1e-9f);
#pragma unroll
  for (int c = 0; c < NC; ++c)
    if (lane + 32 * c < D)
      o[head + (long)i * stride + lane + 32 * c] = acc[c] / lsafe;
  if (lane == 0) lse[((long)bn * e.H + h) * L + i] = m + logf(lsafe);
}

__global__ void __launch_bounds__(F32_WARPS * 32)
evo_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, float* __restrict__ o,
            float* __restrict__ lse, Evo e) {
  for (int bn = blockIdx.z; bn < e.B * e.N; bn += gridDim.z) {
    evo_fwd_f32_slice(q, k, v, o, lse, e, bn);
    __syncwarp();
  }
}

__device__ __forceinline__ void
evo_dq_f32_slice(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ o,
           const float* __restrict__ dout, const float* __restrict__ lse,
           float* __restrict__ dq, float* __restrict__ delta, Evo e, int bn) {
  __shared__ __align__(16) float qs_all[F32_WARPS][MAX_D];
  __shared__ __align__(16) float ds_all[F32_WARPS][MAX_D];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i = blockIdx.x * F32_WARPS + warp;
  if (i >= e.L) return;
  const int h = blockIdx.y, L = e.L, D = e.D;
  const long stride = (long)e.H * D;
  const long head = (long)bn * L * stride + (long)h * D;
  const long rowoff = head + (long)i * stride;
  const long lrow = ((long)bn * e.H + h) * L + i;
  float* qs = qs_all[warp];
  float* dos = ds_all[warp];
  float part = 0.f;
  for (int d = lane; d < D; d += 32) {
    qs[d] = q[rowoff + d] * e.scale;
    dos[d] = dout[rowoff + d];
    part += dout[rowoff + d] * o[rowoff + d];
  }
  const float dl = warp_sum(part);
  if (lane == 0) delta[lrow] = dl;
  const float lse_r = lse[lrow];
  __syncwarp();

  float acc[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) acc[c] = 0.f;
  for (int c0 = 0; c0 < L; c0 += 32) {
    const int key = c0 + lane;
    float ds = 0.f;
    if (key < L) {
      const long koff = head + (long)key * stride;
      const float p = prob(biased(e, dot(qs, k + koff, D), bn, h, i, key),
                           lse_r);
      ds = p * (dot(dos, v + koff, D) - dl);
    }
    const int nk = min(32, L - c0);
    for (int cc = 0; cc < nk; ++cc) {
      const float dc = __shfl_sync(0xffffffffu, ds, cc);
      const float* krow = k + head + (long)(c0 + cc) * stride;
#pragma unroll
      for (int c = 0; c < NC; ++c)
        if (lane + 32 * c < D) acc[c] += dc * krow[lane + 32 * c];
    }
  }
#pragma unroll
  for (int c = 0; c < NC; ++c)
    if (lane + 32 * c < D) dq[rowoff + lane + 32 * c] = acc[c] * e.scale;
}

__global__ void __launch_bounds__(F32_WARPS * 32)
evo_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ o,
           const float* __restrict__ dout, const float* __restrict__ lse,
           float* __restrict__ dq, float* __restrict__ delta, Evo e) {
  for (int bn = blockIdx.z; bn < e.B * e.N; bn += gridDim.z) {
    evo_dq_f32_slice(q, k, v, o, dout, lse, dq, delta, e, bn);
    __syncwarp();
  }
}

__device__ __forceinline__ void
evo_dkv_f32_slice(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            float* __restrict__ dk, float* __restrict__ dv, void* db1,
            Evo e, int bn) {
  __shared__ __align__(16) float ks_all[F32_WARPS][MAX_D];
  __shared__ __align__(16) float vs_all[F32_WARPS][MAX_D];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int j = blockIdx.x * F32_WARPS + warp;   // this warp's key
  if (j >= e.L) return;
  const int L = e.L, D = e.D;
  const long stride = (long)e.H * D;
  float* ks = ks_all[warp];
  float* vs = vs_all[warp];
  float db1part = 0.f;

  for (int h = 0; h < e.H; ++h) {
    const long head = (long)bn * L * stride + (long)h * D;
    const long rowoff = head + (long)j * stride;
    __syncwarp();
    for (int d = lane; d < D; d += 32) {
      ks[d] = k[rowoff + d];
      vs[d] = v[rowoff + d];
    }
    __syncwarp();
    float dka[NC], dva[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) dka[c] = dva[c] = 0.f;
    for (int i0 = 0; i0 < L; i0 += 32) {
      const int i = i0 + lane;
      float p = 0.f, ds = 0.f;
      if (i < L) {
        const long qoff = head + (long)i * stride;
        const long lrow = ((long)bn * e.H + h) * L + i;
        float s = 0.f, dp = 0.f;
        for (int d = 0; d < D; ++d) {
          s += (q[qoff + d] * e.scale) * ks[d];
          dp += dout[qoff + d] * vs[d];
        }
        p = prob(biased(e, s, bn, h, i, j), lse[lrow]);
        ds = p * (dp - delta[lrow]);
      }
      db1part += ds;
      const int nq = min(32, L - i0);
      for (int cc = 0; cc < nq; ++cc) {
        const float pc = __shfl_sync(0xffffffffu, p, cc);
        const float dc = __shfl_sync(0xffffffffu, ds, cc);
        const long qoff = head + (long)(i0 + cc) * stride;
#pragma unroll
        for (int c = 0; c < NC; ++c)
          if (lane + 32 * c < D) {
            dva[c] += pc * dout[qoff + lane + 32 * c];
            dka[c] += dc * (q[qoff + lane + 32 * c] * e.scale);
          }
      }
    }
#pragma unroll
    for (int c = 0; c < NC; ++c)
      if (lane + 32 * c < D) {
        dk[rowoff + lane + 32 * c] = dka[c];
        dv[rowoff + lane + 32 * c] = dva[c];
      }
  }
  const float total = warp_sum(db1part);
  if (db1 != nullptr && lane == 0)
    st_any(db1, (long)bn * L + j, total, e.b1_bf16);
}

__global__ void __launch_bounds__(F32_WARPS * 32)
evo_dkv_f32(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            float* __restrict__ dk, float* __restrict__ dv, void* db1,
            Evo e) {
  for (int bn = blockIdx.y; bn < e.B * e.N; bn += gridDim.y) {
    evo_dkv_f32_slice(q, k, v, dout, lse, delta, dk, dv, db1, e, bn);
    __syncwarp();
  }
}

__device__ __forceinline__ void
evo_db2_f32_slice(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            void* db2, Evo e, int bh) {
  __shared__ __align__(16) float qs_all[F32_WARPS][MAX_D];
  __shared__ __align__(16) float ds_all[F32_WARPS][MAX_D];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i = blockIdx.x * F32_WARPS + warp;   // this warp's query
  if (i >= e.L) return;
  const int b = bh / e.H, h = bh % e.H;
  const int L = e.L, D = e.D;
  const long stride = (long)e.H * D;
  float* qs = qs_all[warp];
  float* dos = ds_all[warp];
  for (int c0 = 0; c0 < L; c0 += 32) {
    const int key = c0 + lane;
    float acc = 0.f;
    for (int n = 0; n < e.N; ++n) {
      const int bn = b * e.N + n;
      const long head = (long)bn * L * stride + (long)h * D;
      const long rowoff = head + (long)i * stride;
      const long lrow = ((long)bn * e.H + h) * L + i;
      __syncwarp();
      for (int d = lane; d < D; d += 32) {
        qs[d] = q[rowoff + d] * e.scale;
        dos[d] = dout[rowoff + d];
      }
      __syncwarp();
      if (key < L) {
        const long koff = head + (long)key * stride;
        const float p = prob(biased(e, dot(qs, k + koff, D), bn, h, i, key),
                             lse[lrow]);
        acc += p * (dot(dos, v + koff, D) - delta[lrow]);
      }
    }
    if (key < L) st_any(db2, ((long)bh * L + i) * L + key, acc, e.b2_bf16);
  }
}

__global__ void __launch_bounds__(F32_WARPS * 32)
evo_db2_f32(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            void* db2, Evo e) {
  for (int bh = blockIdx.y; bh < e.B * e.H; bh += gridDim.y) {
    evo_db2_f32_slice(q, k, v, dout, lse, delta, db2, e, bh);
    __syncwarp();
  }
}

// ---------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------
// B*N and B*H stay within int (the kernels' slice indices)
bool bad(const Evo& e, int dtype) {
  return e.B <= 0 || e.N <= 0 || e.L <= 0 || e.H <= 0 || e.D < 8 ||
         e.D > MAX_D || e.D % 8 || (long)e.B * e.N > 2147483647L ||
         (long)e.B * e.H > 2147483647L || (dtype != 0 && dtype != 1);
}

// D rounded up to the bf16 kernels' padded widths
int padded(int D) { return D <= 16 ? 16 : D <= 32 ? 32 : D <= 64 ? 64 : 128; }

template <typename K>
int set_smem(K kern, int bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

struct Ptrs {
  const void *q, *k, *v, *o, *dout, *lse;
  void *out, *lse_out, *dq, *dk, *dv, *delta, *dbias;
};

int tiles(int L) { return (L + TILE - 1) / TILE; }
// grid axes y and z stop at 65535: the kernels walk the B*N (B*H) slices
// with a grid-stride loop over that axis
int slices(int n) { return n < 65535 ? n : 65535; }
int f32_rows(int L) { return (L + F32_WARPS - 1) / F32_WARPS; }

template <int DP>
int fwd(const Ptrs& p, const Evo& e, int dtype, cudaStream_t st) {
  if (dtype == 1) {
    const int smem = mma_smem<DP>(1, 2, CHUNK);
    int err = set_smem(evo_fwd_mma<DP>, smem);
    if (err) return err;
    evo_fwd_mma<DP><<<dim3(tiles(e.L), e.H, slices(e.B * e.N)), THREADS,
                      smem, st>>>(
        (const bf16*)p.q, (const bf16*)p.k, (const bf16*)p.v, (bf16*)p.out,
        (float*)p.lse_out, e);
  } else {
    evo_fwd_f32<<<dim3(f32_rows(e.L), e.H, slices(e.B * e.N)),
                  F32_WARPS * 32, 0,
                  st>>>((const float*)p.q, (const float*)p.k,
                        (const float*)p.v, (float*)p.out, (float*)p.lse_out,
                        e);
  }
  return (int)cudaGetLastError();
}

template <int DP>
int dq(const Ptrs& p, const Evo& e, int dtype, cudaStream_t st) {
  if (dtype == 1) {
    const int smem = mma_smem<DP>(2, 2, CHUNK + 2 * TILE);
    int err = set_smem(evo_dq_mma<DP>, smem);
    if (err) return err;
    evo_dq_mma<DP><<<dim3(tiles(e.L), e.H, slices(e.B * e.N)), THREADS,
                     smem, st>>>(
        (const bf16*)p.q, (const bf16*)p.k, (const bf16*)p.v,
        (const bf16*)p.o, (const bf16*)p.dout, (const float*)p.lse,
        (bf16*)p.dq, (float*)p.delta, e);
  } else {
    evo_dq_f32<<<dim3(f32_rows(e.L), e.H, slices(e.B * e.N)),
                 F32_WARPS * 32, 0, st>>>((const float*)p.q, (const float*)p.k,
                       (const float*)p.v, (const float*)p.o,
                       (const float*)p.dout, (const float*)p.lse,
                       (float*)p.dq, (float*)p.delta, e);
  }
  return (int)cudaGetLastError();
}

template <int DP>
int dkv(const Ptrs& p, const Evo& e, int dtype, cudaStream_t st) {
  if (dtype == 1) {
    const int smem = mma_smem<DP>(4, 0, TILE * LDB + 2 * TILE);
    int err = set_smem(evo_dkv_mma<DP>, smem);
    if (err) return err;
    evo_dkv_mma<DP><<<dim3(tiles(e.L), slices(e.B * e.N)), THREADS, smem,
                      st>>>(
        (const bf16*)p.q, (const bf16*)p.k, (const bf16*)p.v,
        (const bf16*)p.dout, (const float*)p.lse, (const float*)p.delta,
        (bf16*)p.dk, (bf16*)p.dv, p.dbias, e);
  } else {
    evo_dkv_f32<<<dim3(f32_rows(e.L), slices(e.B * e.N)), F32_WARPS * 32, 0,
                  st>>>(
        (const float*)p.q, (const float*)p.k, (const float*)p.v,
        (const float*)p.dout, (const float*)p.lse, (const float*)p.delta,
        (float*)p.dk, (float*)p.dv, p.dbias, e);
  }
  return (int)cudaGetLastError();
}

template <int DP>
int db2(const Ptrs& p, const Evo& e, int dtype, cudaStream_t st) {
  if (dtype == 1) {
    const int smem = db2_smem<DP>();
    int err = set_smem(evo_db2_mma<DP>, smem);
    if (err) return err;
    evo_db2_mma<DP><<<dim3(tiles(e.L), tiles(e.L), slices(e.B * e.H)),
                      THREADS * db2_groups<DP>(), smem, st>>>(
        (const bf16*)p.q, (const bf16*)p.k, (const bf16*)p.v,
        (const bf16*)p.dout, (const float*)p.lse, (const float*)p.delta,
        p.dbias, e);
  } else {
    evo_db2_f32<<<dim3(f32_rows(e.L), slices(e.B * e.H)), F32_WARPS * 32, 0,
                  st>>>(
        (const float*)p.q, (const float*)p.k, (const float*)p.v,
        (const float*)p.dout, (const float*)p.lse, (const float*)p.delta,
        p.dbias, e);
  }
  return (int)cudaGetLastError();
}

// A bf16 tensor map of q, k, v, out or dO [B*N, L, H, D] (innermost first:
// D, H, L, B*N) whose box is `rows` rows of one head in RowTile<D> boxes;
// rows past L come back zero.
template <int D>
int row_map(CUtensorMap* map, const void* base, const Evo& e, int rows) {
  using T = hp::RowTile<D>;
  const uint64_t dims[4] = {(uint64_t)D, (uint64_t)e.H, (uint64_t)e.L,
                            (uint64_t)e.B * e.N};
  const uint64_t strides[3] = {(uint64_t)D * 2, (uint64_t)e.H * D * 2,
                               (uint64_t)e.L * e.H * D * 2};
  const uint32_t box[4] = {(uint32_t)T::CH, 1, (uint32_t)rows, 1};
  return hp::make_map_bf16(map, base, 4, dims, strides, box, T::SW);
}

// The pair bias [B, H, L, pitch] (innermost first: keys, queries, H, B;
// rows `pitch` elements apart) in 128-byte-swizzled boxes of COLS keys and
// `rows` queries; keys and queries past L come back zero.
template <int BK>
int bias_map(CUtensorMap* map, const Evo& e, int pitch, int rows) {
  if constexpr (BK == B2_NONE) {
    return 0;
  } else {
    const uint64_t es = BiasTile<BK>::ES, row = (uint64_t)pitch * es;
    const uint64_t dims[4] = {(uint64_t)e.L, (uint64_t)e.L, (uint64_t)e.H,
                              (uint64_t)e.B};
    const uint64_t strides[3] = {row, row * e.L, row * e.L * e.H};
    const uint32_t box[4] = {(uint32_t)BiasTile<BK>::COLS, (uint32_t)rows, 1,
                             1};
    return hp::make_map(map,
                        BK == B2_F32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                        e.b2, 4, dims, strides, box, hp::SW128);
  }
}

// The static shared memory the wgmma kernels add to their dynamic share.
constexpr int WG_STATIC_SMEM = 2048;

template <int D, int BK>
int dq_wgmma(const Ptrs& p, const Evo& e, int pitch, cudaStream_t st) {
  using W = EvoWg<D, BK>;
  static_assert(W::DQ_SMEM + WG_STATIC_SMEM <= SMEM_MAX, "dq smem");
  CUtensorMap qmap, kmap, vmap, dmap, bmap = {};
  int rc = row_map<D>(&qmap, p.q, e, ROWS);
  if (!rc) rc = row_map<D>(&dmap, p.dout, e, ROWS);
  if (!rc) rc = row_map<D>(&kmap, p.k, e, RT);
  if (!rc) rc = row_map<D>(&vmap, p.v, e, RT);
  if (!rc) rc = bias_map<BK>(&bmap, e, pitch, ROWS);
  if (rc) return rc;
  cudaError_t err = cudaFuncSetAttribute(
      evo_dq_wgmma<D, BK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      W::DQ_SMEM);
  if (err != cudaSuccess) return (int)err;
  evo_dq_wgmma<D, BK><<<dim3((e.L + ROWS - 1) / ROWS, e.H,
                                slices(e.B * e.N)),
                           WG_THREADS, W::DQ_SMEM, st>>>(
      qmap, kmap, vmap, dmap, bmap, (const bf16*)p.o, (const bf16*)p.dout,
      (const float*)p.lse, (bf16*)p.dq, (float*)p.delta, e);
  return (int)cudaGetLastError();
}

template <int D, int BK>
int dkv_wgmma(const Ptrs& p, const Evo& e, int pitch, cudaStream_t st) {
  using W = EvoWg<D, BK>;
  static_assert(W::DKV_SMEM + WG_STATIC_SMEM <= SMEM_MAX, "dk/dv smem");
  CUtensorMap qmap, kmap, vmap, dmap, bmap = {};
  int rc = row_map<D>(&qmap, p.q, e, RT);
  if (!rc) rc = row_map<D>(&dmap, p.dout, e, RT);
  if (!rc) rc = row_map<D>(&kmap, p.k, e, ROWS);
  if (!rc) rc = row_map<D>(&vmap, p.v, e, ROWS);
  if (!rc) rc = bias_map<BK>(&bmap, e, pitch, RT);
  if (rc) return rc;
  cudaError_t err = cudaFuncSetAttribute(
      evo_dkv_wgmma<D, BK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      W::DKV_SMEM);
  if (err != cudaSuccess) return (int)err;
  evo_dkv_wgmma<D, BK><<<dim3((e.L + ROWS - 1) / ROWS,
                                 slices(e.B * e.N)),
                            WG_THREADS, W::DKV_SMEM, st>>>(
      qmap, kmap, vmap, dmap, bmap, (const float*)p.lse,
      (const float*)p.delta, (bf16*)p.dk, (bf16*)p.dv, p.dbias, e);
  return (int)cudaGetLastError();
}

// The wgmma launcher F<D, BK> for the head dim and the pair bias's kind.
#define EVO_WG_BY_BIAS(F, D, ...)                                     \
  (e.b2 == nullptr ? F<D, B2_NONE>(__VA_ARGS__)                       \
   : e.b2_bf16     ? F<D, B2_BF16>(__VA_ARGS__)                       \
                   : F<D, B2_F32>(__VA_ARGS__))
#define EVO_WG(F, ...)                                                \
  (e.D == 32   ? EVO_WG_BY_BIAS(F, 32, __VA_ARGS__)                   \
   : e.D == 64 ? EVO_WG_BY_BIAS(F, 64, __VA_ARGS__)                   \
               : EVO_WG_BY_BIAS(F, 128, __VA_ARGS__))

// What the wgmma pair takes beyond `bad`: D 32, 64 or 128, bf16, H on the
// grid, and pair-bias rows `pitch` >= L elements apart that start on
// 16-byte boundaries (TMA's stride rule).
bool bad_wgmma(const Evo& e, int pitch) {
  const int es = e.b2_bf16 ? 2 : 4;
  return bad(e, 1) || (e.D != 32 && e.D != 64 && e.D != 128) ||
         e.H > 65535 ||
         (e.b2 != nullptr && (pitch < e.L || (long)pitch * es % 16));
}

// The launcher F<DP> for head dim D.
#define EVO_BY_D(D, F, ...)                     \
  (padded(D) == 16   ? F<16>(__VA_ARGS__)       \
   : padded(D) == 32 ? F<32>(__VA_ARGS__)       \
   : padded(D) == 64 ? F<64>(__VA_ARGS__)       \
                     : F<128>(__VA_ARGS__))

Evo make(const void* b1, const void* b2, int B, int N, int L, int H, int D,
         int bias_bf16, float scale) {
  return Evo{B, N, L, H, D, scale, b1, b2, bias_bf16 & 1,
             (bias_bf16 >> 1) & 1};
}

}  // namespace

// dtype of q/k/v (and out, dO, dq, dk, dv): 0 = float32, 1 = bfloat16.
// b1 / b2 may be null (absent); bias_bf16 bit 0 says b1 is bf16, bit 1 b2
// (else f32); db1 / db2 are written in their bias's dtype, and db1 null
// skips it.  Each returns cudaGetLastError() after its launch
// (cudaErrorInvalidValue for a shape, head dim or dtype it does not take).
extern "C" int dstt_evo_fwd(const void* q, const void* k, const void* v,
                            const void* b1, const void* b2, void* o,
                            void* lse, int B, int N, int L, int H, int D,
                            int bias_bf16, float scale, int dtype,
                            void* stream) {
  const Evo e = make(b1, b2, B, N, L, H, D, bias_bf16, scale);
  if (bad(e, dtype)) return (int)cudaErrorInvalidValue;
  Ptrs p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.out = o;
  p.lse_out = lse;
  return EVO_BY_D(D, fwd, p, e, dtype, static_cast<cudaStream_t>(stream));
}

extern "C" int dstt_evo_dq(const void* q, const void* k, const void* v,
                           const void* b1, const void* b2, const void* o,
                           const void* dout, const void* lse, void* dqo,
                           void* delta, int B, int N, int L, int H, int D,
                           int bias_bf16, float scale, int dtype,
                           void* stream) {
  const Evo e = make(b1, b2, B, N, L, H, D, bias_bf16, scale);
  if (bad(e, dtype)) return (int)cudaErrorInvalidValue;
  Ptrs p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.dout = dout;
  p.lse = lse;
  p.dq = dqo;
  p.delta = delta;
  return EVO_BY_D(D, dq, p, e, dtype, static_cast<cudaStream_t>(stream));
}

extern "C" int dstt_evo_dkv(const void* q, const void* k, const void* v,
                            const void* b1, const void* b2, const void* dout,
                            const void* lse, const void* delta, void* dko,
                            void* dvo, void* db1, int B, int N, int L, int H,
                            int D, int bias_bf16, float scale, int dtype,
                            void* stream) {
  const Evo e = make(b1, b2, B, N, L, H, D, bias_bf16, scale);
  if (bad(e, dtype) || (db1 != nullptr && b1 == nullptr))
    return (int)cudaErrorInvalidValue;
  Ptrs p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse = lse;
  p.delta = const_cast<void*>(delta);
  p.dk = dko;
  p.dv = dvo;
  p.dbias = db1;
  return EVO_BY_D(D, dkv, p, e, dtype, static_cast<cudaStream_t>(stream));
}

extern "C" int dstt_evo_db2(const void* q, const void* k, const void* v,
                            const void* b1, const void* b2, const void* dout,
                            const void* lse, const void* delta, void* db2o,
                            int B, int N, int L, int H, int D, int bias_bf16,
                            float scale, int dtype, void* stream) {
  const Evo e = make(b1, b2, B, N, L, H, D, bias_bf16, scale);
  if (bad(e, dtype) || b2 == nullptr) return (int)cudaErrorInvalidValue;
  Ptrs p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse = lse;
  p.delta = const_cast<void*>(delta);
  p.dbias = db2o;
  return EVO_BY_D(D, db2, p, e, dtype, static_cast<cudaStream_t>(stream));
}

// The bf16 TMA + wgmma pair (D 32, 64 or 128): `pitch` is the pair bias's
// row pitch in elements (L, or more for a padded copy whose rows start on
// 16-byte boundaries).  Otherwise as dstt_evo_dq / dstt_evo_dkv.
extern "C" int dstt_evo_dq_wgmma(const void* q, const void* k, const void* v,
                                 const void* b1, const void* b2,
                                 const void* o, const void* dout,
                                 const void* lse, void* dqo, void* delta,
                                 int B, int N, int L, int H, int D,
                                 int bias_bf16, float scale, int pitch,
                                 void* stream) {
  const Evo e = make(b1, b2, B, N, L, H, D, bias_bf16, scale);
  if (bad_wgmma(e, pitch)) return (int)cudaErrorInvalidValue;
  Ptrs p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.dout = dout;
  p.lse = lse;
  p.dq = dqo;
  p.delta = delta;
  return EVO_WG(dq_wgmma, p, e, pitch, static_cast<cudaStream_t>(stream));
}

extern "C" int dstt_evo_dkv_wgmma(const void* q, const void* k,
                                  const void* v, const void* b1,
                                  const void* b2, const void* dout,
                                  const void* lse, const void* delta,
                                  void* dko, void* dvo, void* db1, int B,
                                  int N, int L, int H, int D, int bias_bf16,
                                  float scale, int pitch, void* stream) {
  const Evo e = make(b1, b2, B, N, L, H, D, bias_bf16, scale);
  if (bad_wgmma(e, pitch) || (db1 != nullptr && b1 == nullptr))
    return (int)cudaErrorInvalidValue;
  Ptrs p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse = lse;
  p.delta = const_cast<void*>(delta);
  p.dk = dko;
  p.dv = dvo;
  p.dbias = db1;
  return EVO_WG(dkv_wgmma, p, e, pitch, static_cast<cudaStream_t>(stream));
}
