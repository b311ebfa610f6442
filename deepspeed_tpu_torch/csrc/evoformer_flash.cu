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
//   evo_db2_*: the pair-bias gradient `_bwd_db2_kernel` (:442).
// Each comes in variants (`ops.evoformer_flash.fwd_variant`, `bwd_variant`
// and `db2_variant` name the one inputs take): for bf16, TMA + wgmma at D
// 32, 64 and 128 (evo_fwd_wgmma, evo_dq_wgmma, evo_dkv_wgmma,
// evo_db2_wgmma) and mma.sync through registers at every other D
// (evo_fwd_rows, evo_dq_mma, evo_dkv_mma, evo_db2_split: D 8, the
// extra-MSA width, would run 4x padded on wgmma, whose products contract D
// in whole 16-column steps of a swizzled row); the CUDA cores for f32.  The
// first forward and db2 kernels (evo_fwd_mma, one CTA a row n; evo_db2_mma,
// one CTA walking every row) stay for L whose forward strip does not fit
// shared memory, for db2 at D <= 32 with few rows, and for timing
// (`variant="mma"`).
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
//   forward (evo_fwd_wgmma, evo_fwd_rows), grid (ceil(L/64), H, B *
//     groups): one CTA per 64-row query tile of one (b, h) walks `rows`
//     rows n (the host's `fwd_plan`: 4 at AlphaFold 2's shapes) with the
//     pair-bias strip [64 queries, L keys] resident in shared memory, in
//     b2's dtype (TMA boxes, loaded once a CTA: b2 does not depend on n),
//     and per row an online softmax over 64-key tiles in f32 (m, l and the
//     output in registers; P rounded to bf16 for P V); out and lse = m +
//     log(l) once a row.  Any L whose strip fits beside the kernel's tiles
//     (bf16 b2: L 1536 at D 32, 768 at D 128; f32 half that), for
//     evo_fwd_rows while two CTAs fit an SM (L 704 at D 8: at one it ran
//     1.6x the first kernel on an H100); past it,
//     evo_fwd_mma: one CTA per 64-row tile of one (row, head), K, V and b1
//     staged 256 keys at a time, the pair bias added from device memory;
//   dq (mma), grid (ceil(L/64), H, B*N): delta = rowsum(dO * O) of its
//     rows from out as stored (written to `delta` for the other two
//     kernels, which run after it on the stream), then K and V staged as
//     in the first forward, and per 16-key slice P = exp(s - lse), dP = dO
//     V^T, dS = P (dP - delta), dQ += dS K; dq = dQ * scale, written once;
//   dk/dv (mma), grid (ceil(L/64), B*N): one CTA per 64-key tile of a row
//     walks the heads and, for each, the 64-query tiles (Q, dO, lse, delta
//     and the pair-bias tile staged in shared memory): P^T and dS^T as
//     above, dV += P^T dO, dK += dS^T Q in f32 registers, written once per
//     head; with db1 asked for, each lane also sums dS over the heads and
//     queries of its two keys in a fixed order, and the four lanes of a
//     key add with two shuffles: db1 written once;
//   dq and dk/dv (wgmma): the same work and order of sums, warp-
//     specialised (see evo_dq_wgmma and evo_dkv_wgmma below);
//   db2 (evo_db2_wgmma, evo_db2_split), grid (ceil(L/64)^2 tiles, splits,
//     B*H): the N rows of each [64, 64] tile of one (b, h) are split over
//     `splits` CTAs (the host's `db2_plan`: one wave of resident CTAs),
//     each holding the pair-bias tile (TMA, b2's dtype) and summing dS
//     over its rows in order in f32 registers; each split stores its
//     partial, takes an integer ticket, and the CTA with the last ticket
//     adds the partials in split order, writes db2 once and sets the
//     ticket back to 0 (the paged kernels' merge).  evo_db2_mma: one CTA a
//     tile walking every row, G groups of four warps on rows n = g, g + G,
//     ... added in the order g = 0 .. G-1.  The reference CUTLASS kernel
//     sums with float atomics, whose order changes from run to run; here
//     nothing accumulates with atomics, so two runs give the same bits.
// The B*N (B*H, B*groups) axis of each grid stops at the 65535 limit of
// the y and z axes: each kernel is a grid-stride loop over its slices
// (`*_slice` is one slice's work), so any B*N is served.
//
// The bf16 mma forms (evo_fwd_rows, evo_db2_split, the first forward and
// db2, and dq and dk/dv where D is not 32, 64 or 128) run on the tensor
// cores (mma.sync m16n8k16, f32 accumulate): four warps of 16 rows, the
// tiles staged in shared memory as bf16 rows of DP + 8 elements (by
// cp.async a stage or more ahead in the new two), where DP is D rounded
// up to 16, 32, 64 or 128 and the columns past D are zero (D 8, the
// extra-MSA stack's width, runs as 16);
// P and dS are rounded to bf16 and reused from the accumulator registers
// as the A operand.  f32 runs on the CUDA cores with exact f32 products:
// one warp per query row (key row in dk/dv), a lane per key (query) of a
// 32-wide chunk for the scores and the D columns over the lanes for the
// products.
//
// What bounds it on the H100 at AlphaFold 2's MSA row attention (q/k/v
// [1, 128, 256, 8, 32] bf16): bytes.  The forward moves ~69 MB (0.021 ms
// at 3.35 TB/s) against 8.6 GFLOP (0.009 ms at 989 TFLOP/s); dq and dk/dv
// each ~0.031 ms of bytes, db2 0.021.  The first forward and db2 kernels
// ran at ~8x that (0.161 and 0.190 ms on an H100 80GB HBM3 at 700 W,
// PERF.md): many small CTAs staging operands with no copy/compute overlap,
// the pair bias re-read from L2 by every row n (128 MB at the MSA row
// against a 69 MB bound) in 2-byte loads, and db2's 128 CTAs walking all N
// rows (less than one wave).  The new forward keeps the bias strip in
// shared memory (read from L2 N / 4 times, not N times), streams K and V
// by TMA behind the products and overlaps each tile's softmax with the
// previous tile's P V; db2 fills the card by splitting rows and streams
// each row's Q, dO, K and V by TMA.  What holds both at ~3.5x their
// bounds (0.072 ms each on that card) is each 64 x 64 tile's chain of
// products, exponentials and bias reads per row with two to three CTAs an
// SM: the scores' instructions (~8 a score, ~0.02 ms at the MSA row) and
// their latency, not bytes.  At the extra-MSA row (D 8, 537 M scores) the
// issue rate alone costs ~0.15 ms a kernel; the mma.sync forward and db2
// read ~0.60 and ~0.50 ms there.  The wgmma dq and dk/dv pair streams every
// operand by TMA behind the products (a producer warp and an mbarrier
// ring), keeps the pair-bias tile in bf16 or f32 as given and runs two
// (dk/dv) or three (dq) CTAs an SM.
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
// bf16: db2 split over the N rows, and the forward walking rows n with the
// pair bias resident (TMA + wgmma at D 32, 64 and 128; mma.sync with
// cp.async stages at every other D)
// ---------------------------------------------------------------------
using dstt::cp_async16;
using dstt::cp_async_commit;
using dstt::cp_async_wait;

// -lse log2(e) of a row as the new kernels take P = 2^(x log2(e) - lse
// log2(e)) in one FMA and ex2: -inf where lse is at or below the mask
// level (a row masked everywhere: every P is 0, as the re-mask of each
// score gives) or +inf (rows past L).  A masked key (x near -1e30) of any
// other row gives 2^(-1.4e30) = 0 by itself.
__device__ __forceinline__ float neg_lse2(float lse) {
  return lse > NEG_INF * 0.5f ? -lse * LOG2E : -INFINITY;
}

__device__ __forceinline__ float p_of(float x, float nl2) {
  return hp::ex2(fmaf(x, LOG2E, nl2));
}

// Where a db2 tile's splits meet: each split's f32 partial [units][splits]
// [32][128] (thread-major), and one zeroed int ticket a unit (a [64, 64]
// tile of one (b, h)), left zeroed.
struct Split {
  float* ws;
  int* tickets;
  int splits;
};

// The first row of split s of N rows over `splits` (split s walks
// [split_row(s), split_row(s + 1))).
__device__ __forceinline__ int split_row(int s, int N, int splits) {
  return (int)((long)s * N / splits);
}

// A group of the forward's rows: CTA z of the B*groups slices walks rows
// [g * rows, min(N, (g + 1) * rows)) of batch z / groups, g = z % groups.
struct Rows {
  int rows, groups;
};

// Thread tid's 32 db2 accumulators of a [64 query, 64 key] tile (element
// i: row 16 (tid / 32) + g + 8 ((i >> 1) & 1), key 8 (i >> 2) + 2 t +
// (i & 1), the m16n8 C layout of each warp, which wgmma's m64n64 shares)
// into db2 [B*H, L, L] in b2's dtype.  With several splits, each CTA
// stores its partial thread-major, takes a ticket, and the CTA with the
// last ticket adds the partials in split order 0 .. splits-1 (its own
// from registers) and sets the ticket back to 0.  The 128 threads meet at
// named barrier `bar`.
__device__ __forceinline__ void db2_finish(float (&acc)[32], const Evo& e,
                                           void* db2, const Split& sp,
                                           int split, long unit, int bh,
                                           int q0, int k0, int tid,
                                           int bar) {
  __shared__ int last;
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int rl = 16 * (tid >> 5) + g;
  if (sp.splits > 1) {
    float* part = sp.ws + (unit * sp.splits + split) * 4096;
#pragma unroll
    for (int i = 0; i < 32; ++i) part[i * 128 + tid] = acc[i];
    __threadfence();
    hp::named_sync(bar, 128);
    if (tid == 0) last = atomicAdd(sp.tickets + unit, 1) == sp.splits - 1;
    hp::named_sync(bar, 128);
    if (!last) return;
    __threadfence();
    const float* base = sp.ws + unit * sp.splits * 4096;
    float tot[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) tot[i] = 0.f;
    for (int s = 0; s < sp.splits; ++s)
#pragma unroll
      for (int i = 0; i < 32; ++i)
        tot[i] += s == split ? acc[i] : __ldcg(base + s * 4096 + i * 128 + tid);
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = tot[i];
  }
  const int L = e.L;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int row = q0 + rl + 8 * ((i >> 1) & 1);
    const int key = k0 + hp::acc_col(i, t);
    if (row < L && key < L)
      st_any(db2, ((long)bh * L + row) * L + key, acc[i], e.b2_bf16);
  }
  if (sp.splits > 1 && tid == 0) sp.tickets[unit] = 0;   // for the next call
}

// CTAs an SM each kernel's registers are sized for (the launch bound
// caps every thread's registers; fewer spill at these).
template <int D>
constexpr int db2_blocks() {
  return D == 128 ? 1 : 2;
}

template <int DP>
constexpr int db2_split_blocks() {
  return DP == 16 ? 4 : 2;
}

// db2 (TMA + wgmma, D 32, 64, 128), grid (query tiles x key tiles, splits,
// B*H slices): one CTA per [64 query, 64 key] tile of one (b, h) and one
// split of the N rows.  The producer warp (after the consumers) loads the
// pair-bias tile once (TMA, in b2's dtype) and streams each row's Q and dO
// (the query tile) and K and V (the key tile) boxes through a WS-slot
// ring, its lanes staging the row's lse and delta (+inf and 0 past L) and
// b1 (-1e30 past L) a row ahead.  The consumer warpgroup: S = Q K^T and
// dP = dO V^T (wgmma m64n64; the two accumulators share one register
// layout), acc += P (dP - delta), P = exp(S scale + b1 + b2 - lse), in f32
// registers; then `db2_finish`.
template <int D, int BK>
__global__ void __launch_bounds__(WG_THREADS, db2_blocks<D>())
evo_db2_wgmma(const __grid_constant__ CUtensorMap qmap,
              const __grid_constant__ CUtensorMap kmap,
              const __grid_constant__ CUtensorMap vmap,
              const __grid_constant__ CUtensorMap dmap,
              const __grid_constant__ CUtensorMap bmap,
              const float* __restrict__ lse, const float* __restrict__ delta,
              void* db2, Split sp, Evo e) {
  using T = hp::RowTile<D>;
  constexpr int OWN = ROWS * D * 2;   // one of Q, dO, K, V
  constexpr int SLOT = 4 * OWN;
  constexpr int BIAS = BiasTile<BK>::bytes(ROWS, ROWS);
  extern __shared__ __align__(1024) uint8_t smem_tma[];
  uint8_t* Bs = hp::align1024(smem_tma);
  uint8_t* ring = Bs + BIAS;   // slot s: Q, dO, K, V
  __shared__ __align__(16) float lse_s[WS][RT], dl_s[WS][RT], b1_s[WS][RT];
  __shared__ __align__(8) uint64_t b_full, full[WS], empty[WS];
  const int L = e.L, H = e.H, N = e.N;
  const int nkt = (L + ROWS - 1) / ROWS, tile = blockIdx.x;
  const int q0 = tile / nkt * ROWS, k0 = tile % nkt * ROWS;
  const int split = blockIdx.y;
  const int n0 = split_row(split, N, sp.splits);
  const int nr = split_row(split + 1, N, sp.splits) - n0;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    hp::mbar_init(&b_full, 1);
    for (int s = 0; s < WS; ++s) {
      hp::mbar_init(&full[s], 1 + 32);   // expect_tx + the warp's lanes
      hp::mbar_init(&empty[s], 4);       // one arrival a consumer warp
    }
    hp::mbar_fence_init();
  }
  __syncthreads();

  for (int bh = blockIdx.z, it = 0; bh < e.B * H; bh += gridDim.z, ++it) {
    const int b = bh / H, h = bh % H;
    const int j0 = it * nr;
    if (warp == 4) {   // the producer warp
      float nl[RT / 32], nd[RT / 32], nb[RT / 32];
      auto fetch = [&](int j) {
        const int bn = b * N + n0 + j;
        const long base = ((long)bn * H + h) * L;
#pragma unroll
        for (int i = 0; i < RT / 32; ++i) {
          const int row = q0 + lane + 32 * i, key = k0 + lane + 32 * i;
          nl[i] = row < L ? lse[base + row] : INFINITY;
          nd[i] = row < L ? delta[base + row] : 0.f;
          nb[i] = key >= L ? NEG_INF
                  : e.b1   ? ld_any(e.b1, (long)bn * L + key, e.b1_bf16)
                           : 0.f;
        }
      };
      if (lane == 0) {
        constexpr int COLS = BiasTile<BK>::COLS;
        hp::mbar_expect_tx(&b_full, BIAS);
        for (int c = 0; c < ROWS / COLS; ++c)
          hp::tma_load_4d(Bs + c * ROWS * 128, &bmap, &b_full,
                          k0 + c * COLS, q0, h, b);
      }
      if (nr > 0) fetch(0);
      for (int j = 0; j < nr; ++j) {
        const int jc = j0 + j, s = jc % WS, bn = b * N + n0 + j;
        uint8_t* Qs = ring + s * SLOT;
        hp::mbar_wait(&empty[s], ((jc / WS) & 1) ^ 1);
        if (lane == 0) {
          hp::mbar_expect_tx(&full[s], SLOT);
          for (int c = 0; c < T::NCH; ++c) {
            const int off = c * ROWS * T::RB;
            hp::tma_load_4d(Qs + off, &qmap, &full[s], c * T::CH, h, q0, bn);
            hp::tma_load_4d(Qs + OWN + off, &dmap, &full[s], c * T::CH, h,
                            q0, bn);
            hp::tma_load_4d(Qs + 2 * OWN + off, &kmap, &full[s], c * T::CH,
                            h, k0, bn);
            hp::tma_load_4d(Qs + 3 * OWN + off, &vmap, &full[s], c * T::CH,
                            h, k0, bn);
          }
        }
#pragma unroll
        for (int i = 0; i < RT / 32; ++i) {
          lse_s[s][lane + 32 * i] = nl[i];
          dl_s[s][lane + 32 * i] = nd[i];
          b1_s[s][lane + 32 * i] = nb[i];
        }
        hp::mbar_arrive(&full[s]);
        if (j + 1 < nr) fetch(j + 1);
      }
    } else {
      const int g = lane >> 2, t = lane & 3;
      const int rl = 16 * warp + g;   // query rows q0 + rl, + 8
      float acc[32], sc[32], dp[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = 0.f;
      hp::mbar_wait(&b_full, it & 1);
      for (int j = 0; j < nr; ++j) {
        const int jc = j0 + j, s = jc % WS;
        const uint8_t* Qs = ring + s * SLOT;
        hp::mbar_wait(&full[s], (jc / WS) & 1);
        hp::wgmma_fence();
        hp::issue_abt<D, RT>(sc, Qs, ROWS, Qs + 2 * OWN);
        hp::wgmma_commit();
        hp::issue_abt<D, RT>(dp, Qs + OWN, ROWS, Qs + 3 * OWN);
        hp::wgmma_commit();
        const float nl[2] = {neg_lse2(lse_s[s][rl]),
                             neg_lse2(lse_s[s][rl + 8])};
        const float dr[2] = {dl_s[s][rl], dl_s[s][rl + 8]};
        hp::wgmma_wait<1>();
        hp::fence_regs(sc);
#pragma unroll
        for (int i = 0; i < 32; i += 2) {
          const int col = hp::acc_col(i, t), hh = (i >> 1) & 1;
          const float2 b1p = *reinterpret_cast<const float2*>(&b1_s[s][col]);
          float x0 = sc[i] * e.scale + b1p.x;
          float x1 = sc[i + 1] * e.scale + b1p.y;
          if constexpr (BK != B2_NONE) {
            const float2 bb = bias2<BK>(Bs, bias_at<BK>(rl + 8 * hh, col,
                                                        ROWS));
            x0 += bb.x;
            x1 += bb.y;
          }
          sc[i] = p_of(x0, nl[hh]);
          sc[i + 1] = p_of(x1, nl[hh]);
        }
        hp::wgmma_wait<0>();
        hp::fence_regs(dp);
#pragma unroll
        for (int i = 0; i < 32; ++i)
          acc[i] += sc[i] * (dp[i] - dr[(i >> 1) & 1]);
        __syncwarp();
        if (lane == 0) hp::mbar_arrive(&empty[s]);
      }
      const long tiles = (long)nkt * nkt;
      db2_finish(acc, e, db2, sp, split, bh * tiles + tile, bh, q0, k0, tid,
                 1);
    }
    __syncthreads();   // the bias tile and the ring are free for the next
  }
}

// The mma.sync kernels' staged rows: bf16 tiles of TILE rows and DP + 8
// columns (DP: D padded to 16, 32, 64 or 128; zero past D and past L), in
// stages that land behind the stages before them: three for db2 (a
// stage's copies behind two rows of work), two for the forward (whose
// pair-bias strip leaves room for four CTAs an SM at D 8 only so, which
// beat three stages at three CTAs an SM on an H100).
constexpr int MMA_STAGES = 3;
constexpr int FWD_STAGES = 2;

template <int DP>
struct MmaRows {
  static constexpr int LD = DP + 8;
  static constexpr int TILEB = TILE * LD * 2;
  // db2: one row's Q, dO, K, V, then lse, delta and b1 (f32)
  static constexpr int DB2_STAGE = 4 * TILEB + 3 * TILE * 4;
  // the forward: a key tile's K and V, then its b1 (f32)
  static constexpr int FWD_STAGE = 2 * TILEB + TILE * 4;
};

// `rows` rows [pos0, pos0 + rows) of one head of x [B*N, L, H, D] into a
// shared tile of LD bf16 a row by 16-byte cp.async copies (zeros past
// row L and column D), shared by the CTA's THREADS threads.
template <int DP>
__device__ __forceinline__ void stage_async(bf16* dst, const bf16* x,
                                            long head, long stride, int pos0,
                                            int L, int D, int tid) {
  constexpr int NV = DP / 8;
  for (int i = tid; i < TILE * NV; i += THREADS) {
    const int row = i / NV, c = (i % NV) * 8, pos = pos0 + row;
    const bool ok = pos < L && c < D;
    cp_async16(dst + row * MmaRows<DP>::LD + c,
               ok ? x + head + (long)pos * stride + c : x, ok);
  }
}

// db2 (mma.sync, every bf16 D), grid as evo_db2_wgmma's: four warps of 16 query
// rows.  Thread 0 loads the pair-bias tile once a slice (TMA, in b2's dtype);
// each row's Q, dO, K and V are staged MMA_STAGES - 1 rows ahead by cp.async,
// its lse, delta and b1 read into registers as its copies are issued and stored
// after the current row's products.  Per row S = Q K^T and dP = dO V^T through
// mma.sync, acc += P (dP - delta) in f32 registers; then `db2_finish`.
template <int DP, int BK>
__global__ void __launch_bounds__(THREADS, db2_split_blocks<DP>())
evo_db2_split(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const bf16* __restrict__ dout,
              const __grid_constant__ CUtensorMap bmap,
              const float* __restrict__ lse, const float* __restrict__ delta,
              void* db2, Split sp, Evo e) {
  using M = MmaRows<DP>;
  constexpr int LD = M::LD;
  constexpr int BIAS = BiasTile<BK>::bytes(TILE, TILE);
  extern __shared__ __align__(1024) uint8_t smem_tma[];
  uint8_t* Bs = hp::align1024(smem_tma);
  uint8_t* stages = Bs + BIAS;
  __shared__ __align__(8) uint64_t b_full;
  const int L = e.L, D = e.D, H = e.H, N = e.N;
  const int nkt = (L + TILE - 1) / TILE, tile = blockIdx.x;
  const int q0 = tile / nkt * TILE, k0 = tile % nkt * TILE;
  const int split = blockIdx.y;
  const int n0 = split_row(split, N, sp.splits);
  const int nr = split_row(split + 1, N, sp.splits) - n0;
  const int tid = threadIdx.x, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = (tid >> 5) * 16 + g;   // query rows q0 + r0, + 8
  const long stride = (long)H * D;
  if (tid == 0) {
    hp::mbar_init(&b_full, 1);
    hp::mbar_fence_init();
  }
  __syncthreads();

  for (int bh = blockIdx.z, it = 0; bh < e.B * H; bh += gridDim.z, ++it) {
    const int b = bh / H, h = bh % H;
    if (tid == 0) {
      constexpr int COLS = BiasTile<BK>::COLS;
      hp::mbar_expect_tx(&b_full, BIAS);
      for (int c = 0; c < TILE / COLS; ++c)
        hp::tma_load_4d(Bs + c * TILE * 128, &bmap, &b_full, k0 + c * COLS,
                        q0, h, b);
    }
    auto stage = [&](int u) { return stages + u * M::DB2_STAGE; };
    auto issue = [&](int j, int u) {
      const long head = (long)(b * N + n0 + j) * L * stride + (long)h * D;
      bf16* x = reinterpret_cast<bf16*>(stage(u));
      stage_async<DP>(x, q, head, stride, q0, L, D, tid);
      stage_async<DP>(x + TILE * LD, dout, head, stride, q0, L, D, tid);
      stage_async<DP>(x + 2 * TILE * LD, k, head, stride, k0, L, D, tid);
      stage_async<DP>(x + 3 * TILE * LD, v, head, stride, k0, L, D, tid);
      cp_async_commit();
    };
    // threads 0-63: lse and delta of query q0 + tid; 64-127: b1 of key
    // k0 + tid - 64 (-1e30 past L)
    auto fetch = [&](int j) {
      const int bn = b * N + n0 + j;
      float2 r = make_float2(0.f, 0.f);
      if (tid < TILE) {
        const int row = q0 + tid;
        const long li = ((long)bn * H + h) * L + row;
        r = row < L ? make_float2(lse[li], delta[li])
                    : make_float2(INFINITY, 0.f);
      } else {
        const int key = k0 + tid - TILE;
        r.x = key >= L ? NEG_INF
              : e.b1   ? ld_any(e.b1, (long)bn * L + key, e.b1_bf16)
                       : 0.f;
      }
      return r;
    };
    auto put = [&](int u, float2 r) {
      float* f = reinterpret_cast<float*>(stage(u) + 4 * M::TILEB);
      if (tid < TILE) {
        f[tid] = r.x;
        f[TILE + tid] = r.y;
      } else {
        f[2 * TILE + tid - TILE] = r.x;
      }
    };
    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    // one commit group a stage (empty past the last row), so the wait for
    // row j always leaves the next MMA_STAGES - 1 in flight
    for (int j = 0; j < MMA_STAGES - 1; ++j) {
      if (j < nr) {
        issue(j, j);
        put(j, fetch(j));
      } else {
        cp_async_commit();
      }
    }
    for (int j = 0; j < nr; ++j) {
      const int u = j % MMA_STAGES, jn = j + MMA_STAGES - 1;
      float2 nx = make_float2(0.f, 0.f);
      if (jn < nr) {
        issue(jn, jn % MMA_STAGES);
        nx = fetch(jn);
      } else {
        cp_async_commit();
      }
      cp_async_wait<MMA_STAGES - 1>();
      __syncthreads();   // stage u has landed for every thread
      if (j == 0) hp::mbar_wait(&b_full, it & 1);
      const bf16* Qs = reinterpret_cast<const bf16*>(stage(u));
      const bf16* dOs = Qs + TILE * LD;
      const bf16* Ks = dOs + TILE * LD;
      const bf16* Vs = Ks + TILE * LD;
      const float* lse_s = reinterpret_cast<const float*>(Vs + TILE * LD);
      const float* dl_s = lse_s + TILE;
      const float* b1_s = dl_s + TILE;
      const float nl[2] = {neg_lse2(lse_s[r0]), neg_lse2(lse_s[r0 + 8])};
      const float dr[2] = {dl_s[r0], dl_s[r0 + 8]};
#pragma unroll
      for (int kc = 0; kc < TILE; kc += 16) {
        float s[2][4], dp[2][4];
        zero16(s);
        zero16(dp);
        mma_abt<DP>(s, Qs, Ks, LD, r0, kc, g, t);
        mma_abt<DP>(dp, dOs, Vs, LD, r0, kc, g, t);
#pragma unroll
        for (int jj = 0; jj < 2; ++jj)
#pragma unroll
          for (int c = 0; c < 4; c += 2) {
            const int hh = c >> 1, kl = kc + 8 * jj + 2 * t;
            const float2 b1p = *reinterpret_cast<const float2*>(b1_s + kl);
            float x0 = s[jj][c] * e.scale + b1p.x;
            float x1 = s[jj][c + 1] * e.scale + b1p.y;
            if constexpr (BK != B2_NONE) {
              const float2 bb =
                  bias2<BK>(Bs, bias_at<BK>(r0 + 8 * hh, kl, TILE));
              x0 += bb.x;
              x1 += bb.y;
            }
            float* a = acc + (kc / 8 + jj) * 4 + c;
            a[0] += p_of(x0, nl[hh]) * (dp[jj][c] - dr[hh]);
            a[1] += p_of(x1, nl[hh]) * (dp[jj][c + 1] - dr[hh]);
          }
      }
      if (jn < nr) put(jn % MMA_STAGES, nx);
      __syncthreads();   // stage u is read: a later row may land there
    }
    if (nr == 0) hp::mbar_wait(&b_full, it & 1);   // the tile has landed
    const long tiles = (long)nkt * nkt;
    db2_finish(acc, e, db2, sp, split, bh * tiles + tile, bh, q0, k0, tid, 1);
    __syncthreads();   // the bias tile is free for the next slice
  }
}

// The pair-bias strip [64 queries, every key tile] as the forward keeps
// it: ceil(L / 64) * 64 keys in 128-byte boxes of BiasTile<BK>::COLS.
template <int BK>
__host__ __device__ constexpr int strip_bytes(int L) {
  return BiasTile<BK>::bytes(TILE, (L + TILE - 1) / TILE * TILE);
}

// thread 0: the strip of query tile q0 of (b, h) by TMA, on `bar`
template <int BK>
__device__ __forceinline__ void load_strip(uint8_t* strip,
                                           const CUtensorMap* bmap,
                                           uint64_t* bar, int L, int q0,
                                           int h, int b) {
  if constexpr (BK != B2_NONE) {
    constexpr int COLS = BiasTile<BK>::COLS;
    hp::mbar_expect_tx(bar, strip_bytes<BK>(L));
    for (int c = 0; c < (L + TILE - 1) / TILE * TILE / COLS; ++c)
      hp::tma_load_4d(strip + c * TILE * 128, bmap, bar, c * COLS, q0, h, b);
  } else {
    hp::mbar_arrive(bar);
  }
}

template <int D>
constexpr int fwd_blocks() {
  return D == 32 ? 3 : D == 64 ? 2 : 1;
}

// The forward's online softmax step for one lane's two rows (hh) over a
// tile's scores x (natural units, 0 .. n - 1 in the m16n8 C layout, x[i]
// of row hh = (i >> 1) & 1): the running max m from -1e30, alpha =
// exp(m_old - m_new) for l and the output, p = exp(x - m) in place (0 for
// a masked key, and for every key while m is at the mask level), l += p.
template <int NX>
__device__ __forceinline__ void online_softmax(float (&x)[NX], float (&m)[2],
                                               float (&l)[2],
                                               float (&alpha)[2]) {
  float tmax[2] = {NEG_INF, NEG_INF};
#pragma unroll
  for (int i = 0; i < NX; ++i)
    tmax[(i >> 1) & 1] = fmaxf(tmax[(i >> 1) & 1], x[i]);
  float nm[2];   // -m log2(e), -inf while every key so far is masked
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    tmax[hh] = fmaxf(tmax[hh], __shfl_xor_sync(0xffffffffu, tmax[hh], 1));
    tmax[hh] = fmaxf(tmax[hh], __shfl_xor_sync(0xffffffffu, tmax[hh], 2));
    const float m_new = fmaxf(m[hh], tmax[hh]);
    alpha[hh] = hp::ex2((m[hh] - m_new) * LOG2E);
    m[hh] = m_new;
    l[hh] *= alpha[hh];
    nm[hh] = neg_lse2(m_new);
  }
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    x[i] = p_of(x[i], nm[(i >> 1) & 1]);
    l[(i >> 1) & 1] += x[i];
  }
}

// out row and lse of a lane's two rows once a row n is done: l summed
// over the row's four lanes, out = acc / max(l, 1e-9) in bf16 (columns
// 8 n + 2 t, + 1 of acc[4 n + 2 hh], [4 n + 2 hh + 1]; those < D), lse = m
// + log(max(l, 1e-9)).
template <int NACC>
__device__ __forceinline__ void write_row(const float (&acc)[NACC],
                                          const float (&m)[2], float (&l)[2],
                                          const Evo& e, bf16* o, float* lse,
                                          int bn, int h, int row0, int t) {
  const int L = e.L, D = e.D;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
    const int row = row0 + 8 * hh;
    if (row >= L) continue;
    const float lsafe = fmaxf(l[hh], 1e-9f);
    const float inv = 1.f / lsafe;
    bf16* orow = o + (((long)bn * L + row) * e.H + h) * D;
#pragma unroll
    for (int n = 0; n < NACC / 4; ++n)
      if (n * 8 < D)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n + 2 * t) =
            __floats2bfloat162_rn(acc[4 * n + 2 * hh] * inv,
                                  acc[4 * n + 2 * hh + 1] * inv);
    if (t == 0) lse[((long)bn * e.H + h) * L + row] = m[hh] + logf(lsafe);
  }
}

// The forward (TMA + wgmma, D 32, 64, 128), grid (query tiles, H, B *
// groups slices): one CTA per 64 query rows of one (b, h) walks the rows
// n of its group (`Rows`) with the pair-bias strip [64 queries, L keys]
// resident (TMA boxes in b2's dtype, loaded once a slice: the bias is the
// same for every row n).  The producer warp loads each row's Q box (two
// buffers, so the next row's arrives during this one) and streams its
// 64-key K and V boxes through a WS-slot ring, its lanes staging each key
// tile's b1 (-1e30 past L) a tile ahead.  The consumer warpgroup: S = Q
// K^T (wgmma), s scale + b1 + b2, the online softmax in f32 (m, l), P
// rounded to bf16 as the register A operand of O += P V; out and lse
// once a row.
template <int D, int BK>
__global__ void __launch_bounds__(WG_THREADS, fwd_blocks<D>())
evo_fwd_wgmma(const __grid_constant__ CUtensorMap qmap,
              const __grid_constant__ CUtensorMap kmap,
              const __grid_constant__ CUtensorMap vmap,
              const __grid_constant__ CUtensorMap bmap, bf16* __restrict__ o,
              float* __restrict__ lse, Rows rw, Evo e) {
  using T = hp::RowTile<D>;
  constexpr int OWN = ROWS * D * 2;   // Q, K or V
  constexpr int SLOT = 2 * OWN;
  extern __shared__ __align__(1024) uint8_t smem_tma[];
  uint8_t* Qb = hp::align1024(smem_tma);   // buffer u: Q
  uint8_t* ring = Qb + 2 * OWN;            // slot s: K, V
  uint8_t* strip = ring + WS * SLOT;
  __shared__ __align__(16) float b1_s[WS][RT];
  __shared__ __align__(8) uint64_t b_full, q_full[2], q_empty[2], full[WS],
      empty[WS];
  const int L = e.L, H = e.H, N = e.N;
  const int q0 = blockIdx.x * ROWS, h = blockIdx.y;
  const int nkt = (L + RT - 1) / RT;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    hp::mbar_init(&b_full, 1);
    for (int u = 0; u < 2; ++u) {
      hp::mbar_init(&q_full[u], 1);
      hp::mbar_init(&q_empty[u], 4);
    }
    for (int s = 0; s < WS; ++s) {
      hp::mbar_init(&full[s], 1 + 32);
      hp::mbar_init(&empty[s], 4);
    }
    hp::mbar_fence_init();
  }
  __syncthreads();

  // rows and key tiles are counted alike by both roles across slices
  int rc = 0, jc = 0;
  for (int z = blockIdx.z, it = 0; z < e.B * rw.groups;
       z += gridDim.z, ++it) {
    const int b = z / rw.groups, n0 = z % rw.groups * rw.rows;
    const int nr = min(N - n0, rw.rows);
    if (warp == 4) {   // the producer warp
      if (lane == 0) load_strip<BK>(strip, &bmap, &b_full, L, q0, h, b);
      float nb[RT / 32];
      auto fetch = [&](int bn, int kt) {
#pragma unroll
        for (int i = 0; i < RT / 32; ++i) {
          const int key = kt * RT + lane + 32 * i;
          nb[i] = key >= L ? NEG_INF
                  : e.b1   ? ld_any(e.b1, (long)bn * L + key, e.b1_bf16)
                           : 0.f;
        }
      };
      if (nr > 0) fetch(b * N + n0, 0);
      for (int r = 0; r < nr; ++r, ++rc) {
        const int bn = b * N + n0 + r, u = rc & 1;
        if (lane == 0) {
          hp::mbar_wait(&q_empty[u], ((rc >> 1) & 1) ^ 1);
          hp::mbar_expect_tx(&q_full[u], OWN);
          for (int c = 0; c < T::NCH; ++c)
            hp::tma_load_4d(Qb + u * OWN + c * ROWS * T::RB, &qmap,
                            &q_full[u], c * T::CH, h, q0, bn);
        }
        __syncwarp();
        for (int kt = 0; kt < nkt; ++kt, ++jc) {
          const int s = jc % WS;
          uint8_t* Ks = ring + s * SLOT;
          hp::mbar_wait(&empty[s], ((jc / WS) & 1) ^ 1);
          if (lane == 0) {
            hp::mbar_expect_tx(&full[s], SLOT);
            for (int c = 0; c < T::NCH; ++c) {
              hp::tma_load_4d(Ks + c * RT * T::RB, &kmap, &full[s],
                              c * T::CH, h, kt * RT, bn);
              hp::tma_load_4d(Ks + OWN + c * RT * T::RB, &vmap, &full[s],
                              c * T::CH, h, kt * RT, bn);
            }
          }
#pragma unroll
          for (int i = 0; i < RT / 32; ++i) b1_s[s][lane + 32 * i] = nb[i];
          hp::mbar_arrive(&full[s]);
          if (kt + 1 < nkt)
            fetch(bn, kt + 1);
          else if (r + 1 < nr)
            fetch(bn + 1, 0);
        }
      }
    } else {
      const int g = lane >> 2, t = lane & 3;
      const int rl = 16 * warp + g;   // rows q0 + rl, + 8
      float oacc[D / 2], sc[32], m[2], l[2], alpha[2];
      uint32_t pa[4][4];
      // S of key tile kt in flight, then the scores s scale + b1 + b2 (in
      // that order) and the online softmax once it lands
      auto issue_s = [&](const uint8_t* Qs, int s) {
        hp::mbar_wait(&full[s], (jc / WS) & 1);
        hp::wgmma_fence();
        hp::issue_abt<D, RT>(sc, Qs, ROWS, ring + s * SLOT);
        hp::wgmma_commit();
      };
      auto softmax = [&](int s, int kt) {
        hp::fence_regs(sc);
#pragma unroll
        for (int i = 0; i < 32; i += 2) {
          const int col = hp::acc_col(i, t), hh = (i >> 1) & 1;
          const float2 b1p = *reinterpret_cast<const float2*>(&b1_s[s][col]);
          sc[i] = sc[i] * e.scale + b1p.x;
          sc[i + 1] = sc[i + 1] * e.scale + b1p.y;
          if constexpr (BK != B2_NONE) {
            const float2 bb = bias2<BK>(
                strip, bias_at<BK>(rl + 8 * hh, kt * RT + col, ROWS));
            sc[i] += bb.x;
            sc[i + 1] += bb.y;
          }
        }
        online_softmax(sc, m, l, alpha);
      };
      // O = alpha O + P V of the tile in slot s (P from registers)
      auto issue_pv = [&](int s) {
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          oacc[4 * n] *= alpha[0];
          oacc[4 * n + 1] *= alpha[0];
          oacc[4 * n + 2] *= alpha[1];
          oacc[4 * n + 3] *= alpha[1];
        }
        hp::fence_regs(oacc);
        hp::wgmma_fence();
        hp::issue_rs<D>(oacc, pa, ring + s * SLOT + OWN);
        hp::wgmma_commit();
      };
      auto release = [&](int s) {
        __syncwarp();
        if (lane == 0) hp::mbar_arrive(&empty[s]);
      };
      hp::mbar_wait(&b_full, it & 1);
      for (int r = 0; r < nr; ++r, ++rc) {
        const int bn = b * N + n0 + r, u = rc & 1;
        const uint8_t* Qs = Qb + u * OWN;
#pragma unroll
        for (int i = 0; i < D / 2; ++i) oacc[i] = 0.f;
        m[0] = m[1] = NEG_INF;
        l[0] = l[1] = 0.f;
        hp::mbar_wait(&q_full[u], (rc >> 1) & 1);
        // key tile 0, then per tile kt: S_kt and P_{kt-1} V_{kt-1} in
        // flight while the warps wait for S_kt, whose softmax then runs
        // beside P V on the tensor cores
        int sp = jc % WS;
        issue_s(Qs, sp);
        hp::wgmma_wait<0>();
        softmax(sp, 0);
        hp::pack_frags(pa, sc);
        ++jc;
        for (int kt = 1; kt < nkt; ++kt, ++jc) {
          const int s = jc % WS;
          issue_s(Qs, s);
          issue_pv(sp);
          hp::wgmma_wait<1>();
          softmax(s, kt);
          hp::wgmma_wait<0>();
          hp::fence_regs(oacc);
          release(sp);
          hp::pack_frags(pa, sc);
          sp = s;
        }
        issue_pv(sp);
        hp::wgmma_wait<0>();
        hp::fence_regs(oacc);
        release(sp);
        __syncwarp();
        if (lane == 0) hp::mbar_arrive(&q_empty[u]);
        write_row(oacc, m, l, e, o, lse, bn, h, q0 + rl, t);
      }
    }
    __syncthreads();   // the strip is free for the next slice
  }
}

// The forward (mma.sync, every bf16 D), grid as evo_fwd_wgmma's: four warps of
// 16 query rows.  Thread 0 loads the pair-bias strip once a slice (TMA, in b2's
// dtype); each 64-key tile's K and V (and its row's Q at the row's first tile,
// a buffer a stage) are staged FWD_STAGES - 1 tiles ahead by cp.async, its b1
// read into registers as they are issued.  Per tile S = Q K^T (Q's fragments in
// registers, loaded at a row's first tile), s scale + b1 + b2, the online
// softmax, O += P V through mma.sync; out and lse once a row.
template <int DP, int BK>
__global__ void __launch_bounds__(THREADS, DP == 16 ? 4 : 2)
evo_fwd_rows(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v,
             const __grid_constant__ CUtensorMap bmap, bf16* __restrict__ o,
             float* __restrict__ lse, Rows rw, Evo e) {
  using M = MmaRows<DP>;
  constexpr int LD = M::LD;
  extern __shared__ __align__(1024) uint8_t smem_tma[];
  uint8_t* strip = hp::align1024(smem_tma);
  bf16* Qb = reinterpret_cast<bf16*>(strip + strip_bytes<BK>(e.L));
  uint8_t* stages = reinterpret_cast<uint8_t*>(Qb + FWD_STAGES * TILE * LD);
  __shared__ __align__(8) uint64_t b_full;
  const int L = e.L, D = e.D, H = e.H, N = e.N;
  const int q0 = blockIdx.x * TILE, h = blockIdx.y;
  const int nkt = (L + TILE - 1) / TILE;
  const int tid = threadIdx.x, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = (tid >> 5) * 16 + g;   // rows q0 + r0, + 8
  const long stride = (long)H * D;
  if (tid == 0) {
    hp::mbar_init(&b_full, 1);
    hp::mbar_fence_init();
  }
  __syncthreads();

  for (int z = blockIdx.z, it = 0; z < e.B * rw.groups;
       z += gridDim.z, ++it) {
    const int b = z / rw.groups, n0 = z % rw.groups * rw.rows;
    const int nr = min(N - n0, rw.rows), nf = nr * nkt;
    if (tid == 0) load_strip<BK>(strip, &bmap, &b_full, L, q0, h, b);
    auto stage = [&](int u) { return stages + u * M::FWD_STAGE; };
    // stage f: row f / nkt's key tile f % nkt (and its Q at the first)
    auto issue = [&](int f, int u) {
      const int r = f / nkt, kt = f % nkt;
      const long head = (long)(b * N + n0 + r) * L * stride + (long)h * D;
      bf16* x = reinterpret_cast<bf16*>(stage(u));
      if (kt == 0)
        stage_async<DP>(Qb + r % FWD_STAGES * TILE * LD, q, head, stride, q0,
                        L, D, tid);
      stage_async<DP>(x, k, head, stride, kt * TILE, L, D, tid);
      stage_async<DP>(x + TILE * LD, v, head, stride, kt * TILE, L, D, tid);
      cp_async_commit();
    };
    auto fetch = [&](int f) {
      const int bn = b * N + n0 + f / nkt, key = f % nkt * TILE + tid;
      return tid >= TILE ? 0.f
             : key >= L  ? NEG_INF
             : e.b1      ? ld_any(e.b1, (long)bn * L + key, e.b1_bf16)
                         : 0.f;
    };
    auto put = [&](int u, float x) {
      if (tid < TILE)
        reinterpret_cast<float*>(stage(u) + 2 * M::TILEB)[tid] = x;
    };
    uint32_t qa[DP / 16][4];
    float oacc[DP / 8][4], m[2], l[2], alpha[2];
    for (int f = 0; f < FWD_STAGES - 1; ++f) {
      if (f < nf) {
        issue(f, f);
        put(f, fetch(f));
      } else {
        cp_async_commit();
      }
    }
    for (int f = 0; f < nf; ++f) {
      const int u = f % FWD_STAGES, r = f / nkt, kt = f % nkt;
      const int fn = f + FWD_STAGES - 1;
      float nx = 0.f;
      if (fn < nf) {
        issue(fn, fn % FWD_STAGES);
        nx = fetch(fn);
      } else {
        cp_async_commit();
      }
      cp_async_wait<FWD_STAGES - 1>();
      __syncthreads();   // stage u (and Q at a row's first tile) landed
      if (f == 0) hp::mbar_wait(&b_full, it & 1);
      const bf16* Ks = reinterpret_cast<const bf16*>(stage(u));
      const bf16* Vs = Ks + TILE * LD;
      const float* b1_s = reinterpret_cast<const float*>(Vs + TILE * LD);
      if (kt == 0) {
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk)
          frag_a(qa[kk], Qb + r % FWD_STAGES * TILE * LD, LD, r0, kk * 16,
                 t);
#pragma unroll
        for (int n = 0; n < DP / 8; ++n)
#pragma unroll
          for (int c = 0; c < 4; ++c) oacc[n][c] = 0.f;
        m[0] = m[1] = NEG_INF;
        l[0] = l[1] = 0.f;
      }
      float s[32];   // s[4 j + c]: the m16n8 C fragment of keys 8 j ..
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
#pragma unroll
        for (int j = 0; j < TILE / 8; ++j) {
          const bf16* kr = Ks + (j * 8 + g) * LD + kk * 16 + 2 * t;
          dstt::mma_bf16(s + 4 * j, qa[kk], dstt::ld_u32(kr),
                         dstt::ld_u32(kr + 8));
        }
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int col = hp::acc_col(i, t), hh = (i >> 1) & 1;
        const float2 b1p = *reinterpret_cast<const float2*>(b1_s + col);
        s[i] = s[i] * e.scale + b1p.x;
        s[i + 1] = s[i + 1] * e.scale + b1p.y;
        if constexpr (BK != B2_NONE) {
          const float2 bb = bias2<BK>(
              strip, bias_at<BK>(r0 + 8 * hh, kt * TILE + col, TILE));
          s[i] += bb.x;
          s[i + 1] += bb.y;
        }
      }
      online_softmax(s, m, l, alpha);
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
        acc_to_a(pa, reinterpret_cast<const float(*)[4]>(s + 8 * kk));
        mma_rowmajor_b<DP>(oacc, pa, Vs + kk * 16 * LD, LD, lane);
      }
      if (kt == nkt - 1)
        write_row(reinterpret_cast<const float(&)[DP / 2]>(oacc), m, l, e, o,
                  lse, b * N + n0 + r, h, q0 + r0, t);
      if (fn < nf) put(fn % FWD_STAGES, nx);
      __syncthreads();   // stage u is read: a later tile may land there
    }
    __syncthreads();   // the strip is free for the next slice
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

// Opt kernel `kern` in to `bytes` of dynamic shared memory (needed above
// 48 KB less the 1 KB a CTA keeps reserved; harmless below).
template <typename K>
int set_smem(K kern, int bytes) {
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

// The static shared memory of the new wgmma kernels (rows of lse, delta,
// b1 and the barriers) beside their dynamic share.
constexpr int DB2_STATIC_SMEM = 3 * WS * RT * 4 + 128;

template <int D, int BK>
int db2_wgmma(const Ptrs& p, const Evo& e, int pitch, const Split& sp,
              cudaStream_t st) {
  constexpr int SMEM =
      1024 + BiasTile<BK>::bytes(ROWS, ROWS) + WS * 4 * ROWS * D * 2;
  static_assert(SMEM + DB2_STATIC_SMEM <= SMEM_MAX, "db2 smem");
  CUtensorMap qmap, kmap, vmap, dmap, bmap = {};
  int rc = row_map<D>(&qmap, p.q, e, ROWS);
  if (!rc) rc = row_map<D>(&dmap, p.dout, e, ROWS);
  if (!rc) rc = row_map<D>(&kmap, p.k, e, ROWS);
  if (!rc) rc = row_map<D>(&vmap, p.v, e, ROWS);
  if (!rc) rc = bias_map<BK>(&bmap, e, pitch, ROWS);
  if (rc) return rc;
  cudaError_t err = cudaFuncSetAttribute(
      evo_db2_wgmma<D, BK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM);
  if (err != cudaSuccess) return (int)err;
  const int nkt = tiles(e.L);
  evo_db2_wgmma<D, BK><<<dim3(nkt * nkt, sp.splits, slices(e.B * e.H)),
                          WG_THREADS, SMEM, st>>>(
      qmap, kmap, vmap, dmap, bmap, (const float*)p.lse,
      (const float*)p.delta, p.dbias, sp, e);
  return (int)cudaGetLastError();
}

template <int DP, int BK>
int db2_split(const Ptrs& p, const Evo& e, int pitch, const Split& sp,
              cudaStream_t st) {
  constexpr int SMEM = 1024 + BiasTile<BK>::bytes(TILE, TILE) +
                       MMA_STAGES * MmaRows<DP>::DB2_STAGE;
  CUtensorMap bmap = {};
  int rc = bias_map<BK>(&bmap, e, pitch, TILE);
  if (rc) return rc;
  rc = set_smem(evo_db2_split<DP, BK>, SMEM);
  if (rc) return rc;
  const int nkt = tiles(e.L);
  evo_db2_split<DP, BK><<<dim3(nkt * nkt, sp.splits, slices(e.B * e.H)),
                          THREADS, SMEM, st>>>(
      (const bf16*)p.q, (const bf16*)p.k, (const bf16*)p.v,
      (const bf16*)p.dout, bmap, (const float*)p.lse, (const float*)p.delta,
      p.dbias, sp, e);
  return (int)cudaGetLastError();
}

template <int D, int BK>
int fwd_wgmma(const Ptrs& p, const Evo& e, int pitch, Rows rw,
              cudaStream_t st) {
  const int smem = 1024 + (2 + 2 * WS) * ROWS * D * 2 + strip_bytes<BK>(e.L);
  if (smem + WG_STATIC_SMEM > SMEM_MAX) return (int)cudaErrorInvalidValue;
  CUtensorMap qmap, kmap, vmap, bmap = {};
  int rc = row_map<D>(&qmap, p.q, e, ROWS);
  if (!rc) rc = row_map<D>(&kmap, p.k, e, RT);
  if (!rc) rc = row_map<D>(&vmap, p.v, e, RT);
  if (!rc) rc = bias_map<BK>(&bmap, e, pitch, ROWS);
  if (rc) return rc;
  cudaError_t err = cudaFuncSetAttribute(
      evo_fwd_wgmma<D, BK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  evo_fwd_wgmma<D, BK><<<dim3(tiles(e.L), e.H, slices(e.B * rw.groups)),
                          WG_THREADS, smem, st>>>(
      qmap, kmap, vmap, bmap, (bf16*)p.out, (float*)p.lse_out, rw, e);
  return (int)cudaGetLastError();
}

template <int DP, int BK>
int fwd_rows(const Ptrs& p, const Evo& e, int pitch, Rows rw,
             cudaStream_t st) {
  using M = MmaRows<DP>;
  const int smem = 1024 + strip_bytes<BK>(e.L) +
                   FWD_STAGES * (M::TILEB + M::FWD_STAGE);
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  CUtensorMap bmap = {};
  int rc = bias_map<BK>(&bmap, e, pitch, TILE);
  if (rc) return rc;
  rc = set_smem(evo_fwd_rows<DP, BK>, smem);
  if (rc) return rc;
  evo_fwd_rows<DP, BK><<<dim3(tiles(e.L), e.H, slices(e.B * rw.groups)),
                         THREADS, smem, st>>>(
      (const bf16*)p.q, (const bf16*)p.k, (const bf16*)p.v, bmap,
      (bf16*)p.out, (float*)p.lse_out, rw, e);
  return (int)cudaGetLastError();
}

// What the row-walking forward and the split db2 take beyond `bad`: bf16,
// H on the grid, pair-bias rows `pitch` >= L elements apart on 16-byte
// boundaries (TMA's stride rule), and for the wgmma kernels D 32, 64 or
// 128.
bool bad_split(const Evo& e, int pitch, int wgmma) {
  const int es = e.b2_bf16 ? 2 : 4;
  return bad(e, 1) || e.H > 65535 ||
         (wgmma && e.D != 32 && e.D != 64 && e.D != 128) ||
         (e.b2 != nullptr && (pitch < e.L || (long)pitch * es % 16));
}

// The launcher F<X, BK> for the pair bias's kind, b2 given.
#define EVO_B2_GIVEN(F, X, ...)                                        \
  (e.b2_bf16 ? F<X, B2_BF16>(__VA_ARGS__) : F<X, B2_F32>(__VA_ARGS__))
// The launcher F<D, ...> of a wgmma kernel (D 32, 64, 128), or F<DP, ...>
// of an mma.sync kernel, by the pair bias's kind (KIND).
#define EVO_WG_KIND(KIND, F, ...)                                      \
  (e.D == 32   ? KIND(F, 32, __VA_ARGS__)                             \
   : e.D == 64 ? KIND(F, 64, __VA_ARGS__)                             \
               : KIND(F, 128, __VA_ARGS__))
#define EVO_MMA_KIND(KIND, F, ...)                                     \
  (padded(e.D) == 16   ? KIND(F, 16, __VA_ARGS__)                     \
   : padded(e.D) == 32 ? KIND(F, 32, __VA_ARGS__)                     \
   : padded(e.D) == 64 ? KIND(F, 64, __VA_ARGS__)                     \
                       : KIND(F, 128, __VA_ARGS__))

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

// The row-walking forward (bf16, any L whose pair-bias strip fits a CTA's
// shared memory beside the kernel's tiles: the launchers check it, and the
// host's `fwd_variant` routes by the same sizes): `rows` rows n a CTA (the
// host's `fwd_plan`); `wgmma` 1 for the TMA + wgmma kernel (D 32, 64,
// 128), 0 for the mma.sync one (any D); `pitch` as dstt_evo_dq_wgmma's.
extern "C" int dstt_evo_fwd_rows(const void* q, const void* k, const void* v,
                                 const void* b1, const void* b2, void* o,
                                 void* lse, int B, int N, int L, int H, int D,
                                 int bias_bf16, float scale, int pitch,
                                 int rows, int wgmma, void* stream) {
  const Evo e = make(b1, b2, B, N, L, H, D, bias_bf16, scale);
  if (bad_split(e, pitch, wgmma) || rows < 1)
    return (int)cudaErrorInvalidValue;
  const int groups = (N + rows - 1) / rows;
  if ((long)B * groups > 2147483647L) return (int)cudaErrorInvalidValue;
  Ptrs p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.out = o;
  p.lse_out = lse;
  const Rows rw{rows, groups};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return wgmma ? EVO_WG_KIND(EVO_WG_BY_BIAS, fwd_wgmma, p, e, pitch, rw, st)
               : EVO_MMA_KIND(EVO_WG_BY_BIAS, fwd_rows, p, e, pitch, rw, st);
}

// db2 split over the N rows in `splits` parts (the host's `db2_plan`):
// `ws` f32 [B*H * ceil(L/64)^2 * splits * 4096] and `tickets` int
// [B*H * ceil(L/64)^2], zeroed and left zeroed (both may be null with one
// split); `wgmma` and `pitch` as dstt_evo_fwd_rows's.
extern "C" int dstt_evo_db2_split(const void* q, const void* k,
                                  const void* v, const void* b1,
                                  const void* b2, const void* dout,
                                  const void* lse, const void* delta,
                                  void* db2o, void* ws, void* tickets, int B,
                                  int N, int L, int H, int D, int bias_bf16,
                                  float scale, int pitch, int splits,
                                  int wgmma, void* stream) {
  const Evo e = make(b1, b2, B, N, L, H, D, bias_bf16, scale);
  if (bad_split(e, pitch, wgmma) || b2 == nullptr || splits < 1 ||
      splits > N || splits > 65535 ||
      (splits > 1 && (ws == nullptr || tickets == nullptr)))
    return (int)cudaErrorInvalidValue;
  Ptrs p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse = lse;
  p.delta = const_cast<void*>(delta);
  p.dbias = db2o;
  const Split sp{static_cast<float*>(ws), static_cast<int*>(tickets),
                 splits};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return wgmma ? EVO_WG_KIND(EVO_B2_GIVEN, db2_wgmma, p, e, pitch, sp, st)
               : EVO_MMA_KIND(EVO_B2_GIVEN, db2_split, p, e, pitch, sp, st);
}
