// Block-sparse flash attention for Hopper (sm_90a): forward, dq, dk/dv.
//
// Replaces the TPU kernels of deepspeed_tpu/ops/sparse_flash.py:
// `block_sparse_flash_attention` (pallas_call at :149, body `_kernel`),
// and in `block_sparse_flash_backward` `_bwd_dq_kernel` (pallas_call at
// :299) and `_bwd_dkv_kernel` (pallas_call at :329).
//
// Layout (the JAX public one, no transposes): q, k, v, out, dO, dq, dk, dv
// [B, S, H, D]; lse [B, H, S/block, block] f32; the gather table
// idx [H, nqb, A] int32 lists each q-block's key blocks in ascending order
// with -1 padding last; its reverse rev [H, nkb, R] lists each key block's
// q-blocks the same way (ops/sparse_flash.reverse_gather).
//
// The TPU kernels carry the online softmax across a sequential grid axis
// over the A gathered blocks, and every padding entry costs a grid step.
// Here one CTA takes one (b, h, q-block) and loops over its row of the
// table, stopping at the first -1, so padding costs nothing:
//   forward: per visited key block, S = Q K^T masked causally inside the
//     block, online softmax (m, l and the output accumulator in
//     registers), O += P V; out = O / l and lse = m + log(l);
//   dq: per visited key block, P = exp(S - lse), dP = dO V^T,
//     dS = P (dP - delta), dQ += dS K; dq = dQ * scale, written once;
//   dk/dv: one CTA per (b, h, key block) walks the reverse table (the
//     q-blocks that visit this key block): P^T, dS^T as above with
//     dV += P^T dO and dK += dS^T Q (q scaled) in f32 registers, written
//     once, no atomics (the same result every run).
// The mma.sync pair computes delta = rowsum(dO * O) inside: the dq CTA
// for its own rows, each dk/dv CTA for each q-block it visits.  The bf16
// TMA + wgmma pair (below, `sparse_dq_wgmma`, `sparse_dkv_wgmma`) reads
// it from `sparse_bwd_delta`, one launch a backward into [B, H, S] f32,
// as the TPU wrapper computes it once (sparse_flash.py:293).
// Masked scores take the TPU kernel's sentinel NEG_INF = -1e30 and every
// exponent is re-masked (s > NEG_INF / 2), so a row that sees no key gives
// out 0 and a finite lse (-1e30), and then P = 0 in the backward: dq, dk and
// dv 0, never NaN.
//
// bf16 runs on the tensor cores (mma.sync m16n8k16, f32 accumulate), the
// tile core of attn_tile.cuh / flash_bwd.cu: ceil(block/16) warps of 16
// rows (query rows; key rows in dk/dv), rows past the block masked; a key
// block is taken in chunks of 16 keys (keys past the block masked), so
// every block that is a multiple of 8 up to 128 runs: block 8 is one warp
// with 8 masked rows and 8 masked keys.  The tiles sit in shared memory as
// bf16, rows padded by 8 elements; P and dS are rounded to bf16 and reused
// from the accumulator registers as the A operand (as the TPU kernels round
// them too).  f32 runs on the CUDA cores with exact f32 products: one warp
// per query row (key row in dk/dv), a lane per key of a 32-key chunk for the
// scores and the D columns split over the lanes for the products.
// Head dims 64, 128, 192 and 256 (the JAX gate's D % 64 == 0).  At D 256 a
// block above 96 rows does not fit its four backward tiles in shared
// memory (227 KB), so the dq and dk/dv kernels then take a smaller tile:
// the block's own rows split over two CTAs, each staging the other operand
// pair whole (`bwd_tiles`).  At D 256 the dk/dv kernel's 256 f32
// accumulators a thread exceed the 255 registers and spill.
//
// What bounds it on the H100 at the main path's shapes ([4, 4096, 16, 64]
// bf16, 26% of the blocks visited at block 16): operations, 2 (forward) to 4
// (dk/dv) [block, block, D] products per visited block pair, against bytes
// that are each block read once.  The mma.sync forms reload K/V for every
// visit, feed the tensor cores one tile at a time with no copy/compute
// overlap, and at block 16 run one warp per CTA.
//
// The bf16 backward at D 64 / 128 and block 16 / 32 / 64 has a second
// pair on TMA + wgmma over a gathered tile plan (ops/sparse_flash.py
// `tile_walk`): wgmma's M is 64 rows, so a step gathers 64 rows of the
// visited blocks (G = 64 / block of them, one TMA box each) on the M side
// while the CTA's own rows (R blocks, N = R * block <= 64) stay on the N
// side: padding stands only at the tail of a CTA's list, never across
// blocks that one owner does not visit.  At N 16 a step moves 16 KB for
// 0.4 MFLOP (L2 traffic bounds it), so the plan gives a CTA R > 1 owners
// whose lists are alike (adjacent, or grouped by sorted list) where the
// padding costs less than the traffic it saves; `STEP_COST` (measured)
// weighs the two.  One producer warp issues the TMA boxes into a 2-slot
// mbarrier ring (dk/dv: and stages the gathered rows' lse and delta), one
// consumer warpgroup runs the products; P and dS are rounded to bf16 and
// staged in shared memory as the MN-major B of the second products, whose
// A is the gathered tile read MN-major (wgmma's transpose of A).  The
// CTAs with the longest lists start first.  Every output element is
// summed in one CTA in list order and written once: reruns are bitwise
// equal.
//
// The bf16 forward at the same D and blocks has its own TMA + wgmma
// kernel, `sparse_fwd_wgmma`, in flash_fwd_wgmma's orientation over the
// gathered walk of the gather table: a CTA owns 64 query rows (R = 64 /
// block query blocks, grouped adjacent or by sorted list, whichever
// walk takes fewer steps; the last group of a head may be ragged) on
// the M side and gathers G = 64 / block visited key blocks a step on
// the N side (one TMA box each, into a 2-3 slot ring), so at block 16 a
// step is a 64 x 64 x D product instead of 16 x 16 x D.  The owner mask
// of each entry (sparse_tile.cuh) sets the rows whose owner does not
// visit that key block to NEG_INF; the online softmax stays row-wise in
// registers and P V takes P from registers.
#include "attn_tile.cuh"
#include "hopper_tile.cuh"
#include "sparse_tile.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int MAX_BLOCK = 128;
constexpr int F32_WARPS = 8;

using dstt::acc_to_a;
using dstt::frag_a;
using dstt::mma_abt;
using dstt::mma_rowmajor_b;
using dstt::warp_max;
using dstt::warp_sum;
using dstt::zero16;

// Copy `rows` rows of D bf16 (global row stride `stride`) into a shared
// tile of `tile_rows` rows of leading dim LD, zero-filling the rest.
template <int D, int LD>
__device__ __forceinline__ void stage(bf16* dst, const bf16* src, long stride,
                                      int rows, int tile_rows) {
  constexpr int NV = D / 8;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int i = threadIdx.x; i < tile_rows * NV; i += blockDim.x) {
    const int row = i / NV;
    const int c = (i % NV) * 8;
    *reinterpret_cast<uint4*>(dst + row * LD + c) =
        row < rows ? *reinterpret_cast<const uint4*>(src + row * stride + c)
                   : zero;
  }
}

template <int D>
__host__ __device__ constexpr int ld_bf16() {
  return D + 8;
}

// ---------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(256)
sparse_fwd_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, bf16* __restrict__ o,
               float* __restrict__ lse, const int* __restrict__ idx, int S,
               int H, int block, int A, int causal, float sm_scale) {
  constexpr int LD = ld_bf16<D>();
  const int rows = blockDim.x / 2;            // 16 rows a warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + rows * LD;
  bf16* Vs = Ks + rows * LD;

  const int qb = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nqb = S / block;
  const int q0 = qb * block;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = (threadIdx.x >> 5) * 16 + g;   // rows r0 and r0 + 8
  const long stride = (long)H * D;
  const long head = (long)b * S * stride + (long)h * D;

  stage<D, LD>(Qs, q + head + (long)q0 * stride, stride, block, rows);
  __syncthreads();
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) frag_a(qa[kk], Qs, LD, r0, kk * 16, t);

  float oacc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[n][e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF};   // running max, log2 units
  float l[2] = {0.f, 0.f};           // this lane's partial row sums
  const float scale2 = sm_scale * LOG2E;
  const int qp[2] = {q0 + r0, q0 + r0 + 8};
  const int* row_idx = idx + ((long)h * nqb + qb) * A;

  for (int a = 0; a < A; ++a) {
    const int kb = row_idx[a];
    if (kb < 0) break;   // ascending, padding last
    const int k0 = kb * block;
    __syncthreads();     // the previous block's readers are done
    stage<D, LD>(Ks, k + head + (long)k0 * stride, stride, block, rows);
    stage<D, LD>(Vs, v + head + (long)k0 * stride, stride, block, rows);
    __syncthreads();
    for (int kc = 0; kc < block; kc += 16) {
      float s[2][4];
      zero16(s);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const bf16* kr = Ks + (kc + j * 8 + g) * LD + kk * 16 + 2 * t;
          dstt::mma_bf16(s[j], qa[kk], dstt::ld_u32(kr),
                         dstt::ld_u32(kr + 8));
        }
      // s[j][0..1]: row r0, keys kc+8j+2t+{0,1}; s[j][2..3]: row r0+8
      float tmax[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hh = e >> 1;
          const int c = kc + 8 * j + 2 * t + (e & 1);
          const bool vis = c < block && (!causal || k0 + c <= qp[hh]);
          s[j][e] = vis ? s[j][e] * scale2 : NEG_INF;
          tmax[hh] = fmaxf(tmax[hh], s[j][e]);
        }
      float alpha[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        tmax[hh] = fmaxf(tmax[hh], __shfl_xor_sync(0xffffffffu, tmax[hh], 1));
        tmax[hh] = fmaxf(tmax[hh], __shfl_xor_sync(0xffffffffu, tmax[hh], 2));
        const float m_new = fmaxf(m[hh], tmax[hh]);
        alpha[hh] = exp2f(m[hh] - m_new);   // 1 while the row saw no key
        m[hh] = m_new;
        l[hh] *= alpha[hh];
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hh = e >> 1;
          s[j][e] = s[j][e] > NEG_INF * 0.5f ? exp2f(s[j][e] - m[hh]) : 0.f;
          l[hh] += s[j][e];
        }
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        oacc[n][0] *= alpha[0];
        oacc[n][1] *= alpha[0];
        oacc[n][2] *= alpha[1];
        oacc[n][3] *= alpha[1];
      }
      uint32_t pa[4];
      acc_to_a(pa, s);
      mma_rowmajor_b<D>(oacc, pa, Vs + kc * LD, LD, lane);
    }
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
    const int r = r0 + 8 * hh;
    if (r >= block) continue;
    const float lsafe = fmaxf(l[hh], 1e-30f);   // no key seen: out 0
    const float inv = 1.f / lsafe;
    bf16* orow = o + head + (long)(q0 + r) * stride;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8 + 2 * t) =
          __floats2bfloat162_rn(oacc[n][2 * hh] * inv,
                                oacc[n][2 * hh + 1] * inv);
    if (t == 0)
      lse[((long)b * H + h) * S + q0 + r] =
          (m[hh] > NEG_INF * 0.5f ? m[hh] / LOG2E : NEG_INF) + logf(lsafe);
  }
}

// Shared memory of the dq and dk/dv kernels: the CTA's own tile (`rows`
// query rows in dq, key rows in dk/dv; two operands) and the other
// operand pair of a whole block (`other` rows), plus lse and delta.
template <int D>
__host__ __device__ constexpr int bwd_smem(int rows, int other) {
  return 2 * (rows + other) * ld_bf16<D>() * 2 +
         2 * (rows > other ? rows : other) * 4;
}

// delta = rowsum(dO * O) of a staged dO tile's rows [0, n) (rows past n
// get 0, up to tile_rows): two threads per tile row, each sums half the
// row from 16-byte loads, and the pair adds with one shuffle; the CTA
// walks the tile blockDim/2 rows at a time.
template <int D>
__device__ __forceinline__ void tile_delta(float* delta_s, const bf16* dOs,
                                           const bf16* o, long stride,
                                           int n, int tile_rows) {
  constexpr int LD = ld_bf16<D>();
  const int c0 = (threadIdx.x & 1) * (D / 2);
  for (int base = 0; base < tile_rows; base += blockDim.x / 2) {
    const int row = base + (threadIdx.x >> 1);
    float part = 0.f;
    if (row < n) {
#pragma unroll
      for (int c = c0; c < c0 + D / 2; c += 8) {
        const uint4 a = *reinterpret_cast<const uint4*>(dOs + row * LD + c);
        const uint4 b =
            *reinterpret_cast<const uint4*>(o + row * stride + c);
        const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
        const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 xf = __bfloat1622float2(x[e]);
          const float2 yf = __bfloat1622float2(y[e]);
          part += xf.x * yf.x + xf.y * yf.y;
        }
      }
    }
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    if ((threadIdx.x & 1) == 0 && row < tile_rows) delta_s[row] = part;
  }
}

// The backward kernels take blockDim / 2 rows of their block per CTA
// (16 a warp) and `split` CTAs per block: split is 1 but where a whole
// block's four tiles do not fit in shared memory (D 256 at blocks above
// 96), where each CTA takes a part of the block's own rows and the other
// operand pair whole.
template <int D>
__global__ void __launch_bounds__(256)
sparse_dq_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const bf16* __restrict__ o,
              const float* __restrict__ lse, const bf16* __restrict__ dout,
              bf16* __restrict__ dq, const int* __restrict__ idx, int S,
              int H, int block, int A, int causal, float sm_scale,
              int split) {
  constexpr int LD = ld_bf16<D>();
  const int rows = blockDim.x / 2;             // this CTA's query rows
  const int krows = (block + 15) / 16 * 16;    // a key block's tile rows
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dOs = Qs + rows * LD;
  bf16* Ks = dOs + rows * LD;
  bf16* Vs = Ks + krows * LD;
  float* lse_s = reinterpret_cast<float*>(Vs + krows * LD);
  float* delta_s = lse_s + rows;

  const int qb = blockIdx.x / split, h = blockIdx.y, b = blockIdx.z;
  const int row0 = (blockIdx.x % split) * rows;
  const int nrows = min(rows, block - row0);
  const int nqb = S / block;
  const int q0 = qb * block + row0;            // this CTA's first row
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = (threadIdx.x >> 5) * 16 + g;
  const long stride = (long)H * D;
  const long head = (long)b * S * stride + (long)h * D;
  const long qbase = head + (long)q0 * stride;

  stage<D, LD>(Qs, q + qbase, stride, nrows, rows);
  stage<D, LD>(dOs, dout + qbase, stride, nrows, rows);
  for (int r = threadIdx.x; r < rows; r += blockDim.x)
    lse_s[r] = r < nrows ? lse[((long)b * H + h) * S + q0 + r] * LOG2E
                         : INFINITY;   // padding rows: P = 0
  __syncthreads();
  tile_delta<D>(delta_s, dOs, o + qbase, stride, nrows, rows);
  __syncthreads();
  const float lse_r[2] = {lse_s[r0], lse_s[r0 + 8]};
  const float delta_r[2] = {delta_s[r0], delta_s[r0 + 8]};
  const int qp[2] = {q0 + r0, q0 + r0 + 8};
  const float scale2 = sm_scale * LOG2E;

  float dqacc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqacc[n][e] = 0.f;

  const int* row_idx = idx + ((long)h * nqb + qb) * A;
  for (int a = 0; a < A; ++a) {
    const int kb = row_idx[a];
    if (kb < 0) break;
    const int k0 = kb * block;
    __syncthreads();
    stage<D, LD>(Ks, k + head + (long)k0 * stride, stride, block, krows);
    stage<D, LD>(Vs, v + head + (long)k0 * stride, stride, block, krows);
    __syncthreads();
    for (int kc = 0; kc < block; kc += 16) {
      float s[2][4], dp[2][4];
      zero16(s);
      zero16(dp);
      mma_abt<D>(s, Qs, Ks, LD, r0, kc, g, t);
      mma_abt<D>(dp, dOs, Vs, LD, r0, kc, g, t);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hh = e >> 1;
          const int c = kc + 8 * j + 2 * t + (e & 1);
          const bool vis = c < block && (!causal || k0 + c <= qp[hh]);
          const float p = vis ? exp2f(s[j][e] * scale2 - lse_r[hh]) : 0.f;
          s[j][e] = p * (dp[j][e] - delta_r[hh]);   // dS
        }
      uint32_t da[4];
      acc_to_a(da, s);
      mma_rowmajor_b<D>(dqacc, da, Ks + kc * LD, LD, lane);
    }
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = r0 + 8 * hh;
    if (r >= nrows) continue;
    bf16* row = dq + qbase + (long)r * stride;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(row + n * 8 + 2 * t) =
          __floats2bfloat162_rn(dqacc[n][2 * hh] * sm_scale,
                                dqacc[n][2 * hh + 1] * sm_scale);
  }
}

template <int D>
__global__ void __launch_bounds__(256)
sparse_dkv_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const bf16* __restrict__ o,
               const float* __restrict__ lse, const bf16* __restrict__ dout,
               bf16* __restrict__ dk, bf16* __restrict__ dv,
               const int* __restrict__ rev, int S, int H, int block, int R,
               int causal, float sm_scale, int split) {
  constexpr int LD = ld_bf16<D>();
  const int rows = blockDim.x / 2;             // this CTA's key rows
  const int qrows = (block + 15) / 16 * 16;    // a q-block's tile rows
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + rows * LD;
  bf16* Qs = Vs + rows * LD;
  bf16* dOs = Qs + qrows * LD;
  float* lse_s = reinterpret_cast<float*>(dOs + qrows * LD);
  float* delta_s = lse_s + qrows;

  const int kbi = blockIdx.x / split, h = blockIdx.y, b = blockIdx.z;
  const int row0 = (blockIdx.x % split) * rows;
  const int nrows = min(rows, block - row0);
  const int nkb = S / block;
  const int k0 = kbi * block + row0;           // this CTA's first key
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = (threadIdx.x >> 5) * 16 + g;   // key rows r0 and r0 + 8
  const long stride = (long)H * D;
  const long head = (long)b * S * stride + (long)h * D;
  const int kp[2] = {k0 + r0, k0 + r0 + 8};
  const bool kvalid[2] = {r0 < nrows, r0 + 8 < nrows};
  const float scale2 = sm_scale * LOG2E;

  stage<D, LD>(Ks, k + head + (long)k0 * stride, stride, nrows, rows);
  stage<D, LD>(Vs, v + head + (long)k0 * stride, stride, nrows, rows);

  float dkacc[D / 8][4], dvacc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dkacc[n][e] = dvacc[n][e] = 0.f;

  const int* rrow = rev + ((long)h * nkb + kbi) * R;
  for (int r = 0; r < R; ++r) {
    const int qb = rrow[r];
    if (qb < 0) break;
    const int q0 = qb * block;
    const long qbase = head + (long)q0 * stride;
    __syncthreads();   // the previous q-block's readers are done
    stage<D, LD>(Qs, q + qbase, stride, block, qrows);
    stage<D, LD>(dOs, dout + qbase, stride, block, qrows);
    for (int i = threadIdx.x; i < qrows; i += blockDim.x)
      lse_s[i] = i < block ? lse[((long)b * H + h) * S + q0 + i] * LOG2E
                           : INFINITY;
    __syncthreads();
    tile_delta<D>(delta_s, dOs, o + qbase, stride, block, qrows);
    __syncthreads();
    for (int qc = 0; qc < block; qc += 16) {
      float st[2][4], dpt[2][4];
      zero16(st);
      zero16(dpt);
      mma_abt<D>(st, Ks, Qs, LD, r0, qc, g, t);
      mma_abt<D>(dpt, Vs, dOs, LD, r0, qc, g, t);
      // st[j][0..1]: key r0, query rows qc+8j+2t+{0,1}; [2..3]: key r0+8
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hk = e >> 1;
          const int i = qc + 8 * j + 2 * t + (e & 1);
          const bool vis = i < block && kvalid[hk] &&
                           (!causal || kp[hk] <= q0 + i);
          const float p = vis ? exp2f(st[j][e] * scale2 - lse_s[i]) : 0.f;
          dpt[j][e] = p * (dpt[j][e] - delta_s[i]);   // dS^T
          st[j][e] = p;                               // P^T
        }
      uint32_t pa[4], dsa[4];
      acc_to_a(pa, st);
      acc_to_a(dsa, dpt);
      mma_rowmajor_b<D>(dvacc, pa, dOs + qc * LD, LD, lane);
      mma_rowmajor_b<D>(dkacc, dsa, Qs + qc * LD, LD, lane);
    }
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = r0 + 8 * hh;
    if (r >= nrows) continue;
    bf16* dkr = dk + head + (long)(k0 + r) * stride;
    bf16* dvr = dv + head + (long)(k0 + r) * stride;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(dkr + n * 8 + 2 * t) =
          __floats2bfloat162_rn(dkacc[n][2 * hh] * sm_scale,
                                dkacc[n][2 * hh + 1] * sm_scale);
      *reinterpret_cast<__nv_bfloat162*>(dvr + n * 8 + 2 * t) =
          __floats2bfloat162_rn(dvacc[n][2 * hh], dvacc[n][2 * hh + 1]);
    }
  }
}

// ---------------------------------------------------------------------
// bf16 backward on TMA + wgmma over a gathered tile plan
// ---------------------------------------------------------------------
namespace hp = dstt::hopper;

// delta = rowsum(dO * out) in f32 into [B, H, S] for the wgmma pair (bf16,
// D 64 or 128): DELTA_TPR consecutive threads a row of D elements, each
// summing its 16-byte chunks part, part + DELTA_TPR, ... in order, then an
// xor-shuffle sum.
constexpr int DELTA_THREADS = 256;
constexpr int DELTA_TPR = 8;

template <int D>
__global__ void __launch_bounds__(DELTA_THREADS)
sparse_bwd_delta(const bf16* __restrict__ o, const bf16* __restrict__ dout,
                 float* __restrict__ delta, long rows, int S, int H) {
  constexpr int CHUNKS = D * (int)sizeof(bf16) / 16 / DELTA_TPR;
  constexpr int RPB = DELTA_THREADS / DELTA_TPR;
  const long row = (long)blockIdx.x * RPB + threadIdx.x / DELTA_TPR;
  const int part = threadIdx.x % DELTA_TPR;
  float s = 0.f;
  if (row < rows) {
    const uint4* a = reinterpret_cast<const uint4*>(o + row * D);
    const uint4* b = reinterpret_cast<const uint4*>(dout + row * D);
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c) {
      const uint4 ca = a[part + c * DELTA_TPR], cb = b[part + c * DELTA_TPR];
      const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&ca);
      const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&cb);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 fx = __bfloat1622float2(x[i]);
        const float2 fy = __bfloat1622float2(y[i]);
        s += fx.x * fy.x + fx.y * fy.y;
      }
    }
  }
#pragma unroll
  for (int off = DELTA_TPR / 2; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (part == 0 && row < rows) {
    const int h = (int)(row % H);
    const long bs = row / H;
    delta[(bs / S * H + h) * S + bs % S] = s;
  }
}

// The gathered tile plan (ops/sparse_flash.py `TileWalk`).  A CTA owns R
// blocks of one head (query blocks in dq, key blocks in dk/dv: N = R *
// block rows, the narrow N side of every product) and walks its list:
// the blocks any of its R owners visits, ascending, G = 64 / block of
// them a step gathered into one 64-row tile (the wgmma M side) as G TMA
// boxes of `block` rows.  A list entry is (block << 4) | mask, bit o of
// the mask set when owner o visits that block (masked where clear), or
// -1: a padding slot at the list's tail, loaded from past S (zeros) and
// masked.  sched [n_ctas] two int4: (h, steps, offset of the list in
// ents, R) and the R owned blocks, the CTAs with the most steps first.
constexpr int GROWS = 64;                  // gathered rows a step
constexpr int G_CONSUMERS = 128;           // one consumer warpgroup
constexpr int G_THREADS = G_CONSUMERS + 32;   // and one producer warp
constexpr int G_STAGES = 2;                // ring slots

template <int D, int BLK, int R>
struct Walk : hp::RowTile<D> {
  static constexpr int N = BLK * R;           // owned rows
  static constexpr int G = GROWS / BLK;       // gathered blocks a step
  static constexpr int OWN = N * D * 2;       // one owned operand
  static constexpr int TILE = GROWS * D * 2;  // one gathered operand
  static constexpr int RBN = N * 2;           // a staged operand's row
  static constexpr hp::Swizzle SWN =
      RBN == 128 ? hp::SW128 : RBN == 64 ? hp::SW64 : hp::SW32;
  static constexpr int STAGED = GROWS * RBN;  // one staged [64 x N] operand
  static constexpr int LDO = D + 8;           // epilogue rows, bf16
  // the owned pair, the ring of gathered pairs, `staged` staged operands;
  // the epilogue's [N][LDO] rows reuse the ring
  static constexpr int smem(int staged) {
    return 1024 + 2 * OWN + G_STAGES * 2 * TILE + staged * STAGED;
  }
  static_assert(GROWS % BLK == 0 && N <= 64, "tile plan");
  static_assert(2 * N * LDO * 2 <= G_STAGES * 2 * TILE, "epilogue");
};

// CTAs an SM the launch bound asks for, so that no walk spills: four at N
// 16 (and 32 at D 64), three at D 128 N 32, two at D 64 N 64, one at D 128
// N 64 (dk/dv's four accumulators of [D x N])
template <int D, int N>
constexpr int walk_ctas() {
  return N == 16 || (N == 32 && D == 64) ? 4 : N == 32 ? 3 : D == 64 ? 2 : 1;
}

// Store an m64nN f32 accumulator as bf16 into a staged operand of 64 rows
// of N bf16 (the next product's MN-major B: rows its contraction index),
// with the N * 2-byte swizzle.
template <int N, hp::Swizzle SWN>
__device__ __forceinline__ void stage_acc(uint8_t* staged,
                                          const float (&acc)[N / 2], int warp,
                                          int g, int t) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const uint32_t off =
          (16 * warp + g + 8 * hh) * (N * 2) + (8 * j + 2 * t) * 2;
      *reinterpret_cast<uint32_t*>(staged + hp::swizzled<SWN>(off)) =
          hp::pack_bf16x2(acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]);
    }
}

// acc[m] [64 x N] += X^T [64 of D (column box m) x 64] W [64 x N]: X the
// gathered tile (rows its contraction index, read MN-major), W a staged
// operand (MN-major).
template <int D, int N, hp::Swizzle SWN>
__device__ __forceinline__ void issue_tn(float (&acc)[D / 64][N / 2],
                                         const uint8_t* x, const uint8_t* w) {
#pragma unroll
  for (int m = 0; m < D / 64; ++m)
#pragma unroll
    for (int kk = 0; kk < GROWS / 16; ++kk) {
      const uint64_t da = hp::smem_desc(x + m * GROWS * 128 + kk * 16 * 128,
                                        hp::SW128, GROWS * 128, 8 * 128);
      const uint64_t db = hp::smem_desc(w + kk * 16 * (N * 2), SWN,
                                        GROWS * N * 2, 8 * N * 2);
      hp::wgmma_ss<N, 1, 1>(acc[m], da, db, 1);
    }
}

// owned block o of a CTA (o < R)
__device__ __forceinline__ int owned(int4 own, int o) {
  return o == 0 ? own.x : o == 1 ? own.y : o == 2 ? own.z : own.w;
}

// rows [0, N) of an epilogue tile out_s [N][LDO] (bf16), row r of owned
// block r / BLK, to the rows of D elements `stride` apart at `head`,
// 16-byte stores by the consumer warpgroup
template <int D, int BLK, int N, int LDO>
__device__ __forceinline__ void write_rows(bf16* head, long stride,
                                           int4 own, const bf16* out_s,
                                           int tid) {
  for (int x = tid; x < N * D / 8; x += G_CONSUMERS) {
    const int r = x / (D / 8), c = x % (D / 8) * 8;
    const long row = (long)owned(own, r / BLK) * BLK + r % BLK;
    *reinterpret_cast<uint4*>(head + row * stride + c) =
        *reinterpret_cast<const uint4*>(out_s + r * LDO + c);
  }
}

// dq: the CTA owns R query blocks (Q, dO, lse, delta loaded once) and
// gathers 64 key rows a step: S^T = K_g Q^T and dP^T = V_g dO^T (M 64, N
// the owned rows, K = D), P^T = exp2(S^T scale log2e - lse log2e) masked
// (owners that do not visit a gathered block, the causal diagonal, the
// tail's padding), dS^T = P^T (dP^T - delta) staged in shared memory as
// bf16, dQ^T += K_g^T dS^T (M = D in 64-row boxes, N, K = 64).
template <int D, int BLK, int R>
__global__ void __launch_bounds__(G_THREADS, walk_ctas<D, BLK * R>())
sparse_dq_wgmma(const __grid_constant__ CUtensorMap qmap,
                const __grid_constant__ CUtensorMap kmap,
                const __grid_constant__ CUtensorMap vmap,
                const __grid_constant__ CUtensorMap dmap,
                const float* __restrict__ lse,
                const float* __restrict__ delta, bf16* __restrict__ dq,
                const int4* __restrict__ sched, const int* __restrict__ ents,
                int S, int H, int B, int causal, float scale_log2,
                float sm_scale) {
  using T = Walk<D, BLK, R>;
  constexpr int N = T::N, G = T::G;
  extern __shared__ __align__(1024) uint8_t smem_tma[];
  uint8_t* Qs = hp::align1024(smem_tma);
  uint8_t* dOs = Qs + T::OWN;
  uint8_t* ring = dOs + T::OWN;   // slot s: the K tile, then the V tile
  uint8_t* dSs = ring + G_STAGES * 2 * T::TILE;
  __shared__ __align__(8) uint64_t own_full, full[G_STAGES], empty[G_STAGES];
  const int4 job = sched[2 * (blockIdx.x / B)];
  const int4 own = sched[2 * (blockIdx.x / B) + 1];
  const int b = blockIdx.x % B, h = job.x, n_steps = job.y;
  const int* list = ents + job.z;
  const int tid = threadIdx.x;
  if (tid == 0) {
    hp::mbar_init(&own_full, 1);
    for (int s = 0; s < G_STAGES; ++s) {
      hp::mbar_init(&full[s], 1);
      hp::mbar_init(&empty[s], 4);   // one arrival per consumer warp
    }
    hp::mbar_fence_init();
  }
  __syncthreads();

  if (tid >= G_CONSUMERS) {   // producer: TMA from one lane
    if (tid == G_CONSUMERS) {
      hp::mbar_expect_tx(&own_full, 2 * T::OWN);
      for (int o = 0; o < R; ++o)
        for (int c = 0; c < T::NCH; ++c) {
          const int off = c * N * T::RB + o * BLK * T::RB;
          hp::tma_load_4d(Qs + off, &qmap, &own_full, c * T::CH, h,
                          owned(own, o) * BLK, b);
          hp::tma_load_4d(dOs + off, &dmap, &own_full, c * T::CH, h,
                          owned(own, o) * BLK, b);
        }
      for (int j = 0; j < n_steps; ++j) {
        const int s = j % G_STAGES;
        hp::mbar_wait(&empty[s], ((j / G_STAGES) & 1) ^ 1);
        uint8_t* Ks = ring + s * 2 * T::TILE;
        hp::mbar_expect_tx(&full[s], 2 * T::TILE);
        for (int i = 0; i < G; ++i) {
          const int e = list[j * G + i];
          const int k0 = e >= 0 ? (e >> 4) * BLK : S;   // padding: zeros
          for (int c = 0; c < T::NCH; ++c) {
            const int off = c * GROWS * T::RB + i * BLK * T::RB;
            hp::tma_load_4d(Ks + off, &kmap, &full[s], c * T::CH, h, k0, b);
            hp::tma_load_4d(Ks + T::TILE + off, &vmap, &full[s], c * T::CH,
                            h, k0, b);
          }
        }
      }
    }
    return;
  }

  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int kr = 16 * warp + g;   // gathered rows kr, kr + 8 (one slot)
  // this thread's query columns 8 j + 2 t, + 1: their rows, lse (times
  // log2 e) and delta
  int qrow[N / 8];
  float2 lse2[N / 8], dl[N / 8];
  const long lbase = ((long)b * H + h) * S;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    qrow[j] = owned(own, 8 * j / BLK) * BLK + 8 * j % BLK + 2 * t;
    const float2 l = *reinterpret_cast<const float2*>(lse + lbase + qrow[j]);
    lse2[j] = make_float2(l.x * LOG2E, l.y * LOG2E);
    dl[j] = *reinterpret_cast<const float2*>(delta + lbase + qrow[j]);
  }
  float dqa[D / 64][N / 2];
#pragma unroll
  for (int m = 0; m < D / 64; ++m)
#pragma unroll
    for (int i = 0; i < N / 2; ++i) dqa[m][i] = 0.f;
  float st[N / 2], dpt[N / 2];
  hp::mbar_wait(&own_full, 0);

  for (int j = 0; j < n_steps; ++j) {
    const int s = j % G_STAGES;
    const int e = list[j * G + kr / BLK];
    const uint8_t* Ks = ring + s * 2 * T::TILE;
    const uint8_t* Vs = Ks + T::TILE;
    hp::mbar_wait(&full[s], (j / G_STAGES) & 1);
    hp::wgmma_fence();
    hp::issue_abt<D, N>(st, Ks, GROWS, Qs);
    hp::wgmma_commit();
    hp::issue_abt<D, N>(dpt, Vs, GROWS, dOs);
    hp::wgmma_commit();
    const int mask = e < 0 ? 0 : e & 15;
    const int kp = (e >> 4) * BLK + kr % BLK;   // key rows kp, kp + 8
    hp::wgmma_wait<1>();
    hp::fence_regs(st);
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const int jj = i >> 2;
      const float l = (i & 1) ? lse2[jj].y : lse2[jj].x;
      float p = hp::ex2(fmaf(st[i], scale_log2, -l));
      if (!((mask >> (8 * jj / BLK)) & 1) ||
          (causal && kp + 8 * ((i >> 1) & 1) > qrow[jj] + (i & 1)))
        p = 0.f;
      st[i] = p;
    }
    hp::wgmma_wait<0>();
    hp::fence_regs(dpt);
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const float d = (i & 1) ? dl[i >> 2].y : dl[i >> 2].x;
      dpt[i] = st[i] * (dpt[i] - d);
    }
    hp::named_sync(1, G_CONSUMERS);   // the last step's product read dSs
    stage_acc<N, T::SWN>(dSs, dpt, warp, g, t);
    hp::fence_proxy_async();
    hp::named_sync(1, G_CONSUMERS);
    hp::wgmma_fence();
    issue_tn<D, N, T::SWN>(dqa, Ks, dSs);
    hp::wgmma_commit();
    hp::wgmma_wait<0>();
#pragma unroll
    for (int m = 0; m < D / 64; ++m) hp::fence_regs(dqa[m]);
    __syncwarp();
    if (lane == 0) hp::mbar_arrive(&empty[s]);
  }

  // dQ^T (rows d, columns the owned query rows) through shared memory
  hp::named_sync(1, G_CONSUMERS);   // every product has read the ring
  bf16* out_s = reinterpret_cast<bf16*>(ring);
#pragma unroll
  for (int m = 0; m < D / 64; ++m)
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const int d = 64 * m + kr + 8 * ((i >> 1) & 1);
      out_s[hp::acc_col(i, t) * T::LDO + d] =
          __float2bfloat16(dqa[m][i] * sm_scale);
    }
  hp::named_sync(1, G_CONSUMERS);
  const long stride = (long)H * D;
  write_rows<D, BLK, N, T::LDO>(dq + (long)b * S * stride + (long)h * D,
                                stride, own, out_s, tid);
}

// dk/dv: the CTA owns R key blocks (K and V loaded once) and gathers 64
// query rows a step (Q, dO, and their lse and delta, which the producer
// warp stages beside the ring slot: +inf and 0 on padding rows): S = Q_g
// K^T and dP = dO_g V^T (M 64, N the owned keys), P and dS = P (dP -
// delta) masked as in dq, both staged as bf16; dV^T += dO_g^T P and dK^T
// += Q_g^T dS (M = D, N, K = 64).
template <int D, int BLK, int R>
__global__ void __launch_bounds__(G_THREADS, walk_ctas<D, BLK * R>())
sparse_dkv_wgmma(const __grid_constant__ CUtensorMap qmap,
                 const __grid_constant__ CUtensorMap kmap,
                 const __grid_constant__ CUtensorMap vmap,
                 const __grid_constant__ CUtensorMap dmap,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, bf16* __restrict__ dk,
                 bf16* __restrict__ dv, const int4* __restrict__ sched,
                 const int* __restrict__ ents, int S, int H, int B,
                 int causal, float scale_log2, float sm_scale) {
  using T = Walk<D, BLK, R>;
  constexpr int N = T::N, G = T::G;
  extern __shared__ __align__(1024) uint8_t smem_tma[];
  uint8_t* Ks = hp::align1024(smem_tma);
  uint8_t* Vs = Ks + T::OWN;
  uint8_t* ring = Vs + T::OWN;   // slot s: the Q tile, then the dO tile
  uint8_t* Ps = ring + G_STAGES * 2 * T::TILE;
  uint8_t* dSs = Ps + T::STAGED;
  __shared__ float lse_s[G_STAGES][GROWS], dl_s[G_STAGES][GROWS];
  __shared__ __align__(8) uint64_t own_full, full[G_STAGES], empty[G_STAGES];
  const int4 job = sched[2 * (blockIdx.x / B)];
  const int4 own = sched[2 * (blockIdx.x / B) + 1];
  const int b = blockIdx.x % B, h = job.x, n_steps = job.y;
  const int* list = ents + job.z;
  const int tid = threadIdx.x;
  if (tid == 0) {
    hp::mbar_init(&own_full, 1);
    for (int s = 0; s < G_STAGES; ++s) {
      hp::mbar_init(&full[s], 1 + 32);   // the TMA lane + the warp's rows
      hp::mbar_init(&empty[s], 4);
    }
    hp::mbar_fence_init();
  }
  __syncthreads();

  if (tid >= G_CONSUMERS) {   // producer warp
    const int lane = tid - G_CONSUMERS;
    const long lbase = ((long)b * H + h) * S;
    if (lane == 0) {
      hp::mbar_expect_tx(&own_full, 2 * T::OWN);
      for (int o = 0; o < R; ++o)
        for (int c = 0; c < T::NCH; ++c) {
          const int off = c * N * T::RB + o * BLK * T::RB;
          hp::tma_load_4d(Ks + off, &kmap, &own_full, c * T::CH, h,
                          owned(own, o) * BLK, b);
          hp::tma_load_4d(Vs + off, &vmap, &own_full, c * T::CH, h,
                          owned(own, o) * BLK, b);
        }
    }
    for (int j = 0; j < n_steps; ++j) {
      const int s = j % G_STAGES;
      hp::mbar_wait(&empty[s], ((j / G_STAGES) & 1) ^ 1);
      if (lane == 0) {
        uint8_t* Qg = ring + s * 2 * T::TILE;
        hp::mbar_expect_tx(&full[s], 2 * T::TILE);
        for (int i = 0; i < G; ++i) {
          const int e = list[j * G + i];
          const int r0 = e >= 0 ? (e >> 4) * BLK : S;   // padding: zeros
          for (int c = 0; c < T::NCH; ++c) {
            const int off = c * GROWS * T::RB + i * BLK * T::RB;
            hp::tma_load_4d(Qg + off, &qmap, &full[s], c * T::CH, h, r0, b);
            hp::tma_load_4d(Qg + T::TILE + off, &dmap, &full[s], c * T::CH,
                            h, r0, b);
          }
        }
      }
      for (int rr = lane; rr < GROWS; rr += 32) {
        const int e = list[j * G + rr / BLK];
        const long i = lbase + (e >> 4) * BLK + rr % BLK;
        lse_s[s][rr] = e >= 0 ? lse[i] * LOG2E : INFINITY;
        dl_s[s][rr] = e >= 0 ? delta[i] : 0.f;
      }
      hp::mbar_arrive(&full[s]);
    }
    return;
  }

  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int qr = 16 * warp + g;   // gathered query rows qr, qr + 8
  int krow[N / 8];                // this thread's key columns 8 j + 2 t
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
    krow[j] = owned(own, 8 * j / BLK) * BLK + 8 * j % BLK + 2 * t;
  float dka[D / 64][N / 2], dva[D / 64][N / 2];
#pragma unroll
  for (int m = 0; m < D / 64; ++m)
#pragma unroll
    for (int i = 0; i < N / 2; ++i) dka[m][i] = dva[m][i] = 0.f;
  float sc[N / 2], dp[N / 2];
  hp::mbar_wait(&own_full, 0);

  for (int j = 0; j < n_steps; ++j) {
    const int s = j % G_STAGES;
    const int e = list[j * G + qr / BLK];
    const uint8_t* Qg = ring + s * 2 * T::TILE;
    const uint8_t* dOg = Qg + T::TILE;
    hp::mbar_wait(&full[s], (j / G_STAGES) & 1);
    hp::wgmma_fence();
    hp::issue_abt<D, N>(sc, Qg, GROWS, Ks);
    hp::wgmma_commit();
    hp::issue_abt<D, N>(dp, dOg, GROWS, Vs);
    hp::wgmma_commit();
    const int mask = e < 0 ? 0 : e & 15;
    const int qp = (e >> 4) * BLK + qr % BLK;   // query rows qp, qp + 8
    const float lse2[2] = {lse_s[s][qr], lse_s[s][qr + 8]};
    const float dl[2] = {dl_s[s][qr], dl_s[s][qr + 8]};
    hp::wgmma_wait<1>();
    hp::fence_regs(sc);
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const int hh = (i >> 1) & 1, jj = i >> 2;
      float p = hp::ex2(fmaf(sc[i], scale_log2, -lse2[hh]));
      if (!((mask >> (8 * jj / BLK)) & 1) ||
          (causal && krow[jj] + (i & 1) > qp + 8 * hh))
        p = 0.f;
      sc[i] = p;
    }
    hp::wgmma_wait<0>();
    hp::fence_regs(dp);
#pragma unroll
    for (int i = 0; i < N / 2; ++i)
      dp[i] = sc[i] * (dp[i] - dl[(i >> 1) & 1]);
    hp::named_sync(1, G_CONSUMERS);   // the last step's products read Ps, dSs
    stage_acc<N, T::SWN>(Ps, sc, warp, g, t);
    stage_acc<N, T::SWN>(dSs, dp, warp, g, t);
    hp::fence_proxy_async();
    hp::named_sync(1, G_CONSUMERS);
    hp::wgmma_fence();
    issue_tn<D, N, T::SWN>(dva, dOg, Ps);
    issue_tn<D, N, T::SWN>(dka, Qg, dSs);
    hp::wgmma_commit();
    hp::wgmma_wait<0>();
#pragma unroll
    for (int m = 0; m < D / 64; ++m) {
      hp::fence_regs(dva[m]);
      hp::fence_regs(dka[m]);
    }
    __syncwarp();
    if (lane == 0) hp::mbar_arrive(&empty[s]);
  }

  // dK^T * scale and dV^T (rows d, columns the owned keys) through shared
  // memory
  hp::named_sync(1, G_CONSUMERS);
  bf16* out_k = reinterpret_cast<bf16*>(ring);
  bf16* out_v = out_k + N * T::LDO;
#pragma unroll
  for (int m = 0; m < D / 64; ++m)
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const int at = hp::acc_col(i, t) * T::LDO + 64 * m + qr +
                     8 * ((i >> 1) & 1);
      out_k[at] = __float2bfloat16(dka[m][i] * sm_scale);
      out_v[at] = __float2bfloat16(dva[m][i]);
    }
  hp::named_sync(1, G_CONSUMERS);
  const long stride = (long)H * D;
  const long head = (long)b * S * stride + (long)h * D;
  write_rows<D, BLK, N, T::LDO>(dk + head, stride, own, out_k, tid);
  write_rows<D, BLK, N, T::LDO>(dv + head, stride, own, out_v, tid);
}

// The forward on TMA + wgmma over the gathered walk of the gather table
// (flash_fwd_wgmma's orientation): the CTA owns R = 64 / BLK query blocks
// (Q loaded once, 64 rows: the M side) and gathers G = 64 / BLK key
// blocks a step (the N side): S = Q K_g^T (m64n64, K = D), owner-masked
// (sparse_tile.cuh), the online softmax row-wise in registers (quad
// shuffles), P rounded to bf16 as the A fragments of O += P V_g (V the
// MN-major B: the transpose bit).  S_{j+1} is issued before P_j V_j runs,
// so one step's softmax overlaps the other's product.  Rows whose owner
// visits no block of a step take P = 0 there; a row that sees no key at
// all gives out 0 and lse = NEG_INF + log(1e-30), as the mma.sync kernel.
template <int D>
__host__ __device__ constexpr int fwd_stages() {
  return D == 64 ? 3 : 2;
}

template <int D>
__host__ __device__ constexpr int fwd_ctas() {
  return D == 64 ? 3 : 2;
}

template <int D, int BLK>
__global__ void __launch_bounds__(G_THREADS, fwd_ctas<D>())
sparse_fwd_wgmma(const __grid_constant__ CUtensorMap qmap,
                 const __grid_constant__ CUtensorMap kmap,
                 const __grid_constant__ CUtensorMap vmap,
                 bf16* __restrict__ o, float* __restrict__ lse,
                 const int4* __restrict__ sched, const int* __restrict__ ents,
                 int S, int H, int B, int causal, float scale_log2) {
  using T = hp::RowTile<D>;
  constexpr int G = GROWS / BLK, R = GROWS / BLK, STAGES = fwd_stages<D>();
  constexpr int TILE = GROWS * D * 2;
  extern __shared__ __align__(1024) uint8_t smem_tma[];
  uint8_t* Qs = hp::align1024(smem_tma);
  uint8_t* ring = Qs + TILE;   // slot s: the K tile, then the V tile
  __shared__ __align__(8) uint64_t q_full, full[STAGES], empty[STAGES];
  const int4 job = sched[2 * (blockIdx.x / B)];
  const int4 own = sched[2 * (blockIdx.x / B) + 1];
  const int b = blockIdx.x % B, h = job.x, n_steps = job.y;
  const int* list = ents + job.z;
  const int tid = threadIdx.x;
  if (tid == 0) {
    hp::mbar_init(&q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      hp::mbar_init(&full[s], 1);
      hp::mbar_init(&empty[s], 4);   // one arrival per consumer warp
    }
    hp::mbar_fence_init();
  }
  __syncthreads();

  if (tid >= G_CONSUMERS) {   // producer: TMA from one lane
    if (tid == G_CONSUMERS) {
      hp::mbar_expect_tx(&q_full, TILE);
      for (int r = 0; r < R; ++r) {
        const int qb = owned(own, r);
        for (int c = 0; c < T::NCH; ++c)
          hp::tma_load_4d(Qs + c * GROWS * T::RB + r * BLK * T::RB, &qmap,
                          &q_full, c * T::CH, h, qb >= 0 ? qb * BLK : S, b);
      }
      for (int j = 0; j < n_steps; ++j) {
        const int s = j % STAGES;
        hp::mbar_wait(&empty[s], ((j / STAGES) & 1) ^ 1);
        uint8_t* Ks = ring + s * 2 * TILE;
        hp::mbar_expect_tx(&full[s], 2 * TILE);
        dstt::sparse::gather_boxes<D, BLK>(Ks, &kmap, &full[s],
                                           list + j * G, h, b, S);
        dstt::sparse::gather_boxes<D, BLK>(Ks + TILE, &vmap, &full[s],
                                           list + j * G, h, b, S);
      }
    }
    return;
  }

  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  // this thread's rows 16 warp + g (+ 8): their owner and query position
  int obit[2], qpos[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = 16 * warp + g + 8 * hh;
    obit[hh] = r / BLK;
    qpos[hh] = owned(own, r / BLK) * BLK + r % BLK;
  }
  float oacc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) oacc[i] = 0.f;
  float sc[32];
  uint32_t pa[4][4];
  float m[2] = {NEG_INF, NEG_INF};   // running max, log2 units
  float l[2] = {0.f, 0.f};           // this lane's partial row sums
  float alpha[2] = {1.f, 1.f};

  // mask and online softmax of step j's S tile: new row max m, alpha =
  // 2^(m_old - m_new) for O and l, P = 2^(s - m) into sc (0 where masked)
  auto softmax = [&](int j) {
    int ent[G];
#pragma unroll
    for (int i = 0; i < G; ++i) ent[i] = list[j * G + i];
    dstt::sparse::mask_scores<BLK>(sc, ent, obit, qpos, t, causal,
                                   scale_log2);
    float tmax[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int i = 0; i < 32; ++i)
      tmax[(i >> 1) & 1] = fmaxf(tmax[(i >> 1) & 1], sc[i]);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      tmax[hh] = fmaxf(tmax[hh], __shfl_xor_sync(0xffffffffu, tmax[hh], 1));
      tmax[hh] = fmaxf(tmax[hh], __shfl_xor_sync(0xffffffffu, tmax[hh], 2));
      const float m_new = fmaxf(m[hh], tmax[hh]);
      alpha[hh] = hp::ex2(m[hh] - m_new);   // 1 while the row saw no key
      m[hh] = m_new;
      l[hh] *= alpha[hh];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int hh = (i >> 1) & 1;
      sc[i] = sc[i] > NEG_INF * 0.5f ? hp::ex2(sc[i] - m[hh]) : 0.f;
      l[hh] += sc[i];
    }
  };
  auto rescale = [&]() {
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      oacc[4 * n] *= alpha[0];
      oacc[4 * n + 1] *= alpha[0];
      oacc[4 * n + 2] *= alpha[1];
      oacc[4 * n + 3] *= alpha[1];
    }
    hp::fence_regs(oacc);
  };

  hp::mbar_wait(&q_full, 0);
  if (n_steps > 0) {
    hp::mbar_wait(&full[0], 0);
    hp::wgmma_fence();
    hp::issue_abt<D, GROWS>(sc, Qs, GROWS, ring);
    hp::wgmma_commit();
    hp::wgmma_wait<0>();
    hp::fence_regs(sc);
    softmax(0);
    hp::pack_frags(pa, sc);
  }
  // step j: S_j = Q K_j^T and O = alpha_{j-1} O + P_{j-1} V_{j-1} are
  // issued together; the softmax of S_j runs while P_{j-1} V_{j-1} holds
  // the tensor cores
  for (int j = 1; j < n_steps; ++j) {
    const int s = j % STAGES, sp = (j - 1) % STAGES;
    hp::mbar_wait(&full[s], (j / STAGES) & 1);
    hp::wgmma_fence();
    hp::issue_abt<D, GROWS>(sc, Qs, GROWS, ring + s * 2 * TILE);
    hp::wgmma_commit();
    rescale();
    hp::wgmma_fence();
    hp::issue_rs<D>(oacc, pa, ring + sp * 2 * TILE + TILE);
    hp::wgmma_commit();
    hp::wgmma_wait<1>();   // S_j is done (groups end in order)
    hp::fence_regs(sc);
    softmax(j);
    hp::wgmma_wait<0>();   // P_{j-1} V_{j-1} is done
    hp::fence_regs(oacc);
    __syncwarp();
    if (lane == 0) hp::mbar_arrive(&empty[sp]);
    hp::pack_frags(pa, sc);
  }
  if (n_steps > 0) {   // the last step's P V
    rescale();
    hp::wgmma_fence();
    hp::issue_rs<D>(oacc, pa,
                    ring + (n_steps - 1) % STAGES * 2 * TILE + TILE);
    hp::wgmma_commit();
    hp::wgmma_wait<0>();
    hp::fence_regs(oacc);
  }

  const long stride = (long)H * D;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
    if (owned(own, obit[hh]) < 0) continue;   // a ragged group's gap
    const float lsafe = fmaxf(l[hh], 1e-30f);   // no key seen: out 0
    const float inv = 1.f / lsafe;
    bf16* orow = o + (long)b * S * stride + (long)qpos[hh] * stride +
                 (long)h * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n + 2 * t) =
          __floats2bfloat162_rn(oacc[4 * n + 2 * hh] * inv,
                                oacc[4 * n + 2 * hh + 1] * inv);
    if (t == 0)
      lse[((long)b * H + h) * S + qpos[hh]] =
          (m[hh] > NEG_INF * 0.5f ? m[hh] / LOG2E : NEG_INF) + logf(lsafe);
  }
}

// ---------------------------------------------------------------------
// f32 on the CUDA cores: one warp per row, F32_WARPS rows a CTA
// ---------------------------------------------------------------------
template <int D>
__device__ __forceinline__ float dot_row(const float* a_smem,
                                         const float* b) {
  float acc = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    const float4 x = *reinterpret_cast<const float4*>(a_smem + d);
    const float4 y = *reinterpret_cast<const float4*>(b + d);
    acc += x.x * y.x + x.y * y.y + x.z * y.z + x.w * y.w;
  }
  return acc;
}

template <int D>
__global__ void __launch_bounds__(F32_WARPS * 32)
sparse_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, float* __restrict__ o,
               float* __restrict__ lse, const int* __restrict__ idx, int S,
               int H, int block, int A, int causal, float sm_scale) {
  constexpr int NC = D / 32;
  __shared__ __align__(16) float qs_all[F32_WARPS][D];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int qpos = blockIdx.x * F32_WARPS + warp;
  if (qpos >= S) return;
  const int h = blockIdx.y, b = blockIdx.z;
  const int nqb = S / block, qb = qpos / block;
  const long stride = (long)H * D;
  const long head = (long)b * S * stride + (long)h * D;
  float* qs = qs_all[warp];
  for (int d = lane; d < D; d += 32)
    qs[d] = q[head + (long)qpos * stride + d] * sm_scale;
  __syncwarp();

  float m = NEG_INF, l = 0.f, acc[NC];
#pragma unroll
  for (int j = 0; j < NC; ++j) acc[j] = 0.f;
  const int* row_idx = idx + ((long)h * nqb + qb) * A;
  for (int a = 0; a < A; ++a) {
    const int kb = row_idx[a];
    if (kb < 0) break;
    const int k0 = kb * block;
    for (int c0 = 0; c0 < block; c0 += 32) {
      const int c = c0 + lane;
      float s = NEG_INF;
      if (c < block && (!causal || k0 + c <= qpos))
        s = dot_row<D>(qs, k + head + (long)(k0 + c) * stride);
      const float m_new = fmaxf(m, warp_max(s));
      const float p = s > NEG_INF * 0.5f ? expf(s - m_new) : 0.f;
      const float alpha = expf(m - m_new);
      l = l * alpha + warp_sum(p);
      m = m_new;
#pragma unroll
      for (int j = 0; j < NC; ++j) acc[j] *= alpha;
      const int n = min(32, block - c0);
      for (int cc = 0; cc < n; ++cc) {
        const float pc = __shfl_sync(0xffffffffu, p, cc);
        const float* vrow = v + head + (long)(k0 + c0 + cc) * stride;
#pragma unroll
        for (int j = 0; j < NC; ++j) acc[j] += pc * vrow[lane + 32 * j];
      }
    }
  }
  const float lsafe = fmaxf(l, 1e-30f);
#pragma unroll
  for (int j = 0; j < NC; ++j)
    o[head + (long)qpos * stride + lane + 32 * j] = acc[j] / lsafe;
  if (lane == 0) lse[((long)b * H + h) * S + qpos] = m + logf(lsafe);
}

template <int D>
__global__ void __launch_bounds__(F32_WARPS * 32)
sparse_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ o,
              const float* __restrict__ lse, const float* __restrict__ dout,
              float* __restrict__ dq, const int* __restrict__ idx, int S,
              int H, int block, int A, int causal, float sm_scale) {
  constexpr int NC = D / 32;
  __shared__ __align__(16) float qs_all[F32_WARPS][D];
  __shared__ __align__(16) float ds_all[F32_WARPS][D];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int qpos = blockIdx.x * F32_WARPS + warp;
  if (qpos >= S) return;
  const int h = blockIdx.y, b = blockIdx.z;
  const int nqb = S / block, qb = qpos / block;
  const long stride = (long)H * D;
  const long head = (long)b * S * stride + (long)h * D;
  const long rowoff = head + (long)qpos * stride;
  float* qs = qs_all[warp];
  float* dos = ds_all[warp];
  float part = 0.f;
  for (int d = lane; d < D; d += 32) {
    qs[d] = q[rowoff + d] * sm_scale;
    dos[d] = dout[rowoff + d];
    part += dout[rowoff + d] * o[rowoff + d];
  }
  const float delta = warp_sum(part);
  const float lse_r = lse[((long)b * H + h) * S + qpos];
  __syncwarp();

  float acc[NC];
#pragma unroll
  for (int j = 0; j < NC; ++j) acc[j] = 0.f;
  const int* row_idx = idx + ((long)h * nqb + qb) * A;
  for (int a = 0; a < A; ++a) {
    const int kb = row_idx[a];
    if (kb < 0) break;
    const int k0 = kb * block;
    for (int c0 = 0; c0 < block; c0 += 32) {
      const int c = c0 + lane;
      float ds = 0.f;
      if (c < block && (!causal || k0 + c <= qpos)) {
        const long koff = head + (long)(k0 + c) * stride;
        const float p = expf(dot_row<D>(qs, k + koff) - lse_r);
        ds = p * (dot_row<D>(dos, v + koff) - delta);
      }
      const int n = min(32, block - c0);
      for (int cc = 0; cc < n; ++cc) {
        const float dc = __shfl_sync(0xffffffffu, ds, cc);
        const float* krow = k + head + (long)(k0 + c0 + cc) * stride;
#pragma unroll
        for (int j = 0; j < NC; ++j) acc[j] += dc * krow[lane + 32 * j];
      }
    }
  }
#pragma unroll
  for (int j = 0; j < NC; ++j) dq[rowoff + lane + 32 * j] = acc[j] * sm_scale;
}

template <int D>
__global__ void __launch_bounds__(F32_WARPS * 32)
sparse_dkv_f32(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ o,
               const float* __restrict__ lse, const float* __restrict__ dout,
               float* __restrict__ dk, float* __restrict__ dv,
               const int* __restrict__ rev, int S, int H, int block, int R,
               int causal, float sm_scale) {
  constexpr int NC = D / 32;
  __shared__ __align__(16) float ks_all[F32_WARPS][D];
  __shared__ __align__(16) float vs_all[F32_WARPS][D];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kpos = blockIdx.x * F32_WARPS + warp;
  if (kpos >= S) return;
  const int h = blockIdx.y, b = blockIdx.z;
  const int nkb = S / block, kbi = kpos / block;
  const long stride = (long)H * D;
  const long head = (long)b * S * stride + (long)h * D;
  const long rowoff = head + (long)kpos * stride;
  float* ks = ks_all[warp];
  float* vs = vs_all[warp];
  for (int d = lane; d < D; d += 32) {
    ks[d] = k[rowoff + d];
    vs[d] = v[rowoff + d];
  }
  __syncwarp();

  float dka[NC], dva[NC];
#pragma unroll
  for (int j = 0; j < NC; ++j) dka[j] = dva[j] = 0.f;
  const int* rrow = rev + ((long)h * nkb + kbi) * R;
  for (int r = 0; r < R; ++r) {
    const int qb = rrow[r];
    if (qb < 0) break;
    const int q0 = qb * block;
    for (int i0 = 0; i0 < block; i0 += 32) {
      const int i = i0 + lane;
      float p = 0.f, ds = 0.f;
      if (i < block && (!causal || kpos <= q0 + i)) {
        const long qoff = head + (long)(q0 + i) * stride;
        float s = 0.f, dp = 0.f, delta = 0.f;
        for (int d = 0; d < D; ++d) {
          s += (q[qoff + d] * sm_scale) * ks[d];
          dp += dout[qoff + d] * vs[d];
          delta += dout[qoff + d] * o[qoff + d];
        }
        p = expf(s - lse[((long)b * H + h) * S + q0 + i]);
        ds = p * (dp - delta);
      }
      const int n = min(32, block - i0);
      for (int cc = 0; cc < n; ++cc) {
        const float pc = __shfl_sync(0xffffffffu, p, cc);
        const float dc = __shfl_sync(0xffffffffu, ds, cc);
        const long qoff = head + (long)(q0 + i0 + cc) * stride;
#pragma unroll
        for (int j = 0; j < NC; ++j) {
          dva[j] += pc * dout[qoff + lane + 32 * j];
          dka[j] += dc * (q[qoff + lane + 32 * j] * sm_scale);
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    dk[rowoff + lane + 32 * j] = dka[j];
    dv[rowoff + lane + 32 * j] = dva[j];
  }
}

// ---------------------------------------------------------------------
struct Shape {
  int B, S, H, D, block, n, causal;
  float scale;
};

bool bad(const Shape& s, int dtype) {
  return s.B <= 0 || s.S <= 0 || s.H <= 0 || s.n <= 0 || s.block < 8 ||
         s.block > MAX_BLOCK || s.block % 8 || s.S % s.block ||
         (s.D != 64 && s.D != 128 && s.D != 192 && s.D != 256) ||
         (dtype != 0 && dtype != 1);
}

// threads and dynamic shared memory of the bf16 kernels: one 16-row warp
// per 16 rows of the block
int mma_threads(int block) { return 32 * ((block + 15) / 16); }

constexpr int MAX_SMEM = 227 * 1024;   // a CTA's dynamic shared memory

// The backward kernels' rows per CTA (a multiple of 16) and CTAs per
// block: the whole block in one CTA where its tiles fit, else the block's
// own rows split over the fewest CTAs whose tiles do.
template <int D>
void bwd_tiles(int block, int* rows, int* split) {
  const int whole = (block + 15) / 16 * 16;
  *split = 1;
  *rows = whole;
  while (bwd_smem<D>(*rows, whole) > MAX_SMEM) {
    ++*split;
    *rows = ((block + *split - 1) / *split + 15) / 16 * 16;
  }
}

template <typename K>
int set_smem(K kern, int bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int D>
int fwd(const void* q, const void* k, const void* v, void* o, void* lse,
        const void* idx, const Shape& s, int dtype, cudaStream_t st) {
  if (dtype == 1) {
    const int threads = mma_threads(s.block);
    const int smem = 3 * (threads / 2) * ld_bf16<D>() * 2;
    int err = set_smem(sparse_fwd_mma<D>, smem);
    if (err) return err;
    sparse_fwd_mma<D><<<dim3(s.S / s.block, s.H, s.B), threads, smem, st>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o,
        (float*)lse, (const int*)idx, s.S, s.H, s.block, s.n, s.causal,
        s.scale);
  } else {
    sparse_fwd_f32<D><<<dim3((s.S + F32_WARPS - 1) / F32_WARPS, s.H, s.B),
                        F32_WARPS * 32, 0, st>>>(
        (const float*)q, (const float*)k, (const float*)v, (float*)o,
        (float*)lse, (const int*)idx, s.S, s.H, s.block, s.n, s.causal,
        s.scale);
  }
  return (int)cudaGetLastError();
}

template <int D>
int dq(const void* q, const void* k, const void* v, const void* o,
       const void* lse, const void* dout, void* dqo, const void* idx,
       const Shape& s, int dtype, cudaStream_t st) {
  if (dtype == 1) {
    int rows, split;
    bwd_tiles<D>(s.block, &rows, &split);
    const int smem = bwd_smem<D>(rows, (s.block + 15) / 16 * 16);
    int err = set_smem(sparse_dq_mma<D>, smem);
    if (err) return err;
    sparse_dq_mma<D><<<dim3(s.S / s.block * split, s.H, s.B), 2 * rows,
                       smem, st>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)o,
        (const float*)lse, (const bf16*)dout, (bf16*)dqo, (const int*)idx,
        s.S, s.H, s.block, s.n, s.causal, s.scale, split);
  } else {
    sparse_dq_f32<D><<<dim3((s.S + F32_WARPS - 1) / F32_WARPS, s.H, s.B),
                       F32_WARPS * 32, 0, st>>>(
        (const float*)q, (const float*)k, (const float*)v, (const float*)o,
        (const float*)lse, (const float*)dout, (float*)dqo, (const int*)idx,
        s.S, s.H, s.block, s.n, s.causal, s.scale);
  }
  return (int)cudaGetLastError();
}

template <int D>
int dkv(const void* q, const void* k, const void* v, const void* o,
        const void* lse, const void* dout, void* dko, void* dvo,
        const void* rev, const Shape& s, int dtype, cudaStream_t st) {
  if (dtype == 1) {
    int rows, split;
    bwd_tiles<D>(s.block, &rows, &split);
    const int smem = bwd_smem<D>(rows, (s.block + 15) / 16 * 16);
    int err = set_smem(sparse_dkv_mma<D>, smem);
    if (err) return err;
    sparse_dkv_mma<D><<<dim3(s.S / s.block * split, s.H, s.B), 2 * rows,
                        smem, st>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)o,
        (const float*)lse, (const bf16*)dout, (bf16*)dko, (bf16*)dvo,
        (const int*)rev, s.S, s.H, s.block, s.n, s.causal, s.scale, split);
  } else {
    sparse_dkv_f32<D><<<dim3((s.S + F32_WARPS - 1) / F32_WARPS, s.H, s.B),
                        F32_WARPS * 32, 0, st>>>(
        (const float*)q, (const float*)k, (const float*)v, (const float*)o,
        (const float*)lse, (const float*)dout, (float*)dko, (float*)dvo,
        (const int*)rev, s.S, s.H, s.block, s.n, s.causal, s.scale);
  }
  return (int)cudaGetLastError();
}

// A bf16 tensor map of [B, S, H, D] (innermost first: D, H, S, B) whose
// box is BLK rows of one head in 64-column boxes (the 128-byte swizzle).
template <int D, int BLK>
int walk_map(CUtensorMap* map, const void* base, int B, int S, int H) {
  using T = hp::RowTile<D>;
  const uint64_t dims[4] = {D, (uint64_t)H, (uint64_t)S, (uint64_t)B};
  const uint64_t strides[3] = {D * 2, (uint64_t)H * D * 2,
                               (uint64_t)S * H * D * 2};
  const uint32_t box[4] = {T::CH, 1, BLK, 1};
  return hp::make_map_bf16(map, base, 4, dims, strides, box, T::SW);
}

struct WalkArgs {
  const void *q, *k, *v, *lse, *dout, *delta, *sched, *ents;
  void *out1, *out2;   // dq; or dk, dv
  int n_ctas, B, S, H, causal;
  float scale;
};

template <int D, int BLK, int R>
int launch_walk(const WalkArgs& a, bool dkv, cudaStream_t st) {
  using T = Walk<D, BLK, R>;
  CUtensorMap qm, km, vm, dm;
  int rc = walk_map<D, BLK>(&qm, a.q, a.B, a.S, a.H);
  if (!rc) rc = walk_map<D, BLK>(&km, a.k, a.B, a.S, a.H);
  if (!rc) rc = walk_map<D, BLK>(&vm, a.v, a.B, a.S, a.H);
  if (!rc) rc = walk_map<D, BLK>(&dm, a.dout, a.B, a.S, a.H);
  if (rc) return rc;
  const unsigned grid = (unsigned)a.n_ctas * a.B;
  const float sl2 = a.scale * LOG2E;
  if (dkv) {
    const int smem = T::smem(2);
    int err = set_smem(sparse_dkv_wgmma<D, BLK, R>, smem);
    if (err) return err;
    sparse_dkv_wgmma<D, BLK, R><<<grid, G_THREADS, smem, st>>>(
        qm, km, vm, dm, (const float*)a.lse, (const float*)a.delta,
        (bf16*)a.out1, (bf16*)a.out2, (const int4*)a.sched,
        (const int*)a.ents, a.S, a.H, a.B, a.causal, sl2, a.scale);
  } else {
    const int smem = T::smem(1);
    int err = set_smem(sparse_dq_wgmma<D, BLK, R>, smem);
    if (err) return err;
    sparse_dq_wgmma<D, BLK, R><<<grid, G_THREADS, smem, st>>>(
        qm, km, vm, dm, (const float*)a.lse, (const float*)a.delta,
        (bf16*)a.out1, (const int4*)a.sched, (const int*)a.ents, a.S, a.H,
        a.B, a.causal, sl2, a.scale);
  }
  return (int)cudaGetLastError();
}

// (block, owners a CTA) pairs of the gathered plan: N = block * R <= 64
template <int D>
int walk_by_tile(int block, int R, const WalkArgs& a, bool dkv,
                 cudaStream_t st) {
  if (block == 16 && R == 1) return launch_walk<D, 16, 1>(a, dkv, st);
  if (block == 16 && R == 2) return launch_walk<D, 16, 2>(a, dkv, st);
  if (block == 16 && R == 4) return launch_walk<D, 16, 4>(a, dkv, st);
  if (block == 32 && R == 1) return launch_walk<D, 32, 1>(a, dkv, st);
  if (block == 32 && R == 2) return launch_walk<D, 32, 2>(a, dkv, st);
  if (block == 64 && R == 1) return launch_walk<D, 64, 1>(a, dkv, st);
  return (int)cudaErrorInvalidValue;
}

int walk(int D, int block, int R, const WalkArgs& a, bool dkv,
         cudaStream_t st) {
  if (a.B <= 0 || a.H <= 0 || a.n_ctas <= 0 || a.S <= 0 || a.S % block ||
      a.delta == nullptr)
    return (int)cudaErrorInvalidValue;
  if (D == 64) return walk_by_tile<64>(block, R, a, dkv, st);
  if (D == 128) return walk_by_tile<128>(block, R, a, dkv, st);
  return (int)cudaErrorInvalidValue;
}

struct FwdArgs {
  const void *q, *k, *v, *sched, *ents;
  void *o, *lse;
  int n_ctas, B, S, H, causal;
  float scale;
};

template <int D, int BLK>
int launch_fwd_walk(const FwdArgs& a, cudaStream_t st) {
  CUtensorMap qm, km, vm;
  int rc = walk_map<D, BLK>(&qm, a.q, a.B, a.S, a.H);
  if (!rc) rc = walk_map<D, BLK>(&km, a.k, a.B, a.S, a.H);
  if (!rc) rc = walk_map<D, BLK>(&vm, a.v, a.B, a.S, a.H);
  if (rc) return rc;
  constexpr int smem = 1024 + GROWS * D * 2 * (1 + 2 * fwd_stages<D>());
  int err = set_smem(sparse_fwd_wgmma<D, BLK>, smem);
  if (err) return err;
  sparse_fwd_wgmma<D, BLK><<<(unsigned)a.n_ctas * a.B, G_THREADS, smem,
                             st>>>(
      qm, km, vm, (bf16*)a.o, (float*)a.lse, (const int4*)a.sched,
      (const int*)a.ents, a.S, a.H, a.B, a.causal, a.scale * LOG2E);
  return (int)cudaGetLastError();
}

template <int D>
int fwd_walk_by_block(int block, const FwdArgs& a, cudaStream_t st) {
  if (block == 16) return launch_fwd_walk<D, 16>(a, st);
  if (block == 32) return launch_fwd_walk<D, 32>(a, st);
  if (block == 64) return launch_fwd_walk<D, 64>(a, st);
  return (int)cudaErrorInvalidValue;
}

template <int D>
int launch_delta(const void* o, const void* dout, void* delta, int B, int S,
                 int H, cudaStream_t st) {
  constexpr int RPB = DELTA_THREADS / DELTA_TPR;
  const long rows = (long)B * S * H;
  sparse_bwd_delta<D><<<(unsigned)((rows + RPB - 1) / RPB), DELTA_THREADS, 0,
                        st>>>((const bf16*)o, (const bf16*)dout,
                              (float*)delta, rows, S, H);
  return (int)cudaGetLastError();
}

// The launcher F<D> for head dim D (one of the four `bad` lets through).
#define SPARSE_BY_D(dim, F, ...)                            \
  ((dim) == 64    ? F<64>(__VA_ARGS__)                      \
   : (dim) == 128 ? F<128>(__VA_ARGS__)                     \
   : (dim) == 192 ? F<192>(__VA_ARGS__)                     \
                  : F<256>(__VA_ARGS__))

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  A (R): the table's last dim.  Each
// returns cudaGetLastError() after its launch (cudaErrorInvalidValue for an
// unsupported head dim, block, shape or dtype).
extern "C" int dstt_sparse_fwd(const void* q, const void* k, const void* v,
                               void* o, void* lse, const void* idx, int B,
                               int S, int H, int D, int block, int A,
                               int causal, float scale, int dtype,
                               void* stream) {
  const Shape s{B, S, H, D, block, A, causal, scale};
  if (bad(s, dtype)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return SPARSE_BY_D(D, fwd, q, k, v, o, lse, idx, s, dtype, st);
}

extern "C" int dstt_sparse_dq(const void* q, const void* k, const void* v,
                              const void* o, const void* lse,
                              const void* dout, void* dqo, const void* idx,
                              int B, int S, int H, int D, int block, int A,
                              int causal, float scale, int dtype,
                              void* stream) {
  const Shape s{B, S, H, D, block, A, causal, scale};
  if (bad(s, dtype)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return SPARSE_BY_D(D, dq, q, k, v, o, lse, dout, dqo, idx, s, dtype, st);
}

extern "C" int dstt_sparse_dkv(const void* q, const void* k, const void* v,
                               const void* o, const void* lse,
                               const void* dout, void* dko, void* dvo,
                               const void* rev, int B, int S, int H, int D,
                               int block, int R, int causal, float scale,
                               int dtype, void* stream) {
  const Shape s{B, S, H, D, block, R, causal, scale};
  if (bad(s, dtype)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return SPARSE_BY_D(D, dkv, q, k, v, o, lse, dout, dko, dvo, rev, s, dtype,
                     st);
}

// delta [B, H, S] f32 = rowsum(dO * out) over bf16 out / dO [B, S, H, D],
// D 64 or 128 (what the wgmma pair reads).
extern "C" int dstt_sparse_bwd_delta(const void* o, const void* dout,
                                     void* delta, int B, int S, int H,
                                     int D, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  if (D == 64) return launch_delta<64>(o, dout, delta, B, S, H, st);
  if (D == 128) return launch_delta<128>(o, dout, delta, B, S, H, st);
  return (int)cudaErrorInvalidValue;
}

// The bf16 TMA + wgmma dq and dk/dv over a gathered tile plan (sched
// [n_ctas] two int4 and its lists `ents`, R owned blocks a CTA): D 64 or 128,
// block 16 (R 1, 2, 4), 32 (R 1, 2) or 64 (R 1); delta from
// dstt_sparse_bwd_delta.  Each returns cudaGetLastError() after its
// launch (cudaErrorInvalidValue for what it does not take).
extern "C" int dstt_sparse_dq_wgmma(const void* q, const void* k,
                                    const void* v, const void* lse,
                                    const void* dout, const void* delta,
                                    void* dqo, const void* sched,
                                    const void* ents, int n_ctas, int R,
                                    int B, int S, int H, int D, int block,
                                    int causal, float scale, void* stream) {
  const WalkArgs a{q,   k,      v, lse, dout, delta, sched, ents, dqo,
                   nullptr, n_ctas, B, S,   H,    causal, scale};
  return walk(D, block, R, a, false, static_cast<cudaStream_t>(stream));
}

extern "C" int dstt_sparse_dkv_wgmma(const void* q, const void* k,
                                     const void* v, const void* lse,
                                     const void* dout, const void* delta,
                                     void* dko, void* dvo, const void* sched,
                                     const void* ents, int n_ctas, int R,
                                     int B, int S, int H, int D, int block,
                                     int causal, float scale, void* stream) {
  const WalkArgs a{q,   k,   v,      lse, dout, delta, sched,  ents,
                   dko, dvo, n_ctas, B,   S,    H,     causal, scale};
  return walk(D, block, R, a, true, static_cast<cudaStream_t>(stream));
}

// The bf16 TMA + wgmma forward over the gathered walk of the gather table
// (sched [n_ctas] two int4 and its lists `ents`, 64 / block owned query
// blocks a CTA, -1 for a ragged group's gap): D 64 or 128, block 16, 32
// or 64.  Returns cudaGetLastError() after its launch
// (cudaErrorInvalidValue for what it does not take).
extern "C" int dstt_sparse_fwd_wgmma(const void* q, const void* k,
                                     const void* v, void* o, void* lse,
                                     const void* sched, const void* ents,
                                     int n_ctas, int B, int S, int H, int D,
                                     int block, int causal, float scale,
                                     void* stream) {
  if (B <= 0 || H <= 0 || n_ctas <= 0 || S <= 0 || block <= 0 ||
      S % block)
    return (int)cudaErrorInvalidValue;
  const FwdArgs a{q, k, v, sched, ents, o, lse, n_ctas, B, S, H, causal,
                  scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64) return fwd_walk_by_block<64>(block, a, st);
  if (D == 128) return fwd_walk_by_block<128>(block, a, st);
  return (int)cudaErrorInvalidValue;
}
