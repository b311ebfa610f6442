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
// delta = rowsum(dO * O) is computed inside the kernels, as flash_bwd.cu
// does: by the dq CTA for its own rows, and by each dk/dv CTA for each
// q-block it visits, two threads a row with 16-byte loads (no [B, H, S]
// array of it is written).
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
// that are each block read once; the first form here reloads K/V for every
// visit, feeds the tensor cores one tile at a time with no copy/compute
// overlap, and at block 16 runs one warp per CTA.  A BigBird global row (or
// a global key block in dk/dv) walks every block while the others walk a
// few: the load is imbalanced and nothing here evens it out.
#include "attn_tile.cuh"

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
