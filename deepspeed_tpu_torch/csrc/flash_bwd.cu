// Causal flash-attention backward for Hopper (sm_90a): the dq kernel and
// the dk/dv kernel.
//
// Replaces the TPU kernels of deepspeed_tpu/ops/flash_attention.py
// `_bwd_vjp`: `_bwd_dq_kernel` (pallas_call at :374) and `_bwd_dkv_kernel`
// (pallas_call at :398).  Inputs are the forward's residuals (q, k, v, out,
// lse) and dO; delta = rowsum(dO * O) is computed in the kernels, as on the
// TPU, so no [B, NH, S] array of it is written.
//
// Layout (the JAX public one, no transposes): q, out, dO, dq [B, S, NH, D];
// k, v, dk, dv [B, S, NKV, D]; lse [B, NH, S] f32.  Any S (ragged tails are
// masked), causal or not, GQA with NH % NKV == 0, D in {32, 64, 128}.
//
//   dq kernel, grid (ceil(S/64), NH, B): one CTA per 64-row query tile of
//     one head.  It computes delta for its rows, then walks key tiles of
//     64 up to the diagonal: S = Q K^T, P = exp(S*scale - lse), dP = dO V^T,
//     dS = P * (dP - delta), dQ += dS K in f32; it writes dQ * scale once.
//   dk/dv kernel, grid (ceil(S/64), NKV, B): one CTA per 64-key tile of one
//     KV head.  It walks the q heads of its GQA group and, for each, the
//     64-row query tiles from the diagonal on, each in two 32-row
//     passes (registers): S^T = K Q^T, P^T, dP^T =
//     V dO^T, dS^T; dV += P^T dO and dK += dS^T Q in f32 registers, and
//     writes dK * scale and dV once.  The TPU kernel writes dk/dv per q head
//     in bf16 and sums the group outside; here the group sum is f32 inside
//     the CTA.  No atomics: every output element is written by one thread,
//     so the result is the same on every run.
//
// bf16 runs on the tensor cores with mma.sync m16n8k16 (f32 accumulate):
// four warps of 16 rows (query rows in the dq kernel, key rows in the dk/dv
// kernel), the tiles staged in shared memory as bf16 with rows padded by 8
// elements; products whose B operand is row-major in the contraction dim
// (dS K, P^T dO, dS^T Q) read it with ldmatrix.trans, and P / dS are
// rounded to bf16 and reused from the accumulator registers as the A
// operand (as the forward does with P; the TPU kernels round them too).
// f32 runs on the CUDA cores with exact f32 products (4 threads per row,
// as attn_tile.cuh's f32 core).
//
// What bounds it on the H100 at the training shape ([4, 2048, 16, 128]
// bf16, causal): operations.  dq does 3 and dk/dv 4 causal [S, S, D]
// matmuls per head (1.03e11 and 1.37e11 FLOP: 0.104 and 0.139 ms at 989
// TFLOP/s) against ~200 MB of bytes (0.06 ms).  This first form feeds the
// tensor cores one tile at a time from shared memory with no copy/compute
// overlap; TMA, wgmma and a ring of stages are the next step.
#include "attn_tile.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int BQ = dstt::BQ;     // query rows per dq CTA (64)
constexpr int BK = dstt::BK;     // keys per tile (64)
constexpr int QT = 64;           // query rows staged per dk/dv tile
constexpr int QSUB = 32;         // query rows per dk/dv product pass
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Copy `rows` rows of D bf16 (global row stride `stride`) into a shared
// tile of `tile_rows` rows of leading dim LD, zero-filling rows >= rows.
template <int D, int LD>
__device__ __forceinline__ void stage_bf16(bf16* dst, const bf16* src,
                                           long stride, int rows,
                                           int tile_rows, int tid,
                                           int nthreads) {
  constexpr int NV = D / 8;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int idx = tid; idx < tile_rows * NV; idx += nthreads) {
    const int row = idx / NV;
    const int c = (idx % NV) * 8;
    *reinterpret_cast<uint4*>(dst + row * LD + c) =
        row < rows ? *reinterpret_cast<const uint4*>(src + row * stride + c)
                   : zero;
  }
}

// A fragment (m16n8k16, row-major) of rows r0 and r0 + 8 at column k0.
__device__ __forceinline__ void frag_a(uint32_t* a, const bf16* tile,
                                       int LD, int r0, int k0, int t) {
  const bf16* p = tile + r0 * LD + k0 + 2 * t;
  a[0] = dstt::ld_u32(p);
  a[1] = dstt::ld_u32(p + 8 * LD);
  a[2] = dstt::ld_u32(p + 8);
  a[3] = dstt::ld_u32(p + 8 * LD + 8);
}

// f32 accumulators of a 16 x 16k tile (n-tiles 2kk, 2kk+1) as the bf16 A
// fragment of the next product.
__device__ __forceinline__ void acc_to_a(uint32_t* a, const float (*s)[4],
                                         int kk) {
  a[0] = dstt::pack_bf16(s[2 * kk][0], s[2 * kk][1]);
  a[1] = dstt::pack_bf16(s[2 * kk][2], s[2 * kk][3]);
  a[2] = dstt::pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
  a[3] = dstt::pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
}

// acc[16 x D] += A[16 x 16] * Bt where Bt is a row-major [16, D] shared
// tile (rows = the contraction dim) read with ldmatrix.trans.
template <int D>
__device__ __forceinline__ void mma_rowmajor_b(float (*acc)[4],
                                               const uint32_t* a,
                                               const bf16* bt, int LD,
                                               int lane) {
  const bf16* row =
      bt + ((lane & 7) + ((lane >> 3) & 1) * 8) * LD + (lane >> 4) * 8;
#pragma unroll
  for (int n = 0; n < D / 16; ++n) {
    uint32_t b[4];
    dstt::ldmatrix_x4_trans(b, row + n * 16);
    dstt::mma_bf16(acc[2 * n], a, b[0], b[1]);
    dstt::mma_bf16(acc[2 * n + 1], a, b[2], b[3]);
  }
}

template <int D>
constexpr int dq_mma_smem() {
  return (2 * BQ + 2 * BK) * (D + 8) * 2 + 2 * BQ * 4;
}

template <int D>
__global__ void __launch_bounds__(dstt::MMA_THREADS)
flash_bwd_dq_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ o,
                 const float* __restrict__ lse, const bf16* __restrict__ dout,
                 bf16* __restrict__ dq, int S, int NH, int NKV, int causal,
                 float sm_scale) {
  constexpr int LD = D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dOs = Qs + BQ * LD;
  bf16* Ks = dOs + BQ * LD;
  bf16* Vs = Ks + BK * LD;
  float* lse_s = reinterpret_cast<float*>(Vs + BK * LD);
  float* delta_s = lse_s + BQ;

  // the last query tiles walk the most key tiles: launch them first so
  // the short ones fill the tail of the grid
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (NH / NKV);
  const int n_rows = min(BQ, S - q0);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int r0 = warp * 16 + g;   // this lane's rows: r0 and r0 + 8
  const long q_stride = (long)NH * D;
  const long q_base = ((long)b * S + q0) * NH * D + (long)h * D;
  const long kv_stride = (long)NKV * D;
  const long kv_base = (long)b * S * NKV * D + (long)kvh * D;

  stage_bf16<D, LD>(Qs, q + q_base, q_stride, n_rows, BQ, tid,
                    dstt::MMA_THREADS);
  stage_bf16<D, LD>(dOs, dout + q_base, q_stride, n_rows, BQ, tid,
                    dstt::MMA_THREADS);
  for (int r = tid; r < BQ; r += dstt::MMA_THREADS)
    lse_s[r] = r < n_rows ? lse[((long)b * NH + h) * S + q0 + r] * LOG2E
                          : INFINITY;   // padding rows: P = 0
  __syncthreads();
  // delta = rowsum(dO * O) in f32, warp w for its own 16 rows
  for (int rr = 0; rr < 16; ++rr) {
    const int row = warp * 16 + rr;
    float part = 0.f;
    if (row < n_rows)
      for (int d = lane; d < D; d += 32)
        part += __bfloat162float(dOs[row * LD + d]) *
                __bfloat162float(o[q_base + row * q_stride + d]);
    part = warp_sum(part);
    if (lane == 0) delta_s[row] = part;
  }
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

  const int k_end = causal ? min(S, q0 + n_rows) : S;
  for (int kt0 = 0; kt0 < k_end; kt0 += BK) {
    __syncthreads();   // the previous tile's readers are done
    const int nk = min(BK, k_end - kt0);
    stage_bf16<D, LD>(Ks, k + kv_base + (long)kt0 * kv_stride, kv_stride,
                      nk, BK, tid, dstt::MMA_THREADS);
    stage_bf16<D, LD>(Vs, v + kv_base + (long)kt0 * kv_stride, kv_stride,
                      nk, BK, tid, dstt::MMA_THREADS);
    __syncthreads();

    float s[BK / 8][4], dp[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t qa[4], da[4];
      frag_a(qa, Qs, LD, r0, kk * 16, t);
      frag_a(da, dOs, LD, r0, kk * 16, t);
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        const bf16* kr = Ks + (j * 8 + g) * LD + kk * 16 + 2 * t;
        dstt::mma_bf16(s[j], qa, dstt::ld_u32(kr), dstt::ld_u32(kr + 8));
        const bf16* vr = Vs + (j * 8 + g) * LD + kk * 16 + 2 * t;
        dstt::mma_bf16(dp[j], da, dstt::ld_u32(vr), dstt::ld_u32(vr + 8));
      }
    }
    // s[j][0..1]: row r0, keys kt0+8j+2t+{0,1}; s[j][2..3]: row r0+8
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hh = e >> 1;
        const int kp = kt0 + 8 * j + 2 * t + (e & 1);
        const bool vis = kp < k_end && (!causal || kp <= qp[hh]);
        const float p = vis ? exp2f(s[j][e] * scale2 - lse_r[hh]) : 0.f;
        s[j][e] = p * (dp[j][e] - delta_r[hh]);   // dS
      }
    }
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[4];
      acc_to_a(a, s, kk);
      mma_rowmajor_b<D>(dqacc, a, Ks + kk * 16 * LD, LD, lane);
    }
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = r0 + 8 * hh;
    if (r >= n_rows) continue;
    bf16* row = dq + q_base + r * q_stride;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(row + n * 8 + 2 * t) =
          __floats2bfloat162_rn(dqacc[n][2 * hh] * sm_scale,
                                dqacc[n][2 * hh + 1] * sm_scale);
  }
}

template <int D>
constexpr int dkv_mma_smem() {
  return (2 * BK + 2 * QT) * (D + 8) * 2 + 2 * QT * 4;
}

template <int D>
__global__ void __launch_bounds__(dstt::MMA_THREADS)
flash_bwd_dkv_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const bf16* __restrict__ o,
                  const float* __restrict__ lse,
                  const bf16* __restrict__ dout, bf16* __restrict__ dk,
                  bf16* __restrict__ dv, int S, int NH, int NKV, int causal,
                  float sm_scale) {
  constexpr int LD = D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + BK * LD;
  bf16* Qs = Vs + BK * LD;
  bf16* dOs = Qs + QT * LD;
  float* lse_s = reinterpret_cast<float*>(dOs + QT * LD);
  float* delta_s = lse_s + QT;

  const int k0 = blockIdx.x * BK;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = NH / NKV;
  const int n_keys = min(BK, S - k0);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int r0 = warp * 16 + g;   // this lane's key rows: r0 and r0 + 8
  const long kv_stride = (long)NKV * D;
  const long kv_base = ((long)b * S + k0) * NKV * D + (long)kvh * D;
  const long q_stride = (long)NH * D;
  const int kp[2] = {k0 + r0, k0 + r0 + 8};
  const float scale2 = sm_scale * LOG2E;

  stage_bf16<D, LD>(Ks, k + kv_base, kv_stride, n_keys, BK, tid,
                    dstt::MMA_THREADS);
  stage_bf16<D, LD>(Vs, v + kv_base, kv_stride, n_keys, BK, tid,
                    dstt::MMA_THREADS);

  float dkacc[D / 8][4], dvacc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dkacc[n][e] = dvacc[n][e] = 0.f;

  // query rows before k0 see none of these keys (k0 is a multiple of QT)
  const int q_begin = causal ? k0 : 0;
  for (int hq = kvh * G; hq < (kvh + 1) * G; ++hq) {
    const long head_base = (long)b * S * NH * D + (long)hq * D;
    const float* lse_h = lse + ((long)b * NH + hq) * S;
    for (int qt0 = q_begin; qt0 < S; qt0 += QT) {
      const int nq = min(QT, S - qt0);
      const long q_base = head_base + (long)qt0 * q_stride;
      __syncthreads();   // the previous tile's readers are done
      stage_bf16<D, LD>(Qs, q + q_base, q_stride, nq, QT, tid,
                        dstt::MMA_THREADS);
      stage_bf16<D, LD>(dOs, dout + q_base, q_stride, nq, QT, tid,
                        dstt::MMA_THREADS);
      for (int r = tid; r < QT; r += dstt::MMA_THREADS)
        lse_s[r] = r < nq ? lse_h[qt0 + r] * LOG2E : INFINITY;
      __syncthreads();
      // delta for the tile's rows: warp w takes rows 16w .. 16w+15
      for (int rr = 0; rr < QT / 4; ++rr) {
        const int row = warp * (QT / 4) + rr;
        float part = 0.f;
        if (row < nq)
          for (int d = lane; d < D; d += 32)
            part += __bfloat162float(dOs[row * LD + d]) *
                    __bfloat162float(o[q_base + row * q_stride + d]);
        part = warp_sum(part);
        if (lane == 0) delta_s[row] = part;
      }
      __syncthreads();

      // two passes of QSUB rows keep P^T and dS^T at 16 registers each
      for (int sub = 0; sub < QT && qt0 + sub < S; sub += QSUB) {
        const bf16* Qp = Qs + sub * LD;
        const bf16* dOp = dOs + sub * LD;
        float st[QSUB / 8][4], dpt[QSUB / 8][4];
#pragma unroll
        for (int j = 0; j < QSUB / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          uint32_t ka[4], va[4];
          frag_a(ka, Ks, LD, r0, kk * 16, t);
          frag_a(va, Vs, LD, r0, kk * 16, t);
#pragma unroll
          for (int j = 0; j < QSUB / 8; ++j) {
            const bf16* qr = Qp + (j * 8 + g) * LD + kk * 16 + 2 * t;
            dstt::mma_bf16(st[j], ka, dstt::ld_u32(qr),
                           dstt::ld_u32(qr + 8));
            const bf16* dr = dOp + (j * 8 + g) * LD + kk * 16 + 2 * t;
            dstt::mma_bf16(dpt[j], va, dstt::ld_u32(dr),
                           dstt::ld_u32(dr + 8));
          }
        }
        // st[j][0..1]: key r0, query rows sub+8j+2t+{0,1}; [2..3]: key
        // r0+8
#pragma unroll
        for (int j = 0; j < QSUB / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int hk = e >> 1;
            const int r = sub + 8 * j + 2 * t + (e & 1);
            const int qpos = qt0 + r;
            const bool vis = kp[hk] < S && qpos < S &&
                             (!causal || kp[hk] <= qpos);
            const float p =
                vis ? exp2f(st[j][e] * scale2 - lse_s[r]) : 0.f;
            dpt[j][e] = p * (dpt[j][e] - delta_s[r]);   // dS^T
            st[j][e] = p;                               // P^T
          }
        }
#pragma unroll
        for (int kk = 0; kk < QSUB / 16; ++kk) {
          uint32_t pa[4], dsa[4];
          acc_to_a(pa, st, kk);
          acc_to_a(dsa, dpt, kk);
          mma_rowmajor_b<D>(dvacc, pa, dOp + kk * 16 * LD, LD, lane);
          mma_rowmajor_b<D>(dkacc, dsa, Qp + kk * 16 * LD, LD, lane);
        }
      }
    }
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = r0 + 8 * hh;
    if (r >= n_keys) continue;
    bf16* dkr = dk + kv_base + r * kv_stride;
    bf16* dvr = dv + kv_base + r * kv_stride;
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
// f32 forms on the CUDA cores: 256 threads, 4 per row (thread (r, p) takes
// columns p, p+4, ..., p+60 of a 64-wide tile and output columns
// 4*(p+4g) .. +3, g < D/16), tiles in shared memory as f32 with rows
// padded by 4 floats.
constexpr int F32_THREADS = dstt::NTHREADS;

template <int D>
__device__ __forceinline__ void stage_f32(float* dst, const float* src,
                                          long stride, int rows,
                                          int tile_rows, int tid) {
  constexpr int LD = D + 4;
  for (int idx = tid; idx < tile_rows * (D / 4); idx += F32_THREADS) {
    const int row = idx / (D / 4);
    const int c = (idx % (D / 4)) * 4;
    *reinterpret_cast<float4*>(dst + row * LD + c) =
        row < rows ? *reinterpret_cast<const float4*>(src + row * stride + c)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

// delta of row r (rows >= rows give 0): the 4 threads of the row sum its
// output columns and reduce with two xor shuffles.
template <int D>
__device__ __forceinline__ float row_delta(const float* dOs, const float* o,
                                           long stride, int r, int p,
                                           int rows) {
  constexpr int LD = D + 4;
  float part = 0.f;
  if (r < rows)
    for (int gg = 0; gg < D / 16; ++gg) {
      const int c = 4 * (p + 4 * gg);
      part += dot4(*reinterpret_cast<const float4*>(dOs + r * LD + c),
                   *reinterpret_cast<const float4*>(o + r * stride + c));
    }
  part += __shfl_xor_sync(0xffffffffu, part, 1);
  part += __shfl_xor_sync(0xffffffffu, part, 2);
  return part;
}

template <int D>
constexpr int dq_f32_smem() {
  return (2 * BQ + 2 * BK) * (D + 4) * 4 + BQ * (BK + 4) * 4;
}

template <int D>
__global__ void __launch_bounds__(F32_THREADS)
flash_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ o,
                 const float* __restrict__ lse,
                 const float* __restrict__ dout, float* __restrict__ dq,
                 int S, int NH, int NKV, int causal, float sm_scale) {
  constexpr int LD = D + 4;
  constexpr int LDP = BK + 4;
  constexpr int NG = D / 16;
  extern __shared__ __align__(16) float fsmem[];
  float* Qs = fsmem;
  float* dOs = Qs + BQ * LD;
  float* Ks = dOs + BQ * LD;
  float* Vs = Ks + BK * LD;
  float* DSs = Vs + BK * LD;

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (NH / NKV);
  const int n_rows = min(BQ, S - q0);
  const int tid = threadIdx.x;
  const int r = tid >> 2;
  const int p = tid & 3;
  const int qpos = q0 + r;
  const long q_stride = (long)NH * D;
  const long q_base = ((long)b * S + q0) * NH * D + (long)h * D;
  const long kv_stride = (long)NKV * D;
  const long kv_base = (long)b * S * NKV * D + (long)kvh * D;

  stage_f32<D>(Qs, q + q_base, q_stride, n_rows, BQ, tid);
  stage_f32<D>(dOs, dout + q_base, q_stride, n_rows, BQ, tid);
  __syncthreads();
  const float delta = row_delta<D>(dOs, o + q_base, q_stride, r, p, n_rows);
  const float lse_r =
      r < n_rows ? lse[((long)b * NH + h) * S + qpos] : INFINITY;

  float acc[NG][4];
#pragma unroll
  for (int gg = 0; gg < NG; ++gg)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[gg][e] = 0.f;

  const int k_end = causal ? min(S, q0 + n_rows) : S;
  for (int kt0 = 0; kt0 < k_end; kt0 += BK) {
    __syncthreads();
    const int nk = min(BK, k_end - kt0);
    stage_f32<D>(Ks, k + kv_base + (long)kt0 * kv_stride, kv_stride, nk, BK,
                 tid);
    stage_f32<D>(Vs, v + kv_base + (long)kt0 * kv_stride, kv_stride, nk, BK,
                 tid);
    __syncthreads();
    float s[BK / 4], dp[BK / 4];
#pragma unroll
    for (int j = 0; j < BK / 4; ++j) s[j] = dp[j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; d += 4) {
      const float4 qv = *reinterpret_cast<const float4*>(Qs + r * LD + d);
      const float4 dv4 = *reinterpret_cast<const float4*>(dOs + r * LD + d);
#pragma unroll
      for (int j = 0; j < BK / 4; ++j) {
        s[j] += dot4(qv, *reinterpret_cast<const float4*>(
                             Ks + (p + 4 * j) * LD + d));
        dp[j] += dot4(dv4, *reinterpret_cast<const float4*>(
                               Vs + (p + 4 * j) * LD + d));
      }
    }
#pragma unroll
    for (int j = 0; j < BK / 4; ++j) {
      const int kp = kt0 + p + 4 * j;
      const bool vis = kp < k_end && (!causal || kp <= qpos);
      const float pr = vis ? expf(s[j] * sm_scale - lse_r) : 0.f;
      DSs[r * LDP + p + 4 * j] = pr * (dp[j] - delta);
    }
    __syncthreads();
#pragma unroll 2
    for (int kk = 0; kk < BK; kk += 4) {
      const float4 dsv = *reinterpret_cast<const float4*>(DSs + r * LDP + kk);
      const float de[4] = {dsv.x, dsv.y, dsv.z, dsv.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float* krow = Ks + (kk + e) * LD;
#pragma unroll
        for (int gg = 0; gg < NG; ++gg) {
          const float4 kv =
              *reinterpret_cast<const float4*>(krow + 4 * (p + 4 * gg));
          acc[gg][0] += de[e] * kv.x;
          acc[gg][1] += de[e] * kv.y;
          acc[gg][2] += de[e] * kv.z;
          acc[gg][3] += de[e] * kv.w;
        }
      }
    }
  }
  if (r < n_rows) {
    float* row = dq + q_base + r * q_stride;
#pragma unroll
    for (int gg = 0; gg < NG; ++gg)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        row[4 * (p + 4 * gg) + e] = acc[gg][e] * sm_scale;
  }
}

constexpr int QT_F32 = 64;   // query rows per tile, f32 dk/dv kernel

template <int D>
constexpr int dkv_f32_smem() {
  return (2 * BK + 2 * QT_F32) * (D + 4) * 4 + 2 * BK * (QT_F32 + 4) * 4 +
         2 * QT_F32 * 4;
}

template <int D>
__global__ void __launch_bounds__(F32_THREADS)
flash_bwd_dkv_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ o,
                  const float* __restrict__ lse,
                  const float* __restrict__ dout, float* __restrict__ dk,
                  float* __restrict__ dv, int S, int NH, int NKV, int causal,
                  float sm_scale) {
  constexpr int LD = D + 4;
  constexpr int LDP = QT_F32 + 4;
  constexpr int NG = D / 16;
  extern __shared__ __align__(16) float fsmem[];
  float* Ks = fsmem;
  float* Vs = Ks + BK * LD;
  float* Qs = Vs + BK * LD;
  float* dOs = Qs + QT_F32 * LD;
  float* PTs = dOs + QT_F32 * LD;
  float* DSTs = PTs + BK * LDP;
  float* lse_s = DSTs + BK * LDP;
  float* delta_s = lse_s + QT_F32;

  const int k0 = blockIdx.x * BK;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = NH / NKV;
  const int n_keys = min(BK, S - k0);
  const int tid = threadIdx.x;
  const int c = tid >> 2;   // this thread's key row (and query row when
  const int p = tid & 3;    // staging a query tile)
  const int kpos = k0 + c;
  const long kv_stride = (long)NKV * D;
  const long kv_base = ((long)b * S + k0) * NKV * D + (long)kvh * D;
  const long q_stride = (long)NH * D;

  stage_f32<D>(Ks, k + kv_base, kv_stride, n_keys, BK, tid);
  stage_f32<D>(Vs, v + kv_base, kv_stride, n_keys, BK, tid);

  float dka[NG][4], dva[NG][4];
#pragma unroll
  for (int gg = 0; gg < NG; ++gg)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[gg][e] = dva[gg][e] = 0.f;

  const int q_begin = causal ? (k0 / QT_F32) * QT_F32 : 0;
  for (int hq = kvh * G; hq < (kvh + 1) * G; ++hq) {
    const long head_base = (long)b * S * NH * D + (long)hq * D;
    const float* lse_h = lse + ((long)b * NH + hq) * S;
    for (int qt0 = q_begin; qt0 < S; qt0 += QT_F32) {
      const int nq = min(QT_F32, S - qt0);
      const long q_base = head_base + (long)qt0 * q_stride;
      __syncthreads();
      stage_f32<D>(Qs, q + q_base, q_stride, nq, QT_F32, tid);
      stage_f32<D>(dOs, dout + q_base, q_stride, nq, QT_F32, tid);
      __syncthreads();
      const float dl = row_delta<D>(dOs, o + q_base, q_stride, c, p, nq);
      if (p == 0) {
        delta_s[c] = dl;
        lse_s[c] = c < nq ? lse_h[qt0 + c] : INFINITY;
      }
      __syncthreads();
      float st[QT_F32 / 4], dpt[QT_F32 / 4];
#pragma unroll
      for (int j = 0; j < QT_F32 / 4; ++j) st[j] = dpt[j] = 0.f;
#pragma unroll 2
      for (int d = 0; d < D; d += 4) {
        const float4 kv = *reinterpret_cast<const float4*>(Ks + c * LD + d);
        const float4 vv = *reinterpret_cast<const float4*>(Vs + c * LD + d);
#pragma unroll
        for (int j = 0; j < QT_F32 / 4; ++j) {
          st[j] += dot4(kv, *reinterpret_cast<const float4*>(
                                Qs + (p + 4 * j) * LD + d));
          dpt[j] += dot4(vv, *reinterpret_cast<const float4*>(
                                 dOs + (p + 4 * j) * LD + d));
        }
      }
#pragma unroll
      for (int j = 0; j < QT_F32 / 4; ++j) {
        const int r = p + 4 * j;
        const int qpos = qt0 + r;
        const bool vis = kpos < S && qpos < S && (!causal || kpos <= qpos);
        const float pr = vis ? expf(st[j] * sm_scale - lse_s[r]) : 0.f;
        PTs[c * LDP + r] = pr;
        DSTs[c * LDP + r] = pr * (dpt[j] - delta_s[r]);
      }
      __syncthreads();
#pragma unroll 2
      for (int rr = 0; rr < QT_F32; rr += 4) {
        const float4 pv = *reinterpret_cast<const float4*>(PTs + c * LDP + rr);
        const float4 sv =
            *reinterpret_cast<const float4*>(DSTs + c * LDP + rr);
        const float pe[4] = {pv.x, pv.y, pv.z, pv.w};
        const float se[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float* drow = dOs + (rr + e) * LD;
          const float* qrow = Qs + (rr + e) * LD;
#pragma unroll
          for (int gg = 0; gg < NG; ++gg) {
            const int col = 4 * (p + 4 * gg);
            const float4 dv4 = *reinterpret_cast<const float4*>(drow + col);
            const float4 qv = *reinterpret_cast<const float4*>(qrow + col);
            dva[gg][0] += pe[e] * dv4.x;
            dva[gg][1] += pe[e] * dv4.y;
            dva[gg][2] += pe[e] * dv4.z;
            dva[gg][3] += pe[e] * dv4.w;
            dka[gg][0] += se[e] * qv.x;
            dka[gg][1] += se[e] * qv.y;
            dka[gg][2] += se[e] * qv.z;
            dka[gg][3] += se[e] * qv.w;
          }
        }
      }
    }
  }
  if (c < n_keys) {
    float* dkr = dk + kv_base + c * kv_stride;
    float* dvr = dv + kv_base + c * kv_stride;
#pragma unroll
    for (int gg = 0; gg < NG; ++gg)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dkr[4 * (p + 4 * gg) + e] = dka[gg][e] * sm_scale;
        dvr[4 * (p + 4 * gg) + e] = dva[gg][e];
      }
  }
}

// ---------------------------------------------------------------------
template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* o,
              const void* lse, const void* dout, void* dq, int B, int S,
              int NH, int NKV, int causal, int dtype, cudaStream_t stream) {
  const dim3 grid((S + BQ - 1) / BQ, NH, B);
  const float sm_scale = 1.0f / sqrtf((float)D);
  cudaError_t err;
  if (dtype == 1) {
    err = cudaFuncSetAttribute(flash_bwd_dq_mma<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               dq_mma_smem<D>());
    if (err != cudaSuccess) return (int)err;
    flash_bwd_dq_mma<D><<<grid, dstt::MMA_THREADS, dq_mma_smem<D>(),
                          stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const bf16*>(o),
        static_cast<const float*>(lse), static_cast<const bf16*>(dout),
        static_cast<bf16*>(dq), S, NH, NKV, causal, sm_scale);
  } else {
    err = cudaFuncSetAttribute(flash_bwd_dq_f32<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               dq_f32_smem<D>());
    if (err != cudaSuccess) return (int)err;
    flash_bwd_dq_f32<D><<<grid, F32_THREADS, dq_f32_smem<D>(), stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(o),
        static_cast<const float*>(lse), static_cast<const float*>(dout),
        static_cast<float*>(dq), S, NH, NKV, causal, sm_scale);
  }
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* o,
               const void* lse, const void* dout, void* dk, void* dv, int B,
               int S, int NH, int NKV, int causal, int dtype,
               cudaStream_t stream) {
  const dim3 grid((S + BK - 1) / BK, NKV, B);
  const float sm_scale = 1.0f / sqrtf((float)D);
  cudaError_t err;
  if (dtype == 1) {
    err = cudaFuncSetAttribute(flash_bwd_dkv_mma<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               dkv_mma_smem<D>());
    if (err != cudaSuccess) return (int)err;
    flash_bwd_dkv_mma<D><<<grid, dstt::MMA_THREADS, dkv_mma_smem<D>(),
                           stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const bf16*>(o),
        static_cast<const float*>(lse), static_cast<const bf16*>(dout),
        static_cast<bf16*>(dk), static_cast<bf16*>(dv), S, NH, NKV, causal,
        sm_scale);
  } else {
    err = cudaFuncSetAttribute(flash_bwd_dkv_f32<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               dkv_f32_smem<D>());
    if (err != cudaSuccess) return (int)err;
    flash_bwd_dkv_f32<D><<<grid, F32_THREADS, dkv_f32_smem<D>(), stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(o),
        static_cast<const float*>(lse), static_cast<const float*>(dout),
        static_cast<float*>(dk), static_cast<float*>(dv), S, NH, NKV, causal,
        sm_scale);
  }
  return (int)cudaGetLastError();
}

bool bad_shape(int B, int S, int NH, int NKV, int dtype) {
  return B <= 0 || S <= 0 || NKV <= 0 || NH % NKV != 0 ||
         (dtype != 0 && dtype != 1);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Each returns cudaGetLastError() after
// its launch (cudaErrorInvalidValue for an unsupported head dim, shape or
// dtype).
extern "C" int dstt_flash_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* o, const void* lse,
                                 const void* dout, void* dq, int B, int S,
                                 int NH, int NKV, int D, int causal,
                                 int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bad_shape(B, S, NH, NKV, dtype)) return (int)cudaErrorInvalidValue;
  if (D == 32)
    return launch_dq<32>(q, k, v, o, lse, dout, dq, B, S, NH, NKV, causal,
                         dtype, st);
  if (D == 64)
    return launch_dq<64>(q, k, v, o, lse, dout, dq, B, S, NH, NKV, causal,
                         dtype, st);
  if (D == 128)
    return launch_dq<128>(q, k, v, o, lse, dout, dq, B, S, NH, NKV, causal,
                          dtype, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int dstt_flash_bwd_dkv(const void* q, const void* k,
                                  const void* v, const void* o,
                                  const void* lse, const void* dout,
                                  void* dk, void* dv, int B, int S, int NH,
                                  int NKV, int D, int causal, int dtype,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bad_shape(B, S, NH, NKV, dtype)) return (int)cudaErrorInvalidValue;
  if (D == 32)
    return launch_dkv<32>(q, k, v, o, lse, dout, dk, dv, B, S, NH, NKV,
                          causal, dtype, st);
  if (D == 64)
    return launch_dkv<64>(q, k, v, o, lse, dout, dk, dv, B, S, NH, NKV,
                          causal, dtype, st);
  if (D == 128)
    return launch_dkv<128>(q, k, v, o, lse, dout, dk, dv, B, S, NH, NKV,
                           causal, dtype, st);
  return (int)cudaErrorInvalidValue;
}
