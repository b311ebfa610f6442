// The one query-tile x key-tile flash core that both the dense causal
// forward (flash_fwd.cu) and the paged prefill (paged_prefill.cu) run.
// The two kernels differ only in where a key row lives (a key-offset
// functor) and in their key ranges and masks.  The core comes in two forms with the same arguments and results:
// `attn_tile_mma` for bf16 on the tensor cores, and `attn_tile` for f32
// on the CUDA cores (exact f32 products, for f32 models and checks).
//
// attn_tile (f32):
//   * one CTA = 64 query rows of one head, 256 threads, 4 threads per row;
//   * Q, the K/V tile (64 keys) and P are staged in shared memory as f32,
//     rows padded by 4 floats so the float4 reads of 8 rows x 4 column
//     groups hit 32 distinct banks;
//   * thread (r, p) scores keys p, p+4, ..., p+60 of the tile for row r,
//     the row max / row sum reduce over the 4 lanes of the row with two
//     xor shuffles, and the thread accumulates output columns
//     4*(p+4g) .. 4*(p+4g)+3 for g < D/16 in f32 registers;
//   * online softmax (running max m, partial sums l) in f32, so the score
//     matrix never leaves shared memory.
//   What bounds it: the f32 FMAs of the two products run on the CUDA
//   cores (67 TFLOP/s peak, not the 989 of the tensor cores), fed from
//   shared memory at about one float4 load per four FMAs.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace dstt {

constexpr int BQ = 64;          // query rows per CTA
constexpr int BK = 64;          // keys per tile
constexpr int NTHREADS = 256;   // 4 threads per query row

// Bytes of dynamic shared memory attn_tile needs for head dim D.
__host__ __device__ constexpr int tile_smem_bytes(int D) {
  return (BQ * (D + 4) + 2 * BK * (D + 4) + BQ * (BK + 4)) * 4;
}

// One CTA's flash pass: query rows [0, n_rows) at q + r*q_stride sit at
// absolute positions qpos0 + r and attend keys in [k_begin, k_end) (key kp
// at kb/vb + key_off(kp)) under the causal rule kp <= qpos and, when
// window > 0, the sliding-window rule kp > qpos - window.  With ALIBI each
// visible score qk * sm_scale takes -slope (qpos - kp).  Writes the
// normalized output rows (zeros for a row that saw no key) and, when lse
// is not null, lse[r] = m + log(l).
template <int D, bool ALIBI = false, class KeyOff>
__device__ __forceinline__ void attn_tile(
    const float* __restrict__ q, long q_stride, const float* __restrict__ kb,
    const float* __restrict__ vb, KeyOff key_off, float* __restrict__ o,
    long o_stride, float* __restrict__ lse, int n_rows, int qpos0,
    bool causal, int window, int k_begin, int k_end, float sm_scale,
    float slope = 0.f) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int LD = D + 4;
  constexpr int LDP = BK + 4;
  constexpr int NG = D / 16;           // float4 column groups per thread
  constexpr int VN = 4;                // floats per 16-byte load
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * LD;
  float* Vs = Ks + BK * LD;
  float* Ps = Vs + BK * LD;

  const int tid = threadIdx.x;
  const int r = tid >> 2;
  const int p = tid & 3;
  const int qpos = qpos0 + r;

  for (int idx = tid; idx < BQ * (D / VN); idx += NTHREADS) {
    const int row = idx / (D / VN);
    const int c = (idx % (D / VN)) * VN;
    *reinterpret_cast<float4*>(Qs + row * LD + c) =
        row < n_rows
            ? *reinterpret_cast<const float4*>(q + row * q_stride + c)
            : make_float4(0.f, 0.f, 0.f, 0.f);
  }

  float acc[NG][4];
#pragma unroll
  for (int g = 0; g < NG; ++g)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[g][e] = 0.f;
  float m = -INFINITY;
  float lpart = 0.f;

  if (k_begin < 0) k_begin = 0;
  for (int kt0 = (k_begin / BK) * BK; kt0 < k_end; kt0 += BK) {
    __syncthreads();   // the previous tile's readers are done
    for (int idx = tid; idx < BK * (D / VN); idx += NTHREADS) {
      const int row = idx / (D / VN);
      const int c = (idx % (D / VN)) * VN;
      const int kp = kt0 + row;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
      if (kp < k_end) {
        const long off = key_off(kp);
        kv = *reinterpret_cast<const float4*>(kb + off + c);
        vv = *reinterpret_cast<const float4*>(vb + off + c);
      }
      *reinterpret_cast<float4*>(Ks + row * LD + c) = kv;
      *reinterpret_cast<float4*>(Vs + row * LD + c) = vv;
    }
    __syncthreads();

    float s[BK / 4];
#pragma unroll
    for (int j = 0; j < BK / 4; ++j) s[j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      const float4 qv = *reinterpret_cast<const float4*>(Qs + r * LD + d);
#pragma unroll
      for (int j = 0; j < BK / 4; ++j) {
        const float4 kv =
            *reinterpret_cast<const float4*>(Ks + (p + 4 * j) * LD + d);
        s[j] += qv.x * kv.x + qv.y * kv.y + qv.z * kv.z + qv.w * kv.w;
      }
    }

    float tmax = -INFINITY;
#pragma unroll
    for (int j = 0; j < BK / 4; ++j) {
      const int kp = kt0 + p + 4 * j;
      const bool vis = kp < k_end && (!causal || kp <= qpos) &&
                       (window <= 0 || kp > qpos - window);
      if constexpr (ALIBI)
        s[j] = vis ? s[j] * sm_scale - slope * (float)(qpos - kp) : -INFINITY;
      else
        s[j] = vis ? s[j] * sm_scale : -INFINITY;
      tmax = fmaxf(tmax, s[j]);
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
    const float m_new = fmaxf(m, tmax);
    // a row that has seen no visible key keeps m = -inf: alpha and every
    // p stay 0, so it contributes nothing until a visible key arrives
    const float alpha = (m == -INFINITY) ? 0.f : expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 4; ++j) {
      const float pj = (s[j] == -INFINITY) ? 0.f : expf(s[j] - m_new);
      psum += pj;
      Ps[r * LDP + p + 4 * j] = pj;
    }
    lpart = lpart * alpha + psum;
    m = m_new;
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[g][e] *= alpha;
    __syncthreads();

#pragma unroll 2
    for (int kk = 0; kk < BK; kk += 4) {
      const float4 pv = *reinterpret_cast<const float4*>(Ps + r * LDP + kk);
      const float pe[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float* vrow = Vs + (kk + e) * LD;
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          const float4 vv =
              *reinterpret_cast<const float4*>(vrow + 4 * (p + 4 * g));
          acc[g][0] += pe[e] * vv.x;
          acc[g][1] += pe[e] * vv.y;
          acc[g][2] += pe[e] * vv.z;
          acc[g][3] += pe[e] * vv.w;
        }
      }
    }
  }

  float l = lpart;
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);
  if (r < n_rows) {
    const float inv = l > 0.f ? 1.f / l : 0.f;
    float* orow = o + r * o_stride;
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      const int col = 4 * (p + 4 * g);
#pragma unroll
      for (int e = 0; e < 4; ++e) orow[col + e] = acc[g][e] * inv;
    }
    if (lse != nullptr && p == 0) lse[r] = l > 0.f ? m + logf(l) : -INFINITY;
  }
}

// ---------------------------------------------------------------------
// The bf16 core on the tensor cores (mma.sync m16n8k16, f32 accumulate).
//   * one CTA = 64 query rows of one head, 4 warps, warp w owns rows
//     16w .. 16w+15; Q, the K tile and the V tile (64 keys) sit in shared
//     memory as bf16, rows padded by 8 elements so the fragment reads and
//     ldmatrix rows hit distinct banks;
//   * S = Q K^T: Q's A fragments stay in registers for the whole pass, K's
//     B fragments are read straight from the row-major K tile;
//   * online softmax on the S accumulators in f32 (base-2 exponent), each
//     lane holding rows g and g+8 of its warp's tile;
//   * O += P V: P is rounded to bf16 and reused from the accumulator
//     registers as the A operand (FlashAttention-2's layout trick); V's B
//     fragments come from ldmatrix.trans.
// What bounds it: at these tiles the tensor cores are fed from shared
// memory one tile at a time with no copy/compute overlap; TMA, wgmma and
// a ring of stages are the next step.
constexpr int MMA_THREADS = 128;

__host__ __device__ constexpr int mma_smem_bytes(int D) {
  return (BQ + 2 * BK) * (D + 8) * 2;
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const void* p) {
  const uint32_t a =
      static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// The same pass as attn_tile (same arguments and results) for bf16, on
// MMA_THREADS threads with mma_smem_bytes(D) of dynamic shared memory.
template <int D, bool ALIBI = false, class KeyOff>
__device__ __forceinline__ void attn_tile_mma(
    const __nv_bfloat16* __restrict__ q, long q_stride,
    const __nv_bfloat16* __restrict__ kb,
    const __nv_bfloat16* __restrict__ vb, KeyOff key_off,
    __nv_bfloat16* __restrict__ o, long o_stride, float* __restrict__ lse,
    int n_rows, int qpos0, bool causal, int window, int k_begin, int k_end,
    float sm_scale, float slope = 0.f) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int LD = D + 8;
  constexpr int NV = D / 8;            // 16-byte vectors per row
  constexpr float LOG2E = 1.4426950408889634f;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + BQ * LD;
  __nv_bfloat16* Vs = Ks + BK * LD;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int r0 = warp * 16 + g;        // this lane's rows: r0 and r0 + 8
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  for (int idx = tid; idx < BQ * NV; idx += MMA_THREADS) {
    const int row = idx / NV;
    const int c = (idx % NV) * 8;
    *reinterpret_cast<uint4*>(Qs + row * LD + c) =
        row < n_rows
            ? *reinterpret_cast<const uint4*>(q + row * q_stride + c)
            : zero;
  }
  __syncthreads();
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const __nv_bfloat16* qr = Qs + r0 * LD + kk * 16 + 2 * t;
    qa[kk][0] = ld_u32(qr);
    qa[kk][1] = ld_u32(qr + 8 * LD);
    qa[kk][2] = ld_u32(qr + 8);
    qa[kk][3] = ld_u32(qr + 8 * LD + 8);
  }

  float oacc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[n][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};   // running max, log2 units
  float l[2] = {0.f, 0.f};               // this lane's partial row sums
  const float scale = sm_scale * LOG2E;
  const int qp[2] = {qpos0 + r0, qpos0 + r0 + 8};

  if (k_begin < 0) k_begin = 0;
  for (int kt0 = (k_begin / BK) * BK; kt0 < k_end; kt0 += BK) {
    __syncthreads();   // the previous tile's readers are done
    for (int idx = tid; idx < BK * NV; idx += MMA_THREADS) {
      const int row = idx / NV;
      const int c = (idx % NV) * 8;
      const int kp = kt0 + row;
      uint4 kv = zero, vv = zero;
      if (kp < k_end) {
        const long off = key_off(kp);
        kv = *reinterpret_cast<const uint4*>(kb + off + c);
        vv = *reinterpret_cast<const uint4*>(vb + off + c);
      }
      *reinterpret_cast<uint4*>(Ks + row * LD + c) = kv;
      *reinterpret_cast<uint4*>(Vs + row * LD + c) = vv;
    }
    __syncthreads();

    float s[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        const __nv_bfloat16* kr = Ks + (j * 8 + g) * LD + kk * 16 + 2 * t;
        mma_bf16(s[j], qa[kk], ld_u32(kr), ld_u32(kr + 8));
      }
    }

    // s[j][0..1]: row r0, keys kt0+8j+2t+{0,1}; s[j][2..3]: row r0+8
    float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const int kp = kt0 + 8 * j + 2 * t + (e & 1);
        const bool vis = kp < k_end && (!causal || kp <= qp[h]) &&
                         (window <= 0 || kp > qp[h] - window);
        if constexpr (ALIBI)
          s[j][e] = vis ? s[j][e] * scale - slope * LOG2E * (float)(qp[h] - kp)
                        : -INFINITY;
        else
          s[j][e] = vis ? s[j][e] * scale : -INFINITY;
        tmax[h] = fmaxf(tmax[h], s[j][e]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      tmax[h] = fmaxf(tmax[h], __shfl_xor_sync(0xffffffffu, tmax[h], 1));
      tmax[h] = fmaxf(tmax[h], __shfl_xor_sync(0xffffffffu, tmax[h], 2));
      const float m_new = fmaxf(m[h], tmax[h]);
      // a row with no visible key so far keeps m = -inf and adds nothing
      alpha[h] = (m[h] == -INFINITY) ? 0.f : exp2f(m[h] - m_new);
      m[h] = m_new;
      l[h] *= alpha[h];
    }
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        s[j][e] = (s[j][e] == -INFINITY) ? 0.f : exp2f(s[j][e] - m[h]);
        l[h] += s[j][e];
      }
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      oacc[n][0] *= alpha[0];
      oacc[n][1] *= alpha[0];
      oacc[n][2] *= alpha[1];
      oacc[n][3] *= alpha[1];
    }

#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const __nv_bfloat16* vrow =
          Vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
          (lane >> 4) * 8;
#pragma unroll
      for (int n = 0; n < D / 16; ++n) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, vrow + n * 16);
        mma_bf16(oacc[2 * n], pa, b[0], b[1]);
        mma_bf16(oacc[2 * n + 1], pa, b[2], b[3]);
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const int r = r0 + 8 * h;
    if (r >= n_rows) continue;
    const float inv = l[h] > 0.f ? 1.f / l[h] : 0.f;
    __nv_bfloat16* orow = o + r * o_stride;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8 + 2 * t) =
          __floats2bfloat162_rn(oacc[n][2 * h] * inv,
                                oacc[n][2 * h + 1] * inv);
    }
    if (lse != nullptr && t == 0)
      lse[r] = l[h] > 0.f ? m[h] / LOG2E + logf(l[h]) : -INFINITY;
  }
}

// The core for element type T, with its block size and shared memory.
template <typename T>
__host__ __device__ constexpr int launch_threads() {
  return std::is_same<T, __nv_bfloat16>::value ? MMA_THREADS : NTHREADS;
}

template <typename T>
__host__ __device__ constexpr int launch_smem_bytes(int D) {
  return std::is_same<T, __nv_bfloat16>::value ? mma_smem_bytes(D)
                                               : tile_smem_bytes(D);
}

template <typename T, int D, bool ALIBI = false, class KeyOff>
__device__ __forceinline__ void attn_tile_any(
    const T* q, long q_stride, const T* kb, const T* vb, KeyOff key_off,
    T* o, long o_stride, float* lse, int n_rows, int qpos0, bool causal,
    int window, int k_begin, int k_end, float sm_scale, float slope = 0.f) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    attn_tile_mma<D, ALIBI>(q, q_stride, kb, vb, key_off, o, o_stride, lse,
                            n_rows, qpos0, causal, window, k_begin, k_end,
                            sm_scale, slope);
  } else {
    attn_tile<D, ALIBI>(q, q_stride, kb, vb, key_off, o, o_stride, lse,
                        n_rows, qpos0, causal, window, k_begin, k_end,
                        sm_scale, slope);
  }
}

// ---------------------------------------------------------------------
// Fragment helpers of the kernels that stage every operand in shared
// memory as bf16 rows of leading dim LD and read the mma fragments from
// there (sparse_flash.cu, evoformer_flash.cu): a warp owns 16 rows, lane
// (g, t) = (lane / 4, lane % 4) rows g and g + 8.
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// A fragment (m16n8k16, row-major) of rows r0 and r0 + 8 at column k0.
__device__ __forceinline__ void frag_a(uint32_t* a, const __nv_bfloat16* tile,
                                       int LD, int r0, int k0, int t) {
  const __nv_bfloat16* p = tile + r0 * LD + k0 + 2 * t;
  a[0] = ld_u32(p);
  a[1] = ld_u32(p + 8 * LD);
  a[2] = ld_u32(p + 8);
  a[3] = ld_u32(p + 8 * LD + 8);
}

// f32 accumulators of a 16 x 16 tile (n-tiles 0 and 1) as the bf16 A
// fragment of the next product.
__device__ __forceinline__ void acc_to_a(uint32_t* a, const float (*s)[4]) {
  a[0] = pack_bf16(s[0][0], s[0][1]);
  a[1] = pack_bf16(s[0][2], s[0][3]);
  a[2] = pack_bf16(s[1][0], s[1][1]);
  a[3] = pack_bf16(s[1][2], s[1][3]);
}

// acc[16 x D] += A[16 x 16] * Bt where Bt is a row-major [16, D] shared
// tile (rows = the contraction dim) read with ldmatrix.trans.
template <int D>
__device__ __forceinline__ void mma_rowmajor_b(float (*acc)[4],
                                               const uint32_t* a,
                                               const __nv_bfloat16* bt,
                                               int LD, int lane) {
  const __nv_bfloat16* row =
      bt + ((lane & 7) + ((lane >> 3) & 1) * 8) * LD + (lane >> 4) * 8;
#pragma unroll
  for (int n = 0; n < D / 16; ++n) {
    uint32_t b[4];
    ldmatrix_x4_trans(b, row + n * 16);
    mma_bf16(acc[2 * n], a, b[0], b[1]);
    mma_bf16(acc[2 * n + 1], a, b[2], b[3]);
  }
}

// S[16 x 16] (two n-tiles) += A rows (a tile of LD, rows r0/r0+8) times the
// 16 rows [c0, c0 + 16) of a row-major tile Bt, transposed: S = A Bt^T,
// contracting D columns.
template <int D>
__device__ __forceinline__ void mma_abt(float (*s)[4],
                                        const __nv_bfloat16* a_tile,
                                        const __nv_bfloat16* bt, int LD,
                                        int r0, int c0, int g, int t) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    frag_a(a, a_tile, LD, r0, kk * 16, t);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const __nv_bfloat16* br = bt + (c0 + j * 8 + g) * LD + kk * 16 + 2 * t;
      mma_bf16(s[j], a, ld_u32(br), ld_u32(br + 8));
    }
  }
}

__device__ __forceinline__ void zero16(float (*s)[4]) {
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
}

// 16-byte asynchronous copies into shared memory (cp.async, tile_matmul.cu
// and the Evoformer kernels that stage rows a step ahead); src-size 0
// writes 16 zero bytes and reads nothing.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
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

}  // namespace dstt
