// Causal flash-attention backward for Hopper (sm_90a): the delta, dq and
// dk/dv kernels.
//
// Replaces the TPU kernels of deepspeed_tpu/ops/flash_attention.py
// `_bwd_vjp`: `_bwd_dq_kernel` (pallas_call at :374) and `_bwd_dkv_kernel`
// (pallas_call at :398).  Inputs are the forward's residuals (q, k, v, out,
// lse) and dO.
//
// Layout (the JAX public one, no transposes): q, out, dO, dq [B, S, NH, D];
// k, v, dk, dv [B, S, NKV, D]; lse and delta [B, NH, S] f32.  Any S (ragged
// tails are masked), causal or not, GQA with NH % NKV == 0, D in {32, 64,
// 128}.  No atomics: every output element is written by one thread after a
// fixed order of sums, so the result is the same on every run.
//
// What bounds it on the H100 at the training shape ([4, 2048, 16, 128]
// bf16, causal): operations.  dq does 3 and dk/dv 4 causal [S, S, D]
// matmuls per head (1.03e11 and 1.37e11 FLOP: 0.104 and 0.139 ms at 989
// TFLOP/s) against ~200 MB of bytes (0.06 ms).
//
// bf16: three kernels, one launch each per backward.
//   flash_bwd_delta: delta = rowsum(dO * out) in f32 into [B, NH, S]
//     (D * 2 / 16 threads a row, one 16-byte load each of out and dO, an
//     xor-shuffle sum).  On the TPU each kernel recomputes it from the out
//     tile; here the dk/dv kernel would redo it for every query tile a key
//     tile visits, so it is computed once and both kernels read it.
//   flash_bwd_dkv_wgmma, grid (ceil(S/128), NKV, B), key tiles on x from
//     the first (the heaviest causal ones first), head-major: one CTA =
//     128 keys of one KV head, warp-specialised as flash_fwd.cu.  A
//     producer warpgroup (registers handed to the consumers with
//     setmaxnreg): one thread loads K and V once by TMA and streams 64-row
//     tiles of Q and dO through a 3-slot mbarrier ring, walking the q
//     heads of the GQA group and, causal, the query tiles from the
//     diagonal on; one warp stages each tile's lse (times log2 e) and
//     delta in shared memory (+inf and 0 past S, so those rows give P = 0).
//     Two consumer warpgroups of 64 keys each, per tile: S^T = K Q^T and
//     dP^T = V dO^T (wgmma, both operands K-major in shared memory); P^T =
//     exp2(S^T scale log2e - lse log2e), masked only on the diagonal tile
//     and past S; dS^T = P^T (dP^T - delta); dV += P^T dO and dK += dS^T Q
//     (wgmma with P^T / dS^T rounded to bf16 from the accumulators as the
//     register A operand, dO / Q as the MN-major B).  dK and dV stay in f32
//     registers over the whole group, so the GQA sum is f32 and in order;
//     dK * scale and dV are written once.  A warpgroup whose 64 keys all
//     lie past a tile's rows (the first causal tile of warpgroup 1) skips
//     its products but still frees the slot.
//   flash_bwd_dq_wgmma, grid (ceil(S/128), NH, B), query tiles on x from
//     the last, head-major: one CTA = 128 query rows of one head (two
//     consumer warpgroups of 64), Q and dO loaded once, 64-key tiles of K
//     and V through a 3-slot ring up to the diagonal: S = Q K^T, dP =
//     dO V^T, P, dS = P (dP - delta), dQ += dS K (K as the MN-major B);
//     dQ * scale is written once.
//   Tiles are loaded through 4-D tensor maps over [B, S, heads, D], so rows
//   past S come back zero and a tile never crosses into the next batch;
//   rows of more than 64 bf16 load as 64-column boxes (the 128-byte
//   swizzle's width; D 32 uses the 64-byte swizzle), as in flash_fwd.cu.
//
// f32 runs on the CUDA cores with exact f32 products (4 threads per row,
// as attn_tile.cuh's f32 core) and computes delta inside, per tile: grids
// (ceil(S/64), NH or NKV, B).
#include "attn_tile.cuh"
#include "hopper_tile.cuh"

namespace {

using bf16 = __nv_bfloat16;
namespace hp = dstt::hopper;
constexpr int BQ = dstt::BQ;     // query rows per f32 dq CTA (64)
constexpr int BK = dstt::BK;     // keys per f32 tile (64)
constexpr float LOG2E = 1.4426950408889634f;

// ---------------------------------------------------------------------
// delta = rowsum(dO * out), f32, [B, NH, S]
__device__ __forceinline__ float dot_chunk(uint4 a, uint4 b, const bf16*) {
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 fx = __bfloat1622float2(x[i]);
    const float2 fy = __bfloat1622float2(y[i]);
    s += fx.x * fy.x + fx.y * fy.y;
  }
  return s;
}

__device__ __forceinline__ float dot_chunk(uint4 a, uint4 b, const float*) {
  const float4 x = *reinterpret_cast<const float4*>(&a);
  const float4 y = *reinterpret_cast<const float4*>(&b);
  return x.x * y.x + x.y * y.y + x.z * y.z + x.w * y.w;
}

constexpr int DELTA_THREADS = 256;

// Row r = (b * S + s) * NH + h of out / dO (D elements) is summed by TPR
// consecutive threads, one 16-byte chunk each, and lands at
// delta[(b * NH + h) * S + s].
template <typename T, int D>
__global__ void __launch_bounds__(DELTA_THREADS)
flash_bwd_delta(const T* __restrict__ o, const T* __restrict__ dout,
                float* __restrict__ delta, long rows, int S, int NH) {
  constexpr int TPR = D * (int)sizeof(T) / 16;
  constexpr int RPB = DELTA_THREADS / TPR;
  const long row = (long)blockIdx.x * RPB + threadIdx.x / TPR;
  const int part = threadIdx.x % TPR;
  float s = 0.f;
  if (row < rows)
    s = dot_chunk(reinterpret_cast<const uint4*>(o + row * D)[part],
                  reinterpret_cast<const uint4*>(dout + row * D)[part], o);
#pragma unroll
  for (int off = TPR / 2; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (part == 0 && row < rows) {
    const int h = (int)(row % NH);
    const long bs = row / NH;
    delta[(bs / S * NH + h) * S + bs % S] = s;
  }
}

// ---------------------------------------------------------------------
// bf16: TMA + wgmma, warp-specialised
constexpr int WG_THREADS = 384;   // producer warpgroup + two consumers
constexpr int KV_ROWS = 128;      // dk/dv: keys per CTA
constexpr int QT = 64;            // dk/dv: query rows per ring tile
constexpr int DQ_ROWS = 128;      // dq: query rows per CTA
constexpr int KT = 64;            // dq: keys per ring tile
constexpr int STAGES = 3;         // ring slots

template <int D>
struct BwdTile : hp::RowTile<D> {
  static constexpr int KV_BYTES = KV_ROWS * D * 2;   // dk/dv: K or V
  static constexpr int QT_BYTES = QT * D * 2;        // dk/dv: Q or dO tile
  static constexpr int DKV_SMEM = 1024 + 2 * KV_BYTES + STAGES * 2 * QT_BYTES;
  static constexpr int Q_BYTES = DQ_ROWS * D * 2;    // dq: Q or dO
  static constexpr int KT_BYTES = KT * D * 2;        // dq: K or V tile
  static constexpr int DQ_SMEM = 1024 + 2 * Q_BYTES + STAGES * 2 * KT_BYTES;
};

using hp::acc_col;
using hp::ex2;
using hp::issue_abt;
using hp::issue_rs;
using hp::pack_frags;

template <int D>
__global__ void __launch_bounds__(WG_THREADS, 1)
flash_bwd_dkv_wgmma(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap,
                    const __grid_constant__ CUtensorMap dmap,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dk,
                    bf16* __restrict__ dv, int S, int NH, int NKV,
                    int causal, float scale_log2, float sm_scale) {
  using T = BwdTile<D>;
  static_assert(D == 32 || D == 64 || D == 128, "head dim");
  extern __shared__ __align__(1024) uint8_t smem_tma[];
  uint8_t* Ks = hp::align1024(smem_tma);
  uint8_t* Vs = Ks + T::KV_BYTES;
  uint8_t* QdO = Vs + T::KV_BYTES;   // slot s: the Q tile, then the dO tile
  __shared__ float lse_s[STAGES][QT], dl_s[STAGES][QT];
  __shared__ __align__(8) uint64_t kv_full, full[STAGES], empty[STAGES];
  const int k0 = blockIdx.x * KV_ROWS, kvh = blockIdx.y, b = blockIdx.z;
  const int G = NH / NKV;
  // query rows before k0 see none of these keys (k0 is a multiple of QT)
  const int q_begin = causal ? k0 : 0;
  const int n_qt = (S - q_begin + QT - 1) / QT;   // per q head
  const int n_tiles = G * n_qt;
  const int tid = threadIdx.x, wg = tid >> 7;
  if (tid == 0) {
    hp::mbar_init(&kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      hp::mbar_init(&full[s], 1 + 32);   // TMA thread + the lse/delta warp
      hp::mbar_init(&empty[s], 8);       // one arrival per consumer warp
    }
    hp::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {   // producer
    hp::setmaxnreg_dec<24>();
    const int warp = tid >> 5, lane = tid & 31;
    if (warp == 0 && lane == 0) {
      hp::mbar_expect_tx(&kv_full, 2 * T::KV_BYTES);
      for (int c = 0; c < T::NCH; ++c) {
        hp::tma_load_4d(Ks + c * KV_ROWS * T::RB, &kmap, &kv_full,
                        c * T::CH, kvh, k0, b);
        hp::tma_load_4d(Vs + c * KV_ROWS * T::RB, &vmap, &kv_full,
                        c * T::CH, kvh, k0, b);
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % STAGES;
        const int hq = kvh * G + j / n_qt, qt0 = q_begin + j % n_qt * QT;
        hp::mbar_wait(&empty[s], ((j / STAGES) & 1) ^ 1);
        uint8_t* Qs = QdO + s * 2 * T::QT_BYTES;
        hp::mbar_expect_tx(&full[s], 2 * T::QT_BYTES);
        for (int c = 0; c < T::NCH; ++c) {
          hp::tma_load_4d(Qs + c * QT * T::RB, &qmap, &full[s], c * T::CH,
                          hq, qt0, b);
          hp::tma_load_4d(Qs + T::QT_BYTES + c * QT * T::RB, &dmap,
                          &full[s], c * T::CH, hq, qt0, b);
        }
      }
    } else if (warp == 1) {
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % STAGES;
        const int hq = kvh * G + j / n_qt, qt0 = q_begin + j % n_qt * QT;
        const long base = ((long)blockIdx.z * NH + hq) * S;
        hp::mbar_wait(&empty[s], ((j / STAGES) & 1) ^ 1);
        for (int r = lane; r < QT; r += 32) {
          const int row = qt0 + r;
          lse_s[s][r] = row < S ? lse[base + row] * LOG2E : INFINITY;
          dl_s[s][r] = row < S ? delta[base + row] : 0.f;
        }
        hp::mbar_arrive(&full[s]);
      }
    }
    return;
  }

  hp::setmaxnreg_inc<240>();
  const int c = wg - 1;
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int kw0 = k0 + 64 * c;                 // this warpgroup's keys
  const int kr0 = kw0 + 16 * warp + g;         // keys kr0, kr0 + 8
  const uint8_t* ka = Ks + 64 * c * T::RB;
  const uint8_t* va = Vs + 64 * c * T::RB;
  const bool key_edge = kw0 + 64 > S;
  float dka[D / 2], dva[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;
  float st[32], dpt[32];
  uint32_t pa[4][4], da[4][4];
  hp::mbar_wait(&kv_full, 0);

  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % STAGES, qt0 = q_begin + j % n_qt * QT;
    const uint8_t* Qs = QdO + s * 2 * T::QT_BYTES;
    const uint8_t* dOs = Qs + T::QT_BYTES;
    hp::mbar_wait(&full[s], (j / STAGES) & 1);
    if (!causal || qt0 + QT > kw0) {   // some row sees some key
      hp::wgmma_fence();
      issue_abt<D, QT>(st, ka, KV_ROWS, Qs);
      hp::wgmma_commit();
      issue_abt<D, QT>(dpt, va, KV_ROWS, dOs);
      hp::wgmma_commit();
      const bool masked = (causal && qt0 < kw0 + 64) || key_edge;
      hp::wgmma_wait<1>();
      hp::fence_regs(st);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int col = acc_col(i, t);
        float p = ex2(fmaf(st[i], scale_log2, -lse_s[s][col]));
        if (masked) {
          const int kp = kr0 + 8 * ((i >> 1) & 1);
          if (kp >= S || (causal && kp > qt0 + col)) p = 0.f;
        }
        st[i] = p;
      }
      hp::wgmma_wait<0>();
      hp::fence_regs(dpt);
#pragma unroll
      for (int i = 0; i < 32; ++i)
        dpt[i] = st[i] * (dpt[i] - dl_s[s][acc_col(i, t)]);
      pack_frags(pa, st);
      pack_frags(da, dpt);
      hp::wgmma_fence();
      issue_rs<D>(dva, pa, dOs);
      issue_rs<D>(dka, da, Qs);
      hp::wgmma_commit();
      hp::wgmma_wait<0>();
      hp::fence_regs(dva);
      hp::fence_regs(dka);
    }
    __syncwarp();
    if (lane == 0) hp::mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int key = kr0 + 8 * hh;
    if (key >= S) continue;
    const long off = (((long)b * S + key) * NKV + kvh) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(dk + off + 8 * n + 2 * t) =
          __floats2bfloat162_rn(dka[4 * n + 2 * hh] * sm_scale,
                                dka[4 * n + 2 * hh + 1] * sm_scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + off + 8 * n + 2 * t) =
          __floats2bfloat162_rn(dva[4 * n + 2 * hh], dva[4 * n + 2 * hh + 1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(WG_THREADS, 1)
flash_bwd_dq_wgmma(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap,
                   const __grid_constant__ CUtensorMap dmap,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, bf16* __restrict__ dq,
                   int S, int NH, int NKV, int causal, float scale_log2,
                   float sm_scale) {
  using T = BwdTile<D>;
  static_assert(D == 32 || D == 64 || D == 128, "head dim");
  extern __shared__ __align__(1024) uint8_t smem_tma[];
  uint8_t* Qs = hp::align1024(smem_tma);
  uint8_t* dOs = Qs + T::Q_BYTES;
  uint8_t* KVs = dOs + T::Q_BYTES;   // slot s: the K tile, then the V tile
  __shared__ __align__(8) uint64_t q_full, full[STAGES], empty[STAGES];
  const int h = blockIdx.y, b = blockIdx.z;
  // the last query tiles walk the most key tiles: they start first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * DQ_ROWS;
  const int kvh = h / (NH / NKV);
  const int n_kt = ((causal ? min(S, q0 + DQ_ROWS) : S) + KT - 1) / KT;
  const int tid = threadIdx.x, wg = tid >> 7;
  if (tid == 0) {
    hp::mbar_init(&q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      hp::mbar_init(&full[s], 1);
      hp::mbar_init(&empty[s], 8);       // one arrival per consumer warp
    }
    hp::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {   // producer
    hp::setmaxnreg_dec<24>();
    if (tid == 0) {
      hp::mbar_expect_tx(&q_full, 2 * T::Q_BYTES);
      for (int c = 0; c < T::NCH; ++c) {
        hp::tma_load_4d(Qs + c * DQ_ROWS * T::RB, &qmap, &q_full,
                        c * T::CH, h, q0, b);
        hp::tma_load_4d(dOs + c * DQ_ROWS * T::RB, &dmap, &q_full,
                        c * T::CH, h, q0, b);
      }
      for (int j = 0; j < n_kt; ++j) {
        const int s = j % STAGES;
        hp::mbar_wait(&empty[s], ((j / STAGES) & 1) ^ 1);
        uint8_t* Ks = KVs + s * 2 * T::KT_BYTES;
        hp::mbar_expect_tx(&full[s], 2 * T::KT_BYTES);
        for (int c = 0; c < T::NCH; ++c) {
          hp::tma_load_4d(Ks + c * KT * T::RB, &kmap, &full[s], c * T::CH,
                          kvh, j * KT, b);
          hp::tma_load_4d(Ks + T::KT_BYTES + c * KT * T::RB, &vmap,
                          &full[s], c * T::CH, kvh, j * KT, b);
        }
      }
    }
    return;
  }

  hp::setmaxnreg_inc<240>();
  const int c = wg - 1;
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row_lo = q0 + 64 * c;              // this warpgroup's rows
  const int row0 = row_lo + 16 * warp + g;     // rows row0, row0 + 8
  const uint8_t* qa = Qs + 64 * c * T::RB;
  const uint8_t* da_s = dOs + 64 * c * T::RB;
  float lse2[2], dl[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row0 + 8 * hh;
    const long i = ((long)b * NH + h) * S + row;
    lse2[hh] = row < S ? lse[i] * LOG2E : INFINITY;   // rows past S: P = 0
    dl[hh] = row < S ? delta[i] : 0.f;
  }
  float dqa[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dqa[i] = 0.f;
  float sc[32], dp[32];
  uint32_t dsa[4][4];
  hp::mbar_wait(&q_full, 0);

  for (int j = 0; j < n_kt; ++j) {
    const int s = j % STAGES, kt0 = j * KT;
    const uint8_t* Ks = KVs + s * 2 * T::KT_BYTES;
    const uint8_t* Vs = Ks + T::KT_BYTES;
    hp::mbar_wait(&full[s], (j / STAGES) & 1);
    if (!causal || kt0 < row_lo + 64) {   // some row sees some key
      hp::wgmma_fence();
      issue_abt<D, KT>(sc, qa, DQ_ROWS, Ks);
      hp::wgmma_commit();
      issue_abt<D, KT>(dp, da_s, DQ_ROWS, Vs);
      hp::wgmma_commit();
      const bool masked = (causal && kt0 + KT - 1 > row_lo) || kt0 + KT > S;
      hp::wgmma_wait<1>();
      hp::fence_regs(sc);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int hh = (i >> 1) & 1;
        float p = ex2(fmaf(sc[i], scale_log2, -lse2[hh]));
        if (masked) {
          const int kp = kt0 + acc_col(i, t);
          if (kp >= S || (causal && kp > row0 + 8 * hh)) p = 0.f;
        }
        sc[i] = p;
      }
      hp::wgmma_wait<0>();
      hp::fence_regs(dp);
#pragma unroll
      for (int i = 0; i < 32; ++i)
        dp[i] = sc[i] * (dp[i] - dl[(i >> 1) & 1]);
      pack_frags(dsa, dp);
      hp::wgmma_fence();
      issue_rs<D>(dqa, dsa, Ks);
      hp::wgmma_commit();
      hp::wgmma_wait<0>();
      hp::fence_regs(dqa);
    }
    __syncwarp();
    if (lane == 0) hp::mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row0 + 8 * hh;
    if (row >= S) continue;
    bf16* out = dq + (((long)b * S + row) * NH + h) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * n + 2 * t) =
          __floats2bfloat162_rn(dqa[4 * n + 2 * hh] * sm_scale,
                                dqa[4 * n + 2 * hh + 1] * sm_scale);
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
// A bf16 tensor map of [B, S, heads, D] (innermost first: D, heads, S, B)
// whose box is `rows` rows of one head in D-column boxes of BwdTile's width.
template <int D>
int bwd_map(CUtensorMap* map, const void* base, int B, int S, int heads,
            int rows) {
  using T = BwdTile<D>;
  const uint64_t dims[4] = {D, (uint64_t)heads, (uint64_t)S, (uint64_t)B};
  const uint64_t strides[3] = {D * 2, (uint64_t)heads * D * 2,
                               (uint64_t)S * heads * D * 2};
  const uint32_t box[4] = {T::CH, 1, (uint32_t)rows, 1};
  return hp::make_map_bf16(map, base, 4, dims, strides, box, T::SW);
}

template <int D>
int launch_dq_wgmma(const void* q, const void* k, const void* v,
                    const void* lse, const void* dout, const void* delta,
                    void* dq, int B, int S, int NH, int NKV, int causal,
                    cudaStream_t stream) {
  using T = BwdTile<D>;
  CUtensorMap qmap, kmap, vmap, dmap;
  int rc = bwd_map<D>(&qmap, q, B, S, NH, DQ_ROWS);
  if (!rc) rc = bwd_map<D>(&dmap, dout, B, S, NH, DQ_ROWS);
  if (!rc) rc = bwd_map<D>(&kmap, k, B, S, NKV, KT);
  if (!rc) rc = bwd_map<D>(&vmap, v, B, S, NKV, KT);
  if (rc) return rc;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      T::DQ_SMEM);
  if (err != cudaSuccess) return (int)err;
  const float sm_scale = 1.0f / sqrtf((float)D);
  flash_bwd_dq_wgmma<D><<<dim3((S + DQ_ROWS - 1) / DQ_ROWS, NH, B),
                          WG_THREADS, T::DQ_SMEM, stream>>>(
      qmap, kmap, vmap, dmap, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dq), S, NH, NKV,
      causal, sm_scale * LOG2E, sm_scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv_wgmma(const void* q, const void* k, const void* v,
                     const void* lse, const void* dout, const void* delta,
                     void* dk, void* dv, int B, int S, int NH, int NKV,
                     int causal, cudaStream_t stream) {
  using T = BwdTile<D>;
  CUtensorMap qmap, kmap, vmap, dmap;
  int rc = bwd_map<D>(&qmap, q, B, S, NH, QT);
  if (!rc) rc = bwd_map<D>(&dmap, dout, B, S, NH, QT);
  if (!rc) rc = bwd_map<D>(&kmap, k, B, S, NKV, KV_ROWS);
  if (!rc) rc = bwd_map<D>(&vmap, v, B, S, NKV, KV_ROWS);
  if (rc) return rc;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      T::DKV_SMEM);
  if (err != cudaSuccess) return (int)err;
  const float sm_scale = 1.0f / sqrtf((float)D);
  flash_bwd_dkv_wgmma<D><<<dim3((S + KV_ROWS - 1) / KV_ROWS, NKV, B),
                           WG_THREADS, T::DKV_SMEM, stream>>>(
      qmap, kmap, vmap, dmap, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), S, NH, NKV, causal, sm_scale * LOG2E,
      sm_scale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_delta(const void* o, const void* dout, void* delta, int B, int S,
                 int NH, cudaStream_t stream) {
  constexpr int RPB = DELTA_THREADS / (D * (int)sizeof(T) / 16);
  const long rows = (long)B * S * NH;
  flash_bwd_delta<T, D><<<(unsigned)((rows + RPB - 1) / RPB),
                          DELTA_THREADS, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout),
      static_cast<float*>(delta), rows, S, NH);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dq_f32(const void* q, const void* k, const void* v, const void* o,
                  const void* lse, const void* dout, void* dq, int B, int S,
                  int NH, int NKV, int causal, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_f32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      dq_f32_smem<D>());
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dq_f32<D><<<dim3((S + BQ - 1) / BQ, NH, B), F32_THREADS,
                        dq_f32_smem<D>(), stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(o),
      static_cast<const float*>(lse), static_cast<const float*>(dout),
      static_cast<float*>(dq), S, NH, NKV, causal, 1.0f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv_f32(const void* q, const void* k, const void* v,
                   const void* o, const void* lse, const void* dout,
                   void* dk, void* dv, int B, int S, int NH, int NKV,
                   int causal, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_f32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      dkv_f32_smem<D>());
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dkv_f32<D><<<dim3((S + BK - 1) / BK, NKV, B), F32_THREADS,
                         dkv_f32_smem<D>(), stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(o),
      static_cast<const float*>(lse), static_cast<const float*>(dout),
      static_cast<float*>(dk), static_cast<float*>(dv), S, NH, NKV, causal,
      1.0f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

// A bf16 call needs delta; TMA needs 65535 or fewer heads and batches on
// the grid.
bool bad_shape(int B, int S, int NH, int NKV, int dtype, const void* delta) {
  return B <= 0 || S <= 0 || NKV <= 0 || NH % NKV != 0 || NH > 65535 ||
         B > 65535 || (dtype != 0 && dtype != 1) ||
         (dtype == 1 && delta == nullptr);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Each returns cudaGetLastError() after
// its launch (cudaErrorInvalidValue for an unsupported head dim, shape or
// dtype).  delta [B, NH, S] f32 is dstt_flash_bwd_delta's output for the
// same out and dO: the bf16 kernels read it; the f32 kernels compute delta
// themselves and ignore it (it may be null there).
extern "C" int dstt_flash_bwd_delta(const void* o, const void* dout,
                                    void* delta, int B, int S, int NH,
                                    int D, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0 || NH <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == 1) {
    if (D == 32) return launch_delta<bf16, 32>(o, dout, delta, B, S, NH, st);
    if (D == 64) return launch_delta<bf16, 64>(o, dout, delta, B, S, NH, st);
    if (D == 128)
      return launch_delta<bf16, 128>(o, dout, delta, B, S, NH, st);
  } else if (dtype == 0) {
    if (D == 32)
      return launch_delta<float, 32>(o, dout, delta, B, S, NH, st);
    if (D == 64)
      return launch_delta<float, 64>(o, dout, delta, B, S, NH, st);
    if (D == 128)
      return launch_delta<float, 128>(o, dout, delta, B, S, NH, st);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" int dstt_flash_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* o, const void* lse,
                                 const void* dout, const void* delta,
                                 void* dq, int B, int S, int NH, int NKV,
                                 int D, int causal, int dtype,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bad_shape(B, S, NH, NKV, dtype, delta))
    return (int)cudaErrorInvalidValue;
  if (dtype == 1) {
    if (D == 32)
      return launch_dq_wgmma<32>(q, k, v, lse, dout, delta, dq, B, S, NH,
                                 NKV, causal, st);
    if (D == 64)
      return launch_dq_wgmma<64>(q, k, v, lse, dout, delta, dq, B, S, NH,
                                 NKV, causal, st);
    if (D == 128)
      return launch_dq_wgmma<128>(q, k, v, lse, dout, delta, dq, B, S, NH,
                                  NKV, causal, st);
  } else {
    if (D == 32)
      return launch_dq_f32<32>(q, k, v, o, lse, dout, dq, B, S, NH, NKV,
                               causal, st);
    if (D == 64)
      return launch_dq_f32<64>(q, k, v, o, lse, dout, dq, B, S, NH, NKV,
                               causal, st);
    if (D == 128)
      return launch_dq_f32<128>(q, k, v, o, lse, dout, dq, B, S, NH, NKV,
                                causal, st);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" int dstt_flash_bwd_dkv(const void* q, const void* k,
                                  const void* v, const void* o,
                                  const void* lse, const void* dout,
                                  const void* delta, void* dk, void* dv,
                                  int B, int S, int NH, int NKV, int D,
                                  int causal, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bad_shape(B, S, NH, NKV, dtype, delta))
    return (int)cudaErrorInvalidValue;
  if (dtype == 1) {
    if (D == 32)
      return launch_dkv_wgmma<32>(q, k, v, lse, dout, delta, dk, dv, B, S,
                                  NH, NKV, causal, st);
    if (D == 64)
      return launch_dkv_wgmma<64>(q, k, v, lse, dout, delta, dk, dv, B, S,
                                  NH, NKV, causal, st);
    if (D == 128)
      return launch_dkv_wgmma<128>(q, k, v, lse, dout, delta, dk, dv, B, S,
                                   NH, NKV, causal, st);
  } else {
    if (D == 32)
      return launch_dkv_f32<32>(q, k, v, o, lse, dout, dk, dv, B, S, NH,
                                NKV, causal, st);
    if (D == 64)
      return launch_dkv_f32<64>(q, k, v, o, lse, dout, dk, dv, B, S, NH,
                                NKV, causal, st);
    if (D == 128)
      return launch_dkv_f32<128>(q, k, v, o, lse, dout, dk, dv, B, S, NH,
                                 NKV, causal, st);
  }
  return (int)cudaErrorInvalidValue;
}
