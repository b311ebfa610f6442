// Causal flash-attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel deepspeed_tpu/ops/flash_attention.py `_fwd`
// (pallas_call body `_fwd_kernel`): FlashAttention-2 online softmax with
// f32 accumulation, key tiles past the diagonal skipped by bounding the
// loop, GQA by reading kv head h // (NH/NKV) (no KV repeat), out + lse.
//
// Layout: q [B, S, NH, D], k/v [B, S, NKV, D] (the JAX public layout, so
// no transposes), out like q, lse [B, NH, S] f32.  S need not be a
// multiple of the tile: the ragged last tile is masked.
//
// bf16 (flash_fwd_wgmma): warp-specialised TMA + wgmma.  What bounds it:
// the two products, 4 S^2 D / 2 operations per head (causal) against
// 2 (2 S NH D + 2 S NKV D) bytes, far above the card's ~295 operations
// per byte at these lengths, so the tensor cores; the design keeps them
// fed.  One CTA = 128 query rows of one head: a producer warpgroup (one
// thread issues every TMA load; its registers handed to the consumers
// with setmaxnreg) and two consumer warpgroups of 64 rows each.  TMA
// loads Q once and K / V tiles of 128 keys into a 2-slot mbarrier ring
// (K and V on barriers of their own, so S = Q K^T starts before V
// lands), through 4-D tensor maps over [B, S, heads, D], so rows past S
// come back zero and a tile never crosses into the next batch.  Rows of
// more than 64 bf16 are loaded as 64-column boxes (the 128-byte swizzle's
// width); D 32 and 96 as 32-column boxes (64-byte swizzle), D 80 as
// 16-column boxes (32-byte swizzle), so P V is one wgmma of N = D over 3
// or 5 column blocks (hopper_tile.cuh's RowTile).  S = Q K^T is wgmma with both
// operands in shared memory (K is the K-major B); the online softmax runs
// on the f32 accumulators with a base-2 exponent, masking only the
// diagonal tile and the ragged end; O += P V takes P from registers
// (rounded to bf16, FlashAttention-2's layout trick, now wgmma's A
// fragment) and the V tile as the MN-major B (the transpose bit).  The
// consumers free a slot at its mbarrier: no CTA-wide barrier per tile.
// The grid is (q tiles, NH, B), the q tiles walked from the last, so
// the longest causal rows of a head start first and the CTAs in flight
// share a few heads' K and V in L2 (a head-minor order streams every
// head's K/V at once, more than the 50 MB L2 at the training shape).
//
// f32 (flash_fwd_kernel): grid (ceil(S/64), NH, B), one CTA per 64-row
// query tile of one head on attn_tile.cuh's CUDA-core core (its note says
// what bounds it).  Causal CTAs walk keys [0, q0 + rows) only.
#include "attn_tile.cuh"
#include "hopper_tile.cuh"

namespace {

struct DenseKeyOff {
  long base, stride;
  __device__ __forceinline__ long operator()(int kp) const {
    return base + (long)kp * stride;
  }
};

// f32: one CTA per 64-row query tile on attn_tile's CUDA-core core
template <int D>
__global__ void __launch_bounds__(dstt::NTHREADS)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int S, int NH, int NKV,
                 int causal, float sm_scale) {
  const int q0 = blockIdx.x * dstt::BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (NH / NKV);
  const int n_rows = min(dstt::BQ, S - q0);
  const long row_stride = (long)NH * D;
  const long base = ((long)b * S + q0) * NH * D + (long)h * D;
  const DenseKeyOff key_off{(long)b * S * NKV * D + (long)kvh * D,
                            (long)NKV * D};
  const int k_end = causal ? min(S, q0 + n_rows) : S;
  dstt::attn_tile<D>(q + base, row_stride, k, v, key_off, o + base,
                     row_stride, lse + ((long)b * NH + h) * S + q0, n_rows,
                     q0, causal != 0, 0, 0, k_end, sm_scale);
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o,
               void* lse, int B, int S, int NH, int NKV, int causal,
               cudaStream_t stream) {
  const int smem = dstt::tile_smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + dstt::BQ - 1) / dstt::BQ, NH, B);
  flash_fwd_kernel<D><<<grid, dstt::NTHREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), S, NH, NKV, causal, 1.0f / sqrtf((float)D));
  return (int)cudaGetLastError();
}


// ---------------------------------------------------------------------
// bf16: TMA + wgmma, warp-specialised
namespace hp = dstt::hopper;

constexpr int FQ = 128;         // query rows per CTA (two warpgroups)
constexpr int FK = 128;         // keys per tile
constexpr int F_STAGES = 3;     // K/V ring slots
constexpr int F_THREADS = 384;  // producer warpgroup + two consumers
constexpr float LOG2E = 1.4426950408889634f;

// a row's boxes as RowTile<D> cuts them (CH = 64, 32 or 16 columns, each
// with the swizzle of its width), and the CTA's tile sizes
template <int D>
struct FwdTile : hp::RowTile<D> {
  static constexpr int Q_BYTES = FQ * D * 2;
  static constexpr int KV_BYTES = FK * D * 2;
  static constexpr int SMEM = 1024 + Q_BYTES + F_STAGES * 2 * KV_BYTES;
};

// S = Q K^T for one warpgroup: its 64 query rows (Q tile `qs`) against
// the 128 keys of K tile `ks`, both K-major in D-column boxes.
template <int D>
__device__ __forceinline__ void issue_s(float (&sc)[FK / 2],
                                        const uint8_t* qs,
                                        const uint8_t* ks) {
  using T = FwdTile<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int ch = kk * 16 / T::CH, within = (kk * 16 % T::CH) * 2;
    const uint64_t da = hp::smem_desc(qs + ch * FQ * T::RB + within, T::SW,
                                      16, 8 * T::RB);
    const uint64_t db = hp::smem_desc(ks + ch * FK * T::RB + within, T::SW,
                                      16, 8 * T::RB);
    hp::wgmma_ss<FK, 0>(sc, da, db, kk > 0);
  }
}

// O += P V: P from registers (the bf16 A fragments), V tile `vs` as the
// MN-major B, 16 keys a step, D in CH-column boxes FK rows apart.
template <int D>
__device__ __forceinline__ void issue_pv(float (&oacc)[D / 2],
                                         uint32_t (&pa)[FK / 16][4],
                                         const uint8_t* vs) {
  using T = FwdTile<D>;
#pragma unroll
  for (int kk = 0; kk < FK / 16; ++kk) {
    const uint64_t db = hp::smem_desc(vs + kk * 16 * T::RB, T::SW,
                                      FK * T::RB, 8 * T::RB);
    hp::wgmma_rs<D, 1>(oacc, pa[kk], db, 1);
  }
}

// Online softmax of one S tile in place: mask (only where `masked`), new
// row max m (log2 units: the raw max times scale_log2), alpha =
// 2^(m_old - m_new) for the output and l, p = 2^(s scale_log2 - m) into
// sc by one FMA and ex2.  sc[4 jj + e] is row row0 + 8 (e / 2), key
// k0 + 8 jj + 2 t + e % 2.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void softmax_tile(float (&sc)[FK / 2],
                                             float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], bool masked,
                                             int k0, int row0, int t, int S,
                                             int causal, float scale_log2) {
  float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int jj = 0; jj < FK / 8; ++jj) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (masked) {
        const int kp = k0 + 8 * jj + 2 * t + (e & 1);
        if (kp >= S || (causal && kp > row0 + 8 * (e >> 1)))
          sc[4 * jj + e] = -INFINITY;
      }
      tmax[e >> 1] = fmaxf(tmax[e >> 1], sc[4 * jj + e]);
    }
  }
  float mu[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    tmax[hh] = fmaxf(tmax[hh], __shfl_xor_sync(0xffffffffu, tmax[hh], 1));
    tmax[hh] = fmaxf(tmax[hh], __shfl_xor_sync(0xffffffffu, tmax[hh], 2));
    const float m_new = fmaxf(m[hh], tmax[hh] * scale_log2);
    // a row with no visible key so far keeps m = -inf and adds nothing
    mu[hh] = m_new == -INFINITY ? 0.f : m_new;
    alpha[hh] = ex2(m[hh] - mu[hh]);
    m[hh] = m_new;
    l[hh] *= alpha[hh];
  }
#pragma unroll
  for (int jj = 0; jj < FK / 8; ++jj) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = ex2(fmaf(sc[4 * jj + e], scale_log2, -mu[e >> 1]));
      sc[4 * jj + e] = p;
      l[e >> 1] += p;
    }
  }
}

// P (f32, the S accumulator layout) as the bf16 A fragments of P V.
__device__ __forceinline__ void pack_p(uint32_t (&pa)[FK / 16][4],
                                       const float (&sc)[FK / 2]) {
#pragma unroll
  for (int kk = 0; kk < FK / 16; ++kk) {
    pa[kk][0] = dstt::pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
    pa[kk][1] = dstt::pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
    pa[kk][2] = dstt::pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
    pa[kk][3] = dstt::pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
    hp::fence_regs(pa[kk]);
  }
}


template <int D>
__global__ void __launch_bounds__(F_THREADS, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap qmap,
                const __grid_constant__ CUtensorMap kmap,
                const __grid_constant__ CUtensorMap vmap,
                __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                int S, int NH, int NKV, int causal, float scale_log2) {
  using T = FwdTile<D>;
  extern __shared__ __align__(1024) uint8_t smem_tma[];
  uint8_t* Qs = hp::align1024(smem_tma);
  uint8_t* KVs = Qs + T::Q_BYTES;   // slot s: K, then V
  __shared__ __align__(8) uint64_t q_full, k_full[F_STAGES],
      v_full[F_STAGES], empty[F_STAGES];
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * FQ;
  const int kvh = h / (NH / NKV);
  const int n_kt = ((causal ? min(S, q0 + FQ) : S) + FK - 1) / FK;
  const int tid = threadIdx.x, wg = tid >> 7;
  if (tid == 0) {
    hp::mbar_init(&q_full, 1);
    for (int s = 0; s < F_STAGES; ++s) {
      hp::mbar_init(&k_full[s], 1);
      hp::mbar_init(&v_full[s], 1);
      hp::mbar_init(&empty[s], 8);    // one arrival per consumer warp
    }
    hp::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {   // producer
    hp::setmaxnreg_dec<24>();
    if (tid == 0) {
      hp::mbar_expect_tx(&q_full, T::Q_BYTES);
      for (int c = 0; c < T::NCH; ++c)
        hp::tma_load_4d(Qs + c * FQ * T::RB, &qmap, &q_full, c * T::CH, h,
                        q0, b);
      for (int j = 0; j < n_kt; ++j) {
        const int s = j % F_STAGES;
        hp::mbar_wait(&empty[s], ((j / F_STAGES) & 1) ^ 1);
        uint8_t* Ks = KVs + s * 2 * T::KV_BYTES;
        uint8_t* Vs = Ks + T::KV_BYTES;
        hp::mbar_expect_tx(&k_full[s], T::KV_BYTES);
        for (int c = 0; c < T::NCH; ++c)
          hp::tma_load_4d(Ks + c * FK * T::RB, &kmap, &k_full[s],
                          c * T::CH, kvh, j * FK, b);
        hp::mbar_expect_tx(&v_full[s], T::KV_BYTES);
        for (int c = 0; c < T::NCH; ++c)
          hp::tma_load_4d(Vs + c * FK * T::RB, &vmap, &v_full[s],
                          c * T::CH, kvh, j * FK, b);
      }
    }
    return;
  }

  hp::setmaxnreg_inc<240>();
  const int c = wg - 1;
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = q0 + 64 * c + 16 * warp + g;   // rows row0, row0 + 8
  const uint8_t* qs = Qs + 64 * c * T::RB;         // this warpgroup's rows
  float oacc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) oacc[i] = 0.f;
  float sc[FK / 2];
  uint32_t pa[FK / 16][4];
  float m[2] = {-INFINITY, -INFINITY};   // running max, log2 units
  float l[2] = {0.f, 0.f};               // this lane's partial row sums
  float alpha[2];
  // tile j needs the mask where it holds keys past S or, causal, keys
  // past this warpgroup's first row
  const int row_lo = q0 + 64 * c;
  auto masked = [&](int k0) {
    return k0 + FK > S || (causal && k0 + FK - 1 > row_lo);
  };
  // The two warpgroups take turns to issue their products (barriers
  // 1 + c: a warpgroup waits for its turn, issues, and hands the turn
  // over), so one's softmax runs while the other's products hold the
  // tensor cores; warpgroup 0 goes first.
  const int my_turn = 1 + c, their_turn = 2 - c;
  if (c == 1) hp::named_arrive(their_turn, 256);
  hp::mbar_wait(&q_full, 0);

  // tile 0: S, softmax, P
  hp::mbar_wait(&k_full[0], 0);
  hp::named_sync(my_turn, 256);
  hp::wgmma_fence();
  issue_s<D>(sc, qs, KVs);
  hp::wgmma_commit();
  if (c == 0 || n_kt > 1) hp::named_arrive(their_turn, 256);
  hp::wgmma_wait<0>();
  hp::fence_regs(sc);
  softmax_tile(sc, m, l, alpha, masked(0), 0, row0, t, S, causal,
               scale_log2);
  pack_p(pa, sc);

  // tile j: S_j = Q K_j^T and O = alpha_{j-1} O + P_{j-1} V_{j-1} are
  // issued in this warpgroup's turn; the softmax of S_j runs while
  // P_{j-1} V_{j-1} (and the other warpgroup's products) hold the tensor
  // cores
  for (int j = 1; j < n_kt; ++j) {
    const int s = j % F_STAGES, sp = (j - 1) % F_STAGES;
    hp::mbar_wait(&k_full[s], (j / F_STAGES) & 1);
    hp::named_sync(my_turn, 256);
    hp::wgmma_fence();
    issue_s<D>(sc, qs, KVs + s * 2 * T::KV_BYTES);
    hp::wgmma_commit();
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      oacc[4 * n] *= alpha[0];
      oacc[4 * n + 1] *= alpha[0];
      oacc[4 * n + 2] *= alpha[1];
      oacc[4 * n + 3] *= alpha[1];
    }
    hp::fence_regs(oacc);
    hp::mbar_wait(&v_full[sp], ((j - 1) / F_STAGES) & 1);
    hp::wgmma_fence();
    issue_pv<D>(oacc, pa, KVs + sp * 2 * T::KV_BYTES + T::KV_BYTES);
    hp::wgmma_commit();
    // the last turn of warpgroup 1 is handed to no one
    if (c == 0 || j < n_kt - 1) hp::named_arrive(their_turn, 256);
    hp::wgmma_wait<1>();            // S_j is done (groups end in order)
    hp::fence_regs(sc);
    softmax_tile(sc, m, l, alpha, masked(j * FK), j * FK, row0, t, S,
                 causal, scale_log2);
    hp::wgmma_wait<0>();            // P_{j-1} V_{j-1} is done
    hp::fence_regs(oacc);
    __syncwarp();
    if (lane == 0) hp::mbar_arrive(&empty[sp]);
    pack_p(pa, sc);
  }

  // the last tile's P V
  {
    const int sp = (n_kt - 1) % F_STAGES;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      oacc[4 * n] *= alpha[0];
      oacc[4 * n + 1] *= alpha[0];
      oacc[4 * n + 2] *= alpha[1];
      oacc[4 * n + 3] *= alpha[1];
    }
    hp::fence_regs(oacc);
    hp::mbar_wait(&v_full[sp], ((n_kt - 1) / F_STAGES) & 1);
    hp::wgmma_fence();
    issue_pv<D>(oacc, pa, KVs + sp * 2 * T::KV_BYTES + T::KV_BYTES);
    hp::wgmma_commit();
    hp::wgmma_wait<0>();
    hp::fence_regs(oacc);
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
    const int row = row0 + 8 * hh;
    if (row >= S) continue;
    const float inv = l[hh] > 0.f ? 1.f / l[hh] : 0.f;
    __nv_bfloat16* orow = o + (((long)b * S + row) * NH + h) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n + 2 * t) =
          __floats2bfloat162_rn(oacc[4 * n + 2 * hh] * inv,
                                oacc[4 * n + 2 * hh + 1] * inv);
    if (t == 0)
      lse[((long)b * NH + h) * S + row] =
          l[hh] > 0.f ? m[hh] / LOG2E + logf(l[hh]) : -INFINITY;
  }
}

template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, void* o,
                 void* lse, int B, int S, int NH, int NKV, int causal,
                 cudaStream_t stream) {
  using T = FwdTile<D>;
  const long q_tiles = (S + FQ - 1) / FQ;
  if (NH > 65535 || B > 65535) return (int)cudaErrorInvalidValue;
  CUtensorMap qmap, kmap, vmap;
  const uint32_t box[4] = {T::CH, 1, FQ, 1};
  const uint64_t qd[4] = {D, (uint64_t)NH, (uint64_t)S, (uint64_t)B};
  const uint64_t qs[3] = {D * 2, (uint64_t)NH * D * 2,
                          (uint64_t)S * NH * D * 2};
  const uint64_t kd[4] = {D, (uint64_t)NKV, (uint64_t)S, (uint64_t)B};
  const uint64_t ks[3] = {D * 2, (uint64_t)NKV * D * 2,
                          (uint64_t)S * NKV * D * 2};
  int rc = hp::make_map_bf16(&qmap, q, 4, qd, qs, box, T::SW);
  if (!rc) rc = hp::make_map_bf16(&kmap, k, 4, kd, ks, box, T::SW);
  if (!rc) rc = hp::make_map_bf16(&vmap, v, 4, kd, ks, box, T::SW);
  if (rc) return rc;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      T::SMEM);
  if (err != cudaSuccess) return (int)err;
  flash_fwd_wgmma<D><<<dim3((unsigned)q_tiles, NH, B), F_THREADS, T::SMEM,
                       stream>>>(
      qmap, kmap, vmap, static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), S, NH, NKV, causal,
      LOG2E / sqrtf((float)D));
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for an unsupported head dim or dtype).
extern "C" int dstt_flash_fwd(const void* q, const void* k, const void* v,
                              void* o, void* lse, int B, int S, int NH,
                              int NKV, int D, int causal, int dtype,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0 || NKV <= 0 || NH % NKV != 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == 1) {
    if (D == 32)
      return launch_wgmma<32>(q, k, v, o, lse, B, S, NH, NKV, causal, st);
    if (D == 64)
      return launch_wgmma<64>(q, k, v, o, lse, B, S, NH, NKV, causal, st);
    if (D == 80)
      return launch_wgmma<80>(q, k, v, o, lse, B, S, NH, NKV, causal, st);
    if (D == 96)
      return launch_wgmma<96>(q, k, v, o, lse, B, S, NH, NKV, causal, st);
    if (D == 128)
      return launch_wgmma<128>(q, k, v, o, lse, B, S, NH, NKV, causal, st);
  } else if (dtype == 0) {
    if (D == 32)
      return launch_f32<32>(q, k, v, o, lse, B, S, NH, NKV, causal, st);
    if (D == 64)
      return launch_f32<64>(q, k, v, o, lse, B, S, NH, NKV, causal, st);
    if (D == 80)
      return launch_f32<80>(q, k, v, o, lse, B, S, NH, NKV, causal, st);
    if (D == 96)
      return launch_f32<96>(q, k, v, o, lse, B, S, NH, NKV, causal, st);
    if (D == 128)
      return launch_f32<128>(q, k, v, o, lse, B, S, NH, NKV, causal, st);
  }
  return (int)cudaErrorInvalidValue;
}
