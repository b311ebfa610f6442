// Causal blocked-flash prefill over the paged KV arena, for Hopper (sm_90a).
//
// Replaces the TPU kernel deepspeed_tpu/ops/paged_prefill.py
// `paged_prefill_attention` (pallas_call body `_kernel`): C chunk queries
// at absolute positions pos0 .. pos0+C-1 attend the keys their block table
// points at, under key_pos <= q_pos and, when window > 0, key_pos > q_pos -
// window; online softmax in f32; neither the gathered K/V copy nor the
// score matrix is ever written to device memory.
//
// Beyond the TPU kernel, each kernel takes ALiBi slopes [NH] f32 (the
// reference's callers send ALiBi models to a dense gather in XLA): each
// visible score qk/sqrt(D) takes -slope[h] (q_pos - key_pos), added in f32
// before the running max, in the layout the masks are built in; a model
// that adds the bias before the 1/sqrt(D) scale (Falcon-RW) passes slopes
// divided by sqrt(D), so the kernels do not branch on the architecture.
// The bias is a template flag (ALIBI): a call without slopes runs the code
// it ran before.
//
// Layout: q [C, NH, D]; arena k/v [L, nb, bs, NKV, D] (the merged
// [L, nb, bs, NKV * D] is the same bytes) read at layer `layer`; table [MB]
// int32, entries clamped to [0, nb-1] like the reference; out [C, NH, D].
// A 64-query tile walks keys from the window's start for its first query
// up to its last VALID query (pos0 + min(c0+64, n_valid) - 1), so key
// blocks past the chunk's valid rows are never read.  Rows c >= n_valid
// are padding the caller drops.  Every C >= 1 is served.
//
// Two kernels; `ops/paged_prefill.py:prefill_variant` names the one a call
// takes (a stated rule, each with its launch count):
//
// paged_prefill_wgmma ("tma": bf16, D 32/64/80/96/128, a block size TMA
// can tile, see paged_tile.cuh; D 80 and 96 in 16- and 32-column boxes,
// hopper_tile.cuh's RowTile, so P V is one wgmma of N = D).  What bounds it: the two products, 4 D per
// visible (query, key) pair against each visible key row read about once
// (at C 256, pos0 1024, NH 32, D 128: 4.8 GFLOP and 21 MB, some 5-7 us of
// either); what held the mma.sync kernel back was latency (loads, then a
// barrier, then the products, per tile; 128 CTAs of 17-20 serial tiles).
// One CTA = 64 query rows of one head and one contiguous range of their
// key tiles: a producer warp (one lane issues every TMA load) reads the
// block table, clamps each entry and loads Q once and each 64-key tile of
// K and V (64 / bs page boxes, or part of one page) into a 2-slot mbarrier
// ring, K and V on barriers of their own; the consumer warpgroup runs
// S = Q K^T as an SS-wgmma (K K-major), the online softmax on the f32
// accumulators with a base-2 exponent (masks only on the diagonal tile,
// the window's edge and the ragged end), and O += P V as an RS-wgmma (P
// rounded to bf16 in registers, V MN-major through the transpose bit),
// freeing each slot at its mbarrier: no CTA-wide barrier per tile.  Rows
// of an edge tile outside the keys the range may read are zeroed in V
// before P V, so garbage past a sequence's end never meets P = 0 as NaN.
// The grid (NH, q tiles, splits) puts the G query heads of a kv head next
// to each other (their K/V pages share L2) and splits every tile's key
// range over `splits` CTAs (`ops/paged_prefill.py:prefill_plan`, chosen
// on the host from C, n_valid, pos0 and the window: the card fills at
// phase 13's local heads too).  With splits > 1 each CTA writes its
// unnormalised (m, l, acc) to a workspace and takes an integer ticket of
// its tile; the CTA that takes the last one merges the splits in split
// order (its own from registers) and resets the ticket.  No float
// atomics: a rerun is bit for bit the same.
//
// paged_prefill_kernel ("mma": other bf16 block sizes; "f32"): grid
// (ceil(C/64), NH), one CTA per 64-query tile of one head on
// attn_tile.cuh's tile core (its note says what bounds it).
#include "attn_tile.cuh"
#include "paged_tile.cuh"

namespace {

struct PagedKeyOff {
  const int* table;
  long layer_off, row_stride, head_off;
  int nb, bs;
  __device__ __forceinline__ long operator()(int kp) const {
    int blk = table[kp / bs];
    blk = min(max(blk, 0), nb - 1);
    return layer_off + ((long)blk * bs + kp % bs) * row_stride + head_off;
  }
};

template <typename T, int D, bool ALIBI>
__global__ void __launch_bounds__(dstt::launch_threads<T>())
paged_prefill_kernel(const T* __restrict__ q, const T* __restrict__ ak,
                     const T* __restrict__ av, const int* __restrict__ table,
                     T* __restrict__ o, int C, int NH, int NKV, int nb,
                     int bs, int MB, long layer_off, int pos0, int n_valid,
                     int window, float sm_scale,
                     const float* __restrict__ slopes) {
  const int c0 = blockIdx.x * dstt::BQ;
  const int h = blockIdx.y;
  const int kvh = h / (NH / NKV);
  const int n_rows = min(dstt::BQ, C - c0);
  const long row_stride = (long)NH * D;
  const long base = (long)c0 * NH * D + (long)h * D;
  const PagedKeyOff key_off{table, layer_off, (long)NKV * D, (long)kvh * D,
                            nb, bs};
  const int qpos0 = pos0 + c0;
  const int last_q = pos0 + min(c0 + dstt::BQ, n_valid) - 1;
  const int k_end = max(0, min(last_q + 1, MB * bs));
  const int k_begin = window > 0 ? max(0, qpos0 - window + 1) : 0;
  dstt::attn_tile_any<T, D, ALIBI>(
      q + base, row_stride, ak, av, key_off, o + base, row_stride, nullptr,
      n_rows, qpos0, true, window, k_begin, k_end, sm_scale,
      ALIBI ? slopes[h] : 0.f);
}

template <typename T, int D, bool ALIBI>
int launch(const void* q, const void* ak, const void* av, const void* table,
           void* o, int C, int NH, int NKV, int nb, int bs, int MB,
           long long layer_off, int pos0, int n_valid, int window,
           const float* slopes, cudaStream_t stream) {
  const int smem = dstt::launch_smem_bytes<T>(D);
  cudaError_t err = cudaFuncSetAttribute(
      paged_prefill_kernel<T, D, ALIBI>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((C + dstt::BQ - 1) / dstt::BQ, NH);
  paged_prefill_kernel<T, D, ALIBI><<<grid, dstt::launch_threads<T>(), smem,
                                      stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(ak),
      static_cast<const T*>(av), static_cast<const int*>(table),
      static_cast<T*>(o), C, NH, NKV, nb, bs, MB, (long)layer_off, pos0,
      n_valid, window, 1.0f / sqrtf((float)D), slopes);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_any(const void* q, const void* ak, const void* av,
               const void* table, void* o, int C, int NH, int NKV, int nb,
               int bs, int MB, long long layer_off, int pos0, int n_valid,
               int window, const void* slopes, cudaStream_t stream) {
  const float* sl = static_cast<const float*>(slopes);
  if (sl)
    return launch<T, D, true>(q, ak, av, table, o, C, NH, NKV, nb, bs, MB,
                              layer_off, pos0, n_valid, window, sl, stream);
  return launch<T, D, false>(q, ak, av, table, o, C, NH, NKV, nb, bs, MB,
                             layer_off, pos0, n_valid, window, sl, stream);
}

// ---------------------------------------------------------------------
// bf16: TMA + wgmma, split over the key range (paged_prefill_wgmma)
namespace hp = dstt::hopper;
namespace pg = dstt::paged;
using bf16 = __nv_bfloat16;

constexpr int PQ = 64;             // query rows a CTA (one warpgroup)
constexpr int P_STAGES = 2;        // K/V ring slots
constexpr int P_THREADS = 128 + 32;   // consumer warpgroup + producer warp

template <int D>
struct PrefillTile {
  static constexpr int TILE = pg::TK * D * 2;   // a Q, K or V tile, bytes
  static constexpr int SMEM = 1024 + TILE + P_STAGES * 2 * TILE;
  // a split's partial state: D / 2 accumulators and (m, m, l, l) a thread
  static constexpr int PART = 128 * (D / 2 + 4);
};

struct PrefillArgs {
  int C, NH, NKV, nb, bs, MB, page0, pos0, n_valid, window, splits;
  float scale_log2;
  const float* slopes;   // the ALIBI build's [NH] slopes
};

// Query tile qt's keys: [k_begin, k_end) (the window's start for its first
// query, one past its last valid query, within the table), as key tiles
// [t_lo, t_hi); split s of `splits` takes tiles [j0, j1).  The host plan
// (ops/paged_prefill.py:prefill_plan) computes the same ranges.
struct TileRange {
  int k_begin, k_end, j0, j1;
};

__device__ __forceinline__ TileRange tile_range(const PrefillArgs& a, int qt,
                                                int split) {
  TileRange r;
  const int c0 = qt * PQ, qlo = a.pos0 + c0;
  r.k_end = max(0, min(a.pos0 + min(c0 + PQ, a.n_valid), a.MB * a.bs));
  r.k_begin = a.window > 0 ? max(0, qlo - a.window + 1) : 0;
  const int t_lo = r.k_begin / pg::TK;
  const int t_hi = r.k_end > r.k_begin ? (r.k_end + pg::TK - 1) / pg::TK
                                       : t_lo;
  const int n = t_hi - t_lo;
  r.j0 = t_lo + (int)((long)split * n / a.splits);
  r.j1 = t_lo + (int)((long)(split + 1) * n / a.splits);
  return r;
}

// Online softmax of one m64n64 S tile in place (element i: row r0 +
// 8 ((i >> 1) & 1), key k0 + acc_col(i, t)): mask where `masked` (key past
// the row's position, past k_end, or outside the window), new row max m
// (log2 units), alpha = 2^(m_old - m_new), p = 2^(s scale_log2 - m).  With
// ALIBI the visible scores are first taken to log2 units with their bias,
// s scale_log2 - slope_log2 (q_pos - k_pos), and the scale is then 1.
template <bool ALIBI>
__device__ __forceinline__ void prefill_softmax(
    float (&sc)[32], float (&m)[2], float (&l)[2], float (&alpha)[2],
    bool masked, int k0, int qpos0, int t, int k_end, int window,
    float scale_log2, float slope_log2) {
  float tmax[2] = {-INFINITY, -INFINITY};
  if constexpr (ALIBI) {
    // slope (k - q) = slope (k0 + 2t - q) + slope (8 (i >> 2) + (i & 1)):
    // a row's base and a column constant, two FMAs an element
    float base[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      base[hh] = slope_log2 * (float)(k0 + 2 * t - qpos0 - 8 * hh);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int hh = (i >> 1) & 1;
      const int kp = k0 + hp::acc_col(i, t), qp = qpos0 + 8 * hh;
      if (masked &&
          (kp > qp || kp >= k_end || (window > 0 && kp <= qp - window)))
        sc[i] = -INFINITY;
      else
        sc[i] = fmaf(sc[i], scale_log2,
                     fmaf(slope_log2, (float)(8 * (i >> 2) + (i & 1)),
                          base[hh]));
      tmax[hh] = fmaxf(tmax[hh], sc[i]);
    }
    scale_log2 = 1.f;   // the scores are in log2 units now
  } else {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int hh = (i >> 1) & 1;
      if (masked) {
        const int kp = k0 + hp::acc_col(i, t), qp = qpos0 + 8 * hh;
        if (kp > qp || kp >= k_end || (window > 0 && kp <= qp - window))
          sc[i] = -INFINITY;
      }
      tmax[hh] = fmaxf(tmax[hh], sc[i]);
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
    alpha[hh] = hp::ex2(m[hh] - mu[hh]);
    m[hh] = m_new;
    l[hh] *= alpha[hh];
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int hh = (i >> 1) & 1;
    const float p = hp::ex2(fmaf(sc[i], scale_log2, -mu[hh]));
    sc[i] = p;
    l[hh] += p;
  }
}

template <int D>
__device__ __forceinline__ void rescale(float (&oacc)[D / 2],
                                        const float (&alpha)[2]) {
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    oacc[4 * n] *= alpha[0];
    oacc[4 * n + 1] *= alpha[0];
    oacc[4 * n + 2] *= alpha[1];
    oacc[4 * n + 3] *= alpha[1];
  }
  hp::fence_regs(oacc);
}

// Rows c0 + r0 and + 8 of head h, normalised by l (a row that saw no key
// gives zeros), rows past C dropped.
template <int D>
__device__ __forceinline__ void store_rows(bf16* __restrict__ o,
                                           const float (&oacc)[D / 2],
                                           const float (&l)[2], int row0,
                                           int t, int C, int NH, int h) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row0 + 8 * hh;
    if (row >= C) continue;
    const float inv = l[hh] > 0.f ? 1.f / l[hh] : 0.f;
    bf16* orow = o + ((long)row * NH + h) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n + 2 * t) =
          __floats2bfloat162_rn(oacc[4 * n + 2 * hh] * inv,
                                oacc[4 * n + 2 * hh + 1] * inv);
  }
}

// O += P V for the tile at key k0 from V tile `Vs` (slot barrier `bar`,
// phase `parity`); on an edge tile the V rows outside [k_begin, k_end)
// are zeroed first (their P is 0, and garbage there must not be NaN).
template <int D>
__device__ __forceinline__ void issue_pv(float (&oacc)[D / 2],
                                         const uint32_t (&pa)[4][4],
                                         uint8_t* Vs, uint64_t* bar,
                                         uint32_t parity, int k0,
                                         int k_begin, int k_end, int tid) {
  hp::mbar_wait(bar, parity);
  if (k0 < k_begin || k0 + pg::TK > k_end) {
    pg::zero_rows<D>(Vs, k_begin - k0, k_end - k0, tid, 128);
    hp::fence_proxy_async();
    hp::named_sync(1, 128);
  }
  hp::wgmma_fence();
  hp::issue_rs<D>(oacc, pa, Vs);
  hp::wgmma_commit();
}

template <int D, bool ALIBI>
__global__ void __launch_bounds__(P_THREADS, 2)
paged_prefill_wgmma(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap,
                    const int* __restrict__ table, bf16* __restrict__ o,
                    float* __restrict__ ws, int* __restrict__ tickets,
                    PrefillArgs a) {
  using T = hp::RowTile<D>;
  using P = PrefillTile<D>;
  extern __shared__ __align__(1024) uint8_t smem_tma[];
  uint8_t* Qs = hp::align1024(smem_tma);
  uint8_t* KVs = Qs + P::TILE;   // slot s: K at 2 s TILE, V after it
  __shared__ __align__(8) uint64_t q_full, k_full[P_STAGES],
      v_full[P_STAGES], k_empty[P_STAGES], v_empty[P_STAGES];
  __shared__ int last;
  const int h = blockIdx.x, qt = blockIdx.y, split = blockIdx.z;
  const int kvh = h / (a.NH / a.NKV);
  const TileRange kr = tile_range(a, qt, split);
  const int nt = kr.j1 - kr.j0;
  const int tid = threadIdx.x;
  if (tid == 0) {
    hp::mbar_init(&q_full, 1);
    for (int s = 0; s < P_STAGES; ++s) {
      hp::mbar_init(&k_full[s], 1);
      hp::mbar_init(&v_full[s], 1);
      hp::mbar_init(&k_empty[s], 4);   // one arrival a consumer warp
      hp::mbar_init(&v_empty[s], 4);
    }
    hp::mbar_fence_init();
  }
  __syncthreads();

  if (tid >= 128) {   // the producer warp (lane 0 issues every load)
    const int lane = tid & 31;
    const int rows = a.bs < pg::TK ? a.bs : pg::TK;
    pg::BoxPages pages{table, a.MB, a.nb, a.bs, rows, kr.j0 * pg::TK};
    if (lane == 0) {
      hp::mbar_expect_tx(&q_full, P::TILE);
      for (int c = 0; c < T::NCH; ++c)
        hp::tma_load_4d(Qs + c * PQ * T::RB, &qmap, &q_full, c * T::CH, h,
                        qt * PQ, 0);
    }
    // K of a slot is freed when its S is done, V when its P V is
    for (int j = 0; j < nt; ++j) {
      const int s = j % P_STAGES;
      const uint32_t free_parity = ((j / P_STAGES) & 1) ^ 1;
      const int box0 = j * (pg::TK / rows);
      uint8_t* Ks = KVs + s * 2 * P::TILE;
      hp::mbar_wait(&k_empty[s], free_parity);
      if (lane == 0) hp::mbar_expect_tx(&k_full[s], P::TILE);
      pg::load_tile<D>(Ks, &kmap, &k_full[s], pages, box0, a.page0, kvh,
                       lane);
      hp::mbar_wait(&v_empty[s], free_parity);
      if (lane == 0) hp::mbar_expect_tx(&v_full[s], P::TILE);
      pg::load_tile<D>(Ks + P::TILE, &vmap, &v_full[s], pages, box0,
                       a.page0, kvh, lane);
    }
    return;
  }

  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = 16 * warp + g;            // rows r0, r0 + 8 of the tile
  const int qlo = a.pos0 + qt * PQ;        // the tile's first position
  const int qpos0 = qlo + r0;
  float oacc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) oacc[i] = 0.f;
  float sc[32];
  uint32_t pa[4][4];
  float m[2] = {-INFINITY, -INFINITY};   // running max, log2 units
  float l[2] = {0.f, 0.f};               // this lane's partial row sums
  float alpha[2] = {1.f, 1.f};
  const float slope_log2 = ALIBI ? a.slopes[h] * 1.4426950408889634f : 0.f;
  // tile k0 needs the mask where it holds a key past the tile's first
  // row, past k_end, or at or before the last row's window edge
  auto masked = [&](int k0) {
    return k0 + pg::TK - 1 > qlo || k0 + pg::TK > kr.k_end ||
           (a.window > 0 && k0 <= qlo + PQ - 1 - a.window);
  };
  hp::mbar_wait(&q_full, 0);

  if (nt > 0) {
    hp::mbar_wait(&k_full[0], 0);
    hp::wgmma_fence();
    hp::issue_abt<D, 64>(sc, Qs, PQ, KVs);
    hp::wgmma_commit();
    hp::wgmma_wait<0>();
    hp::fence_regs(sc);
    __syncwarp();
    if (lane == 0) hp::mbar_arrive(&k_empty[0]);
    prefill_softmax<ALIBI>(sc, m, l, alpha, masked(kr.j0 * pg::TK),
                           kr.j0 * pg::TK, qpos0, t, kr.k_end, a.window,
                           a.scale_log2, slope_log2);
    hp::pack_frags(pa, sc);
    // tile j: S_j = Q K_j^T is issued, then P_{j-1} V_{j-1}; the softmax
    // of S_j runs while P_{j-1} V_{j-1} holds the tensor cores
    for (int j = 1; j < nt; ++j) {
      const int s = j % P_STAGES, sp = (j - 1) % P_STAGES;
      const int k0 = (kr.j0 + j) * pg::TK;
      hp::mbar_wait(&k_full[s], (j / P_STAGES) & 1);
      hp::wgmma_fence();
      hp::issue_abt<D, 64>(sc, Qs, PQ, KVs + s * 2 * P::TILE);
      hp::wgmma_commit();
      rescale<D>(oacc, alpha);
      issue_pv<D>(oacc, pa, KVs + sp * 2 * P::TILE + P::TILE, &v_full[sp],
                  ((j - 1) / P_STAGES) & 1, k0 - pg::TK, kr.k_begin,
                  kr.k_end, tid);
      hp::wgmma_wait<1>();            // S_j is done (groups end in order)
      hp::fence_regs(sc);
      __syncwarp();
      if (lane == 0) hp::mbar_arrive(&k_empty[s]);
      prefill_softmax<ALIBI>(sc, m, l, alpha, masked(k0), k0, qpos0, t,
                             kr.k_end, a.window, a.scale_log2, slope_log2);
      hp::wgmma_wait<0>();            // P_{j-1} V_{j-1} is done
      hp::fence_regs(oacc);
      __syncwarp();
      if (lane == 0) hp::mbar_arrive(&v_empty[sp]);
      hp::pack_frags(pa, sc);
    }
    const int sp = (nt - 1) % P_STAGES;
    rescale<D>(oacc, alpha);
    issue_pv<D>(oacc, pa, KVs + sp * 2 * P::TILE + P::TILE, &v_full[sp],
                ((nt - 1) / P_STAGES) & 1, (kr.j1 - 1) * pg::TK,
                kr.k_begin, kr.k_end, tid);
    hp::wgmma_wait<0>();
    hp::fence_regs(oacc);
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
  }
  const int row0 = qt * PQ + r0;
  if (a.splits == 1) {
    store_rows<D>(o, oacc, l, row0, t, a.C, a.NH, h);
    return;
  }

  // split partial: thread-major float4s, so the merging CTA's thread tid
  // reads back exactly what thread tid of each split held
  const int unit = qt * a.NH + h;
  float4* part = reinterpret_cast<float4*>(ws) +
                 ((long)unit * a.splits + split) * (P::PART / 4);
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
    part[i * 128 + tid] = make_float4(oacc[4 * i], oacc[4 * i + 1],
                                      oacc[4 * i + 2], oacc[4 * i + 3]);
  part[(D / 8) * 128 + tid] = make_float4(m[0], m[1], l[0], l[1]);
  __threadfence();
  hp::named_sync(1, 128);
  if (tid == 0) last = atomicAdd(tickets + unit, 1) == a.splits - 1;
  hp::named_sync(1, 128);
  if (!last) return;
  __threadfence();

  // the last CTA of the tile: merge splits 0 .. splits-1 in order
  const float4* base = reinterpret_cast<const float4*>(ws) +
                       (long)unit * a.splits * (P::PART / 4);
  float M[2] = {-INFINITY, -INFINITY};
  for (int sp = 0; sp < a.splits; ++sp) {
    const float4 ml = sp == split
                          ? make_float4(m[0], m[1], l[0], l[1])
                          : __ldcg(base + (long)sp * (P::PART / 4) +
                                   (D / 8) * 128 + tid);
    M[0] = fmaxf(M[0], ml.x);
    M[1] = fmaxf(M[1], ml.y);
  }
  float O[D / 2], L[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < D / 2; ++i) O[i] = 0.f;
  for (int sp = 0; sp < a.splits; ++sp) {
    const float4* ps = base + (long)sp * (P::PART / 4);
    const float4 ml = sp == split ? make_float4(m[0], m[1], l[0], l[1])
                                  : __ldcg(ps + (D / 8) * 128 + tid);
    // a split that saw no key of a row adds nothing to it
    const float f0 = ml.x == -INFINITY ? 0.f : hp::ex2(ml.x - M[0]);
    const float f1 = ml.y == -INFINITY ? 0.f : hp::ex2(ml.y - M[1]);
    L[0] += ml.z * f0;
    L[1] += ml.w * f1;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      const float4 v = sp == split
                           ? make_float4(oacc[4 * i], oacc[4 * i + 1],
                                         oacc[4 * i + 2], oacc[4 * i + 3])
                           : __ldcg(ps + i * 128 + tid);
      O[4 * i] += v.x * f0;
      O[4 * i + 1] += v.y * f0;
      O[4 * i + 2] += v.z * f1;
      O[4 * i + 3] += v.w * f1;
    }
  }
  store_rows<D>(o, O, L, row0, t, a.C, a.NH, h);
  if (tid == 0) tickets[unit] = 0;   // zeroed for the next call
}

template <int D, bool ALIBI>
int launch_wgmma(const void* q, const void* ak, const void* av,
                 const void* table, void* o, void* ws, void* tickets, int C,
                 int NH, int NKV, int L, int nb, int bs, int MB, int layer,
                 int pos0, int n_valid, int window, int splits,
                 const float* slopes, cudaStream_t stream) {
  using T = hp::RowTile<D>;
  using P = PrefillTile<D>;
  const int q_tiles = (C + PQ - 1) / PQ;
  if (!pg::tma_block_size(bs) || splits < 1 || q_tiles > 65535 ||
      splits > 65535 || (long)L * nb >= (1L << 31) ||
      (splits > 1 && (ws == nullptr || tickets == nullptr)))
    return (int)cudaErrorInvalidValue;
  CUtensorMap qmap, kmap, vmap;
  const uint64_t qd[4] = {D, (uint64_t)NH, (uint64_t)C, 1};
  const uint64_t qs[3] = {D * 2, (uint64_t)NH * D * 2,
                          (uint64_t)C * NH * D * 2};
  const uint32_t qbox[4] = {T::CH, 1, PQ, 1};
  int rc = hp::make_map_bf16(&qmap, q, 4, qd, qs, qbox, T::SW);
  if (!rc) rc = pg::arena_map<D>(&kmap, ak, L, nb, bs, NKV);
  if (!rc) rc = pg::arena_map<D>(&vmap, av, L, nb, bs, NKV);
  if (rc) return rc;
  cudaError_t err = cudaFuncSetAttribute(
      paged_prefill_wgmma<D, ALIBI>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, P::SMEM);
  if (err != cudaSuccess) return (int)err;
  PrefillArgs args{C,      NH,     NKV,
                   nb,     bs,     MB,
                   layer * nb,     pos0,
                   n_valid, window, splits,
                   1.4426950408889634f / sqrtf((float)D), slopes};
  paged_prefill_wgmma<D, ALIBI><<<dim3(NH, q_tiles, splits), P_THREADS,
                                  P::SMEM, stream>>>(
      qmap, kmap, vmap, static_cast<const int*>(table),
      static_cast<bf16*>(o), static_cast<float*>(ws),
      static_cast<int*>(tickets), args);
  return (int)cudaGetLastError();
}

template <int D>
int launch_wgmma_any(const void* q, const void* ak, const void* av,
                     const void* table, void* o, void* ws, void* tickets,
                     int C, int NH, int NKV, int L, int nb, int bs, int MB,
                     int layer, int pos0, int n_valid, int window,
                     int splits, const void* slopes, cudaStream_t stream) {
  const float* sl = static_cast<const float*>(slopes);
  if (sl)
    return launch_wgmma<D, true>(q, ak, av, table, o, ws, tickets, C, NH,
                                 NKV, L, nb, bs, MB, layer, pos0, n_valid,
                                 window, splits, sl, stream);
  return launch_wgmma<D, false>(q, ak, av, table, o, ws, tickets, C, NH, NKV,
                                L, nb, bs, MB, layer, pos0, n_valid, window,
                                splits, sl, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; window <= 0 means no sliding window;
// slopes: [NH] f32 ALiBi slopes or null.  Returns cudaGetLastError()
// after the launch.
extern "C" int dstt_paged_prefill(const void* q, const void* ak,
                                  const void* av, const void* table, void* o,
                                  int C, int NH, int NKV, int D, int nb,
                                  int bs, int MB, long long layer_off,
                                  int pos0, int n_valid, int window,
                                  const void* slopes, int dtype,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (C <= 0 || NKV <= 0 || NH % NKV != 0 || nb <= 0 || bs <= 0 || MB <= 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == 1) {
    if (D == 32)
      return launch_any<__nv_bfloat16, 32>(q, ak, av, table, o, C, NH, NKV, nb,
                                       bs, MB, layer_off, pos0, n_valid,
                                       window, slopes, st);
    if (D == 64)
      return launch_any<__nv_bfloat16, 64>(q, ak, av, table, o, C, NH, NKV, nb,
                                       bs, MB, layer_off, pos0, n_valid,
                                       window, slopes, st);
    if (D == 80)
      return launch_any<__nv_bfloat16, 80>(q, ak, av, table, o, C, NH, NKV, nb,
                                           bs, MB, layer_off, pos0, n_valid,
                                           window, slopes, st);
    if (D == 96)
      return launch_any<__nv_bfloat16, 96>(q, ak, av, table, o, C, NH, NKV, nb,
                                           bs, MB, layer_off, pos0, n_valid,
                                           window, slopes, st);
    if (D == 128)
      return launch_any<__nv_bfloat16, 128>(q, ak, av, table, o, C, NH, NKV, nb,
                                        bs, MB, layer_off, pos0, n_valid,
                                        window, slopes, st);
  } else if (dtype == 0) {
    if (D == 32)
      return launch_any<float, 32>(q, ak, av, table, o, C, NH, NKV, nb, bs, MB,
                               layer_off, pos0, n_valid, window, slopes, st);
    if (D == 64)
      return launch_any<float, 64>(q, ak, av, table, o, C, NH, NKV, nb, bs, MB,
                               layer_off, pos0, n_valid, window, slopes, st);
    if (D == 80)
      return launch_any<float, 80>(q, ak, av, table, o, C, NH, NKV, nb, bs, MB,
                                   layer_off, pos0, n_valid, window, slopes,
                                   st);
    if (D == 96)
      return launch_any<float, 96>(q, ak, av, table, o, C, NH, NKV, nb, bs, MB,
                                   layer_off, pos0, n_valid, window, slopes,
                                   st);
    if (D == 128)
      return launch_any<float, 128>(q, ak, av, table, o, C, NH, NKV, nb, bs, MB,
                                layer_off, pos0, n_valid, window, slopes, st);
  }
  return (int)cudaErrorInvalidValue;
}

// The TMA + wgmma kernel (bf16; see the note at the top): arena k/v
// [L, nb, bs, NKV, D] read at `layer`; with splits > 1, ws holds
// q_tiles * NH * splits partial states of 128 * (D / 2 + 4) floats and
// tickets one zeroed int per (q tile, head) (left zeroed).  Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for what the
// kernel does not take).
extern "C" int dstt_paged_prefill_tma(const void* q, const void* ak,
                                      const void* av, const void* table,
                                      void* o, void* ws, void* tickets,
                                      int C, int NH, int NKV, int D, int L,
                                      int nb, int bs, int MB, int layer,
                                      int pos0, int n_valid, int window,
                                      int splits, const void* slopes,
                                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (C <= 0 || NKV <= 0 || NH % NKV != 0 || nb <= 0 || bs <= 0 ||
      MB <= 0 || L <= 0 || layer < 0 || layer >= L)
    return (int)cudaErrorInvalidValue;
  if (D == 32)
    return launch_wgmma_any<32>(q, ak, av, table, o, ws, tickets, C, NH, NKV, L,
                            nb, bs, MB, layer, pos0, n_valid, window, splits,
                            slopes, st);
  if (D == 64)
    return launch_wgmma_any<64>(q, ak, av, table, o, ws, tickets, C, NH, NKV, L,
                            nb, bs, MB, layer, pos0, n_valid, window, splits,
                            slopes, st);
  if (D == 80)
    return launch_wgmma_any<80>(q, ak, av, table, o, ws, tickets, C, NH, NKV,
                                L, nb, bs, MB, layer, pos0, n_valid, window,
                                splits, slopes, st);
  if (D == 96)
    return launch_wgmma_any<96>(q, ak, av, table, o, ws, tickets, C, NH, NKV,
                                L, nb, bs, MB, layer, pos0, n_valid, window,
                                splits, slopes, st);
  if (D == 128)
    return launch_wgmma_any<128>(q, ak, av, table, o, ws, tickets, C, NH, NKV,
                             L, nb, bs, MB, layer, pos0, n_valid, window,
                             splits, slopes, st);
  return (int)cudaErrorInvalidValue;
}
