// Paged decode attention for Hopper (sm_90a): one query token per sequence
// over its KV blocks in the shared arena.
//
// Replaces the TPU kernel deepspeed_tpu/ops/paged_attention.py
// `paged_decode_attention` (pallas_call body `_kernel`): block table read
// per key block, table entries clamped to [0, nb-1], keys past lens[b]
// masked, lens[b] < 0 rows give zeros, GQA served per kv head (the G
// grouped q heads share one pass over the kv head's keys), f32 online
// softmax.  Beyond the TPU kernel (whose callers send these models to a
// dense gather in XLA), each kernel also takes:
//   * a sliding window w > 0: keys at or before lens[b] - w are masked,
//     and the key walk starts at the tile of key lens[b] + 1 - w, so a row
//     past its window reads about w keys, not lens[b] + 1;
//   * ALiBi slopes [NH] f32: score qk/sqrt(D) - slope[h] (lens[b] - k);
//   * any group G: a group above MAXG (8) q heads is cut into passes of 8
//     heads over the same kv head (the last one shorter), each pass a
//     work unit of its own (Falcon-7B: 71 heads, 9 passes of its one kv
//     head, whose tiles the passes read from L2 after the first);
// the window and the bias are template flags (WIN, ALIBI), so a call
// without them runs the code it ran before they existed.
//
// Layout: q [B, NH, D]; arena k/v [L, nb, bs, NKV, D] (the merged
// [L, nb, bs, NKV * D] is the same bytes) read at one layer — no layer
// slice is ever copied; tables [B, MB] int32; lens [B] int32; out
// [B, NH, D].
//
// What bounds it on the H100: bytes.  Every live key row of K and V is
// read once per (sequence, kv head) and each row does 4*G*D FLOPs, far
// below the ~295 FLOP/byte ridge, so the card is only fast when enough
// bytes are in flight: some 3.35 TB/s x ~1 us of latency, 24 KB or more
// on each SM.  The TPU kernel walks one sequence's blocks in order on one
// core; here one sequence's keys are split over CTAs (split-KV, as in
// flash-decoding).  `ops/paged_attention.py:decode_variant` names the
// kernels a call takes:
//
// paged_decode_tma ("tma": bf16, D 32/64/80/96/128, a block size TMA can
// tile, see paged_tile.cuh; B <= 4096): one wave of resident CTAs (as many as
// fit on every SM) walks a work list that each CTA builds alike from
// lens: the key tiles (64 keys, whole pages at bs <= 64) of every
// (sequence, work unit: a kv head, or one pass of a group above 8), from
// the window's first tile, in that order, T of them, CTA c taking positions
// [c T / N, (c + 1) T / N), so every CTA carries the same number of tiles
// within one, whatever the sequences' lengths, no CTA is launched past a
// sequence's end, and a long sequence spreads over as many CTAs as its
// tiles need.  A producer warp reads the table (a window of 32 page
// entries in its lanes, one read for many tiles), clamps each entry and
// loads the K and V tiles of one kv head by TMA (one [bs, D] box a page,
// row pitch NKV*D) into a ring of 3 slots (16 KB a slot at D 128), so
// with four CTAs an SM (12 slots) some 190 KB are in flight; more CTAs
// an SM with fewer slots each read faster than fewer CTAs with deeper
// rings, as the CTAs' starts and merges then overlap more.  The consumer warps
// compute from shared memory: a thread per key takes its dot with each
// of the G queries (f32, q scaled by log2(e)/sqrt(D) once); a warp per
// query head takes the tile's max, the base-2 exponents and their sum;
// then each thread adds P V for one 16-byte column chunk over its keys
// (keys past lens are skipped, so garbage there never enters a sum).  The
// warps' sums meet in shared memory in a fixed order.  A head whose tiles
// lie in one CTA's range is written, normalised, by that CTA; otherwise
// each of the CTAs that share it writes its unnormalised (acc, m, l) to a
// workspace and takes an integer ticket of the (sequence, kv head), and
// the CTA that takes the last one merges them in CTA order and resets
// the ticket: one launch, no float atomics, a rerun bit for bit the same
// (the grid is fixed for a card and a group size).  At D 80 and 96 a row
// is 10 or 12 chunks: the P V pass gives a key group 16 threads (a power
// of two, for the shuffles that sum the groups), 6 or 4 of them idle.
//
// paged_decode_kernel + paged_decode_combine_kernel ("mma": other bf16
// block sizes; "f32"), a split-KV pass and a merge:
//   1. paged_decode_kernel, grid (NKV * passes, B, splits): the CTA of
//      split s takes keys [s*KS, (s+1)*KS) from the window's first key of
//      one (work unit, sequence) — a CTA past the sequence's end returns at
//      once.  Its 8 warps take keys w*4, w*4+1,
//      ... in runs of 4 and issue the 4 rows' K and V loads (one vector
//      load per lane per row) before any arithmetic, so their latencies
//      overlap; lane i holds D/32 (at D 80 and 96: 4, on the first D/4
//      lanes) contiguous elements of q, k, v and of
//      the f32 accumulators for each of the pass's <= 8 heads; the per-key dot
//      is a 5-step xor-shuffle sum; the warps' (m, l, acc) states merge
//      through shared memory into the split's partial state, written
//      unnormalized to the f32 scratch `part` [B, NH, splits, D + 2].
//   2. paged_decode_combine_kernel, grid (NH, B): merges the live splits'
//      partial states and writes the normalized output row.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

#include "paged_tile.cuh"

namespace {

constexpr int NW = 8;      // warps per CTA
constexpr int KB = 4;      // keys per warp per iteration
constexpr int MAXG = 8;    // q heads a pass (work unit) serves
constexpr int KS = 256;    // keys per split
constexpr float LOG2E = 1.4426950408889634f;

// The q heads of a pass and the passes of a group of G: one pass of G up
// to MAXG, else passes of MAXG (ops/paged_attention.py:group_passes).
__host__ __device__ __forceinline__ int pass_heads(int G) {
  return G < MAXG ? G : MAXG;
}
__host__ __device__ __forceinline__ int group_passes(int G) {
  return (G + pass_heads(G) - 1) / pass_heads(G);
}

// The first key a row at position `len` reads under a window w > 0: the
// keys at or before len - w are masked.
__device__ __forceinline__ int window_lo(int len, int window) {
  return max(0, len + 1 - window);
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// PER contiguous elements of T in one aligned vector load, as f32.
template <typename T, int PER>
struct alignas(PER * sizeof(T)) Pack {
  T v[PER];
};
template <typename T, int PER>
__device__ __forceinline__ void load_f(const T* src, float* dst) {
  const Pack<T, PER> p = *reinterpret_cast<const Pack<T, PER>*>(src);
#pragma unroll
  for (int e = 0; e < PER; ++e) dst[e] = to_f(p.v[e]);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// grid (NKV * passes, B, splits): blockIdx.x is the work unit, pass
// blockIdx.x % passes of kv head blockIdx.x / passes; with WIN the splits
// cover [window_lo, n_keys), with ALIBI each score takes its bias.
template <typename T, int D, bool WIN, bool ALIBI>
__global__ void __launch_bounds__(NW * 32)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ ak,
                    const T* __restrict__ av, const int* __restrict__ tables,
                    const int* __restrict__ lens, float* __restrict__ part,
                    int NH, int NKV, int nb, int bs, int MB, int splits,
                    long layer_off, float sm_scale, int window,
                    const float* __restrict__ slopes) {
  // a lane's contiguous elements: D / 32 (one aligned vector load), or 4
  // at D 80 and 96, whose rows then span the first D / 4 lanes (the other
  // lanes hold zeros)
  constexpr int PER = D == 32 || D == 64 || D == 128 ? D / 32 : 4;
  constexpr int LANES = D / PER;
  __shared__ float sm_m[NW][MAXG];
  __shared__ float sm_l[NW][MAXG];
  __shared__ float sm_acc[NW][MAXG][D];

  const int GA = NH / NKV;                  // the whole group
  const int HG = pass_heads(GA), GC = group_passes(GA);
  const int kvh = blockIdx.x / GC;
  const int h0 = kvh * GA + (blockIdx.x % GC) * HG;   // the pass's heads
  const int G = min(HG, kvh * GA + GA - h0);
  const int b = blockIdx.y;
  const int split = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const bool cols = LANES == 32 || lane < LANES;   // lane holds columns
  const int len = lens[b];
  const int n_keys = min(len + 1, MB * bs);   // lens < 0: no keys
  int k0 = split * KS;
  if constexpr (WIN) k0 += window_lo(len, window);
  if (k0 >= n_keys) return;   // past the sequence: the combine skips it
  const int k1 = min(k0 + KS, n_keys);

  float qf[MAXG][PER], acc[MAXG][PER], m[MAXG], l[MAXG];
  float slope[MAXG];
  const long q_base = ((long)b * NH + h0) * D + (cols ? lane * PER : 0);
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < PER; ++e) acc[g][e] = 0.f;
    slope[g] = 0.f;
    if (g < G && cols) {
      load_f<T, PER>(q + q_base + (long)g * D, qf[g]);
#pragma unroll
      for (int e = 0; e < PER; ++e) qf[g][e] *= sm_scale;
    } else {
#pragma unroll
      for (int e = 0; e < PER; ++e) qf[g][e] = 0.f;
    }
    if constexpr (ALIBI)
      if (g < G) slope[g] = slopes[h0 + g];
  }

  const long row_stride = (long)NKV * D;
  const long head_off =
      layer_off + (long)kvh * D + (cols ? lane * PER : 0);
  const int* tb = tables + (long)b * MB;
  for (int base = k0 + warp * KB; base < k1; base += NW * KB) {
    float kf[KB][PER], vf[KB][PER];
#pragma unroll
    for (int u = 0; u < KB; ++u) {
      const int kp = base + u;
      if (kp < k1 && cols) {
        int blk = tb[kp / bs];
        blk = min(max(blk, 0), nb - 1);
        const long off = head_off + ((long)blk * bs + kp % bs) * row_stride;
        load_f<T, PER>(ak + off, kf[u]);
        load_f<T, PER>(av + off, vf[u]);
      } else {
#pragma unroll
        for (int e = 0; e < PER; ++e) { kf[u][e] = 0.f; vf[u][e] = 0.f; }
      }
    }
#pragma unroll
    for (int u = 0; u < KB; ++u) {
      if (base + u >= k1) break;   // uniform across the warp
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        if (g >= G) break;
        float s = 0.f;
#pragma unroll
        for (int e = 0; e < PER; ++e) s += qf[g][e] * kf[u][e];
        s = warp_sum(s);
        if constexpr (ALIBI) s -= slope[g] * (float)(len - (base + u));
        const float m_new = fmaxf(m[g], s);
        const float alpha = expf(m[g] - m_new);   // exp(-inf) = 0 at start
        const float pr = expf(s - m_new);
        l[g] = l[g] * alpha + pr;
#pragma unroll
        for (int e = 0; e < PER; ++e)
          acc[g][e] = acc[g][e] * alpha + pr * vf[u][e];
        m[g] = m_new;
      }
    }
  }

#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    if (g >= G) break;
    if (lane == 0) {
      sm_m[warp][g] = m[g];
      sm_l[warp][g] = l[g];
    }
    if (cols)
#pragma unroll
      for (int e = 0; e < PER; ++e)
        sm_acc[warp][g][lane * PER + e] = acc[g][e];
  }
  __syncthreads();
  // the split's partial state, unnormalized: acc[0:D], then m, l
  for (int i = threadIdx.x; i < G * D; i += NW * 32) {
    const int g = i / D;
    const int d = i % D;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < NW; ++w) M = fmaxf(M, sm_m[w][g]);
    float L = 0.f, O = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float mw = sm_m[w][g];
      if (mw == -INFINITY) continue;   // warp saw no key
      const float sc = expf(mw - M);
      L += sm_l[w][g] * sc;
      O += sm_acc[w][g][d] * sc;
    }
    float* pr = part + (((long)b * NH + h0 + g) * splits + split) * (D + 2);
    pr[d] = O;
    if (d == 0) {
      pr[D] = M;
      pr[D + 1] = L;
    }
  }
}

template <typename T, int D, bool WIN>
__global__ void __launch_bounds__(D)
paged_decode_combine_kernel(const float* __restrict__ part,
                            const int* __restrict__ lens, T* __restrict__ o,
                            int NH, int MB, int bs, int splits, int window) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int d = threadIdx.x;
  int n_keys = min(lens[b] + 1, MB * bs);
  if constexpr (WIN) n_keys -= window_lo(lens[b], window);
  const int live = n_keys > 0 ? (n_keys + KS - 1) / KS : 0;
  const float* pr = part + ((long)b * NH + h) * splits * (D + 2);
  float M = -INFINITY;
  for (int s = 0; s < live; ++s) M = fmaxf(M, pr[s * (D + 2) + D]);
  float L = 0.f, O = 0.f;
  for (int s = 0; s < live; ++s) {
    const float* ps = pr + s * (D + 2);
    const float sc = expf(ps[D] - M);
    L += ps[D + 1] * sc;
    O += ps[d] * sc;
  }
  // lens < 0 (inactive row): no live split, L = 0 -> zeros
  o[((long)b * NH + h) * D + d] = from_f<T>(L > 0.f ? O / L : 0.f);
}

template <typename T, int D, bool WIN, bool ALIBI>
int launch(const void* q, const void* ak, const void* av, const void* tables,
           const void* lens, void* part, void* o, int B, int NH, int NKV,
           int nb, int bs, int MB, long long layer_off, int window,
           const float* slopes, cudaStream_t stream) {
  const int splits = (MB * bs + KS - 1) / KS;
  const int units = NKV * group_passes(NH / NKV);
  paged_decode_kernel<T, D, WIN, ALIBI>
      <<<dim3(units, B, splits), NW * 32, 0, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(ak),
          static_cast<const T*>(av), static_cast<const int*>(tables),
          static_cast<const int*>(lens), static_cast<float*>(part), NH, NKV,
          nb, bs, MB, splits, (long)layer_off, 1.0f / sqrtf((float)D),
          window, slopes);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  paged_decode_combine_kernel<T, D, WIN><<<dim3(NH, B), D, 0, stream>>>(
      static_cast<const float*>(part), static_cast<const int*>(lens),
      static_cast<T*>(o), NH, MB, bs, splits, window);
  return (int)cudaGetLastError();
}

// f(WIN, ALIBI) for the flags of a call: a window > 0, slopes given.
template <typename F>
int by_flags(int window, const void* slopes, F&& f) {
  using yes = std::true_type;
  using no = std::false_type;
  if (window > 0)
    return slopes ? f(yes(), yes()) : f(yes(), no());
  return slopes ? f(no(), yes()) : f(no(), no());
}

template <typename T, int D>
int launch_any(const void* q, const void* ak, const void* av,
               const void* tables, const void* lens, void* part, void* o,
               int B, int NH, int NKV, int nb, int bs, int MB,
               long long layer_off, int window, const void* slopes,
               cudaStream_t stream) {
  return by_flags(window, slopes, [&](auto win, auto alibi) {
    return launch<T, D, decltype(win)::value, decltype(alibi)::value>(
        q, ak, av, tables, lens, part, o, B, NH, NKV, nb, bs, MB, layer_off,
        window, static_cast<const float*>(slopes), stream);
  });
}

// ---------------------------------------------------------------------
// bf16: TMA ring, one launch (paged_decode_tma)
namespace hp = dstt::hopper;
namespace pg = dstt::paged;
using bf16 = __nv_bfloat16;

constexpr int D_SLOTS = 3;            // ring slots, a K or a V tile each
constexpr int D_THREADS = 128 + 32;   // four consumer warps + producer warp

template <int D>
struct DecodeTile {
  static constexpr int TILE = pg::TK * D * 2;
  static constexpr int RING = D_SLOTS * TILE;
  static constexpr int NDC = D / 8;        // 16-byte chunks a row
  // the P V pass's threads a key group: NDC rounded up to a power of two
  // (16 at D 80 and 96, whose last 6 or 4 threads a group idle there)
  static constexpr int NDCP = NDC <= 4 ? 4 : NDC <= 8 ? 8 : 16;
  static constexpr int KG = 128 / NDCP;    // key groups of the P V pass
  // q of one head, f32: two halves of D / 2 + 4 floats (the pad puts the
  // halves' chunks, read at once by a key's two threads, on other banks)
  static constexpr int QROW = D + 8;
  // shared memory after the ring, floats: q [G][QROW], scores and
  // probabilities [G][64] each, the warps' sums [4][G][D]; then the work
  // list's prefix sums, B + 1 ints
  static constexpr int smem(int G, int B) {
    return 1024 + RING + (G * QROW + 2 * G * pg::TK + 4 * G * D) * 4 +
           ((B + 1) * 4 + 15) / 16 * 16;
  }
};

struct DecodeArgs {
  int B, NH, NKV, nb, bs, MB, page0, segs;
  float scale_log2;
  // work units a sequence (NKV * passes), q heads a pass, the window
  // (WIN builds), the slopes (ALIBI builds)
  int NU, HG, window;
  const float* slopes;
};

// The first key tile a sequence at position `len` reads: the window's.
template <bool WIN>
__device__ __forceinline__ int first_tile(int len, const DecodeArgs& a) {
  if constexpr (WIN) return window_lo(len, a.window) / pg::TK;
  return 0;
}

// Key tiles of a sequence at position `len` (0 for an inactive row), from
// its first tile.
template <bool WIN>
__device__ __forceinline__ int seq_tiles(int len, const DecodeArgs& a) {
  const int n_keys = min(len + 1, a.MB * a.bs);
  if (n_keys <= 0) return 0;
  const int n = (n_keys + pg::TK - 1) / pg::TK;
  if constexpr (WIN) return max(0, n - first_tile<WIN>(len, a));
  return n;
}

// The work list: position p of T = sum_b NU * tiles_b runs over
// sequences, then work units (kv heads, each in its passes), then key
// tiles; CTA c of N walks positions [c T / N, (c + 1) T / N), so every
// CTA carries the same number of tiles within one.  chunk_of(p) is the
// CTA whose range holds p.
__device__ __forceinline__ int chunk_of(int p, int T, int N) {
  return (int)(((long)p * N + N - 1) / T);
}

// The run of a CTA's range [p, p1) inside one (sequence, work unit): its
// tiles [t0, t1) of the unit's n (counted from the sequence's first
// tile), its index among the CTAs that share the unit's tiles and their
// count, and the position after it.
struct Segment {
  int b, unit, t0, t1, index, count, next;
};

__device__ __forceinline__ Segment segment_at(int p, int p1, const int* pre,
                                              int B, int NU, int T, int N,
                                              int c) {
  int lo = 0, hi = B;   // pre[lo] <= p < pre[hi]
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (pre[mid] <= p) lo = mid; else hi = mid;
  }
  const int n = (pre[lo + 1] - pre[lo]) / NU;
  const int r = p - pre[lo];
  const int start = pre[lo] + (r / n) * n, stop = start + n;
  const int next = min(p1, stop);
  const int first = chunk_of(start, T, N);
  return Segment{lo, r / n, r % n, r % n + (next - p), c - first,
                 chunk_of(stop - 1, T, N) - first + 1, next};
}

// GM: a bound on the heads of a pass (1, 2, 4 or 8), so the accumulators
// of a small group take few registers (four CTAs an SM up to GM 2).  WIN:
// the walk starts at the window's tile and masks below its first key;
// ALIBI: each score takes -slope (len - k) (log2 units, as the scores);
// SPLIT: a group above MAXG, in passes (work units) of MAXG heads.  With
// all three off, the kernel is the one without them.
template <int D, int GM, bool WIN, bool ALIBI, bool SPLIT>
__global__ void __launch_bounds__(D_THREADS, GM <= 2 ? 4 : 2)
paged_decode_tma(const __grid_constant__ CUtensorMap kmap,
                 const __grid_constant__ CUtensorMap vmap,
                 const bf16* __restrict__ q, const int* __restrict__ tables,
                 const int* __restrict__ lens, bf16* __restrict__ o,
                 float* __restrict__ ws, int* __restrict__ tickets,
                 DecodeArgs a) {
  using DT = DecodeTile<D>;
  constexpr int TK = pg::TK, NDC = DT::NDC, NDCP = DT::NDCP, KG = DT::KG;
  const int GA = a.NH / a.NKV;                // a kv head's whole group
  const int GC = SPLIT ? a.NU / a.NKV : 1;    // its passes
  const int HG = SPLIT ? a.HG : GA;           // heads a pass (last: fewer)
  const int NU = SPLIT ? a.NU : a.NKV;        // work units a sequence
  extern __shared__ __align__(1024) uint8_t smem_tma[];
  uint8_t* ring = hp::align1024(smem_tma);
  float* sq = reinterpret_cast<float*>(ring + DT::RING);   // [HG][QROW]
  float* ss = sq + HG * DT::QROW;                           // [HG][TK]
  float* sp = ss + HG * TK;                                 // [HG][TK]
  float* red = sp + HG * TK;                                // [4][HG][D]
  int* pre = reinterpret_cast<int*>(red + 4 * HG * D);      // [B + 1]
  __shared__ __align__(8) uint64_t full[D_SLOTS], empty[D_SLOTS];
  __shared__ float s_alpha[MAXG], s_m[MAXG], s_l[MAXG];
  __shared__ int last;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;

  // the work list, the same in every CTA: pre[b] = positions before
  // sequence b (its NKV heads' tiles), by warp 0's running scan
  if (warp == 0) {
    int carry = 0;
    if (lane == 0) pre[0] = 0;
    for (int b0 = 0; b0 < a.B; b0 += 32) {
      const int b = b0 + lane;
      int x = b < a.B ? seq_tiles<WIN>(__ldg(lens + b), a) * NU : 0;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, x, off);
        if (lane >= off) x += y;
      }
      if (b < a.B) pre[b + 1] = carry + x;
      carry += __shfl_sync(0xffffffffu, x, 31);
    }
  }
  // inactive rows (lens < 0): zeros, each row by one CTA
  for (int b = blockIdx.x; b < a.B; b += gridDim.x)
    if (seq_tiles<WIN>(__ldg(lens + b), a) == 0)
      for (int i = tid; i < a.NH * D; i += D_THREADS)
        o[(long)b * a.NH * D + i] = __float2bfloat16(0.f);
  if (tid == 0) {
    for (int s = 0; s < D_SLOTS; ++s) {
      hp::mbar_init(&full[s], 1);
      hp::mbar_init(&empty[s], 4);   // one arrival a consumer warp
    }
    hp::mbar_fence_init();
  }
  __syncthreads();
  // N <= T CTAs share the positions, so every CTA's range holds one or
  // more and a head's tiles are shared by consecutive CTAs
  const int T = pre[a.B], N = min((int)gridDim.x, T), cta = blockIdx.x;
  const int p0 = cta < N ? (int)((long)cta * T / N) : 0;
  const int p1 = cta < N ? (int)((long)(cta + 1) * T / N) : 0;
  const int rows = a.bs < TK ? a.bs : TK;

  if (warp == 4) {   // the producer warp: K_j, V_j, K_j+1, ... in turn
    int e = 0;       // ring entries issued
    for (int pos = p0; pos < p1;) {
      const Segment sg = segment_at(pos, p1, pre, a.B, NU, T, N, cta);
      const int t_first = first_tile<WIN>(__ldg(lens + sg.b), a);
      pg::BoxPages pages{tables + (long)sg.b * a.MB, a.MB, a.nb, a.bs, rows,
                         (t_first + sg.t0) * TK};
      for (int j = 0; j < sg.t1 - sg.t0; ++j) {
        for (int kv = 0; kv < 2; ++kv, ++e) {
          const int s = e % D_SLOTS;
          hp::mbar_wait(&empty[s], ((e / D_SLOTS) & 1) ^ 1);
          if (lane == 0) hp::mbar_expect_tx(&full[s], DT::TILE);
          pg::load_tile<D>(ring + s * DT::TILE, kv ? &vmap : &kmap, &full[s],
                           pages, j * (TK / rows), a.page0, sg.unit / GC,
                           lane);
        }
      }
      pos = sg.next;
    }
    return;
  }

  const int dc = tid % NDCP, kg = tid / NDCP;   // the P V pass's chunk, keys
  int e = 0;                                  // ring entries consumed
  for (int pos = p0; pos < p1;) {
    const Segment sg = segment_at(pos, p1, pre, a.B, NU, T, N, cta);
    pos = sg.next;
    const int len = __ldg(lens + sg.b);
    const int n_keys = min(len + 1, a.MB * a.bs);
    const int k_lo = WIN ? window_lo(len, a.window) : 0;
    const int t0 = first_tile<WIN>(len, a) + sg.t0, nt = sg.t1 - sg.t0;
    // the pass's heads: HG of the kv head's group from the pass's first
    const int h0 = (sg.unit / GC) * GA + (sg.unit % GC) * HG;
    const int G = SPLIT ? min(HG, (sg.unit / GC) * GA + GA - h0) : GA;
    const long row = (long)sg.b * a.NH + h0;                 // first head
    for (int x = tid; x < G * D; x += 128) {
      const int g = x / D, d = x % D;
      sq[g * DT::QROW + d + (d >= D / 2 ? 4 : 0)] =
          __bfloat162float(q[row * D + x]) * a.scale_log2;
    }
    float slope[GM];   // log2 units
#pragma unroll
    for (int g = 0; g < GM; ++g)
      slope[g] = ALIBI && g < G ? __ldg(a.slopes + h0 + g) * LOG2E : 0.f;
    float m_r[2] = {-INFINITY, -INFINITY};   // heads warp and warp + 4
    float l_r[2] = {0.f, 0.f};
    float acc[GM][8];
#pragma unroll
    for (int g = 0; g < GM; ++g)
#pragma unroll
      for (int u = 0; u < 8; ++u) acc[g][u] = 0.f;
    hp::named_sync(1, 128);

    for (int j = 0; j < nt; ++j, e += 2) {
      const int k0 = (t0 + j) * TK;
      const int sk = e % D_SLOTS, sv = (e + 1) % D_SLOTS;
      // scores: two threads a key, half of D each, all G heads (q
      // broadcast from shared memory); the second half walks its chunks
      // from the middle at D 128, so a key's two threads read other banks
      hp::mbar_wait(&full[sk], (e / D_SLOTS) & 1);
      {
        const uint8_t* Ks = ring + sk * DT::TILE;
        const int key = tid >> 1, half = tid & 1;
        float sc[GM];
#pragma unroll
        for (int g = 0; g < GM; ++g) sc[g] = 0.f;
#pragma unroll 4
        for (int j = 0; j < NDC / 2; ++j) {
          const int cj = half ? (j ^ (D == 128 ? 4 : 0)) : j;
          const uint4 raw = *pg::tile_chunk<D>(Ks, key, half * NDC / 2 + cj);
          const __nv_bfloat162* kp2 =
              reinterpret_cast<const __nv_bfloat162*>(&raw);
          float kf[8];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const float2 f = __bfloat1622float2(kp2[u]);
            kf[2 * u] = f.x;
            kf[2 * u + 1] = f.y;
          }
#pragma unroll
          for (int g = 0; g < GM; ++g) {
            if (g >= G) break;
            const float4* qv = reinterpret_cast<const float4*>(
                sq + g * DT::QROW + half * (D / 2 + 4) + cj * 8);
            const float4 x = qv[0], y = qv[1];
            sc[g] += kf[0] * x.x + kf[1] * x.y + kf[2] * x.z + kf[3] * x.w +
                     kf[4] * y.x + kf[5] * y.y + kf[6] * y.z + kf[7] * y.w;
          }
        }
        const bool live_key =
            k0 + key < n_keys && (!WIN || k0 + key >= k_lo);
#pragma unroll
        for (int g = 0; g < GM; ++g) {
          if (g >= G) break;
          // a + b on one lane, b + a on the other: the same float
          float both = sc[g] + __shfl_xor_sync(0xffffffffu, sc[g], 1);
          if constexpr (ALIBI) both -= slope[g] * (float)(len - (k0 + key));
          if (half == 0) ss[g * TK + key] = live_key ? both : -INFINITY;
        }
      }
      __syncwarp();
      if (lane == 0) hp::mbar_arrive(&empty[sk]);
      hp::named_sync(1, 128);
      // softmax: warp w takes heads w and w + 4, two keys a lane
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int g = warp + 4 * hi;
        if (g >= G) break;
        const float s0 = ss[g * TK + lane], s1 = ss[g * TK + lane + 32];
        const float m_new = fmaxf(m_r[hi], pg::warp_max(fmaxf(s0, s1)));
        const float mu = m_new == -INFINITY ? 0.f : m_new;
        const float al = hp::ex2(m_r[hi] - mu);
        const float p0 = hp::ex2(s0 - mu), p1 = hp::ex2(s1 - mu);
        sp[g * TK + lane] = p0;
        sp[g * TK + lane + 32] = p1;
        l_r[hi] = l_r[hi] * al + pg::warp_sum(p0 + p1);
        m_r[hi] = m_new;
        if (lane == 0) s_alpha[g] = al;
      }
      hp::named_sync(1, 128);
      // P V: a thread a 16-byte column chunk over keys kg, kg + KG, ...
      hp::mbar_wait(&full[sv], ((e + 1) / D_SLOTS) & 1);
      const uint8_t* Vs = ring + sv * DT::TILE;
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        if (g >= G) break;
        const float al = s_alpha[g];
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[g][c] *= al;
      }
#pragma unroll 2
      for (int r0 = 0; r0 < TK / KG; ++r0) {
        const int r = kg + KG * r0;
        if (NDCP != NDC && dc >= NDC) break;   // a padding thread
        if (k0 + r >= n_keys) break;   // keys past lens are never read
        if (WIN && k0 + r < k_lo) continue;   // nor keys before the window
        const uint4 raw = *pg::tile_chunk<D>(Vs, r, dc);
        const __nv_bfloat162* vp2 =
            reinterpret_cast<const __nv_bfloat162*>(&raw);
        float vf[8];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float2 f = __bfloat1622float2(vp2[u]);
          vf[2 * u] = f.x;
          vf[2 * u + 1] = f.y;
        }
#pragma unroll
        for (int g = 0; g < GM; ++g) {
          if (g >= G) break;
          const float p = sp[g * TK + r];
#pragma unroll
          for (int c = 0; c < 8; ++c) acc[g][c] += p * vf[c];
        }
      }
      __syncwarp();
      if (lane == 0) hp::mbar_arrive(&empty[sv]);
    }

    // the key groups' sums: first the lanes of a warp that share a chunk,
    // then the four warps in order
#pragma unroll
    for (int off = NDCP; off < 32; off <<= 1)
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        if (g >= G) break;
#pragma unroll
        for (int c = 0; c < 8; ++c)
          acc[g][c] += __shfl_xor_sync(0xffffffffu, acc[g][c], off);
      }
    if (lane == 0)
      for (int hi = 0; hi < 2; ++hi) {
        const int g = warp + 4 * hi;
        if (g < G) {
          s_m[g] = m_r[hi];
          s_l[g] = l_r[hi];
        }
      }
    if (lane < NDC)
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        if (g >= G) break;
#pragma unroll
        for (int c = 0; c < 8; ++c)
          red[(warp * G + g) * D + dc * 8 + c] = acc[g][c];
      }
    hp::named_sync(1, 128);
    auto summed = [&](int g, int d) {
      return red[g * D + d] + red[(G + g) * D + d] +
             red[(2 * G + g) * D + d] + red[(3 * G + g) * D + d];
    };
    if (sg.count == 1) {
      for (int x = tid; x < G * D; x += 128)
        o[row * D + x] = __float2bfloat16(summed(x / D, x % D) / s_l[x / D]);
      hp::named_sync(1, 128);   // red and s_l are read before the next
      continue;
    }
    const long key = (long)sg.b * NU + sg.unit;
    const int PART = HG * (D + 2);   // a segment's acc [G][D], m, l
    float* part = ws + (key * a.segs + sg.index) * PART;
    for (int x = tid; x < G * D; x += 128) {
      const int g = x / D, d = x % D;
      part[g * (D + 2) + d] = summed(g, d);
      if (d == 0) {
        part[g * (D + 2) + D] = s_m[g];
        part[g * (D + 2) + D + 1] = s_l[g];
      }
    }
    __threadfence();
    hp::named_sync(1, 128);
    if (tid == 0) last = atomicAdd(tickets + key, 1) == sg.count - 1;
    hp::named_sync(1, 128);
    if (last) {
      __threadfence();
      // the last CTA of the (sequence, kv head): its segments in order
      const float* base = ws + key * a.segs * PART;
      for (int x = tid; x < G * D; x += 128) {
        const int g = x / D, d = x % D;
        float M = -INFINITY;
        for (int s = 0; s < sg.count; ++s)
          M = fmaxf(M, __ldcg(base + s * PART + g * (D + 2) + D));
        float O = 0.f, L = 0.f;
        for (int s = 0; s < sg.count; ++s) {
          const float* ps = base + s * PART + g * (D + 2);
          const float f = hp::ex2(__ldcg(ps + D) - M);
          L += __ldcg(ps + D + 1) * f;
          O += __ldcg(ps + d) * f;
        }
        o[row * D + x] = __float2bfloat16(O / L);
      }
      if (tid == 0) tickets[key] = 0;   // zeroed for the next call
    }
    hp::named_sync(1, 128);   // `last` is read before the next segment's
  }
}

// The grid: one wave of resident CTAs (as many as fit on every SM at
// this pass size and batch) walks the work list.  The last answer is
// kept (a serving step asks the same for every layer).
template <int D, int GM, bool WIN, bool ALIBI, bool SPLIT>
int resident_ctas(int HG, int B, int* ctas) {
  static int last_dev = -1, last_G = 0, last_B = 0, last_ctas = 0;
  const int smem = DecodeTile<D>::smem(HG, B);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev == last_dev && HG == last_G && B == last_B) {
    *ctas = last_ctas;
    return 0;
  }
  err = cudaFuncSetAttribute(paged_decode_tma<D, GM, WIN, ALIBI, SPLIT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, paged_decode_tma<D, GM, WIN, ALIBI, SPLIT>, D_THREADS, smem);
  if (err != cudaSuccess) return (int)err;
  *ctas = per_sm * sms > 0 ? per_sm * sms : 1;
  last_dev = dev, last_G = HG, last_B = B, last_ctas = *ctas;
  return 0;
}

template <int D, int GM, bool WIN, bool ALIBI, bool SPLIT>
int launch_tma(const void* q, const void* ak, const void* av,
               const void* tables, const void* lens, void* o, void* ws,
               void* tickets, int B, int NH, int NKV, int L, int nb, int bs,
               int MB, int layer, int segs, int window, const float* slopes,
               cudaStream_t stream) {
  const int G = NH / NKV;
  const int NU = NKV * group_passes(G), HG = pass_heads(G);
  if (!pg::tma_block_size(bs) || segs < 1 || B > 4096 ||
      (long)L * nb >= (1L << 31) ||
      (long)segs * pg::TK < (long)MB * bs ||
      (long)B * NU * segs >= (1L << 31) || ws == nullptr ||
      tickets == nullptr)
    return (int)cudaErrorInvalidValue;
  CUtensorMap kmap, vmap;
  int rc = pg::arena_map<D>(&kmap, ak, L, nb, bs, NKV);
  if (!rc) rc = pg::arena_map<D>(&vmap, av, L, nb, bs, NKV);
  if (rc) return rc;
  int ctas = 0;
  rc = resident_ctas<D, GM, WIN, ALIBI, SPLIT>(HG, B, &ctas);
  if (rc) return rc;
  DecodeArgs args{B,  NH, NKV, nb,     bs,    MB, layer * nb, segs,
                  LOG2E / sqrtf((float)D), NU, HG, window, slopes};
  paged_decode_tma<D, GM, WIN, ALIBI, SPLIT>
      <<<ctas, D_THREADS, DecodeTile<D>::smem(HG, B), stream>>>(
          kmap, vmap, static_cast<const bf16*>(q),
          static_cast<const int*>(tables), static_cast<const int*>(lens),
          static_cast<bf16*>(o), static_cast<float*>(ws),
          static_cast<int*>(tickets), args);
  return (int)cudaGetLastError();
}

// f(GM, SPLIT) for a group of G: the least bound GM of 1, 2, 4, 8 that
// holds a pass, and whether G takes more than one pass.
template <typename F>
int by_group(int G, F&& f) {
  using one = std::false_type;
  if (G <= 1) return f(std::integral_constant<int, 1>(), one());
  if (G <= 2) return f(std::integral_constant<int, 2>(), one());
  if (G <= 4) return f(std::integral_constant<int, 4>(), one());
  if (G <= MAXG) return f(std::integral_constant<int, 8>(), one());
  return f(std::integral_constant<int, 8>(), std::true_type());
}

template <int D>
int launch_tma_any(const void* q, const void* ak, const void* av,
                   const void* tables, const void* lens, void* o, void* ws,
                   void* tickets, int B, int NH, int NKV, int L, int nb,
                   int bs, int MB, int layer, int segs, int window,
                   const void* slopes, cudaStream_t stream) {
  return by_group(NH / NKV, [&](auto gm, auto split) {
    return by_flags(window, slopes, [&](auto win, auto alibi) {
      return launch_tma<D, decltype(gm)::value, decltype(win)::value,
                        decltype(alibi)::value, decltype(split)::value>(
          q, ak, av, tables, lens, o, ws, tickets, B, NH, NKV, L, nb, bs, MB,
          layer, segs, window, static_cast<const float*>(slopes), stream);
    });
  });
}

// The grid of the build without a window or a bias (the builds with them
// have the same launch bound and shared memory, so the same grid).
template <int D>
int ctas_any(int G, int B) {
  int ctas = 0;
  const int rc = by_group(G, [&](auto gm, auto split) {
    return resident_ctas<D, decltype(gm)::value, false, false,
                         decltype(split)::value>(pass_heads(G), B, &ctas);
  });
  return rc ? 0 : ctas;
}

}  // namespace

// The head dims this library holds: the build of this source with
// -DDSTT_DECODE_WIDE (library paged_decode_wide) takes D 80 and 96, the
// default build D 32, 64 and 128, so the two halves of the template builds
// compile in parallel (ops/_build.py) and each library refuses the other's.
#ifdef DSTT_DECODE_WIDE
#define DSTT_DECODE_DIMS(X) X(80) X(96)
#else
#define DSTT_DECODE_DIMS(X) X(32) X(64) X(128)
#endif

// Number of key splits of a table of MB blocks of bs keys: the scratch
// `part` holds B * NH * splits * (D + 2) floats.
extern "C" int dstt_paged_decode_splits(int MB, int bs) {
  return (MB * bs + KS - 1) / KS;
}

// dtype: 0 = float32, 1 = bfloat16; window <= 0: no sliding window;
// slopes: [NH] f32 ALiBi slopes or null.  Returns cudaGetLastError()
// after the launches (cudaErrorInvalidValue for an unsupported shape or
// dtype).
extern "C" int dstt_paged_decode(const void* q, const void* ak,
                                 const void* av, const void* tables,
                                 const void* lens, void* part, void* o,
                                 int B, int NH, int NKV, int D, int nb,
                                 int bs, int MB, long long layer_off,
                                 int window, const void* slopes, int dtype,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || NKV <= 0 || NH % NKV != 0 || nb <= 0 || bs <= 0 || MB <= 0)
    return (int)cudaErrorInvalidValue;
#define DSTT_CASE(DD)                                                        \
  if (D == DD) {                                                            \
    if (dtype == 1)                                                         \
      return launch_any<__nv_bfloat16, DD>(q, ak, av, tables, lens, part, o, \
                                           B, NH, NKV, nb, bs, MB,           \
                                           layer_off, window, slopes, st);   \
    if (dtype == 0)                                                         \
      return launch_any<float, DD>(q, ak, av, tables, lens, part, o, B, NH,  \
                                   NKV, nb, bs, MB, layer_off, window,       \
                                   slopes, st);                              \
  }
  DSTT_DECODE_DIMS(DSTT_CASE)
#undef DSTT_CASE
  return (int)cudaErrorInvalidValue;
}

// The TMA kernel (bf16; see the note at the top): arena k/v
// [L, nb, bs, NKV, D] read at `layer`; with U = NKV * passes work units a
// sequence and HG q heads a pass (ops/paged_attention.py:group_passes), ws
// holds B * U * segs * HG * (D + 2) floats with segs * 64 >= MB * bs (a
// unit's tiles split over at most segs CTAs), tickets one zeroed int per
// (sequence, unit) (left zeroed); B <= 4096; window and slopes as in
// dstt_paged_decode.  Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for what the kernel does not take).
extern "C" int dstt_paged_decode_tma(const void* q, const void* ak,
                                     const void* av, const void* tables,
                                     const void* lens, void* o, void* ws,
                                     void* tickets, int B, int NH, int NKV,
                                     int D, int L, int nb, int bs, int MB,
                                     int layer, int segs, int window,
                                     const void* slopes, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || NKV <= 0 || NH % NKV != 0 || nb <= 0 || bs <= 0 ||
      MB <= 0 || L <= 0 || layer < 0 || layer >= L)
    return (int)cudaErrorInvalidValue;
#define DSTT_CASE(DD)                                                      \
  if (D == DD)                                                            \
    return launch_tma_any<DD>(q, ak, av, tables, lens, o, ws, tickets, B,  \
                              NH, NKV, L, nb, bs, MB, layer, segs, window, \
                              slopes, st);
  DSTT_DECODE_DIMS(DSTT_CASE)
#undef DSTT_CASE
  return (int)cudaErrorInvalidValue;
}

// The TMA kernel's grid for head dim D, group G and batch B (the CTAs
// that share its work list), or 0 where it takes no such call.
extern "C" int dstt_paged_decode_tma_ctas(int D, int G, int B) {
  if (G < 1 || B < 1 || B > 4096) return 0;
#define DSTT_CASE(DD) \
  if (D == DD) return ctas_any<DD>(G, B);
  DSTT_DECODE_DIMS(DSTT_CASE)
#undef DSTT_CASE
  return 0;
}
