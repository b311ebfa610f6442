// Gather-LoRA delta of multi-tenant serving, for Hopper (sm_90a).
//
// Replaces the TPU kernel deepspeed_tpu/ops/lora_matmul.py
// `_pallas_lora_delta` (pallas_call body `_lora_kernel`): every row s of a
// ragged batch carries an adapter slot id[s], and
//   out[s] = scaling * (x[s] @ A[id[s]]) @ B[id[s]]     (id[s] >= 0)
//   out[s] = 0.0, stored explicitly                      (id[s] < 0)
// all in f32: x rows (bf16 or f32) widen exactly, the factors are the
// adapter pool's f32 slot stacks, h = x @ A stays f32, and every product is
// an f32 FMA on the CUDA cores (no TF32, no bf16 rounding of a factor or of
// h) — the JAX promotion of bf16 rows against f32 factors.  TF32 tensor
// cores would round the factors to 10 bits (past the 1e-5 relative limit
// the port holds the kernel to), and at ~10 FLOP a byte the kernel sits
// under the f32 CUDA cores' ridge (67 TFLOP/s over 3.35 TB/s = 20): bytes
// bound it, so tensor cores would buy nothing.
//
// Layout: x [S, K]; a [slots, K, r]; b [slots, r, N]; out [S, N] f32.
// `plan` is one int32 buffer the wrapper builds on the host once per
// serving call (the ids are host data there):
//   perm  [S]     the original row of sorted position p (rows sorted by slot)
//   tiles [T, 3]  (slot, first sorted position, rows <= TR); slot -1 = base,
//                 the base tiles first
//   recs  [T, 4 + TR] the fused kernel's tile records: (slot, first
//                 sorted position, rows, 0, then the rows' perm entries)
// The TPU kernel sweeps every slot over every row tile under a mask (a
// sequential grid with a VMEM accumulator).  Here the rows are grouped by
// slot instead (Punica/S-LoRA's SGMV segments), so each CTA works for one
// slot's rows only.
//
// lora_delta_fused (dstt_lora_delta): one launch.  The work is numbered:
// first every shrink item (adapter tile, K span of SPAN rows: that span's
// partial h [TR, r] into scratch `hp`), then every expand item (tile, N
// span of SPAN columns).  Persistent CTAs (as many as are resident) take
// items from one atomic work counter, so an expand item, which waits with
// an acquire load of its tile's counter for the tile's ks shrink items,
// never waits on an item that no running CTA holds: every shrink item is
// handed out before any expand item, and shrink items wait on nothing.
// The expand item sums the ks partials in span order (no float atomics:
// reruns are bitwise equal).  A producer warp per CTA takes the next item
// while it loads the current one, and fetches each item's tile record
// (slot, rows and their perm entries in one read) and bytes into a
// 2-slot mbarrier ring with 1-D bulk copies (cp.async.bulk):
// A[slot]'s rows of the K span (contiguous), one copy per gathered x row,
// and one per row of B[slot] over the N span; operands that are not
// 16-byte aligned (bf16 K % 8, f32 K % 4, N % 4) go through the warp's
// own loads instead.  Ranks whose factor span exceeds a ring slot
// (16 KB) take it in chunks.  Eight consumer warps contract a chunk as
// 4 x 4 register tiles and write the output with 16-byte stores.  Each
// call finds its counters zero and leaves them zero, each zeroed by its
// last user: the work counter by the producer whose fetch takes its last
// value (every CTA fetches one past the end), a tile's counter by the
// last of its expanders (each adds one after its wait).  Nothing depends
// on the host's count of calls, so a CUDA graph that replays any number
// of calls, or an eager call between two replays, finds them zero, and
// no CTA waits at its end to reset anything.  Counters and `hp` are the
// wrapper's cached scratch: no call allocates.
//
// lora_delta_shrink_kernel + lora_delta_expand_kernel
// (dstt_lora_delta_two_pass): the first port, kept so that the two can be
// timed in one call: grid (T, ceil(K/512)) shrink CTAs stage x and A as
// scalars, then grid (T, ceil(N/256)) expand CTAs each sum the tile's
// partials again.
// Any K, N >= 1 and r from 1 to 128 (the ragged edges are masked).
//
// What bounds it on the H100: bytes.  A row costs 2 K r + 2 r N FLOPs (262
// kFLOP at K = N = 4096, r = 16); x (2 or 4 bytes a value), out (4) and
// each slot's factors ((K + N) r 4 bytes, 512 KB at r = 16) are ~14 MB at
// S = 512 rows of 4 slots against ~134 MFLOP.  At the decode shape (32
// rows) the bytes are ~1.5 MB, under a microsecond: there latency bounds
// it, which one launch and the ring address.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_tile.cuh"

namespace {

constexpr int NWARP = 8;        // warps per shrink CTA
constexpr int TR = 16;          // rows per tile
constexpr int RPW = TR / NWARP; // rows per warp
constexpr int KC = 128;         // rows of A staged per chunk
constexpr int KSPAN = 512;      // K rows per shrink CTA
constexpr int NT = 256;         // output columns per expand CTA

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// CPL: columns of r per lane (1 for r <= 32, 2 up to 64, 4 up to 128).
// P: lanes per key group (the power of two >= r when r <= 32, else 32).
template <typename T, int CPL>
__global__ void __launch_bounds__(NWARP * 32)
lora_delta_shrink_kernel(const T* __restrict__ x, const float* __restrict__ a,
                         const int* __restrict__ plan, float* __restrict__ hp,
                         int S, int K, int r, int P) {
  const int* perm = plan;
  const int* tile = plan + S + 3 * blockIdx.x;
  const int slot = tile[0], p0 = tile[1], rows = tile[2];
  if (slot < 0) return;  // base rows: the expand pass stores their zeros
  extern __shared__ float smem[];
  float* sa = smem;           // [KC, r]  a chunk of A[slot]'s rows
  float* sx = smem + KC * r;  // [TR, KC] the tile's x over the same chunk
  const float* A = a + (long)slot * K * r;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int G = 32 / P;  // interleaved key groups
  const int g = lane / P, col = lane % P;
  const int k_lo = blockIdx.y * KSPAN, k_hi = min(K, k_lo + KSPAN);

  float acc[RPW][CPL];
#pragma unroll
  for (int i = 0; i < RPW; ++i)
#pragma unroll
    for (int c = 0; c < CPL; ++c) acc[i][c] = 0.f;

  for (int k0 = k_lo; k0 < k_hi; k0 += KC) {
    const int kc = min(KC, k_hi - k0);
    __syncthreads();  // the previous chunk is consumed
    for (int i = threadIdx.x; i < kc * r; i += NWARP * 32)
      sa[i] = A[(long)k0 * r + i];
    for (int i = threadIdx.x; i < TR * KC; i += NWARP * 32) {
      const int row = i / KC, kk = i % KC;
      sx[i] = (row < rows && kk < kc)
                  ? to_f(x[(long)perm[p0 + row] * K + k0 + kk])
                  : 0.f;
    }
    __syncthreads();
    for (int kk = g; kk < kc; kk += G) {
      float av[CPL];
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        const int j = col + 32 * c;
        av[c] = j < r ? sa[kk * r + j] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        const float xv = sx[(warp * RPW + i) * KC + kk];
#pragma unroll
        for (int c = 0; c < CPL; ++c) acc[i][c] = fmaf(xv, av[c], acc[i][c]);
      }
    }
  }
  // the key groups' sums (lanes g * P + col for each g)
  for (int off = P; off < 32; off <<= 1)
#pragma unroll
    for (int i = 0; i < RPW; ++i)
#pragma unroll
      for (int c = 0; c < CPL; ++c)
        acc[i][c] += __shfl_xor_sync(0xffffffffu, acc[i][c], off);
  if (g != 0) return;
  float* out = hp + ((long)blockIdx.y * S + p0) * r;
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int row = warp * RPW + i;
    if (row >= rows) continue;
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      const int j = col + 32 * c;
      if (j < r) out[(long)row * r + j] = acc[i][c];
    }
  }
}

__global__ void __launch_bounds__(NT)
lora_delta_expand_kernel(const float* __restrict__ hp,
                         const float* __restrict__ b,
                         const int* __restrict__ plan, float* __restrict__ out,
                         int S, int N, int r, int ks, float scaling,
                         int scaled) {
  const int* perm = plan;
  const int* tile = plan + S + 3 * blockIdx.x;
  const int slot = tile[0], p0 = tile[1], rows = tile[2];
  const int n = blockIdx.y * NT + threadIdx.x;
  if (slot < 0) {  // base rows: an explicit 0.0, never 0 * anything
    if (n < N)
      for (int i = 0; i < rows; ++i) out[(long)perm[p0 + i] * N + n] = 0.f;
    return;
  }
  extern __shared__ float sh[];  // [TR, r] the tile's h rows
  for (int i = threadIdx.x; i < TR * r; i += NT) {
    const int row = i / r, j = i % r;
    float v = 0.f;
    if (row < rows)
      for (int s = 0; s < ks; ++s)  // fixed order over the K spans
        v += hp[((long)s * S + p0 + row) * r + j];
    sh[i] = v;
  }
  __syncthreads();
  if (n >= N) return;
  const float* B = b + (long)slot * r * N;
  float acc[TR];
#pragma unroll
  for (int i = 0; i < TR; ++i) acc[i] = 0.f;
  for (int j = 0; j < r; ++j) {
    const float bv = B[(long)j * N + n];
#pragma unroll
    for (int i = 0; i < TR; ++i) acc[i] = fmaf(sh[i * r + j], bv, acc[i]);
  }
#pragma unroll
  for (int i = 0; i < TR; ++i)
    if (i < rows)
      out[(long)perm[p0 + i] * N + n] = scaled ? acc[i] * scaling : acc[i];
}

template <typename T, int CPL>
int launch_two_pass(const void* x, const void* a, const void* b,
                    const void* plan, void* hp, void* out, int S, int K,
                    int N, int r, int n_tiles, float scaling,
                    cudaStream_t stream) {
  int P = 32;
  if (CPL == 1) {
    P = 1;
    while (P < r) P <<= 1;
  }
  const int ks = (K + KSPAN - 1) / KSPAN;
  const int smem_shrink = (KC * r + TR * KC) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      lora_delta_shrink_kernel<T, CPL>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem_shrink);
  if (err != cudaSuccess) return (int)err;
  lora_delta_shrink_kernel<T, CPL>
      <<<dim3(n_tiles, ks), NWARP * 32, smem_shrink, stream>>>(
          static_cast<const T*>(x), static_cast<const float*>(a),
          static_cast<const int*>(plan), static_cast<float*>(hp), S, K, r, P);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int smem_expand = TR * r * (int)sizeof(float);
  lora_delta_expand_kernel<<<dim3(n_tiles, (N + NT - 1) / NT), NT,
                             smem_expand, stream>>>(
      static_cast<const float*>(hp), static_cast<const float*>(b),
      static_cast<const int*>(plan), static_cast<float*>(out), S, N, r, ks,
      scaling, scaling != 1.0f);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_rank(const void* x, const void* a, const void* b, const void* plan,
                void* hp, void* out, int S, int K, int N, int r, int n_tiles,
                float scaling, cudaStream_t st) {
  if (r <= 32)
    return launch_two_pass<T, 1>(x, a, b, plan, hp, out, S, K, N, r,
                                 n_tiles, scaling, st);
  if (r <= 64)
    return launch_two_pass<T, 2>(x, a, b, plan, hp, out, S, K, N, r,
                                 n_tiles, scaling, st);
  return launch_two_pass<T, 4>(x, a, b, plan, hp, out, S, K, N, r,
                               n_tiles, scaling, st);
}


// ---------------------------------------------------------------------
// lora_delta_fused: one launch, shrink and expand items from one counter
// ---------------------------------------------------------------------
namespace hp = dstt::hopper;

constexpr int MAX_RANK = 128;
constexpr int F_CONS = 256;              // consumer threads (8 warps)
constexpr int F_THREADS = F_CONS + 32;   // and one producer warp
constexpr int F_STAGES = 2;              // ring slots
constexpr int SPAN = 256;                // K rows / N columns of an item
constexpr int CHUNK_FLOATS = 4096;       // factor floats a ring slot holds
constexpr int B_ROWS = CHUNK_FLOATS / SPAN;   // rows of B a slot holds
constexpr int W_BYTES = CHUNK_FLOATS * 4;
constexpr int X_BYTES = TR * SPAN * 4;   // a tile's x rows, f32 at most
constexpr int SLOT_BYTES = W_BYTES + X_BYTES;
constexpr int RED_FLOATS = F_CONS * 16;  // the k-groups' 4 x 4 partials
constexpr int H_FLOATS = TR * MAX_RANK;  // one tile's h
constexpr int REC = 4 + TR;              // a tile record: slot, p0, rows,
                                         // 0, then its rows' perm
constexpr int F_SMEM =
    128 + F_STAGES * SLOT_BYTES + (RED_FLOATS + H_FLOATS) * 4;

struct FusedArgs {
  const void* x;
  const float* a;
  const float* b;
  const int* recs;   // [n_tiles, REC] tile records, base tiles first
  float* hp;         // [n_tiles - first_ad, ks, TR, r] shrink partials
  float* out;
  int* ctr;          // [0] work, [1 + t] tile t's finished shrink items
                     // (then its expanders)
  int S, K, N, r, n_tiles, first_ad, ks, ns, n_shrink, n_items;
  float scaling;
  int scaled, x_bulk, a_bulk, b_bulk, out_vec;
};

// K rows of A a ring slot holds: a multiple of 8 (so every x chunk
// starts 16-byte aligned) with k rows x r floats <= CHUNK_FLOATS
__host__ __device__ constexpr int k_chunk(int r) {
  return CHUNK_FLOATS / r / 8 * 8 < SPAN ? CHUNK_FLOATS / r / 8 * 8 : SPAN;
}

// Work item `item`: shrink items (tile, K span) of the adapter tiles come
// first, tile-major, then expand items (tile, N span) of every tile; the
// rest from the tile's record (slot, first sorted position, rows).
struct Item {
  int tile, span, shrink, slot, rows, lo, len, chunks, chunk_rows;
};

__device__ __forceinline__ Item decode(const FusedArgs& p, int item,
                                       const int* rec) {
  Item it{};
  if (item < p.n_shrink) {
    it.shrink = 1;
    it.tile = p.first_ad + item / p.ks;
    it.span = item % p.ks;
  } else {
    const int j = item - p.n_shrink;
    it.tile = j / p.ns;
    it.span = j % p.ns;
  }
  it.slot = rec[0];
  it.rows = rec[2];
  it.lo = it.span * SPAN;
  it.len = min(SPAN, (it.shrink ? p.K : p.N) - it.lo);
  it.chunk_rows = it.shrink ? k_chunk(p.r) : B_ROWS;
  const int J = it.shrink ? it.len : p.r;   // the contraction an item walks
  it.chunks = it.slot >= 0 ? (J + it.chunk_rows - 1) / it.chunk_rows : 1;
  return it;
}

// The producer warp's copies of chunk c of `it` into a ring slot: W (A's
// rows of the chunk's K range, or B's rows of the chunk's r range over
// the item's N span, rows SPAN floats apart) and, for a shrink item, X
// (the tile's x rows over the same K range, rows chunk_rows apart; lane
// i holds row i's perm entry).  16-byte-aligned operands go by 1-D bulk
// copy (one per x row, one for A, one per B row); the others by the
// warp's own loads and stores.
template <typename T>
__device__ __forceinline__ void load_chunk(const FusedArgs& p, const Item& it,
                                           int c, int my_row, uint8_t* slot,
                                           uint64_t* bar, int lane) {
  float* W = reinterpret_cast<float*>(slot);
  T* X = reinterpret_cast<T*>(slot + W_BYTES);
  if (it.shrink) {
    const int k0 = it.lo + c * it.chunk_rows;
    const int kc = min(it.chunk_rows, it.lo + it.len - k0);
    const float* A = p.a + ((long)it.slot * p.K + k0) * p.r;
    const T* x = static_cast<const T*>(p.x);
    const uint32_t a_bytes = p.a_bulk ? kc * p.r * 4 : 0;
    const uint32_t x_bytes = p.x_bulk ? it.rows * kc * (int)sizeof(T) : 0;
    if (lane == 0 && a_bytes + x_bytes)
      hp::mbar_expect_tx_only(bar, a_bytes + x_bytes);
    __syncwarp();
    if (p.a_bulk) {
      if (lane == 31) hp::bulk_load(W, A, a_bytes, bar);
    } else {
      for (int i = lane; i < kc * p.r; i += 32) W[i] = A[i];
    }
    if (p.x_bulk) {
      if (lane < it.rows)
        hp::bulk_load(X + lane * it.chunk_rows,
                      x + (long)my_row * p.K + k0, kc * (int)sizeof(T),
                      bar);
    } else {
      for (int row = 0; row < it.rows; ++row) {
        const int src_row = __shfl_sync(0xffffffffu, my_row, row);
        const T* src = x + (long)src_row * p.K + k0;
        for (int k = lane; k < kc; k += 32) X[row * it.chunk_rows + k] = src[k];
      }
    }
  } else if (it.slot >= 0) {
    const int j0 = c * B_ROWS, jc = min(B_ROWS, p.r - j0);
    const float* B = p.b + ((long)it.slot * p.r + j0) * p.N + it.lo;
    if (lane == 0 && p.b_bulk) hp::mbar_expect_tx_only(bar, jc * it.len * 4);
    __syncwarp();
    if (p.b_bulk) {
      if (lane < jc)
        hp::bulk_load(W + lane * SPAN, B + (long)lane * p.N, it.len * 4, bar);
    } else {
      for (int j = 0; j < jc; ++j)
        for (int n = lane; n < it.len; n += 32)
          W[j * SPAN + n] = B[(long)j * p.N + n];
    }
  }
}

__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  v[0] = f.x, v[1] = f.y, v[2] = f.z, v[3] = f.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  v[0] = lo.x, v[1] = lo.y, v[2] = hi.x, v[3] = hi.y;
}

// acc[i][c] += sum over this thread's j of X[4 rq + i][j] W[j][4 cq + c]:
// j < J in chunks of 4, chunk 4 kg, then every KG-th (a fixed order).
// X rows ldx elements apart (a multiple of 4), W rows ldw floats apart
// (float4 loads when w4); a j past J is never multiplied.
template <typename T>
__device__ __forceinline__ void contract(float (&acc)[4][4], const T* X,
                                         int ldx, const float* W, int ldw,
                                         int J, int rq, int cq, int kg,
                                         int KG, bool w4) {
  const T* xr = X + 4 * rq * ldx;
  const float* wc = W + 4 * cq;
  for (int j0 = 4 * kg; j0 < J; j0 += 4 * KG) {
    float xv[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) load4(xr + i * ldx + j0, xv[i]);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (j0 + u < J) {
        float w[4];
        const float* wr = wc + (j0 + u) * ldw;
        if (w4) {
          load4(wr, w);
        } else {
#pragma unroll
          for (int c = 0; c < 4; ++c) w[c] = wr[c];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            acc[i][c] = fmaf(xv[i][u], w[c], acc[i][c]);
      }
    }
  }
}

// Store row `row`'s 4 results v (times mul) at o, columns c0.. of C:
// one 16-byte store where vec and all four are inside.
__device__ __forceinline__ void store4(float* o, const float (&v)[4],
                                      float mul, int c0, int C, bool vec) {
  if (vec && c0 + 3 < C) {
    *reinterpret_cast<float4*>(o) =
        make_float4(v[0] * mul, v[1] * mul, v[2] * mul, v[3] * mul);
  } else {
    for (int e = 0; e < 4 && c0 + e < C; ++e) o[e] = v[e] * mul;
  }
}

// One launch of the whole delta.  A CTA is one producer warp, which
// takes items from the work counter (the next one while it loads the
// current one) and fills a 2-slot mbarrier ring with each item's chunks
// and its tile's record, and 8 consumer warps, which contract them: 16
// rows x C outputs (C = r for shrink, the N span for expand) as 4 x 4
// register tiles, the contraction split into KG = 256 / (4 ceil(C / 4))
// groups of interleaved 4-row pieces summed in order through shared
// memory where KG > 1.  A shrink item writes its partial h [TR, r] of
// one K span and releases it on its tile's counter; an expand item waits
// (acquire) for its tile's ks shrinks, sums their partials in span order
// into h, then stores scaling * h B over its N span (base tiles: 0.0).
// Each counter's last user zeroes it for the next call.
template <typename T>
__global__ void __launch_bounds__(F_THREADS, 2)
lora_delta_fused(const FusedArgs p) {
  extern __shared__ __align__(128) uint8_t smem_raw[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 127) & ~uintptr_t(127));
  float* red = reinterpret_cast<float*>(ring + F_STAGES * SLOT_BYTES);
  float* hs = red + RED_FLOATS;
  __shared__ __align__(8) uint64_t full[F_STAGES], empty[F_STAGES];
  // per slot: item, chunk, then the item's tile record
  __shared__ int meta[F_STAGES][2 + REC];
  const int tid = threadIdx.x, lane = tid & 31;
  if (tid == 0) {
    for (int s = 0; s < F_STAGES; ++s) {
      hp::mbar_init(&full[s], 32);   // every producer lane arrives
      hp::mbar_init(&empty[s], 1);
    }
    hp::mbar_fence_init();
  }
  __syncthreads();

  if (tid >= F_CONS) {   // producer
    int next = 0;
    if (lane == 0) next = atomicAdd(p.ctr, 1);
    int item = __shfl_sync(0xffffffffu, next, 0);
    for (int j = 0;;) {
      if (lane == 0 && item < p.n_items) next = atomicAdd(p.ctr, 1);
      // the call's last fetch: no other comes, so the counter is zeroed
      if (lane == 0 && item == p.n_items + (int)gridDim.x - 1) p.ctr[0] = 0;
      int n = 1;
      Item it{};
      int rec = 0, my_row = 0;
      if (item < p.n_items) {
        const int tile =
            item < p.n_shrink ? p.first_ad + item / p.ks
                              : (item - p.n_shrink) / p.ns;
        rec = lane < REC ? p.recs[tile * REC + lane] : 0;
        int r0[3];
        for (int i = 0; i < 3; ++i) r0[i] = __shfl_sync(0xffffffffu, rec, i);
        it = decode(p, item, r0);
        my_row = __shfl_sync(0xffffffffu, rec, 4 + (lane & (TR - 1)));
        n = it.chunks;
      }
      for (int c = 0; c < n; ++c, ++j) {
        const int s = j % F_STAGES;
        hp::mbar_wait(&empty[s], ((j / F_STAGES) & 1) ^ 1);
        if (lane < REC) meta[s][2 + lane] = rec;
        if (lane == 0) {
          meta[s][0] = item;
          meta[s][1] = c;
        }
        if (item < p.n_items)
          load_chunk<T>(p, it, c, my_row, ring + s * SLOT_BYTES, &full[s],
                        lane);
        __syncwarp();
        hp::mbar_arrive(&full[s]);
      }
      if (item >= p.n_items) break;
      item = __shfl_sync(0xffffffffu, next, 0);
    }
    return;
  }

  const int r4 = (p.r + 3) & ~3;
  Item it{};
  int CQ = 1, KG = 1, kg = 0, rq = 0, cq = 0;
  int seen = -1;   // tid 0: the tile counter before this expander's add
  float acc[4][4];
  for (int j = 0;; ++j) {
    const int s = j % F_STAGES;
    hp::mbar_wait(&full[s], (j / F_STAGES) & 1);
    const int* m = meta[s];
    const int item = m[0], c = m[1];
    if (item >= p.n_items) break;
    const int* rec = m + 2;
    const uint8_t* slot = ring + s * SLOT_BYTES;
    if (c == 0) {   // a new item: its thread layout, h for an expand
      it = decode(p, item, rec);
      CQ = ((it.shrink ? p.r : it.len) + 3) / 4;
      const int micro = 4 * CQ;
      KG = F_CONS / micro;
      kg = tid / micro;
      rq = tid % micro & 3;
      cq = tid % micro >> 2;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
      if (!it.shrink && it.slot >= 0) {
        if (tid == 0) {
          while (hp::ld_acquire(p.ctr + 1 + it.tile) < p.ks) __nanosleep(32);
          seen = atomicAdd(p.ctr + 1 + it.tile, 1);   // read at the end
        }
        hp::named_sync(1, F_CONS);
        const float* part =
            p.hp + (long)(it.tile - p.first_ad) * p.ks * TR * p.r;
        for (int o = tid; o < TR * p.r; o += F_CONS) {
          float h = 0.f;
#pragma unroll 16
          for (int sp = 0; sp < p.ks; ++sp)   // span order
            h += __ldcg(part + (long)sp * TR * p.r + o);
          hs[o / p.r * r4 + o % p.r] = h;
        }
        hp::named_sync(1, F_CONS);
      }
    }
    if (kg < KG) {
      if (it.shrink) {
        const int k0 = it.lo + c * it.chunk_rows;
        contract<T>(acc, reinterpret_cast<const T*>(slot + W_BYTES),
                    it.chunk_rows, reinterpret_cast<const float*>(slot),
                    p.r, min(it.chunk_rows, it.lo + it.len - k0), rq, cq,
                    kg, KG, (p.r & 3) == 0);
      } else if (it.slot >= 0) {
        const int j0 = c * B_ROWS;
        contract<float>(acc, hs + j0, r4,
                        reinterpret_cast<const float*>(slot), SPAN,
                        min(B_ROWS, p.r - j0), rq, cq, kg, KG, true);
      }
    }
    const bool last = c == it.chunks - 1;
    if (last && it.slot >= 0) {
      const int C = it.shrink ? p.r : it.len;
      float* dst = it.shrink
                       ? p.hp + ((long)(it.tile - p.first_ad) * p.ks +
                                 it.span) * TR * p.r
                       : p.out + it.lo;
      const long ld = it.shrink ? p.r : p.N;
      const bool vec = it.shrink ? (p.r & 3) == 0 : p.out_vec;
      const float mul = !it.shrink && p.scaled ? p.scaling : 1.f;
      if (KG == 1) {   // one group: every output from its registers
        if (kg == 0) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int row = 4 * rq + i;
            if (row < it.rows)
              store4(dst + (it.shrink ? row : (long)rec[4 + row]) * ld +
                         4 * cq,
                     acc[i], mul, 4 * cq, C, vec);
          }
        }
      } else {   // the k-groups' partials, then their sums in order
        const int CP = 4 * CQ;
        if (kg < KG)
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              red[(kg * TR + 4 * rq + i) * CP + 4 * cq + e] = acc[i][e];
        hp::named_sync(1, F_CONS);
        for (int q = tid; q < TR * CQ; q += F_CONS) {
          const int row = q / CQ, c0 = q % CQ * 4;
          if (row >= it.rows) continue;
          float v[4] = {0.f, 0.f, 0.f, 0.f};
          for (int g = 0; g < KG; ++g)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              v[e] += red[(g * TR + row) * CP + c0 + e];
          store4(dst + (it.shrink ? row : (long)rec[4 + row]) * ld + c0, v,
                 mul, c0, C, vec);
        }
      }
    } else if (last) {   // base rows: an explicit 0.0, never 0 * x
      const int CQn = (it.len + 3) / 4;
      const float zero[4] = {0.f, 0.f, 0.f, 0.f};
      for (int q = tid; q < it.rows * CQn; q += F_CONS) {
        const int row = q / CQn, c0 = q % CQn * 4;
        store4(p.out + (long)rec[4 + row] * p.N + it.lo + c0, zero, 1.f, c0,
               it.len, p.out_vec);
      }
    }
    hp::named_sync(1, F_CONS);   // the slot, red and h are read
    if (tid == 0) {
      if (last && it.shrink)   // the partial, released to the expanders
        asm volatile("red.release.gpu.global.add.s32 [%0], 1;\n" ::"l"(
                         p.ctr + 1 + it.tile)
                     : "memory");
      hp::mbar_arrive(&empty[s]);
      // (after the slot is handed back: the add's value may still be on
      // its way)
      if (last && seen == p.ks + p.ns - 1)   // the tile's last expander
        p.ctr[1 + it.tile] = 0;
      if (last) seen = -1;
    }
  }
}

template <typename T>
int launch_fused(const FusedArgs& p, int grid, cudaStream_t st) {
  static bool attr_set[64] = {};   // the shared-memory limit, once a device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!attr_set[dev]) {
    err = cudaFuncSetAttribute(lora_delta_fused<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               F_SMEM);
    if (err != cudaSuccess) return (int)err;
    attr_set[dev] = true;
  }
  lora_delta_fused<T><<<grid, F_THREADS, F_SMEM, st>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// The fused kernel.  x dtype: 0 = float32, 1 = bfloat16.  plan: perm [S],
// tiles [n_tiles, 3] (the two-pass kernel's), then the fused kernel's
// tile records [n_tiles, 4 + tile_rows] (slot, first sorted position,
// rows, 0, the rows' perm entries), the first `first_ad` tiles base
// tiles; hp: (n_tiles - first_ad) * ceil(K / span) * tile_rows * r
// floats; ctr: `ctr_ints` >= 1 + n_tiles ints, the first 1 + n_tiles
// zero (a new buffer is; each call leaves them zero); tile_rows and
// span: the wrapper's view of TR and SPAN (refused if they differ); at
// most max_ctas CTAs.  Returns cudaGetLastError() after the launch.
extern "C" int dstt_lora_delta(const void* x, const void* a, const void* b,
                               const void* plan, void* hp, void* ctr,
                               void* out, int S, int K, int N, int r,
                               int n_tiles, int first_ad, int tile_rows,
                               int span, int ctr_ints, float scaling,
                               int dtype, int max_ctas, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S <= 0 || K <= 0 || N <= 0 || r <= 0 || r > MAX_RANK ||
      n_tiles <= 0 || first_ad < 0 || first_ad > n_tiles || max_ctas <= 0 ||
      tile_rows != TR || span != SPAN || ctr_ints < 1 + n_tiles ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const int es = dtype == 1 ? 2 : 4;
  auto aligned = [](const void* ptr) {
    return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
  };
  FusedArgs p;
  p.x = x;
  p.a = static_cast<const float*>(a);
  p.b = static_cast<const float*>(b);
  p.recs = static_cast<const int*>(plan) + S + 3 * n_tiles;
  p.hp = static_cast<float*>(hp);
  p.out = static_cast<float*>(out);
  p.ctr = static_cast<int*>(ctr);
  p.S = S, p.K = K, p.N = N, p.r = r;
  p.n_tiles = n_tiles, p.first_ad = first_ad;
  p.ks = (K + SPAN - 1) / SPAN;
  p.ns = (N + SPAN - 1) / SPAN;
  p.n_shrink = (n_tiles - first_ad) * p.ks;
  p.n_items = p.n_shrink + n_tiles * p.ns;
  p.scaling = scaling;
  p.scaled = scaling != 1.0f;
  p.x_bulk = (long)K * es % 16 == 0 && aligned(x);
  p.a_bulk = (K % 8 == 0 || r % 4 == 0) && aligned(a);
  p.b_bulk = N % 4 == 0 && aligned(b);
  p.out_vec = N % 4 == 0 && aligned(out);
  if (!aligned(hp)) return (int)cudaErrorInvalidValue;
  const int grid = p.n_items < max_ctas ? p.n_items : max_ctas;
  return dtype == 1 ? launch_fused<__nv_bfloat16>(p, grid, st)
                    : launch_fused<float>(p, grid, st);
}

// The two-pass kernels (dtype and plan as above; they read perm and
// tiles).  hp: ceil(K / k_span) * S * r floats; tile_rows and k_span: the
// wrapper's view of TR and KSPAN (refused if they differ).  Returns
// cudaGetLastError() after the launches.
extern "C" int dstt_lora_delta_two_pass(const void* x, const void* a,
                                        const void* b, const void* plan,
                                        void* hp, void* out, int S, int K,
                                        int N, int r, int n_tiles,
                                        int tile_rows, int k_span,
                                        float scaling, int dtype,
                                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S <= 0 || K <= 0 || N <= 0 || r <= 0 || r > MAX_RANK ||
      n_tiles <= 0 || tile_rows != TR || k_span != KSPAN)
    return (int)cudaErrorInvalidValue;
  if (dtype == 1)
    return launch_rank<__nv_bfloat16>(x, a, b, plan, hp, out, S, K, N, r,
                                      n_tiles, scaling, st);
  if (dtype == 0)
    return launch_rank<float>(x, a, b, plan, hp, out, S, K, N, r, n_tiles,
                              scaling, st);
  return (int)cudaErrorInvalidValue;
}
