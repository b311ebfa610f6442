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
// h) — the JAX promotion of bf16 rows against f32 factors.
//
// Layout: x [S, K]; a [slots, K, r]; b [slots, r, N]; out [S, N] f32.
// `plan` is one int32 buffer the wrapper builds on the host once per
// serving call (the ids are host data there):
//   perm  [S]     the original row of sorted position p (rows sorted by slot)
//   tiles [T, 3]  (slot, first sorted position, rows <= TR); slot -1 = base
// and `hp` is f32 scratch [ks, S, r] for the shrink pass's partial sums.
//
// The TPU kernel sweeps every slot over every row tile under a mask (a
// sequential grid with a VMEM accumulator).  Here the rows are grouped by
// slot instead (Punica/S-LoRA's SGMV segments), so each CTA works for one
// slot's rows only, in two launches:
//   1. lora_delta_shrink_kernel, grid (T, ks): h partial of tile t over the
//      K span [k * KSPAN, (k+1) * KSPAN): A[slot]'s rows of the span stream
//      through shared memory in KC-row chunks beside the tile's x rows of
//      the same chunk; 8 warps take TR/8 rows each, lanes take the r
//      columns (and, when r < 32, 32/r interleaved key groups reduced with
//      shuffles at the end).  Base tiles return at once.
//   2. lora_delta_expand_kernel, grid (T, ceil(N/NT)): sums the ks partials
//      of the tile's h rows in a fixed order into shared memory, then each
//      thread computes one output column for the tile's rows (B[slot]'s row
//      j read once per CTA, coalesced) and stores scaling * sum at the rows'
//      original places; base tiles store 0.0.  No atomics: the same result
//      on every run.
// Any K, N >= 1 and r from 1 to 128 (the ragged edges are masked).
//
// What bounds it on the H100: bytes.  A row costs 2 K r + 2 r N FLOPs (262
// kFLOP at K = N = 4096, r = 16); x (2 or 4 bytes a value), out (4) and
// each slot's factors ((K + N) r 4 bytes, 512 KB at r = 16) are ~14 MB at
// S = 512 rows of 4 slots against ~134 MFLOP: ~10 FLOP a byte, under the
// f32 CUDA cores' ridge (67 TFLOP/s over 3.35 TB/s = 20).  So the design
// reads each x row once, each slot's factors once per tile (from L2 after
// the first tile), writes each output once, keeps h ([ks, S, r] f32, 256 KB
// at S = 512) tiny, and splits K over CTAs so that a few slots' rows still
// spread over many SMs.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

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
int launch(const void* x, const void* a, const void* b, const void* plan,
           void* hp, void* out, int S, int K, int N, int r, int n_tiles,
           float scaling, cudaStream_t stream) {
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
    return launch<T, 1>(x, a, b, plan, hp, out, S, K, N, r, n_tiles, scaling,
                        st);
  if (r <= 64)
    return launch<T, 2>(x, a, b, plan, hp, out, S, K, N, r, n_tiles, scaling,
                        st);
  return launch<T, 4>(x, a, b, plan, hp, out, S, K, N, r, n_tiles, scaling,
                      st);
}

}  // namespace

// Rows per tile and K rows per shrink CTA, for the wrapper's plan and
// scratch: hp holds ceil(K / KSPAN) * S * r floats.
extern "C" int dstt_lora_delta_tile_rows() { return TR; }
extern "C" int dstt_lora_delta_k_span() { return KSPAN; }

// dtype of x: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after
// the launches.
extern "C" int dstt_lora_delta(const void* x, const void* a, const void* b,
                               const void* plan, void* hp, void* out, int S,
                               int K, int N, int r, int n_tiles, float scaling,
                               int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S <= 0 || K <= 0 || N <= 0 || r <= 0 || r > 128 || n_tiles <= 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == 1)
    return launch_rank<__nv_bfloat16>(x, a, b, plan, hp, out, S, K, N, r,
                                      n_tiles, scaling, st);
  if (dtype == 0)
    return launch_rank<float>(x, a, b, plan, hp, out, S, K, N, r, n_tiles,
                              scaling, st);
  return (int)cudaErrorInvalidValue;
}
