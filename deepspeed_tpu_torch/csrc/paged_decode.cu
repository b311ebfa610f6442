// Paged decode attention for Hopper (sm_90a): one query token per sequence
// over its KV blocks in the shared arena.
//
// Replaces the TPU kernel deepspeed_tpu/ops/paged_attention.py
// `paged_decode_attention` (pallas_call body `_kernel`): block table read
// per key block, table entries clamped to [0, nb-1], keys past lens[b]
// masked, lens[b] < 0 rows give zeros, GQA served per kv head (the G
// grouped q heads share one pass over the kv head's keys), f32 online
// softmax.
//
// Layout: q [B, NH, D]; arena k/v [L, nb, bs, NKV, D] addressed at layer
// `layer_off` (an element offset into the full arena — no layer slice is
// ever copied); tables [B, MB] int32; lens [B] int32; out [B, NH, D].
//
// What bounds it on the H100: bytes.  Every live key row of K and V is
// read once per (sequence, kv head) and each row does 4*G*D FLOPs, far
// below the ~295 FLOP/byte ridge, so the card is only fast when enough
// loads are in flight.  The TPU kernel walks one sequence's blocks in
// order on one core; here one sequence's keys are split over many CTAs
// (split-KV, as in flash-decoding), so a long sequence does not leave the
// card waiting on one CTA's loads:
//   1. paged_decode_kernel, grid (NKV, B, splits): the CTA of split s takes
//      keys [s*KS, (s+1)*KS) of one (kv head, sequence) — a CTA past the
//      sequence's end returns at once.  Its 8 warps take keys w*4, w*4+1,
//      ... in runs of 4 and issue the 4 rows' K and V loads (one vector
//      load per lane per row) before any arithmetic, so their latencies
//      overlap; lane i holds D/32 contiguous elements of q, k, v and of
//      the f32 accumulators for each of the G <= 8 heads; the per-key dot
//      is a 5-step xor-shuffle sum; the warps' (m, l, acc) states merge
//      through shared memory into the split's partial state, written
//      unnormalized to the f32 scratch `part` [B, NH, splits, D + 2].
//   2. paged_decode_combine_kernel, grid (NH, B): merges the live splits'
//      partial states and writes the normalized output row.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int NW = 8;      // warps per CTA
constexpr int KB = 4;      // keys per warp per iteration
constexpr int MAXG = 8;    // largest GQA group served
constexpr int KS = 256;    // keys per split

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

template <typename T, int D>
__global__ void __launch_bounds__(NW * 32)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ ak,
                    const T* __restrict__ av, const int* __restrict__ tables,
                    const int* __restrict__ lens, float* __restrict__ part,
                    int NH, int NKV, int nb, int bs, int MB, int splits,
                    long layer_off, float sm_scale) {
  constexpr int PER = D / 32;   // elements per lane
  __shared__ float sm_m[NW][MAXG];
  __shared__ float sm_l[NW][MAXG];
  __shared__ float sm_acc[NW][MAXG][D];

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int split = blockIdx.z;
  const int G = NH / NKV;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n_keys = min(lens[b] + 1, MB * bs);   // lens < 0: no keys
  const int k0 = split * KS;
  if (k0 >= n_keys) return;   // past the sequence: the combine skips it
  const int k1 = min(k0 + KS, n_keys);

  float qf[MAXG][PER], acc[MAXG][PER], m[MAXG], l[MAXG];
  const long q_base = ((long)b * NH + (long)kvh * G) * D + lane * PER;
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < PER; ++e) acc[g][e] = 0.f;
    if (g < G) {
      load_f<T, PER>(q + q_base + (long)g * D, qf[g]);
#pragma unroll
      for (int e = 0; e < PER; ++e) qf[g][e] *= sm_scale;
    } else {
#pragma unroll
      for (int e = 0; e < PER; ++e) qf[g][e] = 0.f;
    }
  }

  const long row_stride = (long)NKV * D;
  const long head_off = layer_off + (long)kvh * D + lane * PER;
  const int* tb = tables + (long)b * MB;
  for (int base = k0 + warp * KB; base < k1; base += NW * KB) {
    float kf[KB][PER], vf[KB][PER];
#pragma unroll
    for (int u = 0; u < KB; ++u) {
      const int kp = base + u;
      if (kp < k1) {
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
#pragma unroll
    for (int e = 0; e < PER; ++e) sm_acc[warp][g][lane * PER + e] = acc[g][e];
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
    float* pr = part + (((long)b * NH + (long)kvh * G + g) * splits + split) *
                           (D + 2);
    pr[d] = O;
    if (d == 0) {
      pr[D] = M;
      pr[D + 1] = L;
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(D)
paged_decode_combine_kernel(const float* __restrict__ part,
                            const int* __restrict__ lens, T* __restrict__ o,
                            int NH, int MB, int bs, int splits) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int d = threadIdx.x;
  const int n_keys = min(lens[b] + 1, MB * bs);
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

template <typename T, int D>
int launch(const void* q, const void* ak, const void* av, const void* tables,
           const void* lens, void* part, void* o, int B, int NH, int NKV,
           int nb, int bs, int MB, long long layer_off, cudaStream_t stream) {
  const int splits = (MB * bs + KS - 1) / KS;
  paged_decode_kernel<T, D><<<dim3(NKV, B, splits), NW * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(ak),
      static_cast<const T*>(av), static_cast<const int*>(tables),
      static_cast<const int*>(lens), static_cast<float*>(part), NH, NKV, nb,
      bs, MB, splits, (long)layer_off, 1.0f / sqrtf((float)D));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  paged_decode_combine_kernel<T, D><<<dim3(NH, B), D, 0, stream>>>(
      static_cast<const float*>(part), static_cast<const int*>(lens),
      static_cast<T*>(o), NH, MB, bs, splits);
  return (int)cudaGetLastError();
}

}  // namespace

// Number of key splits of a table of MB blocks of bs keys: the scratch
// `part` holds B * NH * splits * (D + 2) floats.
extern "C" int dstt_paged_decode_splits(int MB, int bs) {
  return (MB * bs + KS - 1) / KS;
}

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after the
// launches (cudaErrorInvalidValue for an unsupported shape or dtype).
extern "C" int dstt_paged_decode(const void* q, const void* ak,
                                 const void* av, const void* tables,
                                 const void* lens, void* part, void* o,
                                 int B, int NH, int NKV, int D, int nb,
                                 int bs, int MB, long long layer_off,
                                 int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || NKV <= 0 || NH % NKV != 0 || NH / NKV > MAXG || nb <= 0 ||
      bs <= 0 || MB <= 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == 1) {
    if (D == 32)
      return launch<__nv_bfloat16, 32>(q, ak, av, tables, lens, part, o, B,
                                       NH, NKV, nb, bs, MB, layer_off, st);
    if (D == 64)
      return launch<__nv_bfloat16, 64>(q, ak, av, tables, lens, part, o, B,
                                       NH, NKV, nb, bs, MB, layer_off, st);
    if (D == 128)
      return launch<__nv_bfloat16, 128>(q, ak, av, tables, lens, part, o, B,
                                        NH, NKV, nb, bs, MB, layer_off, st);
  } else if (dtype == 0) {
    if (D == 32)
      return launch<float, 32>(q, ak, av, tables, lens, part, o, B, NH, NKV,
                               nb, bs, MB, layer_off, st);
    if (D == 64)
      return launch<float, 64>(q, ak, av, tables, lens, part, o, B, NH, NKV,
                               nb, bs, MB, layer_off, st);
    if (D == 128)
      return launch<float, 128>(q, ak, av, tables, lens, part, o, B, NH, NKV,
                                nb, bs, MB, layer_off, st);
  }
  return (int)cudaErrorInvalidValue;
}
