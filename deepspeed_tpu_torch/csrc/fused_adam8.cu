// One-pass 8-bit Adam/AdamW for Hopper (sm_90a).
//
// Replaces the TPU kernel deepspeed_tpu/ops/fused_adam8.py
// `fused_adam8_leaf` (pallas_call at :182, body `_kernel`): decode the
// int8 m (linear, per-row scale) and uint8 v (log map over 24 octaves
// below the row max, code 0 = exact 0), take the Adam step in f32, write
// the new f32 master and its cast to the compute dtype, take each row's
// exact absmax of the new moments and requantize them.
//
// Layout: every array is the leaf seen as [rows, R] (R = its last dim, the
// quantization row), row-major and contiguous; the scales are [rows] f32.
// The outputs may alias the inputs (the engine updates in place): each
// element is read and written by one thread, and every thread has read the
// old row scales before the __syncthreads() that precedes their store.
//
// Grid: one CTA of 256 threads per row, or 256/TPR rows of TPR (32, 64 or
// 128) threads each when R is short.
//   pass 1: decode, update, write the master and its cast, keep m_new and
//     v_new in shared memory, each thread's running max of |m_new| and
//     v_new; reduced over the row with warp shuffles, then across the row's
//     warps in shared memory;
//   pass 2: requantize m_new / v_new from shared memory, write the codes
//     and the two scales.
// When a row does not fit in shared memory (R > 25600) pass 1 only takes
// the maxima and pass 2 recomputes the update from the inputs (and writes
// the master there, since the recompute reads the old one).
//
// What bounds it on the H100: bytes.  Per element it reads the gradient
// (2 B bf16), the two codes (2 B) and the master (4 B) and writes the
// master (4 B), the bf16 parameter (2 B) and the two codes (2 B): 16 B, or
// 21.05 GB and 6.3 ms at 3.35 TB/s for GPT-2-1.3B's 1,315,819,520
// parameters (the recompute form reads ~20 B).  The exp2/log2/division/sqrt
// per element (~40 operations) stay under the bytes at the card's rates,
// which is why the one-pass form wins here where it lost on the TPU's VPU.
// Vector loads (16 B of master, 8 B of bf16, 4 B of codes a thread) when R
// is a multiple of 4 and every pointer 16-byte aligned.
//
// Numerics: the operation order of the plain version
// (runtime/optimizers.adam8_leaf), with __fmul_rn/__fadd_rn/__fdiv_rn/
// __fsqrt_rn so nvcc contracts nothing into an FMA; rintf rounds half to
// even like torch.round.  Build without --use_fast_math: the codebook needs
// IEEE exp2f, log2f and division.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;
constexpr int THREADS = 256;
// the f32 value of the JAX package's _V_LOG_STEP = 24.0 / 254.0 (a Python
// double rounded once to f32, as the plain version's weak scalar is)
constexpr float V_LOG_STEP = (float)(24.0 / 254.0);
constexpr int STASH_MAX_BYTES = 200 * 1024;

struct Hyper {
  float lr, c1, c2, b1, omb1, b2, omb2, eps, wd;  // omb = 1 - b (in double)
  int adam_w;
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// One element: (new master, m_new, v_new) from the gradient g (already in
// f32), the codes and the old master, as runtime/optimizers.adam8_leaf.
__device__ __forceinline__ float adam_elem(float g, int mq, int vq, float p,
                                           float ms, float vs, float gs,
                                           const Hyper& h, float& m_new,
                                           float& v_new) {
  g = __fmul_rn(g, gs);
  if (!h.adam_w && h.wd != 0.f) g = __fadd_rn(g, __fmul_rn(h.wd, p));
  const float m = __fmul_rn((float)mq, ms);
  const float v =
      vq == 0 ? 0.f
              : __fmul_rn(vs, exp2f(__fmul_rn((float)vq - 255.f, V_LOG_STEP)));
  m_new = __fadd_rn(__fmul_rn(h.b1, m), __fmul_rn(h.omb1, g));
  v_new = __fadd_rn(__fmul_rn(h.b2, v), __fmul_rn(h.omb2, __fmul_rn(g, g)));
  float upd = __fdiv_rn(__fdiv_rn(m_new, h.c1),
                        __fadd_rn(__fsqrt_rn(__fdiv_rn(v_new, h.c2)), h.eps));
  if (h.adam_w && h.wd != 0.f) upd = __fadd_rn(upd, __fmul_rn(h.wd, p));
  return __fsub_rn(p, __fmul_rn(h.lr, upd));
}

__device__ __forceinline__ int8_t code_m(float m_new, float scale) {
  const float q = rintf(__fdiv_rn(m_new, scale));
  return (int8_t)fminf(fmaxf(q, -128.f), 127.f);
}

__device__ __forceinline__ uint8_t code_v(float v_new, float denom) {
  const float r = __fdiv_rn(v_new, denom);
  if (!(r > 0.f)) return 0;
  const float q = rintf(__fadd_rn(
      255.f, __fdiv_rn(log2f(fmaxf(r, 0x1p-30f)), V_LOG_STEP)));
  return (uint8_t)fminf(fmaxf(q, 1.f), 255.f);
}

// VEC consecutive elements from i on, widened to f32 / int.
template <int VEC>
__device__ __forceinline__ void load_g(const float* g, long i, float* out) {
  if constexpr (VEC == 4) {
    const float4 v = *reinterpret_cast<const float4*>(g + i);
    out[0] = v.x, out[1] = v.y, out[2] = v.z, out[3] = v.w;
  } else {
    out[0] = g[i];
  }
}

template <int VEC>
__device__ __forceinline__ void load_g(const bf16* g, long i, float* out) {
  if constexpr (VEC == 4) {
    const uint2 u = *reinterpret_cast<const uint2*>(g + i);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    out[0] = a.x, out[1] = a.y, out[2] = b.x, out[3] = b.y;
  } else {
    out[0] = __bfloat162float(g[i]);
  }
}

template <int VEC>
__device__ __forceinline__ void load_codes(const int8_t* mq, const uint8_t* vq,
                                           long i, int* m, int* v) {
  if constexpr (VEC == 4) {
    const char4 a = *reinterpret_cast<const char4*>(mq + i);
    const uchar4 b = *reinterpret_cast<const uchar4*>(vq + i);
    m[0] = a.x, m[1] = a.y, m[2] = a.z, m[3] = a.w;
    v[0] = b.x, v[1] = b.y, v[2] = b.z, v[3] = b.w;
  } else {
    m[0] = mq[i];
    v[0] = vq[i];
  }
}

template <int VEC>
__device__ __forceinline__ void load_f32(const float* p, long i, float* out) {
  load_g<VEC>(p, i, out);
}

template <int VEC>
__device__ __forceinline__ void store_f32(float* p, long i, const float* x) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p + i) = make_float4(x[0], x[1], x[2], x[3]);
  } else {
    p[i] = x[0];
  }
}

template <int VEC>
__device__ __forceinline__ void store_cast(bf16* o, long i, const float* x) {
  if constexpr (VEC == 4) {
    __nv_bfloat162 a = __floats2bfloat162_rn(x[0], x[1]);
    __nv_bfloat162 b = __floats2bfloat162_rn(x[2], x[3]);
    uint2 u;
    u.x = *reinterpret_cast<uint32_t*>(&a);
    u.y = *reinterpret_cast<uint32_t*>(&b);
    *reinterpret_cast<uint2*>(o + i) = u;
  } else {
    o[i] = __float2bfloat16_rn(x[0]);
  }
}

template <int VEC>
__device__ __forceinline__ void store_cast(float* o, long i, const float* x) {
  store_f32<VEC>(o, i, x);
}

template <int VEC>
__device__ __forceinline__ void store_codes(int8_t* mq, uint8_t* vq, long i,
                                            const int8_t* m,
                                            const uint8_t* v) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<char4*>(mq + i) = make_char4(m[0], m[1], m[2], m[3]);
    *reinterpret_cast<uchar4*>(vq + i) = make_uchar4(v[0], v[1], v[2], v[3]);
  } else {
    mq[i] = m[0];
    vq[i] = v[0];
  }
}

template <typename G, typename O, int VEC, bool STASH>
__global__ void __launch_bounds__(THREADS) fused_adam8_kernel(
    const G* __restrict__ g, const int8_t* mq, const float* ms,
    const uint8_t* vq, const float* vs, const float* p,
    const float* __restrict__ gscale, float* p_out, O* __restrict__ pc_out,
    int8_t* mq_out, float* ms_out, uint8_t* vq_out, float* vs_out, long rows,
    int R, int tpr, Hyper h) {
  extern __shared__ float stash[];   // STASH: [rows per CTA][2][R] f32
  __shared__ float red_m[THREADS / 32], red_v[THREADS / 32];
  const int rpc = THREADS / tpr;
  const int sub = threadIdx.x / tpr;     // this thread's row in the CTA
  const int lt = threadIdx.x % tpr;      // and its rank in the row
  const long row = (long)blockIdx.x * rpc + sub;
  const bool live = row < rows;
  const long base = row * (long)R;
  const float gs = *gscale;
  float* m_st = stash + (long)sub * 2 * R;
  float* v_st = m_st + R;
  // the old scales, read by every thread before any new one is stored
  const float m_s = live ? ms[row] : 0.f;
  const float v_s = live ? vs[row] : 0.f;

  float amax_m = 0.f, amax_v = 0.f;
  if (live) {
    for (int e = lt * VEC; e < R; e += tpr * VEC) {
      float gv[VEC], pv[VEC], pn[VEC];
      int mc[VEC], vc[VEC];
      load_g<VEC>(g, base + e, gv);
      load_codes<VEC>(mq, vq, base + e, mc, vc);
      load_f32<VEC>(p, base + e, pv);
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        float mn, vn;
        pn[k] = adam_elem(gv[k], mc[k], vc[k], pv[k], m_s, v_s, gs, h, mn,
                          vn);
        amax_m = fmaxf(amax_m, fabsf(mn));
        amax_v = fmaxf(amax_v, vn);
        if constexpr (STASH) {
          m_st[e + k] = mn;
          v_st[e + k] = vn;
        }
      }
      if constexpr (STASH) {
        store_f32<VEC>(p_out, base + e, pn);
        store_cast<VEC>(pc_out, base + e, pn);
      }
    }
  }
  amax_m = warp_max(amax_m);
  amax_v = warp_max(amax_v);
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    red_m[warp] = amax_m;
    red_v[warp] = amax_v;
  }
  // after this barrier every read of the old codes, master and scales is
  // done, so pass 2 may overwrite them in place
  __syncthreads();
  const int wpr = tpr / 32;
  float rm = 0.f, rv = 0.f;
  for (int w = sub * wpr; w < (sub + 1) * wpr; ++w) {
    rm = fmaxf(rm, red_m[w]);
    rv = fmaxf(rv, red_v[w]);
  }
  const float scale_m = rm > 0.f ? __fdiv_rn(rm, 127.f) : 1.f;
  const float denom_v = rv > 0.f ? rv : 1.f;
  if (!live) return;
  for (int e = lt * VEC; e < R; e += tpr * VEC) {
    float mn[VEC], vn[VEC];
    if constexpr (STASH) {
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        mn[k] = m_st[e + k];
        vn[k] = v_st[e + k];
      }
    } else {
      float gv[VEC], pv[VEC], pn[VEC];
      int mc[VEC], vc[VEC];
      load_g<VEC>(g, base + e, gv);
      load_codes<VEC>(mq, vq, base + e, mc, vc);
      load_f32<VEC>(p, base + e, pv);
#pragma unroll
      for (int k = 0; k < VEC; ++k)
        pn[k] = adam_elem(gv[k], mc[k], vc[k], pv[k], m_s, v_s, gs, h, mn[k],
                          vn[k]);
      store_f32<VEC>(p_out, base + e, pn);
      store_cast<VEC>(pc_out, base + e, pn);
    }
    int8_t qm[VEC];
    uint8_t qv[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      qm[k] = code_m(mn[k], scale_m);
      qv[k] = code_v(vn[k], denom_v);
    }
    store_codes<VEC>(mq_out, vq_out, base + e, qm, qv);
  }
  if (lt == 0) {
    ms_out[row] = scale_m;
    vs_out[row] = rv;
  }
}

template <typename G, typename O, int VEC, bool STASH>
int launch(const void* const* in, void* const* out, long rows, int R,
           const Hyper& h, cudaStream_t stream) {
  // threads per row: enough for one vector group each, 32 at least
  int tpr = 32;
  while (tpr < THREADS && tpr * VEC < R) tpr *= 2;
  const int rpc = THREADS / tpr;
  const size_t smem = STASH ? (size_t)rpc * 2 * R * sizeof(float) : 0;
  auto kern = fused_adam8_kernel<G, O, VEC, STASH>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long grid = (rows + rpc - 1) / rpc;
  kern<<<(unsigned)grid, THREADS, smem, stream>>>(
      static_cast<const G*>(in[0]), static_cast<const int8_t*>(in[1]),
      static_cast<const float*>(in[2]), static_cast<const uint8_t*>(in[3]),
      static_cast<const float*>(in[4]), static_cast<const float*>(in[5]),
      static_cast<const float*>(in[6]), static_cast<float*>(out[0]),
      static_cast<O*>(out[1]), static_cast<int8_t*>(out[2]),
      static_cast<float*>(out[3]), static_cast<uint8_t*>(out[4]),
      static_cast<float*>(out[5]), rows, R, tpr, h);
  return (int)cudaGetLastError();
}

template <typename G, typename O>
int dispatch(const void* const* in, void* const* out, long rows, int R,
             const Hyper& h, bool vec, cudaStream_t st) {
  // rows fit in shared memory: at most 256/32 = 8 rows of R <= 128 a CTA,
  // else one row of R <= 25600
  int tpr = 32;
  while (tpr < THREADS && tpr * (vec ? 4 : 1) < R) tpr *= 2;
  const bool stash =
      (size_t)(THREADS / tpr) * 2 * R * sizeof(float) <= STASH_MAX_BYTES;
  if (vec)
    return stash ? launch<G, O, 4, true>(in, out, rows, R, h, st)
                 : launch<G, O, 4, false>(in, out, rows, R, h, st);
  return stash ? launch<G, O, 1, true>(in, out, rows, R, h, st)
               : launch<G, O, 1, false>(in, out, rows, R, h, st);
}

}  // namespace

// dtypes: bit 0 the gradient's (0 f32, 1 bf16), bit 1 the cast's (0 f32,
// 1 bf16).  lr, c1, c2, b1, 1 - b1, b2, 1 - b2, eps, wd as f32 values of the
// host's doubles; gscale a device pointer to one f32.  Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for a bad
// shape or dtype).
extern "C" int dstt_fused_adam8(
    const void* g, const void* mq, const void* ms, const void* vq,
    const void* vs, const void* p, const void* gscale, void* p_out,
    void* pc_out, void* mq_out, void* ms_out, void* vq_out, void* vs_out,
    long long rows, int R, float lr, float c1, float c2, float b1,
    float omb1, float b2, float omb2, float eps, float wd, int adam_w,
    int dtypes, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || R <= 0 || dtypes < 0 || dtypes > 3)
    return (int)cudaErrorInvalidValue;
  const Hyper h{lr, c1, c2, b1, omb1, b2, omb2, eps, wd, adam_w};
  const void* in[7] = {g, mq, ms, vq, vs, p, gscale};
  void* out[6] = {p_out, pc_out, mq_out, ms_out, vq_out, vs_out};
  bool vec = R % 4 == 0;
  const void* ptrs[8] = {g, mq, vq, p, p_out, pc_out, mq_out, vq_out};
  for (int i = 0; i < 8; ++i)
    vec = vec && (reinterpret_cast<uintptr_t>(ptrs[i]) % 16 == 0);
  const bool g_bf16 = dtypes & 1, o_bf16 = dtypes & 2;
  if (g_bf16 && o_bf16)
    return dispatch<bf16, bf16>(in, out, rows, R, h, vec, st);
  if (g_bf16)
    return dispatch<bf16, float>(in, out, rows, R, h, vec, st);
  if (o_bf16)
    return dispatch<float, bf16>(in, out, rows, R, h, vec, st);
  return dispatch<float, float>(in, out, rows, R, h, vec, st);
}
