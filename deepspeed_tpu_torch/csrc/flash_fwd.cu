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
// Grid: (ceil(S/64), NH, B), one CTA per 64-row query tile of one head;
// the tile core is attn_tile.cuh (tensor cores for bf16, CUDA cores for
// f32; its note says what bounds each).  Causal CTAs walk keys
// [0, q0 + rows) only.
#include "attn_tile.cuh"

namespace {

struct DenseKeyOff {
  long base, stride;
  __device__ __forceinline__ long operator()(int kp) const {
    return base + (long)kp * stride;
  }
};

template <typename T, int D>
__global__ void __launch_bounds__(dstt::launch_threads<T>())
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
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
  dstt::attn_tile_any<T, D>(q + base, row_stride, k, v, key_off, o + base,
                            row_stride, lse + ((long)b * NH + h) * S + q0,
                            n_rows, q0, causal != 0, 0, 0, k_end, sm_scale);
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int B, int S, int NH, int NKV, int causal, cudaStream_t stream) {
  const int smem = dstt::launch_smem_bytes<T>(D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + dstt::BQ - 1) / dstt::BQ, NH, B);
  flash_fwd_kernel<T, D><<<grid, dstt::launch_threads<T>(), smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      S, NH, NKV, causal, 1.0f / sqrtf((float)D));
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
      return launch<__nv_bfloat16, 32>(q, k, v, o, lse, B, S, NH, NKV,
                                       causal, st);
    if (D == 64)
      return launch<__nv_bfloat16, 64>(q, k, v, o, lse, B, S, NH, NKV,
                                       causal, st);
    if (D == 128)
      return launch<__nv_bfloat16, 128>(q, k, v, o, lse, B, S, NH, NKV,
                                        causal, st);
  } else if (dtype == 0) {
    if (D == 32)
      return launch<float, 32>(q, k, v, o, lse, B, S, NH, NKV, causal, st);
    if (D == 64)
      return launch<float, 64>(q, k, v, o, lse, B, S, NH, NKV, causal, st);
    if (D == 128)
      return launch<float, 128>(q, k, v, o, lse, B, S, NH, NKV, causal, st);
  }
  return (int)cudaErrorInvalidValue;
}
