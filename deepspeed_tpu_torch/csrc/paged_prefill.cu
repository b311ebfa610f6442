// Causal blocked-flash prefill over the paged KV arena, for Hopper (sm_90a).
//
// Replaces the TPU kernel deepspeed_tpu/ops/paged_prefill.py
// `paged_prefill_attention` (pallas_call body `_kernel`): C chunk queries
// at absolute positions pos0 .. pos0+C-1 attend the keys their block table
// points at, under key_pos <= q_pos and, when window > 0, key_pos > q_pos -
// window; online softmax in f32; neither the gathered K/V copy nor the
// score matrix is ever written to device memory.
//
// Layout: q [C, NH, D]; arena k/v [L, nb, bs, NKV, D] addressed at layer
// `layer_off` (an element offset: the full arena is passed, never a layer
// slice); table [MB] int32, entries clamped to [0, nb-1] like the
// reference; out [C, NH, D].
//
// Grid: (ceil(C/64), NH), one CTA per 64-query tile of one head; every
// C >= 1 is served (the ragged last tile is masked; there
// is no VMEM-driven tile plan on this card).  A CTA walks keys from the
// window's start for its first query up to its last VALID query
// (pos0 + min(c0+64, n_valid) - 1), so key blocks past the chunk's valid
// rows are never read.  Rows c >= n_valid are padding the caller drops.
// The tile core and what bounds it: attn_tile.cuh.
#include "attn_tile.cuh"

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

template <typename T, int D>
__global__ void __launch_bounds__(dstt::launch_threads<T>())
paged_prefill_kernel(const T* __restrict__ q, const T* __restrict__ ak,
                     const T* __restrict__ av, const int* __restrict__ table,
                     T* __restrict__ o, int C, int NH, int NKV, int nb,
                     int bs, int MB, long layer_off, int pos0, int n_valid,
                     int window, float sm_scale) {
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
  dstt::attn_tile_any<T, D>(q + base, row_stride, ak, av, key_off,
                            o + base, row_stride, nullptr, n_rows, qpos0,
                            true, window, k_begin, k_end, sm_scale);
}

template <typename T, int D>
int launch(const void* q, const void* ak, const void* av, const void* table,
           void* o, int C, int NH, int NKV, int nb, int bs, int MB,
           long long layer_off, int pos0, int n_valid, int window,
           cudaStream_t stream) {
  const int smem = dstt::launch_smem_bytes<T>(D);
  cudaError_t err = cudaFuncSetAttribute(
      paged_prefill_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((C + dstt::BQ - 1) / dstt::BQ, NH);
  paged_prefill_kernel<T, D><<<grid, dstt::launch_threads<T>(), smem,
                               stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(ak),
      static_cast<const T*>(av), static_cast<const int*>(table),
      static_cast<T*>(o), C, NH, NKV, nb, bs, MB, (long)layer_off, pos0,
      n_valid, window, 1.0f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; window <= 0 means no sliding window.
// Returns cudaGetLastError() after the launch.
extern "C" int dstt_paged_prefill(const void* q, const void* ak,
                                  const void* av, const void* table, void* o,
                                  int C, int NH, int NKV, int D, int nb,
                                  int bs, int MB, long long layer_off,
                                  int pos0, int n_valid, int window,
                                  int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (C <= 0 || NKV <= 0 || NH % NKV != 0 || nb <= 0 || bs <= 0 || MB <= 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == 1) {
    if (D == 32)
      return launch<__nv_bfloat16, 32>(q, ak, av, table, o, C, NH, NKV, nb,
                                       bs, MB, layer_off, pos0, n_valid,
                                       window, st);
    if (D == 64)
      return launch<__nv_bfloat16, 64>(q, ak, av, table, o, C, NH, NKV, nb,
                                       bs, MB, layer_off, pos0, n_valid,
                                       window, st);
    if (D == 128)
      return launch<__nv_bfloat16, 128>(q, ak, av, table, o, C, NH, NKV, nb,
                                        bs, MB, layer_off, pos0, n_valid,
                                        window, st);
  } else if (dtype == 0) {
    if (D == 32)
      return launch<float, 32>(q, ak, av, table, o, C, NH, NKV, nb, bs, MB,
                               layer_off, pos0, n_valid, window, st);
    if (D == 64)
      return launch<float, 64>(q, ak, av, table, o, C, NH, NKV, nb, bs, MB,
                               layer_off, pos0, n_valid, window, st);
    if (D == 128)
      return launch<float, 128>(q, ak, av, table, o, C, NH, NKV, nb, bs, MB,
                                layer_off, pos0, n_valid, window, st);
  }
  return (int)cudaErrorInvalidValue;
}
