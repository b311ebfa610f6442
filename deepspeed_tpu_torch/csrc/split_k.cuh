// Split-K merge shared by the port's split GEMMs (tile_matmul.cu,
// moe_grouped.cu): each split's CTA stores its f32 partial to a
// [splits, M, N] workspace and takes an integer ticket of its output
// tile; the CTA that takes the last one adds the partials in split order
// (so a rerun is bit-identical: no float atomics) and sets the ticket
// back to 0 for the next call on the stream.
#pragma once

#include "hopper_tile.cuh"

namespace dstt {

// K tiles [t0, t1) of split `split` out of `splits` over nkt tiles; the
// host plans compute the same ranges (tp_matmul.tile_plan,
// moe_grouped.grouped_plan)
__device__ __forceinline__ void split_range(int split, int splits, int nkt,
                                            int& t0, int& t1) {
  t0 = (int)((long)split * nkt / splits);
  t1 = (int)((long)(split + 1) * nkt / splits);
}

// Split-K, between the halves: after each consumer thread stored its
// share of the partial, take a ticket of the output tile and return
// whether this CTA took the last one (then it sums the partials).
// `bar_id` / `threads` name the consumers' barrier, `leader` one of them.
__device__ __forceinline__ bool take_ticket(int* __restrict__ ticket,
                                            int* last, int splits,
                                            int bar_id, int threads,
                                            bool leader) {
  __threadfence();
  hopper::named_sync(bar_id, threads);
  if (leader) *last = atomicAdd(ticket, 1) == splits - 1;
  hopper::named_sync(bar_id, threads);
  if (*last) __threadfence();
  return *last;
}

// Split-K, second half (the last CTA of an output tile): out = ws[0] +
// ws[1] + ... + ws[splits-1], added in that order, over rows [m0, m0 +
// rows) and columns [n0, n0 + BN) of the tile, 16-byte chunks spread
// over the CTA's `threads` consumers, BATCH splits' loads in flight at a
// time; then the ticket is reset for the next call on this stream.
template <int BN, int BATCH>
__device__ __forceinline__ void sum_partials(
    float* __restrict__ out, const float* __restrict__ ws,
    int* __restrict__ ticket, int M, int N, int m0, int rows, int n0,
    int splits, int tid, int threads) {
  constexpr int C4 = BN / 4;   // 16-byte chunks per tile row
  const long mn = (long)M * N;
  for (int i = tid; i < rows * C4; i += threads) {
    const int col = n0 + (i % C4) * 4;
    if (col >= N) continue;     // N % 8 == 0: a chunk is in or out
    const long off = (long)(m0 + i / C4) * N + col;
    float4 sum = __ldcg(reinterpret_cast<const float4*>(ws + off));
    for (int sp = 1; sp < splits; sp += BATCH) {
      float4 p[BATCH];
#pragma unroll
      for (int b = 0; b < BATCH; ++b)
        p[b] = sp + b < splits
                   ? __ldcg(reinterpret_cast<const float4*>(
                         ws + (sp + b) * mn + off))
                   : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int b = 0; b < BATCH; ++b) {
        if (sp + b >= splits) break;
        sum.x += p[b].x;
        sum.y += p[b].y;
        sum.z += p[b].z;
        sum.w += p[b].w;
      }
    }
    *reinterpret_cast<float4*>(out + off) = sum;
  }
  if (tid == 0) *ticket = 0;
}

}  // namespace dstt
