// The block-sparse forward's gathered, owner-masked score tile
// (sparse_flash.cu `sparse_fwd_wgmma`; hopper_selftest.cu checks it
// alone, since a wrong index here gives wrong numbers, not a fault).
//
// A CTA owns R = 64 / BLK query blocks of one head: its 64 query rows
// (row r belongs to owner r / BLK) are the M side of an m64n64 product.
// A step gathers G = 64 / BLK key blocks of the union of the owners'
// lists (ops/sparse_flash.py `tile_walk`): the N side, columns
// [BLK gi, BLK gi + BLK) from the step's entry gi, which is -1 (a
// padding slot at the list's tail, loaded as zeros) or (key block << 4)
// | mask, bit o of the mask set where owner o visits that block.
#pragma once

#include "hopper_tile.cuh"

namespace dstt {
namespace sparse {

constexpr float NEG_INF = -1e30f;   // the TPU kernel's sentinel

// Scores of one step in place: accumulator element i of the m64n64 tile
// (thread (warp, g, t): rows 16 warp + g + 8 hh, hh = i / 2 % 2; column
// 8 (i / 4) + 2 t + i % 2) times scale_log2, or NEG_INF where the key is
// not visible to the row: its entry is -1, the row's owner `obit[hh]`
// has its mask bit clear, or (causal) the key's position is past the
// row's `qpos[hh]`.
template <int BLK>
__device__ __forceinline__ void mask_scores(float (&sc)[32],
                                            const int (&ent)[64 / BLK],
                                            const int (&obit)[2],
                                            const int (&qpos)[2], int t,
                                            int causal, float scale_log2) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int e = ent[8 * (i >> 2) / BLK];   // 2 t + 1 < 8 <= BLK
    const int hh = (i >> 1) & 1;
    const int kp = (e >> 4) * BLK + 8 * (i >> 2) % BLK + 2 * t + (i & 1);
    const bool vis = e >= 0 && ((e >> obit[hh]) & 1) &&
                     (!causal || kp <= qpos[hh]);
    sc[i] = vis ? sc[i] * scale_log2 : NEG_INF;
  }
}

// One step's gathered tile of one operand: G = 64 / BLK boxes of BLK
// rows (one TMA box per entry and D-column chunk) at rows i BLK of the
// 64-row tile `dst` (chunks of 64 rows x CH columns, 64 RB bytes apart);
// a -1 entry loads rows from S on, which the map fills with zeros.
template <int D, int BLK>
__device__ __forceinline__ void gather_boxes(uint8_t* dst,
                                             const CUtensorMap* map,
                                             uint64_t* bar, const int* ent,
                                             int h, int b, int S) {
  using T = hopper::RowTile<D>;
#pragma unroll
  for (int i = 0; i < 64 / BLK; ++i) {
    const int e = ent[i];
    const int k0 = e >= 0 ? (e >> 4) * BLK : S;
#pragma unroll
    for (int c = 0; c < T::NCH; ++c)
      hopper::tma_load_4d(dst + c * 64 * T::RB + i * BLK * T::RB, map, bar,
                          c * T::CH, h, k0, b);
  }
}

}  // namespace sparse
}  // namespace dstt
