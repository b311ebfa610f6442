// 64-key tiles of the paged KV arena by TMA, shared by the TMA kernels of
// paged_prefill.cu (paged_prefill_wgmma) and paged_decode.cu
// (paged_decode_tma).
//
// The arena [L, nb, bs, NKV, D] (or the merged [L, nb, bs, NKV * D], the
// same bytes) is seen by one 4-D tensor map as [L * nb pages, bs rows,
// NKV heads, D], so a layer is a page offset (layer * nb) and a box of
// one kv head's rows has a row pitch of NKV * D elements.  A tile holds
// 64 consecutive key positions of one kv head, in the layout that
// hopper_tile.cuh's RowTile<D> describes (CH-column boxes of 64 rows,
// swizzled as TMA writes them: 64 columns at D 64 / 128, 32 at D 32 /
// 96, 16 at D 80): at bs <= 64 it is 64 / bs pages of one
// box each, at bs >= 64 one 64-row part of a page.  So a bs that TMA can
// tile this way is 8, 16, 32 or a multiple of 64 (a box of bs rows must
// start on the swizzle's 8-row repeat); other block sizes stay on the
// mma.sync kernels (`tma_block_size`, mirrored by the wrappers' rules).
#pragma once

#include "hopper_tile.cuh"

namespace dstt {
namespace paged {

namespace hp = dstt::hopper;

constexpr int TK = 64;   // keys a tile

inline bool tma_block_size(int bs) {
  return bs == 8 || bs == 16 || bs == 32 || (bs >= TK && bs % TK == 0);
}

// The arena's 4-D map of bf16 elements: [L * nb, bs, NKV, D] with boxes of
// min(bs, 64) rows of one head's CH columns.  Returns 0 or a CUDA error.
template <int D>
inline int arena_map(CUtensorMap* map, const void* arena, int L, int nb,
                     int bs, int NKV) {
  using T = hp::RowTile<D>;
  const uint64_t dims[4] = {(uint64_t)D, (uint64_t)NKV, (uint64_t)bs,
                            (uint64_t)L * nb};
  const uint64_t strides[3] = {(uint64_t)D * 2, (uint64_t)NKV * D * 2,
                               (uint64_t)bs * NKV * D * 2};
  const uint32_t box[4] = {(uint32_t)T::CH, 1,
                           (uint32_t)(bs < TK ? bs : TK), 1};
  return hp::make_map_bf16(map, arena, 4, dims, strides, box, T::SW);
}

// The arena blocks of a run of TMA boxes, 32 at a time in a producer
// warp's lanes: box i of the run holds keys [key0 + i rows, + rows) (rows
// = min(bs, 64)), and lane l holds the clamped table entry of box w0 + l,
// so the loads of many tiles wait on one table read.  Table entries are
// clamped to [0, nb - 1]; a page past the table (a tile that runs past
// MB * bs keys) reads the table's last entry, whose keys the kernels mask.
// Every lane of the warp calls `block` (it shuffles), with the same box.
struct BoxPages {
  const int* table;
  int MB, nb, bs, rows, key0;
  int w0 = -64, blk = 0;

  __device__ __forceinline__ int block(int box, int lane) {
    if (box < w0 || box >= w0 + 32) {   // warp-uniform
      w0 = box;
      const int j = min((key0 + (box + lane) * rows) / bs, MB - 1);
      blk = min(max(__ldg(table + j), 0), nb - 1);
    }
    return __shfl_sync(0xffffffffu, blk, box - w0);
  }
};

// Issue (lane 0) the TMA boxes of the 64-key tile whose first box is
// `box0` of `pages`' run, kv head `kvh`, into `dst`, completing on `bar`
// (which expects TK * D * 2 bytes): 64 / bs pages of one box at bs <= 64,
// a 64-row part of one page at bs >= 64.  Every lane of the warp calls it.
template <int D>
__device__ __forceinline__ void load_tile(uint8_t* dst, const CUtensorMap* map,
                                          uint64_t* bar, BoxPages& pages,
                                          int box0, int page0, int kvh,
                                          int lane) {
  using T = hp::RowTile<D>;
  for (int p = 0; p < TK / pages.rows; ++p) {
    const int box = box0 + p;
    const int blk = pages.block(box, lane);
    const int key = pages.key0 + box * pages.rows;
    if (lane == 0) {
#pragma unroll
      for (int c = 0; c < T::NCH; ++c)
        hp::tma_load_4d(dst + c * TK * T::RB + p * pages.rows * T::RB, map,
                        bar, c * T::CH, kvh, key % pages.bs, page0 + blk);
    }
  }
}

// The 16-byte chunk c (of D / 8) of row r of a tile as TMA wrote it: box
// c / (CH / 8), chunk c % (CH / 8) XOR the swizzle's row pattern.
template <int D>
__device__ __forceinline__ const uint4* tile_chunk(const uint8_t* tile, int r,
                                                   int c) {
  using T = hp::RowTile<D>;
  constexpr int PER = T::CH / 8;
  return reinterpret_cast<const uint4*>(
      tile + (c / PER) * TK * T::RB + r * T::RB +
      (((c % PER) ^ T::row_xor(r)) << 4));
}

// Zero whole rows [0, lo) and [hi, TK) of a tile (every box of a row, so
// the swizzle does not matter), by `threads` threads from `tid`; the
// caller fences the async proxy and syncs before a wgmma reads the tile.
template <int D>
__device__ __forceinline__ void zero_rows(uint8_t* tile, int lo, int hi,
                                          int tid, int threads) {
  using T = hp::RowTile<D>;
  constexpr int PER_ROW = D / 8;   // 16-byte chunks a row, over all boxes
  for (int i = tid; i < TK * PER_ROW; i += threads) {
    const int r = i / PER_ROW, c = i % PER_ROW;
    if (r >= lo && r < hi) continue;
    *reinterpret_cast<uint4*>(tile + (c / (T::CH / 8)) * TK * T::RB +
                              r * T::RB + ((c % (T::CH / 8)) << 4)) =
        make_uint4(0u, 0u, 0u, 0u);
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

}  // namespace paged
}  // namespace dstt
