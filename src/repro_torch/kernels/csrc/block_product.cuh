// block_product.cuh — the gated binary x int32 block product shared by the
// port's two timestep kernels (spike_timestep.cu, spike_timestep_fused.cu).
//
// Both kernels add weight rows of spiking sources into int32 accumulators,
// 128 neuron columns at a time. A CTA lists the spiking (slot, row) pairs
// of its work, slot-major and ascending, and each warp takes an even share
// of the list, whatever the slots: it reads each listed row as 16-byte
// vectors (one warp covers the 128 columns, 4 a lane), several rows in
// flight, adds them into 4 register accumulators a lane, and adds those
// into the CTA's shared per-slot sums with shared atomics when its slot
// changes and at the end. The sums of several CTAs are then added in
// global memory with atomicAdd.
//
// Why any split of the rows gives the same bits:
//   exact mode: every add is a uint32 add, which wraps mod 2^32 and is
//     associative and commutative, so partial sums over any split of the
//     rows, added in any order (atomicAdd on uint32 included), give the
//     bits of the sequential sum.
//   f32 mode: each 128-source block is summed in fp32 FMA and truncated
//     toward zero (__float2int_rz, as JAX's astype(int32)) before the
//     uint32 accumulate. The engine admits a weight image only while every
//     column sum of |w| over a 128-row block stays under 2^24
//     (mxu_partial_sum_bound, core/engine.py). Sources are {0,1}, so every
//     partial sum of any subset of a block's rows is an integer of
//     magnitude < 2^24, exactly representable in fp32, and every FMA along
//     the way is exact. Truncating the partial sum of each piece of a split
//     block therefore gives integers whose wrapping sum is the truncated
//     sum of the whole block.

#pragma once

#include <cstdint>

namespace blockprod {

constexpr int kBlockSrc = 128;        // sources per gate block
constexpr int kTileCols = 128;        // neuron columns per warp, 4 per lane
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr uint32_t kRowBits = 0xFFFFFFu;  // row of a list entry
constexpr int kSlotShift = 24;            // entry = row | slot << 24

__device__ __forceinline__ void flush_f32(float (&facc)[4],
                                          uint32_t (&acc)[4]) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    acc[c] += static_cast<uint32_t>(__float2int_rz(facc[c]));
    facc[c] = 0.0f;
  }
}

// s_acc[slot][col + c] += coef(e) * w[row(e)][col + c] for every entry e
// of the warp's share of a (slot, row) list, slot-major and ascending,
// c = 0..3: the lane's four columns of its 128-column tile, kLoads rows'
// 16-byte loads in flight. `col` is the lane's first column in `w` (a
// multiple of 4, `w` 16-byte aligned); s_acc is the CTA's [slot][128]
// shared sums of that tile. In f32 mode the rows of one 128-row block are
// summed in fp32 and truncated when the block or the slot changes and at
// the end. Every lane walks the same list, so each branch is uniform.
template <bool F32, int kLoads, class Coef>
__device__ __forceinline__ void warp_rows(const uint32_t* list, int n,
                                          const int32_t* __restrict__ w,
                                          int ld, int col, const Coef& coef,
                                          uint32_t* s_acc, int lane) {
  if (n <= 0) return;
  uint32_t acc[4] = {0u, 0u, 0u, 0u};
  float facc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  // slot << kSlotKey | the row's 128-row block: a change ends a piece
  constexpr int kSlotKey = kSlotShift - 7;
  uint32_t key = list[0] >> 7;
  const auto add_to_slot = [&](uint32_t slot) {
    uint32_t* dst = s_acc + slot * kTileCols + lane * 4;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      atomicAdd(dst + c, acc[c]);
      acc[c] = 0u;
    }
  };
  for (int i0 = 0; i0 < n; i0 += kLoads) {
    uint32_t ent[kLoads];
    int4 wv[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      if (i0 + u < n) {
        ent[u] = list[i0 + u];
        wv[u] = __ldg(reinterpret_cast<const int4*>(
            w + static_cast<size_t>(ent[u] & kRowBits) * ld + col));
      }
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      if (i0 + u >= n) break;
      const uint32_t k2 = ent[u] >> 7;
      if (k2 != key) {
        if (F32) flush_f32(facc, acc);
        if ((k2 >> kSlotKey) != (key >> kSlotKey))
          add_to_slot(key >> kSlotKey);
        key = k2;
      }
      const int32_t cf = coef(ent[u]);
      const int32_t wc[4] = {wv[u].x, wv[u].y, wv[u].z, wv[u].w};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (F32) {
          facc[c] = __fmaf_rn(static_cast<float>(cf),
                              static_cast<float>(wc[c]), facc[c]);
        } else {
          acc[c] += static_cast<uint32_t>(cf) * static_cast<uint32_t>(wc[c]);
        }
      }
    }
  }
  if (F32) flush_f32(facc, acc);
  add_to_slot(key >> kSlotKey);
}

}  // namespace blockprod
