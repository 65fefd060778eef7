// spike_timestep_fused.cu — K event-gated Cerebra-H timesteps in one call,
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `spike_timestep_fused_kernel`
// (src/repro/kernels/spike_timestep.py, built by `build_spike_timestep_fused`),
// which backs the JAX engine's `fuse_steps > 1` window on the "pallas" and
// "pallas-mxu" backends. It computes the same function:
//
//   ext_syn[k]  = ext[k] @ W_ext  for every step k of the window, skipping
//                 every 128-source block whose window-OR gate scalar is 0
//   for k in 0..K-1:
//     syn      = ext_syn[k] + spikes @ W_rec     (the carry of step k-1)
//     v', s    = LIF(v, syn)                     lif.cuh
//     v, spikes = active[k] ? (v', s) : (v, spikes)
//     raster[k] = active[k] ? s : 0
//
// with every add wrapping mod 2^32. The external spikes arrive bitpacked,
// 32 sources per 32-bit lane (source s = lane s/32, bit s%32).
//
// What bounds it: bytes. A window must read the scheduled W_ext blocks once
// and the W_rec rows of each step's spiking neurons, and write the (K, B, P)
// raster and the carries: ~7.7 MB, ~2.3 us at 3.35 TB/s for a served K = 8
// window of the slice (B 8, 1568 inputs, P 1024). The recurrent leg also
// has a chain of K dependent steps, each a round of L2 loads and a cluster
// barrier. Run as one cluster per batch tile for the whole window (8 CTAs
// under the batch-tile gate), the external leg alone was ~10^5 dependent
// iterations per thread before the first step.
//
// Design: two legs, two launches from the one entry point, on one stream
// after a memset of the raster (a CUDA graph captures all three; nothing is
// kept between calls).
//   * External leg, no step-to-step dependence, spread over the card:
//     grid = (P/128 neuron tiles, n_ext/128 external blocks, B/BB batch
//     tiles), 8 warps per CTA: 8 x 13 = 104 CTAs under the batch-tile gate
//     at the slice. A CTA whose window-OR gate scalar is 0 exits at once.
//     Otherwise it reads the block's spike lanes of its K x BB (step, slot)
//     rows and copies its 128 columns of the rows that spike anywhere in
//     the window into shared memory (cp.async, 16 bytes a lane, all in
//     flight): each active block is fetched ONCE per window, the property
//     events/trace.fused_block_traffic counts. Each warp then takes (step,
//     slot) rows, lists the row's spikes in the block with four ballots,
//     and adds the listed staged rows, 8 at a time (16-byte shared loads, 4
//     columns a lane): the product does only the work of the spikes, and
//     its time is the shared-memory reads of one 512-byte row per spike.
//     The row's 128 partials go into the raster, zeroed by this entry
//     point, with wrapping atomicAdd, each instruction on 128 contiguous
//     bytes.
//   * Recurrent leg, K steps, one thread-block CLUSTER of up to 8 CTAs per
//     batch tile: step k+1 reads every neuron's spike of step k, so the
//     neuron tiles of a batch tile meet once per step. CTA `rank` owns the
//     128-column tiles rank, rank + 8, ... with 16 warps. Each step, one
//     thread per spike word of the batch tile lists the spiking (slot, row)
//     pairs (a block-wide scan), and each warp takes an even share of that
//     list, whatever the slots, reading its W_rec rows 16 bytes a lane, 8
//     rows in flight, from global memory where the 50 MB L2 keeps W_rec
//     warm (block_product.cuh). A warp's sums join the per-slot shared accumulators with shared
//     atomics when its slot changes. (A list of rows with a BB-bit slot mask
//     costs BB multiply-adds a row, though a served row spikes in about one
//     slot; a warp per slot waits on the busiest slot.) The LIF epilogue,
//     its operands loaded before the product, runs one thread per (slot,
//     column). A warp's ballot is the 32-bit spike word of its 32 columns;
//     lanes 0..cluster-1 push it into every CTA's shared memory through
//     distributed shared memory, then `cluster.sync()`. The word buffer is
//     double buffered by step parity, so one barrier per step suffices; a
//     cluster is scheduled whole, so the barrier cannot deadlock. Only the
//     W_rec rows of neurons that spiked are read: skipping a silent source
//     adds exactly 0 in both modes.
//
// Accumulate modes, as in spike_timestep.cu:
//   exact (use_f32 = 0): uint32 wrapping adds, bit-exact always.
//   f32   (use_f32 = 1): each 128-row block, external and recurrent, is
//     summed in fp32 (no TF32, no fast-math) and truncated toward zero
//     (__float2int_rz) before the uint32 accumulate; a recurrent block
//     split between warps is truncated per piece. Exact while every block
//     sum stays under 2^24, which the engine enforces at build (the
//     argument is in block_product.cuh); the atomics add uint32 values, so
//     their order does not matter.

#include <cooperative_groups.h>

#include <cstdint>
#include <cuda_runtime.h>

#include "block_product.cuh"
#include "lif.cuh"

namespace cg = cooperative_groups;

namespace {

using blockprod::kBlockSrc;
using blockprod::kFull;
using blockprod::kTileCols;

constexpr int kLanesPerBlock = kBlockSrc / 32;  // packed lanes per block
constexpr int kExtWarps = 8;                    // external leg, per CTA
constexpr int kExtThreads = kExtWarps * 32;
constexpr int kExtLoads = 8;        // staged rows read at a time per warp
constexpr int kRecWarps = 16;                   // recurrent leg, per CTA
constexpr int kRecThreads = kRecWarps * 32;
constexpr int kPassWords = 256;     // spike words listed per pass
constexpr int kRecLoads = 8;        // W_rec rows in flight per warp
constexpr int kMaxCluster = 8;                  // portable cluster size
constexpr int kMaxSmem = 227 * 1024;

// Inclusive prefix sum of `x` over the warp.
__device__ __forceinline__ int warp_scan(int x, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  return x;
}

// 16-byte asynchronous copy global -> shared (cp.async.cg: L2 only).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

struct Params {
  const int32_t* act;      // (Bp / BB, n_ext / 128) window-OR gate scalars
  const uint32_t* ext;     // (K, Bp, n_ext / 32) packed external spikes
  const int32_t* w_ext;    // (n_ext, P)
  const int32_t* w_rec;    // (P, P)
  const int32_t* v;        // (Bp, P) carries at window entry
  const int32_t* spk0;     // (Bp, P)
  const int32_t* active;   // (K, Bp) advance mask
  int32_t* v_out;          // (Bp, P) carries at window exit
  int32_t* spk_out;        // (Bp, P)
  int32_t* raster;         // (K, Bp, P); first the external accumulators
  int K, Bp, n_ext, P;
  int decay_mode, shift, decay_raw, threshold, reset_mode;
};

// ---- external leg: one CTA per (neuron tile, external block, batch tile) --
template <int BB, bool F32>
__global__ void __launch_bounds__(kExtThreads)
fused_ext_kernel(const Params p) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int ns = p.n_ext / kBlockSrc;
  const int sb = blockIdx.y;
  const int tile_b = blockIdx.z;
  if (p.act[tile_b * ns + sb] == 0) return;  // event gate, uniform per CTA

  const int KB = p.K * BB;              // (step, slot) rows of the window
  const int L = p.n_ext / 32;           // packed lanes per batch row
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row0 = tile_b * BB;
  const int col0 = blockIdx.x * kTileCols;
  // all shared memory is dynamic: static bytes would lower the opt-in cap
  int32_t* s_w = reinterpret_cast<int32_t*>(smem);   // [128 rows][128 cols]
  uint32_t* s_union = smem + kBlockSrc * kTileCols;  // [4] window-OR lanes
  uint32_t* s_bits = s_union + kLanesPerBlock;       // [KB][4] spike lanes
  uint32_t* s_list = s_bits + KB * kLanesPerBlock    // [8][128] per warp
                     + warp * kBlockSrc;

  if (tid < kLanesPerBlock) s_union[tid] = 0u;
  __syncthreads();
  // the block's lanes of every (step, slot) row; lane l of a warp always
  // holds packed lane l % 4, so a shuffle OR leaves 4 shared atomics a warp
  uint32_t any = 0u;
  for (int i = tid; i < KB * kLanesPerBlock; i += kExtThreads) {
    const int f = i / kLanesPerBlock, l = i % kLanesPerBlock;
    const int k = f / BB, r = f - k * BB;
    const uint32_t u =
        p.ext[(static_cast<size_t>(k) * p.Bp + row0 + r) * L
              + sb * kLanesPerBlock + l];
    s_bits[i] = u;
    any |= u;
  }
#pragma unroll
  for (int o = kLanesPerBlock; o < 32; o <<= 1)
    any |= __shfl_xor_sync(kFull, any, o);
  if (lane < kLanesPerBlock && any != 0u) atomicOr(&s_union[lane], any);
  __syncthreads();

  // stage the rows that spike anywhere in the window, at their source
  // index: warp w copies rows w, w + 8, ..., 16 bytes a lane
  const int32_t* wb = p.w_ext + static_cast<size_t>(sb) * kBlockSrc * p.P
                      + col0 + lane * 4;
  for (int j = warp; j < kBlockSrc; j += kExtWarps) {
    if ((s_union[j >> 5] >> (j & 31)) & 1u)
      cp_async16(s_w + j * kTileCols + lane * 4,
                            wb + static_cast<size_t>(j) * p.P);
  }
  cp_async_wait_all();
  __syncthreads();

  // warp w takes (step, slot) rows w, w + 8, ...: it lists the row's
  // spikes in the block (lane l holds bits 4l..4l+3; any order will do),
  // then adds the staged weight rows of the list, kExtLoads at a time
  for (int f = warp; f < KB; f += kExtWarps) {
    const uint32_t nib = (s_bits[f * kLanesPerBlock + (lane >> 3)]
                          >> ((lane & 7) * 4)) & 0xFu;
    int n = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const bool on = ((nib >> b) & 1u) != 0u;
      const unsigned ball = __ballot_sync(kFull, on);
      if (on) s_list[n + __popc(ball & ((1u << lane) - 1u))] = lane * 4 + b;
      n += __popc(ball);
    }
    if (n == 0) continue;  // no spike of this row in the block
    __syncwarp();
    uint32_t acc[4] = {0u, 0u, 0u, 0u};
    float facc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int i0 = 0; i0 < n; i0 += kExtLoads) {
      int4 wv[kExtLoads];
#pragma unroll
      for (int u = 0; u < kExtLoads; ++u) {
        if (i0 + u < n) {
          const int j = static_cast<int>(s_list[i0 + u]);
          wv[u] =
              *reinterpret_cast<const int4*>(s_w + j * kTileCols + lane * 4);
        }
      }
#pragma unroll
      for (int u = 0; u < kExtLoads; ++u) {
        if (i0 + u >= n) break;
        const int32_t wc[4] = {wv[u].x, wv[u].y, wv[u].z, wv[u].w};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (F32) {
            facc[c] = __fadd_rn(facc[c], static_cast<float>(wc[c]));
          } else {
            acc[c] += static_cast<uint32_t>(wc[c]);
          }
        }
      }
    }
    // the row's 128 partials pass through the list buffer, so that each
    // atomic instruction of the warp covers 128 contiguous bytes
    __syncwarp();
    reinterpret_cast<uint4*>(s_list)[lane] =
        F32 ? make_uint4(static_cast<uint32_t>(__float2int_rz(facc[0])),
                         static_cast<uint32_t>(__float2int_rz(facc[1])),
                         static_cast<uint32_t>(__float2int_rz(facc[2])),
                         static_cast<uint32_t>(__float2int_rz(facc[3])))
            : make_uint4(acc[0], acc[1], acc[2], acc[3]);
    __syncwarp();
    const int k = f / BB, r = f - k * BB;
    uint32_t* dst = reinterpret_cast<uint32_t*>(p.raster)
                    + (static_cast<size_t>(k) * p.Bp + row0 + r) * p.P + col0;
#pragma unroll
    for (int c = 0; c < kTileCols; c += 32) {
      const uint32_t add = s_list[c + lane];
      if (add != 0u) atomicAdd(dst + c + lane, add);
    }
    __syncwarp();  // s_list is rewritten by the warp's next row
  }
}

// ---- recurrent leg: K steps, one cluster per batch tile ----

struct OneCoef {  // a listed spike adds its weight row once
  __device__ __forceinline__ int32_t operator()(uint32_t) const { return 1; }
};

template <int BB, bool F32>
__global__ void __launch_bounds__(kRecThreads)
fused_rec_kernel(const Params p) {
  constexpr int kOut = (BB * kTileCols + kRecThreads - 1) / kRecThreads;
  extern __shared__ __align__(16) uint32_t smem[];
  const int P = p.P, Bp = p.Bp, K = p.K;
  const int n_words = P / 32;            // spike words per batch row
  const int n_w = BB * n_words;          // spike words per batch tile

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int csize = static_cast<int>(cluster.num_blocks());
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tile_b = blockIdx.y;
  const int row0 = tile_b * BB;
  const int n_tiles = P / kTileCols;
  const int my_tiles = (n_tiles + csize - 1) / csize;
  uint32_t* s_acc = smem;                           // [my_tiles][BB][128]
  uint32_t* s_all = s_acc + my_tiles * BB * kTileCols;  // [2][BB][n_words]
  uint32_t* s_q = s_all + 2 * n_w;                  // [8192] (slot, row)
  uint32_t* s_wsum = s_q + kPassWords * 32;         // [16] warp counts

  // ---- carries in (own columns) ----
  for (int t = rank; t < n_tiles; t += csize) {
    for (int o = tid; o < BB * kTileCols; o += kRecThreads) {
      const size_t idx = static_cast<size_t>(row0 + o / kTileCols) * P
                         + t * kTileCols + o % kTileCols;
      p.v_out[idx] = p.v[idx];
      p.spk_out[idx] = p.spk0[idx];
    }
  }
  // spike words of the whole neuron axis at window entry, into buffer 0
  for (int i = warp; i < n_w; i += kRecWarps) {
    const int r = i / n_words, w = i - r * n_words;
    const unsigned bits = __ballot_sync(
        kFull, p.spk0[static_cast<size_t>(row0 + r) * P + w * 32 + lane] != 0);
    if (lane == 0) s_all[r * n_words + w] = bits;
  }
  // every CTA of the cluster runs before any distributed-shared write
  cluster.sync();

  for (int k = 0; k < K; ++k) {
    const uint32_t* prev = s_all + (k & 1) * n_w;
    uint32_t* next = s_all + ((k + 1) & 1) * n_w;
    for (int i = tid; i < my_tiles * BB * kTileCols; i += kRecThreads)
      s_acc[i] = 0u;
    // the epilogue's operands of the first own tile, loaded before the
    // product hides them
    int32_t e_syn[kOut], e_v[kOut], e_spk[kOut], e_act[kOut];
#pragma unroll
    for (int j = 0; j < kOut; ++j) {
      const int o = tid + j * kRecThreads;
      if (o < BB * kTileCols) {
        const int row = row0 + o / kTileCols;
        const size_t idx = static_cast<size_t>(row) * P + rank * kTileCols
                           + o % kTileCols;
        e_syn[j] = p.raster[static_cast<size_t>(k) * Bp * P + idx];
        e_v[j] = p.v_out[idx];
        e_spk[j] = p.spk_out[idx];
        e_act[j] = p.active[k * Bp + row];
      }
    }
    // kPassWords spike words at a time: one thread per word lists the
    // spiking (slot, row) pairs, slot-major and ascending; each warp then
    // takes an even share of the list, whatever the slots
    for (int base = 0; base < n_w; base += kPassWords) {
      const int wi = base + tid;
      const uint32_t word = tid < kPassWords && wi < n_w ? prev[wi] : 0u;
      const int cnt = __popc(word);
      const int incl = warp_scan(cnt, lane);
      if (lane == 31) s_wsum[warp] = static_cast<uint32_t>(incl);
      __syncthreads();
      int off = 0, total = 0;
#pragma unroll
      for (int w = 0; w < kRecWarps; ++w) {
        const int c = static_cast<int>(s_wsum[w]);
        off += w < warp ? c : 0;
        total += c;
      }
      if (word != 0u) {
        const uint32_t slot = static_cast<uint32_t>(wi / n_words);
        const int w_in = wi - static_cast<int>(slot) * n_words;
        int pos = off + incl - cnt;
        for (uint32_t m = word; m != 0u; m &= m - 1u)
          s_q[pos++] = static_cast<uint32_t>(w_in * 32 + __ffs(m) - 1)
                       | (slot << blockprod::kSlotShift);
      }
      __syncthreads();
      const int lo = warp * total / kRecWarps;
      const int hi = (warp + 1) * total / kRecWarps;
      for (int ti = 0, t = rank; t < n_tiles; ++ti, t += csize)
        blockprod::warp_rows<F32, kRecLoads>(
            s_q + lo, hi - lo, p.w_rec, P, t * kTileCols + lane * 4,
            OneCoef{}, s_acc + ti * BB * kTileCols, lane);
      __syncthreads();  // s_q and s_wsum are rewritten by the next pass
    }
    // LIF, one (slot, column) per thread; a warp's 32 columns share a slot
    for (int ti = 0, t = rank; t < n_tiles; ++ti, t += csize) {
      const int col0 = t * kTileCols;
#pragma unroll
      for (int j = 0; j < kOut; ++j) {
        const int o = tid + j * kRecThreads;
        if (o < BB * kTileCols) {  // uniform per warp
          const int r = o / kTileCols, c = o % kTileCols;
          const size_t idx = static_cast<size_t>(row0 + r) * P + col0 + c;
          const size_t ridx = static_cast<size_t>(k) * Bp * P + idx;
          if (ti > 0) {  // tiles past the first load their operands here
            e_syn[j] = p.raster[ridx];
            e_v[j] = p.v_out[idx];
            e_spk[j] = p.spk_out[idx];
            e_act[j] = p.active[k * Bp + row0 + r];
          }
          int32_t carry;
          if (e_act[j] != 0) {
            const uint32_t syn = static_cast<uint32_t>(e_syn[j])
                                 + s_acc[(ti * BB + r) * kTileCols + c];
            int32_t vo;
            carry = lif::step(e_v[j], syn, p.decay_mode, p.shift,
                              p.decay_raw, p.threshold, p.reset_mode, &vo);
            p.v_out[idx] = vo;
            p.spk_out[idx] = carry;
            p.raster[ridx] = carry;
          } else {  // paused slot: keep the carry, emit nothing
            carry = e_spk[j];
            p.raster[ridx] = 0;
          }
          const unsigned bits = __ballot_sync(kFull, carry != 0);
          if (lane < csize) {
            uint32_t* dst = cluster.map_shared_rank(next, lane);
            dst[r * n_words + (col0 + c) / 32] = bits;
          }
        }
      }
    }
    // the words are in every CTA; `next` of the step before is free again,
    // and s_acc may be zeroed
    cluster.sync();
  }
}

size_t ext_smem_bytes(int K, int bb) {
  return sizeof(uint32_t) * (static_cast<size_t>(kBlockSrc) * kTileCols
                             + (static_cast<size_t>(K) * bb + 1)
                                   * kLanesPerBlock
                             + static_cast<size_t>(kExtWarps) * kBlockSrc);
}

size_t rec_smem_bytes(int bb, int P) {
  const int n_tiles = P / kTileCols;
  const int csize = n_tiles < kMaxCluster ? n_tiles : kMaxCluster;
  const size_t my_tiles = (n_tiles + csize - 1) / csize;
  return sizeof(uint32_t) * (my_tiles * bb * kTileCols
                             + 2 * static_cast<size_t>(bb) * (P / 32)
                             + kPassWords * 32 + kRecWarps);
}

template <class Kernel>
cudaError_t allow_smem(Kernel kernel) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
}

template <int BB, bool F32>
cudaError_t launch(const Params& p, int csize, cudaStream_t stream) {
  auto ext_kernel = fused_ext_kernel<BB, F32>;
  auto rec_kernel = fused_rec_kernel<BB, F32>;
  // once per instantiation: allow the dynamic shared memory above 48 KB
  static const cudaError_t attr_err = [&] {
    const cudaError_t e = allow_smem(ext_kernel);
    return e != cudaSuccess ? e : allow_smem(rec_kernel);
  }();
  if (attr_err != cudaSuccess) return attr_err;

  const int n_tiles = p.P / kTileCols;
  ext_kernel<<<dim3(n_tiles, p.n_ext / kBlockSrc, p.Bp / BB), kExtThreads,
               ext_smem_bytes(p.K, BB), stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(csize, p.Bp / BB, 1);
  cfg.blockDim = dim3(kRecThreads, 1, 1);
  cfg.dynamicSmemBytes = rec_smem_bytes(BB, p.P);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, rec_kernel, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int BB>
cudaError_t launch_bb(bool use_f32, const Params& p, int csize,
                      cudaStream_t stream) {
  return use_f32 ? launch<BB, true>(p, csize, stream)
                 : launch<BB, false>(p, csize, stream);
}

}  // namespace

// Plain C entry point, loaded with ctypes. block_batch is 1 (per-example
// gate) or 8 (batch-tile gate). All arrays are 32-bit, row-major and
// contiguous, pre-padded by the wrapper: B % block_batch == 0,
// n_ext % 128 == 0 (n_ext > 0), P % 128 == 0; ext holds the packed lanes
// (K, B, n_ext / 32); act is (B / block_batch, n_ext / 128); w_ext and
// w_rec are 16-byte aligned. Zeroes the raster, then issues the external
// leg and the recurrent leg on `stream`; returns the first CUDA error (0 on
// success).
extern "C" int spike_timestep_fused_launch(
    const void* act, const void* ext, const void* w_ext, const void* w_rec,
    const void* v, const void* spk0, const void* active, void* v_out,
    void* spk_out, void* raster, int K, int B, int n_ext, int P,
    int block_batch, int use_f32, int decay_mode, int shift, int decay_raw,
    int threshold, int reset_mode, void* stream) {
  if (K <= 0 || B <= 0 || n_ext <= 0 || P <= 0 || block_batch <= 0 ||
      B % block_batch != 0 || n_ext % kBlockSrc != 0 || P % kTileCols != 0 ||
      P >= (1 << 24) || B / block_batch > 65535 ||
      n_ext / kBlockSrc > 65535 ||
      static_cast<long long>(K) * B * P > (1LL << 31) - 1 ||
      ext_smem_bytes(K, block_batch) > static_cast<size_t>(kMaxSmem) ||
      rec_smem_bytes(block_batch, P) > static_cast<size_t>(kMaxSmem) ||
      reinterpret_cast<uintptr_t>(w_ext) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(w_rec) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.act = static_cast<const int32_t*>(act);
  p.ext = static_cast<const uint32_t*>(ext);
  p.w_ext = static_cast<const int32_t*>(w_ext);
  p.w_rec = static_cast<const int32_t*>(w_rec);
  p.v = static_cast<const int32_t*>(v);
  p.spk0 = static_cast<const int32_t*>(spk0);
  p.active = static_cast<const int32_t*>(active);
  p.v_out = static_cast<int32_t*>(v_out);
  p.spk_out = static_cast<int32_t*>(spk_out);
  p.raster = static_cast<int32_t*>(raster);
  p.K = K;
  p.Bp = B;
  p.n_ext = n_ext;
  p.P = P;
  p.decay_mode = decay_mode;
  p.shift = shift;
  p.decay_raw = decay_raw;
  p.threshold = threshold;
  p.reset_mode = reset_mode;
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(
      raster, 0, sizeof(int32_t) * static_cast<size_t>(K) * B * P, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_tiles = P / kTileCols;
  const int csize = n_tiles < kMaxCluster ? n_tiles : kMaxCluster;
  switch (block_batch) {
    case 1:
      err = launch_bb<1>(use_f32 != 0, p, csize, s);
      break;
    case 8:
      err = launch_bb<8>(use_f32 != 0, p, csize, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}
