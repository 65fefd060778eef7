// spike_timestep_fused.cu — K event-gated Cerebra-H timesteps in one launch,
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
// Design (simple on purpose; wgmma, TMA pipelines and a split source loop
// are later work):
//   * Per-step feedback: step k+1 reads every neuron's spike of step k, so
//     the neuron tiles of one batch tile must meet once per step. They form
//     one thread-block CLUSTER of up to 8 CTAs (grid = cluster x batch
//     tiles); CTA `rank` owns the 128-column neuron tiles rank, rank + 8, ...
//     with one thread per column. After each step a warp's ballot is the
//     32-bit spike word of its 32 columns; lanes 0..cluster-1 push that word
//     into every CTA's shared memory through distributed shared memory
//     (`map_shared_rank`), then `cluster.sync()`. The word buffer is double
//     buffered by step parity, so one barrier per step suffices. A cluster
//     is scheduled whole, so the barrier cannot deadlock.
//   * The recurrent image (4 MiB at P = 1024) does not fit in shared
//     memory. Each step reads, from global memory where the 50 MB L2 keeps
//     them warm, only the W_rec rows of neurons that spiked in the tile's
//     previous step: the spiking rows are compacted into a list with a
//     BB-bit row mask each. Skipping a silent source adds exactly 0 in both
//     modes (every f32 partial sum is an exact integer under the 2^24
//     bound), so the result is the Pallas kernel's, from fewer bytes.
//   * The K x BB external accumulators: each active external block is
//     fetched ONCE per window: the CTA stages its columns of the block's
//     rows that spike anywhere in the window into shared memory (64 KB),
//     then applies them to the window's (step, example) rows, 8 at a time
//     in registers. The accumulators live in the raster output itself
//     (K, B, P), which each thread owns column-wise until step k overwrites
//     it with the emitted spikes, so any K fits.
//
// What bounds it: bytes. A window must read the scheduled W_ext blocks
// once and the W_rec rows of each step's spiking neurons, and write the
// (K, B, P) raster and the carries. This simple design is held back by its
// few CTAs (8 per batch tile at P = 1024) and by dependent row loads;
// PERF.md records its time against that bound.
//
// Accumulate modes, as in spike_timestep.cu:
//   exact (use_f32 = 0): uint32 wrapping adds, bit-exact always.
//   f32   (use_f32 = 1): each 128-row block, external and recurrent, is
//     summed in fp32 FMA (no TF32, no fast-math) and truncated toward zero
//     (__float2int_rz) before the uint32 accumulate. Exact while every
//     block sum stays under 2^24, which the engine enforces at build.

#include <cooperative_groups.h>

#include <cstdint>
#include <cuda_runtime.h>

#include "lif.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kBlockSrc = 128;                  // sources per gate block
constexpr int kTileCols = 128;                  // threads per CTA
constexpr int kWarps = kTileCols / 32;
constexpr int kLanesPerBlock = kBlockSrc / 32;  // packed lanes per block
constexpr int kGroup = 8;       // (step, example) rows per register group
constexpr int kBatchLoads = 8;  // weight-row loads in flight per thread
constexpr int kMaxCluster = 8;  // portable cluster size
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kMaxSmem = 227 * 1024;

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

// Inclusive prefix sum of `x` over the warp.
__device__ __forceinline__ int warp_scan(int x, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  return x;
}

template <int BB, bool F32>
__global__ void __launch_bounds__(kTileCols)
spike_timestep_fused_kernel(const Params p) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int P = p.P, Bp = p.Bp, K = p.K;
  const int n_words = P / 32;            // spike words per batch row
  const int L = p.n_ext / 32;            // packed lanes per batch row
  const int ns = p.n_ext / kBlockSrc;    // external gate blocks
  const int KB = K * BB;                 // (step, example) rows per window
  int32_t* s_w = reinterpret_cast<int32_t*>(smem);   // [128 rows][128 cols]
  uint32_t* s_all = smem + kBlockSrc * kTileCols;    // [2][BB][n_words]
  uint32_t* s_q = s_all + 2 * BB * n_words;          // [P] q | mask << 24
  uint32_t* s_rows = s_q + P;                        // [128] block rows
  uint32_t* s_gmask = s_rows + kBlockSrc;            // [128] group masks
  uint32_t* s_misc = s_gmask + kBlockSrc;            // union[4], counts

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int csize = static_cast<int>(cluster.num_blocks());
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tile_b = blockIdx.y;
  const int row0 = tile_b * BB;
  const int n_tiles = P / kTileCols;

  // ---- carries in; external accumulators zeroed (own columns only) ----
  for (int t = rank; t < n_tiles; t += csize) {
    const int col = t * kTileCols + tid;
    for (int r = 0; r < BB; ++r) {
      const size_t idx = static_cast<size_t>(row0 + r) * P + col;
      p.v_out[idx] = p.v[idx];
      p.spk_out[idx] = p.spk0[idx];
      for (int k = 0; k < K; ++k)
        p.raster[(static_cast<size_t>(k) * Bp + row0 + r) * P + col] = 0;
    }
  }
  // spike words of the whole neuron axis at window entry, into buffer 0
  for (int r = 0; r < BB; ++r) {
    for (int w = warp; w < n_words; w += kWarps) {
      const unsigned bits = __ballot_sync(
          kFull, p.spk0[static_cast<size_t>(row0 + r) * P + w * 32 + lane]
                     != 0);
      if (lane == 0) s_all[r * n_words + w] = bits;
    }
  }
  // every CTA of the cluster runs before any distributed-shared write
  cluster.sync();

  // ---- external accumulate: each active block fetched once per window --
  for (int sb = 0; sb < ns; ++sb) {
    if (p.act[tile_b * ns + sb] == 0) continue;  // uniform event gate
    if (tid < kLanesPerBlock) s_misc[tid] = 0u;
    __syncthreads();
    {  // rows of the block that spike in any (step, example) of the window
      const int l = tid & (kLanesPerBlock - 1);
      uint32_t u = 0u;
      for (int f = tid / kLanesPerBlock; f < KB;
           f += kTileCols / kLanesPerBlock) {
        const int k = f / BB, r = f - k * BB;
        u |= p.ext[(static_cast<size_t>(k) * Bp + row0 + r) * L
                   + sb * kLanesPerBlock + l];
      }
      if (u != 0u) atomicOr(&s_misc[l], u);
    }
    __syncthreads();
    if (warp == 0) {  // compact them, ascending
      const uint32_t u = lane < kLanesPerBlock ? s_misc[lane] : 0u;
      const int cnt = __popc(u);
      const int incl = warp_scan(cnt, lane);
      int pos = incl - cnt;
      for (uint32_t m = u; m != 0u; m &= m - 1u)
        s_rows[pos++] = static_cast<uint32_t>(lane * 32 + __ffs(m) - 1);
      if (lane == 31) s_misc[4] = static_cast<uint32_t>(incl);
    }
    __syncthreads();
    const int n_rows = static_cast<int>(s_misc[4]);

    for (int t = rank; t < n_tiles; t += csize) {
      const int col = t * kTileCols + tid;
      // stage this thread's column of the active rows (read back only by
      // the same thread, so no barrier is needed between the two)
      const int32_t* wb = p.w_ext + static_cast<size_t>(sb) * kBlockSrc * P
                          + col;
      for (int i0 = 0; i0 < n_rows; i0 += kBatchLoads) {
        int32_t wv[kBatchLoads];
#pragma unroll
        for (int u = 0; u < kBatchLoads; ++u) {
          const int i = min(i0 + u, n_rows - 1);
          wv[u] = wb[static_cast<size_t>(s_rows[i]) * P];
        }
#pragma unroll
        for (int u = 0; u < kBatchLoads; ++u)
          if (i0 + u < n_rows) s_w[(i0 + u) * kTileCols + tid] = wv[u];
      }
      for (int g = 0; g < KB; g += kGroup) {
        // which of the group's (step, example) rows spike on each row
        if (tid < n_rows) {
          const int j = static_cast<int>(s_rows[tid]);
          uint32_t m = 0u;
          for (int e = 0; e < kGroup && g + e < KB; ++e) {
            const int f = g + e, k = f / BB, r = f - k * BB;
            const uint32_t lanev =
                p.ext[(static_cast<size_t>(k) * Bp + row0 + r) * L
                      + sb * kLanesPerBlock + (j >> 5)];
            m |= ((lanev >> (j & 31)) & 1u) << e;
          }
          s_gmask[tid] = m;
        }
        __syncthreads();
        uint32_t acc[kGroup];
        float facc[kGroup];
#pragma unroll
        for (int e = 0; e < kGroup; ++e) {
          acc[e] = 0u;
          facc[e] = 0.0f;
        }
#pragma unroll 4
        for (int i = 0; i < n_rows; ++i) {
          const uint32_t m = s_gmask[i];
          const int32_t wv = s_w[i * kTileCols + tid];
          if (F32) {
            const float wf = static_cast<float>(wv);
#pragma unroll
            for (int e = 0; e < kGroup; ++e)
              facc[e] = __fmaf_rn(static_cast<float>((m >> e) & 1u), wf,
                                  facc[e]);
          } else {
#pragma unroll
            for (int e = 0; e < kGroup; ++e)
              acc[e] += ((m >> e) & 1u) * static_cast<uint32_t>(wv);
          }
        }
#pragma unroll
        for (int e = 0; e < kGroup; ++e) {
          if (g + e >= KB) break;
          const int f = g + e, k = f / BB, r = f - k * BB;
          const size_t ridx = (static_cast<size_t>(k) * Bp + row0 + r) * P
                              + col;
          const uint32_t add =
              F32 ? static_cast<uint32_t>(__float2int_rz(facc[e])) : acc[e];
          p.raster[ridx] = static_cast<int32_t>(
              static_cast<uint32_t>(p.raster[ridx]) + add);
        }
        __syncthreads();  // s_gmask is rewritten by the next group
      }
    }
  }

  // ---- K steps: recurrent accumulate on the previous step's spikes, LIF,
  // masked-slot keep, spike words pushed to the whole cluster ----
  for (int k = 0; k < K; ++k) {
    const uint32_t* prev = s_all + (k & 1) * BB * n_words;
    uint32_t* next = s_all + ((k + 1) & 1) * BB * n_words;
    if (warp == 0) {  // spiking recurrent rows, ascending, with row masks
      int base = 0;
      for (int w0 = 0; w0 < n_words; w0 += 32) {
        const int w = w0 + lane;
        uint32_t rowbits[BB];
        uint32_t u = 0u;
#pragma unroll
        for (int r = 0; r < BB; ++r) {
          rowbits[r] = w < n_words ? prev[r * n_words + w] : 0u;
          u |= rowbits[r];
        }
        const int cnt = __popc(u);
        const int incl = warp_scan(cnt, lane);
        int pos = base + incl - cnt;
        for (uint32_t m = u; m != 0u; m &= m - 1u) {
          const int b = __ffs(m) - 1;
          uint32_t rm = 0u;
#pragma unroll
          for (int r = 0; r < BB; ++r) rm |= ((rowbits[r] >> b) & 1u) << r;
          s_q[pos++] = static_cast<uint32_t>(w * 32 + b) | (rm << 24);
        }
        base += __shfl_sync(kFull, incl, 31);
      }
      if (lane == 0) s_misc[5] = static_cast<uint32_t>(base);
    }
    __syncthreads();
    const int n_q = static_cast<int>(s_misc[5]);

    for (int t = rank; t < n_tiles; t += csize) {
      const int col = t * kTileCols + tid;
      uint32_t acc[BB];
      float facc[BB];
#pragma unroll
      for (int r = 0; r < BB; ++r) {
        acc[r] = 0u;
        facc[r] = 0.0f;
      }
      int chunk = 0;  // f32: the 128-row block the partial sums belong to
      for (int i0 = 0; i0 < n_q; i0 += kBatchLoads) {
        uint32_t ent[kBatchLoads];
        int32_t wv[kBatchLoads];
#pragma unroll
        for (int u = 0; u < kBatchLoads; ++u) {
          // past the end: the last row again with an empty mask (adds 0)
          ent[u] = i0 + u < n_q ? s_q[i0 + u] : (s_q[n_q - 1] & 0xFFFFFFu);
          wv[u] = p.w_rec[static_cast<size_t>(ent[u] & 0xFFFFFFu) * P + col];
        }
#pragma unroll
        for (int u = 0; u < kBatchLoads; ++u) {
          const uint32_t rm = ent[u] >> 24;
          if (F32) {
            const int c = static_cast<int>((ent[u] & 0xFFFFFFu) / kBlockSrc);
            if (c != chunk) {  // uniform: every thread walks the same list
#pragma unroll
              for (int r = 0; r < BB; ++r) {
                acc[r] += static_cast<uint32_t>(__float2int_rz(facc[r]));
                facc[r] = 0.0f;
              }
              chunk = c;
            }
            const float wf = static_cast<float>(wv[u]);
#pragma unroll
            for (int r = 0; r < BB; ++r)
              facc[r] = __fmaf_rn(static_cast<float>((rm >> r) & 1u), wf,
                                  facc[r]);
          } else {
#pragma unroll
            for (int r = 0; r < BB; ++r)
              acc[r] += ((rm >> r) & 1u) * static_cast<uint32_t>(wv[u]);
          }
        }
      }
      if (F32) {
#pragma unroll
        for (int r = 0; r < BB; ++r)
          acc[r] += static_cast<uint32_t>(__float2int_rz(facc[r]));
      }
#pragma unroll
      for (int r = 0; r < BB; ++r) {
        const int row = row0 + r;
        const size_t idx = static_cast<size_t>(row) * P + col;
        const size_t ridx = (static_cast<size_t>(k) * Bp + row) * P + col;
        int32_t carry;
        if (p.active[k * Bp + row] != 0) {  // uniform per CTA
          const uint32_t syn = static_cast<uint32_t>(p.raster[ridx]) + acc[r];
          int32_t vo;
          carry = lif::step(p.v_out[idx], syn, p.decay_mode, p.shift,
                            p.decay_raw, p.threshold, p.reset_mode, &vo);
          p.v_out[idx] = vo;
          p.spk_out[idx] = carry;
          p.raster[ridx] = carry;
        } else {  // paused slot: keep the carry, emit nothing
          carry = p.spk_out[idx];
          p.raster[ridx] = 0;
        }
        const unsigned bits = __ballot_sync(kFull, carry != 0);
        if (lane < csize) {
          uint32_t* dst = cluster.map_shared_rank(next, lane);
          dst[r * n_words + t * kWarps + warp] = bits;
        }
      }
    }
    // the words are in every CTA; `next` of the step before is free again
    cluster.sync();
  }
}

size_t smem_bytes(int bb, int P) {
  return sizeof(uint32_t) *
         (static_cast<size_t>(kBlockSrc) * kTileCols
          + 2 * static_cast<size_t>(bb) * (P / 32) + P + 2 * kBlockSrc + 8);
}

template <int BB, bool F32>
cudaError_t launch(const Params& p, int csize, cudaStream_t stream) {
  auto kernel = spike_timestep_fused_kernel<BB, F32>;
  // once per instantiation: allow the dynamic shared memory above 48 KB
  static const cudaError_t attr_err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attr_err != cudaSuccess) return attr_err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(csize, p.Bp / BB, 1);
  cfg.blockDim = dim3(kTileCols, 1, 1);
  cfg.dynamicSmemBytes = smem_bytes(BB, p.P);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, p);
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
// (K, B, n_ext / 32); act is (B / block_batch, n_ext / 128). Returns the
// CUDA error of the launch (0 on success).
extern "C" int spike_timestep_fused_launch(
    const void* act, const void* ext, const void* w_ext, const void* w_rec,
    const void* v, const void* spk0, const void* active, void* v_out,
    void* spk_out, void* raster, int K, int B, int n_ext, int P,
    int block_batch, int use_f32, int decay_mode, int shift, int decay_raw,
    int threshold, int reset_mode, void* stream) {
  if (K <= 0 || B <= 0 || n_ext <= 0 || P <= 0 || block_batch <= 0 ||
      B % block_batch != 0 || n_ext % kBlockSrc != 0 || P % kTileCols != 0 ||
      P >= (1 << 24) || B / block_batch > 65535 ||
      smem_bytes(block_batch, P) > static_cast<size_t>(kMaxSmem)) {
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
  const int n_tiles = P / kTileCols;
  const int csize = n_tiles < kMaxCluster ? n_tiles : kMaxCluster;
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
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
