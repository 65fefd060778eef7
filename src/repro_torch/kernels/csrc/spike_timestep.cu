// spike_timestep.cu — one event-gated Cerebra-H timestep for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `spike_timestep_kernel`
// (src/repro/kernels/spike_timestep.py, built by `build_spike_timestep`),
// which backs the JAX engine's "pallas" and "pallas-mxu" backends. It
// computes the same function:
//
//   syn      = sources @ W                 (B,S){0,1} x (S,P) int32 Q16.16
//              skipping every 128-source block whose activity scalar is 0
//   v_new    = decay(v) + syn              shift or fixed-point-mul decay
//   spikes   = v_new >= threshold
//   v_out    = reset(v_new, spikes)        zero | subtract | hold
//
// with every add wrapping mod 2^32, as the JAX reference does.
//
// Design (simple on purpose; a later change redesigns it):
//   * grid = (P/128 neuron tiles, B/BB batch tiles); one thread per neuron
//     column, 128 threads per CTA, BB register accumulators per thread.
//   * the CTA walks the S/128 source blocks; it reads its own activity
//     scalar (the TPU kernel's scalar prefetch) and skips a silent block
//     outright — no weight load, no accumulate. The branch is uniform.
//   * an active block's BB x 128 source tile is staged in shared memory,
//     the rows with any spike are compacted into a list (warp ballots),
//     and each listed W row is read once, coalesced across the CTA, and
//     added into the BB accumulators.
//   * the decay / integrate / fire / reset epilogue runs in registers.
//
// What bounds it at the serving slice's shape (B = 8 slots, S = 2592
// padded to 2688, P = 1024): the weight image is 2688 x 1024 int32, about
// 11 MB, and at most the rows of spiking sources have to be read, so the
// function is bound by bytes (weight rows over the 3.35 TB/s of HBM3). This
// simple design is further held back by its few CTAs (8 under the
// batch-tile gate, 64 under the per-example gate, on a 132-SM card) and
// by one dependent row load per spiking source; PERF.md records its time
// against that bound.
//
// Accumulate modes:
//   exact (use_f32 = 0): uint32 wrapping adds, bit-exact always.
//   f32   (use_f32 = 1): each 128-row block is summed in fp32 FMA (no TF32,
//     no fast-math), truncated toward zero (__float2int_rz, as JAX's
//     astype(int32)), then added into the uint32 accumulator. Exact while
//     every block sum stays under 2^24, which the engine enforces at build.

#include <cstdint>
#include <cuda_runtime.h>

#include "lif.cuh"

namespace {

constexpr int kBlockSrc = 128;  // sources per gate block
constexpr int kTileCols = 128;  // neuron columns per CTA, one per thread
constexpr int kWarps = kTileCols / 32;

template <int BB, bool F32>
__global__ void __launch_bounds__(kTileCols)
spike_timestep_kernel(const int32_t* __restrict__ act,
                      const int32_t* __restrict__ src,
                      const int32_t* __restrict__ w,
                      const int32_t* __restrict__ v,
                      int32_t* __restrict__ v_out,
                      int32_t* __restrict__ spk_out,
                      int S, int P, int decay_mode, int shift,
                      int32_t decay_raw, int32_t threshold, int reset_mode) {
  __shared__ int32_t s_src[BB][kBlockSrc];
  __shared__ int16_t s_rows[kBlockSrc];
  __shared__ int s_count[kWarps];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int col = blockIdx.x * kTileCols + tid;
  const int tile = blockIdx.y;
  const int row0 = tile * BB;
  const int ns = S / kBlockSrc;

  uint32_t acc[BB];
#pragma unroll
  for (int r = 0; r < BB; ++r) acc[r] = 0u;

  for (int sb = 0; sb < ns; ++sb) {
    // event gate: one scalar per (batch tile, source block), uniform
    if (act[tile * ns + sb] == 0) continue;

    // stage the BB x 128 source tile; thread tid owns source row tid
    int any = 0;
#pragma unroll
    for (int r = 0; r < BB; ++r) {
      const int32_t s =
          src[static_cast<size_t>(row0 + r) * S + sb * kBlockSrc + tid];
      s_src[r][tid] = s;
      any |= s;
    }
    // compact the rows with any spike, in ascending order
    const unsigned mask = __ballot_sync(0xFFFFFFFFu, any != 0);
    if (lane == 0) s_count[warp] = __popc(mask);
    __syncthreads();
    int base = 0, n_rows = 0;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) {
      const int c = s_count[k];
      base += (k < warp) ? c : 0;
      n_rows += c;
    }
    if (any != 0) {
      s_rows[base + __popc(mask & ((1u << lane) - 1u))] =
          static_cast<int16_t>(tid);
    }
    __syncthreads();

    const int32_t* wb = w + static_cast<size_t>(sb) * kBlockSrc * P + col;
    if (F32) {
      float facc[BB];
#pragma unroll
      for (int r = 0; r < BB; ++r) facc[r] = 0.0f;
#pragma unroll 4
      for (int i = 0; i < n_rows; ++i) {
        const int j = s_rows[i];
        const float wv = static_cast<float>(wb[static_cast<size_t>(j) * P]);
#pragma unroll
        for (int r = 0; r < BB; ++r)
          facc[r] = __fmaf_rn(static_cast<float>(s_src[r][j]), wv, facc[r]);
      }
#pragma unroll
      for (int r = 0; r < BB; ++r)
        acc[r] += static_cast<uint32_t>(__float2int_rz(facc[r]));
    } else {
#pragma unroll 4
      for (int i = 0; i < n_rows; ++i) {
        const int j = s_rows[i];
        const uint32_t wv =
            static_cast<uint32_t>(wb[static_cast<size_t>(j) * P]);
#pragma unroll
        for (int r = 0; r < BB; ++r)
          acc[r] += static_cast<uint32_t>(s_src[r][j]) * wv;
      }
    }
    __syncthreads();  // s_src / s_rows are rewritten by the next block
  }

#pragma unroll
  for (int r = 0; r < BB; ++r) {
    const size_t idx = static_cast<size_t>(row0 + r) * P + col;
    spk_out[idx] = lif::step(v[idx], acc[r], decay_mode, shift, decay_raw,
                             threshold, reset_mode, &v_out[idx]);
  }
}

template <int BB>
cudaError_t launch_bb(bool use_f32, dim3 grid, cudaStream_t stream,
                      const int32_t* act, const int32_t* src,
                      const int32_t* w, const int32_t* v, int32_t* v_out,
                      int32_t* spk_out, int S, int P, int decay_mode,
                      int shift, int32_t decay_raw, int32_t threshold,
                      int reset_mode) {
  if (use_f32) {
    spike_timestep_kernel<BB, true><<<grid, kTileCols, 0, stream>>>(
        act, src, w, v, v_out, spk_out, S, P, decay_mode, shift, decay_raw,
        threshold, reset_mode);
  } else {
    spike_timestep_kernel<BB, false><<<grid, kTileCols, 0, stream>>>(
        act, src, w, v, v_out, spk_out, S, P, decay_mode, shift, decay_raw,
        threshold, reset_mode);
  }
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded with ctypes. block_batch is 1 (per-example
// gate) or 8 (batch-tile gate). All arrays are int32, row-major and
// contiguous, pre-padded by the wrapper: B % block_batch == 0,
// S % 128 == 0, P % 128 == 0; act is (B / block_batch, S / 128). Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int spike_timestep_launch(const void* act, const void* src,
                                     const void* w, const void* v,
                                     void* v_out, void* spk_out, int B,
                                     int S, int P, int block_batch,
                                     int use_f32, int decay_mode, int shift,
                                     int decay_raw, int threshold,
                                     int reset_mode, void* stream) {
  if (B <= 0 || S <= 0 || P <= 0 || block_batch <= 0 ||
      B % block_batch != 0 || S % kBlockSrc != 0 || P % kTileCols != 0 ||
      B / block_batch > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(P / kTileCols, B / block_batch);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* a = static_cast<const int32_t*>(act);
  const auto* x = static_cast<const int32_t*>(src);
  const auto* wt = static_cast<const int32_t*>(w);
  const auto* vv = static_cast<const int32_t*>(v);
  auto* vo = static_cast<int32_t*>(v_out);
  auto* so = static_cast<int32_t*>(spk_out);
  const bool f32 = use_f32 != 0;
  cudaError_t err;
  switch (block_batch) {
    case 1:
      err = launch_bb<1>(f32, grid, s, a, x, wt, vv, vo, so, S, P,
                         decay_mode, shift, decay_raw, threshold, reset_mode);
      break;
    case 8:
      err = launch_bb<8>(f32, grid, s, a, x, wt, vv, vo, so, S, P,
                         decay_mode, shift, decay_raw, threshold, reset_mode);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}
