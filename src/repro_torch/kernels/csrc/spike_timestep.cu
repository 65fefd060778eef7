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
// What bounds it: bytes. At the serving slice's shape (B = 8 slots,
// S = 2592 padded to 2688, P = 1024) only the weight rows of sources that
// spike have to be read, ~800 rows of 4 KB at a served step, 3.3 MB: about
// 1 us at the 3.35 TB/s of HBM3. The TPU kernel walks the source blocks in
// order on one core; a grid of one CTA per (batch tile, neuron tile) that
// does the same leaves 8 CTAs on a 132-SM card, each making ~200 dependent
// row round trips.
//
// Design: the source loop is spread over the card.
//   * Product launch, grid = (P/128 neuron tiles, S/128 source blocks,
//     B/BB batch tiles), 4 warps per CTA: 8 x 21 = 168 CTAs under the
//     batch-tile gate at the slice shape. A CTA whose gate scalar (the
//     TPU kernel's scalar prefetch) is 0 exits at once.
//   * A CTA stages its BB x 128 source tile and lists the spiking (slot,
//     source) pairs (ballots and a prefix over the 4 warps); each warp
//     takes an even share of the list and reads its weight rows 16 bytes
//     a lane, 8 rows in flight, adding each row once per spike, times the
//     source value (block_product.cuh). A list of rows with BB
//     coefficients each would cost BB multiply-adds per row, though a
//     served row spikes in about one slot. The block's per-slot sums meet
//     in shared memory and are added into a (B, P) uint32 accumulator,
//     zeroed by this entry point, with wrapping atomicAdd: the same bits
//     in any order (see block_product.cuh, also for the f32 split).
//   * Epilogue launch: one thread per (b, p) reads the accumulator and runs
//     the decay / integrate / fire / reset of lif.cuh.
//   The memset and both launches go on the caller's stream, so a CUDA graph
//   captures them whole; nothing is kept between calls.
//
// Accumulate modes:
//   exact (use_f32 = 0): uint32 wrapping adds, bit-exact always.
//   f32   (use_f32 = 1): each warp sums its piece of the block's rows in
//     fp32 FMA (no TF32, no fast-math) and truncates it toward zero before
//     the uint32 adds. Exact while every block sum stays under 2^24, which
//     the engine enforces at build.

#include <cstdint>
#include <cuda_runtime.h>

#include "block_product.cuh"
#include "lif.cuh"

namespace {

using blockprod::kBlockSrc;
using blockprod::kFull;
using blockprod::kTileCols;

constexpr int kWarps = kBlockSrc / 32;  // warp w owns sources 32w..32w+31
constexpr int kThreads = kBlockSrc;
constexpr int kEpilogueThreads = 256;
constexpr int kLoads = 8;  // weight rows in flight per warp

struct SourceCoef {  // the staged source value of a (slot, row) entry
  const int32_t (*s_src)[kBlockSrc];
  __device__ __forceinline__ int32_t operator()(uint32_t e) const {
    return s_src[e >> blockprod::kSlotShift][e & blockprod::kRowBits];
  }
};

template <int BB, bool F32>
__global__ void __launch_bounds__(kThreads)
spike_block_kernel(const int32_t* __restrict__ act,
                   const int32_t* __restrict__ src,
                   const int32_t* __restrict__ w,
                   uint32_t* __restrict__ acc_out, int S, int P) {
  __shared__ int32_t s_src[BB][kBlockSrc];
  __shared__ uint32_t s_list[BB * kBlockSrc];  // (slot, row) entries
  __shared__ uint32_t s_acc[BB * kTileCols];   // the block's sums
  __shared__ int s_cnt[BB][kWarps];

  const int ns = S / kBlockSrc;
  const int sb = blockIdx.y;
  const int tile = blockIdx.z;
  if (act[tile * ns + sb] == 0) return;  // event gate, uniform per CTA

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row0 = tile * BB;
  const int col0 = blockIdx.x * kTileCols;

  // stage the BB x 128 source tile; thread tid owns source row tid
  unsigned ball[BB];
#pragma unroll
  for (int r = 0; r < BB; ++r) {
    const int32_t s =
        src[static_cast<size_t>(row0 + r) * S + sb * kBlockSrc + tid];
    s_src[r][tid] = s;
    ball[r] = __ballot_sync(kFull, s != 0);
    if (lane == 0) s_cnt[r][warp] = __popc(ball[r]);
  }
  for (int i = tid; i < BB * kTileCols; i += kThreads) s_acc[i] = 0u;
  __syncthreads();
  // list the spiking (slot, row) pairs, slot-major and ascending
  int total = 0;
#pragma unroll
  for (int r = 0; r < BB; ++r) {
    int off = total;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) {
      off += k < warp ? s_cnt[r][k] : 0;
      total += s_cnt[r][k];
    }
    if ((ball[r] >> lane) & 1u)
      s_list[off + __popc(ball[r] & ((1u << lane) - 1u))] =
          static_cast<uint32_t>(tid)
          | (static_cast<uint32_t>(r) << blockprod::kSlotShift);
  }
  __syncthreads();

  // each warp takes an even share of the list, whatever the slots
  const int lo = warp * total / kWarps;
  const int hi = (warp + 1) * total / kWarps;
  blockprod::warp_rows<F32, kLoads>(
      s_list + lo, hi - lo, w + static_cast<size_t>(sb) * kBlockSrc * P, P,
      col0 + lane * 4, SourceCoef{s_src}, s_acc, lane);
  __syncthreads();

  // one column per thread: the block's sums into the accumulator
#pragma unroll
  for (int r = 0; r < BB; ++r) {
    const uint32_t s = s_acc[r * kTileCols + tid];
    if (s != 0u)
      atomicAdd(acc_out + static_cast<size_t>(row0 + r) * P + col0 + tid, s);
  }
}

__global__ void __launch_bounds__(kEpilogueThreads)
spike_epilogue_kernel(const uint32_t* __restrict__ acc,
                      const int32_t* __restrict__ v,
                      int32_t* __restrict__ v_out,
                      int32_t* __restrict__ spk_out, int n, int decay_mode,
                      int shift, int32_t decay_raw, int32_t threshold,
                      int reset_mode) {
  const int i = blockIdx.x * kEpilogueThreads + threadIdx.x;
  if (i >= n) return;
  spk_out[i] = lif::step(v[i], acc[i], decay_mode, shift, decay_raw,
                         threshold, reset_mode, &v_out[i]);
}

template <int BB>
void launch_product(bool use_f32, dim3 grid, cudaStream_t stream,
                    const int32_t* act, const int32_t* src, const int32_t* w,
                    uint32_t* acc, int S, int P) {
  if (use_f32) {
    spike_block_kernel<BB, true><<<grid, kThreads, 0, stream>>>(act, src, w,
                                                                acc, S, P);
  } else {
    spike_block_kernel<BB, false><<<grid, kThreads, 0, stream>>>(act, src, w,
                                                                 acc, S, P);
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes. block_batch is 1 (per-example
// gate) or 8 (batch-tile gate). All arrays are 32-bit, row-major and
// contiguous, pre-padded by the wrapper: B % block_batch == 0,
// S % 128 == 0, P % 128 == 0; act is (B / block_batch, S / 128); w is
// 16-byte aligned; acc is (B, P) scratch, zeroed here. Issues the memset,
// the product launch and the epilogue launch on `stream` and returns the
// first CUDA error (0 on success).
extern "C" int spike_timestep_launch(const void* act, const void* src,
                                     const void* w, const void* v, void* acc,
                                     void* v_out, void* spk_out, int B,
                                     int S, int P, int block_batch,
                                     int use_f32, int decay_mode, int shift,
                                     int decay_raw, int threshold,
                                     int reset_mode, void* stream) {
  if (B <= 0 || S <= 0 || P <= 0 || block_batch <= 0 ||
      B % block_batch != 0 || S % kBlockSrc != 0 || P % kTileCols != 0 ||
      B / block_batch > 65535 || S / kBlockSrc > 65535 ||
      static_cast<long long>(B) * P > (1LL << 31) - 1 ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  auto* a = static_cast<uint32_t*>(acc);
  const int n = B * P;
  cudaError_t err =
      cudaMemsetAsync(a, 0, sizeof(uint32_t) * static_cast<size_t>(n), s);
  if (err != cudaSuccess) return static_cast<int>(err);

  const dim3 grid(P / kTileCols, S / kBlockSrc, B / block_batch);
  const auto* ac = static_cast<const int32_t*>(act);
  const auto* x = static_cast<const int32_t*>(src);
  const auto* wt = static_cast<const int32_t*>(w);
  const bool f32 = use_f32 != 0;
  switch (block_batch) {
    case 1:
      launch_product<1>(f32, grid, s, ac, x, wt, a, S, P);
      break;
    case 8:
      launch_product<8>(f32, grid, s, ac, x, wt, a, S, P);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  spike_epilogue_kernel<<<(n + kEpilogueThreads - 1) / kEpilogueThreads,
                          kEpilogueThreads, 0, s>>>(
      a, static_cast<const int32_t*>(v), static_cast<int32_t*>(v_out),
      static_cast<int32_t*>(spk_out), n, decay_mode, shift, decay_raw,
      threshold, reset_mode);
  return static_cast<int>(cudaGetLastError());
}
