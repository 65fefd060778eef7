// lif_step.cu — the fused hardware LIF update for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `lif_step_kernel`
// (src/repro/kernels/lif_step.py, built by `build_lif_step`), which
// `repro.kernels.ops.lif_step` calls. It computes, elementwise over an
// int32 array,
//
//   v_new  = shift_decay(v) + syn          0.125 / 0.25 / 0.5: v - (v >> k)
//                                          0.75: v >> 2
//   spikes = v_new >= threshold
//   v_out  = reset(v_new, spikes)          zero | subtract | hold
//
// with every add and subtract wrapping mod 2^32, through `lif::step` of
// lif.cuh, the epilogue the timestep kernels share.
//
// Design: one thread per element with a bounds check. The TPU kernel's
// (8, 128)-aligned blocks and the wrapper's padding were the TPU's tiling;
// here the flat index covers any shape. What bounds it: 16 bytes per
// element (v and syn in, v_out and spikes out) over the 3.35 TB/s of HBM3,
// ~12 integer operations per element, far under the card's integer rate;
// at the bench's (8, 1024) the 128 KiB take 0.04 us, so one launch is
// bound by its launch cost, not by the data.

#include <cstdint>
#include <cuda_runtime.h>

#include "lif.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
lif_step_kernel(const int32_t* __restrict__ v,
                const int32_t* __restrict__ syn,
                int32_t* __restrict__ v_out,
                int32_t* __restrict__ spk_out, int64_t n, int decay_mode,
                int shift, int32_t threshold, int reset_mode) {
  const int64_t i =
      static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  int32_t vo;
  spk_out[i] = lif::step(v[i], static_cast<uint32_t>(syn[i]), decay_mode,
                         shift, 0, threshold, reset_mode, &vo);
  v_out[i] = vo;
}

}  // namespace

// Launches on `stream` without synchronising; returns cudaGetLastError()
// (0 = launched). decay_mode is lif::kDecayShiftSub or lif::kDecayShift.
extern "C" int lif_step_launch(const void* v, const void* syn, void* v_out,
                               void* spk_out, long long n, int decay_mode,
                               int shift, int threshold, int reset_mode,
                               void* stream) {
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (n <= 0 || blocks > 0x7FFFFFFFLL ||
      (decay_mode != lif::kDecayShiftSub && decay_mode != lif::kDecayShift)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  lif_step_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(v), static_cast<const int32_t*>(syn),
      static_cast<int32_t*>(v_out), static_cast<int32_t*>(spk_out), n,
      decay_mode, shift, threshold, reset_mode);
  return static_cast<int>(cudaGetLastError());
}
