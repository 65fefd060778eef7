// lif.cuh — the integer LIF epilogue shared by the port's timestep kernels.
//
// Decay, integrate, fire and reset of one Cerebra-H neuron, with every
// add and subtract wrapping mod 2^32 as the JAX reference's int32 does
// (C++ signed overflow is undefined, so the arithmetic runs in uint32_t).
// Twin of repro_torch.kernels.epilogue.decay_and_fire.

#pragma once

#include <cstdint>

namespace lif {

// decay_mode values (set by the Python wrappers); any other value (2) is
// the fixed-point multiply fx_mul(v, decay_raw)
constexpr int kDecayShiftSub = 0;  // v - (v >> shift)
constexpr int kDecayShift = 1;     // v >> shift

// reset_mode values; any other value (2) is hold
constexpr int kResetZero = 0;
constexpr int kResetSubtract = 1;

__device__ __forceinline__ int32_t wrap_add(int32_t a, uint32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) + b);
}

__device__ __forceinline__ int32_t wrap_sub(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) -
                              static_cast<uint32_t>(b));
}

// `>>` on int32_t compiles to an arithmetic shift (shr.s32), matching
// jnp.right_shift on signed ints.
__device__ __forceinline__ int32_t decay(int32_t v, int mode, int shift,
                                         int32_t raw) {
  if (mode == kDecayShiftSub) return wrap_sub(v, v >> shift);
  if (mode == kDecayShift) return v >> shift;
  // fx_mul: a_hi * b + (a_lo * b >> 16), 0 <= b <= 2^16, a_lo < 2^16
  const int32_t a_hi = v >> 16;
  const uint32_t a_lo = static_cast<uint32_t>(v) & 0xFFFFu;
  const uint32_t b = static_cast<uint32_t>(raw);
  const uint32_t lo = (a_lo * b) >> 16;
  return static_cast<int32_t>(static_cast<uint32_t>(a_hi) * b + lo);
}

// v_new = decay(v) + syn; spike = v_new >= threshold; *v_out = reset.
// Returns the spike (0 or 1).
__device__ __forceinline__ int32_t step(int32_t v, uint32_t syn,
                                        int decay_mode, int shift,
                                        int32_t decay_raw, int32_t threshold,
                                        int reset_mode, int32_t* v_out) {
  const int32_t v_new = wrap_add(decay(v, decay_mode, shift, decay_raw), syn);
  const int32_t spk = v_new >= threshold ? 1 : 0;
  int32_t vo = v_new;
  if (reset_mode == kResetZero) {
    vo = spk ? 0 : v_new;
  } else if (reset_mode == kResetSubtract) {
    vo = wrap_sub(v_new, spk ? threshold : 0);
  }
  *v_out = vo;
  return spk;
}

}  // namespace lif
