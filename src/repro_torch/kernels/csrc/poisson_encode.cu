// poisson_encode.cu — the hardware rate encoder for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `poisson_encode_kernel`
// (src/repro/kernels/poisson_encode.py, built by `build_poisson_encode`),
// which `repro.kernels.ops.poisson_encode` calls. For intensities x (B, D)
// float32 and T timesteps it writes spikes (T, B, D) int32 {0, 1}:
//
//   h     = mix(seed ^ t*P_T ^ b*P_B ^ d*P_D)       murmur3 finaliser
//   c     = clip(x, 0, 1)
//   spike = h < (uint32) min(c * 2^32, 4294967040.0f)  or  c >= 1
//
// all in uint32_t, whose multiplies wrap mod 2^32 as JAX's uint32 does.
// The hash is a pure function of (seed, t, b, d), so this kernel, its
// plain version (repro_torch.kernels.ref.poisson_encode_ref) and the JAX
// kernel agree bit for bit.
//
// NaN: jnp.clip and jnp.minimum carry a NaN into astype(uint32), which
// gives 0 on XLA, so a NaN intensity never fires. fminf / fmaxf would drop
// the NaN instead, so the clip and the minimum are written as compares
// and NaN takes its own branch. The float -> uint32 conversion truncates
// toward zero (__float2uint_rz), as astype does.
//
// Design: one thread per output element; consecutive threads write
// consecutive d, so stores coalesce, and each intensity row is re-read
// from L2 by its T timesteps. What bounds it: the (T, B, D) int32 output
// written once plus the (B, D) input read once, over the 3.35 TB/s of
// HBM3; ~12 integer operations per element are far under the card's
// integer rate. At the bench's T 25, B 8, D 784 the 652 KB take 0.19 us,
// so one launch is bound by its launch cost, not by the data.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kPrimeT = 0x9E3779B1u;
constexpr uint32_t kPrimeB = 0x85EBCA77u;
constexpr uint32_t kPrimeD = 0xC2B2AE3Du;

__device__ __forceinline__ uint32_t mix(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

__global__ void __launch_bounds__(kThreads)
poisson_encode_kernel(const float* __restrict__ intens,
                      int32_t* __restrict__ out, int64_t n, int B, int D,
                      uint32_t seed) {
  const int64_t i =
      static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const int64_t row = i / D;  // t * B + b
  const uint32_t d = static_cast<uint32_t>(i - row * D);
  const uint32_t b = static_cast<uint32_t>(row % B);
  const uint32_t t = static_cast<uint32_t>(row / B);
  const uint32_t h =
      mix(seed ^ (t * kPrimeT) ^ (b * kPrimeB) ^ (d * kPrimeD));

  const float x = intens[static_cast<int64_t>(b) * D + d];
  int32_t fire = 0;
  if (x == x) {  // NaN never fires
    const float c = x < 0.0f ? 0.0f : (x > 1.0f ? 1.0f : x);
    const float scaled = c * 4294967296.0f;
    const uint32_t thr =
        __float2uint_rz(scaled < 4294967040.0f ? scaled : 4294967040.0f);
    fire = (h < thr || c >= 1.0f) ? 1 : 0;
  }
  out[i] = fire;
}

}  // namespace

// Launches on `stream` without synchronising; returns cudaGetLastError()
// (0 = launched). `seed` is the int32 seed's bit pattern.
extern "C" int poisson_encode_launch(const void* intens, void* out, int T,
                                     int B, int D, unsigned int seed,
                                     void* stream) {
  const long long n = static_cast<long long>(T) * B * D;
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (T <= 0 || B <= 0 || D <= 0 || blocks > 0x7FFFFFFFLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  poisson_encode_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(intens), static_cast<int32_t*>(out), n, B,
      D, seed);
  return static_cast<int>(cudaGetLastError());
}
