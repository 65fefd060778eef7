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
// What bounds it: the (T, B, D) int32 raster written once, over the
// 3.35 TB/s of HBM3; the (B, D) input is T times smaller. Bytes bind only
// while each output word costs few instructions: the finaliser and the
// compare are ~12, under the card's issue rate for 4 bytes of HBM
// traffic, but recovering (t, b, d) from a flat index per element takes
// 64-bit divisions, a software routine on Hopper that would bind first.
//
// Design: a thread owns 4 consecutive positions j = b*D + d of the (B*D)
// plane, and a run of `t_per_block` timesteps picked by blockIdx.y. Before
// its t loop it finds (b, d) of its first position with one 32-bit
// division and steps to the next three, reads the 4 intensities once (one
// 16-byte load), and keeps their thresholds and their t-free hash terms
// b*P_B ^ d*P_D in registers. Each t then costs seed ^ t*P_T, 4 finalisers
// and compares, and one 16-byte streaming store of four int32. The launch
// plan (kernels/poisson_encode.launch_plan) splits t over blockIdx.y until
// the grid holds ~2 waves of the card's resident threads, so a small plane
// with many timesteps still fills every SM. A plane with B*D % 4 != 0, or
// an input or output not 16-byte aligned, takes scalar loads and stores in
// the same kernel (the condition is uniform over the grid).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // launch_plan's THREADS
constexpr int kPerThread = 4;  // positions of the plane per thread
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

// The spike rule's t-free half: h < *thr fires, and so does *always.
__device__ __forceinline__ void threshold(float x, uint32_t* thr,
                                          bool* always) {
  *thr = 0u;
  *always = false;
  if (x == x) {  // NaN never fires
    const float c = x < 0.0f ? 0.0f : (x > 1.0f ? 1.0f : x);
    const float scaled = c * 4294967296.0f;
    *thr = __float2uint_rz(scaled < 4294967040.0f ? scaled : 4294967040.0f);
    *always = c >= 1.0f;
  }
}

__global__ void __launch_bounds__(kThreads)
poisson_encode_kernel(const float* __restrict__ intens,
                      int32_t* __restrict__ out, int T, int BD, int D,
                      int t_per_block, uint32_t seed) {
  const int j0 = (blockIdx.x * kThreads + threadIdx.x) * kPerThread;
  if (j0 >= BD) return;
  const int t0 = blockIdx.y * t_per_block;
  const int t1 = t0 + min(t_per_block, T - t0);
  const bool vec =
      (BD % kPerThread) == 0 &&
      ((reinterpret_cast<uintptr_t>(intens) |
        reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  const int n = min(kPerThread, BD - j0);

  float x[kPerThread];
  if (vec) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(intens + j0));
    x[0] = q.x;
    x[1] = q.y;
    x[2] = q.z;
    x[3] = q.w;
  } else {
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      x[k] = k < n ? intens[j0 + k] : 0.0f;
    }
  }
  uint32_t bd_hash[kPerThread], thr[kPerThread];
  bool always[kPerThread];
  uint32_t b = static_cast<uint32_t>(j0 / D);
  uint32_t d = static_cast<uint32_t>(j0) - b * static_cast<uint32_t>(D);
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    bd_hash[k] = (b * kPrimeB) ^ (d * kPrimeD);
    threshold(x[k], &thr[k], &always[k]);
    if (++d == static_cast<uint32_t>(D)) {
      d = 0u;
      ++b;
    }
  }

  int32_t* row = out + static_cast<int64_t>(t0) * BD + j0;
  for (int t = t0; t < t1; ++t, row += BD) {
    const uint32_t st = seed ^ (static_cast<uint32_t>(t) * kPrimeT);
    int32_t f[kPerThread];
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      f[k] = (mix(st ^ bd_hash[k]) < thr[k] || always[k]) ? 1 : 0;
    }
    if (vec) {
      __stcs(reinterpret_cast<int4*>(row), make_int4(f[0], f[1], f[2], f[3]));
    } else {
      for (int k = 0; k < n; ++k) row[k] = f[k];
    }
  }
}

}  // namespace

// Launches a (grid_x, grid_y) grid of kThreads-thread blocks on `stream`
// without synchronising; returns cudaGetLastError() (0 = launched). BD is
// B * D < 2^31; block (x, y) covers positions [x * 1024, (x + 1) * 1024)
// of the plane and timesteps [y * t_per_block, (y + 1) * t_per_block).
// `seed` is the int32 seed's bit pattern.
extern "C" int poisson_encode_launch(const void* intens, void* out, int T,
                                     int BD, int D, unsigned int seed,
                                     int grid_x, int grid_y, int t_per_block,
                                     void* stream) {
  if (T <= 0 || BD <= 0 || D <= 0 || BD % D != 0 || t_per_block <= 0 ||
      grid_x <= 0 || grid_y <= 0 || grid_y > 65535 ||
      static_cast<long long>(grid_x) * kThreads * kPerThread < BD ||
      static_cast<long long>(grid_y) * t_per_block < T) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  poisson_encode_kernel<<<dim3(grid_x, grid_y), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(intens), static_cast<int32_t*>(out), T, BD,
      D, t_per_block, seed);
  return static_cast<int>(cudaGetLastError());
}
