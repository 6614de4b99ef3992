// Per-client gradient sign-alignment counts on the parameter arena.
//
// Replaces: src/repro/kernels/sign_align.py, per_client_sign_align
// (_per_client_kernel), and its Triton-lowered twin in
// src/repro/kernels/gpu.py. For each client c it counts the arena slots
// where sign(u[c]) equals the reference sign r; r carries -2 on padding,
// which no sign in {-1, 0, 1} matches.
//
// Bound on the H100: memory. It reads C*n*4 bytes of updates and n bytes of
// reference signs (n = R*1024) and does a compare and an add per slot, far
// below the card's integer rate. On the main path (C <= 16, R = 54) that is
// about 3.6 MB, about 1.1 us at 3.35 TB/s, so one launch costs more than
// the traffic and the kernel is launch-bound there.
//
// Design: a 2-D grid over (chunk of the n slots, client). Each thread reads
// four updates with one 16-byte load and four signs with one 4-byte load,
// in a grid-stride loop, and counts in a register. A warp-shuffle and a
// shared-memory reduction leave one partial count per block, which one
// integer atomicAdd adds to the client's int32 counter. Integer addition
// does not depend on order, so the counts are exact and the same on every
// run (the TPU kernel counts in f32, exact only below 2^24 matches).
// sign(x) is (x > 0) - (x < 0): +0 and -0 give 0, as jnp.sign does.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int sign_of(float x) {
  return (x > 0.0f) - (x < 0.0f);
}

__device__ __forceinline__ int matches(float4 v, char4 r) {
  return (sign_of(v.x) == r.x) + (sign_of(v.y) == r.y) +
         (sign_of(v.z) == r.z) + (sign_of(v.w) == r.w);
}

__global__ void __launch_bounds__(kThreads)
per_client_sign_align_kernel(const float4* __restrict__ u,
                             const char4* __restrict__ r,
                             int* __restrict__ counts, long long n4) {
  const int c = blockIdx.y;
  const float4* uc = u + (long long)c * n4;
  int count = 0;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n4;
       i += (long long)gridDim.x * kThreads) {
    count += matches(uc[i], r[i]);
  }
  for (int off = 16; off > 0; off >>= 1)
    count += __shfl_down_sync(0xffffffffu, count, off);
  __shared__ int warp_sums[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = count;
  __syncthreads();
  if (warp == 0) {
    count = lane < kThreads / 32 ? warp_sums[lane] : 0;
    for (int off = 16; off > 0; off >>= 1)
      count += __shfl_down_sync(0xffffffffu, count, off);
    if (lane == 0) atomicAdd(counts + c, count);
  }
}

}  // namespace

// u: (C, n) f32, r: (n,) int8, counts: (C,) int32 zeroed by the caller;
// n is a multiple of 4 and both u and r are 16-byte aligned. Launches on
// `stream` and returns cudaGetLastError() as an int.
extern "C" int per_client_sign_align(const void* u, const void* r,
                                     void* counts, int clients,
                                     long long n, void* stream) {
  const long long n4 = n / 4;
  long long blocks = (n4 + kThreads - 1) / kThreads;
  if (blocks > 1024) blocks = 1024;
  if (blocks < 1) blocks = 1;
  dim3 grid((unsigned)blocks, (unsigned)clients);
  per_client_sign_align_kernel<<<grid, kThreads, 0,
                                 (cudaStream_t)stream>>>(
      (const float4*)u, (const char4*)r, (int*)counts, n4);
  return (int)cudaGetLastError();
}
