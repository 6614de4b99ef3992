// Gradient sign-alignment counts on the parameter arena.
//
// Replaces, in src/repro/kernels/sign_align.py:
//   per_client_sign_align (_per_client_kernel): for each client c, the
//     count of arena slots where sign(u[c]) equals the reference sign r;
//   sign_align_counts (_count_kernel): the same count for one update g,
//     f32 or bf16, as one scalar;
// and their Triton-lowered twins in src/repro/kernels/gpu.py. r carries -2
// on padding, which no sign in {-1, 0, 1} matches.
//
// Bound on the H100: memory. per_client_sign_align reads C*n*4 bytes of
// updates and n bytes of reference signs (n = R*1024) and does a compare
// and an add per slot, far below the card's integer rate. On the main path
// (C <= 16, R = 54) that is about 3.6 MB, about 1.1 us at 3.35 TB/s, so
// one launch costs more than the traffic and the kernel is launch-bound
// there. sign_align_counts moves 5*n bytes for f32 g (0.28 MB at R = 54,
// about 0.08 us): purely launch-bound.
//
// Design: a grid over chunks of the n slots (and, per client, a second
// grid axis). Each thread reads four values with one load (16 bytes of
// f32, 8 of bf16) and four signs with one 4-byte load, in a grid-stride
// loop, and counts in a register. A warp-shuffle and a shared-memory
// reduction leave one partial count per block, which one integer atomicAdd
// adds to a zeroed int32 counter. Integer addition does not depend on
// order, so the counts are exact and the same on every run (the TPU kernels
// count in f32, exact only below 2^24 matches). sign(x) is
// (x > 0) - (x < 0): +0, -0 and NaN give 0, as jnp.sign does for zeros.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 1024;

__device__ __forceinline__ int sign_of(float x) {
  return (x > 0.0f) - (x < 0.0f);
}

__device__ __forceinline__ float4 load4(const float* x, long long i) {
  return reinterpret_cast<const float4*>(x)[i];
}

// bf16 -> f32 is exact, so the sign is the bf16 value's own.
__device__ __forceinline__ float4 load4(const __nv_bfloat16* x, long long i) {
  const uint2 raw = reinterpret_cast<const uint2*>(x)[i];
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ int matches(float4 v, char4 r) {
  return (sign_of(v.x) == r.x) + (sign_of(v.y) == r.y) +
         (sign_of(v.z) == r.z) + (sign_of(v.w) == r.w);
}

// Adds the block's counts into *target with one atomic.
__device__ __forceinline__ void block_add(int count, int* target) {
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
    if (lane == 0) atomicAdd(target, count);
  }
}

// Counts over x[0 .. 4*n4) against r; blockIdx.y picks a slab of x.
template <typename T>
__global__ void __launch_bounds__(kThreads)
sign_align_kernel(const T* __restrict__ x, const char4* __restrict__ r,
                  int* __restrict__ counts, long long n4) {
  const int c = blockIdx.y;
  const T* xc = x + (long long)c * n4 * 4;
  int count = 0;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n4;
       i += (long long)gridDim.x * kThreads) {
    count += matches(load4(xc, i), r[i]);
  }
  block_add(count, counts + c);
}

unsigned blocks_for(long long n4) {
  long long blocks = (n4 + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks < 1) blocks = 1;
  return (unsigned)blocks;
}

}  // namespace

// u: (C, n) f32, r: (n,) int8, counts: (C,) int32 zeroed by the caller;
// n is a multiple of 4 and both u and r are 16-byte aligned. Launches on
// `stream` and returns cudaGetLastError() as an int.
extern "C" int per_client_sign_align(const void* u, const void* r,
                                     void* counts, int clients,
                                     long long n, void* stream) {
  const long long n4 = n / 4;
  dim3 grid(blocks_for(n4), (unsigned)clients);
  sign_align_kernel<float><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)u, (const char4*)r, (int*)counts, n4);
  return (int)cudaGetLastError();
}

// g: (n,) f32 (g_bf16 == 0) or bf16 (g_bf16 != 0), r: (n,) int8, count:
// one int32 zeroed by the caller; n is a multiple of 4, g and r 16-byte
// aligned. Launches on `stream` and returns cudaGetLastError() as an int.
extern "C" int sign_align_counts(const void* g, int g_bf16, const void* r,
                                 void* count, long long n, void* stream) {
  const long long n4 = n / 4;
  dim3 grid(blocks_for(n4), 1);
  if (g_bf16) {
    sign_align_kernel<__nv_bfloat16><<<grid, kThreads, 0,
                                       (cudaStream_t)stream>>>(
        (const __nv_bfloat16*)g, (const char4*)r, (int*)count, n4);
  } else {
    sign_align_kernel<float><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)g, (const char4*)r, (int*)count, n4);
  }
  return (int)cudaGetLastError();
}
