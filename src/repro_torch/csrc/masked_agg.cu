// Weighted aggregation of the cohort's updates over the client axis.
//
// Replaces: src/repro/kernels/masked_agg.py, masked_agg (_agg_kernel), and
// its Triton-lowered twin in src/repro/kernels/gpu.py. It computes
// out = sum_c w[c] * u[c] for u (C, n) f32 and w (C,) f32, n = R*1024.
//
// Bound on the H100: memory. It reads C*n*4 bytes of updates and writes
// n*4 bytes, two flops per update read. On the main path (C <= 16, R = 54)
// that is about 3.8 MB, about 1.1 us at 3.35 TB/s, so one launch costs more
// than the traffic and the kernel is launch-bound there.
//
// Design: each thread owns four consecutive outputs. It walks the clients
// in order c = 0..C-1, reading four updates with one 16-byte load (the
// warp's loads are contiguous) and accumulating w[c] * u[c] in f32 with
// fmaf, and writes its four outputs once. No atomics, no cross-thread
// reduction: the result is the same on every run.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
masked_agg_kernel(const float4* __restrict__ u, const float* __restrict__ w,
                  float4* __restrict__ out, int clients, long long n4) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n4) return;
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int c = 0; c < clients; ++c) {
    const float wc = w[c];
    const float4 v = u[(long long)c * n4 + i];
    acc.x = fmaf(wc, v.x, acc.x);
    acc.y = fmaf(wc, v.y, acc.y);
    acc.z = fmaf(wc, v.z, acc.z);
    acc.w = fmaf(wc, v.w, acc.w);
  }
  out[i] = acc;
}

}  // namespace

// u: (C, n) f32, w: (C,) f32, out: (n,) f32; n is a multiple of 4 and u,
// out are 16-byte aligned. Launches on `stream` and returns
// cudaGetLastError() as an int.
extern "C" int masked_agg(const void* u, const void* w, void* out,
                          int clients, long long n, void* stream) {
  const long long n4 = n / 4;
  const long long blocks = (n4 + kThreads - 1) / kThreads;
  masked_agg_kernel<<<(unsigned)(blocks > 0 ? blocks : 1), kThreads, 0,
                      (cudaStream_t)stream>>>(
      (const float4*)u, (const float*)w, (float4*)out, clients, n4);
  return (int)cudaGetLastError();
}
