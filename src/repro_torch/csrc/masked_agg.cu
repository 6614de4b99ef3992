// Weighted aggregation of the cohort's updates over the client axis, and
// the same sum subtracted from the parameters in one pass.
//
// Replaces, in src/repro/kernels/masked_agg.py:
//   masked_agg (_agg_kernel): out = sum_c w[c] * u[c], f32;
//   fused_update (_fused_kernel): out = p - sum_c w_lr[c] * u[c] in p's
//     dtype (f32 or bf16), aggregation and apply fused;
// and their Triton-lowered twins in src/repro/kernels/gpu.py. u is (C, n)
// f32, n = R*1024.
//
// Bound on the H100: memory. masked_agg reads C*n*4 bytes of updates and
// writes n*4 bytes, two flops per update read; fused_update also reads p
// once and writes out once in p's dtype. On the main path (C <= 16,
// R = 54) that is 2.7-3.8 MB, about 0.8-1.1 us at 3.35 TB/s, so one launch
// costs more than the traffic and both kernels are launch-bound there.
//
// Design: each thread owns four consecutive outputs. It walks the clients
// in order c = 0..C-1, reading four updates with one 16-byte load (the
// warp's loads are contiguous) and accumulating w[c] * u[c] in f32 with
// fmaf, and writes its four outputs once. fused_update then reads four p
// values (16 bytes of f32 or 8 of bf16), takes p - acc in f32 and rounds it
// once into p's dtype (__float2bfloat16_rn: round to nearest even, as
// .astype(bf16) does). No atomics, no cross-thread reduction: the result
// is the same on every run. fused_update writes a new tensor; p is only
// read.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float4 weighted_sum4(const float4* __restrict__ u,
                                                const float* __restrict__ w,
                                                int clients, long long n4,
                                                long long i) {
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int c = 0; c < clients; ++c) {
    const float wc = w[c];
    const float4 v = u[(long long)c * n4 + i];
    acc.x = fmaf(wc, v.x, acc.x);
    acc.y = fmaf(wc, v.y, acc.y);
    acc.z = fmaf(wc, v.z, acc.z);
    acc.w = fmaf(wc, v.w, acc.w);
  }
  return acc;
}

__device__ __forceinline__ float4 load4(const float* x, long long i) {
  return reinterpret_cast<const float4*>(x)[i];
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* x, long long i) {
  const uint2 raw = reinterpret_cast<const uint2*>(x)[i];
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(float* x, long long i, float4 v) {
  reinterpret_cast<float4*>(x)[i] = v;
}

__device__ __forceinline__ void store4(__nv_bfloat16* x, long long i,
                                       float4 v) {
  __nv_bfloat162 a, b;
  a.x = __float2bfloat16_rn(v.x);
  a.y = __float2bfloat16_rn(v.y);
  b.x = __float2bfloat16_rn(v.z);
  b.y = __float2bfloat16_rn(v.w);
  uint2 raw;
  raw.x = *reinterpret_cast<const unsigned int*>(&a);
  raw.y = *reinterpret_cast<const unsigned int*>(&b);
  reinterpret_cast<uint2*>(x)[i] = raw;
}

__global__ void __launch_bounds__(kThreads)
masked_agg_kernel(const float4* __restrict__ u, const float* __restrict__ w,
                  float4* __restrict__ out, int clients, long long n4) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n4) return;
  out[i] = weighted_sum4(u, w, clients, n4, i);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_update_kernel(const T* __restrict__ p, const float4* __restrict__ u,
                    const float* __restrict__ w, T* __restrict__ out,
                    int clients, long long n4) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n4) return;
  const float4 acc = weighted_sum4(u, w, clients, n4, i);
  const float4 pv = load4(p, i);
  store4(out, i, make_float4(pv.x - acc.x, pv.y - acc.y, pv.z - acc.z,
                             pv.w - acc.w));
}

unsigned blocks_for(long long n4) {
  const long long blocks = (n4 + kThreads - 1) / kThreads;
  return (unsigned)(blocks > 0 ? blocks : 1);
}

}  // namespace

// u: (C, n) f32, w: (C,) f32, out: (n,) f32; n is a multiple of 4 and u,
// out are 16-byte aligned. Launches on `stream` and returns
// cudaGetLastError() as an int.
extern "C" int masked_agg(const void* u, const void* w, void* out,
                          int clients, long long n, void* stream) {
  const long long n4 = n / 4;
  masked_agg_kernel<<<blocks_for(n4), kThreads, 0, (cudaStream_t)stream>>>(
      (const float4*)u, (const float*)w, (float4*)out, clients, n4);
  return (int)cudaGetLastError();
}

// p, out: (n,) f32 (p_bf16 == 0) or bf16 (p_bf16 != 0); u: (C, n) f32;
// w_lr: (C,) f32; n is a multiple of 4 and p, u, out are 16-byte aligned.
// Launches on `stream` and returns cudaGetLastError() as an int.
extern "C" int fused_update(const void* p, int p_bf16, const void* u,
                            const void* w_lr, void* out, int clients,
                            long long n, void* stream) {
  const long long n4 = n / 4;
  if (p_bf16) {
    fused_update_kernel<__nv_bfloat16><<<blocks_for(n4), kThreads, 0,
                                         (cudaStream_t)stream>>>(
        (const __nv_bfloat16*)p, (const float4*)u, (const float*)w_lr,
        (__nv_bfloat16*)out, clients, n4);
  } else {
    fused_update_kernel<float><<<blocks_for(n4), kThreads, 0,
                                 (cudaStream_t)stream>>>(
        (const float*)p, (const float4*)u, (const float*)w_lr, (float*)out,
        clients, n4);
  }
  return (int)cudaGetLastError();
}
