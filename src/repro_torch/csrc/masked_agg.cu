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
// R = 54) that is 2.7-3.8 MB, about 0.8-1.1 us at 3.35 TB/s. The inputs
// come from the kernel before (the cohort step), so they sit in the 50 MB
// L2: at this size the time is set by how many loads are in flight and on
// how many SMs, not by HBM's rate.
//
// Design: each thread owns four consecutive outputs (one float4). It walks
// the clients in chunks of kChunk: it issues the chunk's kChunk 16-byte
// loads first (read-only, not kept in L1: ld.global.nc.L1::no_allocate;
// the warp's loads of one client are contiguous), then does the chunk's
// FMAs in client order, acc = fmaf(w[c], u[c][i], acc) from acc = +0 for
// c = 0..C-1. A slot past the last client is cut by a predicate inside
// the load instruction and a predicate on its FMAs, so any C takes the
// same code. The weights are read once a block into shared memory, kWTile
// at a time, after the first chunk's loads are issued, so their latency
// hides under those loads. Threads of the last block past the output
// read float4 0 so that they reach the barriers, and store nothing.
// fused_update issues its p load first, takes p - acc in f32 and rounds
// it once into p's dtype (__float2bfloat16_rn: round to nearest even, as
// .astype(bf16) does). Every output is the same f32 FMA chain in the same
// order as the earlier one-loop kernel's (no split of the client axis, no
// atomics, no client skipped when its weight is 0: 0 * Inf is NaN, and
// -0.0 + 0 * x is +0.0), so results are equal by bits run to run and to
// that kernel. fused_update writes a new tensor; p is only read.
//
// Why these sizes (one H100 80GB HBM3, 700 W, device time of 50 launches
// in a CUDA graph, medians; PERF.md section 6): kThreads = 64 spreads the
// main shape's 13,824 float4 outputs (C 16 x R 54) over 216 blocks, so all
// 132 SMs work where the earlier 256-thread blocks left 78 idle: 2.02 us
// against 2.04 at 32 threads, 2.10 at 128, 2.27 at 256 and 2.61 for the
// earlier kernel. kChunk = 16 puts a whole cohort of up to 16 clients in
// flight at once: fused_update at C 10 x R 54 takes 1.92 us against 2.06
// with chunks of 8. The predicate inside the load, instead of a branch
// around it, takes C 5 x R 7 from 1.78 to 1.54 us. The price is registers
// (96 in masked_agg, up to 126 in fused_update), so fewer blocks fit on an
// SM; at C 4 x R 4096 (84 MB, past the L2) the kernel still takes 26.3 us
// against the earlier 29.3. Staging the weights behind a barrier is what
// keeps a chunk's 16 loads in flight: with the weights read instead by
// __ldg in the FMA loop, or by ordered read-only loads after the chunk's
// loads, and no barrier, ptxas puts each FMA beside its load (32
// registers) and masked_agg at C 16 x R 54 takes 2.27-2.59 us against
// 2.01-2.03 staged, fused_update at C 10 x R 54 2.37-2.63 against
// 1.96-2.12 (two probe calls, ten alternating turns each, slower in every
// turn).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;   // threads a block, one float4 of output each
constexpr int kChunk = 16;     // clients whose loads a thread issues at once
constexpr int kWTile = 256;    // weights staged in shared memory at a time

// One 16-byte load, read-only and not kept in L1, issued only when `on`:
// the predicate sits inside the instruction, so a slot past the last
// client costs no branch. Returns zeros when off.
__device__ __forceinline__ float4 load_stream(const float4* p, bool on) {
  float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  asm volatile(
      "{\n.reg .pred q;\nsetp.ne.b32 q, %5, 0;\n"
      "@q ld.global.nc.L1::no_allocate.v4.f32 {%0, %1, %2, %3}, [%4];\n}"
      : "+f"(v.x), "+f"(v.y), "+f"(v.z), "+f"(v.w)
      : "l"(p), "r"((int)on));
  return v;
}

__device__ __forceinline__ uint2 load_stream(const uint2* p) {
  uint2 v;
  asm volatile("ld.global.nc.L1::no_allocate.v2.u32 {%0, %1}, [%2];"
               : "=r"(v.x), "=r"(v.y)
               : "l"(p));
  return v;
}

// Σ_c w[c] * u[c][i] over c = 0..clients-1 in order, one fmaf a term,
// Chunk clients' loads issued before their first FMA. Every thread of the
// block calls it with the same `clients` (it holds the block's barriers);
// i is a valid float4 index for every thread.
template <int Chunk>
__device__ __forceinline__ float4 weighted_sum4(const float4* __restrict__ u,
                                                const float* __restrict__ w,
                                                float* ws, int clients,
                                                long long n4, long long i) {
  static_assert(kWTile % Chunk == 0, "a chunk never straddles two tiles");
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int c0 = 0; c0 < clients; c0 += Chunk) {
    const int m = min(Chunk, clients - c0);
    float4 v[Chunk];
#pragma unroll
    for (int k = 0; k < Chunk; ++k)
      v[k] = load_stream(u + (long long)(c0 + k) * n4 + i, k < m);
    if (c0 % kWTile == 0) {            // the chunk opens a tile of weights
      if (c0 > 0) __syncthreads();     // the last tile is read by all
      const int tile = min(kWTile, clients - c0);
      for (int j = threadIdx.x; j < tile; j += kThreads) ws[j] = w[c0 + j];
      __syncthreads();
    }
    const float* wc = ws + c0 % kWTile;
#pragma unroll
    for (int k = 0; k < Chunk; ++k) {
      if (k < m) {
        const float wk = wc[k];
        acc.x = fmaf(wk, v[k].x, acc.x);
        acc.y = fmaf(wk, v[k].y, acc.y);
        acc.z = fmaf(wk, v[k].z, acc.z);
        acc.w = fmaf(wk, v[k].w, acc.w);
      }
    }
  }
  return acc;
}

__device__ __forceinline__ float4 load4(const float* x, long long i) {
  return load_stream(reinterpret_cast<const float4*>(x) + i, true);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* x, long long i) {
  const uint2 raw = load_stream(reinterpret_cast<const uint2*>(x) + i);
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

// The chunk size is a template argument, so the kernel's name in a trace
// shows it. At n4 = 0 the one block returns before any load or barrier.
template <int Chunk>
__global__ void __launch_bounds__(kThreads)
masked_agg_kernel(const float4* __restrict__ u, const float* __restrict__ w,
                  float4* __restrict__ out, int clients, long long n4) {
  if (n4 == 0) return;
  __shared__ float ws[kWTile];
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  const float4 acc =
      weighted_sum4<Chunk>(u, w, ws, clients, n4, i < n4 ? i : 0);
  if (i < n4) out[i] = acc;
}

template <int Chunk, typename T>
__global__ void __launch_bounds__(kThreads)
fused_update_kernel(const T* __restrict__ p, const float4* __restrict__ u,
                    const float* __restrict__ w, T* __restrict__ out,
                    int clients, long long n4) {
  if (n4 == 0) return;
  __shared__ float ws[kWTile];
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long j = i < n4 ? i : 0;
  const float4 pv = load4(p, j);
  const float4 acc = weighted_sum4<Chunk>(u, w, ws, clients, n4, j);
  if (i < n4)
    store4(out, i, make_float4(pv.x - acc.x, pv.y - acc.y, pv.z - acc.z,
                               pv.w - acc.w));
}

unsigned blocks_for(long long n4) {
  const long long blocks = (n4 + kThreads - 1) / kThreads;
  return (unsigned)(blocks > 0 ? blocks : 1);
}

}  // namespace

// u: (C, n) f32, w: (C,) f32, out: (n,) f32; n is a multiple of 4 (0
// launches one block that stores nothing) and u, out are 16-byte
// aligned. Launches on `stream` and returns cudaGetLastError() as an int.
extern "C" int masked_agg(const void* u, const void* w, void* out,
                          int clients, long long n, void* stream) {
  const long long n4 = n / 4;
  masked_agg_kernel<kChunk><<<blocks_for(n4), kThreads, 0,
                              (cudaStream_t)stream>>>(
      (const float4*)u, (const float*)w, (float4*)out, clients, n4);
  return (int)cudaGetLastError();
}

// p, out: (n,) f32 (p_bf16 == 0) or bf16 (p_bf16 != 0); u: (C, n) f32;
// w_lr: (C,) f32; n is a multiple of 4 (0 as above) and p, u, out are
// 16-byte aligned. Launches on `stream` and returns cudaGetLastError() as
// an int.
extern "C" int fused_update(const void* p, int p_bf16, const void* u,
                            const void* w_lr, void* out, int clients,
                            long long n, void* stream) {
  const long long n4 = n / 4;
  if (p_bf16) {
    fused_update_kernel<kChunk, __nv_bfloat16><<<blocks_for(n4), kThreads,
                                                 0, (cudaStream_t)stream>>>(
        (const __nv_bfloat16*)p, (const float4*)u, (const float*)w_lr,
        (__nv_bfloat16*)out, clients, n4);
  } else {
    fused_update_kernel<kChunk, float><<<blocks_for(n4), kThreads, 0,
                                         (cudaStream_t)stream>>>(
        (const float*)p, (const float4*)u, (const float*)w_lr, (float*)out,
        clients, n4);
  }
  return (int)cudaGetLastError();
}
