// Per-row symmetric int8 quantization of the parameter arena, and its
// inverse: the wire format of int8 compression with error feedback.
//
// Replaces: src/repro/kernels/quantize.py, quantize_q8 (_quant_kernel) and
// dequantize_q8 (_dequant_kernel), and their Triton-lowered twins in
// src/repro/kernels/gpu.py. For x (R, 1024) f32 it computes, row by row,
//   scale = max(max|x|, 1e-12) / 127          (R, 1) f32
//   q     = clip(round_half_even(x / scale), -127, 127)   (R, 1024) int8
// and the inverse q * scale (R, 1024) f32.
//
// Bound on the H100: memory. Each kernel moves 5 bytes per element (4 of
// f32, 1 of int8) and 4 per row, with a handful of operations per element.
// At 864 rows (16 clients x 54 rows, the cohort folded) that is 4.43 MB,
// 1.32 us at 3.35 TB/s; at 54 rows (one client) 0.28 MB, 0.08 us, so one
// launch costs more than the traffic and the kernel is launch-bound there.
//
// Design: one block of 256 threads per row, so a row is read once and every
// thread reads one float4 (16 bytes, the warp's loads contiguous) and keeps
// it in registers. The row's max |x| comes from warp shuffles and eight
// partial maxima in shared memory; max does not depend on order, so every
// thread holds the same amax. Each thread then writes its four codes as one
// char4, and thread 0 the scale. Dequantization reads one char4 and the
// row's scale per thread and writes one float4. One pass over the data in
// each direction, no atomics, the same result on every run.
//
// Bit-exactness with the plain version (kernels/ref.py), which the error
// feedback needs, or trajectories part:
//  - the scale and x / scale are IEEE divisions (__fdiv_rn), not products
//    with a reciprocal, which differ in the last bit and flip codes at ties;
//  - rounding is half to even (rintf), as torch.round and jnp.round, not
//    roundf (half away from zero); the clamp comes after the rounding;
//  - the dequantized value is one rounded product (__fmul_rn), never fused
//    into an FMA with a later subtraction.
// NaN and infinite inputs are outside the contract: the scale and codes of
// such a row are unspecified.

#include <cuda_runtime.h>

namespace {

constexpr int kLane = 1024;
constexpr int kThreads = kLane / 4;          // one float4 per thread
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ signed char code(float x, float scale) {
  const float r = rintf(__fdiv_rn(x, scale));
  return (signed char)(int)fminf(fmaxf(r, -127.0f), 127.0f);
}

__global__ void __launch_bounds__(kThreads)
quantize_q8_kernel(const float4* __restrict__ x, char4* __restrict__ q,
                   float* __restrict__ scale) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  const float4 v = x[i];
  float amax = fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)),
                     fmaxf(fabsf(v.z), fabsf(v.w)));
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  __shared__ float warp_max[kWarps];
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = amax;
  __syncthreads();
  amax = warp_max[0];
  for (int w = 1; w < kWarps; ++w) amax = fmaxf(amax, warp_max[w]);
  const float s = __fdiv_rn(fmaxf(amax, 1e-12f), 127.0f);
  q[i] = make_char4(code(v.x, s), code(v.y, s), code(v.z, s), code(v.w, s));
  if (threadIdx.x == 0) scale[blockIdx.x] = s;
}

__global__ void __launch_bounds__(kThreads)
dequantize_q8_kernel(const char4* __restrict__ q,
                     const float* __restrict__ scale,
                     float4* __restrict__ out) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  const char4 c = q[i];
  const float s = scale[blockIdx.x];
  out[i] = make_float4(__fmul_rn((float)c.x, s), __fmul_rn((float)c.y, s),
                       __fmul_rn((float)c.z, s), __fmul_rn((float)c.w, s));
}

}  // namespace

// x: (rows, 1024) f32, q: (rows, 1024) int8, scale: (rows,) f32; rows >= 1,
// x and q 16-byte aligned. Launches on `stream` and returns
// cudaGetLastError() as an int.
extern "C" int quantize_q8(const void* x, void* q, void* scale,
                           long long rows, void* stream) {
  quantize_q8_kernel<<<(unsigned)rows, kThreads, 0, (cudaStream_t)stream>>>(
      (const float4*)x, (char4*)q, (float*)scale);
  return (int)cudaGetLastError();
}

// q: (rows, 1024) int8, scale: (rows,) f32, out: (rows, 1024) f32; rows >= 1,
// q and out 16-byte aligned. Launches on `stream` and returns
// cudaGetLastError() as an int.
extern "C" int dequantize_q8(const void* q, const void* scale, void* out,
                             long long rows, void* stream) {
  dequantize_q8_kernel<<<(unsigned)rows, kThreads, 0,
                         (cudaStream_t)stream>>>(
      (const char4*)q, (const float*)scale, (float4*)out);
  return (int)cudaGetLastError();
}
