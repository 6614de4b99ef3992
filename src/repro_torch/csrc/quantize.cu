// Per-row symmetric int8 quantization of the parameter arena, its inverse,
// and the error-feedback round trip that the int8 cohort paths run.
//
// Replaces: src/repro/kernels/quantize.py, quantize_q8 (_quant_kernel) and
// dequantize_q8 (_dequant_kernel), and their Triton-lowered twins in
// src/repro/kernels/gpu.py. For x (R, 1024) f32 it computes, row by row,
//   scale = max(max|x|, 1e-12) / 127          (R, 1) f32
//   q     = clip(round_half_even(x / scale), -127, 127)   (R, 1024) int8
// and the inverse q * scale (R, 1024) f32. ef_round_trip is quantize_q8's
// form on the megastep, scanned and spmd paths (core/compression.py,
// compress_cohort): for the deltas d and the error-feedback buffers e,
// (M, 1024) f32 each, it codes c = d + e row by row as quantize_q8 does
// and writes
//   restored = q * scale        (what the server sees)
//   residual = c - restored     (the error feedback carried on)
// in one pass, where the plain composition runs an add, the two codec
// kernels and a subtraction. The codes never reach memory: nothing on
// those paths reads them (wire bytes are counted from the shapes).
//
// Rows a call on the quickstart's paths (10 clients, 54 rows each): the
// per-client loop codes one client, 54 rows; the megastep folds each
// (steps, batch) group padded to 1, 2, 4 or 8 clients, 54 to 432 rows, most
// calls 54 or 108; the scanned and spmd paths fold the whole cohort, 270 or
// 540 rows.
//
// Bound on the H100: memory. quantize_q8 and dequantize_q8 move 5 bytes
// per element (4 of f32, 1 of int8) and 4 per row, with a handful of
// operations per element: at 54 rows 0.28 MB, 0.08 us at 3.35 TB/s, so one
// launch costs more than the traffic. ef_round_trip reads 8 and writes 8
// bytes per element, 0.88 MB at 54 rows (0.26 us) and 8.8 MB at 540
// (2.64 us), against 34 bytes per element for the add, the codec pair and
// the subtraction.
//
// Design: one block per row, so a row is read once and every thread keeps
// its values in registers: up to kWideRows rows 512 threads of one float2
// each, beyond it 256 threads of one float4 (the warp's loads contiguous
// either way). The row's max |x| comes from warp shuffles and the warps'
// partial maxima in shared memory; max does not depend on order, so every
// thread holds the same amax. Each thread then writes its codes as one
// char2 or char4, and thread 0 the scale; ef_round_trip writes a float2 or
// float4 of each output instead. Dequantization reads one char4 and the
// row's scale per thread and writes one float4. One pass over the data in
// each direction, no atomics, the same result on every run.
//
// Why (one H100 80GB HBM3, 700 W, device time of 50 calls in a CUDA graph,
// medians of ten alternating turns; PERF.md section 6): the IEEE divisions
// set the time. With x * s in place of __fdiv_rn(x, s) (a timing-only
// probe, wrong codes) one warp a row (eight float4 a lane, 32 divisions a
// thread) drops from 8.92 to 2.48 us at 864 rows, and 256 threads a row
// from 2.78 to 2.31. Fewer values a thread shorten each thread's chain of
// divisions: at 54 rows 512 threads take 2.00 us against 2.34 for 256, and
// the round trip 2.09 against 2.45; 512 stay faster up to 432 rows (2.43
// against 2.47, the round trip 2.73 against 2.87). At 540 rows 256 win
// (the round trip 3.06 against 3.20): 512-thread blocks fit 528 rows in one
// wave of the card (four to an SM), 256-thread blocks 1056. 1024 threads a
// row (one float) are slower than 512 at every size, 128 (two float4)
// slower than 256 at 54 and 864 rows.
// The round trip takes 2.09 us at 54 rows and 3.06 at 540 where the add,
// the codec pair and the subtraction took 6.35 and 8.36.
// Dequantization is at the launch's floor with one block a row: at the
// loop's 54 rows, 256 threads of one char4 take 1.28-1.29 us in two
// probes of ten turns each, and every design that spreads a row over more,
// smaller blocks, so that every SM works, is slower (64 threads of one
// char4, 216 blocks: 1.333; 16 threads of four, 16 codes a thread: 1.39;
// 32 of four: 1.39; 16 codes in one 16-byte load: 1.41-1.52), as are
// fewer, larger blocks (two rows a block: 1.31-1.33; four: 1.46) and 512
// threads of one char2 (1.290, equal). At 864 rows 32 threads of four
// char4 are 1.2-1.6% faster (2.145-2.165 against 2.180-2.192), a row
// count no path gives the kernel, so there is no switch.
//
// Bit-exactness with the plain version (kernels/ref.py), which the error
// feedback needs, or trajectories part:
//  - the scale and x / scale are IEEE divisions (__fdiv_rn), not products
//    with a reciprocal, which differ in the last bit and flip codes at ties;
//  - rounding is half to even (rintf), as torch.round and jnp.round, not
//    roundf (half away from zero); the clamp comes after the rounding;
//  - the dequantized value is one rounded product (__fmul_rn), and the
//    sum and the residual are rounded additions (__fadd_rn, __fsub_rn):
//    the compiler may not contract c - q * scale into an FMA, which would
//    part from the plain path in the last bit and feed back through the
//    error feedback.
// quantize_q8 and ef_round_trip take the scale and codes from one
// function (code_row), so they cannot round differently.
// NaN and infinite inputs are outside the contract: the scale and codes of
// such a row are unspecified.

#include <cuda_runtime.h>

namespace {

constexpr int kLane = 1024;
// Up to this many rows a row takes 512 threads of two values each, beyond
// it 256 threads of four: the last row count the paths run at which 512
// threads were measured faster (the header says why).
constexpr long long kWideRows = 432;

// W values a thread, so kLane / W threads a row.
template <int W> struct Vec;
template <> struct Vec<4> { using F = float4; using C = char4; };
template <> struct Vec<2> { using F = float2; using C = char2; };

__device__ __forceinline__ void unpack(float4 v, float (&a)[4]) {
  a[0] = v.x; a[1] = v.y; a[2] = v.z; a[3] = v.w;
}
__device__ __forceinline__ void unpack(float2 v, float (&a)[2]) {
  a[0] = v.x; a[1] = v.y;
}
__device__ __forceinline__ float4 pack(const float (&a)[4]) {
  return make_float4(a[0], a[1], a[2], a[3]);
}
__device__ __forceinline__ float2 pack(const float (&a)[2]) {
  return make_float2(a[0], a[1]);
}
__device__ __forceinline__ char4 pack(const signed char (&k)[4]) {
  return make_char4(k[0], k[1], k[2], k[3]);
}
__device__ __forceinline__ char2 pack(const signed char (&k)[2]) {
  return make_char2(k[0], k[1]);
}

__device__ __forceinline__ signed char code(float x, float scale) {
  const float r = rintf(__fdiv_rn(x, scale));
  return (signed char)(int)fminf(fmaxf(r, -127.0f), 127.0f);
}

// The codes k of the W values a that this thread holds of the block's row,
// and the row's scale, max(max|x|, 1e-12) / 127, which it returns (every
// thread calls it and gets the same scale).
template <int W>
__device__ __forceinline__ float code_row(const float (&a)[W],
                                          signed char (&k)[W]) {
  constexpr int kWarps = kLane / W / 32;
  float amax = 0.0f;
#pragma unroll
  for (int i = 0; i < W; ++i) amax = fmaxf(amax, fabsf(a[i]));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  __shared__ float warp_max[kWarps];
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = amax;
  __syncthreads();
  amax = warp_max[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) amax = fmaxf(amax, warp_max[w]);
  const float s = __fdiv_rn(fmaxf(amax, 1e-12f), 127.0f);
#pragma unroll
  for (int i = 0; i < W; ++i) k[i] = code(a[i], s);
  return s;
}

template <int W>
__global__ void __launch_bounds__(kLane / W)
quantize_q8_kernel(const typename Vec<W>::F* __restrict__ x,
                   typename Vec<W>::C* __restrict__ q,
                   float* __restrict__ scale) {
  const long long i = (long long)blockIdx.x * (kLane / W) + threadIdx.x;
  float a[W];
  signed char k[W];
  unpack(x[i], a);
  const float s = code_row<W>(a, k);
  q[i] = pack(k);
  if (threadIdx.x == 0) scale[blockIdx.x] = s;
}

template <int W>
__global__ void __launch_bounds__(kLane / W)
ef_round_trip_kernel(const typename Vec<W>::F* __restrict__ d,
                     const typename Vec<W>::F* __restrict__ e,
                     typename Vec<W>::F* __restrict__ restored,
                     typename Vec<W>::F* __restrict__ residual) {
  const long long i = (long long)blockIdx.x * (kLane / W) + threadIdx.x;
  float c[W], b[W], r[W], t[W];
  signed char k[W];
  unpack(d[i], c);
  unpack(e[i], b);
#pragma unroll
  for (int j = 0; j < W; ++j) c[j] = __fadd_rn(c[j], b[j]);
  const float s = code_row<W>(c, k);
#pragma unroll
  for (int j = 0; j < W; ++j) {
    r[j] = __fmul_rn((float)k[j], s);
    t[j] = __fsub_rn(c[j], r[j]);
  }
  restored[i] = pack(r);
  residual[i] = pack(t);
}

constexpr int kDequantThreads = kLane / 4;   // one char4 per thread

__global__ void __launch_bounds__(kDequantThreads)
dequantize_q8_kernel(const char4* __restrict__ q,
                     const float* __restrict__ scale,
                     float4* __restrict__ out) {
  const long long i = (long long)blockIdx.x * kDequantThreads + threadIdx.x;
  const char4 c = q[i];
  const float s = scale[blockIdx.x];
  out[i] = make_float4(__fmul_rn((float)c.x, s), __fmul_rn((float)c.y, s),
                       __fmul_rn((float)c.z, s), __fmul_rn((float)c.w, s));
}

template <int W>
void launch_quantize(const void* x, void* q, void* scale, long long rows,
                     cudaStream_t stream) {
  quantize_q8_kernel<W><<<(unsigned)rows, kLane / W, 0, stream>>>(
      (const typename Vec<W>::F*)x, (typename Vec<W>::C*)q, (float*)scale);
}

template <int W>
void launch_round_trip(const void* d, const void* e, void* restored,
                       void* residual, long long rows, cudaStream_t stream) {
  using F = typename Vec<W>::F;
  ef_round_trip_kernel<W><<<(unsigned)rows, kLane / W, 0, stream>>>(
      (const F*)d, (const F*)e, (F*)restored, (F*)residual);
}

}  // namespace

// x: (rows, 1024) f32, q: (rows, 1024) int8, scale: (rows,) f32; rows >= 1,
// x and q 16-byte aligned. Launches on `stream` and returns
// cudaGetLastError() as an int.
extern "C" int quantize_q8(const void* x, void* q, void* scale,
                           long long rows, void* stream) {
  if (rows <= kWideRows)
    launch_quantize<2>(x, q, scale, rows, (cudaStream_t)stream);
  else
    launch_quantize<4>(x, q, scale, rows, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

// q: (rows, 1024) int8, scale: (rows,) f32, out: (rows, 1024) f32; rows >= 1,
// q and out 16-byte aligned. Launches on `stream` and returns
// cudaGetLastError() as an int.
extern "C" int dequantize_q8(const void* q, const void* scale, void* out,
                             long long rows, void* stream) {
  dequantize_q8_kernel<<<(unsigned)rows, kDequantThreads, 0,
                         (cudaStream_t)stream>>>(
      (const char4*)q, (const float*)scale, (float4*)out);
  return (int)cudaGetLastError();
}

// d, e, restored, residual: (rows, 1024) f32 each, 16-byte aligned, the
// outputs apart from the inputs; rows >= 1. Writes restored = deQ(Q(d + e))
// and residual = (d + e) - restored. Launches on `stream` and returns
// cudaGetLastError() as an int.
extern "C" int ef_round_trip(const void* d, const void* e, void* restored,
                             void* residual, long long rows, void* stream) {
  if (rows <= kWideRows)
    launch_round_trip<2>(d, e, restored, residual, rows,
                         (cudaStream_t)stream);
  else
    launch_round_trip<4>(d, e, restored, residual, rows,
                         (cudaStream_t)stream);
  return (int)cudaGetLastError();
}
