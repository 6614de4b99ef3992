// Cohort gather on the error-feedback arena: the scanned control plane's
// fetch of the selected clients' slabs.
//
// Replaces: src/repro/kernels/gather.py, onehot_gather (_gather_kernel), and
// its Triton-lowered twin in src/repro/kernels/gpu.py. For src (N, R, 1024)
// f32 and idx (K,) int64 it computes out[k] = src[idx[k]], (K, R, 1024) f32.
// The TPU kernel writes this as a one-hot matmul sum_n onehot[k,n] * src[n],
// a workaround for the TPU's matrix unit; on Hopper it is the indexed gather
// it stands for.
//
// Bound on the H100: memory. It reads K*R*4096 bytes of slabs and K*8 of
// indices and writes K*R*4096 bytes, with no arithmetic. On the main path
// (K = 10 clients, R = 54 rows) that is 4.42 MB, 1.32 us at 3.35 TB/s; at
// K = 5, 0.66 us. One launch costs more than that, so the kernel is
// launch-bound there.
//
// Design: one block of 256 threads per (row, slab) pair; each thread copies
// one float4 (16-byte loads and stores, the warp's addresses contiguous).
// More bytes in flight a thread did not make it faster: at 10 of 11 slabs
// of 54 rows one warp of eight float4 a thread took 2.023 and 2.041 us in
// two probes of ten turns against this design's 2.053 and 2.030, 64
// threads of four 2.053-2.060, 16 of sixteen 2.135 (one H100 80GB HBM3,
// 700 W, CUDA graphs; PERF.md section 6); the bound is 1.32 us.
// Every block reads its index from device memory, so the wrapper never
// reads an index on the host and the kernel can run inside a dispatch with
// no host synchronisation. An index outside [0, N) traps the kernel (the
// launch fails loudly at the next synchronisation) and never reads out of
// bounds.
//
// Exactness: the kernel copies bits, so it equals jnp.take (the JAX
// package's oracle, kernels/ref.py cohort_gather) bit for bit, -0.0 and NaN
// payloads included. The one-hot Pallas kernel does not keep them: its sum
// adds 0 * src[n] for every other slab n, so a -0.0 may come out +0.0, and
// an Inf or NaN in any slab makes every output NaN. On finite inputs the
// two agree exactly.

#include <cuda_runtime.h>

namespace {

constexpr int kLane = 1024;
constexpr int kThreads = kLane / 4;          // one float4 per thread

__global__ void __launch_bounds__(kThreads)
cohort_gather_kernel(const float4* __restrict__ src,
                     const long long* __restrict__ idx,
                     float4* __restrict__ out, long long n, long long rows) {
  const long long k = blockIdx.y;
  const long long i = idx[k];
  if (i < 0 || i >= n) __trap();
  const long long row = blockIdx.x;
  out[(k * rows + row) * kThreads + threadIdx.x] =
      src[(i * rows + row) * kThreads + threadIdx.x];
}

}  // namespace

// src: (n, rows, 1024) f32, idx: (k,) int64, out: (k, rows, 1024) f32;
// n, rows >= 1, 1 <= k <= 65535, src and out 16-byte aligned. Launches on
// `stream` and returns cudaGetLastError() as an int.
extern "C" int cohort_gather(const void* src, const void* idx, void* out,
                             long long n, long long rows, int k,
                             void* stream) {
  const dim3 grid((unsigned)rows, (unsigned)k);
  cohort_gather_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float4*)src, (const long long*)idx, (float4*)out, n, rows);
  return (int)cudaGetLastError();
}
