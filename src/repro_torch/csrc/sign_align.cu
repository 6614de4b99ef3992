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
// per_client_sign_align also takes P references at once: r (P, n) with
// group = C / P clients a reference, client c counted against r[c / group].
// That is the topology sync's jax.vmap of the Pallas kernel over parents
// (src/repro/topology/engine.py:158) as one launch: the grid's y index is
// the reference (grid (k * group, P)), so a cluster finds its reference
// row with no division. P = 1 (group = C) launches the kernel's ungrouped
// instantiation, the flat θ filter's code unchanged: every address
// computation added to the grouped form (first a 64-bit division of the
// client index on the loads' address path, then the y index) made the
// P = 1 launch slower than the earlier kernel in every turn of one call.
//
// Bound on the H100: memory. per_client_sign_align reads C*n*4 bytes of
// updates and n bytes of reference signs (n = R*1024) and does a compare
// and an add per slot, far below the card's integer rate. On the main path
// (C <= 16, R = 54) that is about 3.6 MB, about 1.1 us at 3.35 TB/s, so
// one launch costs more than the traffic and the kernel is launch-bound
// there. sign_align_counts moves 5*n bytes for f32 g (0.28 MB at R = 54,
// about 0.08 us): purely launch-bound.
//
// Design: one launch a call, which writes the final f32 counts into an
// output the caller allocates uninitialised; nothing is carried between
// calls (no zeroed counter, no atomics into the output, no second launch).
// Each count is taken by one thread-block cluster of k blocks (grid
// (k*C/P, P), cluster (k, 1, 1)), k <= 8, the portable limit, chosen on
// the host so that about 132 blocks or more work where C and n allow it:
// 8 at the main shape, 128 blocks. The threads of a cluster stride over
// the slab together; each issues a batch of kBatch read-only loads of four
// values (16 bytes of f32, 8 of bf16) and four signs before it counts any
// of them, the predicate of a slot past the end inside the load
// instruction.
// Warp shuffles and the block's shared memory reduce the threads' counts;
// thread 0 of each block writes the block's count into rank 0's shared
// memory through distributed shared memory, and after the cluster's
// barrier rank 0 adds the k partials and writes the count, converted
// once. With n = 0 every block returns before any load or barrier, rank 0
// having written 0.
//
// Two cluster barriers order the shared memory. A block may touch another
// block's shared memory only once that block has started (CUDA C++
// Programming Guide, Distributed Shared Memory), so the barrier is split:
// every thread arrives (barrier.cluster.arrive.relaxed) before its loads
// and waits (barrier.cluster.wait) after its block's sum, just before the
// remote store; the wait overlaps the loads, and when it returns every
// block of the cluster has started. The full cluster.sync() after the
// stores (arrive with release, wait with acquire) orders them before rank
// 0 reads its partials, and keeps rank 0 alive until they have landed.
//
// Why (one H100 80GB HBM3, 700 W, device time of 50 calls in a CUDA graph,
// medians of ten alternating turns; PERF.md section 6): at C 16 x R 54
// this takes 3.57 us where the earlier zero-fill, atomics kernel and cast
// took 5.19, and one block of 1024 threads a count, the simplest design,
// 5.50 (16 SMs each reading 221 KB). Plain loads, with or without a
// branch around each, let the compiler put each count beside its load
// (32 registers) and took 3.94-3.99 us; 512 threads with batches of 4
// are within 0.02 us. Of the 3.57 us, the cluster launch costs about 0.5
// and the cluster barrier about 0.6 (the same kernel with one-block
// clusters against a plain launch, and with atomics in place of the
// barrier). The split barrier that orders the remote store costs 0.11 us
// more at that shape (3.54 -> 3.66) and 0.04-0.05 at C 1 x R 54 and for
// one count of R 54; keeping each partial in its own block's shared
// memory, read by rank 0 between two cluster.sync(), cost 0.5-0.7. At
// R 864, 8 blocks a count read 57 MB in 24.8 us (the earlier kernel 27.7)
// but one update of 4.4 MB in 11.8 (5.2): the cluster limit holds the
// count to 8 SMs.
//
// Exactness: counts are int32 from the first thread to the last partial
// (n < 2^31, which the wrappers enforce, so nothing wraps) and integer
// addition does not depend on order; the one conversion, __int2float_rn,
// rounds to nearest even as the plain version's int64 -> f32 .to does, so
// the two are equal by bits. (The TPU kernels count in f32, exact only
// below 2^24 matches.) sign(x) is (x > 0) - (x < 0): +0, -0 and NaN give
// 0, as jnp.sign does for zeros; subnormals keep their sign (no flush).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;     // threads a block
constexpr int kBatch = 8;         // loads a thread issues before it counts
constexpr int kMaxCluster = 8;    // the portable limit of a cluster's blocks
constexpr int kBusyBlocks = 132;  // the H100's SMs

__device__ __forceinline__ int sign_of(float x) {
  return (x > 0.0f) - (x < 0.0f);
}

// Read-only loads that are issued only when `on`, the predicate inside the
// instruction: a slot past the end costs no branch, and the compiler
// cannot sink a count into a branch around its load. Off, x reads 0 and
// r reads -2 (the padding, which no sign matches).
__device__ __forceinline__ float4 load4(const float* x, long long i,
                                        bool on) {
  float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  asm volatile(
      "{\n.reg .pred q;\nsetp.ne.b32 q, %5, 0;\n"
      "@q ld.global.nc.L1::no_allocate.v4.f32 {%0, %1, %2, %3}, [%4];\n}"
      : "+f"(v.x), "+f"(v.y), "+f"(v.z), "+f"(v.w)
      : "l"(reinterpret_cast<const float4*>(x) + i), "r"((int)on));
  return v;
}

// bf16 -> f32 is exact, so the sign is the bf16 value's own.
__device__ __forceinline__ float4 load4(const __nv_bfloat16* x, long long i,
                                        bool on) {
  uint2 raw = make_uint2(0u, 0u);
  asm volatile(
      "{\n.reg .pred q;\nsetp.ne.b32 q, %3, 0;\n"
      "@q ld.global.nc.L1::no_allocate.v2.u32 {%0, %1}, [%2];\n}"
      : "+r"(raw.x), "+r"(raw.y)
      : "l"(reinterpret_cast<const uint2*>(x) + i), "r"((int)on));
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ char4 load_signs(const char4* r, long long i,
                                            bool on) {
  unsigned bits = 0xFEFEFEFEu;         // -2 in each byte
  asm volatile(
      "{\n.reg .pred q;\nsetp.ne.b32 q, %2, 0;\n"
      "@q ld.global.nc.L1::no_allocate.b32 %0, [%1];\n}"
      : "+r"(bits)
      : "l"(r + i), "r"((int)on));
  return *reinterpret_cast<const char4*>(&bits);
}

// The split cluster barrier: arrive says only that this thread has started
// (relaxed: it orders no memory); wait returns once every thread of the
// cluster has arrived. Every thread of every block calls both, in this
// order, once (.aligned: all threads of a warp together).
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
}

__device__ __forceinline__ int matches(float4 v, char4 r) {
  return (sign_of(v.x) == r.x) + (sign_of(v.y) == r.y) +
         (sign_of(v.z) == r.z) + (sign_of(v.w) == r.w);
}

// The sum of the block's counts, in thread 0 (every thread calls it).
__device__ __forceinline__ int block_sum(int count) {
  for (int off = 16; off > 0; off >>= 1)
    count += __shfl_down_sync(0xffffffffu, count, off);
  __shared__ int warp_sums[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = count;
  __syncthreads();
  count = 0;
  if (warp == 0) {
    count = lane < kThreads / 32 ? warp_sums[lane] : 0;
    for (int off = 16; off > 0; off >>= 1)
      count += __shfl_down_sync(0xffffffffu, count, off);
  }
  return count;
}

// counts[c] = the matches of x[c][0 .. 4*n4) against the reference, for
// the cluster c of k blocks: grouped, r[blockIdx.y] and c = (blockIdx.y *
// gridDim.x + blockIdx.x) / k (gridDim.x = k * clients a reference);
// otherwise r and c = blockIdx.x / k (gridDim.y = 1).
template <typename T, bool kGrouped>
__global__ void __launch_bounds__(kThreads)
sign_align_kernel(const T* __restrict__ x, const char4* __restrict__ r,
                  float* __restrict__ counts, long long n4) {
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned k = cluster.num_blocks();
  const unsigned rank = cluster.block_rank();
  const long long c = kGrouped ? (blockIdx.y * gridDim.x + blockIdx.x) / k
                               : blockIdx.x / k;
  if (n4 == 0) {
    if (rank == 0 && threadIdx.x == 0) counts[c] = 0.0f;
    return;
  }
  cluster_arrive();
  const T* xc = x + c * n4 * 4;
  const char4* rc = kGrouped ? r + blockIdx.y * n4 : r;
  const long long stride = (long long)k * kThreads;   // the cluster's threads
  const long long first = (long long)rank * kThreads + threadIdx.x;
  int count = 0;
  for (long long i0 = 0; i0 < n4; i0 += stride * kBatch) {
    float4 v[kBatch];
    char4 s[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const long long i = i0 + first + j * stride;
      v[j] = load4(xc, i, i < n4);
      s[j] = load_signs(rc, i, i < n4);
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) count += matches(v[j], s[j]);
  }
  count = block_sum(count);
  __shared__ int partials[kMaxCluster];
  cluster_wait();               // every block of the cluster has started
  if (threadIdx.x == 0) *cluster.map_shared_rank(partials + rank, 0) = count;
  cluster.sync();
  if (rank == 0 && threadIdx.x == 0) {
    int total = 0;
    for (unsigned j = 0; j < k; ++j) total += partials[j];
    counts[c] = __int2float_rn(total);
  }
}

// Blocks a count: enough for about kBusyBlocks in all, no more than
// kMaxCluster, and no more than there are kThreads-wide steps of work.
int cluster_size(int clients, long long n4) {
  long long k = (kBusyBlocks + clients - 1) / clients;
  const long long steps = (n4 + kThreads - 1) / kThreads;
  if (k > steps) k = steps;
  if (k > kMaxCluster) k = kMaxCluster;
  return k < 1 ? 1 : (int)k;
}

// One launch of clusters of k blocks, one cluster a count; returns the
// launch's error or, if it has none, cudaGetLastError(), as an int.
template <typename T>
int launch(const void* x, const void* r, void* counts, int clients,
           int group, long long n, void* stream) {
  const long long n4 = n / 4;
  const int k = cluster_size(clients, n4);
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = (unsigned)k;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((unsigned)k * (unsigned)group,
                        (unsigned)(clients / group));
  config.blockDim = dim3(kThreads);
  config.stream = (cudaStream_t)stream;
  config.attrs = &cluster;
  config.numAttrs = 1;
  const cudaError_t launched =
      group == clients
          ? cudaLaunchKernelEx(&config, sign_align_kernel<T, false>,
                               (const T*)x, (const char4*)r, (float*)counts,
                               n4)
          : cudaLaunchKernelEx(&config, sign_align_kernel<T, true>,
                               (const T*)x, (const char4*)r, (float*)counts,
                               n4);
  const cudaError_t last = cudaGetLastError();
  return (int)(launched != cudaSuccess ? launched : last);
}

}  // namespace

// u: (C, n) f32, r: (C / group, n) int8, counts: (C,) f32, written whole;
// client c is counted against r[c / group] (group >= 1 divides C); n is a
// multiple of 4 below 2^31 (0 writes C zeros and loads nothing) and u, r
// are 16-byte aligned. Launches on `stream` and returns the launch's CUDA
// error as an int.
extern "C" int per_client_sign_align(const void* u, const void* r,
                                     void* counts, int clients, int group,
                                     long long n, void* stream) {
  return launch<float>(u, r, counts, clients, group, n, stream);
}

// g: (n,) f32 (g_bf16 == 0) or bf16 (g_bf16 != 0), r: (n,) int8, count:
// one f32, written; n is a multiple of 4 below 2^31, g and r 16-byte
// aligned. Launches on `stream` and returns the launch's CUDA error as an
// int.
extern "C" int sign_align_counts(const void* g, int g_bf16, const void* r,
                                 void* count, long long n, void* stream) {
  return g_bf16 ? launch<__nv_bfloat16>(g, r, count, 1, 1, n, stream)
                : launch<float>(g, r, count, 1, 1, n, stream);
}
