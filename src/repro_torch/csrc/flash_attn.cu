// Flash attention, forward: causal or full online-softmax attention with
// an optional sliding window and grouped KV heads.
//
// Replaces: src/repro/kernels/flash_attn.py, flash_attention
// (_flash_kernel), and on the model path the function it stands for,
// blockwise_attention in src/repro/models/layers.py. Per query row:
//   s   = (q * 1/sqrt(hd)) . k^T            in f32
//   s   = -1e30 where masked                (causal: k_pos <= q_pos; window:
//                                             q_pos - k_pos < window;
//                                             positions from 0 on both axes)
//   m, l, acc carried in f32 over the KV tiles (online softmax)
//   out = acc / max(l, 1e-30), rounded once to the output type
// Query head h reads KV head h / G (G = H / K), as JAX's reshape of q to
// (B, S, K, G, hd) implies; KV heads are never expanded. The layout is
// given by strides, so (BH, S, hd) with heads flattened is the case
// H = K = 1.
//
// Bound on the H100: operations. At qwen2-1.5b's prefill (B 4, S 2048,
// H 12, K 2, hd 128, bf16, causal) one layer is 4*B*H*S^2*hd/2 = 5.15e10
// FLOPs, 0.052 ms at the 989 TFLOP/s of the bf16 tensor cores, against
// 58.7 MB of q, k, v and o, 0.018 ms at 3.35 TB/s.
//
// Design (simple and right first): one block of 256 threads per (64 query
// rows, b*H + h). The q tile is scaled into shared memory once as f32,
// transposed; each KV tile of 64 rows is staged through shared memory as
// f32 (k transposed, v as is), so the product loops read float4s: each
// thread owns a 4x4 micro-tile of the 64x64 scores and 4 rows x (hd/16)
// columns of the accumulator, in registers. Row max and sum reduce over
// the 16 threads of a row by warp shuffles. Tiles wholly above the
// diagonal or wholly outside the window are skipped: the first tile with
// an unmasked score gives the skipped ones a correction exp(m_old - m_new)
// of exactly 0, so the result is the same. Shared memory: 117 KB at hd
// 128, 217 KB at hd 256, one block per SM.
//
// What it leaves on the table: the products run on CUDA cores in f32
// (67 TFLOP/s) instead of the tensor cores (wgmma, 989 TFLOP/s in bf16);
// tiles are loaded by the threads, not by TMA, with no pipelining of the
// next tile's load behind the current tile's math; occupancy is one block
// of 8 warps per SM at hd 128.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;        // query rows of a block
constexpr int kBK = 64;        // KV rows of a tile
constexpr int kThreads = 256;
constexpr int kLd = kBQ + 4;   // row stride of the transposed tiles: float4
                               // aligned, and a warp's transposing stores
                               // of 8 lanes cover the 32 banks once

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int H, G, hd, causal, window;   // window <= 0: none
  float scale;
  long long qb, qs, qh, kb, ks, kh, vb, vs, vh, ob, os, oh;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// kChunks: the accumulator's column chunks of 4 per thread, hd <= 64 * kChunks
template <typename Tin, typename Tout, int kChunks>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const Params p, int kv_tiles) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int hd = p.hd;
  float* qt = smem;                 // [hd][kLd]  q tile, transposed, scaled
  float* kt = qt + hd * kLd;        // [hd][kLd]  k tile, transposed
  float* vt = kt + hd * kLd;        // [kBK][hd]  v tile
  float* pt = vt + kBK * hd;        // [kBK][kLd] probabilities, transposed

  const int tid = threadIdx.x;
  const int tx = tid & 15;          // score columns 4tx..4tx+3
  const int ty = tid >> 4;          // rows 4ty..4ty+3
  const int h = blockIdx.y % p.H;
  const long long b = blockIdx.y / p.H;
  const int kvh = h / p.G;
  const int q0 = blockIdx.x * kBQ;

  const Tin* q = static_cast<const Tin*>(p.q) + b * p.qb + h * p.qh;
  const Tin* k = static_cast<const Tin*>(p.k) + b * p.kb + kvh * p.kh;
  const Tin* v = static_cast<const Tin*>(p.v) + b * p.vb + kvh * p.vh;

  // item (r, d): rows 4r..4r+3 at column d; neighbouring lanes take
  // neighbouring d, so global reads are coalesced and the float4 stores
  // conflict-free
  for (int item = tid; item < (kBQ / 4) * hd; item += kThreads) {
    const int d = item % hd, r = 4 * (item / hd);
    const Tin* src = q + (q0 + r) * p.qs + d;
    *reinterpret_cast<float4*>(&qt[d * kLd + r]) = make_float4(
        to_f32(src[0]) * p.scale, to_f32(src[p.qs]) * p.scale,
        to_f32(src[2 * p.qs]) * p.scale, to_f32(src[3 * p.qs]) * p.scale);
  }

  float m[4], l[4], acc[4][kChunks][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -1e30f;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < kChunks; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][c][e] = 0.0f;
  }

  int t_end = kv_tiles;
  if (p.causal) t_end = min(t_end, (q0 + kBQ - 1) / kBK + 1);
  int t_begin = 0;
  if (p.window > 0 && q0 - p.window + 1 > 0)
    t_begin = (q0 - p.window + 1) / kBK;

  for (int t = t_begin; t < t_end; ++t) {
    const int kv0 = t * kBK;
    __syncthreads();                // the last tile's readers are done
    for (int item = tid; item < (kBK / 4) * hd; item += kThreads) {
      const int d = item % hd, c = 4 * (item / hd);
      const Tin* src = k + (kv0 + c) * p.ks + d;
      *reinterpret_cast<float4*>(&kt[d * kLd + c]) = make_float4(
          to_f32(src[0]), to_f32(src[p.ks]), to_f32(src[2 * p.ks]),
          to_f32(src[3 * p.ks]));
    }
    for (int item = tid; item < kBK * hd; item += kThreads) {
      const int d = item % hd, c = item / hd;
      vt[c * hd + d] = to_f32(v[(kv0 + c) * p.vs + d]);
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < hd; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(&qt[d * kLd + 4 * ty]);
      const float4 c = *reinterpret_cast<const float4*>(&kt[d * kLd + 4 * tx]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], cv[j], s[i][j]);
    }

    float corr[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + 4 * ty + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = kv0 + 4 * tx + j;
        const bool keep = (!p.causal || kp <= qp) &&
                          (p.window <= 0 || qp - kp < p.window);
        if (!keep) s[i][j] = -1e30f;
      }
      float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      corr[i] = expf(m[i] - m_new);
      l[i] = l[i] * corr[i] + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kChunks; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][c][e] *= corr[i];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(&pt[(4 * tx + j) * kLd + 4 * ty]) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      const float4 pp = *reinterpret_cast<const float4*>(&pt[c * kLd + 4 * ty]);
      const float pv[4] = {pp.x, pp.y, pp.z, pp.w};
#pragma unroll
      for (int jc = 0; jc < kChunks; ++jc) {
        const int col = 4 * (tx + 16 * jc);
        if (col < hd) {
          const float4 w = *reinterpret_cast<const float4*>(&vt[c * hd + col]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[i][jc][0] = fmaf(pv[i], w.x, acc[i][jc][0]);
            acc[i][jc][1] = fmaf(pv[i], w.y, acc[i][jc][1]);
            acc[i][jc][2] = fmaf(pv[i], w.z, acc[i][jc][2]);
            acc[i][jc][3] = fmaf(pv[i], w.w, acc[i][jc][3]);
          }
        }
      }
    }
  }

  Tout* o = static_cast<Tout*>(p.o) + b * p.ob + h * p.oh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float den = fmaxf(l[i], 1e-30f);
    Tout* row = o + (q0 + 4 * ty + i) * p.os;
#pragma unroll
    for (int jc = 0; jc < kChunks; ++jc) {
      const int col = 4 * (tx + 16 * jc);
      if (col < hd) {
#pragma unroll
        for (int e = 0; e < 4; ++e) store(row + col + e, acc[i][jc][e] / den);
      }
    }
  }
}

constexpr int smem_bytes(int hd) {
  return (2 * hd * kLd + kBK * hd + kBK * kLd) * 4;
}

template <typename Tin, typename Tout, int kChunks>
int launch(const Params& p, dim3 grid, int kv_tiles, cudaStream_t stream) {
  // above 48 KB of dynamic shared memory a kernel must opt in; done once
  // per instantiation, for its largest hd, so that no launch (nor a CUDA
  // graph's capture) repeats it
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      flash_fwd_kernel<Tin, Tout, kChunks>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes(64 * kChunks));
  if (opt_in != cudaSuccess) return (int)opt_in;
  flash_fwd_kernel<Tin, Tout, kChunks>
      <<<grid, kThreads, smem_bytes(p.hd), stream>>>(p, kv_tiles);
  return (int)cudaGetLastError();
}

template <typename Tin, typename Tout>
int launch_hd(const Params& p, dim3 grid, int kv_tiles, cudaStream_t stream) {
  if (p.hd <= 64) return launch<Tin, Tout, 1>(p, grid, kv_tiles, stream);
  if (p.hd <= 128) return launch<Tin, Tout, 2>(p, grid, kv_tiles, stream);
  return launch<Tin, Tout, 4>(p, grid, kv_tiles, stream);
}

}  // namespace

// q (B, S, H, hd), k and v (B, Sk, K, hd), o (B, S, H, hd), given by
// element strides[12] = {q b, s, h; k b, s, h; v b, s, h; o b, s, h}, each
// contiguous along hd. in_bf16 / out_bf16: 0 for f32, 1 for bf16. S and Sk
// multiples of 64 (the wrapper asks 128); hd a multiple of 8 up to 256;
// H a multiple of K; B*H <= 65535; S <= Sk when causal or windowed.
// window <= 0: no window. Launches on `stream` and returns the CUDA error
// as an int.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, int in_bf16, int out_bf16, int B,
                               int H, int K, int S, int Sk, int hd,
                               const long long* strides, int causal,
                               int window, float scale, void* stream) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.H = H;
  p.G = H / K;
  p.hd = hd;
  p.causal = causal;
  p.window = window;
  p.scale = scale;
  p.qb = strides[0]; p.qs = strides[1]; p.qh = strides[2];
  p.kb = strides[3]; p.ks = strides[4]; p.kh = strides[5];
  p.vb = strides[6]; p.vs = strides[7]; p.vh = strides[8];
  p.ob = strides[9]; p.os = strides[10]; p.oh = strides[11];
  const dim3 grid(S / kBQ, B * H);
  const int kv_tiles = Sk / kBK;
  cudaStream_t st = (cudaStream_t)stream;
  if (in_bf16) {
    return out_bf16 ? launch_hd<__nv_bfloat16, __nv_bfloat16>(p, grid, kv_tiles, st)
                    : launch_hd<__nv_bfloat16, float>(p, grid, kv_tiles, st);
  }
  return out_bf16 ? launch_hd<float, __nv_bfloat16>(p, grid, kv_tiles, st)
                  : launch_hd<float, float>(p, grid, kv_tiles, st);
}
