// Flash attention, forward, on Hopper's tensor cores: bf16 q, k, v with
// hd 64, 96 or 128; causal or full, an optional sliding window, grouped
// KV heads. Output in bf16 or f32.
//
// Replaces: src/repro/kernels/flash_attn.py:71, flash_attention
// (_flash_kernel), and on the model path the function it stands for,
// blockwise_attention in src/repro/models/layers.py. It computes what the
// TPU kernel and kernels/ref.py::flash_attention compute, per query row:
//   s   = (q . k^T) * 1/sqrt(hd)            f32 scores
//   s   = -1e30 where masked                (causal: k_pos <= q_pos; window:
//                                             q_pos - k_pos < window)
//   m, l, acc carried in f32 over the KV tiles (online softmax)
//   out = acc / max(l, 1e-30), rounded once to the output type
// Query head h reads KV head h / G (G = H / K), found by strides; KV heads
// are never expanded. The f32 path and the other head dims stay on the
// SIMT kernel, csrc/flash_attn.cu (kernels/flash_attn.py::route).
//
// Bound on the H100: operations. 4*hd FLOPs per unmasked score (two
// products); at qwen2-1.5b's prefill layer (B 4, S 2048, H 12, K 2, hd 128,
// causal) that is 5.16e10 FLOPs, 0.0521 ms at the 989 TFLOP/s of the bf16
// tensor cores, against 58.7 MB of q, k, v and o, 0.018 ms at 3.35 TB/s.
// The split of P below adds a third product; that is this kernel's own
// cost and not part of the bound.
//
// Why P is split. The reference takes P.V with P in f32. Q.K^T on bf16
// inputs is exact in its products, so only P.V needs care: rounding P to
// bf16 (as FlashAttention-3 does) moves the output by more than one bf16
// ulp of its magnitude plus 1e-5, the tolerance the kernel is held to
// (tests/test_torch_flash.py shows both). So P = P_hi + P_lo with
// P_hi = bf16(P) and P_lo = bf16(P - P_hi), and O += P_hi.V + P_lo.V in
// f32; P_hi + P_lo carries about 16 significant bits of P. l sums the f32
// P.
//
// Design (hopper-kernels guide §1):
//   * a block of 384 threads per (128 query rows, b*H + h): two consumer
//     warpgroups of 64 rows each and one producer warpgroup; setmaxnreg
//     gives the consumers 240 registers and the producer 24;
//   * the producer's first thread loads q once (TMA, 128 rows) and then
//     keeps the KV tiles of 64 rows in flight through a ring of kStages
//     shared-memory stages: cp.async.bulk.tensor into 128-byte swizzled
//     tiles, completion by mbarrier transaction counts (full[s]), reuse
//     when all 8 consumer warps have released the stage (empty[s]);
//   * S = Q.K^T by wgmma.mma_async m64n64k16 with both operands in shared
//     memory, K-major; the scale, the masks and the online softmax run on
//     the accumulator fragment in registers, in the log2 domain (one
//     multiply by scale * log2(e), then exp2; a row's 16 values of a tile
//     lie in the 4 threads of a quad);
//   * P_hi and P_lo are packed from that fragment straight into wgmma's
//     register A operand; V is the MN-major B operand in shared memory;
//     O is accumulated in f32 registers;
//   * tiles wholly masked for a warpgroup are skipped (waited for and
//     released); a row's first tile with an unmasked score gives earlier
//     ones a correction 2^(m_old - m_new) of exactly 0, so skipping and
//     partial tiles stay exact;
//   * the grid is (B*H, S/128), the q tiles in reverse for causal calls,
//     so that the blocks with the longest rows start first.
// KV tiles of 64 rows: 128 was not clearly faster (and slower with a
// window, where more of a wider tile is masked), at twice the registers.
// Head dims: 64 is one 64-column chunk; 128 two; 96 is loaded as two with
// the 32 columns past hd zero-filled by TMA (Q.K^T stops at hd, P.V runs
// over the padding and its columns are not stored).
//
// What it leaves on the table: the tensor cores idle for much of the
// kernel's time (PERF.md has its time beside its bound); where that time
// goes is not measured (no ncu on the card's machine). FlashAttention-3's cures, a
// two-stage pipeline inside each warpgroup (tile i's Q.K^T issued with
// tile i-1's P.V) and turn-taking between the two warpgroups, gained
// little in trials, and ptxas serialised the wgmmas (warnings C7513,
// C7520) in some of them, so they are not in this version. Also: no
// persistent blocks, the output is stored from registers rather than by
// TMA, and the P split costs one extra P.V product.

#include <cuda.h>          // CUtensorMap and its enums (no -lcuda: the
                           // encoder is reached through the runtime)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 128;        // query rows of a block (2 warpgroups of 64)
constexpr int kBK = 64;         // KV rows of a tile
constexpr int kStages = 3;      // K/V ring depth
constexpr int kThreads = 384;   // 2 consumer warpgroups + 1 producer
constexpr int kRowBytes = 128;  // one 64-column bf16 chunk row, swizzled
constexpr int kConsumerWarps = 8;
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  void* o;
  long long ob, os, oh;         // output element strides
  int H, G, kv_tiles, causal, window;   // window <= 0: none
  float scale;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                   "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// Wait for the phase of parity `parity` to complete. A wait that has not
// completed after about 2^34 cycles (seconds) traps: a fault in the
// pipeline then ends the launch with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  long long start = 0;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (start == 0) start = clock64();
    else if (clock64() - start > (1ll << 34)) __trap();
  }
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3) : "memory");
}

// wgmma shared-memory descriptor of a 128-byte swizzled tile whose 8-row
// groups lie 1024 bytes apart (start address, leading and stride byte
// offsets in 16-byte units, layout type 1 = 128-byte swizzle). The tiles
// start on 1024-byte boundaries, so a start moved by k * 32 bytes inside
// the swizzle row selects the k-th 16-column slice.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// keep the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma that owns it
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// D (64 x 64, f32) (+)= A (64 x 16) . B (64 x 16)^T, A and B bf16 in shared
// memory, both K-major
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (64 x 64, f32) += A (64 x 16, bf16 in registers) . B (16 x 64), B bf16
// in shared memory, MN-major (transposed)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo_col, float hi_col) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo_col, hi_col);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

template <int kHd>
struct Layout {
  static constexpr int kChunks = (kHd + 63) / 64;
  static constexpr int kQ = kChunks * kBQ * kRowBytes;
  static constexpr int kTile = kChunks * kBK * kRowBytes;   // K or V, a stage
  static constexpr int kK = kQ;
  static constexpr int kV = kK + kStages * kTile;
  static constexpr int kBars = kV + kStages * kTile;
  // full[kStages], empty[kStages], q: 8 bytes each; 1024 of alignment slack
  static constexpr int kBytes = kBars + (2 * kStages + 1) * 8 + 1024;
};

template <int kHd, typename Tout>
__global__ void __launch_bounds__(kThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v, const Params p) {
  using L = Layout<kHd>;
  constexpr int kChunks = L::kChunks;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base, sk = base + L::kK, sv = base + L::kV;
  const uint32_t bars = base + L::kBars;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kStages + s); };
  const uint32_t qbar = bars + 16 * kStages;

  const int h = blockIdx.x % p.H, b = blockIdx.x / p.H, kvh = h / p.G;
  const int qt = p.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * kBQ;
  int t_end = p.kv_tiles;
  if (p.causal) t_end = min(t_end, (q0 + kBQ - 1) / kBK + 1);
  int t_begin = 0;
  if (p.window > 0 && q0 - p.window + 1 > 0)
    t_begin = (q0 - p.window + 1) / kBK;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumerWarps);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= 2 * 128) {
    // producer warpgroup: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    if (tid == 2 * 128) {
      mbar_expect_tx(qbar, L::kQ);
      for (int c = 0; c < kChunks; ++c)
        tma_load_4d(sq + c * kBQ * kRowBytes, &tm_q, qbar, 64 * c, q0, h, b);
      for (int t = t_begin, i = 0; t < t_end; ++t, ++i) {
        const int s = i % kStages;
        mbar_wait(empty(s), ((i / kStages) & 1) ^ 1);
        mbar_expect_tx(full(s), 2 * L::kTile);
        for (int c = 0; c < kChunks; ++c) {
          const uint32_t off = s * L::kTile + c * kBK * kRowBytes;
          tma_load_4d(sk + off, &tm_k, full(s), 64 * c, t * kBK, kvh, b);
          tma_load_4d(sv + off, &tm_v, full(s), 64 * c, t * kBK, kvh, b);
        }
      }
    }
    return;
  }

  // consumer warpgroups
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int qw0 = q0 + 64 * wg;                 // the warpgroup's first row
  const int r0 = qw0 + 16 * warp + lane / 4;    // this thread's rows r0, r0+8
  const int cq = 2 * (lane % 4);                // its columns in each 8
  const float scale_log2 = p.scale * kLog2e;

  float o[kChunks][32];
#pragma unroll
  for (int c = 0; c < kChunks; ++c)
#pragma unroll
    for (int e = 0; e < 32; ++e) o[c][e] = 0.0f;
  float m[2] = {-1e30f, -1e30f}, l[2] = {0.0f, 0.0f};

  mbar_wait(qbar, 0);
  for (int t = t_begin, i = 0; t < t_end; ++t, ++i) {
    const int s = i % kStages;
    const int kv0 = t * kBK;
    mbar_wait(full(s), (i / kStages) & 1);
    const bool dead = (p.causal && kv0 > qw0 + 63) ||
                      (p.window > 0 && kv0 + kBK - 1 <= qw0 - p.window);
    if (!dead) {
      // S = Q K^T over hd / 16 slices
      float sc[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) sc[e] = 0.0f;
      fence_regs(sc);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kHd / 16; ++ks) {
        const int c = ks / 4, w = ks % 4;
        const uint64_t da = desc_sw128(
            sq + c * kBQ * kRowBytes + wg * 64 * kRowBytes + 32 * w, 16);
        const uint64_t db = desc_sw128(
            sk + s * L::kTile + c * kBK * kRowBytes + 32 * w, 16);
        wgmma_ss(sc, da, db, ks > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);

      // scale, mask, online softmax in the log2 domain (s * scale *
      // log2(e), then exp2); sc[4i + e] is row r0 + 8 * (e >= 2), column
      // kv0 + 8i + cq + (e & 1)
#pragma unroll
      for (int e = 0; e < 32; ++e) sc[e] *= scale_log2;
      const bool edge = (p.causal && kv0 + kBK - 1 > qw0) ||
                        (p.window > 0 && kv0 <= qw0 + 63 - p.window);
      if (edge) {
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const int row = r0 + ((e & 2) ? 8 : 0);
          const int col = kv0 + 8 * (e / 4) + cq + (e & 1);
          const bool keep = (!p.causal || col <= row) &&
                            (p.window <= 0 || row - col < p.window);
          if (!keep) sc[e] = -1e30f;
        }
      }
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = -1e30f;
#pragma unroll
        for (int i8 = 0; i8 < kBK / 8; ++i8)
          mx = fmaxf(mx, fmaxf(sc[4 * i8 + 2 * r], sc[4 * i8 + 2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[r], mx);
        float sum = 0.0f;
#pragma unroll
        for (int i8 = 0; i8 < kBK / 8; ++i8) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            float& x = sc[4 * i8 + 2 * r + j];
            x = exp2f(x - m_new);
            sum += x;
          }
        }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        corr[r] = exp2f(m[r] - m_new);
        l[r] = l[r] * corr[r] + sum;
        m[r] = m_new;
      }

      // split P into bf16 hi and lo register A operands: slice j (KV rows
      // kv0 + 16j ..) takes sc[8j .. 8j + 7] in the order of wgmma's A
      // fragment (row r0 cols 2q, row r0+8 cols 2q, row r0 cols 8+2q, row
      // r0+8 cols 8+2q)
      uint32_t ahi[kBK / 16][4], alo[kBK / 16][4];
#pragma unroll
      for (int j = 0; j < kBK / 16; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float x0 = sc[8 * j + 2 * r], x1 = sc[8 * j + 2 * r + 1];
          ahi[j][r] = pack_bf16(x0, x1);
          const __nv_bfloat162 hi =
              *reinterpret_cast<const __nv_bfloat162*>(&ahi[j][r]);
          alo[j][r] = pack_bf16(x0 - __low2float(hi), x1 - __high2float(hi));
        }

#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
#pragma unroll
        for (int e = 0; e < 32; ++e) o[c][e] *= corr[(e & 2) ? 1 : 0];
        fence_regs(o[c]);
      }
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < kChunks; ++c)
#pragma unroll
        for (int j = 0; j < kBK / 16; ++j) {
          // V rows kv0 + 16j .. + 15, columns 64c .. 64c + 63
          const uint64_t dv = desc_sw128(
              sv + s * L::kTile + c * kBK * kRowBytes + j * 16 * kRowBytes,
              1024);
          wgmma_rs(o[c], ahi[j], dv);
          wgmma_rs(o[c], alo[j], dv);
        }
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int c = 0; c < kChunks; ++c) fence_regs(o[c]);
    }
    // this warp is done with the stage
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(s));
  }

  Tout* out = static_cast<Tout*>(p.o) + b * p.ob + h * p.oh;
  const float den[2] = {fmaxf(l[0], 1e-30f), fmaxf(l[1], 1e-30f)};
#pragma unroll
  for (int c = 0; c < kChunks; ++c)
#pragma unroll
    for (int i8 = 0; i8 < 8; ++i8) {
      const int col = 64 * c + 8 * i8 + cq;
      if (col < kHd) {
#pragma unroll
        for (int r = 0; r < 2; ++r)
          store2(out + (long long)(r0 + 8 * r) * p.os + col,
                 o[c][4 * i8 + 2 * r] / den[r],
                 o[c][4 * i8 + 2 * r + 1] / den[r]);
      }
    }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      ptr = nullptr;
    return reinterpret_cast<EncodeTiled>(ptr);
  }();
  return fn;
}

// a (B, rows, heads, hd) bf16 tensor as 4 TMA dimensions {hd, rows, heads,
// B}, element strides {s, h, b}, boxes of 64 columns by box_rows rows,
// swizzled by 128 bytes; columns past hd read as zeros
int encode(CUtensorMap* map, const void* ptr, int B, int rows, int heads,
           int hd, long long sb, long long ss, long long sh, int box_rows) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return -1000;
  // a dimension of size 1 is never stepped; give it a legal stride
  const long long bytes_s = ss * 2;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)rows,
                              (cuuint64_t)heads, (cuuint64_t)B};
  const cuuint64_t strides[3] = {
      (cuuint64_t)bytes_s,
      (cuuint64_t)(heads > 1 ? sh * 2 : bytes_s),
      (cuuint64_t)(B > 1 ? sb * 2 : bytes_s)};
  const cuuint32_t box[4] = {64, (cuuint32_t)box_rows, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                  const_cast<void*>(ptr), dims, strides, box, elem,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -(int)r;
}

template <int kHd, typename Tout>
int launch(const CUtensorMap& tq, const CUtensorMap& tk,
           const CUtensorMap& tv, const Params& p, dim3 grid,
           cudaStream_t stream) {
  constexpr int bytes = Layout<kHd>::kBytes;
  // above 48 KB of dynamic shared memory a kernel must opt in; once per
  // instantiation, so that no launch (nor a CUDA graph's capture) repeats it
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      flash_wgmma_kernel<kHd, Tout>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (opt_in != cudaSuccess) return (int)opt_in;
  flash_wgmma_kernel<kHd, Tout><<<grid, kThreads, bytes, stream>>>(tq, tk, tv,
                                                                    p);
  return (int)cudaGetLastError();
}

template <typename Tout>
int launch_hd(int hd, const CUtensorMap& tq, const CUtensorMap& tk,
              const CUtensorMap& tv, const Params& p, dim3 grid,
              cudaStream_t stream) {
  switch (hd) {
    case 64: return launch<64, Tout>(tq, tk, tv, p, grid, stream);
    case 96: return launch<96, Tout>(tq, tk, tv, p, grid, stream);
    case 128: return launch<128, Tout>(tq, tk, tv, p, grid, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q (B, S, H, hd), k and v (B, Sk, K, hd) bf16, o (B, S, H, hd), given by
// element strides[12] = {q b, s, h; k b, s, h; v b, s, h; o b, s, h}, each
// contiguous along hd; q, k, v 16-byte aligned with strides that are
// multiples of 8 elements. hd 64, 96 or 128; S a multiple of 128, Sk of
// 64; H a multiple of K; S / 128 <= 65535; S <= Sk when causal or
// windowed. out_bf16: 0 for f32, 1 for bf16. window <= 0: no window.
// Launches on `stream`; returns 0, a CUDA error (> 0), -CUresult of the
// tensor-map encoder, or -1000 when the driver has no encoder.
extern "C" int flash_attention_wgmma(const void* q, const void* k,
                                     const void* v, void* o, int out_bf16,
                                     int B, int H, int K, int S, int Sk,
                                     int hd, const long long* strides,
                                     int causal, int window, float scale,
                                     void* stream) {
  CUtensorMap tq, tk, tv;
  int err = encode(&tq, q, B, S, H, hd, strides[0], strides[1], strides[2],
                   kBQ);
  if (!err)
    err = encode(&tk, k, B, Sk, K, hd, strides[3], strides[4], strides[5],
                 kBK);
  if (!err)
    err = encode(&tv, v, B, Sk, K, hd, strides[6], strides[7], strides[8],
                 kBK);
  if (err) return err;
  Params p;
  p.o = o;
  p.ob = strides[9];
  p.os = strides[10];
  p.oh = strides[11];
  p.H = H;
  p.G = H / K;
  p.kv_tiles = Sk / kBK;
  p.causal = causal;
  p.window = window;
  p.scale = scale;
  const dim3 grid(B * H, S / kBQ);
  cudaStream_t st = (cudaStream_t)stream;
  return out_bf16 ? launch_hd<__nv_bfloat16>(hd, tq, tk, tv, p, grid, st)
                  : launch_hd<float>(hd, tq, tk, tv, p, grid, st);
}

// Dynamic shared memory of a block at head dim hd (0 for one the kernel
// does not take).
extern "C" int flash_attention_wgmma_smem_bytes(int hd) {
  switch (hd) {
    case 64: return Layout<64>::kBytes;
    case 96: return Layout<96>::kBytes;
    case 128: return Layout<128>::kBytes;
  }
  return 0;
}
