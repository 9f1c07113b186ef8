// Flash attention at any head dim up to 256, in bf16 and in fp32: the
// general route's forward, dQ and dK/dV kernels for Hopper (sm_90a),
// written by hand in CUDA C++.
//
// Replaces the rest of what horovod_tpu/ops/pallas_kernels.py's
// _fwd_kernel, _bwd_kernel_dkdv and _bwd_kernel_dq compute: those Pallas
// kernels take any head dim and keep their products in the storage dtype,
// so fp32 inputs give fp32 products. flash_fwd.cu and flash_bwd.cu (the
// wgmma route) take bf16 at head dim 64 and 128; these kernels take every
// other bf16 head dim from 1 to 256 and every fp32 one. The wrapper
// (ops/flash_attention.py, kernel_route) picks the route from the dtype and
// the head dim alone, and the head dim d is padded to the smallest compiled
// size d_pad of 16, 32, 64, 128, 256 that holds it.
//
// The function is the TPU kernels' and the wgmma kernels':
//
//   forward: blockwise online softmax with fp32 scores and statistics;
//            causal on global positions (q_offset / kv_offset); keys at or
//            past kv_len masked; p rounded to V's dtype before PV (a no-op
//            in fp32); a row with no valid key gives out 0 and lse -inf;
//            sm_scale of either sign (the scores are scaled, then masked,
//            then maxed).
//   dQ:      delta = rowsum(dO o out) in fp32 from the cotangent as given
//            (bf16 or fp32), written to an fp32 [B, H, Sq] scratch for the
//            dK/dV kernel; p = exp(s - lse), dS = p (dP - delta) + g_lse p,
//            dQ = dS K * sm_scale.
//   dK/dV:   the same recomputation transposed; dV = P^T dO, dK = dS^T Q *
//            sm_scale. The wrapper launches it after the dQ kernel on the
//            same stream. No atomics: every gradient element is one sum in
//            a fixed order, so two calls agree bit for bit.
//
// with the TPU kernels' roundings in bf16: the products take dO in the
// input dtype, P is rounded to bf16 before PV and dV, dS before dK and dQ,
// and every sum is fp32.
//
// Work split. One block of four warps owns 64 rows (16 a warp) of one
// (batch, head) -- query rows in the forward and dQ kernels, key rows in
// the dK/dV kernel -- and walks the tiles of the other side (kBK rows:
// 64, or 32 where the accumulators are large). Every operand tile is
// staged through shared memory with its rows padded by 16 bytes, so the
// fragment loads below are free of bank conflicts. There is no pipeline:
// a tile's loads do not overlap the previous tile's math inside a block,
// and only the other resident blocks hide the latency.
//
// Products. Each warp keeps its 16 x n accumulators in the register layout
// of mma.sync's m16n8 C fragment (a thread holds rows g and g + 8, columns
// 2t and 2t + 1 of each 8-column block), in both dtypes, so the masking,
// the softmax and the epilogues are one code. Two forms cover all seven
// products:
//
//   NT  C += A B^T with both operands row-major in shared memory (S = Q K^T,
//       dP = dO V^T, and their transposes S^T = K Q^T, dP^T = V dO^T);
//   PN  C += P B with P a previous NT result still in registers and B
//       row-major in shared memory (O += P V, dQ += dS K, dV += P^T dO,
//       dK += dS^T Q).
//
// bf16 runs both forms on the tensor cores with mma.sync m16n8k16 (bf16
// in, fp32 accumulate); PN packs P's fp32 C fragments into bf16 A fragments
// (the rounding the TPU kernels make), and reads B's column pairs with two
// 16-bit loads. fp32 runs both forms on the CUDA cores with FFMA in full
// fp32 (no TF32, which keeps about three decimal digits): NT reads 4 k a
// load (float4 rows of both operands), PN stages P through a per-warp
// shared-memory scratch and reads B's column pairs as float2.
//
// Head dims that are not a compiled size: columns d..d_pad are loaded as
// zeros, so they add nothing to the products, and the output columns past
// d are never stored. Rows are loaded 16 bytes at a time where the view's
// rows allow it (d and the row stride multiples of 16 bytes, an aligned
// base), else one element at a time: a column third of the fused QKV
// projection is read in place at any head dim, and nothing is padded or
// copied on the host. Rows past S are zero and masked.
//
// Registers. A thread holds d_pad / 2 fp32 accumulator values for each
// 64-row output tile (128 at d_pad = 256) and 4 kBK / 8 for each of S and
// dP. The dK/dV kernel holds two output accumulators, so it takes 32-row
// query tiles from d_pad = 128 on, and at 256 runs its query loop twice
// (dV, then dK: the second pass recomputes S, one product in five more).
//
// What bounds it on an H100 SXM (data-sheet peaks at its 700 W limit:
// 3.35 TB/s of HBM3, 989 TFLOP/s dense bf16, 67 TFLOP/s fp32 outside the
// tensor cores): in fp32 at GPT-2 small's shape (B=8, S=1024, H=12, D=64,
// causal) the forward's two products are 12.9 GFLOP over their causal half,
// 0.19 ms at the fp32 peak, and its bytes 0.03 ms: operations bound it. In
// bf16 the same shapes are bound by bytes. What this design leaves on the
// table: no cp.async/TMA pipeline, mma.sync instead of wgmma (a fraction of
// the tensor cores' rate), FFMA operands read from shared memory at about
// one load a four FFMA, the diagonal tile's masked half computed, and no
// scheduling of the uneven causal work across SMs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

#include "bind_device.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBM = 16 * kWarps;  // rows a block owns, 16 a warp

// Stride slots of Args::st: each a [B, S, H, D] view's element strides
// (batch, seq, head); D has unit stride.
enum Slot { kQ, kK, kV, kDO, kOut, kGiven, kO, kDK, kDV, kSlots };

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;   // dO in the input dtype (backward)
  const void* out;    // the forward's output (dQ kernel)
  const void* given;  // dO as given, bf16 or fp32 (dQ kernel: delta)
  void* o;            // forward: out; dQ kernel: dq
  void* dk;
  void* dv;
  float* lse;         // [B, H, Sq]
  const float* glse;  // [B, H, Sq] or null (zeros)
  float* delta;       // [B, H, Sq]
  long long st[kSlots][3];
  int heads, sq, skv, d, kv_len, q_offset, kv_offset, causal, given_f32;
  float scale;
};

// Shared-memory row stride (16 bytes of padding), and the rows of the
// tiles a block walks: keys (forward, dQ), queries (dK/dV, which holds two
// output accumulators).
template <typename T, int DP>
struct Tile {
  static constexpr int kLd = DP + 16 / static_cast<int>(sizeof(T));
  static constexpr int kKeys = DP >= 256 ? 32 : 64;
  static constexpr int kQueries = DP >= 128 ? 32 : 64;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Rows [r0, r0 + R) of one (batch, head) of a view into shared memory (row
// stride LD): DP columns, zero at or past d and in rows at or past n.
template <typename T, int R, int DP, int LD>
__device__ __forceinline__ void load_tile(T* dst, const T* src, long long rs,
                                          int r0, int n, int d) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));  // elements a load
  const bool vec = d % kVec == 0 && rs % kVec == 0 &&
                   (reinterpret_cast<uintptr_t>(src) & 15) == 0;
  if (vec) {
    constexpr int kC = DP / kVec;  // 16-byte chunks a row
    for (int i = threadIdx.x; i < R * kC; i += kThreads) {
      const int r = i / kC, c = (i % kC) * kVec;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (r0 + r < n && c < d) {
        val = *reinterpret_cast<const uint4*>(
            src + static_cast<long long>(r0 + r) * rs + c);
      }
      *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
    }
  } else {
    for (int i = threadIdx.x; i < R * DP; i += kThreads) {
      const int r = i / DP, c = i % DP;
      T val = from_f<T>(0.f);
      if (r0 + r < n && c < d) {
        val = src[static_cast<long long>(r0 + r) * rs + c];
      }
      dst[r * LD + c] = val;
    }
  }
}

__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Two floats as a bf16 pair, the first in the low half (the lower column).
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pair_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ float dot4(float acc, float4 a, float4 b) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// NT: c[16 x 8N] += A[16 x K] B[8N x K]^T; a points at the warp's first row,
// both row-major in shared memory.
template <int N, int K, int LDA, int LDB>
__device__ __forceinline__ void product_nt(float (&c)[N][4],
                                           const __nv_bfloat16* a,
                                           const __nv_bfloat16* b, int g,
                                           int t) {
#pragma unroll 2
  for (int kk = 0; kk < K; kk += 16) {
    const __nv_bfloat16* ap = a + g * LDA + kk + 2 * t;
    const uint32_t af[4] = {ld32(ap), ld32(ap + 8 * LDA), ld32(ap + 8),
                            ld32(ap + 8 * LDA + 8)};
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const __nv_bfloat16* bp = b + (8 * j + g) * LDB + kk + 2 * t;
      mma_16816(c[j], af, ld32(bp), ld32(bp + 8));
    }
  }
}

template <int N, int K, int LDA, int LDB>
__device__ __forceinline__ void product_nt(float (&c)[N][4], const float* a,
                                           const float* b, int g, int t) {
#pragma unroll 2
  for (int kk = 0; kk < K; kk += 4) {
    const float4 a0 = *reinterpret_cast<const float4*>(a + g * LDA + kk);
    const float4 a1 = *reinterpret_cast<const float4*>(a + (g + 8) * LDA + kk);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const float* bp = b + (8 * j + 2 * t) * LDB + kk;
      const float4 b0 = *reinterpret_cast<const float4*>(bp);
      const float4 b1 = *reinterpret_cast<const float4*>(bp + LDB);
      c[j][0] = dot4(c[j][0], a0, b0);
      c[j][1] = dot4(c[j][1], a0, b1);
      c[j][2] = dot4(c[j][2], a1, b0);
      c[j][3] = dot4(c[j][3], a1, b1);
    }
  }
}

// PN: c[16 x 8N] += P[16 x 8M] B[8M x 8N]; P in C-fragment registers, B
// row-major in shared memory. bf16: P rounded to bf16 A fragments.
template <int M, int N, int LDB>
__device__ __forceinline__ void product_pn(float (&c)[N][4],
                                           const float (&p)[M][4],
                                           const __nv_bfloat16* b, float*,
                                           int g, int t) {
  static_assert(M % 2 == 0, "P spans whole k16 steps");
#pragma unroll
  for (int kk = 0; kk < M / 2; ++kk) {
    const uint32_t a[4] = {
        pack_bf16x2(p[2 * kk][0], p[2 * kk][1]),
        pack_bf16x2(p[2 * kk][2], p[2 * kk][3]),
        pack_bf16x2(p[2 * kk + 1][0], p[2 * kk + 1][1]),
        pack_bf16x2(p[2 * kk + 1][2], p[2 * kk + 1][3]),
    };
    const __nv_bfloat16* bp = b + (16 * kk + 2 * t) * LDB + g;
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const __nv_bfloat16* col = bp + 8 * n;
      mma_16816(c[n], a, pair_bf16(col[0], col[LDB]),
                pair_bf16(col[8 * LDB], col[9 * LDB]));
    }
  }
}

// fp32: P goes through the warp's scratch (16 rows of 8M + 4 floats).
template <int M, int N, int LDB>
__device__ __forceinline__ void product_pn(float (&c)[N][4],
                                           const float (&p)[M][4],
                                           const float* b, float* scratch,
                                           int g, int t) {
  constexpr int kLdp = 8 * M + 4;
  __syncwarp();  // every lane is done reading the previous P
#pragma unroll
  for (int j = 0; j < M; ++j) {
    *reinterpret_cast<float2*>(scratch + g * kLdp + 8 * j + 2 * t) =
        make_float2(p[j][0], p[j][1]);
    *reinterpret_cast<float2*>(scratch + (g + 8) * kLdp + 8 * j + 2 * t) =
        make_float2(p[j][2], p[j][3]);
  }
  __syncwarp();
#pragma unroll 4
  for (int k = 0; k < 8 * M; ++k) {
    const float top = scratch[g * kLdp + k];
    const float bot = scratch[(g + 8) * kLdp + k];
    const float* bp = b + k * LDB + 2 * t;
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const float2 bv = *reinterpret_cast<const float2*>(bp + 8 * n);
      c[n][0] = fmaf(top, bv.x, c[n][0]);
      c[n][1] = fmaf(top, bv.y, c[n][1]);
      c[n][2] = fmaf(bot, bv.x, c[n][2]);
      c[n][3] = fmaf(bot, bv.y, c[n][3]);
    }
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&c)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
}

template <typename T>
__device__ __forceinline__ const T* head_base(const void* p,
                                              const long long (&st)[3], int b,
                                              int h) {
  return static_cast<const T*>(p) + b * st[0] + h * st[2];
}

// The 16-row x DP accumulator c of this warp (rows row0 + g, + 8) times
// `mul`, stored in T at columns below d and rows below n.
template <typename T, int DP>
__device__ __forceinline__ void store_rows(void* base, const long long (&st)[3],
                                           int b, int h, int row0, int n,
                                           int d, const float (&c)[DP / 8][4],
                                           const float (&mul)[2], int g,
                                           int t) {
  T* ob = static_cast<T*>(base) + b * st[0] + h * st[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= n) continue;
    T* orow = ob + static_cast<long long>(row) * st[1];
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j + 2 * t + e;
        if (col < d) orow[col] = from_f<T>(c[j][2 * r + e] * mul[r]);
      }
    }
  }
}

// Keys [0, end) that some query row of [q0, q0 + kBM) may attend to.
__device__ __forceinline__ int kv_end(const Args& a, int q0) {
  int end = a.kv_len;
  if (a.causal) {
    const int q_last = a.q_offset + min(q0 + kBM, a.sq) - 1;
    end = min(end, max(q_last - a.kv_offset + 1, 0));
  }
  return end;
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads, 1)
    flash_general_fwd_kernel(const Args a) {
  constexpr int LD = Tile<T, DP>::kLd, BK = Tile<T, DP>::kKeys;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sK = sQ + kBM * LD;
  T* sV = sK + BK * LD;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  float* scratch =
      reinterpret_cast<float*>(sV + BK * LD) + warp * 16 * (BK + 4);
  const int q0 = blockIdx.x * kBM, h = blockIdx.y, b = blockIdx.z;
  const T* kb = head_base<T>(a.k, a.st[kK], b, h);
  const T* vb = head_base<T>(a.v, a.st[kV], b, h);
  load_tile<T, kBM, DP, LD>(sQ, head_base<T>(a.q, a.st[kQ], b, h),
                            a.st[kQ][1], q0, a.sq, a.d);
  const int row0 = q0 + 16 * warp;
  const int pos[2] = {a.q_offset + row0 + g, a.q_offset + row0 + g + 8};
  const int end = kv_end(a, q0);

  float o[DP / 8][4];
  zero(o);
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};  // this thread's partial row sums
  for (int k0 = 0; k0 < end; k0 += BK) {
    __syncthreads();  // every warp is done with the previous tile
    load_tile<T, BK, DP, LD>(sK, kb, a.st[kK][1], k0, a.skv, a.d);
    load_tile<T, BK, DP, LD>(sV, vb, a.st[kV][1], k0, a.skv, a.d);
    __syncthreads();
    float s[BK / 8][4];
    zero(s);
    product_nt<BK / 8, DP, LD, LD>(s, sQ + 16 * warp * LD, sK, g, t);
    float mt[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, col = k0 + 8 * j + 2 * t + (e & 1);
        const bool ok =
            col < a.kv_len && (!a.causal || pos[r] >= a.kv_offset + col);
        const float x = ok ? s[j][e] * a.scale : -INFINITY;
        s[j][e] = x;
        mt[r] = fmaxf(mt[r], x);
      }
    }
    float m_use[2], corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
      // A row with no valid key yet keeps max -inf and exponentiates
      // against 0: its masked entries give exactly 0, never NaN.
      m_use[r] = mt[r] == -INFINITY ? 0.f : mt[r];
      corr[r] = expf(m[r] - m_use[r]);
      m[r] = mt[r];
      l[r] *= corr[r];
    }
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[j][e] - m_use[e >> 1]);
        s[j][e] = p;
        l[e >> 1] += p;  // the unrounded p, as the TPU kernel sums it
      }
    }
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      o[j][0] *= corr[0];
      o[j][1] *= corr[0];
      o[j][2] *= corr[1];
      o[j][3] *= corr[1];
    }
    product_pn<BK / 8, DP / 8, LD>(o, s, sV, scratch, g, t);
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = l[r] > 0.f ? 1.f / l[r] : 0.f;
    const int row = row0 + g + 8 * r;
    if (t == 0 && row < a.sq) {
      a.lse[(static_cast<long long>(b) * a.heads + h) * a.sq + row] =
          l[r] > 0.f ? m[r] + logf(l[r]) : -INFINITY;
    }
  }
  store_rows<T, DP>(a.o, a.st[kO], b, h, row0, a.sq, a.d, o, inv, g, t);
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads, 1)
    flash_general_dq_kernel(const Args a) {
  constexpr int LD = Tile<T, DP>::kLd, BK = Tile<T, DP>::kKeys;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sO = sQ + kBM * LD;  // dO
  T* sK = sO + kBM * LD;
  T* sV = sK + BK * LD;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  float* scratch =
      reinterpret_cast<float*>(sV + BK * LD) + warp * 16 * (BK + 4);
  const int q0 = blockIdx.x * kBM, h = blockIdx.y, b = blockIdx.z;
  const T* kb = head_base<T>(a.k, a.st[kK], b, h);
  const T* vb = head_base<T>(a.v, a.st[kV], b, h);
  load_tile<T, kBM, DP, LD>(sQ, head_base<T>(a.q, a.st[kQ], b, h),
                            a.st[kQ][1], q0, a.sq, a.d);
  load_tile<T, kBM, DP, LD>(sO, head_base<T>(a.dout, a.st[kDO], b, h),
                            a.st[kDO][1], q0, a.sq, a.d);
  const int row0 = q0 + 16 * warp;
  const long long row_base = (static_cast<long long>(b) * a.heads + h) * a.sq;

  // delta = rowsum(dO o out) for the warp's 16 rows, from the cotangent as
  // given; one warp sum a row, in a fixed order.
  float dl[2] = {0.f, 0.f};
  {
    const T* ob = head_base<T>(a.out, a.st[kOut], b, h);
    const char* gb = static_cast<const char*>(a.given) +
                     (b * a.st[kGiven][0] + h * a.st[kGiven][2]) *
                         (a.given_f32 ? 4 : 2);
    for (int i = 0; i < 16; ++i) {
      const int row = row0 + i;
      float acc = 0.f;
      if (row < a.sq) {
        const long long go = static_cast<long long>(row) * a.st[kGiven][1];
        const T* orow = ob + static_cast<long long>(row) * a.st[kOut][1];
        for (int c = lane; c < a.d; c += 32) {
          const float gv =
              a.given_f32
                  ? reinterpret_cast<const float*>(gb)[go + c]
                  : __bfloat162float(
                        reinterpret_cast<const __nv_bfloat16*>(gb)[go + c]);
          acc = fmaf(gv, to_f(orow[c]), acc);
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      }
      if (i == g) dl[0] = acc;
      if (i == g + 8) dl[1] = acc;
      if (lane == 0 && row < a.sq) a.delta[row_base + row] = acc;
    }
  }
  float ls[2], gl[2];
  int pos[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    const bool in = row < a.sq;
    ls[r] = in ? a.lse[row_base + row] : -INFINITY;
    gl[r] = in && a.glse != nullptr ? a.glse[row_base + row] : 0.f;
    pos[r] = a.q_offset + row;
  }
  const int end = kv_end(a, q0);

  float dq[DP / 8][4];
  zero(dq);
  for (int k0 = 0; k0 < end; k0 += BK) {
    __syncthreads();
    load_tile<T, BK, DP, LD>(sK, kb, a.st[kK][1], k0, a.skv, a.d);
    load_tile<T, BK, DP, LD>(sV, vb, a.st[kV][1], k0, a.skv, a.d);
    __syncthreads();
    float s[BK / 8][4], dp[BK / 8][4];
    zero(s);
    zero(dp);
    product_nt<BK / 8, DP, LD, LD>(s, sQ + 16 * warp * LD, sK, g, t);
    product_nt<BK / 8, DP, LD, LD>(dp, sO + 16 * warp * LD, sV, g, t);
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, col = k0 + 8 * j + 2 * t + (e & 1);
        const bool ok = col < a.kv_len && ls[r] != -INFINITY &&
                        (!a.causal || pos[r] >= a.kv_offset + col);
        const float p = ok ? expf(s[j][e] * a.scale - ls[r]) : 0.f;
        s[j][e] = p * (dp[j][e] - dl[r]) + gl[r] * p;  // dS
      }
    }
    product_pn<BK / 8, DP / 8, LD>(dq, s, sK, scratch, g, t);
  }
  const float mul[2] = {a.scale, a.scale};
  store_rows<T, DP>(a.o, a.st[kO], b, h, row0, a.sq, a.d, dq, mul, g, t);
}

// One walk over the query tiles for the block's 64 keys, accumulating dV
// (kWantDV) and/or dK (kWantDK), then storing them.
template <typename T, int DP, bool kWantDK, bool kWantDV>
__device__ __forceinline__ void dkdv_pass(const Args& a, unsigned char* smem,
                                          int q_begin, int q_end) {
  constexpr int LD = Tile<T, DP>::kLd, BK = Tile<T, DP>::kQueries;
  T* sK = reinterpret_cast<T*>(smem);
  T* sV = sK + kBM * LD;
  T* sQ = sV + kBM * LD;
  T* sO = sQ + BK * LD;  // dO
  float* sL = reinterpret_cast<float*>(sO + BK * LD);
  float* sD = sL + BK;
  float* sG = sD + BK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  float* scratch = sG + BK + warp * 16 * (BK + 4);
  const int k0 = blockIdx.x * kBM, h = blockIdx.y, b = blockIdx.z;
  const T* qb = head_base<T>(a.q, a.st[kQ], b, h);
  const T* ob = head_base<T>(a.dout, a.st[kDO], b, h);
  const long long row_base = (static_cast<long long>(b) * a.heads + h) * a.sq;
  const int row0 = k0 + 16 * warp;
  const int key[2] = {row0 + g, row0 + g + 8};

  float dk[DP / 8][4], dv[DP / 8][4];
  zero(dk);
  zero(dv);
  for (int qt = q_begin; qt < q_end; qt += BK) {
    __syncthreads();
    load_tile<T, BK, DP, LD>(sQ, qb, a.st[kQ][1], qt, a.sq, a.d);
    load_tile<T, BK, DP, LD>(sO, ob, a.st[kDO][1], qt, a.sq, a.d);
    for (int i = threadIdx.x; i < BK; i += kThreads) {
      const int row = qt + i;
      const bool in = row < a.sq;
      sL[i] = in ? a.lse[row_base + row] : -INFINITY;
      sD[i] = in ? a.delta[row_base + row] : 0.f;
      sG[i] = in && a.glse != nullptr ? a.glse[row_base + row] : 0.f;
    }
    __syncthreads();
    float s[BK / 8][4], dp[BK / 8][4];
    zero(s);
    product_nt<BK / 8, DP, LD, LD>(s, sK + 16 * warp * LD, sQ, g, t);  // S^T
    if constexpr (kWantDK) {
      zero(dp);
      product_nt<BK / 8, DP, LD, LD>(dp, sV + 16 * warp * LD, sO, g, t);
    }
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, c = 8 * j + 2 * t + (e & 1);
        const int row = qt + c;  // the query
        const bool ok =
            key[r] < a.kv_len && row < a.sq && sL[c] != -INFINITY &&
            (!a.causal || a.q_offset + row >= a.kv_offset + key[r]);
        s[j][e] = ok ? expf(s[j][e] * a.scale - sL[c]) : 0.f;  // P^T
      }
    }
    if constexpr (kWantDV) {
      product_pn<BK / 8, DP / 8, LD>(dv, s, sO, scratch, g, t);
    }
    if constexpr (kWantDK) {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * j + 2 * t + (e & 1);
          const float p = s[j][e];
          s[j][e] = p * (dp[j][e] - sD[c]) + sG[c] * p;  // dS^T
        }
      }
      product_pn<BK / 8, DP / 8, LD>(dk, s, sQ, scratch, g, t);
    }
  }
  if constexpr (kWantDV) {
    const float one[2] = {1.f, 1.f};
    store_rows<T, DP>(a.dv, a.st[kDV], b, h, row0, a.skv, a.d, dv, one, g, t);
  }
  if constexpr (kWantDK) {
    const float mul[2] = {a.scale, a.scale};
    store_rows<T, DP>(a.dk, a.st[kDK], b, h, row0, a.skv, a.d, dk, mul, g, t);
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads, 1)
    flash_general_dkdv_kernel(const Args a) {
  constexpr int LD = Tile<T, DP>::kLd, BK = Tile<T, DP>::kQueries;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sK = reinterpret_cast<T*>(smem);
  T* sV = sK + kBM * LD;
  const int k0 = blockIdx.x * kBM, h = blockIdx.y, b = blockIdx.z;
  load_tile<T, kBM, DP, LD>(sK, head_base<T>(a.k, a.st[kK], b, h),
                            a.st[kK][1], k0, a.skv, a.d);
  load_tile<T, kBM, DP, LD>(sV, head_base<T>(a.v, a.st[kV], b, h),
                            a.st[kV][1], k0, a.skv, a.d);
  // Query tiles that can see a key of [k0, k0 + kBM): none when every key
  // is at or past kv_len; causal, from the first query at or after k0.
  int q_begin = 0, q_end = a.sq;
  if (k0 >= a.kv_len) q_end = 0;
  if (a.causal) {
    q_begin = max(0, k0 + a.kv_offset - a.q_offset);
    q_begin -= q_begin % BK;
  }
  if constexpr (DP >= 256) {  // two accumulators do not fit: dV, then dK
    dkdv_pass<T, DP, false, true>(a, smem, q_begin, q_end);
    dkdv_pass<T, DP, true, false>(a, smem, q_begin, q_end);
  } else {
    dkdv_pass<T, DP, true, true>(a, smem, q_begin, q_end);
  }
}

// Shared memory: the operand tiles, then (fp32) the per-warp P scratch.
template <typename T, int BK>
constexpr int scratch_bytes() {
  return sizeof(T) == 4 ? kWarps * 16 * (BK + 4) * 4 : 0;
}

template <typename T, int DP>
struct Fwd {
  static cudaError_t run(const Args& a, int batch, cudaStream_t s) {
    constexpr int BK = Tile<T, DP>::kKeys;
    constexpr int bytes = (kBM + 2 * BK) * Tile<T, DP>::kLd * sizeof(T) +
                          scratch_bytes<T, BK>();
    // Above 48 KB dynamic shared memory is opted into; the attribute
    // belongs to the current device, so it is set on every launch.
    cudaError_t err = cudaFuncSetAttribute(
        flash_general_fwd_kernel<T, DP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    flash_general_fwd_kernel<T, DP>
        <<<dim3((a.sq + kBM - 1) / kBM, a.heads, batch), kThreads, bytes, s>>>(
            a);
    return cudaGetLastError();
  }
};

template <typename T, int DP>
struct Dq {
  static cudaError_t run(const Args& a, int batch, cudaStream_t s) {
    constexpr int BK = Tile<T, DP>::kKeys;
    constexpr int bytes = (2 * kBM + 2 * BK) * Tile<T, DP>::kLd * sizeof(T) +
                          scratch_bytes<T, BK>();
    cudaError_t err = cudaFuncSetAttribute(
        flash_general_dq_kernel<T, DP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    flash_general_dq_kernel<T, DP>
        <<<dim3((a.sq + kBM - 1) / kBM, a.heads, batch), kThreads, bytes, s>>>(
            a);
    return cudaGetLastError();
  }
};

template <typename T, int DP>
struct Dkdv {
  static cudaError_t run(const Args& a, int batch, cudaStream_t s) {
    constexpr int BK = Tile<T, DP>::kQueries;
    constexpr int bytes = (2 * kBM + 2 * BK) * Tile<T, DP>::kLd * sizeof(T) +
                          3 * BK * 4 + scratch_bytes<T, BK>();
    cudaError_t err = cudaFuncSetAttribute(
        flash_general_dkdv_kernel<T, DP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    flash_general_dkdv_kernel<T, DP>
        <<<dim3((a.skv + kBM - 1) / kBM, a.heads, batch), kThreads, bytes, s>>>(
            a);
    return cudaGetLastError();
  }
};

// The instantiation of L for (fp32 or bf16, d_pad).
template <template <typename, int> class L>
cudaError_t dispatch(int f32, int d_pad, const Args& a, int batch,
                     cudaStream_t s) {
  if (f32) {
    switch (d_pad) {
      case 16: return L<float, 16>::run(a, batch, s);
      case 32: return L<float, 32>::run(a, batch, s);
      case 64: return L<float, 64>::run(a, batch, s);
      case 128: return L<float, 128>::run(a, batch, s);
      case 256: return L<float, 256>::run(a, batch, s);
    }
  } else {
    switch (d_pad) {
      case 16: return L<__nv_bfloat16, 16>::run(a, batch, s);
      case 32: return L<__nv_bfloat16, 32>::run(a, batch, s);
      case 64: return L<__nv_bfloat16, 64>::run(a, batch, s);
      case 128: return L<__nv_bfloat16, 128>::run(a, batch, s);
      case 256: return L<__nv_bfloat16, 256>::run(a, batch, s);
    }
  }
  return cudaErrorInvalidValue;
}

Args make_args(int heads, int sq, int skv, int d, int kv_len, int q_offset,
               int kv_offset, float sm_scale, int causal) {
  Args a = {};
  a.heads = heads;
  a.sq = sq;
  a.skv = skv;
  a.d = d;
  a.kv_len = kv_len;
  a.q_offset = q_offset;
  a.kv_offset = kv_offset;
  a.causal = causal;
  a.scale = sm_scale;
  return a;
}

void set_strides(Args* a, const long long* strides, const int* slots, int n) {
  for (int i = 0; i < n; ++i) {
    for (int j = 0; j < 3; ++j) a->st[slots[i]][j] = strides[3 * i + j];
  }
}

template <template <typename, int> class L>
int launch(int f32, int d_pad, const Args& a, int batch, int device,
           void* stream) {
  if (a.d < 1 || a.d > d_pad) return static_cast<int>(cudaErrorInvalidValue);
  int current = 0;
  cudaError_t err = bind_device(device, &current);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = dispatch<L>(f32, d_pad, a, batch, static_cast<cudaStream_t>(stream));
  if (current != device) cudaSetDevice(current);
  return static_cast<int>(err);
}

}  // namespace

// Plain C entry points for ctypes. f32 selects fp32 (else bf16) operands,
// d_pad the compiled head dim (16, 32, 64, 128, 256; d <= d_pad). Strides
// are in elements, three a view (batch, seq, head); the head dim has unit
// stride. Each launches on `device`, on `stream`, and returns a cudaError_t
// (0 on a successful launch).

// strides: q, k, v, out.
extern "C" int hvt_flash_general_fwd(
    int f32, int d_pad, const void* q, const void* k, const void* v,
    void* out, void* lse, int batch, int heads, int sq, int skv, int d,
    const long long* strides, int kv_len, int q_offset, int kv_offset,
    float sm_scale, int causal, int device, void* stream) {
  Args a = make_args(heads, sq, skv, d, kv_len, q_offset, kv_offset, sm_scale,
                     causal);
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = out;
  a.lse = static_cast<float*>(lse);
  const int slots[] = {kQ, kK, kV, kO};
  set_strides(&a, strides, slots, 4);
  return launch<Fwd>(f32, d_pad, a, batch, device, stream);
}

// strides: q, k, v, dout, dq, dk, dv, out, given (the wgmma entries' order).
extern "C" int hvt_flash_general_dq(
    int f32, int d_pad, const void* q, const void* k, const void* v,
    const void* dout, const void* out, const void* dout_given, int given_f32,
    const void* lse, const void* glse, void* delta, void* dq, int batch,
    int heads, int sq, int skv, int d, const long long* strides, int kv_len,
    int q_offset, int kv_offset, float sm_scale, int causal, int device,
    void* stream) {
  Args a = make_args(heads, sq, skv, d, kv_len, q_offset, kv_offset, sm_scale,
                     causal);
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.out = out;
  a.given = dout_given;
  a.given_f32 = given_f32;
  a.lse = static_cast<float*>(const_cast<void*>(lse));
  a.glse = static_cast<const float*>(glse);
  a.delta = static_cast<float*>(delta);
  a.o = dq;
  const int slots[] = {kQ, kK, kV, kDO, kO, kDK, kDV, kOut, kGiven};
  set_strides(&a, strides, slots, 9);
  return launch<Dq>(f32, d_pad, a, batch, device, stream);
}

extern "C" int hvt_flash_general_dkdv(
    int f32, int d_pad, const void* q, const void* k, const void* v,
    const void* dout, const void* lse, const void* delta, const void* glse,
    void* dk, void* dv, int batch, int heads, int sq, int skv, int d,
    const long long* strides, int kv_len, int q_offset, int kv_offset,
    float sm_scale, int causal, int device, void* stream) {
  Args a = make_args(heads, sq, skv, d, kv_len, q_offset, kv_offset, sm_scale,
                     causal);
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.lse = static_cast<float*>(const_cast<void*>(lse));
  a.delta = static_cast<float*>(const_cast<void*>(delta));
  a.glse = static_cast<const float*>(glse);
  a.dk = dk;
  a.dv = dv;
  const int slots[] = {kQ, kK, kV, kDO, kO, kDK, kDV, kOut, kGiven};
  set_strides(&a, strides, slots, 9);
  return launch<Dkdv>(f32, d_pad, a, batch, device, stream);
}
