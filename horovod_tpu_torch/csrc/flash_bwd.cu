// Flash-attention backward for Hopper (sm_90a), written by hand in CUDA C++.
//
// Replaces horovod_tpu/ops/pallas_kernels.py::_bwd_kernel_dkdv and
// ::_bwd_kernel_dq, the two Pallas TPU kernels behind _bwd_pallas (the
// custom_vjp backward of flash_attention_with_lse). The same two-kernel
// split is kept, with no atomics, so the result is deterministic and each
// gradient is one sum per output element in a fixed order:
//
//   p  = exp(s * sm_scale - lse)        (masked; rows with lse = -inf give 0)
//   ds = p * (dp - delta) + g_lse * p   (dp = dO V^T, delta = rowsum(dO o O))
//   dv = P^T dO,  dk = dS^T Q * sm_scale,  dq = dS K * sm_scale
//
// with the TPU kernels' roundings: dO enters in the input dtype, P is
// rounded to bf16 before the dV product, dS to bf16 before the dK and dQ
// products, all products accumulate in fp32, sm_scale is applied to the
// fp32 sums. delta is computed by the wrapper (as _bwd_pallas computes it
// outside its kernels) and handed in with lse and g_lse as fp32 [B, H, Sq].
//
// Work split. flash_bwd_dkdv_kernel: one block of four warps owns one
// (batch, head, 64-key tile), 16 keys per warp, and walks the query tiles
// itself (the TPU kernel's sequential qi grid axis becomes this loop),
// keeping the dK and dV accumulators in fp32 registers. It computes the
// transposed tiles S^T = K Q^T and dP^T = V dO^T directly, so P^T and dS^T
// come out of the mma accumulators in the A-operand layout of the dV and dK
// products and never leave registers; Q and dO are staged in shared memory
// both row-major (B operand of S^T and dP^T) and transposed (B operand of
// dV and dK). flash_bwd_dq_kernel: one block owns one (batch, head,
// 64-query tile) and walks the key tiles, with K staged row-major and
// transposed and V row-major. Query tiles wholly before a key tile in the
// causal order are skipped by the dK/dV kernel, and key tiles wholly in the
// causal future of a query tile, or at or past kv_len, by the dQ kernel --
// the tiles pallas_kernels.py:505-508 and :565-567 skip. Masking inside a
// tile repeats the forward's rules exactly (causal on global positions
// q_offset / kv_offset, keys at or past kv_len, lse = -inf rows).
//
// Registers. At head dim 128 the dK/dV kernel takes query tiles of 32 (two
// 16 x 128 fp32 accumulators, 128 registers, plus the 16 x 32 S^T and dP^T
// tiles); at 64 it takes 64. K/V and Q/dO mma fragments are read from
// shared memory at each use rather than held, to keep room for the
// accumulators.
//
// Layout. q/k/v/dO are read in place through (batch, seq, head) strides
// with a unit stride along the head dim (the fused QKV projection's column
// views); dq/dk/dv are written through their own strides.
//
// What bounds it on an H100 SXM (data-sheet peaks at its 700 W limit: 3.35
// TB/s, 989 TFLOP/s dense bf16): at GPT-2 small's training shape (B=8,
// S=1024, H=12, D=64, causal) the causal half of the five products the
// gradient needs (S, dP, dV, dK, dQ; 6.45 GFLOP each) is 32 GFLOP, 0.033 ms
// at the bf16 peak, and reading q/k/v/out/dO/lse/g_lse once plus writing
// dq/dk/dv moves about 101 MB, 0.030 ms: the least time is set by
// operations. This design does seven such products, since the dQ kernel
// recomputes S and dP. What else it leaves on the table: no cp.async/TMA
// pipeline, mma.sync instead of wgmma, transposed tiles built with scalar
// shared-memory stores, and no scheduling of the uneven causal work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 64;  // keys per dK/dV block, queries per dQ block
constexpr int kPad = 8;    // bf16 row padding of every shared tile
constexpr float kLog2e = 1.4426950408889634f;

struct BwdParams {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const __nv_bfloat16* dout;
  const float* lse;    // [B, H, Sq]
  const float* delta;  // [B, H, Sq]
  const float* glse;   // [B, H, Sq], or null for zeros
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long do_sb, do_ss, do_sh;
  long long dq_sb, dq_ss, dq_sh;
  long long dk_sb, dk_ss, dk_sh;
  long long dv_sb, dv_ss, dv_sh;
  int n_heads, sq, skv, kv_len, q_offset, kv_offset, causal;
  float scale;       // sm_scale
  float scale_log2;  // sm_scale * log2(e): p runs on exp2
};

__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* ptr) {
  return *reinterpret_cast<const uint32_t*>(ptr);
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragment of rows [r0, r0 + 16) and columns [c0, c0 + 16) of a
// row-major shared tile with row stride ld.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const __nv_bfloat16* s,
                                       int ld, int r0, int c0, int g, int t) {
  const __nv_bfloat16* base = s + (r0 + g) * ld + c0 + t * 2;
  a[0] = ld_u32(base);
  a[1] = ld_u32(base + 8 * ld);
  a[2] = ld_u32(base + 8);
  a[3] = ld_u32(base + 8 * ld + 8);
}

// A fragment (16 rows x 16 columns) from fp32 accumulator tiles n = 2kk and
// 2kk + 1, rounded to bf16: the C layout of m16n8 is the A layout of m16k16.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&lo)[4],
                                         const float (&hi)[4]) {
  a[0] = pack_bf16x2(lo[0], lo[1]);
  a[1] = pack_bf16x2(lo[2], lo[3]);
  a[2] = pack_bf16x2(hi[0], hi[1]);
  a[3] = pack_bf16x2(hi[2], hi[3]);
}

// Rows [r0, r0 + rows) of a strided [S, D] matrix (rows at or past n_valid
// read as zero) into shared memory: row-major into dst (row stride ld) and,
// when dst_t is not null, transposed into dst_t (row stride ld_t).
// Neighbouring threads take neighbouring rows, so the transposed scalar
// stores spread over the banks.
template <int D>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst, int ld,
                                           __nv_bfloat16* dst_t, int ld_t,
                                           const __nv_bfloat16* src, long long ss,
                                           int r0, int rows, int n_valid,
                                           int tid) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  for (int i = tid; i < rows * kChunks; i += kThreads) {
    const int r = i % rows, c = (i / rows) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < n_valid) {
      val = *reinterpret_cast<const uint4*>(src + (long long)(r0 + r) * ss + c);
    }
    *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
    if (dst_t != nullptr) {
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
      for (int x = 0; x < 8; ++x) dst_t[(c + x) * ld_t + r] = e[x];
    }
  }
}

template <int D, int BQ>
struct DkdvSmem {
  static constexpr int kLd = D + kPad;    // row-major tiles
  static constexpr int kLdT = BQ + kPad;  // transposed query tiles
  static constexpr int kBytes =
      sizeof(__nv_bfloat16) * (2 * kTile * kLd + 2 * BQ * kLd + 2 * D * kLdT) +
      sizeof(float) * 3 * BQ;
};

template <int D, int BQ>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkdv_kernel(const BwdParams p) {
  using S = DkdvSmem<D, BQ>;
  constexpr int kLd = S::kLd;
  constexpr int kLdT = S::kLdT;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem);  // [kTile][kLd]
  __nv_bfloat16* sV = sK + kTile * kLd;                         // [kTile][kLd]
  __nv_bfloat16* sQ = sV + kTile * kLd;                         // [BQ][kLd]
  __nv_bfloat16* sdO = sQ + BQ * kLd;                           // [BQ][kLd]
  __nv_bfloat16* sQt = sdO + BQ * kLd;                          // [D][kLdT]
  __nv_bfloat16* sdOt = sQt + D * kLdT;                         // [D][kLdT]
  float* sLse = reinterpret_cast<float*>(sdOt + D * kLdT);      // lse * log2(e)
  float* sDelta = sLse + BQ;
  float* sGlse = sDelta + BQ;

  const int k0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wk = warp * 16;  // this warp's 16 keys within the tile

  const __nv_bfloat16* qb = p.q + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kb = p.k + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* vb = p.v + b * p.v_sb + h * p.v_sh;
  const __nv_bfloat16* dob = p.dout + b * p.do_sb + h * p.do_sh;
  const long long stat0 = ((long long)b * p.n_heads + h) * p.sq;

  stage_rows<D>(sK, kLd, nullptr, 0, kb, p.k_ss, k0, kTile, p.skv, tid);
  stage_rows<D>(sV, kLd, nullptr, 0, vb, p.v_ss, k0, kTile, p.skv, tid);

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[dn][e] = dv[dn][e] = 0.f;
  }
  const int key[2] = {k0 + wk + g, k0 + wk + g + 8};

  // Query tiles that can see some key of this tile: none past kv_len; with
  // the causal mask, none wholly before the tile's first key.
  int qt_begin = 0, qt_end = 0;
  if (k0 < p.kv_len) {
    qt_end = (p.sq + BQ - 1) / BQ;
    if (p.causal) {
      const int first = p.kv_offset + k0 - p.q_offset;
      if (first > 0) qt_begin = min(first / BQ, qt_end);
    }
  }

  for (int qt = qt_begin; qt < qt_end; ++qt) {
    const int q0 = qt * BQ;
    __syncthreads();  // every warp is done with the previous query tile
    stage_rows<D>(sQ, kLd, sQt, kLdT, qb, p.q_ss, q0, BQ, p.sq, tid);
    stage_rows<D>(sdO, kLd, sdOt, kLdT, dob, p.do_ss, q0, BQ, p.sq, tid);
    for (int i = tid; i < BQ; i += kThreads) {
      const int row = q0 + i;
      float l = -INFINITY, dl = 0.f, gl = 0.f;
      if (row < p.sq) {
        l = p.lse[stat0 + row] * kLog2e;
        dl = p.delta[stat0 + row];
        if (p.glse != nullptr) gl = p.glse[stat0 + row];
      }
      sLse[i] = l;
      sDelta[i] = dl;
      sGlse[i] = gl;
    }
    __syncthreads();

    // S^T = K Q^T: this warp's 16 keys x BQ queries, fp32.
    float st[BQ / 8][4];
#pragma unroll
    for (int n = 0; n < BQ / 8; ++n) st[n][0] = st[n][1] = st[n][2] = st[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      load_a(a, sK, kLd, wk, kk * 16, g, t);
#pragma unroll
      for (int n = 0; n < BQ / 8; ++n) {
        const __nv_bfloat16* bp = sQ + (n * 8 + g) * kLd + kk * 16 + t * 2;
        mma_16816(st[n], a, ld_u32(bp), ld_u32(bp + 8));
      }
    }

    // P^T = exp(S^T * scale - lse) under the forward's mask.
#pragma unroll
    for (int n = 0; n < BQ / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n * 8 + t * 2 + (e & 1);
        const int j = key[e >> 1];
        const float l2 = sLse[col];
        const bool ok = j < p.kv_len && l2 != -INFINITY &&
                        (!p.causal || p.q_offset + q0 + col >= p.kv_offset + j);
        st[n][e] = ok ? exp2f(st[n][e] * p.scale_log2 - l2) : 0.f;
      }
    }

    // dV += P^T dO, P rounded to bf16.
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      uint32_t a[4];
      acc_to_a(a, st[2 * kk], st[2 * kk + 1]);
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
        const __nv_bfloat16* bp = sdOt + (dn * 8 + g) * kLdT + kk * 16 + t * 2;
        mma_16816(dv[dn], a, ld_u32(bp), ld_u32(bp + 8));
      }
    }

    // dP^T = V dO^T.
    float dpt[BQ / 8][4];
#pragma unroll
    for (int n = 0; n < BQ / 8; ++n) dpt[n][0] = dpt[n][1] = dpt[n][2] = dpt[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      load_a(a, sV, kLd, wk, kk * 16, g, t);
#pragma unroll
      for (int n = 0; n < BQ / 8; ++n) {
        const __nv_bfloat16* bp = sdO + (n * 8 + g) * kLd + kk * 16 + t * 2;
        mma_16816(dpt[n], a, ld_u32(bp), ld_u32(bp + 8));
      }
    }

    // dS^T = P^T (dP^T - delta) + g_lse P^T, in place of dP^T.
#pragma unroll
    for (int n = 0; n < BQ / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n * 8 + t * 2 + (e & 1);
        dpt[n][e] = st[n][e] * (dpt[n][e] - sDelta[col]) + sGlse[col] * st[n][e];
      }
    }

    // dK += dS^T Q, dS rounded to bf16.
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      uint32_t a[4];
      acc_to_a(a, dpt[2 * kk], dpt[2 * kk + 1]);
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
        const __nv_bfloat16* bp = sQt + (dn * 8 + g) * kLdT + kk * 16 + t * 2;
        mma_16816(dk[dn], a, ld_u32(bp), ld_u32(bp + 8));
      }
    }
  }

  // Every key below skv gets its row, zero where no query saw it.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (key[r] >= p.skv) continue;
    __nv_bfloat16* dkr = p.dk + b * p.dk_sb + h * p.dk_sh + (long long)key[r] * p.dk_ss;
    __nv_bfloat16* dvr = p.dv + b * p.dv_sb + h * p.dv_sh + (long long)key[r] * p.dv_ss;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      *reinterpret_cast<uint32_t*>(dkr + dn * 8 + t * 2) = pack_bf16x2(
          dk[dn][2 * r] * p.scale, dk[dn][2 * r + 1] * p.scale);
      *reinterpret_cast<uint32_t*>(dvr + dn * 8 + t * 2) =
          pack_bf16x2(dv[dn][2 * r], dv[dn][2 * r + 1]);
    }
  }
}

template <int D>
struct DqSmem {
  static constexpr int kLd = D + kPad;       // row-major tiles
  static constexpr int kLdT = kTile + kPad;  // transposed key tile
  static constexpr int kBytes =
      sizeof(__nv_bfloat16) * (4 * kTile * kLd + D * kLdT);
};

template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(const BwdParams p) {
  using S = DqSmem<D>;
  constexpr int kLd = S::kLd;
  constexpr int kLdT = S::kLdT;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);  // [kTile][kLd]
  __nv_bfloat16* sdO = sQ + kTile * kLd;                        // [kTile][kLd]
  __nv_bfloat16* sK = sdO + kTile * kLd;                        // [kTile][kLd]
  __nv_bfloat16* sV = sK + kTile * kLd;                         // [kTile][kLd]
  __nv_bfloat16* sKt = sV + kTile * kLd;                        // [D][kLdT]

  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wr = warp * 16;  // this warp's 16 query rows within the tile

  const __nv_bfloat16* qb = p.q + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kb = p.k + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* vb = p.v + b * p.v_sb + h * p.v_sh;
  const __nv_bfloat16* dob = p.dout + b * p.do_sb + h * p.do_sh;
  const long long stat0 = ((long long)b * p.n_heads + h) * p.sq;

  stage_rows<D>(sQ, kLd, nullptr, 0, qb, p.q_ss, q0, kTile, p.sq, tid);
  stage_rows<D>(sdO, kLd, nullptr, 0, dob, p.do_ss, q0, kTile, p.sq, tid);

  // Rows g and g + 8 of the warp's 16: their statistics stay in registers.
  int row[2], qpos[2];
  float lse2[2], delta[2], glse[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    row[r] = q0 + wr + g + 8 * r;
    qpos[r] = p.q_offset + row[r];
    lse2[r] = -INFINITY;
    delta[r] = glse[r] = 0.f;
    if (row[r] < p.sq) {
      lse2[r] = p.lse[stat0 + row[r]] * kLog2e;
      delta[r] = p.delta[stat0 + row[r]];
      if (p.glse != nullptr) glse[r] = p.glse[stat0 + row[r]];
    }
  }

  // Keys [0, kv_end) can be valid for some row of this tile.
  int kv_end = p.kv_len;
  if (p.causal) {
    const int q_last = p.q_offset + min(q0 + kTile, p.sq) - 1;
    kv_end = min(kv_end, max(q_last - p.kv_offset + 1, 0));
  }
  const int n_tiles = (kv_end + kTile - 1) / kTile;

  float dq[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) dq[dn][0] = dq[dn][1] = dq[dn][2] = dq[dn][3] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kTile;
    __syncthreads();  // every warp is done with the previous key tile
    stage_rows<D>(sK, kLd, sKt, kLdT, kb, p.k_ss, k0, kTile, p.skv, tid);
    stage_rows<D>(sV, kLd, nullptr, 0, vb, p.v_ss, k0, kTile, p.skv, tid);
    __syncthreads();

    // S = Q K^T: the warp's 16 rows x 64 keys.
    float s[kTile / 8][4];
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      load_a(a, sQ, kLd, wr, kk * 16, g, t);
#pragma unroll
      for (int n = 0; n < kTile / 8; ++n) {
        const __nv_bfloat16* bp = sK + (n * 8 + g) * kLd + kk * 16 + t * 2;
        mma_16816(s[n], a, ld_u32(bp), ld_u32(bp + 8));
      }
    }
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int col = k0 + n * 8 + t * 2 + (e & 1);
        const bool ok = col < p.kv_len && lse2[r] != -INFINITY &&
                        (!p.causal || qpos[r] >= p.kv_offset + col);
        s[n][e] = ok ? exp2f(s[n][e] * p.scale_log2 - lse2[r]) : 0.f;
      }
    }

    // dP = dO V^T, then dS = P (dP - delta) + g_lse P in place of dP.
    float dp[kTile / 8][4];
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n) dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      load_a(a, sdO, kLd, wr, kk * 16, g, t);
#pragma unroll
      for (int n = 0; n < kTile / 8; ++n) {
        const __nv_bfloat16* bp = sV + (n * 8 + g) * kLd + kk * 16 + t * 2;
        mma_16816(dp[n], a, ld_u32(bp), ld_u32(bp + 8));
      }
    }
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        dp[n][e] = s[n][e] * (dp[n][e] - delta[r]) + glse[r] * s[n][e];
      }
    }

    // dQ += dS K, dS rounded to bf16.
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      uint32_t a[4];
      acc_to_a(a, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
        const __nv_bfloat16* bp = sKt + (dn * 8 + g) * kLdT + kk * 16 + t * 2;
        mma_16816(dq[dn], a, ld_u32(bp), ld_u32(bp + 8));
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= p.sq) continue;
    __nv_bfloat16* dqr = p.dq + b * p.dq_sb + h * p.dq_sh + (long long)row[r] * p.dq_ss;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      *reinterpret_cast<uint32_t*>(dqr + dn * 8 + t * 2) = pack_bf16x2(
          dq[dn][2 * r] * p.scale, dq[dn][2 * r + 1] * p.scale);
    }
  }
}

template <int D, int BQ>
cudaError_t launch_dkdv(const BwdParams& p, int batch, cudaStream_t stream) {
  constexpr int kSmem = DkdvSmem<D, BQ>::kBytes;
  // Above 48 KB dynamic shared memory must be opted into; the attribute
  // belongs to the current device, so it is set on every launch.
  const cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_kernel<D, BQ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.skv + kTile - 1) / kTile, p.n_heads, batch);
  flash_bwd_dkdv_kernel<D, BQ><<<grid, kThreads, kSmem, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq(const BwdParams& p, int batch, cudaStream_t stream) {
  constexpr int kSmem = DqSmem<D>::kBytes;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.sq + kTile - 1) / kTile, p.n_heads, batch);
  flash_bwd_dq_kernel<D><<<grid, kThreads, kSmem, stream>>>(p);
  return cudaGetLastError();
}

BwdParams make_params(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, const void* glse,
                      void* dq, void* dk, void* dv, int n_heads, int sq, int skv,
                      const long long* st, int kv_len, int q_offset,
                      int kv_offset, float sm_scale, int causal) {
  BwdParams p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.dout = static_cast<const __nv_bfloat16*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.glse = static_cast<const float*>(glse);
  p.dq = static_cast<__nv_bfloat16*>(dq);
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  p.q_sb = st[0]; p.q_ss = st[1]; p.q_sh = st[2];
  p.k_sb = st[3]; p.k_ss = st[4]; p.k_sh = st[5];
  p.v_sb = st[6]; p.v_ss = st[7]; p.v_sh = st[8];
  p.do_sb = st[9]; p.do_ss = st[10]; p.do_sh = st[11];
  p.dq_sb = st[12]; p.dq_ss = st[13]; p.dq_sh = st[14];
  p.dk_sb = st[15]; p.dk_ss = st[16]; p.dk_sh = st[17];
  p.dv_sb = st[18]; p.dv_ss = st[19]; p.dv_sh = st[20];
  p.n_heads = n_heads;
  p.sq = sq;
  p.skv = skv;
  p.kv_len = kv_len;
  p.q_offset = q_offset;
  p.kv_offset = kv_offset;
  p.causal = causal;
  p.scale = sm_scale;
  p.scale_log2 = sm_scale * kLog2e;
  return p;
}

}  // namespace

// Plain C entry points for ctypes. Strides are in elements, 21 of them in
// the order (batch, seq, head) of q, k, v, dO, dq, dk, dv; the head dim has
// unit stride. glse may be null (zero cotangent of lse). Each launches one
// kernel and returns a cudaError_t (0 on a successful launch).
extern "C" int hvt_flash_bwd_dkdv_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* glse, void* dk, void* dv,
    int batch, int n_heads, int sq, int skv, int head_dim,
    const long long* strides, int kv_len, int q_offset, int kv_offset,
    float sm_scale, int causal, void* stream) {
  const BwdParams p = make_params(q, k, v, dout, lse, delta, glse, nullptr, dk,
                                  dv, n_heads, sq, skv, strides, kv_len,
                                  q_offset, kv_offset, sm_scale, causal);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64:
      return static_cast<int>(launch_dkdv<64, 64>(p, batch, s));
    case 128:
      return static_cast<int>(launch_dkdv<128, 32>(p, batch, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int hvt_flash_bwd_dq_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* glse, void* dq,
    int batch, int n_heads, int sq, int skv, int head_dim,
    const long long* strides, int kv_len, int q_offset, int kv_offset,
    float sm_scale, int causal, void* stream) {
  const BwdParams p = make_params(q, k, v, dout, lse, delta, glse, dq, nullptr,
                                  nullptr, n_heads, sq, skv, strides, kv_len,
                                  q_offset, kv_offset, sm_scale, causal);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64:
      return static_cast<int>(launch_dq<64>(p, batch, s));
    case 128:
      return static_cast<int>(launch_dq<128>(p, batch, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
