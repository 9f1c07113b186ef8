// Flash-attention backward for Hopper (sm_90a) at the head dims and in the
// dtype that flash_bwd.cu does not take, written by hand in CUDA C++: bf16
// on wgmma fed by TMA at d_pad 16, 32, 64, 128 and 256, and fp32 on the
// tensor cores as 3xTF32 at d_pad 16, 32, 64 and 128.
//
// Replaces, on the sm90 route of ops/flash_attention.py (bwd_route),
// flash_general.cu's flash_general_dq_kernel and flash_general_dkdv_kernel,
// which compute what horovod_tpu/ops/pallas_kernels.py::_bwd_kernel_dq and
// ::_bwd_kernel_dkdv compute behind _bwd_pallas. The same two-kernel split,
// with no atomics, so every gradient element is one sum in a fixed order
// and two calls agree bit for bit:
//
//   dQ kernel:    delta = rowsum(dO o out) in fp32 from the cotangent as
//                 given (bf16 or fp32), written to an fp32 [B, H, Sq]
//                 scratch; p = exp(s * sm_scale - lse) (masked; rows with
//                 lse = -inf give 0), ds = p (dp - delta) + g_lse p,
//                 dQ = dS K * sm_scale;
//   dK/dV kernel: launched after it on the same stream, reads delta;
//                 dV = P^T dO, dK = dS^T Q * sm_scale.
//
// Masks: causal on global positions q_offset / kv_offset, keys at or past
// kv_len, sm_scale of either sign. bf16 keeps the TPU kernels' roundings:
// dO in the input dtype for the products, P rounded to bf16 before dV, dS
// before dK and dQ, every sum fp32. In fp32 nothing is rounded but the
// products' operands (below).
//
// bf16: the design of flash_bwd.cu (header there), generalised to a head
// dim d that is not 64 or 128. One block = two consumer warpgroups of 64
// rows and a producer warp that keeps a ring of kStages stages full with
// TMA (cp.async.bulk.tensor, mbarrier completion); all seven products are
// bf16 wgmma with fp32 accumulators; P^T and dS^T (dP and dS) are packed
// from the fp32 accumulators into register A fragments, never transposed
// through shared memory; the dK/dV kernel's warpgroups ping-pong; the
// heaviest causal tiles go first. What changes with d_pad:
//
//   - the TMA box and the swizzle: a box is min(d_pad, 64) columns, so a
//     row is 32 bytes at d_pad 16 (32B swizzle), 64 at 32 (64B swizzle)
//     and 128 at 64 and 128 (128B swizzle, two boxes a row at 128); the
//     wgmma descriptors take the matching layout type and eight-row
//     stride. The products over the rows (dQ += dS K, dV += P^T dO, dK +=
//     dS^T Q) read their B operand MN-major through the descriptor's
//     transpose bit, one box wide (n16, n32 or n64);
//   - the tensor map's D extent is d itself: TMA's zero fill pads columns
//     d..d_pad, so a column third of a fused QKV projection is read in
//     place and never past its own columns; delta reads only columns
//     below d, and the epilogues store only those;
//   - at d_pad 64 the S / dP products take Q, dO (K, V) as register A
//     fragments, as flash_bwd.cu does at 64; elsewhere both operands come
//     from shared memory.
//
// At d_pad 256 two 64 x 256 fp32 accumulators (dK and dV of one
// warpgroup) would be 256 registers a thread, more than setmaxnreg gives.
// The dK/dV kernel splits the head dim between its two warpgroups: a block
// owns 64 keys, each warpgroup accumulates two boxes (128 columns) of dK
// and dV, and each computes S^T and dP^T over the whole head dim itself --
// two products of the six more than a 128-key block does, against
// flash_general.cu's two passes, which would stream every Q and dO tile
// twice and recompute S^T in each. The dQ kernel's Q and dO tiles (128
// rows x 512 bytes each) leave room for a ring of 3 stages of 32-key K/V
// tiles, and delta is summed after the query tile's wait, chunk by chunk.
//
// fp32 (namespace tf32): wgmma takes .tf32 operands from shared memory
// only K-major, and dQ += dS K, dV += P^T dO, dK += dS^T Q read their B
// operand MN-major as it lands. So these kernels run the seven products on
// mma.sync.m16n8k8 .tf32, whose fragments are loaded from any layout, as
// 3xTF32: each operand x becomes hi = rna(x), lo = rna(x - hi) (rna: round
// to nearest, ties away, to tf32's 10 mantissa bits, what cvt.rna.tf32.f32
// does, written as integer operations on the bits: the cvt measured slower),
// and C += A_lo B_hi + A_hi B_lo + A_hi B_hi in fp32 accumulators; the
// dropped lo lo term is about 2^-22 of a product. A block is four warps of
// 16 rows (64 rows), as in flash_general.cu; the tiles it walks (64 rows,
// 32 from d_pad 64 on) are double-buffered in shared memory by cp.async
// (zero fill past S and past d), rows padded by 16 bytes so every fragment
// load is free of bank conflicts. P and dS go from the C fragment of one
// product to the A fragment of the next in registers: the contraction
// index inside an 8-column block is permuted (logical k = t reads column
// 2t, t + 4 reads 2t + 1), and B's rows are read in the same order. p runs
// on exp2 with lse and the scale premultiplied by log2(e). The wgmma form
// was not kept: its B operands would need hi and lo planes, and the three
// MN-major ones transposed copies of both, in shared memory (at d_pad 64
// and 32-row streamed tiles about 48 KB a stage beside 128 KB of block
// constants), or its A operands 128 registers a thread of hi and lo
// fragments beside the accumulators. What bounds this design is
// mma.sync's tf32 rate, about 9 clocks a m16n8k8 product an SM
// sub-partition on the H100 (one product a product instead of three
// measured 0.82 against 1.22 ms at GPT-2 small's shape). fp32 d_pad 256
// stays on flash_general.cu: its fp32 tiles of 64 rows are 66 KB each, and
// its dK/dV accumulators 128 registers a thread each.
//
// Which (dtype, d_pad) the wrapper sends here is its bwd_route; each was
// routed only where this pair measured faster than flash_general.cu's in
// the same chip run (PERF.md).
//
// What bounds it on an H100 SXM (data-sheet peaks at 700 W: 3.35 TB/s, 989
// TFLOP/s dense bf16, 495 TF32, 67 fp32 outside the tensor cores): at
// GPT-2 small's fp32 training shape (B=8, S=1024, H=12, D=64, causal) the
// causal half of the five products the gradient needs is 32.2 GFLOP:
// 0.481 ms at the FFMA rate, 0.195 ms as three TF32 products a product at
// the tensor cores' rate; this design does seven (dQ recomputes S and dP),
// so its own floor is 0.274 ms. In bf16 at d_pad 16 and 32 the products are
// thin and the exp work (each kernel recomputes P) sets the floor. What it
// leaves on the table: mma.sync's rate in fp32 (a fraction of wgmma's); the
// hi/lo split of every B fragment in registers at each use; the fp32
// kernels' four-warp blocks, with only other resident blocks hiding a
// tile's latency; the bf16 S / dP products at d_pad 16 and 32 reading both
// operands from shared memory.

#include <cmath>

#include "sm90_common.cuh"

namespace {

constexpr int kConsumers = 2;                // consumer warpgroups
constexpr int kRows = 64 * kConsumers;       // queries per dQ block, keys per dK/dV block
constexpr int kThreads = (kConsumers + 1) * 128;
constexpr int kStages = 4;                   // the dK/dV kernel's ring

// A bf16 operand tile at d_pad D: boxes of kCols columns, kRB bytes a row
// under the swizzle of that width (layout type kLayout of a wgmma
// descriptor: 1 = 128B, 2 = 64B, 3 = 32B), eight-row groups kGroup bytes
// apart; kSteps k16 steps a box row.
template <int D>
struct Geo {
  static_assert(D == 16 || D == 32 || D == 64 || D == 128 || D == 256,
                "bf16 d_pad");
  static constexpr int kCols = D < 64 ? D : 64;
  static constexpr int kBoxes = D / kCols;
  static constexpr int kRB = 2 * kCols;
  static constexpr int kGroup = 8 * kRB;
  static constexpr int kSteps = kCols / 16;
  static constexpr uint64_t kLayout = kRB == 128 ? 1 : (kRB == 64 ? 2 : 3);
};

// Descriptors of a tile TMA wrote at d_pad D. K-major (the contraction runs
// along the row): SBO the eight-row group, LBO unused (a k16 step never
// leaves a swizzle row). MN-major (the contraction runs down the rows): the
// eight-row groups are the K direction; the operand is one box, one swizzle
// atom wide, so the other offset is unused; both are set to the group.
template <int D>
__device__ __forceinline__ uint64_t gdesc_k(const void* tile) {
  using G = Geo<D>;
  const uint64_t addr = smem_u32(tile);
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (uint64_t(G::kGroup >> 4) << 32) | (G::kLayout << 62);
}

template <int D>
__device__ __forceinline__ uint64_t gdesc_mn(const void* tile) {
  using G = Geo<D>;
  const uint64_t addr = smem_u32(tile);
  return ((addr & 0x3FFFF) >> 4) | (uint64_t(G::kGroup >> 4) << 16) |
         (uint64_t(G::kGroup >> 4) << 32) | (G::kLayout << 62);
}

// Byte offset of k16 step kk along a K-major tile's rows (boxes box_bytes
// apart).
template <int D>
__device__ __forceinline__ int kstep(int kk, int box_bytes) {
  using G = Geo<D>;
  return (kk / G::kSteps) * box_bytes + (kk % G::kSteps) * 32;
}

// d (64 x 16, fp32) += A (64 x 16, registers) B (16 x 16, shared): B
// K-major, or MN-major with kTransB.
template <bool kTransB>
__device__ __forceinline__ void wgmma_rs(float (&d)[8], const uint32_t (&a)[4],
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, "
      "%14;\n}\n"
      : HVT_F8(d, 0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate),
        "n"(int(kTransB)));
}

// d (64 x 32, fp32) += A (64 x 16, registers) B (16 x 32, shared).
template <bool kTransB>
__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4],
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {" HVT_R16
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
      : HVT_F8(d, 0), HVT_F8(d, 8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate),
        "n"(int(kTransB)));
}

struct Params {
  const __nv_bfloat16* out;  // dQ kernel: the forward's output, for delta
  const void* dout_given;    // dQ kernel: the cotangent as given (bf16 or fp32)
  const float* lse;          // [B, H, Sq]
  const float* glse;         // [B, H, Sq], or null for zeros
  float* delta;              // [B, H, Sq]: written by dQ, read by dK/dV
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  long long o_sb, o_ss, o_sh;
  long long g_sb, g_ss, g_sh;
  long long dq_sb, dq_ss, dq_sh;
  long long dk_sb, dk_ss, dk_sh;
  long long dv_sb, dv_ss, dv_sh;
  int batch, n_heads, sq, skv, d, kv_len, q_offset, kv_offset, causal;
  int given_f32;
  int row_tiles;     // tiles of the block's own axis (queries or keys)
  float scale;       // sm_scale
  float scale_log2;  // sm_scale * log2(e): p runs on exp2
};

__device__ __forceinline__ float dot8(const uint4& o, const uint4& g) {
  const __nv_bfloat162* oe = reinterpret_cast<const __nv_bfloat162*>(&o);
  const __nv_bfloat162* ge = reinterpret_cast<const __nv_bfloat162*>(&g);
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 of = __bfloat1622float2(oe[i]);
    const float2 gf = __bfloat1622float2(ge[i]);
    acc = fmaf(of.x, gf.x, acc);
    acc = fmaf(of.y, gf.y, acc);
  }
  return acc;
}

__device__ __forceinline__ float dot8(const uint4& o, const uint4& g0,
                                      const uint4& g1) {
  const __nv_bfloat162* oe = reinterpret_cast<const __nv_bfloat162*>(&o);
  const float4 a = *reinterpret_cast<const float4*>(&g0);
  const float4 b = *reinterpret_cast<const float4*>(&g1);
  const float g[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 of = __bfloat1622float2(oe[i]);
    acc = fmaf(of.x, g[2 * i], acc);
    acc = fmaf(of.y, g[2 * i + 1], acc);
  }
  return acc;
}

// Half `half` of row r's O and dO (as given) for delta, in chunks of 8
// columns, zero at or past d: loaded first, so their latency overlaps the
// query tile's TMA, and summed later in fp32 in a fixed order.
template <int D>
struct DeltaHalfRow {
  static constexpr int kHalf = D / 2;
  static constexpr int kChunks = kHalf / 8;
  uint4 o[kChunks];
  uint4 g[2 * kChunks];  // fp32: two a chunk; bf16: the first kChunks

  __device__ __forceinline__ void load(const Params& p, int b, int h, int r,
                                       int half) {
    const int c0 = half * kHalf;
    const __nv_bfloat16* orow = p.out + b * p.o_sb + h * p.o_sh +
                                static_cast<long long>(r) * p.o_ss + c0;
    const long long g0 = b * p.g_sb + h * p.g_sh +
                         static_cast<long long>(r) * p.g_ss + c0;
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      o[i] = c0 + 8 * i < p.d ? reinterpret_cast<const uint4*>(orow)[i] : zero;
    }
    if (p.given_f32) {
      const uint4* gp = reinterpret_cast<const uint4*>(
          static_cast<const float*>(p.dout_given) + g0);
#pragma unroll
      for (int i = 0; i < kChunks; ++i) {
        const bool in = c0 + 8 * i < p.d;
        g[2 * i] = in ? gp[2 * i] : zero;
        g[2 * i + 1] = in ? gp[2 * i + 1] : zero;
      }
    } else {
      const uint4* gp = reinterpret_cast<const uint4*>(
          static_cast<const __nv_bfloat16*>(p.dout_given) + g0);
#pragma unroll
      for (int i = 0; i < kChunks; ++i) {
        g[i] = c0 + 8 * i < p.d ? gp[i] : zero;
      }
    }
  }

  __device__ __forceinline__ float dot(bool given_f32) const {
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      acc += given_f32 ? dot8(o[i], g[2 * i], g[2 * i + 1]) : dot8(o[i], g[i]);
    }
    return acc;
  }
};

// Row r's half `half` of rowsum(dO o out), loaded and summed chunk by chunk
// in DeltaHalfRow's order: at d_pad 256 a prefetched half row of fp32
// cotangent would hold 192 registers.
template <int D>
__device__ __forceinline__ float delta_half(const Params& p, int b, int h,
                                            int r, int half) {
  constexpr int kHalf = D / 2;
  const int c0 = half * kHalf;
  const uint4* orow = reinterpret_cast<const uint4*>(
      p.out + b * p.o_sb + h * p.o_sh + static_cast<long long>(r) * p.o_ss + c0);
  const long long g0 = b * p.g_sb + h * p.g_sh +
                       static_cast<long long>(r) * p.g_ss + c0;
  const uint4* g32 = reinterpret_cast<const uint4*>(
      static_cast<const float*>(p.dout_given) + g0);
  const uint4* g16 = reinterpret_cast<const uint4*>(
      static_cast<const __nv_bfloat16*>(p.dout_given) + g0);
  float acc = 0.f;
#pragma unroll 4
  for (int i = 0; i < kHalf / 8; ++i) {
    if (c0 + 8 * i >= p.d) break;
    acc += p.given_f32 ? dot8(orow[i], g32[2 * i], g32[2 * i + 1])
                       : dot8(orow[i], g16[i]);
  }
  return acc;
}

// The dQ kernel's key tiles: 64 keys in a ring of 4 stages; at d_pad 256,
// where the query tile alone is 128 KB, 32 keys in 3.
template <int D>
struct DqSmem {
  using G = Geo<D>;
  static constexpr int kBK = D == 256 ? 32 : 64;  // keys a tile
  static constexpr int kStages = D == 256 ? 3 : 4;
  static constexpr int kQBox = kRows * G::kRB;  // a box of the query tile
  static constexpr int kKBox = kBK * G::kRB;    // a box of a key tile
  static constexpr int kStageBytes = 2 * G::kBoxes * kKBox;  // K and V
  static constexpr int kBytes = 2 * G::kBoxes * kQBox + kStages * kStageBytes +
                                (1 + 2 * kStages) * 8 + 1024;
};

// S = Q K^T and dP = dO V^T for the warpgroup's 64 rows against one key
// tile (sk, sv), each its own commit group. At d_pad 64 the A operands are
// held in registers (qa_r, doa_r); elsewhere they are read from shared
// memory (qa, doa).
template <int D, bool kRegA, int KS, int N>
__device__ __forceinline__ void issue_s_dp(float (&sacc)[N], float (&dp)[N],
                                           const uint32_t (&qa_r)[KS][4],
                                           const uint32_t (&doa_r)[KS][4],
                                           const uint8_t* qa, const uint8_t* doa,
                                           int qbox, const uint8_t* sk,
                                           const uint8_t* sv, int kbox) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint64_t db = gdesc_k<D>(sk + kstep<D>(kk, kbox));
    if constexpr (kRegA) {
      wgmma_rs<false>(sacc, qa_r[kk], db, kk > 0);
    } else {
      wgmma_ss(sacc, gdesc_k<D>(qa + kstep<D>(kk, qbox)), db, kk > 0);
    }
  }
  wgmma_commit();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint64_t db = gdesc_k<D>(sv + kstep<D>(kk, kbox));
    if constexpr (kRegA) {
      wgmma_rs<false>(dp, doa_r[kk], db, kk > 0);
    } else {
      wgmma_ss(dp, gdesc_k<D>(doa + kstep<D>(kk, qbox)), db, kk > 0);
    }
  }
  wgmma_commit();
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_sm90_dq_kernel(const Params p,
                             const __grid_constant__ CUtensorMap map_q,
                             const __grid_constant__ CUtensorMap map_do,
                             const __grid_constant__ CUtensorMap map_k,
                             const __grid_constant__ CUtensorMap map_v) {
  using G = Geo<D>;
  using S = DqSmem<D>;
  constexpr int kBK = S::kBK, kStages = S::kStages;
  constexpr int kBoxes = G::kBoxes;
  constexpr int kN = G::kCols / 2;  // accumulator floats a box
  constexpr bool kRegA = D == 64;
  constexpr int kAS = kRegA ? D / 16 : 1;  // register A k-steps
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* sQ = align1024(smem_raw);
  uint8_t* sdO = sQ + kBoxes * S::kQBox;
  uint8_t* stages = sdO + kBoxes * S::kQBox;
  uint64_t* qbar = reinterpret_cast<uint64_t*>(stages + kStages * S::kStageBytes);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + kStages;

  const Block blk = block_of(p, true);
  const int q0 = blk.tile * kRows;
  // Keys [0, kv_end) can be valid for some row of this tile.
  int kv_end = p.kv_len;
  if (p.causal) {
    const int q_last = p.q_offset + min(q0 + kRows, p.sq) - 1;
    kv_end = min(kv_end, max(q_last - p.kv_offset + 1, 0));
  }
  const int n_tiles = (kv_end + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    bar_init(qbar, 1);
    for (int s = 0; s < kStages; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], kConsumers * 4);  // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // Producer: one thread loads the query tile once, then keeps the ring
    // of key tiles full.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == kConsumers * 128 && n_tiles > 0) {
      bar_expect_tx(qbar, 2 * kBoxes * S::kQBox);
      for (int x = 0; x < kBoxes; ++x) {
        tma_load(sQ + x * S::kQBox, &map_q, qbar, x * G::kCols, blk.h, q0, blk.b);
        tma_load(sdO + x * S::kQBox, &map_do, qbar, x * G::kCols, blk.h, q0,
                 blk.b);
      }
      int s = 0;
      uint32_t phase = 0;
      for (int j = 0; j < n_tiles; ++j) {
        bar_wait(&empty[s], phase ^ 1);
        bar_expect_tx(&full[s], S::kStageBytes);
        uint8_t* sk = stages + s * S::kStageBytes;
        uint8_t* sv = sk + kBoxes * S::kKBox;
        for (int x = 0; x < kBoxes; ++x) {
          tma_load(sk + x * S::kKBox, &map_k, &full[s], x * G::kCols, blk.h,
                   j * kBK, blk.b);
          tma_load(sv + x * S::kKBox, &map_v, &full[s], x * G::kCols, blk.h,
                   j * kBK, blk.b);
        }
        if (++s == kStages) {
          s = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int lane = threadIdx.x & 31;
    const int warp = (threadIdx.x / 32) & 3;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int wrow0 = q0 + wg * 64;   // the warpgroup's 64 rows
    const int row0 = wrow0 + warp * 16;  // the warp's 16
    const long long stat0 = (static_cast<long long>(blk.b) * p.n_heads + blk.h) * p.sq;

    // delta of the warp's rows: two lanes a row, half a row each, from the
    // cotangent as given; lane 2r holds row r's sum after the exchange. The
    // operands are loaded here and summed once the query tile has arrived.
    constexpr bool kPrefetch = D <= 128;  // else summed after the wait
    const int drow = row0 + lane / 2;
    DeltaHalfRow<kPrefetch ? D : 16> dl_in;
    if (kPrefetch && drow < p.sq) dl_in.load(p, blk.b, blk.h, drow, lane & 1);
    // Rows g and g + 8 of the warp's 16: their statistics stay in registers.
    // A row without keys (lse = -inf) or past Sq gets +inf for lse, so its
    // exp2 is 0 without a test.
    float delta[2], lse2[2], glse[2];
    int qpos[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + g + 8 * r;
      qpos[r] = p.q_offset + row;
      lse2[r] = INFINITY;
      glse[r] = 0.f;
      if (row < p.sq) {
        const float l = p.lse[stat0 + row];
        if (l != -INFINITY) lse2[r] = l * kLog2e;
        if (p.glse != nullptr) glse[r] = p.glse[stat0 + row];
      }
    }

    float dq[kBoxes][kN];
#pragma unroll
    for (int x = 0; x < kBoxes; ++x) {
#pragma unroll
      for (int i = 0; i < kN; ++i) dq[x][i] = 0.f;
    }
    float sacc[kBK / 2], dp[kBK / 2];
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i) sacc[i] = dp[i] = 0.f;
    uint32_t ds_a[kBK / 16][4];
    uint32_t q_a[kAS][4], do_a[kAS][4];
    const uint8_t* qa = sQ + wg * 64 * G::kRB;
    const uint8_t* doa = sdO + wg * 64 * G::kRB;

    if (n_tiles > 0) bar_wait(qbar, 0);
    {
      float dsum = 0.f;
      if (drow < p.sq) {
        dsum = kPrefetch ? dl_in.dot(p.given_f32)
                         : delta_half<D>(p, blk.b, blk.h, drow, lane & 1);
      }
      dsum += __shfl_xor_sync(0xffffffffu, dsum, 1);
      if (!(lane & 1) && drow < p.sq) p.delta[stat0 + drow] = dsum;
      delta[0] = __shfl_sync(0xffffffffu, dsum, 2 * g);
      delta[1] = __shfl_sync(0xffffffffu, dsum, 2 * g + 16);
    }
    // The tile loop is pipelined: tile j + 1's S and dP are issued while
    // tile j's dQ product runs, and a stage is released once the wait for
    // the next tile's S has also seen its dQ product finish.
    if (n_tiles > 0) {
      if constexpr (kRegA) {
        load_a(q_a, sQ, S::kQBox, wg * 64 + warp * 16, lane);
        load_a(do_a, sdO, S::kQBox, wg * 64 + warp * 16, lane);
      }
      bar_wait(&full[0], 0);
      issue_s_dp<D, kRegA>(sacc, dp, q_a, do_a, qa, doa, S::kQBox, stages,
                           stages + kBoxes * S::kKBox, S::kKBox);
      int s = 0;
      uint32_t phase = 0;
      for (int j = 0; j < n_tiles; ++j) {
        const int k0 = j * kBK;
        const uint8_t* sk = stages + s * S::kStageBytes;

        // P = exp(S * scale - lse) under the forward's mask, which a tile
        // wholly inside it (every key valid for every row) skips.
        wgmma_wait<1>();
        fence_regs(sacc);
        fence_regs(ds_a);
#pragma unroll
        for (int x = 0; x < kBoxes; ++x) fence_regs(dq[x]);
        if (j > 0) {
          __syncwarp();
          if (lane == 0) bar_arrive(&empty[s == 0 ? kStages - 1 : s - 1]);
        }
        const bool inside =
            k0 + kBK <= p.kv_len &&
            (!p.causal || p.q_offset + wrow0 >= p.kv_offset + k0 + kBK - 1);
        if (inside) {
#pragma unroll
          for (int i = 0; i < kBK / 2; ++i) {
            sacc[i] = ex2(sacc[i] * p.scale_log2 - lse2[(i >> 1) & 1]);
          }
        } else {
          const int kv_len = p.kv_len;
          const bool causal = p.causal;
#pragma unroll
          for (int n = 0; n < kBK / 8; ++n) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int r = e >> 1;
              const int col = k0 + n * 8 + t * 2 + (e & 1);
              const bool ok = (col < kv_len) & (!causal | (qpos[r] - p.kv_offset >= col));
              sacc[4 * n + e] =
                  ok ? ex2(sacc[4 * n + e] * p.scale_log2 - lse2[r]) : 0.f;
            }
          }
        }

        // dS = P (dP - delta) + g_lse P, rounded to bf16 as dQ's A operand.
        wgmma_wait<0>();
        fence_regs(dp);
#pragma unroll
        for (int i = 0; i < kBK / 2; ++i) {
          const int r = (i >> 1) & 1;
          dp[i] = sacc[i] * (dp[i] - delta[r]) + glse[r] * sacc[i];
        }
        pack_a<kBK / 16>(ds_a, dp);

        // dQ += dS K, K read MN-major, one box at a time.
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {
#pragma unroll
          for (int x = 0; x < kBoxes; ++x) {
            wgmma_rs<true>(dq[x], ds_a[kk],
                           gdesc_mn<D>(sk + x * S::kKBox + kk * 16 * G::kRB), 1);
          }
        }
        wgmma_commit();
        if (j + 1 == n_tiles) break;
        if (++s == kStages) {
          s = 0;
          phase ^= 1;
        }
        bar_wait(&full[s], phase);
        const uint8_t* nk = stages + s * S::kStageBytes;
        issue_s_dp<D, kRegA>(sacc, dp, q_a, do_a, qa, doa, S::kQBox, nk,
                             nk + kBoxes * S::kKBox, S::kKBox);
      }
      wgmma_wait<0>();
    }
#pragma unroll
    for (int x = 0; x < kBoxes; ++x) fence_regs(dq[x]);
    fence_regs(ds_a);

    // Columns below d only: d is a multiple of 8, so a column pair is
    // wholly in or out.
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + g + 8 * r;
      if (row >= p.sq) continue;
      __nv_bfloat16* dqr = p.dq + blk.b * p.dq_sb + blk.h * p.dq_sh +
                           static_cast<long long>(row) * p.dq_ss;
#pragma unroll
      for (int x = 0; x < kBoxes; ++x) {
#pragma unroll
        for (int n = 0; n < G::kCols / 8; ++n) {
          const int col = x * G::kCols + n * 8 + t * 2;
          if (col < p.d) {
            *reinterpret_cast<uint32_t*>(dqr + col) =
                pack_bf16x2(dq[x][4 * n + 2 * r] * p.scale,
                            dq[x][4 * n + 2 * r + 1] * p.scale);
          }
        }
      }
    }
  }
}

// At d_pad 256 a block owns 64 keys and its two warpgroups split the head
// dim, two boxes of dK and dV each (two 64 x 256 fp32 accumulators would be
// 256 registers a thread); each computes S^T and dP^T in full. Elsewhere a
// block owns 128 keys, 64 a warpgroup.
template <int D, int BQ>
struct DkdvSmem {
  using G = Geo<D>;
  static constexpr bool kSplit = D == 256;
  static constexpr int kKeys = kSplit ? 64 : kRows;  // keys a block
  static constexpr int kKBox = kKeys * G::kRB;  // a box of the key tile
  static constexpr int kQBox = BQ * G::kRB;     // a box of a query tile
  static constexpr int kStageBytes = 2 * G::kBoxes * kQBox;  // Q and dO
  static constexpr int kStatBytes = 3 * BQ * 4;               // lse, delta, g_lse
  static constexpr int kBytes = 2 * G::kBoxes * kKBox + kStages * kStageBytes +
                                kStages * kStatBytes + (1 + 2 * kStages) * 8 +
                                1024;
};

// S^T = K Q^T and dP^T = V dO^T for the warpgroup's 64 keys against one
// query tile (sq, sdo), each its own commit group. At d_pad 64 the A
// operands K and V are held in registers (ka_r, va_r); elsewhere they are
// read from shared memory (ka, va).
template <int D, bool kRegA, int KS, int N>
__device__ __forceinline__ void issue_st_dpt(float (&st)[N], float (&dpt)[N],
                                             const uint32_t (&ka_r)[KS][4],
                                             const uint32_t (&va_r)[KS][4],
                                             const uint8_t* ka, const uint8_t* va,
                                             int kbox, const uint8_t* sq,
                                             const uint8_t* sdo, int qbox) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint64_t db = gdesc_k<D>(sq + kstep<D>(kk, qbox));
    if constexpr (kRegA) {
      wgmma_rs<false>(st, ka_r[kk], db, kk > 0);
    } else {
      wgmma_ss(st, gdesc_k<D>(ka + kstep<D>(kk, kbox)), db, kk > 0);
    }
  }
  wgmma_commit();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint64_t db = gdesc_k<D>(sdo + kstep<D>(kk, qbox));
    if constexpr (kRegA) {
      wgmma_rs<false>(dpt, va_r[kk], db, kk > 0);
    } else {
      wgmma_ss(dpt, gdesc_k<D>(va + kstep<D>(kk, kbox)), db, kk > 0);
    }
  }
  wgmma_commit();
}

template <int D, int BQ>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_sm90_dkdv_kernel(const Params p,
                               const __grid_constant__ CUtensorMap map_q,
                               const __grid_constant__ CUtensorMap map_do,
                               const __grid_constant__ CUtensorMap map_k,
                               const __grid_constant__ CUtensorMap map_v) {
  using G = Geo<D>;
  using S = DkdvSmem<D, BQ>;
  constexpr int kBoxes = G::kBoxes;
  constexpr int kOwn = S::kSplit ? kBoxes / 2 : kBoxes;  // boxes a warpgroup
  constexpr int kN = G::kCols / 2;  // accumulator floats a box
  constexpr bool kRegA = D == 64;
  constexpr int kAS = kRegA ? D / 16 : 1;  // register A k-steps
  static_assert(!kRegA || BQ == 64, "register A is written for n64 products");
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* sK = align1024(smem_raw);
  uint8_t* sV = sK + kBoxes * S::kKBox;
  uint8_t* stages = sV + kBoxes * S::kKBox;
  float* stats = reinterpret_cast<float*>(stages + kStages * S::kStageBytes);
  uint64_t* kvbar = reinterpret_cast<uint64_t*>(stats + kStages * 3 * BQ);
  uint64_t* full = kvbar + 1;
  uint64_t* empty = full + kStages;

  const Block blk = block_of(p, false);
  const int k0 = blk.tile * S::kKeys;
  // Query tiles that can see some key of this block: none past kv_len; with
  // the causal mask, none wholly before the block's first key.
  int qt_begin = 0, qt_end = 0;
  if (k0 < p.kv_len) {
    qt_end = (p.sq + BQ - 1) / BQ;
    if (p.causal) {
      const int first = p.kv_offset + k0 - p.q_offset;
      if (first > 0) qt_begin = min(first / BQ, qt_end);
    }
  }

  if (threadIdx.x == 0) {
    bar_init(kvbar, 1);
    for (int s = 0; s < kStages; ++s) {
      bar_init(&full[s], 32);               // the producer warp's lanes
      bar_init(&empty[s], kConsumers * 4);  // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  const long long stat0 = (static_cast<long long>(blk.b) * p.n_heads + blk.h) * p.sq;
  if (wg == kConsumers) {
    // Producer warp: lane 0 loads K and V once, then each query tile's Q
    // and dO; the 32 lanes stage the tile's row statistics beside them. A
    // row without keys (lse = -inf) or past Sq gets +inf for lse, so its
    // exp2 is 0 without a test.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x < kConsumers * 128 + 32 && qt_end > qt_begin) {
      const int lane = threadIdx.x & 31;
      if (lane == 0) {
        bar_expect_tx(kvbar, 2 * kBoxes * S::kKBox);
        for (int x = 0; x < kBoxes; ++x) {
          tma_load(sK + x * S::kKBox, &map_k, kvbar, x * G::kCols, blk.h, k0,
                   blk.b);
          tma_load(sV + x * S::kKBox, &map_v, kvbar, x * G::kCols, blk.h, k0,
                   blk.b);
        }
      }
      // Each lane holds rows lane and lane + 32 of the next tile's
      // statistics, loaded before the wait for its stage.
      constexpr int kPer = (BQ + 31) / 32;
      float l[kPer], dl[kPer], gl[kPer];
      auto load_stats = [&](int q0) {
#pragma unroll
        for (int u = 0; u < kPer; ++u) {
          const int row = q0 + lane + 32 * u;
          l[u] = INFINITY;
          dl[u] = gl[u] = 0.f;
          if (lane + 32 * u < BQ && row < p.sq) {
            const float lse = p.lse[stat0 + row];
            if (lse != -INFINITY) l[u] = lse * kLog2e;
            dl[u] = p.delta[stat0 + row];
            if (p.glse != nullptr) gl[u] = p.glse[stat0 + row];
          }
        }
      };
      load_stats(qt_begin * BQ);
      int s = 0;
      uint32_t phase = 0;
      for (int qt = qt_begin; qt < qt_end; ++qt) {
        const int q0 = qt * BQ;
        bar_wait(&empty[s], phase ^ 1);
        float* st = stats + s * 3 * BQ;
#pragma unroll
        for (int u = 0; u < kPer; ++u) {
          if (lane + 32 * u < BQ) {
            st[lane + 32 * u] = l[u];
            st[BQ + lane + 32 * u] = dl[u];
            st[2 * BQ + lane + 32 * u] = gl[u];
          }
        }
        if (lane == 0) {
          bar_expect_tx(&full[s], S::kStageBytes);
          uint8_t* sq = stages + s * S::kStageBytes;
          uint8_t* sdo = sq + kBoxes * S::kQBox;
          for (int x = 0; x < kBoxes; ++x) {
            tma_load(sq + x * S::kQBox, &map_q, &full[s], x * G::kCols, blk.h,
                     q0, blk.b);
            tma_load(sdo + x * S::kQBox, &map_do, &full[s], x * G::kCols, blk.h,
                     q0, blk.b);
          }
        } else {
          bar_arrive(&full[s]);
        }
        if (qt + 1 < qt_end) load_stats(q0 + BQ);
        if (++s == kStages) {
          s = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int lane = threadIdx.x & 31;
    const int warp = (threadIdx.x / 32) & 3;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int wrow = S::kSplit ? 0 : wg * 64;  // the warpgroup's first key
    const int xo = S::kSplit ? wg * kOwn : 0;  // and first box of dK, dV
    const int wkey0 = k0 + wrow;        // the warpgroup's 64 keys
    const int key0 = wkey0 + warp * 16;  // the warp's 16
    const int key[2] = {key0 + g, key0 + g + 8};

    float dk[kOwn][kN], dv[kOwn][kN];
#pragma unroll
    for (int x = 0; x < kOwn; ++x) {
#pragma unroll
      for (int i = 0; i < kN; ++i) dk[x][i] = dv[x][i] = 0.f;
    }
    float st[BQ / 2], dpt[BQ / 2];
#pragma unroll
    for (int i = 0; i < BQ / 2; ++i) st[i] = dpt[i] = 0.f;
    uint32_t p_a[BQ / 16][4], ds_a[BQ / 16][4];
    uint32_t k_a[kAS][4], v_a[kAS][4];
    const uint8_t* ka = sK + wrow * G::kRB;
    const uint8_t* va = sV + wrow * G::kRB;

    // Each tile is one elementwise phase (P^T and dS^T from the S^T and
    // dP^T the previous phase issued) and one issue phase (dV and dK of
    // this tile, S^T and dP^T of the next); the warpgroups take turns at
    // issuing. A stage is released once the products reading it are done.
    if (qt_end > qt_begin) {
      bar_wait(kvbar, 0);
      if constexpr (kRegA) {
        load_a(k_a, sK, S::kKBox, wrow + warp * 16, lane);
        load_a(v_a, sV, S::kKBox, wrow + warp * 16, lane);
      }
      if (wg == 1) turn_pass(wg);  // warpgroup 0 issues first
      bar_wait(&full[0], 0);
      turn_wait(wg);
      issue_st_dpt<D, kRegA>(st, dpt, k_a, v_a, ka, va, S::kKBox, stages,
                             stages + kBoxes * S::kQBox, S::kQBox);
      turn_pass(wg);
      int s = 0;
      uint32_t phase = 0;
      for (int qt = qt_begin; qt < qt_end; ++qt) {
        const int q0 = qt * BQ;
        const uint8_t* sq = stages + s * S::kStageBytes;
        const uint8_t* sdo = sq + kBoxes * S::kQBox;
        const float* sLse = stats + s * 3 * BQ;  // lse * log2(e)
        const float* sDelta = sLse + BQ;
        const float* sGlse = sDelta + BQ;

        wgmma_wait<0>();
        fence_regs(st);
        fence_regs(dpt);
        fence_regs(p_a);
        fence_regs(ds_a);
#pragma unroll
        for (int x = 0; x < kOwn; ++x) {
          fence_regs(dk[x]);
          fence_regs(dv[x]);
        }
        if (qt > qt_begin) {
          __syncwarp();
          if (lane == 0) bar_arrive(&empty[s == 0 ? kStages - 1 : s - 1]);
        }

        // P^T = exp(S^T * scale - lse) under the forward's mask, which a
        // tile wholly inside it (every key valid for every query) skips;
        // rounded to bf16 as dV's A operand.
        const bool inside = wkey0 + 64 <= p.kv_len &&
                            (!p.causal || p.q_offset + q0 >= p.kv_offset + wkey0 + 63);
        if (inside) {
#pragma unroll
          for (int n = 0; n < BQ / 8; ++n) {
            const float2 l2 = *reinterpret_cast<const float2*>(sLse + n * 8 + t * 2);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              st[4 * n + e] = ex2(st[4 * n + e] * p.scale_log2 - ((e & 1) ? l2.y : l2.x));
            }
          }
        } else {
          // Query column c sees key j when qk + c >= j (or without the
          // causal mask); keys at or past kv_len see nothing.
          const int qk = p.q_offset + q0 - p.kv_offset;
          const bool causal = p.causal;
          const bool key_ok[2] = {key[0] < p.kv_len, key[1] < p.kv_len};
#pragma unroll
          for (int n = 0; n < BQ / 8; ++n) {
            const float2 l2 = *reinterpret_cast<const float2*>(sLse + n * 8 + t * 2);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int col = n * 8 + t * 2 + (e & 1);
              const bool ok = key_ok[e >> 1] & (!causal | (qk + col >= key[e >> 1]));
              const float x = ex2(st[4 * n + e] * p.scale_log2 - ((e & 1) ? l2.y : l2.x));
              st[4 * n + e] = ok ? x : 0.f;
            }
          }
        }
        pack_a<BQ / 16>(p_a, st);

        // dS^T = P^T (dP^T - delta) + g_lse P^T, in place of dP^T, rounded
        // to bf16 as dK's A operand.
#pragma unroll
        for (int n = 0; n < BQ / 8; ++n) {
          const float2 dl = *reinterpret_cast<const float2*>(sDelta + n * 8 + t * 2);
          const float2 gl = *reinterpret_cast<const float2*>(sGlse + n * 8 + t * 2);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 4 * n + e;
            const float d_ = (e & 1) ? dl.y : dl.x;
            const float g_ = (e & 1) ? gl.y : gl.x;
            dpt[i] = st[i] * (dpt[i] - d_) + g_ * st[i];
          }
        }
        pack_a<BQ / 16>(ds_a, dpt);

        // dV += P^T dO and dK += dS^T Q (dO and Q read MN-major, one box at
        // a time), then the next tile's S^T and dP^T.
        const bool last = qt + 1 == qt_end;
        const uint8_t* nq = sq;
        if (!last) {
          if (++s == kStages) {
            s = 0;
            phase ^= 1;
          }
          bar_wait(&full[s], phase);
          nq = stages + s * S::kStageBytes;
        }
        turn_wait(wg);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk) {
#pragma unroll
          for (int x = 0; x < kOwn; ++x) {
            wgmma_rs<true>(dv[x], p_a[kk],
                           gdesc_mn<D>(sdo + (xo + x) * S::kQBox +
                                       kk * 16 * G::kRB), 1);
          }
        }
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk) {
#pragma unroll
          for (int x = 0; x < kOwn; ++x) {
            wgmma_rs<true>(dk[x], ds_a[kk],
                           gdesc_mn<D>(sq + (xo + x) * S::kQBox +
                                       kk * 16 * G::kRB), 1);
          }
        }
        wgmma_commit();
        if (!last) {
          issue_st_dpt<D, kRegA>(st, dpt, k_a, v_a, ka, va, S::kKBox, nq,
                                 nq + kBoxes * S::kQBox, S::kQBox);
        }
        turn_pass(wg);
      }
      wgmma_wait<0>();
      if (wg == 0) turn_wait(wg);  // the other's last pass
    }
#pragma unroll
    for (int x = 0; x < kOwn; ++x) {
      fence_regs(dk[x]);
      fence_regs(dv[x]);
    }
    fence_regs(p_a);
    fence_regs(ds_a);

    // Every key below skv gets its row, zero where no query saw it; columns
    // below d only.
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (key[r] >= p.skv) continue;
      const long long kr = key[r];
      __nv_bfloat16* dkr = p.dk + blk.b * p.dk_sb + blk.h * p.dk_sh + kr * p.dk_ss;
      __nv_bfloat16* dvr = p.dv + blk.b * p.dv_sb + blk.h * p.dv_sh + kr * p.dv_ss;
#pragma unroll
      for (int x = 0; x < kOwn; ++x) {
#pragma unroll
        for (int n = 0; n < G::kCols / 8; ++n) {
          const int col = (xo + x) * G::kCols + n * 8 + t * 2;
          if (col < p.d) {
            *reinterpret_cast<uint32_t*>(dkr + col) =
                pack_bf16x2(dk[x][4 * n + 2 * r] * p.scale,
                            dk[x][4 * n + 2 * r + 1] * p.scale);
            *reinterpret_cast<uint32_t*>(dvr + col) =
                pack_bf16x2(dv[x][4 * n + 2 * r], dv[x][4 * n + 2 * r + 1]);
          }
        }
      }
    }
  }
}

template <int D>
cudaError_t launch_dq(const Params& p, const CUtensorMap* maps,
                      cudaStream_t stream) {
  static std::atomic<uint64_t> done{0};
  constexpr int kSmem = DqSmem<D>::kBytes;
  const cudaError_t err = opt_in(flash_bwd_sm90_dq_kernel<D>, kSmem, done);
  if (err != cudaSuccess) return err;
  const unsigned blocks = static_cast<unsigned>(p.row_tiles) * p.batch * p.n_heads;
  flash_bwd_sm90_dq_kernel<D><<<blocks, kThreads, kSmem, stream>>>(
      p, maps[0], maps[1], maps[2], maps[3]);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkdv(const Params& p, const CUtensorMap* maps,
                        cudaStream_t stream) {
  constexpr int BQ = D >= 128 ? 32 : 64;
  static std::atomic<uint64_t> done{0};
  constexpr int kSmem = DkdvSmem<D, BQ>::kBytes;
  const cudaError_t err = opt_in(flash_bwd_sm90_dkdv_kernel<D, BQ>, kSmem, done);
  if (err != cudaSuccess) return err;
  const unsigned blocks = static_cast<unsigned>(p.row_tiles) * p.batch * p.n_heads;
  flash_bwd_sm90_dkdv_kernel<D, BQ><<<blocks, kThreads, kSmem, stream>>>(
      p, maps[0], maps[1], maps[2], maps[3]);
  return cudaGetLastError();
}

// Strides: 27 in elements, (batch, seq, head) of q, k, v, dO (the operand
// of the products), dq, dk, dv, out, and the cotangent as given.
Params make_params(const void* out, const void* dout_given, int given_f32,
                   const void* lse, const void* glse, void* delta, void* dq,
                   void* dk, void* dv, int batch, int n_heads, int sq, int skv,
                   int d, const long long* st, int kv_len, int q_offset,
                   int kv_offset, float sm_scale, int causal) {
  Params p;
  p.out = static_cast<const __nv_bfloat16*>(out);
  p.dout_given = dout_given;
  p.lse = static_cast<const float*>(lse);
  p.glse = static_cast<const float*>(glse);
  p.delta = static_cast<float*>(delta);
  p.dq = static_cast<__nv_bfloat16*>(dq);
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  p.dq_sb = st[12]; p.dq_ss = st[13]; p.dq_sh = st[14];
  p.dk_sb = st[15]; p.dk_ss = st[16]; p.dk_sh = st[17];
  p.dv_sb = st[18]; p.dv_ss = st[19]; p.dv_sh = st[20];
  p.o_sb = st[21]; p.o_ss = st[22]; p.o_sh = st[23];
  p.g_sb = st[24]; p.g_ss = st[25]; p.g_sh = st[26];
  p.batch = batch;
  p.n_heads = n_heads;
  p.sq = sq;
  p.skv = skv;
  p.d = d;
  p.kv_len = kv_len;
  p.q_offset = q_offset;
  p.kv_offset = kv_offset;
  p.causal = causal;
  p.given_f32 = given_f32;
  p.row_tiles = 0;
  p.scale = sm_scale;
  p.scale_log2 = sm_scale * kLog2e;
  return p;
}

// A strided bf16 [B, S, H, D] view as a 4-D map over (D, H, S, B) whose D
// extent is d itself (TMA zero-fills columns d..d_pad), in boxes of `cols`
// columns (16, 32 or 64: a 32-, 64- or 128-byte row under the swizzle of
// that width) x `rows` rows; rows past S read zeros.
bool make_map_g(CUtensorMap* map, const void* base, int batch, int seq,
                int heads, int d, const long long* st, int rows, int cols) {
  const PFN_cuTensorMapEncodeTiled_v12000 encode = encode_fn();
  if (!encode) return false;
  cuuint64_t dims[4] = {static_cast<cuuint64_t>(d),
                        static_cast<cuuint64_t>(heads),
                        static_cast<cuuint64_t>(seq),
                        static_cast<cuuint64_t>(batch)};
  cuuint64_t strides[3] = {static_cast<cuuint64_t>(st[2] * 2),
                           static_cast<cuuint64_t>(st[1] * 2),
                           static_cast<cuuint64_t>(st[0] * 2)};
  cuuint32_t box[4] = {static_cast<cuuint32_t>(cols), 1,
                       static_cast<cuuint32_t>(rows), 1};
  cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      cols == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                 : (cols == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                               : CU_TENSOR_MAP_SWIZZLE_32B);
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// q, dO (query rows of `q_rows`) and k, v (key rows of `k_rows`) maps.
bool make_maps(CUtensorMap (&maps)[4], const void* q, const void* k,
               const void* v, const void* dout, int batch, int n_heads, int sq,
               int skv, int d, int d_pad, const long long* st, int q_rows,
               int k_rows) {
  const int cols = d_pad < 64 ? d_pad : 64;
  return make_map_g(&maps[0], q, batch, sq, n_heads, d, st + 0, q_rows, cols) &&
         make_map_g(&maps[1], dout, batch, sq, n_heads, d, st + 9, q_rows, cols) &&
         make_map_g(&maps[2], k, batch, skv, n_heads, d, st + 3, k_rows, cols) &&
         make_map_g(&maps[3], v, batch, skv, n_heads, d, st + 6, k_rows, cols);
}

namespace tf32 {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBM = 16 * kWarps;  // rows a block owns, 16 a warp

// Stride slots of Args::st, the order of the C entries' strides.
enum Slot { kSlotQ, kSlotK, kSlotV, kSlotDO, kSlotDQ, kSlotDK, kSlotDV,
            kSlotOut, kSlotGiven, kNumSlots };

struct Args {
  const float* q;
  const float* k;
  const float* v;
  const float* dout;   // dO (fp32)
  const float* out;    // the forward's output (dQ kernel: delta)
  const void* given;   // dO as given, bf16 or fp32 (dQ kernel: delta)
  float* dq;
  float* dk;
  float* dv;
  const float* lse;    // [B, H, Sq]
  const float* glse;   // [B, H, Sq] or null (zeros)
  float* delta;        // [B, H, Sq]
  long long st[kNumSlots][3];
  int batch, heads, sq, skv, d, kv_len, q_offset, kv_offset, causal, given_f32;
  int row_tiles;
  float scale;
};

// Shared-memory row stride in floats (16 bytes of padding: LD / 4 odd, so
// the fragment loads below hit 32 distinct banks), key rows a dQ tile,
// query rows a dK/dV tile, and the blocks an SM is to hold (the register
// cap: 4 blocks at d_pad 16, 3 at 32 and 64). From d_pad 64 on the
// streamed tiles are 32 rows, so three blocks fit an SM's shared memory
// (measured 3-8% faster there, and slower at 16).
template <int D>
struct Tile {
  static_assert(D == 16 || D == 32 || D == 64 || D == 128, "fp32 d_pad");
  static constexpr int kLd = D + 4;
  static constexpr int kKeys = D >= 64 ? 32 : 64;
  static constexpr int kQueries = D >= 64 ? 32 : 64;
  static constexpr int kMinBlocks = D == 16 ? 4 : (D == 128 ? 1 : 3);
};

__device__ __forceinline__ void cp16(void* dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(in ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [r0, r0 + R) of one (batch, head) into shared memory (row stride
// kLd), asynchronously: D columns, zero at or past d and in rows at or past
// n. src and its row stride rs are 16-byte aligned, d a multiple of 4.
template <int R, int D>
__device__ __forceinline__ void load_async(float* dst, const float* src,
                                           long long rs, int r0, int n, int d) {
  constexpr int kC = D / 4;  // 16-byte chunks a row
  for (int i = threadIdx.x; i < R * kC; i += kThreads) {
    const int r = i / kC, c = (i % kC) * 4;
    const bool in = r0 + r < n && c < d;
    cp16(dst + r * Tile<D>::kLd + c,
         in ? src + static_cast<long long>(r0 + r) * rs + c : src, in);
  }
}

// x rounded to tf32 as cvt.rna.tf32.f32 rounds it: to nearest on the 13
// dropped mantissa bits, ties away from zero; the tensor cores read the 19
// bits kept.
__device__ __forceinline__ uint32_t rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = rna(x);
  lo = rna(x - __uint_as_float(hi));
}

// Not volatile: a product has no effect but its outputs, so the compiler
// may interleave independent ones.
__device__ __forceinline__ void mma_1688(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c[n0 + j] += A B_j over NB n-tiles as 3xTF32: the small terms first,
// then hi hi. The three products of one n-tile accumulate in that order;
// the n-tiles are independent, so each pass issues NB products back to
// back (one n-tile's three in a row would each wait for the last).
template <int N, int NB>
__device__ __forceinline__ void mma3(float (&c)[N][4], int n0,
                                     const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4],
                                     const uint32_t (&bh)[NB][2],
                                     const uint32_t (&bl)[NB][2]) {
#pragma unroll
  for (int j = 0; j < NB; ++j) mma_1688(c[n0 + j], al, bh[j]);
#pragma unroll
  for (int j = 0; j < NB; ++j) mma_1688(c[n0 + j], ah, bl[j]);
#pragma unroll
  for (int j = 0; j < NB; ++j) mma_1688(c[n0 + j], ah, bh[j]);
}

// NT: c[16 x 8N] += A[16 x K] B[8N x K]^T, both row-major in shared memory
// (row stride LD), a at the warp's first row. Fragments of m16n8k8: a
// thread reads A rows g and g + 8 at columns t and t + 4, B row 8j + g at
// the same columns.
template <int N, int K, int LD>
__device__ __forceinline__ void product_nt(float (&c)[N][4], const float* a,
                                           const float* b, int g, int t) {
#pragma unroll 2
  for (int kk = 0; kk < K; kk += 8) {
    const float* ap = a + g * LD + kk + t;
    uint32_t ah[4], al[4];
    split(ap[0], ah[0], al[0]);
    split(ap[8 * LD], ah[1], al[1]);
    split(ap[4], ah[2], al[2]);
    split(ap[8 * LD + 4], ah[3], al[3]);
    uint32_t bh[N][2], bl[N][2];
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const float* bp = b + (8 * j + g) * LD + kk + t;
      split(bp[0], bh[j][0], bl[j][0]);
      split(bp[4], bh[j][1], bl[j][1]);
    }
    mma3(c, 0, ah, al, bh, bl);
  }
}

// PN: c[16 x 8N] += P[16 x 8M] B[8M x 8N], P in C-fragment registers (a
// thread holds rows g, g + 8 at columns 8m + 2t, 8m + 2t + 1), B row-major
// in shared memory. Inside each 8-column block the contraction index is
// permuted: logical k = t is column 2t and t + 4 is 2t + 1, so P's C
// fragment is its A fragment, and B's rows are read in that order.
template <int M, int N, int LD>
__device__ __forceinline__ void product_pn(float (&c)[N][4],
                                           const float (&p)[M][4],
                                           const float* b, int g, int t) {
#pragma unroll
  for (int m = 0; m < M; ++m) {
    uint32_t ah[4], al[4];
    split(p[m][0], ah[0], al[0]);
    split(p[m][2], ah[1], al[1]);
    split(p[m][1], ah[2], al[2]);
    split(p[m][3], ah[3], al[3]);
    const float* bp = b + (8 * m + 2 * t) * LD + g;
    // At most 8 n-tiles a pass: their split B fragments stay in registers.
    constexpr int kPass = N < 8 ? N : 8;
#pragma unroll
    for (int n0 = 0; n0 < N; n0 += kPass) {
      uint32_t bh[kPass][2], bl[kPass][2];
#pragma unroll
      for (int n = 0; n < kPass; ++n) {
        split(bp[8 * (n0 + n)], bh[n][0], bl[n][0]);
        split(bp[LD + 8 * (n0 + n)], bh[n][1], bl[n][1]);
      }
      mma3(c, n0, ah, al, bh, bl);
    }
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&c)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
}

__device__ __forceinline__ const float* head(const float* p, const Args& a,
                                             int slot, int b, int h) {
  return p + b * a.st[slot][0] + h * a.st[slot][2];
}

// The 16-row x D accumulator c of this warp (rows row0 + g, + 8) times
// `mul`, stored at columns below d and rows below n.
template <int D>
__device__ __forceinline__ void store_rows(float* base, const Args& a,
                                           int slot, int b, int h, int row0,
                                           int n, const float (&c)[D / 8][4],
                                           float mul, int g, int t) {
  float* ob = base + b * a.st[slot][0] + h * a.st[slot][2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= n) continue;
    float* orow = ob + static_cast<long long>(row) * a.st[slot][1];
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = 8 * j + 2 * t;
      if (col < a.d) {  // d is a multiple of 4: a column pair is in or out
        *reinterpret_cast<float2*>(orow + col) =
            make_float2(c[j][2 * r] * mul, c[j][2 * r + 1] * mul);
      }
    }
  }
}

// The (tile, batch, head) of this block: tile index slowest; `last_first`
// runs the tiles from the last (the dQ kernel's heaviest causal tiles).
__device__ __forceinline__ void block_tile(const Args& a, bool last_first,
                                           int* tile, int* b, int* h) {
  const int bh = a.batch * a.heads;
  const int i = blockIdx.x / bh;
  const int r = blockIdx.x - i * bh;
  *tile = last_first ? a.row_tiles - 1 - i : i;
  *b = r / a.heads;
  *h = r - *b * a.heads;
}

template <int D>
struct DqSmem {
  static constexpr int kBytes =
      (2 * kBM + 2 * 2 * Tile<D>::kKeys) * Tile<D>::kLd * 4;
};

template <int D>
__global__ void __launch_bounds__(kThreads, Tile<D>::kMinBlocks)
    flash_bwd_sm90_dq_kernel(const Args a) {
  constexpr int LD = Tile<D>::kLd, BK = Tile<D>::kKeys;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);
  float* sO = sQ + kBM * LD;  // dO
  float* sKV = sO + kBM * LD;  // two stages of K and V tiles
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  int tile, b, h;
  block_tile(a, true, &tile, &b, &h);
  const int q0 = tile * kBM;
  const float* kb = head(a.k, a, kSlotK, b, h);
  const float* vb = head(a.v, a, kSlotV, b, h);
  // Keys [0, end) that some query row of the block may attend to.
  int end = a.kv_len;
  if (a.causal) {
    const int q_last = a.q_offset + min(q0 + kBM, a.sq) - 1;
    end = min(end, max(q_last - a.kv_offset + 1, 0));
  }
  const int n_tiles = (end + BK - 1) / BK;
  load_async<kBM, D>(sQ, head(a.q, a, kSlotQ, b, h), a.st[kSlotQ][1], q0, a.sq,
                     a.d);
  load_async<kBM, D>(sO, head(a.dout, a, kSlotDO, b, h), a.st[kSlotDO][1], q0,
                     a.sq, a.d);
  if (n_tiles > 0) {
    load_async<BK, D>(sKV, kb, a.st[kSlotK][1], 0, a.skv, a.d);
    load_async<BK, D>(sKV + BK * LD, vb, a.st[kSlotV][1], 0, a.skv, a.d);
  }
  cp_commit();

  const int row0 = q0 + 16 * warp;
  const long long row_base = (static_cast<long long>(b) * a.heads + h) * a.sq;
  // delta = rowsum(dO o out) for the warp's 16 rows, from the cotangent as
  // given, while the tiles load; one warp sum a row, in a fixed order.
  float dl[2] = {0.f, 0.f};
  {
    const float* ob = head(a.out, a, kSlotOut, b, h);
    const char* gb = static_cast<const char*>(a.given) +
                     (b * a.st[kSlotGiven][0] + h * a.st[kSlotGiven][2]) *
                         (a.given_f32 ? 4 : 2);
    for (int i = 0; i < 16; ++i) {
      const int row = row0 + i;
      float acc = 0.f;
      if (row < a.sq) {
        const long long go = static_cast<long long>(row) * a.st[kSlotGiven][1];
        const float* orow = ob + static_cast<long long>(row) * a.st[kSlotOut][1];
        for (int c = lane; c < a.d; c += 32) {
          const float gv =
              a.given_f32
                  ? reinterpret_cast<const float*>(gb)[go + c]
                  : __bfloat162float(
                        reinterpret_cast<const __nv_bfloat16*>(gb)[go + c]);
          acc = fmaf(gv, orow[c], acc);
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
  // p runs on exp2: lse and the scale times log2(e).
  const float scale_log2 = a.scale * kLog2e;
  float ls[2], gl[2];
  int pos[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    const bool in = row < a.sq;
    ls[r] = in ? a.lse[row_base + row] * kLog2e : -INFINITY;
    gl[r] = in && a.glse != nullptr ? a.glse[row_base + row] : 0.f;
    pos[r] = a.q_offset + row;
  }

  float dq[D / 8][4];
  zero(dq);
  for (int j = 0; j < n_tiles; ++j) {
    // Tile j + 1 loads into the other stage while tile j is computed.
    if (j + 1 < n_tiles) {
      float* nk = sKV + ((j + 1) & 1) * 2 * BK * LD;
      load_async<BK, D>(nk, kb, a.st[kSlotK][1], (j + 1) * BK, a.skv, a.d);
      load_async<BK, D>(nk + BK * LD, vb, a.st[kSlotV][1], (j + 1) * BK, a.skv,
                        a.d);
    }
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    const float* sK = sKV + (j & 1) * 2 * BK * LD;
    const float* sV = sK + BK * LD;
    const int k0 = j * BK;
    float s[BK / 8][4], dp[BK / 8][4];
    zero(s);
    zero(dp);
    product_nt<BK / 8, D, LD>(s, sQ + 16 * warp * LD, sK, g, t);
    product_nt<BK / 8, D, LD>(dp, sO + 16 * warp * LD, sV, g, t);
#pragma unroll
    for (int jj = 0; jj < BK / 8; ++jj) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, col = k0 + 8 * jj + 2 * t + (e & 1);
        const bool ok = col < a.kv_len && ls[r] != -INFINITY &&
                        (!a.causal || pos[r] >= a.kv_offset + col);
        const float p = ok ? ex2(fmaf(s[jj][e], scale_log2, -ls[r])) : 0.f;
        s[jj][e] = p * (dp[jj][e] - dl[r]) + gl[r] * p;  // dS
      }
    }
    product_pn<BK / 8, D / 8, LD>(dq, s, sK, g, t);
    __syncthreads();  // every warp is done with this stage
  }
  store_rows<D>(a.dq, a, kSlotDQ, b, h, row0, a.sq, dq, a.scale, g, t);
}

template <int D>
struct DkdvSmem {
  static constexpr int kStage =
      2 * Tile<D>::kQueries * Tile<D>::kLd + 3 * Tile<D>::kQueries;  // floats
  static constexpr int kBytes = (2 * kBM * Tile<D>::kLd + 2 * kStage) * 4;
};

template <int D>
__global__ void __launch_bounds__(kThreads, Tile<D>::kMinBlocks)
    flash_bwd_sm90_dkdv_kernel(const Args a) {
  constexpr int LD = Tile<D>::kLd, BQ = Tile<D>::kQueries;
  constexpr int kStage = DkdvSmem<D>::kStage;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sK = reinterpret_cast<float*>(smem);
  float* sV = sK + kBM * LD;
  float* stages = sV + kBM * LD;  // two stages of Q, dO, lse, delta, g_lse
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  int tile, b, h;
  block_tile(a, false, &tile, &b, &h);
  const int k0 = tile * kBM;
  const float* qb = head(a.q, a, kSlotQ, b, h);
  const float* ob = head(a.dout, a, kSlotDO, b, h);
  const long long row_base = (static_cast<long long>(b) * a.heads + h) * a.sq;
  // Query rows that can see a key of [k0, k0 + kBM): none when every key is
  // at or past kv_len; causal, from the first query at or after k0.
  int q_begin = 0;
  const int q_end = k0 >= a.kv_len ? 0 : a.sq;
  if (a.causal) {
    q_begin = max(0, k0 + a.kv_offset - a.q_offset);
    q_begin -= q_begin % BQ;
  }
  const int n_tiles = q_end > q_begin ? (q_end - q_begin + BQ - 1) / BQ : 0;

  // One stage: Q and dO tiles, async; the row statistics by plain loads
  // (lse times log2(e), -inf past Sq), visible after the barrier that
  // precedes their use.
  auto load_stage = [&](int j) {
    float* sq = stages + (j & 1) * kStage;
    const int qt = q_begin + j * BQ;
    load_async<BQ, D>(sq, qb, a.st[kSlotQ][1], qt, a.sq, a.d);
    load_async<BQ, D>(sq + BQ * LD, ob, a.st[kSlotDO][1], qt, a.sq, a.d);
    float* sL = sq + 2 * BQ * LD;
    for (int i = threadIdx.x; i < BQ; i += kThreads) {
      const int row = qt + i;
      const bool in = row < a.sq;
      sL[i] = in ? a.lse[row_base + row] * kLog2e : -INFINITY;
      sL[BQ + i] = in ? a.delta[row_base + row] : 0.f;
      sL[2 * BQ + i] = in && a.glse != nullptr ? a.glse[row_base + row] : 0.f;
    }
  };
  if (n_tiles > 0) {
    load_async<kBM, D>(sK, head(a.k, a, kSlotK, b, h), a.st[kSlotK][1], k0,
                       a.skv, a.d);
    load_async<kBM, D>(sV, head(a.v, a, kSlotV, b, h), a.st[kSlotV][1], k0,
                       a.skv, a.d);
    load_stage(0);
  }
  cp_commit();

  const int row0 = k0 + 16 * warp;
  const int key[2] = {row0 + g, row0 + g + 8};
  const float scale_log2 = a.scale * kLog2e;
  float dk[D / 8][4], dv[D / 8][4];
  zero(dk);
  zero(dv);
  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) load_stage(j + 1);
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    const float* sq = stages + (j & 1) * kStage;
    const float* sO = sq + BQ * LD;
    const float* sL = sq + 2 * BQ * LD;
    const float* sD = sL + BQ;
    const float* sG = sD + BQ;
    const int qt = q_begin + j * BQ;
    float s[BQ / 8][4], dp[BQ / 8][4];
    zero(s);
    zero(dp);
    product_nt<BQ / 8, D, LD>(s, sK + 16 * warp * LD, sq, g, t);   // S^T
    product_nt<BQ / 8, D, LD>(dp, sV + 16 * warp * LD, sO, g, t);  // dP^T
#pragma unroll
    for (int jj = 0; jj < BQ / 8; ++jj) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, c = 8 * jj + 2 * t + (e & 1);
        const int row = qt + c;  // the query
        const bool ok =
            key[r] < a.kv_len && row < a.sq && sL[c] != -INFINITY &&
            (!a.causal || a.q_offset + row >= a.kv_offset + key[r]);
        s[jj][e] = ok ? ex2(fmaf(s[jj][e], scale_log2, -sL[c])) : 0.f;  // P^T
      }
    }
    product_pn<BQ / 8, D / 8, LD>(dv, s, sO, g, t);
#pragma unroll
    for (int jj = 0; jj < BQ / 8; ++jj) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * jj + 2 * t + (e & 1);
        const float p = s[jj][e];
        s[jj][e] = p * (dp[jj][e] - sD[c]) + sG[c] * p;  // dS^T
      }
    }
    product_pn<BQ / 8, D / 8, LD>(dk, s, sq, g, t);
    __syncthreads();  // every warp is done with this stage
  }
  store_rows<D>(a.dv, a, kSlotDV, b, h, row0, a.skv, dv, 1.f, g, t);
  store_rows<D>(a.dk, a, kSlotDK, b, h, row0, a.skv, dk, a.scale, g, t);
}

// Above 48 KB dynamic shared memory is opted into; the attribute belongs
// to the current device, so it is set on every launch.
template <int D>
cudaError_t launch_dq(const Args& a, cudaStream_t s) {
  constexpr int bytes = DqSmem<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_sm90_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return err;
  const unsigned blocks = static_cast<unsigned>(a.row_tiles) * a.batch * a.heads;
  flash_bwd_sm90_dq_kernel<D><<<blocks, kThreads, bytes, s>>>(a);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkdv(const Args& a, cudaStream_t s) {
  constexpr int bytes = DkdvSmem<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_sm90_dkdv_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const unsigned blocks = static_cast<unsigned>(a.row_tiles) * a.batch * a.heads;
  flash_bwd_sm90_dkdv_kernel<D><<<blocks, kThreads, bytes, s>>>(a);
  return cudaGetLastError();
}

Args make_args(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* glse, int batch, int heads, int sq,
               int skv, int d, const long long* strides, int kv_len,
               int q_offset, int kv_offset, float sm_scale, int causal) {
  Args a = {};
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.dout = static_cast<const float*>(dout);
  a.lse = static_cast<const float*>(lse);
  a.glse = static_cast<const float*>(glse);
  for (int i = 0; i < kNumSlots; ++i) {
    for (int j = 0; j < 3; ++j) a.st[i][j] = strides[3 * i + j];
  }
  a.batch = batch;
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

}  // namespace tf32

bool rows_fit(int tiles, int batch, int heads) {
  return tiles > 0 && grid_fits(tiles, batch, heads);
}

}  // namespace

// Plain C entry points for ctypes, with the signatures of flash_general.cu's
// hvt_flash_general_dq / hvt_flash_general_dkdv. f32 selects the fp32
// (3xTF32) kernels, else the bf16 ones; d_pad is 16, 32, 64 or 128 (or
// 256 in bf16) with d <= d_pad, d a multiple of 8 in bf16 (4 in fp32) so a row is whole
// 16-byte units. Strides are in elements, three a view (batch, seq, head)
// of q, k, v, dout, dq, dk, dv, out, given; every operand has 16-byte
// aligned rows and strides (TMA's and cp.async's rule). glse may be null
// (zero cotangent of lse). Each launches on `device` (the calling thread's
// current device is restored), on `stream`, and returns a cudaError_t (0
// on a successful launch; cudaErrorInvalidValue for a size it does not
// take or a tensor map it cannot encode). Launch the dQ kernel first: it
// writes delta ([B, H, Sq] fp32), which the dK/dV kernel reads.
extern "C" int hvt_flash_bwd_sm90_dq(
    int f32, int d_pad, const void* q, const void* k, const void* v,
    const void* dout, const void* out, const void* dout_given, int given_f32,
    const void* lse, const void* glse, void* delta, void* dq, int batch,
    int heads, int sq, int skv, int d, const long long* strides, int kv_len,
    int q_offset, int kv_offset, float sm_scale, int causal, int device,
    void* stream) {
  const bool sizes = d_pad == 16 || d_pad == 32 || d_pad == 64 ||
                     d_pad == 128 || (!f32 && d_pad == 256);
  if (!sizes || d < 1 || d > d_pad || d % (f32 ? 4 : 8) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int current = 0;
  cudaError_t err = bind_device(device, &current);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f32) {
    tf32::Args a = tf32::make_args(q, k, v, dout, lse, glse, batch, heads, sq,
                                   skv, d, strides, kv_len, q_offset,
                                   kv_offset, sm_scale, causal);
    a.out = static_cast<const float*>(out);
    a.given = dout_given;
    a.given_f32 = given_f32;
    a.delta = static_cast<float*>(delta);
    a.dq = static_cast<float*>(dq);
    a.row_tiles = (sq + tf32::kBM - 1) / tf32::kBM;
    if (!rows_fit(a.row_tiles, batch, heads)) {
      err = cudaErrorInvalidValue;
    } else {
      switch (d_pad) {
        case 16: err = tf32::launch_dq<16>(a, s); break;
        case 32: err = tf32::launch_dq<32>(a, s); break;
        case 64: err = tf32::launch_dq<64>(a, s); break;
        default: err = tf32::launch_dq<128>(a, s); break;
      }
    }
  } else {
    Params p = make_params(out, dout_given, given_f32, lse, glse, delta, dq,
                           nullptr, nullptr, batch, heads, sq, skv, d, strides,
                           kv_len, q_offset, kv_offset, sm_scale, causal);
    p.row_tiles = (sq + kRows - 1) / kRows;
    const int bk = d_pad == 256 ? DqSmem<256>::kBK : DqSmem<16>::kBK;
    CUtensorMap maps[4];
    if (!rows_fit(p.row_tiles, batch, heads) ||
        !make_maps(maps, q, k, v, dout, batch, heads, sq, skv, d, d_pad,
                   strides, kRows, bk)) {
      err = cudaErrorInvalidValue;
    } else {
      switch (d_pad) {
        case 16: err = launch_dq<16>(p, maps, s); break;
        case 32: err = launch_dq<32>(p, maps, s); break;
        case 64: err = launch_dq<64>(p, maps, s); break;
        case 128: err = launch_dq<128>(p, maps, s); break;
        default: err = launch_dq<256>(p, maps, s); break;
      }
    }
  }
  if (current != device) cudaSetDevice(current);
  return static_cast<int>(err);
}

extern "C" int hvt_flash_bwd_sm90_dkdv(
    int f32, int d_pad, const void* q, const void* k, const void* v,
    const void* dout, const void* lse, const void* delta, const void* glse,
    void* dk, void* dv, int batch, int heads, int sq, int skv, int d,
    const long long* strides, int kv_len, int q_offset, int kv_offset,
    float sm_scale, int causal, int device, void* stream) {
  const bool sizes = d_pad == 16 || d_pad == 32 || d_pad == 64 ||
                     d_pad == 128 || (!f32 && d_pad == 256);
  if (!sizes || d < 1 || d > d_pad || d % (f32 ? 4 : 8) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int current = 0;
  cudaError_t err = bind_device(device, &current);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f32) {
    tf32::Args a = tf32::make_args(q, k, v, dout, lse, glse, batch, heads, sq,
                                   skv, d, strides, kv_len, q_offset,
                                   kv_offset, sm_scale, causal);
    a.delta = static_cast<float*>(const_cast<void*>(delta));
    a.dk = static_cast<float*>(dk);
    a.dv = static_cast<float*>(dv);
    a.row_tiles = (skv + tf32::kBM - 1) / tf32::kBM;
    if (!rows_fit(a.row_tiles, batch, heads)) {
      err = cudaErrorInvalidValue;
    } else {
      switch (d_pad) {
        case 16: err = tf32::launch_dkdv<16>(a, s); break;
        case 32: err = tf32::launch_dkdv<32>(a, s); break;
        case 64: err = tf32::launch_dkdv<64>(a, s); break;
        default: err = tf32::launch_dkdv<128>(a, s); break;
      }
    }
  } else {
    Params p = make_params(nullptr, nullptr, 0, lse, glse,
                           const_cast<void*>(delta), nullptr, dk, dv, batch,
                           heads, sq, skv, d, strides, kv_len, q_offset,
                           kv_offset, sm_scale, causal);
    const int keys = d_pad == 256 ? DkdvSmem<256, 32>::kKeys : kRows;
    p.row_tiles = (skv + keys - 1) / keys;
    const int bq = d_pad >= 128 ? 32 : 64;
    CUtensorMap maps[4];
    if (!rows_fit(p.row_tiles, batch, heads) ||
        !make_maps(maps, q, k, v, dout, batch, heads, sq, skv, d, d_pad,
                   strides, bq, keys)) {
      err = cudaErrorInvalidValue;
    } else {
      switch (d_pad) {
        case 16: err = launch_dkdv<16>(p, maps, s); break;
        case 32: err = launch_dkdv<32>(p, maps, s); break;
        case 64: err = launch_dkdv<64>(p, maps, s); break;
        case 128: err = launch_dkdv<128>(p, maps, s); break;
        default: err = launch_dkdv<256>(p, maps, s); break;
      }
    }
  }
  if (current != device) cudaSetDevice(current);
  return static_cast<int>(err);
}
