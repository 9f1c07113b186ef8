// Flash-attention forward for Hopper (sm_90a) at the head dims and in the
// dtype that flash_fwd.cu does not take, written by hand in CUDA C++: bf16
// on wgmma fed by TMA at d_pad 16, 32, 64, 128 and 256, and fp32 on the
// tensor cores as 3xTF32 at d_pad 16, 32, 64 and 128.
//
// Replaces, on the sm90 route of ops/flash_attention.py (fwd_route),
// flash_general.cu's flash_general_fwd_kernel, which computes what
// horovod_tpu/ops/pallas_kernels.py::_fwd_kernel (:125, called behind
// _fwd_pallas) computes: blockwise online softmax with fp32 scores and
// statistics; a causal mask on global positions q_offset / kv_offset; keys
// at or past kv_len masked; sm_scale of either sign (scale, then mask, then
// max); p rounded to V's dtype before PV (a no-op in fp32), the row sum
// over the unrounded p; a row with no valid key gives out 0 and lse -inf;
// out in the input dtype, lse (natural log) fp32 [B, H, Sq].
//
// bf16: the design of flash_fwd.cu (header there), generalised to a head
// dim d that is not 64 or 128. A persistent grid (one or two blocks an SM,
// below); a block = two consumer warpgroups of 64 query rows and a producer
// warp that keeps a ring of K/V stages full with TMA (cp.async.bulk.tensor,
// mbarrier completion) across the block's work items (128 query rows of
// one (batch, head) each); S = Q K^T and O += P V on bf16 wgmma with fp32
// accumulators in registers, P packed from the S accumulator into register
// A fragments and V read MN-major through the descriptor's transpose bit;
// tile j + 1's S product issued before tile j's PV product, the softmax of
// tile j + 1 run while PV runs, and the two warpgroups taking turns at
// issuing through two named barriers; exp2 with the scale folded into the
// exponent where sm_scale > 0; key tiles wholly masked never loaded; the
// heaviest causal items first; the epilogue staged through the item's
// query tile. What changes with d_pad (flash_bwd_sm90_general.cu's Geo):
//
//   - the TMA box and the swizzle: a box is min(d_pad, 64) columns, so a
//     row is 32 bytes at d_pad 16 (32B swizzle), 64 at 32 (64B swizzle)
//     and 128 from 64 (128B swizzle; two boxes a row at 128, four at 256);
//     the descriptors take the matching layout type (3 / 2 / 1) and
//     eight-row stride; PV runs one wgmma a box (n16, n32 or n64) a k-step;
//   - the tensor map's D extent is d itself: TMA's zero fill pads columns
//     d..d_pad, so a column third of the fused QKV projection is read in
//     place, never past its own columns, and the epilogue stores only the
//     16-byte units below d;
//   - at d_pad 64 S takes Q as register A fragments (as flash_fwd.cu at
//     64); elsewhere A is read from shared memory;
//   - at d_pad 256 O is 64 x 256 fp32 a warpgroup, 128 registers a thread:
//     key tiles are 64 (S 32 registers, P 16) and there is one query
//     buffer, so shared memory is 64 KB of Q and two 64 KB K/V stages.
//     Below 256: two query buffers that alternate between items (the next
//     item's tile loads during this one's epilogue) and 4 stages (2 at
//     128); 128-key tiles at 64 and 128; at 16 and 32, where the
//     exponentials outweigh the products, 64-key tiles and two blocks an
//     SM (consumers at 104 registers, 24 KB and 48 KB of shared memory a
//     block): four softmax warps on each SM sub-partition instead of two
//     (on an H100, 15% faster at d 16 than one block of 128-key tiles, 7%
//     at 32; splitting the row max and sum chains changed nothing).
//
// The tile loop sits inside one branch with its first issue and leaves
// before issuing past its last tile, and an accumulator is read or written
// only after a wgmma_wait that covers it: where a path breaks either rule,
// ptxas serialises every wgmma of the kernel (advisories C7514/C7515).
//
// fp32 (namespace tf32): the design of flash_bwd_sm90_general.cu's fp32
// kernels. Both products on mma.sync.m16n8k8 .tf32 as 3xTF32: each operand
// x becomes hi = rna(x), lo = rna(x - hi), and C += A_lo B_hi + A_hi B_lo +
// A_hi B_hi in fp32 (the dropped lo lo term is about 2^-22 of a product).
// A block is four warps of 16 query rows (64 rows); K/V tiles of 64 keys
// (32 from d_pad 64) are double-buffered in shared memory by cp.async
// (zero fill past S and past d), rows padded by 16 bytes so every fragment
// load is free of bank conflicts. P goes from the S product's C fragment
// to the PV product's A fragment in registers by permuting k (logical k =
// t reads column 2t, t + 4 reads 2t + 1), V's rows read in the same order.
// The softmax runs on exp2 with the scale and log2(e) premultiplied. fp32
// d_pad 256 stays on flash_general.cu: its 64-row fp32 tiles are 66 KB
// each, and O alone 128 registers a thread of four-warp blocks.
//
// Which (dtype, d_pad) the wrapper sends here is its fwd_route; each was
// routed only where this kernel measured faster than flash_general.cu's
// forward in the same chip run, in both orders (PERF.md).
//
// What bounds it on an H100 SXM (data-sheet peaks at 700 W: 3.35 TB/s, 989
// TFLOP/s dense bf16, 495 TF32, 67 fp32 outside the tensor cores): at
// GPT-2 small's fp32 training shape (B=8, S=1024, H=12, D=64, causal) the
// causal half of the two products is 12.90 GFLOP: 0.1925 ms at the FFMA
// rate, 0.0782 ms as three tf32 products a product at the tensor cores'
// rate; its bytes (101 MB) take 0.030 ms. In bf16 the bytes bound it by the
// table's measure (about 0.015 ms at [8, 1024, 768 / d, d]), but at d_pad
// 16 and 32 the products are thin and the exponentials set the floor: at
// [8, 1024, 48, 16] causal there are 8 x 48 x 524,800 = 201.5 M of them,
// and the MUFU unit does 16 a clock an SM, across 132 SMs at <= 1.98 GHz:
// 0.048 ms, about 3x the byte bound (0.024 ms at d 32, at most 0.012 ms
// from d 64). What the design does about that floor: no exponential is
// spent on a key tile wholly masked, the fold removes the multiply before
// each one, and the two warpgroups' exponentials run back to back while the
// other's products are in flight; it puts no share of exp2 on the FMA pipe,
// so at d_pad 16 MUFU is the limit. What it leaves on the table: that
// share; the diagonal tile's masked half (computed in full); mma.sync's
// tf32 rate in fp32 (a fraction of wgmma's), with the hi/lo split of every
// B fragment in registers at each use; the fp32 kernels' four-warp blocks,
// with only other resident blocks hiding a tile's latency.

#include <cmath>

#include "sm90_common.cuh"

namespace {

constexpr int kConsumers = 2;                // consumer warpgroups
constexpr int kRows = 64 * kConsumers;       // query rows per work item
constexpr int kThreads = (kConsumers + 1) * 128;
constexpr float kLn2 = 0.6931471805599453f;

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
  __nv_bfloat16* o;
  float* lse;  // [B, H, Sq]
  long long o_sb, o_ss, o_sh;
  int batch, n_heads, sq, d, kv_len, q_offset, kv_offset, causal;
  int row_tiles;     // query tiles of kRows
  int items;         // work items: row_tiles * batch * n_heads
  float scale_log2;  // sm_scale * log2(e): the softmax runs on exp2
};

// Shared memory at d_pad D: kQBufs query tiles (two alternate between
// items; one at 256), a ring of kStages K/V stages of kBN keys.
template <int D>
struct FwdSmem {
  using G = Geo<D>;
  static constexpr int kBN = D == 256 || D <= 32 ? 64 : 128;  // keys a tile
  static constexpr int kBlocks = D <= 32 ? 2 : 1;  // blocks an SM
  // setmaxnreg's split of the block's registers: 384 threads at 168
  // registers for one block an SM, at 80 for two.
  static constexpr int kProducerRegs = kBlocks == 2 ? 24 : 40;
  static constexpr int kConsumerRegs = kBlocks == 2 ? 104 : 232;
  static constexpr int kQBufs = D == 256 ? 1 : 2;
  static constexpr int kStages = D >= 128 ? 2 : 4;
  static constexpr int kQBox = kRows * G::kRB;  // a box of the query tile
  static constexpr int kKBox = kBN * G::kRB;    // a box of a key tile
  static constexpr int kQBytes = G::kBoxes * kQBox;
  static constexpr int kStageBytes = 2 * G::kBoxes * kKBox;  // K and V
  static constexpr int kBytes = kQBufs * kQBytes + kStages * kStageBytes +
                                (2 * kQBufs + 2 * kStages) * 8 + 1024;
};

// S = Q K^T for the warpgroup's 64 rows against one key tile, one commit
// group. At d_pad 64 A is held in registers (qa_r); elsewhere it is read
// from shared memory (qa).
template <int D, bool kRegA, int KS, int N>
__device__ __forceinline__ void issue_s(float (&s)[N], const uint32_t (&qa_r)[KS][4],
                                        const uint8_t* qa, int qbox,
                                        const uint8_t* sk, int kbox) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint64_t db = gdesc_k<D>(sk + kstep<D>(kk, kbox));
    if constexpr (kRegA) {
      wgmma_rs<false>(s, qa_r[kk], db, kk > 0);
    } else {
      wgmma_ss(s, gdesc_k<D>(qa + kstep<D>(kk, qbox)), db, kk > 0);
    }
  }
  wgmma_commit();
}

// O += P V for one key tile, V read MN-major one box at a time, one commit
// group.
template <int D, int KB, int KS, int N>
__device__ __forceinline__ void issue_pv(float (&o)[KB][N],
                                         const uint32_t (&p_a)[KS][4],
                                         const uint8_t* sv, int kbox) {
  using G = Geo<D>;
  static_assert(KB == G::kBoxes && N == G::kCols / 2, "O is a box a wgmma");
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
    for (int x = 0; x < KB; ++x) {
      wgmma_rs<true>(o[x], p_a[kk], gdesc_mn<D>(sv + x * kbox + kk * 16 * G::kRB),
                     1);
    }
  }
  wgmma_commit();
}

// One tile's online softmax on the warpgroup's S fragments (keys k0 ..):
// s becomes p = exp2(s * scale_log2 - m_new) (0 where masked), m and the
// thread's partial row sums l move to the new max, and corr is the factor
// O must be rescaled by. Accumulator i of a thread is row (i >> 1) & 1 of
// its pair (g, g + 8), column k0 + 8 (i / 4) + 2 t + (i & 1). With kFold
// (sm_scale > 0, so the largest score is the largest scaled score) the max
// is taken on the raw scores and exp2's argument is one FMA; otherwise the
// scores are scaled first.
template <bool kFold, int N>
__device__ __forceinline__ void softmax_tile(float (&s)[N], const Params& p,
                                             int k0, bool inside,
                                             const int (&qpos)[2], int t,
                                             float (&m)[2], float (&l)[2],
                                             float (&corr)[2]) {
  const float scale = p.scale_log2;
  if (!inside) {
    const int kv_len = p.kv_len;
    const bool causal = p.causal;
#pragma unroll
    for (int n = 0; n < N / 4; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + n * 8 + t * 2 + (e & 1);
        const bool ok = (col < kv_len) & (!causal | (qpos[e >> 1] - p.kv_offset >= col));
        s[4 * n + e] = ok ? (kFold ? s[4 * n + e] : s[4 * n + e] * scale) : -INFINITY;
      }
    }
  } else if (!kFold) {
#pragma unroll
    for (int i = 0; i < N; ++i) s[i] *= scale;
  }
  float mx[2] = {kFold ? -INFINITY : m[0], kFold ? -INFINITY : m[1]};
#pragma unroll
  for (int i = 0; i < N; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
  float m_use[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    if (kFold) mx[r] = fmaxf(mx[r] * scale, m[r]);
    m_use[r] = mx[r] == -INFINITY ? 0.f : mx[r];
    corr[r] = ex2(m[r] - m_use[r]);
    m[r] = mx[r];
    l[r] *= corr[r];
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int r = (i >> 1) & 1;
    s[i] = ex2(kFold ? fmaf(s[i], scale, -m_use[r]) : s[i] - m_use[r]);
    l[r] += s[i];
  }
}

// Key tiles [0, n) of kBN keys can hold a valid key for some row of the
// query tile at q0: none past kv_len and, with the causal mask, none
// wholly in the tile's future.
template <int kBN>
__device__ __forceinline__ int kv_tiles(const Params& p, int q0) {
  int kv_end = p.kv_len;
  if (p.causal) {
    const int q_last = p.q_offset + min(q0 + kRows, p.sq) - 1;
    kv_end = min(kv_end, max(q_last - p.kv_offset + 1, 0));
  }
  return (kv_end + kBN - 1) / kBN;
}

// Work item w of round r for block i of a grid of g: the rounds run
// boustrophedon (odd rounds from the last block), so with the items in
// heaviest-first order the blocks' loads even out.
__device__ __forceinline__ unsigned item_index(int r, int i, int g) {
  return static_cast<unsigned>(r) * g + ((r & 1) ? g - 1 - i : i);
}

// Byte offset of 16-byte unit u of row r in the epilogue's staging rows of
// kRB bytes: the unit is XORed with the row's place among the rows that
// share a 128-byte bank line, so a warp's fragment stores (8 rows, one
// unit each) hit distinct banks.
template <int kRB>
__device__ __forceinline__ int stage_unit(int r, int u) {
  constexpr int kUnits = kRB / 16, kPerLine = 128 / kRB;
  return r * kRB + ((u ^ ((r / kPerLine) % kUnits)) << 4);
}

template <int D, bool kFold>
__global__ void __launch_bounds__(kThreads, FwdSmem<D>::kBlocks)
    flash_fwd_sm90_kernel(const Params p, const __grid_constant__ CUtensorMap map_q,
                          const __grid_constant__ CUtensorMap map_k,
                          const __grid_constant__ CUtensorMap map_v) {
  using G = Geo<D>;
  using S = FwdSmem<D>;
  constexpr int kBN = S::kBN;
  constexpr int kBoxes = G::kBoxes;
  constexpr int kStages = S::kStages;
  constexpr int kQBufs = S::kQBufs;
  constexpr int kN = G::kCols / 2;  // O accumulator floats a box
  constexpr bool kRegA = D == 64;
  constexpr int kAS = kRegA ? D / 16 : 1;  // register A k-steps
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* sQs = align1024(smem_raw);  // query tiles, alternating items
  uint8_t* stages = sQs + kQBufs * S::kQBytes;
  uint64_t* qfull = reinterpret_cast<uint64_t*>(stages + kStages * S::kStageBytes);
  uint64_t* qempty = qfull + kQBufs;
  uint64_t* full = qempty + kQBufs;
  uint64_t* empty = full + kStages;

  if (threadIdx.x == 0) {
    for (int x = 0; x < kQBufs; ++x) {
      bar_init(&qfull[x], 1);
      bar_init(&qempty[x], kConsumers * 4);  // one arrival a consumer warp
    }
    for (int s = 0; s < kStages; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], kConsumers * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  const int g_blocks = gridDim.x;
  const int bi = blockIdx.x;
  if (wg == kConsumers) {
    // Producer: one thread walks the block's items, loading each one's
    // query tile (into the buffer its item kQBufs back released) and
    // keeping the ring of key tiles full across items.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(S::kProducerRegs));
    if (threadIdx.x == kConsumers * 128) {
      int s = 0;
      uint32_t phase = 0;
      for (int r = 0, n = 0;; ++r, ++n) {
        const unsigned w = item_index(r, bi, g_blocks);
        if (w >= static_cast<unsigned>(p.items)) break;
        const Block blk = block_of(p, true, w);
        const int q0 = blk.tile * kRows;
        const int n_tiles = kv_tiles<kBN>(p, q0);
        const int qb = n % kQBufs;
        bar_wait(&qempty[qb], ((n / kQBufs) & 1) ^ 1);
        uint8_t* sQ = sQs + qb * S::kQBytes;
        if (n_tiles > 0) {
          bar_expect_tx(&qfull[qb], S::kQBytes);
          for (int x = 0; x < kBoxes; ++x) {
            tma_load(sQ + x * S::kQBox, &map_q, &qfull[qb], x * G::kCols, blk.h,
                     q0, blk.b);
          }
        } else {
          bar_arrive(&qfull[qb]);
        }
        for (int j = 0; j < n_tiles; ++j) {
          bar_wait(&empty[s], phase ^ 1);
          bar_expect_tx(&full[s], S::kStageBytes);
          uint8_t* sk = stages + s * S::kStageBytes;
          uint8_t* sv = sk + kBoxes * S::kKBox;
          for (int x = 0; x < kBoxes; ++x) {
            tma_load(sk + x * S::kKBox, &map_k, &full[s], x * G::kCols, blk.h,
                     j * kBN, blk.b);
            tma_load(sv + x * S::kKBox, &map_v, &full[s], x * G::kCols, blk.h,
                     j * kBN, blk.b);
          }
          if (++s == kStages) {
            s = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(S::kConsumerRegs));
    const int lane = threadIdx.x & 31;
    const int warp = (threadIdx.x / 32) & 3;
    const int g = lane >> 2;
    const int t = lane & 3;
    int s = 0;
    uint32_t phase = 0;
    // The warpgroups take turns at issuing their products (one computes
    // while the other's products run), warpgroup 0 first; the turns run on
    // across items, so a warpgroup never passes twice before the other
    // has waited once.
    if (wg == 1) turn_pass(wg);
    for (int r = 0, n = 0;; ++r, ++n) {
      const unsigned w = item_index(r, bi, g_blocks);
      if (w >= static_cast<unsigned>(p.items)) break;
      const Block blk = block_of(p, true, w);
      const int q0 = blk.tile * kRows;
      const int n_tiles = kv_tiles<kBN>(p, q0);
      const int qb = n % kQBufs;
      uint8_t* sQ = sQs + qb * S::kQBytes;
      const int wrow0 = q0 + wg * 64;      // the warpgroup's 64 rows
      const int row0 = wrow0 + warp * 16;  // the warp's 16
      const int qpos[2] = {p.q_offset + row0 + g, p.q_offset + row0 + g + 8};
      // Every key of a tile from k0 is valid for every row of the warpgroup.
      auto inside = [&](int k0) {
        return k0 + kBN <= p.kv_len &&
               (!p.causal || p.q_offset + wrow0 >= p.kv_offset + k0 + kBN - 1);
      };

      float o[kBoxes][kN];
#pragma unroll
      for (int x = 0; x < kBoxes; ++x) {
#pragma unroll
        for (int i = 0; i < kN; ++i) o[x][i] = 0.f;
      }
      float sacc[kBN / 2];
#pragma unroll
      for (int i = 0; i < kBN / 2; ++i) sacc[i] = 0.f;
      uint32_t p_a[kBN / 16][4];
      uint32_t q_a[kAS][4];
      // Rows g and g + 8 of the warp's 16: the running max (log2 domain)
      // and this thread's partial row sums; the quad's partials are added
      // at the end.
      float m[2] = {-INFINITY, -INFINITY};
      float l[2] = {0.f, 0.f};
      float corr[2];
      const uint8_t* qa = sQ + wg * 64 * G::kRB;
      // Releases the ring stage of the tile whose PV product just finished.
      auto release = [&]() {
        __syncwarp();
        if (lane == 0) bar_arrive(&empty[s]);
        if (++s == kStages) {
          s = 0;
          phase ^= 1;
        }
      };

      bar_wait(&qfull[qb], (n / kQBufs) & 1);
      if (n_tiles > 0) {
        if constexpr (kRegA) load_a(q_a, sQ, S::kQBox, wg * 64 + warp * 16, lane);
        bar_wait(&full[s], phase);
        turn_wait(wg);
        issue_s<D, kRegA>(sacc, q_a, qa, S::kQBox, stages + s * S::kStageBytes,
                          S::kKBox);
        turn_pass(wg);
        wgmma_wait<0>();
        fence_regs(sacc);
        softmax_tile<kFold>(sacc, p, 0, inside(0), qpos, t, m, l, corr);
        pack_a<kBN / 16>(p_a, sacc);
        for (int j = 0;; ++j) {
          const uint8_t* sv = stages + s * S::kStageBytes + kBoxes * S::kKBox;
          if (j + 1 == n_tiles) {
            turn_wait(wg);
            issue_pv<D>(o, p_a, sv, S::kKBox);
            turn_pass(wg);
            wgmma_wait<0>();
#pragma unroll
            for (int x = 0; x < kBoxes; ++x) fence_regs(o[x]);
            fence_regs(p_a);
            release();
            break;
          }
          const int ns = s + 1 == kStages ? 0 : s + 1;
          bar_wait(&full[ns], ns == 0 ? phase ^ 1 : phase);
          turn_wait(wg);
          issue_s<D, kRegA>(sacc, q_a, qa, S::kQBox, stages + ns * S::kStageBytes,
                            S::kKBox);
          issue_pv<D>(o, p_a, sv, S::kKBox);
          turn_pass(wg);
          // Tile j + 1's softmax while tile j's PV product runs.
          wgmma_wait<1>();
          fence_regs(sacc);
          const int k0 = (j + 1) * kBN;
          softmax_tile<kFold>(sacc, p, k0, inside(k0), qpos, t, m, l, corr);
          wgmma_wait<0>();
#pragma unroll
          for (int x = 0; x < kBoxes; ++x) fence_regs(o[x]);
          fence_regs(p_a);
          release();
#pragma unroll
          for (int x = 0; x < kBoxes; ++x) {
#pragma unroll
            for (int i = 0; i < kN; ++i) o[x][i] *= corr[(i >> 1) & 1];
          }
          pack_a<kBN / 16>(p_a, sacc);
        }
      }
#pragma unroll
      for (int x = 0; x < kBoxes; ++x) fence_regs(o[x]);
      fence_regs(p_a);

      // out = O / l, rounded once to bf16, staged through the warpgroup's
      // own rows of the item's query tile (no longer read; stage_unit's
      // layout), then 16-byte stores of the units below d; then the tile
      // buffer is released.
      float inv[2];
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 1);
        l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 2);
        inv[rr] = l[rr] > 0.f ? 1.f / l[rr] : 0.f;
      }
      uint8_t* so = sQ + wg * 64 * G::kRB;
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int row = warp * 16 + g + 8 * rr;
#pragma unroll
        for (int x = 0; x < kBoxes; ++x) {
#pragma unroll
          for (int c = 0; c < G::kCols / 8; ++c) {
            *reinterpret_cast<uint32_t*>(so + x * S::kQBox +
                                         stage_unit<G::kRB>(row, c) + 4 * t) =
                pack_bf16x2(o[x][4 * c + 2 * rr] * inv[rr],
                            o[x][4 * c + 2 * rr + 1] * inv[rr]);
          }
        }
      }
      asm volatile("bar.sync %0, 128;\n" ::"r"(3 + wg) : "memory");
      __nv_bfloat16* ob = p.o + blk.b * p.o_sb + blk.h * p.o_sh;
      const int tid = threadIdx.x & 127;
      constexpr int kUnits = G::kRB / 16;       // 16-byte units a box row
      constexpr int kRowUnits = D / 8;          // 16-byte units a row
#pragma unroll
      for (int it = 0; it < 64 * kRowUnits / 128; ++it) {
        const int i = it * 128 + tid;  // a row's units on neighbouring threads
        const int row = i / kRowUnits;
        const int x = (i / kUnits) % kBoxes;
        const int u = i % kUnits;
        const int col = x * G::kCols + u * 8;
        const int grow = wrow0 + row;
        if (grow < p.sq && col < p.d) {
          *reinterpret_cast<uint4*>(ob + static_cast<long long>(grow) * p.o_ss + col) =
              *reinterpret_cast<const uint4*>(so + x * S::kQBox +
                                              stage_unit<G::kRB>(row, u));
        }
      }
      if (t == 0) {
        const long long stat0 =
            (static_cast<long long>(blk.b) * p.n_heads + blk.h) * p.sq;
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int row = row0 + g + 8 * rr;
          if (row < p.sq) {
            p.lse[stat0 + row] = l[rr] > 0.f ? (m[rr] + log2f(l[rr])) * kLn2 : -INFINITY;
          }
        }
      }
      // The buffer's next writer is TMA: order these generic accesses
      // before it, then release.
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncwarp();
      if (lane == 0) bar_arrive(&qempty[qb]);
    }
    if (wg == 0) turn_wait(wg);  // the other's last pass
  }
}

template <int D, bool kFold>
cudaError_t launch(const Params& p, const CUtensorMap* maps, cudaStream_t stream) {
  static std::atomic<uint64_t> done{0};
  constexpr int kSmem = FwdSmem<D>::kBytes;
  const cudaError_t err = opt_in(flash_fwd_sm90_kernel<D, kFold>, kSmem, done);
  if (err != cudaSuccess) return err;
  const int sms = sm_count();
  if (sms <= 0) return cudaErrorInvalidDevice;
  const unsigned blocks =
      static_cast<unsigned>(min(p.items, FwdSmem<D>::kBlocks * sms));
  flash_fwd_sm90_kernel<D, kFold><<<blocks, kThreads, kSmem, stream>>>(
      p, maps[0], maps[1], maps[2]);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bf16(const Params& p, const CUtensorMap* maps,
                        cudaStream_t stream) {
  return p.scale_log2 > 0.f ? launch<D, true>(p, maps, stream)
                            : launch<D, false>(p, maps, stream);
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

namespace tf32 {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBM = 16 * kWarps;  // query rows a block owns, 16 a warp

// Stride slots of Args::st, the order of the C entry's strides.
enum Slot { kSlotQ, kSlotK, kSlotV, kSlotO, kNumSlots };

struct Args {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  float* lse;  // [B, H, Sq]
  long long st[kNumSlots][3];
  int batch, heads, sq, skv, d, kv_len, q_offset, kv_offset, causal;
  int row_tiles;
  float scale;
};

// Shared-memory row stride in floats (16 bytes of padding: LD / 4 odd, so
// the fragment loads below hit 32 distinct banks), keys a K/V tile, and the
// blocks an SM is to hold (the register cap: 128 registers a thread at 4,
// none at 2).
template <int D>
struct Tile {
  static_assert(D == 16 || D == 32 || D == 64 || D == 128, "fp32 d_pad");
  static constexpr int kLd = D + 4;
  static constexpr int kKeys = D >= 64 ? 32 : 64;
  static constexpr int kMinBlocks = D == 128 ? 2 : 4;
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

template <int D>
struct FwdSmem {
  static constexpr int kBytes =
      (kBM + 2 * 2 * Tile<D>::kKeys) * Tile<D>::kLd * 4;
};

template <int D>
__global__ void __launch_bounds__(kThreads, Tile<D>::kMinBlocks)
    flash_fwd_sm90_kernel(const Args a) {
  constexpr int LD = Tile<D>::kLd, BK = Tile<D>::kKeys;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);
  float* sKV = sQ + kBM * LD;  // two stages of K and V tiles
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  // The (tile, batch, head) of this block, tile index slowest and the last
  // tile first: the heaviest causal tiles start first.
  const int bh = a.batch * a.heads;
  const int i_tile = blockIdx.x / bh;
  const int b = (blockIdx.x - i_tile * bh) / a.heads;
  const int h = blockIdx.x - i_tile * bh - b * a.heads;
  const int q0 = (a.row_tiles - 1 - i_tile) * kBM;
  const float* kb = head(a.k, a, kSlotK, b, h);
  const float* vb = head(a.v, a, kSlotV, b, h);
  // Keys [0, end) that some query row of the block may attend to.
  int end = a.kv_len;
  if (a.causal) {
    const int q_last = a.q_offset + min(q0 + kBM, a.sq) - 1;
    end = min(end, max(q_last - a.kv_offset + 1, 0));
  }
  const int n_tiles = (end + BK - 1) / BK;
  if (n_tiles > 0) {
    load_async<kBM, D>(sQ, head(a.q, a, kSlotQ, b, h), a.st[kSlotQ][1], q0,
                       a.sq, a.d);
    load_async<BK, D>(sKV, kb, a.st[kSlotK][1], 0, a.skv, a.d);
    load_async<BK, D>(sKV + BK * LD, vb, a.st[kSlotV][1], 0, a.skv, a.d);
  }
  cp_commit();

  const int row0 = q0 + 16 * warp;
  const int pos[2] = {a.q_offset + row0 + g, a.q_offset + row0 + g + 8};
  // The softmax runs on exp2: scores times the scale and log2(e), scaled
  // before they are masked and maxed (either sign of the scale).
  const float scale_log2 = a.scale * kLog2e;
  float o[D / 8][4];
  zero(o);
  float m[2] = {-INFINITY, -INFINITY};  // running max, log2 domain
  float l[2] = {0.f, 0.f};              // this thread's partial row sums
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
    float s[BK / 8][4];
    zero(s);
    product_nt<BK / 8, D, LD>(s, sQ + 16 * warp * LD, sK, g, t);
    float mt[2] = {m[0], m[1]};
#pragma unroll
    for (int jj = 0; jj < BK / 8; ++jj) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, col = k0 + 8 * jj + 2 * t + (e & 1);
        const bool ok =
            col < a.kv_len && (!a.causal || pos[r] >= a.kv_offset + col);
        const float x = ok ? s[jj][e] * scale_log2 : -INFINITY;
        s[jj][e] = x;
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
      corr[r] = ex2(m[r] - m_use[r]);
      m[r] = mt[r];
      l[r] *= corr[r];
    }
#pragma unroll
    for (int jj = 0; jj < BK / 8; ++jj) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = ex2(s[jj][e] - m_use[e >> 1]);
        s[jj][e] = p;
        l[e >> 1] += p;  // the unrounded p, as the TPU kernel sums it
      }
    }
#pragma unroll
    for (int jj = 0; jj < D / 8; ++jj) {
      o[jj][0] *= corr[0];
      o[jj][1] *= corr[0];
      o[jj][2] *= corr[1];
      o[jj][3] *= corr[1];
    }
    product_pn<BK / 8, D / 8, LD>(o, s, sV, g, t);
    __syncthreads();  // every warp is done with this stage
  }

  // out = O / l at columns below d (a multiple of 4: a column pair is in
  // or out) and rows below Sq; lse = (m + log2 l) ln 2.
  const long long row_base = (static_cast<long long>(b) * a.heads + h) * a.sq;
  float* ob = a.o + b * a.st[kSlotO][0] + h * a.st[kSlotO][2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;
    const int row = row0 + g + 8 * r;
    if (row >= a.sq) continue;
    if (t == 0) {
      a.lse[row_base + row] = l[r] > 0.f ? (m[r] + log2f(l[r])) * kLn2 : -INFINITY;
    }
    float* orow = ob + static_cast<long long>(row) * a.st[kSlotO][1];
#pragma unroll
    for (int jj = 0; jj < D / 8; ++jj) {
      const int col = 8 * jj + 2 * t;
      if (col < a.d) {
        *reinterpret_cast<float2*>(orow + col) =
            make_float2(o[jj][2 * r] * inv, o[jj][2 * r + 1] * inv);
      }
    }
  }
}

// Above 48 KB dynamic shared memory is opted into; the attribute belongs
// to the current device, so it is set on every launch.
template <int D>
cudaError_t launch(const Args& a, cudaStream_t s) {
  constexpr int bytes = FwdSmem<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_sm90_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return err;
  const unsigned blocks = static_cast<unsigned>(a.row_tiles) * a.batch * a.heads;
  flash_fwd_sm90_kernel<D><<<blocks, kThreads, bytes, s>>>(a);
  return cudaGetLastError();
}

}  // namespace tf32

bool rows_fit(int tiles, int batch, int heads) {
  return tiles > 0 && grid_fits(tiles, batch, heads);
}

}  // namespace

// Plain C entry point for ctypes, with the signature of flash_general.cu's
// hvt_flash_general_fwd. f32 selects the fp32 (3xTF32) kernels, else the
// bf16 ones; d_pad is 16, 32, 64 or 128 (or 256 in bf16) with d <= d_pad,
// d a multiple of 8 in bf16 (4 in fp32) so a row is whole 16-byte units.
// Strides are in elements, three a view (batch, seq, head) of q, k, v and
// out; q, k, v have 16-byte aligned rows and strides (TMA's and cp.async's
// rule), out has unit stride along D and strides of whole 16-byte units.
// Launches on `device` (the calling thread's current device is restored),
// on `stream`, and returns a cudaError_t (0 on a successful launch;
// cudaErrorInvalidValue for a size it does not take or a tensor map it
// cannot encode).
extern "C" int hvt_flash_fwd_sm90(
    int f32, int d_pad, const void* q, const void* k, const void* v,
    void* out, void* lse, int batch, int heads, int sq, int skv, int d,
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
    tf32::Args a = {};
    a.q = static_cast<const float*>(q);
    a.k = static_cast<const float*>(k);
    a.v = static_cast<const float*>(v);
    a.o = static_cast<float*>(out);
    a.lse = static_cast<float*>(lse);
    for (int i = 0; i < tf32::kNumSlots; ++i) {
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
    a.row_tiles = (sq + tf32::kBM - 1) / tf32::kBM;
    if (!rows_fit(a.row_tiles, batch, heads)) {
      err = cudaErrorInvalidValue;
    } else {
      switch (d_pad) {
        case 16: err = tf32::launch<16>(a, s); break;
        case 32: err = tf32::launch<32>(a, s); break;
        case 64: err = tf32::launch<64>(a, s); break;
        default: err = tf32::launch<128>(a, s); break;
      }
    }
  } else {
    Params p;
    p.o = static_cast<__nv_bfloat16*>(out);
    p.lse = static_cast<float*>(lse);
    p.o_sb = strides[9];
    p.o_ss = strides[10];
    p.o_sh = strides[11];
    p.batch = batch;
    p.n_heads = heads;
    p.sq = sq;
    p.d = d;
    p.kv_len = kv_len;
    p.q_offset = q_offset;
    p.kv_offset = kv_offset;
    p.causal = causal;
    p.row_tiles = (sq + kRows - 1) / kRows;
    p.items = static_cast<int>(static_cast<long long>(p.row_tiles) * batch *
                               heads);  // rows_fit bounds it
    p.scale_log2 = sm_scale * kLog2e;
    const int cols = d_pad < 64 ? d_pad : 64;
    const int bn = d_pad <= 32 || d_pad == 256 ? FwdSmem<16>::kBN
                                               : FwdSmem<64>::kBN;
    // With no valid key no block loads anything: the maps stay unencoded
    // (and K/V may have no rows at all).
    CUtensorMap maps[3] = {};
    if (!rows_fit(p.row_tiles, batch, heads) ||
        (kv_len > 0 &&
         !(make_map_g(&maps[0], q, batch, sq, heads, d, strides + 0, kRows, cols) &&
           make_map_g(&maps[1], k, batch, skv, heads, d, strides + 3, bn, cols) &&
           make_map_g(&maps[2], v, batch, skv, heads, d, strides + 6, bn, cols)))) {
      err = cudaErrorInvalidValue;
    } else {
      switch (d_pad) {
        case 16: err = launch_bf16<16>(p, maps, s); break;
        case 32: err = launch_bf16<32>(p, maps, s); break;
        case 64: err = launch_bf16<64>(p, maps, s); break;
        case 128: err = launch_bf16<128>(p, maps, s); break;
        default: err = launch_bf16<256>(p, maps, s); break;
      }
    }
  }
  if (current != device) cudaSetDevice(current);
  return static_cast<int>(err);
}
