// Flash-attention forward for Hopper (sm_90a) on bf16 wgmma fed by TMA,
// written by hand in CUDA C++.
//
// Replaces horovod_tpu/ops/pallas_kernels.py::_fwd_kernel, the Pallas TPU
// kernel behind flash_attention / flash_attention_with_lse. It computes the
// same function: blockwise online-softmax attention with fp32 scores and
// softmax statistics, a causal mask on global positions (q_offset /
// kv_offset), keys at or past kv_len masked out, p rounded to bf16 before
// the PV product (fp32 accumulation), rows with no valid key giving out = 0
// and lse = -inf, out rounded once to bf16 and lse (natural log) in fp32
// [B, H, Sq].
//
// Work split. One block = two consumer warpgroups and one producer warp. A
// work item is 128 query rows of one (batch, head), 64 a warpgroup; the
// item walks the key tiles of 128 keys. The grid is persistent (one block an
// SM, at most one a work item), and each block loops over its items, so the
// producer loads the next item's query tile and first key tiles while the
// consumers finish the current one. Both products are bf16 wgmma with fp32
// accumulators in registers:
//
//   S = Q K^T   m64n128k16, B = the K tile K-major; A = Q from registers at
//               head dim 64 (each warp loads its fragments from the
//               swizzled tile once), from shared memory at 128
//   O += P V    m64n64k16 a 64-column box of V, A = P from registers, B =
//               the V tile read MN-major through the descriptor's
//               transpose bit
//
// The S accumulator becomes P's register A fragments by packing pairs to
// bf16 (pack_a), so P never leaves registers, and V is used in the layout
// TMA wrote it in: nothing is transposed through shared memory.
//
// Loads. The producer keeps a ring of kStages shared-memory stages (K and V
// of one tile each) full with TMA (128B swizzle, completion on one mbarrier
// a stage), running on across items; the consumers release a stage with one
// arrival a warp once the PV product reading it is done. An item's query
// tile is loaded once, into one of two tile buffers that alternate between
// items; the consumers release it after the item's epilogue, which stages
// its output there. Each operand is a strided [B, S, H, D] view (a column
// third of the fused QKV projection is read in place) described by a 4-D
// tensor map over (D, H, S, B) with the view's own strides, in boxes of 64
// columns (one 128-byte swizzle row) x 128 rows; at head dim 128 a row is
// two boxes. TMA's zero fill pads rows past S. The maps are encoded on the
// host (sm90_common.cuh).
//
// The tile loop (FlashAttention-3's intra-warpgroup pipelining and its
// ping-pong): tile j + 1's S product is issued, then tile j's PV product;
// the warpgroup waits for S alone and runs the softmax of tile j + 1 (max,
// exp2, row sums) while the tensor cores work on PV, then waits for PV,
// rescales O by exp2(m_old - m_new) and packs P of tile j + 1. The two
// warpgroups take turns at issuing through two named barriers, so one
// computes its softmax while the other's products run. The loop sits inside
// one branch with its first issue and leaves before issuing past its last
// tile, and an accumulator is read or written only after a wgmma_wait that
// covers it (where a path breaks either rule, ptxas serialises every wgmma
// of the kernel: its advisories C7514/C7515).
//
// Softmax. Scores are scaled by sm_scale * log2(e) and exponentiated with
// ex2.approx.ftz; with sm_scale > 0 (the host picks the instantiation) the
// row max is taken on the raw scores and the scale folds into the
// exponent's FMA, one instruction less an element. A tile wholly inside the mask (every key valid for every
// row of the warpgroup) takes no mask test (tested once a tile); the others
// a branch-free one. A row whose running max is still -inf exponentiates
// against 0, so its masked entries give exactly 0 and its rescale factor 0.
// The row sum adds the unrounded p, as the TPU kernel does.
//
// Masks and scheduling. Key tiles wholly in the causal future of the query
// tile, or at or past kv_len, are never loaded (pallas_kernels.py:188-191
// skips the same tiles); an item with no valid key loads nothing and writes
// zeros and -inf. The uneven causal work runs heaviest first: items are
// ordered from the last query tile, each tile index across every (batch,
// head) before the next, and dealt to the blocks in rounds that run
// alternately forwards and backwards, which evens out the blocks' loads.
//
// Epilogue. out = O / l in fp32, rounded once to bf16 and staged through the
// warpgroup's own rows of the item's (no longer read) query tile, swizzled
// so the fragment stores are conflict-free, then written with 16-byte
// stores guarded at Sq; lse = (m + log2 l) ln 2.
//
// Registers. A consumer thread holds S (64 fp32), O (32 at head dim 64, 64
// at 128), P (32) and at head dim 64 Q's fragments (16); setmaxnreg gives
// the consumers 232 registers and the producer 40.
//
// What bounds it on an H100 SXM (data-sheet peaks at its 700 W limit: 3.35
// TB/s of HBM3, 989 TFLOP/s dense bf16): at GPT-2 small's shape (B=8,
// S=1024, H=12, D=64, causal) the causal half of the two products is 12.9
// GFLOP (0.013 ms at the bf16 peak) and reading q/k/v once plus writing out
// and lse moves about 50 MB (0.015 ms at 3.35 TB/s): bytes bound it. Inside
// a block the exp2 work is the other floor: at head dim 64 a 128 x 128 tile
// takes as many MUFU clocks as its two products take tensor-core clocks.
// What it leaves on the table: the diagonal tile's masked half (a
// warpgroup computes all 128 keys of it), the exp2 work itself (MUFU-bound
// at head dim 64), no clusters sharing K/V tiles between the items of one
// (batch, head).

#include <cmath>

#include "sm90_common.cuh"

namespace {

constexpr int kConsumers = 2;                // consumer warpgroups
constexpr int kRows = 64 * kConsumers;       // query rows per work item
constexpr int kThreads = (kConsumers + 1) * 128;
constexpr int kBN = 128;                     // keys per K/V tile
constexpr float kLn2 = 0.6931471805599453f;

struct Params {
  __nv_bfloat16* o;
  float* lse;  // [B, H, Sq]
  long long o_sb, o_ss, o_sh;
  int batch, n_heads, sq, kv_len, q_offset, kv_offset, causal;
  int row_tiles;     // query tiles of kRows
  int items;         // work items: row_tiles * batch * n_heads
  float scale_log2;  // sm_scale * log2(e): the softmax runs on exp2
};

template <int D>
struct FwdSmem {
  static constexpr int kBoxes = D / 64;
  static constexpr int kStages = D == 64 ? 4 : 2;
  static constexpr int kQBox = kRows * kRowBytes;  // a box of the query tile
  static constexpr int kKBox = kBN * kRowBytes;    // a box of a key tile
  static constexpr int kStageBytes = 2 * kBoxes * kKBox;  // K and V
  static constexpr int kBytes = 2 * kBoxes * kQBox + kStages * kStageBytes +
                                (4 + 2 * kStages) * 8 + 1024;
};

// S = Q K^T for the warpgroup's 64 rows against one key tile, one commit
// group. At head dim 64 A is held in registers (qa_r); at 128 it is read
// from shared memory (qa).
template <int D, bool kRegA, int KS>
__device__ __forceinline__ void issue_s(float (&s)[64], const uint32_t (&qa_r)[KS][4],
                                        const uint8_t* qa, int qbox,
                                        const uint8_t* sk, int kbox) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint64_t db = desc_k(sk + (kk / 4) * kbox + (kk % 4) * 32);
    if constexpr (kRegA) {
      wgmma_rs<false>(s, qa_r[kk], db, kk > 0);
    } else {
      wgmma_ss(s, desc_k(qa + (kk / 4) * qbox + (kk % 4) * 32), db, kk > 0);
    }
  }
  wgmma_commit();
}

// O += P V for one key tile, V read MN-major, one commit group.
template <int kBoxes>
__device__ __forceinline__ void issue_pv(float (&o)[kBoxes][32],
                                         const uint32_t (&p_a)[kBN / 16][4],
                                         const uint8_t* sv, int kbox) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk) {
#pragma unroll
    for (int x = 0; x < kBoxes; ++x) {
      wgmma_rs<true>(o[x], p_a[kk], desc_mn(sv + x * kbox + kk * 16 * kRowBytes), 1);
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
template <bool kFold>
__device__ __forceinline__ void softmax_tile(float (&s)[64], const Params& p,
                                             int k0, bool inside,
                                             const int (&qpos)[2], int t,
                                             float (&m)[2], float (&l)[2],
                                             float (&corr)[2]) {
  const float scale = p.scale_log2;
  if (!inside) {
    const int kv_len = p.kv_len;
    const bool causal = p.causal;
#pragma unroll
    for (int n = 0; n < kBN / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + n * 8 + t * 2 + (e & 1);
        const bool ok = (col < kv_len) & (!causal | (qpos[e >> 1] - p.kv_offset >= col));
        s[4 * n + e] = ok ? (kFold ? s[4 * n + e] : s[4 * n + e] * scale) : -INFINITY;
      }
    }
  } else if (!kFold) {
#pragma unroll
    for (int i = 0; i < 64; ++i) s[i] *= scale;
  }
  float mx[2] = {kFold ? -INFINITY : m[0], kFold ? -INFINITY : m[1]};
#pragma unroll
  for (int i = 0; i < 64; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
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
  for (int i = 0; i < 64; ++i) {
    const int r = (i >> 1) & 1;
    s[i] = ex2(kFold ? fmaf(s[i], scale, -m_use[r]) : s[i] - m_use[r]);
    l[r] += s[i];
  }
}

// Key tiles [0, n) can hold a valid key for some row of the query tile at
// q0: none past kv_len and, with the causal mask, none wholly in the tile's
// future.
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

template <int D, bool kFold>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_kernel(const Params p, const __grid_constant__ CUtensorMap map_q,
                     const __grid_constant__ CUtensorMap map_k,
                     const __grid_constant__ CUtensorMap map_v) {
  using S = FwdSmem<D>;
  constexpr int kBoxes = S::kBoxes;
  constexpr int kStages = S::kStages;
  constexpr int kQBytes = kBoxes * S::kQBox;
  constexpr bool kRegA = D == 64;
  constexpr int kAS = kRegA ? D / 16 : 1;  // register A k-steps
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* sQ2 = align1024(smem_raw);  // two query tiles, alternate items
  uint8_t* stages = sQ2 + 2 * kQBytes;
  uint64_t* qfull = reinterpret_cast<uint64_t*>(stages + kStages * S::kStageBytes);
  uint64_t* qempty = qfull + 2;
  uint64_t* full = qempty + 2;
  uint64_t* empty = full + kStages;

  if (threadIdx.x == 0) {
    for (int x = 0; x < 2; ++x) {
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
    // query tile (into the tile buffer its item before last released) and
    // keeping the ring of key tiles full across items.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == kConsumers * 128) {
      int s = 0;
      uint32_t phase = 0;
      for (int r = 0, n = 0;; ++r, ++n) {
        const unsigned w = item_index(r, bi, g_blocks);
        if (w >= static_cast<unsigned>(p.items)) break;
        const Block blk = block_of(p, true, w);
        const int q0 = blk.tile * kRows;
        const int n_tiles = kv_tiles(p, q0);
        const int qb = n & 1;
        bar_wait(&qempty[qb], ((n >> 1) & 1) ^ 1);
        uint8_t* sQ = sQ2 + qb * kQBytes;
        if (n_tiles > 0) {
          bar_expect_tx(&qfull[qb], kQBytes);
          for (int x = 0; x < kBoxes; ++x) {
            tma_load(sQ + x * S::kQBox, &map_q, &qfull[qb], x * 64, blk.h, q0, blk.b);
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
            tma_load(sk + x * S::kKBox, &map_k, &full[s], x * 64, blk.h, j * kBN, blk.b);
            tma_load(sv + x * S::kKBox, &map_v, &full[s], x * 64, blk.h, j * kBN, blk.b);
          }
          if (++s == kStages) {
            s = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
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
      const int n_tiles = kv_tiles(p, q0);
      const int qb = n & 1;
      uint8_t* sQ = sQ2 + qb * kQBytes;
      const int wrow0 = q0 + wg * 64;      // the warpgroup's 64 rows
      const int row0 = wrow0 + warp * 16;  // the warp's 16
      const int qpos[2] = {p.q_offset + row0 + g, p.q_offset + row0 + g + 8};
      // Every key of a tile from k0 is valid for every row of the warpgroup.
      auto inside = [&](int k0) {
        return k0 + kBN <= p.kv_len &&
               (!p.causal || p.q_offset + wrow0 >= p.kv_offset + k0 + kBN - 1);
      };

      float o[kBoxes][32];
#pragma unroll
      for (int x = 0; x < kBoxes; ++x) {
#pragma unroll
        for (int i = 0; i < 32; ++i) o[x][i] = 0.f;
      }
      float sacc[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) sacc[i] = 0.f;
      uint32_t p_a[kBN / 16][4];
      uint32_t q_a[kAS][4];
      // Rows g and g + 8 of the warp's 16: the running max (log2 domain)
      // and this thread's partial row sums; the quad's partials are added
      // at the end.
      float m[2] = {-INFINITY, -INFINITY};
      float l[2] = {0.f, 0.f};
      float corr[2];
      const uint8_t* qa = sQ + wg * 64 * kRowBytes;
      // Releases the ring stage of the tile whose PV product just finished.
      auto release = [&]() {
        __syncwarp();
        if (lane == 0) bar_arrive(&empty[s]);
        if (++s == kStages) {
          s = 0;
          phase ^= 1;
        }
      };

      bar_wait(&qfull[qb], (n >> 1) & 1);
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
            issue_pv<kBoxes>(o, p_a, sv, S::kKBox);
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
          issue_pv<kBoxes>(o, p_a, sv, S::kKBox);
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
            for (int i = 0; i < 32; ++i) o[x][i] *= corr[(i >> 1) & 1];
          }
          pack_a<kBN / 16>(p_a, sacc);
        }
      }
#pragma unroll
      for (int x = 0; x < kBoxes; ++x) fence_regs(o[x]);
      fence_regs(p_a);

      // out = O / l, rounded once to bf16, staged through the warpgroup's
      // own rows of the item's query tile (no longer read; 16-byte unit u
      // of row r at u ^ (r % 8), so a warp's fragment stores hit distinct
      // banks), then 16-byte stores; then the tile buffer is released.
      float inv[2];
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 1);
        l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 2);
        inv[rr] = l[rr] > 0.f ? 1.f / l[rr] : 0.f;
      }
      uint8_t* so = sQ + wg * 64 * kRowBytes;
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int row = warp * 16 + g + 8 * rr;
#pragma unroll
        for (int x = 0; x < kBoxes; ++x) {
#pragma unroll
          for (int c = 0; c < 8; ++c) {
            *reinterpret_cast<uint32_t*>(so + x * S::kQBox + row * kRowBytes +
                                         ((c ^ (row & 7)) << 4) + 4 * t) =
                pack_bf16x2(o[x][4 * c + 2 * rr] * inv[rr],
                            o[x][4 * c + 2 * rr + 1] * inv[rr]);
          }
        }
      }
      asm volatile("bar.sync %0, 128;\n" ::"r"(3 + wg) : "memory");
      __nv_bfloat16* ob = p.o + blk.b * p.o_sb + blk.h * p.o_sh;
      const int tid = threadIdx.x & 127;
#pragma unroll
      for (int it = 0; it < 4 * kBoxes; ++it) {
        const int i = it * 128 + tid;  // a row's 16-byte units on neighbouring threads
        const int row = i / (8 * kBoxes);
        const int x = (i / 8) % kBoxes;
        const int u = i % 8;
        const int grow = wrow0 + row;
        if (grow < p.sq) {
          *reinterpret_cast<uint4*>(ob + static_cast<long long>(grow) * p.o_ss + x * 64 +
                                    u * 8) =
              *reinterpret_cast<const uint4*>(so + x * S::kQBox + row * kRowBytes +
                                              ((u ^ (row & 7)) << 4));
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
  const cudaError_t err = opt_in(flash_fwd_kernel<D, kFold>, kSmem, done);
  if (err != cudaSuccess) return err;
  const int sms = sm_count();
  if (sms <= 0) return cudaErrorInvalidDevice;
  const unsigned blocks = static_cast<unsigned>(min(p.items, sms));
  flash_fwd_kernel<D, kFold><<<blocks, kThreads, kSmem, stream>>>(
      p, maps[0], maps[1], maps[2]);
  return cudaGetLastError();
}

int launch_on(const Params& p, const CUtensorMap* maps, int head_dim,
              cudaStream_t s) {
  const bool fold = p.scale_log2 > 0.f;
  cudaError_t err;
  if (head_dim == 64) {
    err = fold ? launch<64, true>(p, maps, s) : launch<64, false>(p, maps, s);
  } else {
    err = fold ? launch<128, true>(p, maps, s) : launch<128, false>(p, maps, s);
  }
  return static_cast<int>(err);
}

}  // namespace

// Plain C entry point for ctypes: launches the kernel on `stream` of
// `device` (the calling thread's current device is restored) and returns a
// cudaError_t (0 on a successful launch; cudaErrorInvalidValue when a
// tensor map is refused). q, k, v are bf16 with 16-byte aligned rows and
// strides (TMA's rule); strides: 12 in elements, (batch, seq, head) of q,
// k, v and out, with unit stride along the head dim.
extern "C" int hvt_flash_fwd_bf16(
    const void* q, const void* k, const void* v, void* out, void* lse,
    int batch, int n_heads, int sq, int skv, int head_dim,
    const long long* strides, int kv_len, int q_offset, int kv_offset,
    float sm_scale, int causal, int device, void* stream) {
  Params p;
  p.o = static_cast<__nv_bfloat16*>(out);
  p.lse = static_cast<float*>(lse);
  p.o_sb = strides[9];
  p.o_ss = strides[10];
  p.o_sh = strides[11];
  p.batch = batch;
  p.n_heads = n_heads;
  p.sq = sq;
  p.kv_len = kv_len;
  p.q_offset = q_offset;
  p.kv_offset = kv_offset;
  p.causal = causal;
  p.row_tiles = (sq + kRows - 1) / kRows;
  p.items = static_cast<int>(static_cast<long long>(p.row_tiles) * batch *
                             n_heads);  // grid_fits bounds it
  p.scale_log2 = sm_scale * kLog2e;
  if ((head_dim != 64 && head_dim != 128) ||
      !grid_fits(p.row_tiles, batch, n_heads)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int current = 0;
  const cudaError_t err = bind_device(device, &current);
  if (err != cudaSuccess) return static_cast<int>(err);
  // With no valid key no block loads anything: the maps stay unencoded
  // (and K/V may have no rows at all).
  CUtensorMap maps[3] = {};
  int rc = static_cast<int>(cudaErrorInvalidValue);
  if (kv_len <= 0 ||
      (make_map(&maps[0], q, batch, sq, n_heads, head_dim, strides + 0, kRows) &&
       make_map(&maps[1], k, batch, skv, n_heads, head_dim, strides + 3, kBN) &&
       make_map(&maps[2], v, batch, skv, n_heads, head_dim, strides + 6, kBN))) {
    rc = launch_on(p, maps, head_dim, static_cast<cudaStream_t>(stream));
  }
  if (current != device) cudaSetDevice(current);
  return rc;
}
