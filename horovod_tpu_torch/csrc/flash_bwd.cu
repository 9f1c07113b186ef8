// Flash-attention backward for Hopper (sm_90a) on bf16 wgmma fed by TMA,
// written by hand in CUDA C++.
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
// with the TPU kernels' roundings: the products take dO in the input dtype,
// P is rounded to bf16 before the dV product, dS to bf16 before the dK and
// dQ products, all products accumulate in fp32, sm_scale is applied to the
// fp32 sums. delta is computed, as _bwd_pallas computes it, from the
// cotangent as given (bf16 or fp32) and the forward's output, in fp32.
//
// Launch order and delta. The wrapper launches the dQ kernel, then the dK/dV
// kernel, on one stream. Each dQ block owns a tile of 128 query rows: its
// prologue reads the tile's O and given-dO rows once (the loads are issued
// before the wait for the tile's TMA, so the two latencies overlap),
// computes delta for them and writes it to an fp32 [B, H, Sq] scratch
// buffer, which the dK/dV kernel reads after it in stream order.
//
// Work split. One block = two consumer warpgroups of 64 rows and one
// producer warp. flash_bwd_dq_kernel: a block owns 128 queries of one
// (batch, head) and walks the key tiles (64 keys); flash_bwd_dkdv_kernel: a
// block owns 128 keys and walks the query tiles (64 queries at head dim 64,
// 32 at 128). All seven products are bf16 wgmma with fp32 accumulators in
// registers:
//
//   dK/dV: S^T = K Q^T, dP^T = V dO^T   (B = Q, dO K-major); dV += P^T dO,
//          dK += dS^T Q (A = P^T, dS^T from registers; B = dO, Q read
//          MN-major through the descriptor's transpose bit)
//   dQ:    S = Q K^T, dP = dO V^T       (K-major B); dQ += dS K (A = dS from
//          registers, B = K MN-major)
//
// The A operand of S^T and dP^T (K, V) and of S and dP (Q, dO) is a block
// constant: at head dim 64 each warp loads its fragments from the swizzled
// tile once and the products run with A in registers, so a 64-wide product
// reads only B from shared memory (with both operands there, an n64 k-step
// asks for 128 bytes a clock, all the bandwidth shared memory has); at 128
// it is read from shared memory, leaving the registers to the
// accumulators.
//
// The f32 accumulator fragment of one wgmma becomes the register A fragment
// of the next by packing pairs to bf16, so P^T and dS^T never leave
// registers, and no tile is ever transposed through shared memory: every
// operand is used in the layout TMA wrote it in.
//
// Loads. The producer warp keeps a ring of kStages shared-memory stages full
// with TMA (cp.async.bulk.tensor, 128B swizzle, completion on one mbarrier
// a stage); the consumers release a stage with one arrival a warp. Each
// operand is a strided [B, S, H, D] view (a column third of the fused QKV
// projection is read in place) described by a 4-D tensor map over (D, H,
// S, B) with the view's own strides, in boxes of 64 columns (one 128-byte
// swizzle row) x tile rows; at head dim 128 a row is two boxes. TMA's
// zero fill pads rows past S. The dK/dV kernel's producer also stages each
// query tile's lse, delta and g_lse rows (fp32) beside it. The tensor maps
// are encoded on the host through cuTensorMapEncodeTiled, reached with
// cudaGetDriverEntryPoint (no -lcuda), and passed as __grid_constant__
// parameters.
//
// The tile loops. A warpgroup's products and its elementwise work (exp2,
// dS, packing) wait on each other within a tile, and issuing a wgmma
// stalls while the tensor cores are busy, so the two consumer warpgroups
// must keep out of phase. The dK/dV kernel makes each query tile one
// elementwise phase (P^T and dS^T) and one issue phase (dV and dK of this
// tile, S^T and dP^T of the next), and its warpgroups take turns at the
// issue phase through two named barriers (FlashAttention-3's ping-pong):
// one computes while the other's products run. The dQ kernel keeps one
// warpgroup's P computation beside its own dP product instead (tile j + 1's
// S and dP are issued right after tile j's dQ product); staggering its
// warpgroups measured slower. A stage is released once the products
// reading it are done. Each pipelined loop sits inside one branch that
// also holds its first issue, and leaves before issuing past its last
// tile: where a path reaches a wgmma_wait with other groups in flight
// than the loop's, ptxas serialises every wgmma of the kernel (its
// advisory C7515). The dK/dV producer loads the next tile's row
// statistics before it waits for a free stage.
//
// Masks, the same predicates as the forward: causal on global positions
// q_offset / kv_offset, keys at or past kv_len, rows with lse = -inf. Query
// tiles wholly before a key tile in the causal order are skipped by the
// dK/dV kernel, key tiles wholly in a query tile's causal future, or at or
// past kv_len, by the dQ kernel (the tiles pallas_kernels.py:505-508 and
// :565-567 skip). The uneven causal work is scheduled heaviest first: dQ
// block 0 takes the last query tile, dK/dV block 0 the first key tile, and
// each tile index runs across every (batch, head) before the next. A tile
// wholly inside the mask (every key valid for every row of the warpgroup)
// takes no mask test at all (tested once a tile: a test inside the element
// loop compiled to a guarded branch around every element), the others a
// branch-free one, and a row without keys (lse = -inf, or past Sq) carries
// +inf in place of lse, so its exp2 (ex2.approx.ftz) is 0 without a test.
//
// Registers. A consumer thread holds its rows' accumulators: at head dim 128
// the dK and dV sums alone take 128 registers, so the dK/dV kernel streams
// query tiles of 32 there (S^T and dP^T 16 each); setmaxnreg gives the
// consumers 232 registers and the producer 40.
//
// What bounds it on an H100 SXM (data-sheet peaks at its 700 W limit: 3.35
// TB/s, 989 TFLOP/s dense bf16): at GPT-2 small's training shape (B=8,
// S=1024, H=12, D=64, causal) the causal half of the five products the
// gradient needs (S, dP, dV, dK, dQ; 6.45 GFLOP each) is 32 GFLOP, 0.0326 ms
// at the bf16 peak; reading q/k/v/out/dO/lse/g_lse once and writing
// dq/dk/dv moves about 101 MB, 0.030 ms: operations bound it. This design
// does seven products, since the dQ kernel recomputes S and dP, so its own
// floor is 0.046 ms. What it leaves on the table: the elementwise work
// still takes about as long as a tile's products, and in the dQ kernel
// the two warpgroups overlap it only as far as they fall out of phase; dQ
// accumulated in the dK/dV kernel with fp32 atomics (five products, but an
// order that changes from run to run); clusters sharing K/V or Q/dO tiles
// between blocks; a persistent grid overlapping one tile's epilogue with
// the next one's loads.

#include <cmath>

#include "sm90_common.cuh"

namespace {

constexpr int kConsumers = 2;                // consumer warpgroups
constexpr int kRows = 64 * kConsumers;       // queries per dQ block, keys per dK/dV block
constexpr int kThreads = (kConsumers + 1) * 128;
constexpr int kStages = 4;
constexpr int kBK = 64;                      // keys per tile the dQ kernel streams

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
  int batch, n_heads, sq, skv, kv_len, q_offset, kv_offset, causal;
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

__device__ __forceinline__ float dot8(const uint4& o, const float4& g0,
                                      const float4& g1) {
  const __nv_bfloat162* oe = reinterpret_cast<const __nv_bfloat162*>(&o);
  const float g[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 of = __bfloat1622float2(oe[i]);
    acc = fmaf(of.x, g[2 * i], acc);
    acc = fmaf(of.y, g[2 * i + 1], acc);
  }
  return acc;
}

// Half `half` of row r's O and dO (as given) for delta: loaded first, so
// their latency overlaps the query tile's TMA, and summed later in fp32.
template <int D, bool kGivenF32>
struct DeltaHalfRow {
  static constexpr int kHalf = D / 2;
  uint4 o[kHalf / 8];
  uint4 g[kGivenF32 ? kHalf / 4 : kHalf / 8];

  __device__ __forceinline__ void load(const Params& p, int b, int h, int r,
                                       int half) {
    const __nv_bfloat16* orow = p.out + b * p.o_sb + h * p.o_sh +
                                static_cast<long long>(r) * p.o_ss + half * kHalf;
    const long long g0 = b * p.g_sb + h * p.g_sh +
                         static_cast<long long>(r) * p.g_ss + half * kHalf;
    const uint4* gp =
        kGivenF32 ? reinterpret_cast<const uint4*>(
                        static_cast<const float*>(p.dout_given) + g0)
                  : reinterpret_cast<const uint4*>(
                        static_cast<const __nv_bfloat16*>(p.dout_given) + g0);
#pragma unroll
    for (int i = 0; i < kHalf / 8; ++i) o[i] = reinterpret_cast<const uint4*>(orow)[i];
#pragma unroll
    for (int i = 0; i < (kGivenF32 ? kHalf / 4 : kHalf / 8); ++i) g[i] = gp[i];
  }

  __device__ __forceinline__ float dot() const {
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < kHalf / 8; ++i) {
      if constexpr (kGivenF32) {
        const float4* gf = reinterpret_cast<const float4*>(g);
        acc += dot8(o[i], gf[2 * i], gf[2 * i + 1]);
      } else {
        acc += dot8(o[i], g[i]);
      }
    }
    return acc;
  }
};

template <int D>
struct DqSmem {
  static constexpr int kBoxes = D / 64;
  static constexpr int kQBox = kRows * kRowBytes;  // a box of the query tile
  static constexpr int kKBox = kBK * kRowBytes;    // a box of a key tile
  static constexpr int kStageBytes = 2 * kBoxes * kKBox;  // K and V
  static constexpr int kBytes = 2 * kBoxes * kQBox + kStages * kStageBytes +
                                (1 + 2 * kStages) * 8 + 1024;
};

// S = Q K^T and dP = dO V^T for the warpgroup's 64 rows against one key
// tile (sk, sv), each its own commit group. At head dim 64 the A operands
// are held in registers (qa_r, doa_r); at 128 they are read from shared
// memory (qa, doa), which leaves the registers to dQ's accumulators.
template <int D, bool kRegA, int KS>
__device__ __forceinline__ void issue_s_dp(float (&sacc)[32], float (&dp)[32],
                                           const uint32_t (&qa_r)[KS][4],
                                           const uint32_t (&doa_r)[KS][4],
                                           const uint8_t* qa, const uint8_t* doa,
                                           int qbox, const uint8_t* sk,
                                           const uint8_t* sv, int kbox) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint64_t db = desc_k(sk + (kk / 4) * kbox + (kk % 4) * 32);
    if constexpr (kRegA) {
      wgmma_rs<false>(sacc, qa_r[kk], db, kk > 0);
    } else {
      wgmma_ss(sacc, desc_k(qa + (kk / 4) * qbox + (kk % 4) * 32), db, kk > 0);
    }
  }
  wgmma_commit();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint64_t db = desc_k(sv + (kk / 4) * kbox + (kk % 4) * 32);
    if constexpr (kRegA) {
      wgmma_rs<false>(dp, doa_r[kk], db, kk > 0);
    } else {
      wgmma_ss(dp, desc_k(doa + (kk / 4) * qbox + (kk % 4) * 32), db, kk > 0);
    }
  }
  wgmma_commit();
}

template <int D, bool kGivenF32>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_kernel(const Params p, const __grid_constant__ CUtensorMap map_q,
                        const __grid_constant__ CUtensorMap map_do,
                        const __grid_constant__ CUtensorMap map_k,
                        const __grid_constant__ CUtensorMap map_v) {
  using S = DqSmem<D>;
  constexpr int kBoxes = S::kBoxes;
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
        tma_load(sQ + x * S::kQBox, &map_q, qbar, x * 64, blk.h, q0, blk.b);
        tma_load(sdO + x * S::kQBox, &map_do, qbar, x * 64, blk.h, q0, blk.b);
      }
      int s = 0;
      uint32_t phase = 0;
      for (int j = 0; j < n_tiles; ++j) {
        bar_wait(&empty[s], phase ^ 1);
        bar_expect_tx(&full[s], S::kStageBytes);
        uint8_t* sk = stages + s * S::kStageBytes;
        uint8_t* sv = sk + kBoxes * S::kKBox;
        for (int x = 0; x < kBoxes; ++x) {
          tma_load(sk + x * S::kKBox, &map_k, &full[s], x * 64, blk.h, j * kBK,
                   blk.b);
          tma_load(sv + x * S::kKBox, &map_v, &full[s], x * 64, blk.h, j * kBK,
                   blk.b);
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
    const int drow = row0 + lane / 2;
    DeltaHalfRow<D, kGivenF32> dl_in;
    if (drow < p.sq) dl_in.load(p, blk.b, blk.h, drow, lane & 1);
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

    float dq[kBoxes][32];
#pragma unroll
    for (int x = 0; x < kBoxes; ++x) {
#pragma unroll
      for (int i = 0; i < 32; ++i) dq[x][i] = 0.f;
    }
    float sacc[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sacc[i] = dp[i] = 0.f;
    uint32_t ds_a[kBK / 16][4];
    uint32_t q_a[kAS][4], do_a[kAS][4];
    const uint8_t* qa = sQ + wg * 64 * kRowBytes;
    const uint8_t* doa = sdO + wg * 64 * kRowBytes;

    if (n_tiles > 0) bar_wait(qbar, 0);
    {
      float dsum = drow < p.sq ? dl_in.dot() : 0.f;
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
          for (int i = 0; i < 32; ++i) {
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
        for (int i = 0; i < 32; ++i) {
          const int r = (i >> 1) & 1;
          dp[i] = sacc[i] * (dp[i] - delta[r]) + glse[r] * sacc[i];
        }
        pack_a<kBK / 16>(ds_a, dp);

        // dQ += dS K, K read MN-major.
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {
#pragma unroll
          for (int x = 0; x < kBoxes; ++x) {
            wgmma_rs<true>(dq[x], ds_a[kk],
                           desc_mn(sk + x * S::kKBox + kk * 16 * kRowBytes), 1);
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

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + g + 8 * r;
      if (row >= p.sq) continue;
      __nv_bfloat16* dqr = p.dq + blk.b * p.dq_sb + blk.h * p.dq_sh +
                           static_cast<long long>(row) * p.dq_ss;
#pragma unroll
      for (int x = 0; x < kBoxes; ++x) {
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          *reinterpret_cast<uint32_t*>(dqr + x * 64 + n * 8 + t * 2) =
              pack_bf16x2(dq[x][4 * n + 2 * r] * p.scale,
                          dq[x][4 * n + 2 * r + 1] * p.scale);
        }
      }
    }
  }
}

template <int D, int BQ>
struct DkdvSmem {
  static constexpr int kBoxes = D / 64;
  static constexpr int kKBox = kRows * kRowBytes;  // a box of the key tile
  static constexpr int kQBox = BQ * kRowBytes;     // a box of a query tile
  static constexpr int kStageBytes = 2 * kBoxes * kQBox;  // Q and dO
  static constexpr int kStatBytes = 3 * BQ * 4;            // lse, delta, g_lse
  static constexpr int kBytes = 2 * kBoxes * kKBox + kStages * kStageBytes +
                                kStages * kStatBytes + (1 + 2 * kStages) * 8 +
                                1024;
};

// S^T = K Q^T and dP^T = V dO^T for the warpgroup's 64 keys against one
// query tile (sq, sdo), each its own commit group. At head dim 64 the A
// operands K and V are held in registers (ka_r, va_r); at 128 they are read
// from shared memory (ka, va), which leaves the registers to dK's and dV's
// accumulators.
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
    const uint64_t db = desc_k(sq + (kk / 4) * qbox + (kk % 4) * 32);
    if constexpr (kRegA) {
      wgmma_rs<false>(st, ka_r[kk], db, kk > 0);
    } else {
      wgmma_ss(st, desc_k(ka + (kk / 4) * kbox + (kk % 4) * 32), db, kk > 0);
    }
  }
  wgmma_commit();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint64_t db = desc_k(sdo + (kk / 4) * qbox + (kk % 4) * 32);
    if constexpr (kRegA) {
      wgmma_rs<false>(dpt, va_r[kk], db, kk > 0);
    } else {
      wgmma_ss(dpt, desc_k(va + (kk / 4) * kbox + (kk % 4) * 32), db, kk > 0);
    }
  }
  wgmma_commit();
}

template <int D, int BQ>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkdv_kernel(const Params p, const __grid_constant__ CUtensorMap map_q,
                          const __grid_constant__ CUtensorMap map_do,
                          const __grid_constant__ CUtensorMap map_k,
                          const __grid_constant__ CUtensorMap map_v) {
  using S = DkdvSmem<D, BQ>;
  constexpr int kBoxes = S::kBoxes;
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
  const int k0 = blk.tile * kRows;
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
          tma_load(sK + x * S::kKBox, &map_k, kvbar, x * 64, blk.h, k0, blk.b);
          tma_load(sV + x * S::kKBox, &map_v, kvbar, x * 64, blk.h, k0, blk.b);
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
            tma_load(sq + x * S::kQBox, &map_q, &full[s], x * 64, blk.h, q0, blk.b);
            tma_load(sdo + x * S::kQBox, &map_do, &full[s], x * 64, blk.h, q0,
                     blk.b);
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
    const int wkey0 = k0 + wg * 64;     // the warpgroup's 64 keys
    const int key0 = wkey0 + warp * 16;  // the warp's 16
    const int key[2] = {key0 + g, key0 + g + 8};

    float dk[kBoxes][32], dv[kBoxes][32];
#pragma unroll
    for (int x = 0; x < kBoxes; ++x) {
#pragma unroll
      for (int i = 0; i < 32; ++i) dk[x][i] = dv[x][i] = 0.f;
    }
    float st[BQ / 2], dpt[BQ / 2];
#pragma unroll
    for (int i = 0; i < BQ / 2; ++i) st[i] = dpt[i] = 0.f;
    uint32_t p_a[BQ / 16][4], ds_a[BQ / 16][4];
    uint32_t k_a[kAS][4], v_a[kAS][4];
    const uint8_t* ka = sK + wg * 64 * kRowBytes;
    const uint8_t* va = sV + wg * 64 * kRowBytes;

    // Each tile is one elementwise phase (P^T and dS^T from the S^T and
    // dP^T the previous phase issued) and one issue phase (dV and dK of
    // this tile, S^T and dP^T of the next); the warpgroups take turns at
    // issuing. A stage is released once the products reading it are done.
    if (qt_end > qt_begin) {
      bar_wait(kvbar, 0);
      if constexpr (kRegA) {
        load_a(k_a, sK, S::kKBox, wg * 64 + warp * 16, lane);
        load_a(v_a, sV, S::kKBox, wg * 64 + warp * 16, lane);
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
        for (int x = 0; x < kBoxes; ++x) {
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

        // dV += P^T dO and dK += dS^T Q (dO and Q read MN-major), then the
        // next tile's S^T and dP^T.
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
          for (int x = 0; x < kBoxes; ++x) {
            wgmma_rs<true>(dv[x], p_a[kk],
                           desc_mn(sdo + x * S::kQBox + kk * 16 * kRowBytes), 1);
          }
        }
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk) {
#pragma unroll
          for (int x = 0; x < kBoxes; ++x) {
            wgmma_rs<true>(dk[x], ds_a[kk],
                           desc_mn(sq + x * S::kQBox + kk * 16 * kRowBytes), 1);
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
    for (int x = 0; x < kBoxes; ++x) {
      fence_regs(dk[x]);
      fence_regs(dv[x]);
    }
    fence_regs(p_a);
    fence_regs(ds_a);

    // Every key below skv gets its row, zero where no query saw it.
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (key[r] >= p.skv) continue;
      const long long kr = key[r];
      __nv_bfloat16* dkr = p.dk + blk.b * p.dk_sb + blk.h * p.dk_sh + kr * p.dk_ss;
      __nv_bfloat16* dvr = p.dv + blk.b * p.dv_sb + blk.h * p.dv_sh + kr * p.dv_ss;
#pragma unroll
      for (int x = 0; x < kBoxes; ++x) {
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const int col = x * 64 + n * 8 + t * 2;
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

template <int D, bool kGivenF32>
cudaError_t launch_dq(const Params& p, const CUtensorMap* maps,
                      cudaStream_t stream) {
  static std::atomic<uint64_t> done{0};
  constexpr int kSmem = DqSmem<D>::kBytes;
  const cudaError_t err = opt_in(flash_bwd_dq_kernel<D, kGivenF32>, kSmem, done);
  if (err != cudaSuccess) return err;
  const unsigned blocks = static_cast<unsigned>(p.row_tiles) * p.batch * p.n_heads;
  flash_bwd_dq_kernel<D, kGivenF32><<<blocks, kThreads, kSmem, stream>>>(
      p, maps[0], maps[1], maps[2], maps[3]);
  return cudaGetLastError();
}

template <int D, int BQ>
cudaError_t launch_dkdv(const Params& p, const CUtensorMap* maps,
                        cudaStream_t stream) {
  static std::atomic<uint64_t> done{0};
  constexpr int kSmem = DkdvSmem<D, BQ>::kBytes;
  const cudaError_t err = opt_in(flash_bwd_dkdv_kernel<D, BQ>, kSmem, done);
  if (err != cudaSuccess) return err;
  const unsigned blocks = static_cast<unsigned>(p.row_tiles) * p.batch * p.n_heads;
  flash_bwd_dkdv_kernel<D, BQ><<<blocks, kThreads, kSmem, stream>>>(
      p, maps[0], maps[1], maps[2], maps[3]);
  return cudaGetLastError();
}

// Strides: 27 in elements, (batch, seq, head) of q, k, v, dO (the bf16
// operand of the products), dq, dk, dv, out, and the cotangent as given.
Params make_params(const void* out, const void* dout_given, const void* lse,
                   const void* glse, void* delta, void* dq, void* dk, void* dv,
                   int batch, int n_heads, int sq, int skv,
                   const long long* st, int kv_len, int q_offset,
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
  p.kv_len = kv_len;
  p.q_offset = q_offset;
  p.kv_offset = kv_offset;
  p.causal = causal;
  p.row_tiles = 0;
  p.scale = sm_scale;
  p.scale_log2 = sm_scale * kLog2e;
  return p;
}

// q, dO (query rows of `q_rows`) and k, v (key rows of `k_rows`) maps.
bool make_maps(CUtensorMap (&maps)[4], const void* q, const void* k,
               const void* v, const void* dout, int batch, int n_heads, int sq,
               int skv, int d, const long long* st, int q_rows, int k_rows) {
  return make_map(&maps[0], q, batch, sq, n_heads, d, st + 0, q_rows) &&
         make_map(&maps[1], dout, batch, sq, n_heads, d, st + 9, q_rows) &&
         make_map(&maps[2], k, batch, skv, n_heads, d, st + 3, k_rows) &&
         make_map(&maps[3], v, batch, skv, n_heads, d, st + 6, k_rows);
}

}  // namespace

// Plain C entry points for ctypes, each launching one kernel on `stream` of
// `device` (the calling thread's current device is restored) and returning
// a cudaError_t (0 on a successful launch;
// cudaErrorInvalidValue when a tensor map is refused). q, k, v, dout are
// bf16 with 16-byte aligned rows and strides (TMA's rule); glse may be null
// (zero cotangent of lse). Launch the dQ kernel first: it writes delta
// ([B, H, Sq] fp32), which the dK/dV kernel reads.
extern "C" int hvt_flash_bwd_dq_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const void* out, const void* dout_given, int given_f32, const void* lse,
    const void* glse, void* delta, void* dq, int batch, int n_heads, int sq,
    int skv, int head_dim, const long long* strides, int kv_len, int q_offset,
    int kv_offset, float sm_scale, int causal, int device, void* stream) {
  Params p = make_params(out, dout_given, lse, glse, delta, dq, nullptr,
                         nullptr, batch, n_heads, sq, skv, strides, kv_len,
                         q_offset, kv_offset, sm_scale, causal);
  p.row_tiles = (sq + kRows - 1) / kRows;
  if ((head_dim != 64 && head_dim != 128) ||
      !grid_fits(p.row_tiles, batch, n_heads)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int current = 0;
  cudaError_t err = bind_device(device, &current);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap maps[4];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!make_maps(maps, q, k, v, dout, batch, n_heads, sq, skv, head_dim,
                 strides, kRows, kBK)) {
    err = cudaErrorInvalidValue;
  } else if (head_dim == 64) {
    err = given_f32 ? launch_dq<64, true>(p, maps, s)
                    : launch_dq<64, false>(p, maps, s);
  } else {
    err = given_f32 ? launch_dq<128, true>(p, maps, s)
                    : launch_dq<128, false>(p, maps, s);
  }
  if (current != device) cudaSetDevice(current);
  return static_cast<int>(err);
}

extern "C" int hvt_flash_bwd_dkdv_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* glse, void* dk, void* dv,
    int batch, int n_heads, int sq, int skv, int head_dim,
    const long long* strides, int kv_len, int q_offset, int kv_offset,
    float sm_scale, int causal, int device, void* stream) {
  Params p = make_params(nullptr, nullptr, lse, glse, const_cast<void*>(delta),
                         nullptr, dk, dv, batch, n_heads, sq, skv, strides,
                         kv_len, q_offset, kv_offset, sm_scale, causal);
  p.row_tiles = (skv + kRows - 1) / kRows;
  const int bq = head_dim == 64 ? 64 : 32;
  if ((head_dim != 64 && head_dim != 128) ||
      !grid_fits(p.row_tiles, batch, n_heads)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int current = 0;
  cudaError_t err = bind_device(device, &current);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap maps[4];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!make_maps(maps, q, k, v, dout, batch, n_heads, sq, skv, head_dim,
                 strides, bq, kRows)) {
    err = cudaErrorInvalidValue;
  } else {
    err = head_dim == 64 ? launch_dkdv<64, 64>(p, maps, s)
                         : launch_dkdv<128, 32>(p, maps, s);
  }
  if (current != device) cudaSetDevice(current);
  return static_cast<int>(err);
}
