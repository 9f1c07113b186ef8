// Design variants of the flash-attention forward, for timing only (never
// built by the package): the non-persistent form of
// horovod_tpu_torch/csrc/flash_fwd.cu -- one block a 128-row query tile
// of one (batch, head), grid (tiles x batch x heads) heaviest first, the
// same producer warp, TMA ring, S = Q K^T m64n128 and O += P V with V read
// MN-major -- with two compile-time switches:
//
//   -DPP=1    the consumer warpgroups take turns at wgmma issue through two
//             named barriers (ping-pong); PP=0: intra-warpgroup overlap only
//   -DFOLD=1  the row max on the raw scores and sm_scale folded into exp2's
//             FMA (assumes sm_scale > 0); FOLD=0: scores scaled first
//
// Its C entry point has the package's earlier signature (no device
// argument). experiments/flash_fwd/bench.py builds and times it.

#include <cmath>

#include "../../horovod_tpu_torch/csrc/sm90_common.cuh"
#ifndef PP
#define PP 0
#endif
#ifndef FOLD
#define FOLD 0
#endif

namespace {

constexpr int kConsumers = 2;                // consumer warpgroups
constexpr int kRows = 64 * kConsumers;       // query rows per block
constexpr int kThreads = (kConsumers + 1) * 128;
constexpr int kBN = 128;                     // keys per K/V tile
constexpr float kLn2 = 0.6931471805599453f;

struct Params {
  __nv_bfloat16* o;
  float* lse;  // [B, H, Sq]
  long long o_sb, o_ss, o_sh;
  int batch, n_heads, sq, skv, kv_len, q_offset, kv_offset, causal;
  int row_tiles;     // query tiles of kRows
  float scale_log2;  // sm_scale * log2(e): the softmax runs on exp2
};

template <int D>
struct FwdSmem {
  static constexpr int kBoxes = D / 64;
  static constexpr int kStages = D == 64 ? 4 : 2;
  static constexpr int kQBox = kRows * kRowBytes;  // a box of the query tile
  static constexpr int kKBox = kBN * kRowBytes;    // a box of a key tile
  static constexpr int kStageBytes = 2 * kBoxes * kKBox;  // K and V
  static constexpr int kBytes = kBoxes * kQBox + kStages * kStageBytes +
                                (1 + 2 * kStages) * 8 + 1024;
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
// its pair (g, g + 8), column k0 + 8 (i / 4) + 2 t + (i & 1).
__device__ __forceinline__ void softmax_tile(float (&s)[64], const Params& p,
                                             int k0, bool inside,
                                             const int (&qpos)[2], int t,
                                             float (&m)[2], float (&l)[2],
                                             float (&corr)[2]) {
#if FOLD
  if (!inside) {
#else
  if (inside) {
#pragma unroll
    for (int i = 0; i < 64; ++i) s[i] *= p.scale_log2;
  } else {
#endif
    const int kv_len = p.kv_len;
    const bool causal = p.causal;
#pragma unroll
    for (int n = 0; n < kBN / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + n * 8 + t * 2 + (e & 1);
        const bool ok = (col < kv_len) & (!causal | (qpos[e >> 1] - p.kv_offset >= col));
#if FOLD
        s[4 * n + e] = ok ? s[4 * n + e] : -INFINITY;
#else
        s[4 * n + e] = ok ? s[4 * n + e] * p.scale_log2 : -INFINITY;
#endif
      }
    }
  }
#if FOLD
  float mx[2] = {-INFINITY, -INFINITY};
#else
  float mx[2] = {m[0], m[1]};
#endif
#pragma unroll
  for (int i = 0; i < 64; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
  float m_use[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
#if FOLD
    mx[r] = fmaxf(mx[r] * p.scale_log2, m[r]);
#endif
    m_use[r] = mx[r] == -INFINITY ? 0.f : mx[r];
    corr[r] = ex2(m[r] - m_use[r]);
    m[r] = mx[r];
    l[r] *= corr[r];
  }
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int r = (i >> 1) & 1;
#if FOLD
    s[i] = ex2(fmaf(s[i], p.scale_log2, -m_use[r]));
#else
    s[i] = ex2(s[i] - m_use[r]);
#endif
    l[r] += s[i];
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_kernel(const Params p, const __grid_constant__ CUtensorMap map_q,
                     const __grid_constant__ CUtensorMap map_k,
                     const __grid_constant__ CUtensorMap map_v) {
  using S = FwdSmem<D>;
  constexpr int kBoxes = S::kBoxes;
  constexpr int kStages = S::kStages;
  constexpr bool kRegA = D == 64;
  constexpr int kAS = kRegA ? D / 16 : 1;  // register A k-steps
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* sQ = align1024(smem_raw);
  uint8_t* stages = sQ + kBoxes * S::kQBox;
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
  const int n_tiles = (kv_end + kBN - 1) / kBN;

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
      bar_expect_tx(qbar, kBoxes * S::kQBox);
      for (int x = 0; x < kBoxes; ++x) {
        tma_load(sQ + x * S::kQBox, &map_q, qbar, x * 64, blk.h, q0, blk.b);
      }
      int s = 0;
      uint32_t phase = 0;
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
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int lane = threadIdx.x & 31;
    const int warp = (threadIdx.x / 32) & 3;
    const int g = lane >> 2;
    const int t = lane & 3;
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
    // Rows g and g + 8 of the warp's 16: the running max (log2 domain) and
    // this thread's partial row sums; the quad's partials are added at the
    // end.
    float m[2] = {-INFINITY, -INFINITY};
    float l[2] = {0.f, 0.f};
    float corr[2];
    const uint8_t* qa = sQ + wg * 64 * kRowBytes;

    if (n_tiles > 0) {
      bar_wait(qbar, 0);
      if constexpr (kRegA) load_a(q_a, sQ, S::kQBox, wg * 64 + warp * 16, lane);
#if PP
      if (wg == 1) turn_pass(wg);
#endif
      bar_wait(&full[0], 0);
#if PP
      turn_wait(wg);
#endif
      issue_s<D, kRegA>(sacc, q_a, qa, S::kQBox, stages, S::kKBox);
#if PP
      turn_pass(wg);
#endif
      wgmma_wait<0>();
      fence_regs(sacc);
      softmax_tile(sacc, p, 0, inside(0), qpos, t, m, l, corr);
      pack_a<kBN / 16>(p_a, sacc);
      int s = 0;
      uint32_t phase = 0;
      for (int j = 0;; ++j) {
        const uint8_t* sv = stages + s * S::kStageBytes + kBoxes * S::kKBox;
        if (j + 1 == n_tiles) {
#if PP
          turn_wait(wg);
#endif
          issue_pv<kBoxes>(o, p_a, sv, S::kKBox);
#if PP
          turn_pass(wg);
#endif
          wgmma_wait<0>();
#if PP
          if (wg == 0) turn_wait(wg);
#endif
          break;
        }
        int ns = s + 1;
        uint32_t nphase = phase;
        if (ns == kStages) {
          ns = 0;
          nphase ^= 1;
        }
        bar_wait(&full[ns], nphase);
#if PP
        turn_wait(wg);
#endif
        issue_s<D, kRegA>(sacc, q_a, qa, S::kQBox, stages + ns * S::kStageBytes,
                          S::kKBox);
        issue_pv<kBoxes>(o, p_a, sv, S::kKBox);
#if PP
        turn_pass(wg);
#endif
        // Tile j + 1's softmax while tile j's PV product runs.
        wgmma_wait<1>();
        fence_regs(sacc);
        const int k0 = (j + 1) * kBN;
        softmax_tile(sacc, p, k0, inside(k0), qpos, t, m, l, corr);
        wgmma_wait<0>();
#pragma unroll
        for (int x = 0; x < kBoxes; ++x) fence_regs(o[x]);
        fence_regs(p_a);
        __syncwarp();
        if (lane == 0) bar_arrive(&empty[s]);
#pragma unroll
        for (int x = 0; x < kBoxes; ++x) {
#pragma unroll
          for (int i = 0; i < 32; ++i) o[x][i] *= corr[(i >> 1) & 1];
        }
        pack_a<kBN / 16>(p_a, sacc);
        s = ns;
        phase = nphase;
      }
    }
#pragma unroll
    for (int x = 0; x < kBoxes; ++x) fence_regs(o[x]);
    fence_regs(p_a);

    // out = O / l, rounded once to bf16, staged through the warpgroup's own
    // rows of the query tile (16-byte unit u of row r at u ^ (r % 8), so a
    // warp's fragment stores hit distinct banks), then 16-byte stores.
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      inv[r] = l[r] > 0.f ? 1.f / l[r] : 0.f;
    }
    uint8_t* so = sQ + wg * 64 * kRowBytes;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = warp * 16 + g + 8 * r;
#pragma unroll
      for (int x = 0; x < kBoxes; ++x) {
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          *reinterpret_cast<uint32_t*>(so + x * S::kQBox + row * kRowBytes +
                                       ((n ^ (row & 7)) << 4) + 4 * t) =
              pack_bf16x2(o[x][4 * n + 2 * r] * inv[r], o[x][4 * n + 2 * r + 1] * inv[r]);
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
        *reinterpret_cast<uint4*>(ob + static_cast<long long>(grow) * p.o_ss + x * 64 + u * 8) =
            *reinterpret_cast<const uint4*>(so + x * S::kQBox + row * kRowBytes +
                                            ((u ^ (row & 7)) << 4));
      }
    }
    if (t == 0) {
      const long long stat0 = (static_cast<long long>(blk.b) * p.n_heads + blk.h) * p.sq;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + g + 8 * r;
        if (row < p.sq) {
          p.lse[stat0 + row] = l[r] > 0.f ? (m[r] + log2f(l[r])) * kLn2 : -INFINITY;
        }
      }
    }
  }
}

template <int D>
cudaError_t launch(const Params& p, const CUtensorMap* maps, cudaStream_t stream) {
  static std::atomic<uint64_t> done{0};
  constexpr int kSmem = FwdSmem<D>::kBytes;
  const cudaError_t err = opt_in(flash_fwd_kernel<D>, kSmem, done);
  if (err != cudaSuccess) return err;
  const unsigned blocks = static_cast<unsigned>(p.row_tiles) * p.batch * p.n_heads;
  flash_fwd_kernel<D><<<blocks, kThreads, kSmem, stream>>>(p, maps[0], maps[1],
                                                           maps[2]);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes: launches the kernel on `stream` and
// returns a cudaError_t (0 on a successful launch; cudaErrorInvalidValue
// when a tensor map is refused). q, k, v are bf16 with 16-byte aligned rows
// and strides (TMA's rule); strides: 12 in elements, (batch, seq, head) of
// q, k, v and out, with unit stride along the head dim.
extern "C" int hvt_flash_fwd_bf16(
    const void* q, const void* k, const void* v, void* out, void* lse,
    int batch, int n_heads, int sq, int skv, int head_dim,
    const long long* strides, int kv_len, int q_offset, int kv_offset,
    float sm_scale, int causal, void* stream) {
  Params p;
  p.o = static_cast<__nv_bfloat16*>(out);
  p.lse = static_cast<float*>(lse);
  p.o_sb = strides[9];
  p.o_ss = strides[10];
  p.o_sh = strides[11];
  p.batch = batch;
  p.n_heads = n_heads;
  p.sq = sq;
  p.skv = skv;
  p.kv_len = kv_len;
  p.q_offset = q_offset;
  p.kv_offset = kv_offset;
  p.causal = causal;
  p.row_tiles = (sq + kRows - 1) / kRows;
  p.scale_log2 = sm_scale * kLog2e;
  // With no valid key no block loads anything: the maps stay unencoded
  // (and K/V may have no rows at all).
  CUtensorMap maps[3] = {};
  if ((head_dim != 64 && head_dim != 128) ||
      !grid_fits(p.row_tiles, batch, n_heads) ||
      (kv_len > 0 &&
       !(make_map(&maps[0], q, batch, sq, n_heads, head_dim, strides + 0, kRows) &&
         make_map(&maps[1], k, batch, skv, n_heads, head_dim, strides + 3, kBN) &&
         make_map(&maps[2], v, batch, skv, n_heads, head_dim, strides + 6, kBN)))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = head_dim == 64 ? launch<64>(p, maps, s)
                                         : launch<128>(p, maps, s);
  return static_cast<int>(err);
}
