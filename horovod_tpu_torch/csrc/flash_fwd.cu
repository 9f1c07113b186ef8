// Flash-attention forward for Hopper (sm_90a), written by hand in CUDA C++.
//
// Replaces horovod_tpu/ops/pallas_kernels.py::_fwd_kernel, the Pallas TPU
// kernel behind flash_attention / flash_attention_with_lse. It computes the
// same function: blockwise online-softmax attention with fp32 softmax
// statistics, a causal mask on global positions (q_offset / kv_offset),
// keys at or past kv_len masked out, p rounded to V's dtype before the PV
// product (fp32 accumulation), rows with no valid key giving out = 0 and
// lse = -inf, out written in the input dtype and lse in fp32 [B, H, Sq].
//
// Work split. One thread block of four warps takes one (batch, head,
// 64-row query tile); each warp owns 16 query rows. The block walks the
// K/V tiles of 64 keys, staged through shared memory, and keeps the running
// row max, row sum and the output accumulator in fp32 registers. Tiles that
// lie wholly in the causal future of the query tile, or wholly at or past
// kv_len, are never loaded (pallas_kernels.py:188-191 skips the same
// tiles). Both products run on the tensor cores through mma.sync
// m16n8k16 (bf16 in, fp32 accumulate); the S accumulator's register layout
// is the A-operand layout of the PV product, so P never leaves registers.
//
// Layout. q/k/v are read in place through (batch, seq, head) strides with a
// unit stride along the head dim, so the projection's packed [B, S, H*D]
// output -- or one third of a fused [B, S, 3*H*D] QKV output -- is read
// with no relayout copy. The wrapper checks 16-byte alignment of every
// row.
//
// What bounds it on an H100 SXM (data-sheet peaks at its 700 W power limit:
// 3.35 TB/s of HBM3, 989 TFLOP/s dense bf16):
// at GPT-2 small's serving shape (B=8, S=1024, H=12, D=64, causal) the
// causal half of the two products is about 12.9 GFLOP (13 us at the bf16
// peak) and reading q/k/v once plus writing out and lse moves about 50 MB
// (15 us at 3.35 TB/s), so the least time is about 15 us, bound by bytes.
//
// What this simple design leaves on the table: no cp.async/TMA pipeline
// (a tile's loads do not overlap the previous tile's math inside a block;
// only other resident blocks hide the latency), mma.sync instead of the
// asynchronous warpgroup wgmma (a fraction of the card's tensor-core
// rate), V transposed into shared memory with scalar stores, fixed 64x64
// tiles, and no scheduling of the uneven causal work across SMs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

namespace {

constexpr int kBlockQ = 64;   // query rows per thread block (16 per warp)
constexpr int kBlockK = 64;   // keys per K/V tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kPad = 8;       // bf16 row padding: conflict-free fragment loads
constexpr float kLn2 = 0.6931471805599453f;

struct FwdParams {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  float* lse;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  int n_heads, sq, skv, kv_len, q_offset, kv_offset, causal;
  float scale_log2;  // sm_scale * log2(e): the softmax runs on exp2
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

// Two floats as a bf16 pair; the first lands in the low half, which the mma
// fragments read as the lower column.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(const FwdParams p) {
  constexpr int kLd = D + kPad;         // row stride of sQ and sK
  constexpr int kLdV = kBlockK + kPad;  // row stride of sVt (V transposed)
  constexpr int kChunks = D / 8;        // 16-byte chunks per row
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);  // [kBlockQ][kLd]
  __nv_bfloat16* sK = sQ + kBlockQ * kLd;                       // [kBlockK][kLd]
  __nv_bfloat16* sVt = sK + kBlockK * kLd;                      // [D][kLdV]

  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // fragment row (and row + 8)
  const int t = lane & 3;   // fragment column pair

  const __nv_bfloat16* qb = p.q + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kb = p.k + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* vb = p.v + b * p.v_sb + h * p.v_sh;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  // Q tile -> shared memory (rows past Sq are zero and never stored).
  for (int i = tid; i < kBlockQ * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    uint4 val = zero;
    if (q0 + r < p.sq) {
      val = *reinterpret_cast<const uint4*>(qb + (q0 + r) * p.q_ss + c);
    }
    *reinterpret_cast<uint4*>(sQ + r * kLd + c) = val;
  }
  __syncthreads();

  // This warp's 16 query rows as mma A fragments, held for the whole loop.
  const int wr = warp * 16;
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const __nv_bfloat16* base = sQ + (wr + g) * kLd + kk * 16 + t * 2;
    qf[kk][0] = ld_u32(base);
    qf[kk][1] = ld_u32(base + 8 * kLd);
    qf[kk][2] = ld_u32(base + 8);
    qf[kk][3] = ld_u32(base + 8 * kLd + 8);
  }

  float acc[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
    acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;
  }
  // Rows g and g + 8 of the warp's 16. row_sum is this thread's partial
  // sum over its columns; the quad's four partials are added at the end.
  float row_max[2] = {-INFINITY, -INFINITY};
  float row_sum[2] = {0.f, 0.f};
  const int row_a = q0 + wr + g;
  const int qpos[2] = {p.q_offset + row_a, p.q_offset + row_a + 8};

  // Keys [0, kv_end) can be valid for some row of this tile.
  int kv_end = p.kv_len;
  if (p.causal) {
    const int q_last = p.q_offset + min(q0 + kBlockQ, p.sq) - 1;
    kv_end = min(kv_end, max(q_last - p.kv_offset + 1, 0));
  }
  const int n_tiles = (kv_end + kBlockK - 1) / kBlockK;

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kBlockK;
    __syncthreads();  // every warp is done with the previous tile
    for (int i = tid; i < kBlockK * kChunks; i += kThreads) {
      const int r = i / kChunks, c = (i % kChunks) * 8;
      uint4 val = zero;
      if (k0 + r < p.skv) {
        val = *reinterpret_cast<const uint4*>(kb + (k0 + r) * p.k_ss + c);
      }
      *reinterpret_cast<uint4*>(sK + r * kLd + c) = val;
    }
    // V is stored transposed so the PV product's B fragments are 32-bit
    // loads; neighbouring threads take neighbouring keys so the scalar
    // stores spread over the banks.
    for (int i = tid; i < kBlockK * kChunks; i += kThreads) {
      const int r = i % kBlockK, c = (i / kBlockK) * 8;
      uint4 val = zero;
      if (k0 + r < p.skv) {
        val = *reinterpret_cast<const uint4*>(vb + (k0 + r) * p.v_ss + c);
      }
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
      for (int x = 0; x < 8; ++x) sVt[(c + x) * kLdV + r] = e[x];
    }
    __syncthreads();

    // S = Q K^T for the warp's 16 rows x 64 keys, fp32.
    float s[kBlockK / 8][4];
#pragma unroll
    for (int n = 0; n < kBlockK / 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const __nv_bfloat16* kp = sK + (n * 8 + g) * kLd + kk * 16 + t * 2;
        mma_16816(s[n], qf[kk], ld_u32(kp), ld_u32(kp + 8));
      }
    }

    // Scale into the log2 domain, mask, and take the running row max.
    float tile_max[2] = {row_max[0], row_max[1]};
#pragma unroll
    for (int n = 0; n < kBlockK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int col = k0 + n * 8 + t * 2 + (e & 1);
        const bool ok =
            col < p.kv_len && (!p.causal || qpos[r] >= p.kv_offset + col);
        const float x = ok ? s[n][e] * p.scale_log2 : -INFINITY;
        s[n][e] = x;
        tile_max[r] = fmaxf(tile_max[r], x);
      }
    }
    float m_use[2], corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      tile_max[r] = fmaxf(tile_max[r], __shfl_xor_sync(0xffffffffu, tile_max[r], 1));
      tile_max[r] = fmaxf(tile_max[r], __shfl_xor_sync(0xffffffffu, tile_max[r], 2));
      // A row with no valid key so far keeps max -inf; exponentiate
      // against 0 there so masked entries give exactly 0, never NaN.
      m_use[r] = tile_max[r] == -INFINITY ? 0.f : tile_max[r];
      corr[r] = exp2f(row_max[r] - m_use[r]);
      row_max[r] = tile_max[r];
      row_sum[r] *= corr[r];
    }
#pragma unroll
    for (int n = 0; n < kBlockK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = exp2f(s[n][e] - m_use[e >> 1]);
        s[n][e] = pe;
        row_sum[e >> 1] += pe;  // the unrounded p, as the TPU kernel sums it
      }
    }
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      acc[dn][0] *= corr[0];
      acc[dn][1] *= corr[0];
      acc[dn][2] *= corr[1];
      acc[dn][3] *= corr[1];
    }

    // O += P V with P rounded to bf16 (V's dtype), fp32 accumulation.
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk) {
      const uint32_t a[4] = {
          pack_bf16x2(s[2 * kk][0], s[2 * kk][1]),
          pack_bf16x2(s[2 * kk][2], s[2 * kk][3]),
          pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3]),
      };
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
        const __nv_bfloat16* vp = sVt + (dn * 8 + g) * kLdV + kk * 16 + t * 2;
        mma_16816(acc[dn], a, ld_u32(vp), ld_u32(vp + 8));
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    row_sum[r] += __shfl_xor_sync(0xffffffffu, row_sum[r], 1);
    row_sum[r] += __shfl_xor_sync(0xffffffffu, row_sum[r], 2);
  }
  __nv_bfloat16* ob = p.o + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + r * 8;
    if (row >= p.sq) continue;
    const bool any = row_sum[r] > 0.f;
    const float inv = any ? 1.f / row_sum[r] : 0.f;
    __nv_bfloat16* orow = ob + row * p.o_ss;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      *reinterpret_cast<uint32_t*>(orow + dn * 8 + t * 2) =
          pack_bf16x2(acc[dn][2 * r] * inv, acc[dn][2 * r + 1] * inv);
    }
    if (t == 0) {
      p.lse[((long long)b * p.n_heads + h) * p.sq + row] =
          any ? (row_max[r] + log2f(row_sum[r])) * kLn2 : -INFINITY;
    }
  }
}

template <int D>
cudaError_t launch(const FwdParams& p, int batch, cudaStream_t stream) {
  constexpr int kLd = D + kPad;
  constexpr int kLdV = kBlockK + kPad;
  constexpr int kSmem =
      sizeof(__nv_bfloat16) * ((kBlockQ + kBlockK) * kLd + D * kLdV);
  // Above 48 KB (D = 128) dynamic shared memory must be opted into. The
  // attribute belongs to the current device, so it is set on every launch
  // (a cheap host call) and holds on whichever card a thread launches on.
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.sq + kBlockQ - 1) / kBlockQ, p.n_heads, batch);
  flash_fwd_kernel<D><<<grid, kThreads, kSmem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes. Strides are in elements; the head dim
// has unit stride. Returns a cudaError_t (0 on a successful launch).
extern "C" int hvt_flash_fwd_bf16(
    const void* q, const void* k, const void* v, void* out, void* lse,
    int batch, int n_heads, int sq, int skv, int head_dim,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh,
    int kv_len, int q_offset, int kv_offset, float sm_scale, int causal,
    void* stream) {
  FwdParams p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<__nv_bfloat16*>(out);
  p.lse = static_cast<float*>(lse);
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.o_sb = o_sb; p.o_ss = o_ss; p.o_sh = o_sh;
  p.n_heads = n_heads;
  p.sq = sq;
  p.skv = skv;
  p.kv_len = kv_len;
  p.q_offset = q_offset;
  p.kv_offset = kv_offset;
  p.causal = causal;
  p.scale_log2 = sm_scale * 1.4426950408889634f;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64:
      return static_cast<int>(launch<64>(p, batch, s));
    case 128:
      return static_cast<int>(launch<128>(p, batch, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
