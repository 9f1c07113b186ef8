// fp8 matrix product for Hopper (sm_90a), written by hand in CUDA C++.
//
// Replaces horovod_tpu/ops/pallas_kernels.py::_fp8_matmul_kernel (through
// fp8_matmul_pallas), the Pallas TPU kernel behind ops/quantization.fp8_matmul
// on the fp8 training path (compute_dtype="fp8"). It computes the same
// function:
//
//   out[M, N] = (sum_k upcast(a[m, k]) * upcast(b[k, n])) * scale
//
// with fp8 operands (float8_e4m3fn or float8_e5m2, each operand its own, so
// the backward pass pairs an e5m2 gradient with e4m3 operands), fp32
// accumulation, one fp32 scale read from device memory in the epilogue, and
// an fp32 or bf16 output.
//
// Exactness. Every e4m3 and e5m2 value is exactly an fp16 value (e5m2 is the
// top byte of an fp16; e4m3's range, 2^-9 to 448, lies inside fp16's normal
// range), so the tiles are converted to fp16 with one hardware cvt a pair
// (cvt.rn.f16x2.e4m3x2 / .e5m2x2) and multiplied on the tensor cores by
// mma.sync m16n8k16 with fp32 accumulation: every product is exact and every
// sum an fp32 sum, as in the TPU kernel, which upcasts its tiles to fp32.
// Hopper's native fp8 MMA keeps fewer accumulator bits, and the weight
// gradient contracts over all M = 16,384 rows of a GPT-2-small step.
//
// Layouts. Each operand is read in place in either orientation: A[M, K] with
// k contiguous (an activation or a gradient) or m contiguous (a transposed
// view: the weight gradient g^T x reads g so), B[K, N] with k contiguous (the
// transposed view of an nn.Linear-style [N, K] weight, the forward pass) or n
// contiguous (dX = g W reads W [N, K] so, and dW reads x so). Tiles are staged
// into shared memory in their global orientation with 16-byte loads,
// converted to fp16 on the way, and ldmatrix (.trans for the m- or
// n-contiguous ones) brings them into mma fragments: no transposed copy of an
// operand exists. Ragged M, K and N are zero-padded inside the kernel (fp8
// zero is exact zero); an operand whose rows are not 16-byte aligned takes
// byte loads.
//
// Work split. A thread block of 8 warps computes a 128x128 output tile (each
// warp 64x32) over 32-deep k tiles, double-buffered through shared memory:
// the next tile's global loads are in flight in registers while the current
// one is multiplied. Where the output has too few tiles to fill the card (the
// weight gradient of a 768x768 projection: 36 tiles contracting over 16,384
// rows) the wrapper splits the contraction over gridDim.z; each split writes
// its fp32 partial sums to a workspace and a second kernel adds the splits in
// a fixed order, applies the scale and writes the output (deterministic).
//
// What bounds it on an H100 SXM (data-sheet peaks at its 700 W power limit:
// 1,979 TFLOP/s dense fp8, 3.35 TB/s of HBM3): at GPT-2 small's training
// shapes (M = 16,384 rows) the products sit near the ridge. The MLP's fc
// forward, 77.3 GFLOP, needs 39 us of fp8 tensor-core time and 35 us to move
// its 116 MB (fp8 operands, bf16 output); a 768x768 projection's 19.3 GFLOP
// need 10 us against 11 us for its 38 MB. A step's 216 launches need at least
// 4.2 ms of fp8 operations.
//
// What this simple design leaves on the table: fp16 mma.sync runs at half the
// fp8 rate and below wgmma's; no TMA or cp.async (register staging, one
// stage ahead); fixed 128x128x32 tiles; the split-K workspace round trip.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;  // output rows per thread block
constexpr int kBN = 128;  // output columns per thread block
constexpr int kBK = 32;   // contraction depth per shared-memory tile
constexpr int kWarps = 8;  // 2 (rows) x 4 (columns), 64x32 outputs each
constexpr int kThreads = kWarps * 32;
constexpr int kPad = 8;  // fp16 row padding: conflict-free ldmatrix rows
constexpr int kLdK = kBK + kPad;   // row stride of a k-contiguous tile [128][32]
constexpr int kLdMN = kBM + kPad;  // row stride of an m/n-contiguous tile [32][128]
constexpr int kTile = kBM * kLdK;  // fp16 elements a tile buffer holds
static_assert(kBM == kBN, "one tile extent for both operands");
static_assert(kBK * kLdMN <= kTile, "an m/n-contiguous tile fits the buffer");
static_assert(kBM * kBK / 16 == kThreads, "one 16-byte chunk a thread a tile");

struct Params {
  const uint8_t* a;
  const uint8_t* b;
  void* out;
  float* ws;           // [splits, M, N] fp32 partial sums when gridDim.z > 1
  const float* scale;  // one fp32 value on the device
  long long lda, ldb, ldc;  // elements between rows of the stored layouts
  int m, n, k;
  int k_per_split;  // a multiple of kBK
  int a_e5m2, b_e5m2, out_bf16;
  int a_vec, b_vec;  // rows 16-byte aligned: vector loads allowed
};

__device__ __forceinline__ uint32_t fp8x2_to_f16x2(uint32_t two, bool e5m2) {
  const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(
      static_cast<__nv_fp8x2_storage_t>(two & 0xFFFFu),
      e5m2 ? __NV_E5M2 : __NV_E4M3);
  // The lower-addressed fp8 lands in the low half, as the fragments read it.
  return static_cast<uint32_t>(h.x) | (static_cast<uint32_t>(h.y) << 16);
}

// 16 fp8 values -> 16 fp16 values at dst (32 bytes, 16-byte aligned).
__device__ __forceinline__ void store_f16(__half* dst, const uint4 raw,
                                          bool e5m2) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
  uint32_t o[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    o[2 * i] = fp8x2_to_f16x2(w[i], e5m2);
    o[2 * i + 1] = fp8x2_to_f16x2(w[i] >> 16, e5m2);
  }
  uint4* d = reinterpret_cast<uint4*>(dst);
  d[0] = make_uint4(o[0], o[1], o[2], o[3]);
  d[1] = make_uint4(o[4], o[5], o[6], o[7]);
}

// This thread's 16-byte chunk of one operand's tile. KMAJ: the stored layout
// is [rows][k] (k contiguous), the tile rows row0..row0+127 by k
// k0..k0+31, a chunk 16 k of one row. Otherwise [k][rows] (rows contiguous),
// the tile k0..k0+31 by rows row0..row0+127, a chunk 16 rows of one k. Past
// rows (M or N) or k_end the values are zero.
template <bool KMAJ>
__device__ __forceinline__ uint4 load_chunk(const uint8_t* base, long long ld,
                                            int rows, int k_end, int row0,
                                            int k0, bool vec) {
  const int tid = threadIdx.x;
  int r, k, step_r, step_k;
  if (KMAJ) {
    r = row0 + (tid >> 1);
    k = k0 + (tid & 1) * 16;
    step_r = 0;
    step_k = 1;
  } else {
    k = k0 + (tid >> 3);
    r = row0 + (tid & 7) * 16;
    step_r = 1;
    step_k = 0;
  }
  const uint8_t* src = KMAJ ? base + r * ld + k : base + k * ld + r;
  const bool full = KMAJ ? (r < rows && k + 16 <= k_end)
                         : (k < k_end && r + 16 <= rows);
  if (full && vec) return *reinterpret_cast<const uint4*>(src);
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    if (r + i * step_r < rows && k + i * step_k < k_end) {
      w[i >> 2] |= static_cast<uint32_t>(src[i]) << (8 * (i & 3));
    }
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

template <bool KMAJ>
__device__ __forceinline__ void stage(__half* s, const uint4 raw, bool e5m2) {
  const int tid = threadIdx.x;
  __half* dst = KMAJ ? s + (tid >> 1) * kLdK + (tid & 1) * 16
                     : s + (tid >> 3) * kLdMN + (tid & 7) * 16;
  store_f16(dst, raw, e5m2);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const __half* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const __half* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void store_out(const Params& p, int row, int col,
                                          float v) {
  if (p.out_bf16) {
    static_cast<__nv_bfloat16*>(p.out)[row * p.ldc + col] =
        __float2bfloat16_rn(v);
  } else {
    static_cast<float*>(p.out)[row * p.ldc + col] = v;
  }
}

template <bool A_KMAJ, bool B_KMAJ>
__global__ void __launch_bounds__(kThreads, 2)
    fp8_matmul_kernel(const Params p) {
  __shared__ __align__(16) __half sA[2][kTile];
  __shared__ __align__(16) __half sB[2][kTile];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wm = (warp >> 2) * 64;  // the warp's first row in the tile
  const int wn = (warp & 3) * 32;   // the warp's first column in the tile
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int k_begin = blockIdx.z * p.k_per_split;
  const int k_end = min(p.k, k_begin + p.k_per_split);
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + kBK - 1) / kBK : 0;
  const bool a_e5m2 = p.a_e5m2 != 0, b_e5m2 = p.b_e5m2 != 0;
  const bool a_vec = p.a_vec != 0, b_vec = p.b_vec != 0;

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  uint4 ra = load_chunk<A_KMAJ>(p.a, p.lda, p.m, k_end, m0, k_begin, a_vec);
  uint4 rb = load_chunk<B_KMAJ>(p.b, p.ldb, p.n, k_end, n0, k_begin, b_vec);
  stage<A_KMAJ>(sA[0], ra, a_e5m2);
  stage<B_KMAJ>(sB[0], rb, b_e5m2);
  __syncthreads();

  // ldmatrix lane roles: lanes 8j..8j+7 address the rows of matrix j.
  const int lr = lane & 7;
  const int lj0 = (lane >> 3) & 1;
  const int lj1 = lane >> 4;

  for (int t = 0; t < n_tiles; ++t) {
    const int cur = t & 1;
    const bool more = t + 1 < n_tiles;
    if (more) {  // in flight while this tile is multiplied
      const int kn = k_begin + (t + 1) * kBK;
      ra = load_chunk<A_KMAJ>(p.a, p.lda, p.m, k_end, m0, kn, a_vec);
      rb = load_chunk<B_KMAJ>(p.b, p.ldb, p.n, k_end, n0, kn, b_vec);
    }
    const __half* tA = sA[cur];
    const __half* tB = sB[cur];
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t af[4][4];
      uint32_t bf[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int mr = wm + mi * 16;
        if (A_KMAJ) {  // [m][k]: matrices (m, k), (m+8, k), (m, k+8), (m+8, k+8)
          ldsm_x4(af[mi], tA + (mr + lr + lj0 * 8) * kLdK + kk + lj1 * 8);
        } else {  // [k][m], transposed on load, the same four matrices
          ldsm_x4_t(af[mi], tA + (kk + lr + lj1 * 8) * kLdMN + mr + lj0 * 8);
        }
      }
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        const int nc = wn + np * 16;
        uint32_t r[4];
        if (B_KMAJ) {  // [n][k]: (n, k), (n, k+8), (n+8, k), (n+8, k+8)
          ldsm_x4(r, tB + (nc + lr + lj1 * 8) * kLdK + kk + lj0 * 8);
        } else {  // [k][n], transposed on load, the same four matrices
          ldsm_x4_t(r, tB + (kk + lr + lj0 * 8) * kLdMN + nc + lj1 * 8);
        }
        bf[2 * np][0] = r[0];
        bf[2 * np][1] = r[1];
        bf[2 * np + 1][0] = r[2];
        bf[2 * np + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma_16816(acc[mi][ni], af[mi], bf[ni][0], bf[ni][1]);
    }
    if (more) {
      stage<A_KMAJ>(sA[cur ^ 1], ra, a_e5m2);
      stage<B_KMAJ>(sB[cur ^ 1], rb, b_e5m2);
    }
    __syncthreads();
  }

  // Accumulator (mi, ni, e): row g (+8 for e >= 2), columns 2t and 2t + 1.
  const int g = lane >> 2;
  const int tc = (lane & 3) * 2;
  if (gridDim.z > 1) {
    float* ws = p.ws + (long long)blockIdx.z * p.m * p.n;
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = m0 + wm + mi * 16 + g + (e >> 1) * 8;
          const int col = n0 + wn + ni * 8 + tc + (e & 1);
          if (row < p.m && col < p.n) ws[(long long)row * p.n + col] = acc[mi][ni][e];
        }
    return;
  }
  const float s = *p.scale;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = m0 + wm + mi * 16 + g + (e >> 1) * 8;
        const int col = n0 + wn + ni * 8 + tc + (e & 1);
        if (row < p.m && col < p.n) store_out(p, row, col, acc[mi][ni][e] * s);
      }
}

// out = (sum over the splits, in split order) * scale.
__global__ void fp8_matmul_reduce_kernel(const Params p, int splits) {
  const long long total = static_cast<long long>(p.m) * p.n;
  const float s = *p.scale;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    float acc = p.ws[i];
    for (int z = 1; z < splits; ++z) acc += p.ws[z * total + i];
    store_out(p, static_cast<int>(i / p.n), static_cast<int>(i % p.n),
              acc * s);
  }
}

template <bool A_KMAJ, bool B_KMAJ>
cudaError_t launch(const Params& p, int splits, cudaStream_t stream) {
  const dim3 grid((p.n + kBN - 1) / kBN, (p.m + kBM - 1) / kBM, splits);
  fp8_matmul_kernel<A_KMAJ, B_KMAJ><<<grid, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes. a_kmajor: A[M, K] is stored [M][lda] with k
// contiguous, else [K][lda] with m contiguous; b_kmajor: B[K, N] is stored
// [N][ldb] with k contiguous, else [K][ldb] with n contiguous. out is [M][ldc].
// splits > 1 needs a workspace of splits * M * N fp32. Returns a cudaError_t
// (0 when every launch was accepted).
extern "C" int hvt_fp8_matmul(const void* a, const void* b, void* out,
                              void* workspace, const void* scale, int m, int n,
                              int k, long long lda, long long ldb,
                              long long ldc, int a_kmajor, int b_kmajor,
                              int a_e5m2, int b_e5m2, int out_bf16, int splits,
                              void* stream) {
  if (m <= 0 || n <= 0 || k < 0 || splits < 1 || (splits > 1 && !workspace)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.a = static_cast<const uint8_t*>(a);
  p.b = static_cast<const uint8_t*>(b);
  p.out = out;
  p.ws = static_cast<float*>(workspace);
  p.scale = static_cast<const float*>(scale);
  p.lda = lda;
  p.ldb = ldb;
  p.ldc = ldc;
  p.m = m;
  p.n = n;
  p.k = k;
  const int per = (k + splits - 1) / splits;
  p.k_per_split = ((per + kBK - 1) / kBK) * kBK;
  p.a_e5m2 = a_e5m2;
  p.b_e5m2 = b_e5m2;
  p.out_bf16 = out_bf16;
  p.a_vec = lda % 16 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0;
  p.b_vec = ldb % 16 == 0 && reinterpret_cast<uintptr_t>(b) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (a_kmajor && b_kmajor) {
    err = launch<true, true>(p, splits, s);
  } else if (a_kmajor) {
    err = launch<true, false>(p, splits, s);
  } else if (b_kmajor) {
    err = launch<false, true>(p, splits, s);
  } else {
    err = launch<false, false>(p, splits, s);
  }
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const long long total = static_cast<long long>(m) * n;
  const int threads = 256;
  const long long want = (total + threads - 1) / threads;
  const int blocks = static_cast<int>(want < 4096 ? want : 4096);
  fp8_matmul_reduce_kernel<<<blocks, threads, 0, s>>>(p, splits);
  return static_cast<int>(cudaGetLastError());
}
