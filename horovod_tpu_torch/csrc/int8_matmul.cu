// int8-weight matrix product (W8A16) for Hopper (sm_90a), written by hand in
// CUDA C++.
//
// Replaces horovod_tpu/ops/pallas_kernels.py::_int8_matmul_kernel (through
// int8_matmul_pallas), the Pallas TPU kernel behind
// ops/quantization.int8_weight_matmul on the int8 serving path
// (ServePool(weight_dtype="int8")). It computes the same function:
//
//   out[m, n] = cast_to_x_dtype(scale[n] * sum_k x[m, k] * q[k, n])
//
// with x in bf16 or fp32, q int8 with one fp32 scale per output column, fp32
// sums, the scale applied once in the epilogue and one rounding to x's dtype.
// No dequantized copy of the weight exists in device memory.
//
// Exactness. |q| <= 127 is exact in bf16, so the bf16 kernel converts each
// int8 weight tile to bf16 on its way into shared memory and multiplies on the
// tensor cores with mma.sync m16n8k16 bf16 and fp32 accumulation: every
// product is exact and every sum an fp32 sum, as in the TPU kernel, which
// casts its weight tile to x's dtype and accumulates in fp32. fp32 x takes a
// plain tiled FMA kernel (fp32 products and sums, no TF32).
//
// Layouts. The weight is read as stored: [N][ldw] int8, k contiguous (the
// [K, N] payload of quantize_weight is a transposed view of that storage),
// which is the B-operand layout mma.sync's .col fragment wants. x is read in
// place through its strides: row r of the flattened [M, K] lies at
// (r / rows_inner) * x_so + (r % rows_inner) * x_si with k contiguous, so a
// [B, S, K] activation (or a column slice of a wider one) needs no copy.
// Ragged M, N and K are zero-filled inside the kernel; a row or weight row
// that is not 16-byte aligned takes element loads.
//
// Work split (bf16). A thread block of 8 warps computes a 128x128 output tile
// (each warp 64x32) over 32-deep k tiles, double-buffered through shared
// memory: the next tile's global loads are in flight in registers while the
// current one is multiplied (the design of csrc/fp8_matmul.cu).
//
// What bounds it on an H100 SXM (data-sheet peaks at its 700 W power limit:
// 989 TFLOP/s dense bf16, 3.35 TB/s of HBM3). A GPT-2-small serving batch
// (M = 8 x 1024 rows) runs 48 products of 1.39 TFLOP in all: 1.41 ms of bf16
// tensor-core time against 0.75 ms to move their 2.5 GB, so operations bound
// it. At decode-sized M (8 rows) the same 48 products move 85 MB of int8
// weights, 0.025 ms, and the weight bytes bound it.
//
// What this simple design leaves on the table: mma.sync rather than wgmma; no
// TMA or cp.async (register staging, one stage ahead); a conversion of every
// weight element in every block that reads it; fixed 128x128x32 tiles, which
// give small M only N / 128 blocks (no split of the contraction).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;  // output rows per thread block
constexpr int kBN = 128;  // output columns per thread block
constexpr int kBK = 32;   // contraction depth per shared-memory tile
constexpr int kWarps = 8;  // 2 (rows) x 4 (columns), 64x32 outputs each
constexpr int kThreads = kWarps * 32;
constexpr int kPad = 8;  // bf16 row padding: conflict-free ldmatrix rows
constexpr int kLd = kBK + kPad;  // row stride of a [128][32] tile
constexpr int kTile = kBM * kLd;  // bf16 elements a tile buffer holds
static_assert(kBM * kBK / 8 == 2 * kThreads, "two 8-value x chunks a thread");
static_assert(kBN * kBK / 16 == kThreads, "one 16-value weight chunk a thread");

// fp32 FMA kernel: 64x64 outputs a block, 4x4 a thread, 16-deep k tiles.
constexpr int kFM = 64;
constexpr int kFN = 64;
constexpr int kFK = 16;

struct Params {
  const void* x;
  const int8_t* w;
  const float* scales;
  void* out;
  long long x_so, x_si;  // x row strides (elements), see the header
  long long ldw;         // elements between weight rows
  int m, n, k;
  int rows_inner;
  int x_vec, w_vec;  // rows 16-byte aligned: vector loads allowed
};

__device__ __forceinline__ long long x_row(const Params& p, int row) {
  return static_cast<long long>(row / p.rows_inner) * p.x_so +
         static_cast<long long>(row % p.rows_inner) * p.x_si;
}

// 8 bf16 of one x row at k..k+7 (zeros past K); row null past M.
__device__ __forceinline__ uint4 load_x8(const uint16_t* row, int k, int k_end,
                                         bool vec) {
  if (row == nullptr) return make_uint4(0u, 0u, 0u, 0u);
  if (vec && k + 8 <= k_end) return *reinterpret_cast<const uint4*>(row + k);
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    if (k + i < k_end) {
      w[i >> 1] |= static_cast<uint32_t>(row[k + i]) << (16 * (i & 1));
    }
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// 16 int8 of one weight row at k..k+15 (zeros past K); row null past N.
__device__ __forceinline__ uint4 load_w16(const int8_t* row, int k, int k_end,
                                          bool vec) {
  if (row == nullptr) return make_uint4(0u, 0u, 0u, 0u);
  if (vec && k + 16 <= k_end) return *reinterpret_cast<const uint4*>(row + k);
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    if (k + i < k_end) {
      w[i >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(row[k + i]))
                   << (8 * (i & 3));
    }
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Two int8 (the low two bytes of `two`) -> two bf16, exactly; the
// lower-addressed value lands in the low half, as the fragments read it.
__device__ __forceinline__ uint32_t i8x2_to_bf16x2(uint32_t two) {
  const float lo = static_cast<float>(static_cast<int8_t>(two & 0xFFu));
  const float hi = static_cast<float>(static_cast<int8_t>((two >> 8) & 0xFFu));
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return static_cast<uint32_t>(__bfloat16_as_ushort(h.x)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(h.y)) << 16);
}

// 16 int8 -> 16 bf16 at dst (32 bytes, 16-byte aligned).
__device__ __forceinline__ void store_w16(__nv_bfloat16* dst, const uint4 raw) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
  uint32_t o[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    o[2 * i] = i8x2_to_bf16x2(w[i]);
    o[2 * i + 1] = i8x2_to_bf16x2(w[i] >> 16);
  }
  uint4* d = reinterpret_cast<uint4*>(dst);
  d[0] = make_uint4(o[0], o[1], o[2], o[3]);
  d[1] = make_uint4(o[4], o[5], o[6], o[7]);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4],
                                        const __nv_bfloat16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(kThreads, 2)
    int8_matmul_kernel(const Params p) {
  __shared__ __align__(16) __nv_bfloat16 sA[2][kTile];
  __shared__ __align__(16) __nv_bfloat16 sB[2][kTile];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wm = (warp >> 2) * 64;  // the warp's first row in the tile
  const int wn = (warp & 3) * 32;   // the warp's first column in the tile
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int n_tiles = (p.k + kBK - 1) / kBK;
  const bool x_vec = p.x_vec != 0, w_vec = p.w_vec != 0;

  // This thread's loads: x rows r and r + 64 at k offset xk (8 values each),
  // weight row wr at k offset wk (16 values); null past M or N.
  const int r = tid >> 2, xk = (tid & 3) * 8;
  const int wr = tid >> 1, wk = (tid & 1) * 16;
  const uint16_t* xbase = static_cast<const uint16_t*>(p.x);
  const uint16_t* xr0 = m0 + r < p.m ? xbase + x_row(p, m0 + r) : nullptr;
  const uint16_t* xr1 =
      m0 + r + 64 < p.m ? xbase + x_row(p, m0 + r + 64) : nullptr;
  const int8_t* wrow = n0 + wr < p.n ? p.w + (n0 + wr) * p.ldw : nullptr;

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  uint4 ra0 = load_x8(xr0, xk, p.k, x_vec);
  uint4 ra1 = load_x8(xr1, xk, p.k, x_vec);
  uint4 rb = load_w16(wrow, wk, p.k, w_vec);
  *reinterpret_cast<uint4*>(&sA[0][r * kLd + xk]) = ra0;
  *reinterpret_cast<uint4*>(&sA[0][(r + 64) * kLd + xk]) = ra1;
  store_w16(&sB[0][wr * kLd + wk], rb);
  __syncthreads();

  // ldmatrix lane roles: lanes 8j..8j+7 address the rows of matrix j.
  const int lr = lane & 7;
  const int lj0 = (lane >> 3) & 1;
  const int lj1 = lane >> 4;

  for (int t = 0; t < n_tiles; ++t) {
    const int cur = t & 1;
    const bool more = t + 1 < n_tiles;
    if (more) {  // in flight while this tile is multiplied
      const int kn = (t + 1) * kBK;
      ra0 = load_x8(xr0, kn + xk, p.k, x_vec);
      ra1 = load_x8(xr1, kn + xk, p.k, x_vec);
      rb = load_w16(wrow, kn + wk, p.k, w_vec);
    }
    const __nv_bfloat16* tA = sA[cur];
    const __nv_bfloat16* tB = sB[cur];
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t af[4][4];
      uint32_t bf[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        // [m][k]: matrices (m, k), (m+8, k), (m, k+8), (m+8, k+8)
        const int mr = wm + mi * 16;
        ldsm_x4(af[mi], tA + (mr + lr + lj0 * 8) * kLd + kk + lj1 * 8);
      }
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        // [n][k]: matrices (n, k), (n, k+8), (n+8, k), (n+8, k+8)
        const int nc = wn + np * 16;
        uint32_t q[4];
        ldsm_x4(q, tB + (nc + lr + lj1 * 8) * kLd + kk + lj0 * 8);
        bf[2 * np][0] = q[0];
        bf[2 * np][1] = q[1];
        bf[2 * np + 1][0] = q[2];
        bf[2 * np + 1][1] = q[3];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma_16816(acc[mi][ni], af[mi], bf[ni][0], bf[ni][1]);
    }
    if (more) {
      *reinterpret_cast<uint4*>(&sA[cur ^ 1][r * kLd + xk]) = ra0;
      *reinterpret_cast<uint4*>(&sA[cur ^ 1][(r + 64) * kLd + xk]) = ra1;
      store_w16(&sB[cur ^ 1][wr * kLd + wk], rb);
    }
    __syncthreads();
  }

  // Accumulator (mi, ni, e): row g (+8 for e >= 2), columns 2t and 2t + 1.
  const int g = lane >> 2;
  const int tc = (lane & 3) * 2;
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out);
  // Pairs of columns are stored as one 4-byte word where N is even (the
  // pair's first column is even, so the word is aligned).
  const bool pairs = (p.n & 1) == 0;
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const int col = n0 + wn + ni * 8 + tc;
    const float s0 = col < p.n ? p.scales[col] : 0.f;
    const float s1 = col + 1 < p.n ? p.scales[col + 1] : 0.f;
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm + mi * 16 + g + h * 8;
        if (row >= p.m || col >= p.n) continue;
        const float v0 = acc[mi][ni][2 * h] * s0;
        const float v1 = acc[mi][ni][2 * h + 1] * s1;
        __nv_bfloat16* o = out + static_cast<long long>(row) * p.n + col;
        if (pairs) {
          *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(v0, v1);
        } else {
          o[0] = __float2bfloat16_rn(v0);
          if (col + 1 < p.n) o[1] = __float2bfloat16_rn(v1);
        }
      }
  }
}

// fp32 x: each thread accumulates a 4x4 block of outputs with fmaf over
// 16-deep tiles of x and of the weight converted to fp32 in shared memory.
__global__ void __launch_bounds__(kThreads)
    int8_matmul_kernel_f32(const Params p) {
  __shared__ float sx[kFK][kFM + 4];  // [k][m]
  __shared__ float sw[kFK][kFN + 4];  // [k][n]

  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * kFM;
  const int n0 = blockIdx.x * kFN;
  const int tm = (tid >> 4) * 4;  // this thread's first row in the tile
  const int tn = (tid & 15) * 4;  // and first column
  // Loads: element e = tid + 256 i of each [64][16] tile, row e / 16 (the
  // same row at every k tile) and k e % 16.
  const int lk = tid & 15;
  const float* xbase = static_cast<const float*>(p.x);
  const float* xr[4];
  const int8_t* wr[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int lr = (tid >> 4) + 16 * i;
    xr[i] = m0 + lr < p.m ? xbase + x_row(p, m0 + lr) : nullptr;
    wr[i] = n0 + lr < p.n ? p.w + (n0 + lr) * p.ldw : nullptr;
  }

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < p.k; k0 += kFK) {
    const int k = k0 + lk;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int lr = (tid >> 4) + 16 * i;
      sx[lk][lr] = xr[i] != nullptr && k < p.k ? xr[i][k] : 0.f;
      sw[lk][lr] = wr[i] != nullptr && k < p.k ? static_cast<float>(wr[i][k])
                                               : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kFK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = sx[kk][tm + i];
        b[i] = sw[kk][tn + i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* out = static_cast<float*>(p.out);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = n0 + tn + j;
    if (col >= p.n) continue;
    const float s = p.scales[col];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = m0 + tm + i;
      if (row < p.m) out[static_cast<long long>(row) * p.n + col] = acc[i][j] * s;
    }
  }
}

}  // namespace

// Plain C entry point for ctypes. x: bf16 (x_bf16 = 1) or fp32 rows of K
// values, k contiguous, row r at (r / rows_inner) * x_so + (r % rows_inner) *
// x_si elements; w: [N][ldw] int8, k contiguous; scales: [N] fp32; out: [M][N]
// in x's dtype, contiguous. Returns a cudaError_t (0 when the launch was
// accepted).
extern "C" int hvt_int8_matmul(const void* x, const void* w, const void* scales,
                               void* out, int m, int n, int k, int rows_inner,
                               long long x_so, long long x_si, long long ldw,
                               int x_bf16, void* stream) {
  if (m <= 0 || n <= 0 || k < 0 || rows_inner <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.x = x;
  p.w = static_cast<const int8_t*>(w);
  p.scales = static_cast<const float*>(scales);
  p.out = out;
  p.x_so = x_so;
  p.x_si = x_si;
  p.ldw = ldw;
  p.m = m;
  p.n = n;
  p.k = k;
  p.rows_inner = rows_inner;
  // 16 bytes: 8 bf16 of x, 16 int8 of the weight.
  p.x_vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 && x_so % 8 == 0 &&
            x_si % 8 == 0;
  p.w_vec = reinterpret_cast<uintptr_t>(w) % 16 == 0 && ldw % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16) {
    const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
    int8_matmul_kernel<<<grid, kThreads, 0, s>>>(p);
  } else {
    const dim3 grid((n + kFN - 1) / kFN, (m + kFM - 1) / kFM);
    int8_matmul_kernel_f32<<<grid, kThreads, 0, s>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}
