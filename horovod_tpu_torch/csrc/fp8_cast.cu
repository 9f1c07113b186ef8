// Fused fp8 cast, transpose and amax for Hopper (sm_90a), written by hand in
// CUDA C++.
//
// Not a TPU kernel. In the JAX package the delayed-scaling cast of the fp8
// training matmul is plain jnp (horovod_tpu/ops/fp8.py:136-171 over
// ops/quantization.py's fp8_scale_from_history, fp8_saturating_cast and
// fp8_push_amax), which XLA fuses into one pass with its amax. This kernel is
// the port's counterpart of that fusion (ops/quantization.fp8_cast), and it
// also writes the operand layouts kernel 8 (fp8_matmul.cu) needs: Hopper's
// fp8 wgmma takes both operands K-major from shared memory, so the backward
// products dX = g W and dW = g^T x need g, W and x transposed. The cast reads
// every element anyway; writing the payload in both orientations in the same
// pass costs one more byte an element and no extra pass.
//
// One launch over a 2-D tensor x [R, C] (row-major, unit inner stride):
//
//   s      = max(ring) / qmax if max(ring) > 0 else 1   (IEEE division;
//            a NaN in the ring gives 1, as torch's where(amax > 0, ...))
//   v      = x                    (activation and gradient mode)
//          = float(x) + residual  (weight mode: the error-feedback sum kc)
//   q      = fp8(clamp(v / s, -qmax, qmax)), round to nearest even, NaN kept
//   out    q [R, C] and/or q^T [C, R], as the caller asks
//   ring'  = [amax(|v|), ring[0], ..., ring[n-2]]      (fp8_push_amax)
//   weight mode also: residual' = v - float(q) * s     (two IEEE roundings)
//
// Every operation is the IEEE-rounded operation the plain PyTorch version
// performs, in its order (__fdiv_rn, __fmul_rn, __fsub_rn: no contraction
// into FMAs), so the payload, the residual and the ring are bit for bit the
// plain version's. The amax is an atomicMax on the bit pattern of |v|: for
// non-negative floats that order is the float order, and NaN's bits exceed
// +inf's, so a NaN propagates as torch's amax does. The last block to finish
// (a ticket counter) writes the new ring and re-zeroes the two-word
// workspace for the next launch.
//
// A third mode copies fp8 bytes without arithmetic (no ring, no amax): the
// relayout that gives kernel 8 a K-major, 16-byte-aligned operand when its
// caller hands it another layout.
//
// Tiles. A block of 256 threads walks 64 x 64 tiles (a grid-stride loop, at
// most 8 blocks an SM, so the ring is read and the workspace atomics taken
// once a block). Each thread reads 16 consecutive elements of one row
// (16-byte loads: two for bf16, four for fp32, one for fp8), converts them,
// stores their 16 payload bytes to q with one 16-byte store and into a
// shared-memory tile; after a barrier each thread gathers 16 bytes down one
// column of the tile and stores them to q^T with one 16-byte store. Ragged
// edges and unaligned rows take element-wise loads and stores.
//
// What bounds it on an H100 SXM (3.35 TB/s of HBM3 at its 700 W limit): the
// bytes. A bf16 activation moves 2 bytes in and 2 out (q and q^T) an element:
// 16,384 x 768 (a GPT-2-small step's x) needs 15 us, 16,384 x 3072 60 us.
// The weight mode moves 6 in (bf16 w, fp32 residual) and 6 out.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;  // rows and columns of a block's tile
constexpr int kThreads = 256;
constexpr int kChunk = 16;  // elements a thread moves per row or column

enum InKind { kF32 = 0, kBF16 = 1, kRaw = 2 };

struct Params {
  const void* x;
  long long ldx;         // elements between rows of x
  const float* res;      // weight mode: the fp32 residual [R, C], ld = C
  float* res_out;        // weight mode: the new residual [R, C], ld = C
  const float* ring;     // amax ring (not in raw mode)
  float* ring_out;       // the pushed ring
  float* scale_out;      // the scale used (one float)
  uint8_t* q;            // [R, C], row stride ldq, or null
  uint8_t* qt;           // [C, R], row stride ldqt, or null
  long long ldq, ldqt;
  unsigned int* ws;      // two words, zero between launches: amax bits, ticket
  int rows, cols, ring_len;
  float qmax;
  int e5m2;
  int vec_x, vec_res, vec_q, vec_qt;  // 16-byte alignment of rows and bases
};

template <int IN>
struct In;
template <>
struct In<kF32> {
  using T = float;
  static __device__ __forceinline__ float f(T v) { return v; }
};
template <>
struct In<kBF16> {
  using T = __nv_bfloat16;
  static __device__ __forceinline__ float f(T v) { return __bfloat162float(v); }
};
template <>
struct In<kRaw> {
  using T = uint8_t;
  static __device__ __forceinline__ float f(T) { return 0.f; }
};

__device__ __forceinline__ uint8_t to_fp8(float y, float qmax, bool e5m2) {
  // clamp_(-qmax, qmax) keeps NaN: comparisons with NaN are false.
  y = y > qmax ? qmax : (y < -qmax ? -qmax : y);
  return static_cast<uint8_t>(__nv_cvt_float_to_fp8(
      y, __NV_SATFINITE, e5m2 ? __NV_E5M2 : __NV_E4M3));
}

__device__ __forceinline__ float from_fp8(uint8_t q, bool e5m2) {
  const __half_raw h = __nv_cvt_fp8_to_halfraw(
      static_cast<__nv_fp8_storage_t>(q), e5m2 ? __NV_E5M2 : __NV_E4M3);
  return __half2float(__half(h));  // exact: every fp8 value is an fp16 value
}

// The delayed scale from the ring, as fp8_scale_from_history computes it.
__device__ float ring_scale(const Params& p) {
  const int lane = threadIdx.x & 31;
  float m = 0.f;
  bool nan = false;
  for (int i = lane; i < p.ring_len; i += 32) {
    const float v = p.ring[i];
    nan |= isnan(v);
    m = i == lane ? v : fmaxf(m, v);
  }
  if (lane >= p.ring_len) m = -INFINITY;
  for (int o = 16; o > 0; o >>= 1) {
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  }
  nan = __any_sync(0xffffffffu, nan);
  return (!nan && m > 0.f) ? __fdiv_rn(m, p.qmax) : 1.f;
}

// One 64 x 64 tile: the row pass (cast, q, residual, the tile into shared
// memory) and the column pass (q^T). Returns the largest |v| bits seen.
template <int IN, bool WEIGHT>
__device__ __forceinline__ uint32_t cast_tile(const Params& p, float s,
                                              uint8_t (&tile)[kTile][kTile],
                                              int r0, int c0) {
  using T = typename In<IN>::T;
  constexpr bool RAW = IN == kRaw;
  const int tid = threadIdx.x;
  const bool e5m2 = p.e5m2 != 0;

  // Row pass: 16 elements of row r, columns cb .. cb + 15, packed four
  // payload bytes a word (registers, not an addressed array).
  const int r = tid >> 2, cb = (tid & 3) * kChunk;
  const int row = r0 + r, col = c0 + cb;
  const bool full = row < p.rows && col + kChunk <= p.cols;
  uint32_t amax = 0u;
  uint32_t qw[kChunk / 4] = {0u, 0u, 0u, 0u};
  if (row < p.rows && col < p.cols) {
    const T* src = static_cast<const T*>(p.x) + row * p.ldx + col;
    T xv[kChunk];
    if (full && p.vec_x) {
      constexpr int kVec = kChunk * int(sizeof(T)) / 16;
      uint4 raw[kVec];
#pragma unroll
      for (int i = 0; i < kVec; ++i) raw[i] = reinterpret_cast<const uint4*>(src)[i];
#pragma unroll
      for (int i = 0; i < kChunk; ++i) xv[i] = reinterpret_cast<const T*>(raw)[i];
    } else {
#pragma unroll
      for (int i = 0; i < kChunk; ++i) xv[i] = col + i < p.cols ? src[i] : T();
    }
    float rv[kChunk], nr[kChunk];
    const long long off = static_cast<long long>(row) * p.cols + col;
    if (WEIGHT) {
      if (full && p.vec_res) {
#pragma unroll
        for (int i = 0; i < kChunk / 4; ++i) {
          const float4 v = reinterpret_cast<const float4*>(p.res + off)[i];
          rv[4 * i] = v.x;
          rv[4 * i + 1] = v.y;
          rv[4 * i + 2] = v.z;
          rv[4 * i + 3] = v.w;
        }
      } else {
#pragma unroll
        for (int i = 0; i < kChunk; ++i) {
          rv[i] = col + i < p.cols ? p.res[off + i] : 0.f;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      uint32_t b;
      if (RAW) {
        b = reinterpret_cast<const uint8_t&>(xv[i]);
      } else {
        float v = In<IN>::f(xv[i]);
        if (WEIGHT) v = __fadd_rn(v, rv[i]);
        if (col + i < p.cols) amax = max(amax, __float_as_uint(v) & 0x7fffffffu);
        const uint8_t q = to_fp8(__fdiv_rn(v, s), p.qmax, e5m2);
        if (WEIGHT) nr[i] = __fsub_rn(v, __fmul_rn(from_fp8(q, e5m2), s));
        b = q;
      }
      qw[i / 4] |= b << (8 * (i % 4));
    }
    if (WEIGHT) {
      if (full && p.vec_res) {
#pragma unroll
        for (int i = 0; i < kChunk / 4; ++i) {
          reinterpret_cast<float4*>(p.res_out + off)[i] =
              make_float4(nr[4 * i], nr[4 * i + 1], nr[4 * i + 2],
                          nr[4 * i + 3]);
        }
      } else {
#pragma unroll
        for (int i = 0; i < kChunk; ++i) {
          if (col + i < p.cols) p.res_out[off + i] = nr[i];
        }
      }
    }
    if (p.q) {
      uint8_t* dst = p.q + row * p.ldq + col;
      if (full && p.vec_q) {
        *reinterpret_cast<uint4*>(dst) = make_uint4(qw[0], qw[1], qw[2], qw[3]);
      } else {
#pragma unroll
        for (int i = 0; i < kChunk; ++i) {
          if (col + i < p.cols) dst[i] = (qw[i / 4] >> (8 * (i % 4))) & 0xffu;
        }
      }
    }
  }
  if (p.qt) {
    *reinterpret_cast<uint4*>(&tile[r][cb]) = make_uint4(qw[0], qw[1], qw[2], qw[3]);
    __syncthreads();
    // Column pass: rows rb .. rb + 15 of column c, one row of q^T.
    const int c = tid & (kTile - 1), rb = (tid >> 6) * kChunk;
    const int tcol = c0 + c, trow = r0 + rb;
    if (tcol < p.cols && trow < p.rows) {
      uint32_t tw[kChunk / 4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int i = 0; i < kChunk; ++i) {
        tw[i / 4] |= static_cast<uint32_t>(tile[rb + i][c]) << (8 * (i % 4));
      }
      uint8_t* dst = p.qt + tcol * p.ldqt + trow;
      if (trow + kChunk <= p.rows && p.vec_qt) {
        *reinterpret_cast<uint4*>(dst) = make_uint4(tw[0], tw[1], tw[2], tw[3]);
      } else {
#pragma unroll
        for (int i = 0; i < kChunk; ++i) {
          if (trow + i < p.rows) dst[i] = (tw[i / 4] >> (8 * (i % 4))) & 0xffu;
        }
      }
    }
    __syncthreads();  // the tile is rewritten by the next one's row pass
  }
  return amax;
}

// A grid-stride loop over the tiles (at most a few blocks an SM), so the
// ring's scale is read and the two workspace atomics are taken once a
// block, not once a tile.
template <int IN, bool WEIGHT>
__global__ void __launch_bounds__(kThreads)
    fp8_cast_kernel(const Params p) {
  constexpr bool RAW = IN == kRaw;
  __shared__ __align__(16) uint8_t tile[kTile][kTile];
  __shared__ float s_scale;
  __shared__ unsigned int s_amax[kThreads / 32];

  const int tid = threadIdx.x;
  if (!RAW) {
    if (tid < 32) {
      const float s = ring_scale(p);
      if (tid == 0) {
        s_scale = s;
        if (blockIdx.x == 0) *p.scale_out = s;
      }
    }
    __syncthreads();
  }
  const float s = RAW ? 1.f : s_scale;
  const int tiles_c = (p.cols + kTile - 1) / kTile;
  const int tiles = tiles_c * ((p.rows + kTile - 1) / kTile);
  uint32_t amax = 0u;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    amax = max(amax, cast_tile<IN, WEIGHT>(p, s, tile, (t / tiles_c) * kTile,
                                           (t % tiles_c) * kTile));
  }
  if (RAW) return;
  amax = __reduce_max_sync(0xffffffffu, amax);
  if ((tid & 31) == 0) s_amax[tid >> 5] = amax;
  __syncthreads();
  if (tid == 0) {
    unsigned int m = 0u;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) m = max(m, s_amax[w]);
    atomicMax(&p.ws[0], m);
    __threadfence();
    if (atomicAdd(&p.ws[1], 1u) == gridDim.x - 1) {  // the last block
      __threadfence();
      p.ring_out[0] = __uint_as_float(atomicExch(&p.ws[0], 0u));
      for (int i = 1; i < p.ring_len; ++i) p.ring_out[i] = p.ring[i - 1];
      atomicExch(&p.ws[1], 0u);
    }
  }
}

template <int IN, bool WEIGHT>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  static int sms = 0;
  if (!sms) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    if (err != cudaSuccess) return err;
  }
  const long long tiles = static_cast<long long>((p.cols + kTile - 1) / kTile) *
                          ((p.rows + kTile - 1) / kTile);
  const long long most = 8LL * sms;  // 8 blocks of 256 threads fill an SM
  fp8_cast_kernel<IN, WEIGHT>
      <<<static_cast<int>(tiles < most ? tiles : most), kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

bool aligned16(const void* ptr, long long ld_bytes) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && ld_bytes % 16 == 0;
}

}  // namespace

// Plain C entry point for ctypes. in_kind: 0 fp32, 1 bf16, 2 fp8 bytes (the
// relayout: ring, residual, scale and workspace are ignored). x is [rows,
// cols] with row stride ldx elements. residual (weight mode, fp32 [rows,
// cols] contiguous) may be null; then residual_out is ignored. q and qt may
// each be null; q is [rows, cols] with row stride ldq, qt [cols, rows] with
// row stride ldqt. ring / ring_out hold ring_len floats; workspace two
// zeroed 32-bit words. Returns a cudaError_t (0 when the launch was
// accepted).
extern "C" int hvt_fp8_cast(const void* x, long long ldx, const void* residual,
                            void* residual_out, const void* ring,
                            void* ring_out, void* scale_out, void* q,
                            long long ldq, void* qt, long long ldqt,
                            void* workspace, int rows, int cols, int ring_len,
                            float qmax, int in_kind, int e5m2, void* stream) {
  if (rows <= 0 || cols <= 0 || in_kind < 0 || in_kind > 2 || (!q && !qt) ||
      (in_kind != kRaw && (ring_len < 1 || !ring || !ring_out ||
                           !scale_out || !workspace)) ||
      (in_kind == kRaw && residual)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.x = x;
  p.ldx = ldx;
  p.res = static_cast<const float*>(residual);
  p.res_out = static_cast<float*>(residual_out);
  p.ring = static_cast<const float*>(ring);
  p.ring_out = static_cast<float*>(ring_out);
  p.scale_out = static_cast<float*>(scale_out);
  p.q = static_cast<uint8_t*>(q);
  p.qt = static_cast<uint8_t*>(qt);
  p.ldq = ldq;
  p.ldqt = ldqt;
  p.ws = static_cast<unsigned int*>(workspace);
  p.rows = rows;
  p.cols = cols;
  p.ring_len = ring_len;
  p.qmax = qmax;
  p.e5m2 = e5m2;
  const int esize = in_kind == kF32 ? 4 : (in_kind == kBF16 ? 2 : 1);
  p.vec_x = aligned16(x, ldx * esize);
  p.vec_res = residual && aligned16(residual, cols * 4LL) &&
              aligned16(residual_out, cols * 4LL);
  p.vec_q = q && aligned16(q, ldq);
  p.vec_qt = qt && aligned16(qt, ldqt);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_kind == kRaw) return static_cast<int>(launch<kRaw, false>(p, s));
  if (in_kind == kBF16) {
    return static_cast<int>(residual ? launch<kBF16, true>(p, s)
                                     : launch<kBF16, false>(p, s));
  }
  return static_cast<int>(residual ? launch<kF32, true>(p, s)
                                   : launch<kF32, false>(p, s));
}
