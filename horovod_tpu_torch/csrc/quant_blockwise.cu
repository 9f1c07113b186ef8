// Blockwise quantize and dequantize for Hopper (sm_90a), written by hand in
// CUDA C++: the int8 / fp8 (e4m3) wire of the quantized collectives.
//
// Replaces horovod_tpu/ops/pallas_kernels.py::_quant_kernel and
// ::_dequant_kernel, the Pallas TPU kernels behind quantize_blockwise_pallas
// and dequantize_blockwise_pallas. A flat fp32 buffer of n elements is cut
// into scale blocks of `block` elements (the last one zero-padded, as
// ops/quantization.py::_blocks_view pads it); per block:
//
//   amax  = max |x|                        (NaN if the block holds a NaN)
//   scale = amax > 0 ? amax / qmax : 1     (so a NaN or all-zero block gets 1)
//   int8: q = clip(round_half_even(x / scale), -qmax, qmax)
//   e4m3: q = x / scale rounded to nearest even, no saturation
//   dequantize: out = float(q) * scale
//
// Every operation is IEEE-rounded in the plain version's order
// (ops/quantization.py::quantize_blockwise_reference): the two divisions go
// through __fdiv_rn, never a multiply by a reciprocal (which is what makes
// the Pallas interpreter's scales drift by an ulp), rounding is rintf (half
// to even, like torch.round and jnp.round), and the product of the dequantize
// is __fmul_rn. So payloads, scales and dequantized values equal the plain
// version's bit for bit; only the int8 value of a NaN element is undefined,
// in both frameworks. fmaxf drops NaN where torch.amax propagates it, so the
// kernels carry a NaN flag beside the max.
//
// Work split. No 128-lane row tiles as on the TPU: a scale block is a row of
// any length, and elements at or past n read as 0 with no padded copy.
// * block <= 1024: one warp per scale block. Each lane keeps its share of the
//   block in registers (8 floats up to block 256, at most 32), the warp
//   reduces max and NaN flag by shuffles, then writes the payload from the
//   registers: x is read once.
// * block > 1024: one CTA per scale block, a shared-memory reduce, and a
//   second read of the block (from L2 where it still holds it) to write.
// * dequantize: one warp (block <= 1024) or CTA per scale block, the scale
//   read once, the payload read and the output written once.
// Loads are 16-byte float4 and payload stores 4-byte words where block % 4
// == 0 and the buffers are aligned for it; else element by element.
//
// What bounds it on an H100 SXM: a quantize pass reads 4 bytes an element and
// writes 1 + 4/block; a dequantize reads 1 + 4/block and writes 4. At a few
// operations an element both are far below the card's 295 operations a byte:
// bytes bound them. For GPT-2 small's 124,439,808 gradient elements at block
// 256 that is 624 MB a pass, 0.186 ms at 3.35 TB/s.

#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxWarpBlock = 1024;  // largest scale block one warp holds
constexpr int kWarpsPerCta = 8;      // scale blocks per CTA on the warp path
constexpr int kCtaThreads = 512;     // threads of the CTA-per-block path
constexpr unsigned kFull = 0xffffffffu;

struct Int8Wire {
  static __device__ __forceinline__ uint8_t encode(float x, float scale,
                                                   float qmax) {
    float r = rintf(__fdiv_rn(x, scale));
    r = fminf(fmaxf(r, -qmax), qmax);
    return static_cast<uint8_t>(static_cast<int8_t>(__float2int_rn(r)));
  }
  static __device__ __forceinline__ float decode(uint8_t q) {
    return static_cast<float>(static_cast<int8_t>(q));
  }
};

struct E4m3Wire {
  static __device__ __forceinline__ uint8_t encode(float x, float scale,
                                                   float) {
    return static_cast<uint8_t>(
        __nv_cvt_float_to_fp8(__fdiv_rn(x, scale), __NV_NOSAT, __NV_E4M3));
  }
  static __device__ __forceinline__ float decode(uint8_t q) {
    // e4m3 -> half is exact, as is half -> float.
    const __half_raw h = __nv_cvt_fp8_to_halfraw(
        static_cast<__nv_fp8_storage_t>(q), __NV_E4M3);
    return __half2float(__half(h));
  }
};

// VEC elements from index i (i a multiple of VEC); elements at or past n,
// and all of them when !valid, read as 0.
template <int VEC>
__device__ __forceinline__ void load_group(const float* __restrict__ x,
                                           long long i, long long n, bool valid,
                                           float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    if (valid && i + 4 <= n) {
      const float4 f = *reinterpret_cast<const float4*>(x + i);
      v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
      return;
    }
  }
#pragma unroll
  for (int j = 0; j < VEC; ++j) v[j] = (valid && i + j < n) ? x[i + j] : 0.f;
}

template <typename Wire, int VEC>
__device__ __forceinline__ void store_group(uint8_t* __restrict__ q, long long i,
                                            long long n, const float (&v)[VEC],
                                            float scale, float qmax) {
  uint8_t b[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) b[j] = Wire::encode(v[j], scale, qmax);
  if constexpr (VEC == 4) {
    if (i + 4 <= n) {
      *reinterpret_cast<uchar4*>(q + i) = make_uchar4(b[0], b[1], b[2], b[3]);
      return;
    }
  }
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    if (i + j < n) q[i + j] = b[j];
  }
}

template <int VEC>
__device__ __forceinline__ void fold(const float (&v)[VEC], float& amax,
                                     bool& nan) {
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    amax = fmaxf(amax, fabsf(v[j]));
    nan = nan || isnan(v[j]);
  }
}

__device__ __forceinline__ float block_scale(float amax, bool nan, float qmax) {
  return (!nan && amax > 0.f) ? __fdiv_rn(amax, qmax) : 1.f;
}

// One warp per scale block (block <= 1024); the block stays in registers,
// PER groups of VEC elements a lane (block <= 32 * PER * VEC).
template <typename Wire, int VEC, int PER>
__global__ void __launch_bounds__(kWarp * kWarpsPerCta)
    quantize_blockwise_kernel_warp(const float* __restrict__ x,
                                   uint8_t* __restrict__ q,
                                   float* __restrict__ scales, long long n,
                                   int block, long long n_blocks, float qmax) {
  const int lane = threadIdx.x % kWarp;
  const int groups = block / VEC;
  const long long n_warps = (long long)gridDim.x * kWarpsPerCta;
  for (long long b = (long long)blockIdx.x * kWarpsPerCta + threadIdx.x / kWarp;
       b < n_blocks; b += n_warps) {
    const long long base = b * block;
    float v[PER][VEC];
    float amax = 0.f;
    bool nan = false;
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int g = lane + kWarp * k;
      load_group<VEC>(x, base + (long long)g * VEC, n, g < groups, v[k]);
      fold<VEC>(v[k], amax, nan);
    }
#pragma unroll
    for (int off = kWarp / 2; off > 0; off /= 2) {
      amax = fmaxf(amax, __shfl_xor_sync(kFull, amax, off));
    }
    nan = __any_sync(kFull, nan);
    const float scale = block_scale(amax, nan, qmax);
    if (lane == 0) scales[b] = scale;
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int g = lane + kWarp * k;
      if (g < groups) {
        store_group<Wire, VEC>(q, base + (long long)g * VEC, n, v[k], scale,
                               qmax);
      }
    }
  }
}

// One CTA per scale block (block > 1024): reduce through shared memory, then
// read the block again to write it.
template <typename Wire, int VEC>
__global__ void __launch_bounds__(kCtaThreads)
    quantize_blockwise_kernel_cta(const float* __restrict__ x,
                                  uint8_t* __restrict__ q,
                                  float* __restrict__ scales, long long n,
                                  int block, long long n_blocks, float qmax) {
  __shared__ float s_max[kCtaThreads / kWarp];
  __shared__ int s_nan[kCtaThreads / kWarp];
  __shared__ float s_scale;
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const int groups = block / VEC;
  for (long long b = blockIdx.x; b < n_blocks; b += gridDim.x) {
    const long long base = b * block;
    float amax = 0.f;
    bool nan = false;
    for (int g = threadIdx.x; g < groups; g += blockDim.x) {
      float v[VEC];
      load_group<VEC>(x, base + (long long)g * VEC, n, true, v);
      fold<VEC>(v, amax, nan);
    }
#pragma unroll
    for (int off = kWarp / 2; off > 0; off /= 2) {
      amax = fmaxf(amax, __shfl_xor_sync(kFull, amax, off));
    }
    nan = __any_sync(kFull, nan);
    if (lane == 0) {
      s_max[warp] = amax;
      s_nan[warp] = nan;
    }
    __syncthreads();
    if (warp == 0) {
      const int n_warps = blockDim.x / kWarp;
      amax = lane < n_warps ? s_max[lane] : 0.f;
      nan = lane < n_warps ? s_nan[lane] != 0 : false;
#pragma unroll
      for (int off = kWarp / 2; off > 0; off /= 2) {
        amax = fmaxf(amax, __shfl_xor_sync(kFull, amax, off));
      }
      nan = __any_sync(kFull, nan);
      if (lane == 0) {
        s_scale = block_scale(amax, nan, qmax);
        scales[b] = s_scale;
      }
    }
    __syncthreads();
    const float scale = s_scale;
    for (int g = threadIdx.x; g < groups; g += blockDim.x) {
      float v[VEC];
      const long long i = base + (long long)g * VEC;
      load_group<VEC>(x, i, n, true, v);
      store_group<Wire, VEC>(q, i, n, v, scale, qmax);
    }
    __syncthreads();  // s_scale is rewritten for the next block
  }
}

// One team (a warp, or the whole CTA when team == blockDim.x) per scale block.
template <typename Wire, int VEC>
__global__ void __launch_bounds__(kCtaThreads)
    dequantize_blockwise_kernel(const uint8_t* __restrict__ q,
                                const float* __restrict__ scales,
                                float* __restrict__ out, long long n, int block,
                                long long n_blocks, int team) {
  const int teams = blockDim.x / team;
  const int rank = threadIdx.x % team;
  const int groups = block / VEC;
  for (long long b = (long long)blockIdx.x * teams + threadIdx.x / team;
       b < n_blocks; b += (long long)gridDim.x * teams) {
    const float scale = scales[b];
    const long long base = b * block;
    for (int g = rank; g < groups; g += team) {
      const long long i = base + (long long)g * VEC;
      if constexpr (VEC == 4) {
        if (i + 4 <= n) {
          const uchar4 w = *reinterpret_cast<const uchar4*>(q + i);
          *reinterpret_cast<float4*>(out + i) = make_float4(
              __fmul_rn(Wire::decode(w.x), scale),
              __fmul_rn(Wire::decode(w.y), scale),
              __fmul_rn(Wire::decode(w.z), scale),
              __fmul_rn(Wire::decode(w.w), scale));
          continue;
        }
      }
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        if (i + j < n) out[i + j] = __fmul_rn(Wire::decode(q[i + j]), scale);
      }
    }
  }
}

bool aligned(const void* ptr, int bytes) {
  return reinterpret_cast<uintptr_t>(ptr) % bytes == 0;
}

unsigned grid(long long items, long long per_cta, long long cap) {
  long long g = (items + per_cta - 1) / per_cta;
  if (g > cap) g = cap;  // grid-stride beyond the cap
  return static_cast<unsigned>(g < 1 ? 1 : g);
}

template <typename Wire, int VEC>
cudaError_t quantize(const float* x, uint8_t* q, float* scales, long long n,
                     int block, long long n_blocks, float qmax, cudaStream_t s) {
  const unsigned warp_grid = grid(n_blocks, kWarpsPerCta, 132LL * 16);
  if (block <= kWarp * VEC * 2) {  // block 256 and below with float4s
    quantize_blockwise_kernel_warp<Wire, VEC, 2>
        <<<warp_grid, kWarp * kWarpsPerCta, 0, s>>>(x, q, scales, n, block,
                                                   n_blocks, qmax);
  } else if (block <= kMaxWarpBlock) {
    quantize_blockwise_kernel_warp<Wire, VEC, kMaxWarpBlock / kWarp / VEC>
        <<<warp_grid, kWarp * kWarpsPerCta, 0, s>>>(x, q, scales, n, block,
                                                   n_blocks, qmax);
  } else {
    quantize_blockwise_kernel_cta<Wire, VEC>
        <<<grid(n_blocks, 1, 132LL * 4), kCtaThreads, 0, s>>>(
            x, q, scales, n, block, n_blocks, qmax);
  }
  return cudaGetLastError();
}

template <typename Wire, int VEC>
cudaError_t dequantize(const uint8_t* q, const float* scales, float* out,
                       long long n, int block, long long n_blocks,
                       cudaStream_t s) {
  const int team = block <= kMaxWarpBlock ? kWarp : kCtaThreads;
  dequantize_blockwise_kernel<Wire, VEC>
      <<<grid(n_blocks, kCtaThreads / team, 132LL * 16), kCtaThreads, 0, s>>>(
          q, scales, out, n, block, n_blocks, team);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry points for ctypes. x and out are fp32, q the one-byte wire
// (wire 0 = int8, 1 = fp8 e4m3), scales fp32 of ceil(n / block) blocks; all
// contiguous on the device. Launch on `stream`, never synchronize. Return a
// cudaError_t (0 on a successful launch).
extern "C" int hvt_quantize_blockwise(const void* x, void* q, void* scales,
                                      long long n, int block, int wire,
                                      float qmax, void* stream) {
  if (n <= 0) return 0;
  if (block < 1 || (wire != 0 && wire != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long n_blocks = (n + block - 1) / block;
  const float* xf = static_cast<const float*>(x);
  uint8_t* qb = static_cast<uint8_t*>(q);
  float* sf = static_cast<float*>(scales);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = block % 4 == 0 && aligned(x, 16) && aligned(q, 4);
  cudaError_t rc;
  if (wire == 0) {
    rc = vec ? quantize<Int8Wire, 4>(xf, qb, sf, n, block, n_blocks, qmax, s)
             : quantize<Int8Wire, 1>(xf, qb, sf, n, block, n_blocks, qmax, s);
  } else {
    rc = vec ? quantize<E4m3Wire, 4>(xf, qb, sf, n, block, n_blocks, qmax, s)
             : quantize<E4m3Wire, 1>(xf, qb, sf, n, block, n_blocks, qmax, s);
  }
  return static_cast<int>(rc);
}

extern "C" int hvt_dequantize_blockwise(const void* q, const void* scales,
                                        void* out, long long n, int block,
                                        int wire, void* stream) {
  if (n <= 0) return 0;
  if (block < 1 || (wire != 0 && wire != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long n_blocks = (n + block - 1) / block;
  const uint8_t* qb = static_cast<const uint8_t*>(q);
  const float* sf = static_cast<const float*>(scales);
  float* of = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = block % 4 == 0 && aligned(q, 4) && aligned(out, 16);
  cudaError_t rc;
  if (wire == 0) {
    rc = vec ? dequantize<Int8Wire, 4>(qb, sf, of, n, block, n_blocks, s)
             : dequantize<Int8Wire, 1>(qb, sf, of, n, block, n_blocks, s);
  } else {
    rc = vec ? dequantize<E4m3Wire, 4>(qb, sf, of, n, block, n_blocks, s)
             : dequantize<E4m3Wire, 1>(qb, sf, of, n, block, n_blocks, s);
  }
  return static_cast<int>(rc);
}
