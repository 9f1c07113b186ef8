// Fused AdamW update for Hopper (sm_90a), written by hand in CUDA C++.
//
// Replaces horovod_tpu/ops/pallas_kernels.py::_fused_adamw_kernel, the
// Pallas TPU kernel behind fused_adamw_update_pallas (the ZeRO-1 sharded
// weight update's one pass over each flat shard bucket). It computes the
// same function, in fp32 whatever the buffer dtypes:
//
//   c = count + 1;  m' = (1 - b1) g + b1 m;  v' = (1 - b2) g^2 + b2 v
//   u = (m' / (1 - b1^c)) / (sqrt(v' / (1 - b2^c) + eps_root) + eps)
//   u = u + weight_decay * p   (when weight_decay != 0)
//   update = -lr * u           (stored in p's dtype; m', v' in theirs)
//
// count is read from a device int32 scalar (the optax step count before
// this update), so a training step never waits on the host for it, as the
// TPU kernel keeps it a device scalar. m and v may be updated in place
// (m_out == m, v_out == v): each element is read and written by one thread.
//
// Every operation is IEEE-rounded in the order the plain PyTorch version
// (ops/fused_adamw.py) rounds it: the products and sums go through the
// __fmul_rn / __fadd_rn / __fsub_rn intrinsics, which nvcc never contracts
// into fused multiply-adds, and division and square root are the correctly
// rounded ones. Only powf for the bias corrections may round differently
// from torch.pow.
//
// Work split. No padding to 128-lane rows as on the TPU: a grid-stride loop
// gives each thread groups of four elements, read with 16-byte (fp32) or
// 8-byte (bf16) vector loads where a buffer is aligned for them, and the
// ragged tail element by element.
//
// What bounds it on an H100 SXM: it reads p, m, v, g and writes the update,
// m and v: 28 bytes an element with fp32 buffers and about 30 operations,
// far below the card's 295 operations a byte, so bytes bound it. For GPT-2
// small's 124,439,808 parameters at world 1 that is 3.48 GB, 1.04 ms at
// 3.35 TB/s.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct AdamArgs {
  float neg_lr;        // -lr
  float b1, b2;
  float one_minus_b1;  // (1 - b1), rounded once from the double
  float one_minus_b2;
  float eps, eps_root, weight_decay;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f(float& dst, float x) { dst = x; }
__device__ __forceinline__ void from_f(__nv_bfloat16& dst, float x) {
  dst = __float2bfloat16_rn(x);
}

// Four consecutive elements from i, as one vector load when aligned.
__device__ __forceinline__ void load4(const float* ptr, long long i, bool vec,
                                      float (&x)[4]) {
  if (vec) {
    const float4 v = *reinterpret_cast<const float4*>(ptr + i);
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) x[j] = ptr[i + j];
  }
}

__device__ __forceinline__ void load4(const __nv_bfloat16* ptr, long long i,
                                      bool vec, float (&x)[4]) {
  if (vec) {
    const uint2 raw = *reinterpret_cast<const uint2*>(ptr + i);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
    for (int j = 0; j < 4; ++j) x[j] = __bfloat162float(e[j]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) x[j] = __bfloat162float(ptr[i + j]);
  }
}

__device__ __forceinline__ void store4(float* ptr, long long i, bool vec,
                                       const float (&x)[4]) {
  if (vec) {
    *reinterpret_cast<float4*>(ptr + i) = make_float4(x[0], x[1], x[2], x[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) ptr[i + j] = x[j];
  }
}

__device__ __forceinline__ void store4(__nv_bfloat16* ptr, long long i, bool vec,
                                       const float (&x)[4]) {
  __nv_bfloat16 e[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) e[j] = __float2bfloat16_rn(x[j]);
  if (vec) {
    *reinterpret_cast<uint2*>(ptr + i) = *reinterpret_cast<const uint2*>(e);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) ptr[i + j] = e[j];
  }
}

// One element, in the plain version's order of operations.
__device__ __forceinline__ void adam_one(float p, float m, float v, float g,
                                         const AdamArgs& a, float bc1, float bc2,
                                         float& u, float& nm, float& nv) {
  nm = __fadd_rn(__fmul_rn(a.one_minus_b1, g), __fmul_rn(a.b1, m));
  nv = __fadd_rn(__fmul_rn(a.one_minus_b2, __fmul_rn(g, g)), __fmul_rn(a.b2, v));
  const float mhat = __fdiv_rn(nm, bc1);
  const float vhat = __fdiv_rn(nv, bc2);
  float x = __fdiv_rn(mhat, __fadd_rn(__fsqrt_rn(__fadd_rn(vhat, a.eps_root)), a.eps));
  if (a.weight_decay != 0.f) x = __fadd_rn(x, __fmul_rn(a.weight_decay, p));
  u = __fmul_rn(a.neg_lr, x);
}

// vec: bit 0 p, 1 m, 2 v, 3 g, 4 update, 5 m_out, 6 v_out aligned for
// vector access.
template <typename TP, typename TM>
__global__ void __launch_bounds__(kThreads) fused_adamw_kernel(
    const TP* __restrict__ p, const TM* m, const TM* v, const TP* __restrict__ g,
    TP* __restrict__ u, TM* m_out, TM* v_out, const int* __restrict__ count,
    long long n, AdamArgs a, int vec) {
  const float c = static_cast<float>(*count + 1);
  const float bc1 = __fsub_rn(1.f, powf(a.b1, c));
  const float bc2 = __fsub_rn(1.f, powf(a.b2, c));
  const long long groups = (n + 3) / 4;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x; q < groups;
       q += stride) {
    const long long i = q * 4;
    if (i + 4 <= n) {
      float xp[4], xm[4], xv[4], xg[4], xu[4], ym[4], yv[4];
      load4(p, i, vec & 1, xp);
      load4(m, i, vec & 2, xm);
      load4(v, i, vec & 4, xv);
      load4(g, i, vec & 8, xg);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        adam_one(xp[j], xm[j], xv[j], xg[j], a, bc1, bc2, xu[j], ym[j], yv[j]);
      }
      store4(u, i, vec & 16, xu);
      store4(m_out, i, vec & 32, ym);
      store4(v_out, i, vec & 64, yv);
    } else {
      for (long long e = i; e < n; ++e) {
        float xu, ym, yv;
        adam_one(to_f(p[e]), to_f(m[e]), to_f(v[e]), to_f(g[e]), a, bc1, bc2, xu,
                 ym, yv);
        from_f(u[e], xu);
        from_f(m_out[e], ym);
        from_f(v_out[e], yv);
      }
    }
  }
}

template <typename TP, typename TM>
cudaError_t launch(const void* p, const void* m, const void* v, const void* g,
                   void* u, void* m_out, void* v_out, const void* count,
                   long long n, const AdamArgs& a, cudaStream_t stream) {
  auto aligned = [](const void* ptr, int bytes) {
    return reinterpret_cast<uintptr_t>(ptr) % bytes == 0;
  };
  const int wp = 4 * sizeof(TP), wm = 4 * sizeof(TM);
  const int vec = aligned(p, wp) | aligned(m, wm) << 1 | aligned(v, wm) << 2 |
                  aligned(g, wp) << 3 | aligned(u, wp) << 4 |
                  aligned(m_out, wm) << 5 | aligned(v_out, wm) << 6;
  const long long groups = (n + 3) / 4;
  long long blocks = (groups + kThreads - 1) / kThreads;
  if (blocks > 132 * 32) blocks = 132 * 32;  // grid-stride beyond 32 per SM
  if (blocks < 1) blocks = 1;
  fused_adamw_kernel<TP, TM><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const TP*>(p), static_cast<const TM*>(m),
      static_cast<const TM*>(v), static_cast<const TP*>(g), static_cast<TP*>(u),
      static_cast<TM*>(m_out), static_cast<TM*>(v_out),
      static_cast<const int*>(count), n, a, vec);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes. p, g and the update share p_dtype; m, v
// and their outputs share m_dtype (0 = float32, 1 = bfloat16). count is a
// device int32 scalar. Returns a cudaError_t (0 on a successful launch).
extern "C" int hvt_fused_adamw(const void* p, const void* m, const void* v,
                               const void* g, void* u, void* m_out, void* v_out,
                               const void* count, long long n, int p_dtype,
                               int m_dtype, float neg_lr, float b1, float b2,
                               float one_minus_b1, float one_minus_b2, float eps,
                               float eps_root, float weight_decay, void* stream) {
  const AdamArgs a{neg_lr, b1, b2, one_minus_b1, one_minus_b2,
                   eps, eps_root, weight_decay};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0) return 0;
  const int key = p_dtype * 2 + m_dtype;
  switch (key) {
    case 0:
      return static_cast<int>(launch<float, float>(p, m, v, g, u, m_out, v_out,
                                                   count, n, a, s));
    case 1:
      return static_cast<int>(launch<float, __nv_bfloat16>(
          p, m, v, g, u, m_out, v_out, count, n, a, s));
    case 2:
      return static_cast<int>(launch<__nv_bfloat16, float>(
          p, m, v, g, u, m_out, v_out, count, n, a, s));
    case 3:
      return static_cast<int>(launch<__nv_bfloat16, __nv_bfloat16>(
          p, m, v, g, u, m_out, v_out, count, n, a, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
