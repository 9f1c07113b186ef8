// Hopper (sm_90a) building blocks shared by the flash-attention kernels
// (flash_fwd.cu, flash_bwd.cu) and the int8-weight matmul (int8_matmul.cu):
// mbarriers, TMA tile loads through 4-D tensor maps, shared-memory matrix
// descriptors of 128B-swizzled tiles, bf16 wgmma wrappers, register
// fragments, and the host side's tensor-map encoding, context binding
// (bind_device.cuh), shared-memory opt-in and SM count. Everything sits in
// an anonymous namespace: each source is its own library (ops/_build.py),
// and the library's hash covers this header.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums only: libcuda is not linked
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "bind_device.cuh"  // bind_device

namespace {

constexpr int kRowBytes = 128;               // a box row: 64 bf16, one swizzle span
constexpr int kGroupBytes = 8 * kRowBytes;   // eight rows: one swizzle atom
constexpr float kLog2e = 1.4426950408889634f;

// The (tile, batch, head) of work item `index` (the block's own in the
// two-argument form): tile index slowest, so every (batch, head) gets its
// tile t before any gets t + 1; `last_first` runs the tiles from the last.
struct Block {
  int tile, b, h;
};

template <typename P>
__device__ __forceinline__ Block block_of(const P& p, bool last_first,
                                          unsigned index) {
  const int bh = p.batch * p.n_heads;
  const int t = index / bh;
  const int r = index - t * bh;
  Block blk;
  blk.tile = last_first ? p.row_tiles - 1 - t : t;
  blk.b = r / p.n_heads;
  blk.h = r - blk.b * p.n_heads;
  return blk;
}

template <typename P>
__device__ __forceinline__ Block block_of(const P& p, bool last_first) {
  return block_of(p, last_first, blockIdx.x);
}

// The first 1024-byte boundary at or after p, as an offset from p: the
// pointer stays derived from the shared array, so its loads stay LDS.
__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  const uint32_t at = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return p + ((1024u - (at & 1023u)) & 1023u);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// Waits until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  }
}

// One box (64 columns x the map's rows) at column d0 of head h, row s0 of
// batch b.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int d0, int h, int s0,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(d0), "r"(h), "r"(s0), "r"(b)
      : "memory");
}

// Shared-memory matrix descriptors of a tile TMA wrote: 128-byte rows under
// the 128B swizzle, eight-row groups 1024 bytes apart, layout type 1.
// K-major (the contraction runs along the row): SBO 1024, LBO unused; a
// k-step of 16 is 32 bytes along the row. MN-major (the contraction runs
// down the rows, the transposed read): the eight-row groups are the K
// direction (1024 bytes), and a 64-column operand is one swizzle atom wide,
// so the other offset is unused; both are set to 1024. A k-step of 16 is
// 16 rows, 2048 bytes.
__device__ __forceinline__ uint64_t desc_k(const void* tile) {
  const uint64_t addr = smem_u32(tile);
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (uint64_t(kGroupBytes >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ uint64_t desc_mn(const void* tile) {
  const uint64_t addr = smem_u32(tile);
  return ((addr & 0x3FFFF) >> 4) | (uint64_t(kGroupBytes >> 4) << 16) |
         (uint64_t(kGroupBytes >> 4) << 32) | (1ull << 62);
}

template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
  }
}

// The two consumer warpgroups take turns at issuing their products: a
// warpgroup waits on its own named barrier (1 + wg) before it issues and
// then arrives on the other's, so one runs its elementwise work while the
// other's products occupy the tensor cores.
__device__ __forceinline__ void turn_wait(int wg) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(1 + wg) : "memory");
}

__device__ __forceinline__ void turn_pass(int wg) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - wg) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(PENDING) : "memory");
}

#define HVT_F8(d, o)                                                      \
  "+f"(d[(o) + 0]), "+f"(d[(o) + 1]), "+f"(d[(o) + 2]), "+f"(d[(o) + 3]), \
      "+f"(d[(o) + 4]), "+f"(d[(o) + 5]), "+f"(d[(o) + 6]), "+f"(d[(o) + 7])
#define HVT_R16                                                               \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
#define HVT_R32                                                               \
  HVT_R16 ", %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "   \
          "%28, %29, %30, %31"

// d (64 x N, fp32) = or += A (64 x 16, shared, K-major) B (16 x N, shared,
// K-major); accumulate == 0 overwrites d.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" HVT_R32
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : HVT_F8(d, 0), HVT_F8(d, 8), HVT_F8(d, 16), HVT_F8(d, 24)
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {" HVT_R16
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : HVT_F8(d, 0), HVT_F8(d, 8)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64, fp32) = or += A (64 x 16, registers) B (16 x 64, shared):
// B K-major, or MN-major (the transposed read) with kTransB.
template <bool kTransB>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" HVT_R32
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : HVT_F8(d, 0), HVT_F8(d, 8), HVT_F8(d, 16), HVT_F8(d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate),
        "n"(int(kTransB)));
}

#define HVT_R64                                                               \
  HVT_R32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "   \
          "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "  \
          "%57, %58, %59, %60, %61, %62, %63"
#define HVT_F64(d)                                                      \
  HVT_F8(d, 0), HVT_F8(d, 8), HVT_F8(d, 16), HVT_F8(d, 24), HVT_F8(d, 32), \
      HVT_F8(d, 40), HVT_F8(d, 48), HVT_F8(d, 56)

// d (64 x 128, fp32) = or += A (64 x 16, shared, K-major) B (16 x 128,
// shared, K-major).
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" HVT_R64
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : HVT_F64(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 128, fp32) = or += A (64 x 16, registers) B (16 x 128, shared):
// B K-major, or MN-major with kTransB.
template <bool kTransB>
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" HVT_R64
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : HVT_F64(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate),
        "n"(int(kTransB)));
}

// The register A fragments of the warp's 16 rows [r0, r0 + 16) of a K-major
// tile TMA wrote (box x of 64 columns at tile + x * box_bytes, 128-byte rows
// under the 128B swizzle: 16-byte unit u of row r sits at u ^ (r % 8)), one
// a k-step of 16 columns; r0 is a multiple of 8.
template <int KS>
__device__ __forceinline__ void load_a(uint32_t (&a)[KS][4], const uint8_t* tile,
                                       int box_bytes, int r0, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const uint8_t* lo = tile + (kk / 4) * box_bytes + (r0 + g) * kRowBytes + 4 * t;
    const uint8_t* hi = lo + 8 * kRowBytes;
    const int u0 = ((2 * (kk % 4)) ^ g) << 4, u1 = ((2 * (kk % 4) + 1) ^ g) << 4;
    a[kk][0] = *reinterpret_cast<const uint32_t*>(lo + u0);
    a[kk][1] = *reinterpret_cast<const uint32_t*>(hi + u0);
    a[kk][2] = *reinterpret_cast<const uint32_t*>(lo + u1);
    a[kk][3] = *reinterpret_cast<const uint32_t*>(hi + u1);
  }
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Register A fragments (64 x 16 each, bf16) from an fp32 accumulator of
// 64 x 16 N: accumulator i of a thread is row lane / 4 (+ 8 for odd i / 2)
// of its warp's 16, column 8 (i / 4) + 2 (lane % 4) (+ 1 for odd i), which
// is the A layout of the k-step holding its column.
template <int KS>
__device__ __forceinline__ void pack_a(uint32_t (&a)[KS][4],
                                       const float (&acc)[KS * 8]) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      a[kk][j] = pack_bf16x2(acc[8 * kk + 2 * j], acc[8 * kk + 2 * j + 1]);
    }
  }
}

PFN_cuTensorMapEncodeTiled_v12000 encode_fn() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (!fn) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(ptr);
    }
  }
  return fn;
}

// A strided bf16 [B, S, H, D] view (element strides st = {batch, seq, head},
// unit stride along D) as a 4-D map over (D, H, S, B), in boxes of 64
// columns x `rows` rows under the 128B swizzle; rows past S read zeros.
bool make_map(CUtensorMap* map, const void* base, int batch, int seq,
              int heads, int d, const long long* st, int rows) {
  const PFN_cuTensorMapEncodeTiled_v12000 encode = encode_fn();
  if (!encode) return false;
  cuuint64_t dims[4] = {static_cast<cuuint64_t>(d),
                        static_cast<cuuint64_t>(heads),
                        static_cast<cuuint64_t>(seq),
                        static_cast<cuuint64_t>(batch)};
  cuuint64_t strides[3] = {static_cast<cuuint64_t>(st[2] * 2),
                           static_cast<cuuint64_t>(st[1] * 2),
                           static_cast<cuuint64_t>(st[0] * 2)};
  cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Above 48 KB a kernel's dynamic shared memory must be opted into, once
// for each device (the attribute belongs to the current device).
template <typename Kernel>
cudaError_t opt_in(Kernel kernel, int bytes, std::atomic<uint64_t>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = dev < 64 ? 1ull << dev : 0;
  if (bit && (done.load(std::memory_order_relaxed) & bit)) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_relaxed);
  return err;
}

// SMs of the current device (0 when it cannot be asked): a persistent
// grid's size.
int sm_count() {
  static std::atomic<int> counts[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= 64) return 0;
  int n = counts[dev].load(std::memory_order_relaxed);
  if (n == 0 &&
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) == cudaSuccess) {
    counts[dev].store(n, std::memory_order_relaxed);
  }
  return n;
}

bool grid_fits(int tiles, int batch, int n_heads) {
  return static_cast<long long>(tiles) * batch * n_heads <= 0x7fffffffLL;
}

}  // namespace
