// fp8 matrix product for Hopper (sm_90a) on native fp8 wgmma and TMA,
// written by hand in CUDA C++.
//
// Replaces horovod_tpu/ops/pallas_kernels.py::_fp8_matmul_kernel (through
// fp8_matmul_pallas), the Pallas TPU kernel behind ops/quantization.fp8_matmul
// on the fp8 training path (compute_dtype="fp8"). It computes the same
// function:
//
//   out[M, N] = (sum_k upcast(a[m, k]) * upcast(b[k, n])) * scale_a * scale_b
//
// with fp8 operands (float8_e4m3fn or float8_e5m2, each operand its own, in
// all four pairings: the backward pass pairs an e5m2 gradient with e4m3
// operands), fp32 sums, the fp32 device scales multiplied (one IEEE rounding,
// as torch's sx * sk) and applied in the epilogue, and an fp32 or bf16 output.
//
// Layouts. Hopper's fp8 wgmma reads both operands K-major from shared memory
// (PTX has transpose qualifiers for f16/bf16 only), so the kernel takes
// K-major operands and nothing else: a [M, K] with k contiguous and b stored
// [N, K] with k contiguous, each row 16-byte aligned (TMA's rule). The fp8
// training path hands it exactly that: ops/quantization.fp8_cast writes each
// payload in both orientations in the pass that casts it. Any other layout is
// the wrapper's business (one K-major copy through fp8_cast.cu's byte mode).
//
// Loads and stores. One producer warp keeps a ring of kStages shared-memory
// stages full with TMA (cp.async.bulk.tensor, 128B swizzle, completion on an
// mbarrier a stage); a stage is a 128 x 128-byte tile of a and of b (32 KB). TMA's
// out-of-bounds zero fill pads ragged M, N and K (fp8 zero is exact zero).
// Each consumer warpgroup stages its scaled 64 x 128 outputs in shared
// memory (128B-swizzled, so a store instruction's eight rows hit eight bank
// groups) and one of its threads hands them to a TMA store, which clips
// ragged edges; the warpgroup goes on to its next item while it drains.
// The tensor maps are encoded on the host through cuTensorMapEncodeTiled,
// reached with cudaGetDriverEntryPoint (no -lcuda), and passed as
// __grid_constant__ parameters.
//
// Tensor cores. Two consumer warpgroups each own 64 rows of the 128 x 128
// output tile and issue wgmma.mma_async m64n128k32 (4 a stage) on the
// stage's tiles.
//
// Precision. Every product of two fp8 values is exact, but Hopper's fp8
// tensor cores keep fewer bits than fp32: on an H100 one k32 wgmma into a
// zeroed accumulator already rounds its 32-product sum to ~13 mantissa bits
// (chip_smoke.py's [fp8] phase prints this rounding at K = 32), and chaining
// k-steps in the tensor core's accumulator compounds it past the 1e-4 of
// the largest output the plain version is held to; chaining 2 or 4 did.
// So every k-step runs into a zeroed scratch accumulator and is promoted,
// added into fp32 registers (DeepSeek-V3 and DeepGEMM promote every 4
// k-steps): the error then stays that of one k-step's rounding, ~4e-5 of
// the largest output at any K, 16,384 (the weight gradient of a
// GPT-2-small step) included. Two scratch
// accumulators alternate, so one k-step runs while the last one is added;
// the adds cost the SM's fp32 pipe about as much issue time as the wgmma
// takes, which the two consumer warpgroups overlap only in part.
//
// Work split. A work item is one 128 x 128 output tile (kBM x kBN) over one
// range of K; a persistent grid of one block an SM walks the items, so the
// producer loads the next item's stages while the consumers store the last
// one's outputs. Where the output has too few tiles to fill the card (the
// weight gradient of a 768 x 768 projection: 36 tiles over K = 16,384) the
// wrapper splits the contraction; each split writes its fp32 partial sums to
// a workspace and a second kernel adds the splits in a fixed order, applies
// the scales and writes the output: deterministic, no atomics.
//
// Why these sizes. 128 x 128 tiles with two 64-row consumer warpgroups keep
// three 64-float accumulators (the promoted sum and two scratch) a thread,
// 192 registers, under setmaxnreg's 232; a wider tile would not fit. A
// 128-byte k tile is one 128B swizzle row, so a stage is one TMA box an
// operand. Five stages (160 KB, beside 64 KB of output staging, of the 227 KB
// a block may use) keep 4 tiles in flight while one is multiplied: a stage's
// 4.2 MFLOP take ~0.3-0.6 us on one SM, about one round trip to device
// memory. On an H100 the output staging with TMA stores took 10-27% off the
// forward products against stores from registers with six stages (the
// [fp8] phase of chip_smoke.py before and after).
//
// What bounds it on an H100 SXM (data-sheet peaks at its 700 W power limit:
// 1,979 TFLOP/s dense fp8, 3.35 TB/s of HBM3): at GPT-2 small's training
// shapes (M = 16,384 rows) the operations. The MLP's fc forward, 77.3 GFLOP,
// needs 39 us of fp8 tensor-core time and 35 us to move its 116 MB (fp8
// operands, bf16 output); a step's 216 launches need at least 4.2 ms.
//
// What this design leaves on the table: the fp32 adds of the per-k-step
// promotion compete with the wgmma for issue slots; the two consumer
// warpgroups finish an item together, so the tensor cores idle while both
// stage their outputs; 128 x 128 tiles need ~15 TB/s of L2 bandwidth at the
// fp8 peak, more than the card has (a cluster multicast of the shared tile
// would halve it); the split-K partial sums make a round trip through device
// memory.

#include <cuda.h>  // CUtensorMap and its enums only: libcuda is not linked
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bind_device.cuh"  // bind_device

namespace {

constexpr int kBM = 128;  // output rows per block (two 64-row warpgroups)
constexpr int kBN = 128;  // output columns per block
constexpr int kBK = 128;  // contraction bytes (= fp8 elements) per stage
constexpr int kStages = 5;
constexpr int kConsumers = 2;  // consumer warpgroups
constexpr int kThreads = (kConsumers + 1) * 128;
constexpr int kKSteps = kBK / 32;  // wgmma k-steps a stage
constexpr int kTileBytes = kBM * kBK;
// A consumer warpgroup's 64 x 128 output tile staged for its TMA store:
// boxes of 64 rows x 128 bytes (64 bf16 or 32 fp32 columns), 128B-swizzled.
constexpr int kOutBytes = 64 * kBN * 4;
constexpr int kSmemBytes =
    2 * kStages * kTileBytes + kConsumers * kOutBytes + 2 * kStages * 8 + 1024;
static_assert(kBM == kBN, "one TMA box shape for both operands");

struct Params {
  const float* scale_a;   // fp32 device scalars; scale_b may be null
  const float* scale_b;
  int m, n, k;
  int tiles_m, tiles_n, splits;
  int k_tiles_per_split;
  int out_bf16;
};

// One output tile of one contraction split: work item w of
// tiles_m * tiles_n * splits, the split slowest and the column fastest, so
// the blocks working at one time share rows of a and all of b in L2.
struct Work {
  int m0, n0, z, kt0, nk;
};

__device__ __forceinline__ Work work_of(const Params& p, int w) {
  Work t;
  const int per = p.tiles_m * p.tiles_n;
  t.z = w / per;
  const int r = w - t.z * per;
  t.m0 = (r / p.tiles_n) * kBM;
  t.n0 = (r % p.tiles_n) * kBN;
  const int k_tiles = (p.k + kBK - 1) / kBK;
  t.kt0 = t.z * p.k_tiles_per_split;
  t.nk = max(0, min(k_tiles, t.kt0 + p.k_tiles_per_split) - t.kt0);
  return t;
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

__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int k0, int row0) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(k0), "r"(row0)
      : "memory");
}

// Stores one box of the output (or of a split's partial sums) from shared
// memory; rows and columns past the tensor's edge are not written.
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          const void* src, int col, int row,
                                          int z) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(src)),
         "r"(col), "r"(row), "r"(z)
      : "memory");
}

__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(wg + 1) : "memory");
}

// Shared-memory matrix descriptor of a K-major tile with 128-byte rows under
// the 128B swizzle: start address, LBO 1 (unused when swizzled), SBO 1024
// bytes (eight rows), layout type 1. Moving 32 bytes along K adds 2.
__device__ __forceinline__ uint64_t desc_of(const void* tile) {
  const uint64_t addr = smem_u32(tile);
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) | ((1024ull >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void fence_operands(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define HVT_D64 \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
#define HVT_OUT64 \
    "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
    "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
    "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
    "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
    "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
    "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
    "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
    "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
// One wgmma.mma_async m64n128k32 with fp32 accumulators d[64] and fp8
// operands ATYPE x BTYPE from shared memory; accumulate == 0 overwrites d.
#define HVT_WGMMA_M64N128K32(ATYPE, BTYPE) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n128k32.f32." ATYPE "." BTYPE " {" \
      HVT_D64 "}, %64, %65, p, 1, 1;\n}\n" \
      : HVT_OUT64 \
      : "l"(da), "l"(db), "r"(accumulate))

template <bool AE5, bool BE5>
__device__ __forceinline__ void wgmma_m64n128k32(float (&d)[64], uint64_t da,
                                                 uint64_t db, int accumulate) {
  if (!AE5 && !BE5) HVT_WGMMA_M64N128K32("e4m3", "e4m3");
  if (!AE5 && BE5) HVT_WGMMA_M64N128K32("e4m3", "e5m2");
  if (AE5 && !BE5) HVT_WGMMA_M64N128K32("e5m2", "e4m3");
  if (AE5 && BE5) HVT_WGMMA_M64N128K32("e5m2", "e5m2");
}

__device__ __forceinline__ float scale_of(const Params& p) {
  return p.scale_b ? __fmul_rn(*p.scale_a, *p.scale_b) : *p.scale_a;
}

// One k-step into a fresh scratch accumulator t, as its own commit group.
template <bool AE5, bool BE5>
__device__ __forceinline__ void issue_step(float (&t)[64], uint64_t da,
                                           uint64_t db, int kk) {
  fence_operands(t);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
  wgmma_m64n128k32<AE5, BE5>(t, da + 2 * kk, db + 2 * kk, 0);
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void wait_steps() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(PENDING)
               : "memory");
}

__device__ __forceinline__ void promote(float (&acc)[64], float (&t)[64]) {
  fence_operands(t);
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] += t[i];
}

// One stage's four k-steps, each promoted into acc: two scratch
// accumulators alternate, so one k-step runs on the tensor cores while the
// previous one's sum is added.
template <bool AE5, bool BE5>
__device__ __forceinline__ void mma_stage(float (&acc)[64], float (&t0)[64],
                                          float (&t1)[64], uint64_t da,
                                          uint64_t db) {
  static_assert(kKSteps == 4, "the alternation below is written for 4");
  issue_step<AE5, BE5>(t0, da, db, 0);
  issue_step<AE5, BE5>(t1, da, db, 1);
  wait_steps<1>();
  promote(acc, t0);
  issue_step<AE5, BE5>(t0, da, db, 2);
  wait_steps<1>();
  promote(acc, t1);
  issue_step<AE5, BE5>(t1, da, db, 3);
  wait_steps<1>();
  promote(acc, t0);
  wait_steps<0>();
  promote(acc, t1);
}

// A persistent grid: each block walks work items blockIdx.x, + gridDim.x,
// ...; the producer runs ahead into the next item's stages while the
// consumers store the last one's outputs.
template <bool AE5, bool BE5>
__global__ void __launch_bounds__(kThreads, 1)
    fp8_matmul_kernel(const Params p, const __grid_constant__ CUtensorMap map_a,
                      const __grid_constant__ CUtensorMap map_b,
                      const __grid_constant__ CUtensorMap map_c) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* tiles_a = smem;
  uint8_t* tiles_b = smem + kStages * kTileBytes;
  uint8_t* outs = smem + 2 * kStages * kTileBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(outs + kConsumers * kOutBytes);
  uint64_t* empty = full + kStages;

  const int wg = threadIdx.x / 128;
  const int work = p.tiles_m * p.tiles_n * p.splits;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], kConsumers * 4);  // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {
    // Producer warpgroup: one thread keeps the ring full.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == kConsumers * 128) {
      int s = 0;
      uint32_t phase = 0;
      for (int w = blockIdx.x; w < work; w += gridDim.x) {
        const Work t = work_of(p, w);
        for (int i = 0; i < t.nk; ++i) {
          bar_wait(&empty[s], phase ^ 1);
          bar_expect_tx(&full[s], 2 * kTileBytes);
          const int kc = (t.kt0 + i) * kBK;
          tma_load(tiles_a + s * kTileBytes, &map_a, &full[s], kc, t.m0);
          tma_load(tiles_b + s * kTileBytes, &map_b, &full[s], kc, t.n0);
          if (++s == kStages) {
            s = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    float acc[64], t0[64], t1[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) t0[i] = t1[i] = 0.f;
    const int lane = threadIdx.x & 31;
    const int tw = threadIdx.x % 128;
    const bool split = p.splits > 1;  // fp32 partial sums, unscaled
    const bool bf16 = !split && p.out_bf16;
    const float s_out = split ? 1.f : scale_of(p);
    int s = 0;
    uint32_t phase = 0;
    for (int w = blockIdx.x; w < work; w += gridDim.x) {
      const Work t = work_of(p, w);
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = 0.f;
      for (int i = 0; i < t.nk; ++i) {
        bar_wait(&full[s], phase);
        mma_stage<AE5, BE5>(
            acc, t0, t1, desc_of(tiles_a + s * kTileBytes + wg * 64 * kBK),
            desc_of(tiles_b + s * kTileBytes));
        if (lane == 0) bar_arrive(&empty[s]);
        if (++s == kStages) {
          s = 0;
          phase ^= 1;
        }
      }

      // Accumulator i of a thread: row 16 w + lane / 4 (+ 8 for odd i / 2)
      // of the warpgroup's 64, columns 8 (i / 4) + 2 (lane % 4) and + 1.
      // Staged into 128B-swizzled boxes (16-byte unit u of row r at
      // u ^ (r % 8): the eight rows a store instruction touches fall in
      // eight bank groups), then one thread stores them with TMA while
      // the warpgroup goes on to its next item.
      uint8_t* out = outs + wg * kOutBytes;
      if (tw == 0) {  // the last item's stores have read the staging tile
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      }
      wg_sync(wg);
      const int q = lane % 4;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = (tw / 32) * 16 + lane / 4 + 8 * h;
          float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
          if (!split) {
            v0 = __fmul_rn(v0, s_out);
            v1 = __fmul_rn(v1, s_out);
          }
          if (bf16) {  // box j / 8, unit j % 8, bytes 4 q
            uint8_t* box = out + (j / 8) * 64 * 128;
            *reinterpret_cast<__nv_bfloat162*>(
                box + r * 128 + (((j % 8) ^ (r % 8)) * 16) + 4 * q) =
                __floats2bfloat162_rn(v0, v1);
          } else {  // box j / 4, unit 2 (j % 4) + q / 2, bytes 8 (q % 2)
            uint8_t* box = out + (j / 4) * 64 * 128;
            const int u = 2 * (j % 4) + q / 2;
            *reinterpret_cast<float2*>(box + r * 128 + ((u ^ (r % 8)) * 16) +
                                       8 * (q % 2)) = make_float2(v0, v1);
          }
        }
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      wg_sync(wg);
      const int row = t.m0 + wg * 64;
      if (tw == 0 && row < p.m) {
        const int boxes = bf16 ? 2 : 4, cols = bf16 ? 64 : 32;
        for (int b = 0; b < boxes; ++b) {
          tma_store(&map_c, out + b * 64 * 128, t.n0 + b * cols, row, t.z);
        }
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      }
    }
    if (tw == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}

// out = (sum over the splits, in split order) * scale_a * scale_b; ws and
// out are [M, N] with row stride ld (ws one such matrix a split).
__global__ void fp8_matmul_reduce_kernel(const Params p, const float* ws,
                                         void* out, long long ld,
                                         int out_bf16) {
  const long long total = static_cast<long long>(p.m) * p.n;
  const long long plane = static_cast<long long>(p.m) * ld;
  const float s = scale_of(p);
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long at = (i / p.n) * ld + i % p.n;
    float acc = ws[at];
    for (int z = 1; z < p.splits; ++z) acc += ws[z * plane + at];
    acc = __fmul_rn(acc, s);
    if (out_bf16) {
      static_cast<__nv_bfloat16*>(out)[at] = __float2bfloat16_rn(acc);
    } else {
      static_cast<float*>(out)[at] = acc;
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

// A [rows, K] K-major uint8 matrix with row stride ld bytes, in 128 x 128
// boxes under the 128B swizzle; out-of-bounds boxes read zeros.
bool make_map(CUtensorMap* map, const void* base, int rows, int k,
              long long ld) {
  const PFN_cuTensorMapEncodeTiled_v12000 encode = encode_fn();
  if (!encode) return false;
  cuuint64_t dims[2] = {static_cast<cuuint64_t>(k),
                        static_cast<cuuint64_t>(rows)};
  cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld)};
  cuuint32_t box[2] = {kBK, kBM};
  cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base),
                dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The output (splits == 1: [M, N] in its dtype) or the splits' fp32
// partial sums ([splits, M, N]), row stride ld elements, as a 3-D map of
// 64-row boxes of 128 bytes under the 128B swizzle.
bool make_out_map(CUtensorMap* map, void* base, int m, int n, int splits,
                  long long ld, bool bf16) {
  const PFN_cuTensorMapEncodeTiled_v12000 encode = encode_fn();
  if (!encode) return false;
  const int esize = bf16 ? 2 : 4;
  cuuint64_t dims[3] = {static_cast<cuuint64_t>(n),
                        static_cast<cuuint64_t>(m),
                        static_cast<cuuint64_t>(splits)};
  cuuint64_t strides[2] = {static_cast<cuuint64_t>(ld * esize),
                           static_cast<cuuint64_t>(ld * esize * m)};
  cuuint32_t box[3] = {static_cast<cuuint32_t>(128 / esize), 64, 1};
  cuuint32_t elem[3] = {1, 1, 1};
  return encode(map,
                bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                     : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                3, base, dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_NONE,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <bool AE5, bool BE5>
cudaError_t launch(const Params& p, const CUtensorMap& ma,
                   const CUtensorMap& mb, const CUtensorMap& mc, int splits,
                   cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        fp8_matmul_kernel<AE5, BE5>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  static int sms = 0;
  if (!sms) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    if (err != cudaSuccess) return err;
  }
  const int work = p.tiles_m * p.tiles_n * splits;
  fp8_matmul_kernel<AE5, BE5>
      <<<work < sms ? work : sms, kThreads, kSmemBytes, stream>>>(p, ma, mb,
                                                                  mc);
  return cudaGetLastError();
}

// The three tensor maps, the product and, with splits > 1, the sum of the
// splits, on the calling thread's current device.
int encode_and_launch(const void* a, const void* b, void* out, void* workspace,
                      const void* scale_a, const void* scale_b, int m, int n,
                      int k, long long lda, long long ldb, long long ldc,
                      int a_e5m2, int b_e5m2, int out_bf16, int splits,
                      cudaStream_t s) {
  CUtensorMap ma, mb, mc;
  const bool split = splits > 1;
  if (!make_map(&ma, a, m, k, lda) || !make_map(&mb, b, n, k, ldb) ||
      !make_out_map(&mc, split ? workspace : out, m, n, splits, ldc,
                    !split && out_bf16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.scale_a = static_cast<const float*>(scale_a);
  p.scale_b = static_cast<const float*>(scale_b);
  p.m = m;
  p.n = n;
  p.k = k;
  const int k_tiles = (k + kBK - 1) / kBK;
  p.k_tiles_per_split = (k_tiles + splits - 1) / splits;
  p.tiles_m = (m + kBM - 1) / kBM;
  p.tiles_n = (n + kBN - 1) / kBN;
  p.splits = splits;
  p.out_bf16 = out_bf16;
  cudaError_t err;
  if (a_e5m2 && b_e5m2) {
    err = launch<true, true>(p, ma, mb, mc, splits, s);
  } else if (a_e5m2) {
    err = launch<true, false>(p, ma, mb, mc, splits, s);
  } else if (b_e5m2) {
    err = launch<false, true>(p, ma, mb, mc, splits, s);
  } else {
    err = launch<false, false>(p, ma, mb, mc, splits, s);
  }
  if (err != cudaSuccess || !split) return static_cast<int>(err);
  const long long total = static_cast<long long>(m) * n;
  const int threads = 256;
  const long long want = (total + threads - 1) / threads;
  const int blocks = static_cast<int>(want < 4096 ? want : 4096);
  fp8_matmul_reduce_kernel<<<blocks, threads, 0, s>>>(
      p, static_cast<const float*>(workspace), out, ldc, out_bf16);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point for ctypes: launches on `stream` of `device` (the
// calling thread's current device is restored). a is [M, K] stored with k
// contiguous and row stride lda bytes; b is [K, N] stored as [N, K] with k
// contiguous and row stride ldb bytes; both bases and strides 16-byte
// aligned (the TMA's rule). out is [M, N] with row stride ldc elements, ldc
// a multiple of 8 (bf16) or 4 (fp32), 16-byte aligned. scale_b may be null.
// splits > 1 needs a 16-byte-aligned workspace of splits * M * ldc fp32.
// Returns a cudaError_t (0 when every launch was accepted;
// cudaErrorInvalidValue when the arguments or the tensor maps are refused).
extern "C" int hvt_fp8_matmul(const void* a, const void* b, void* out,
                              void* workspace, const void* scale_a,
                              const void* scale_b, int m, int n, int k,
                              long long lda, long long ldb, long long ldc,
                              int a_e5m2, int b_e5m2, int out_bf16, int splits,
                              int device, void* stream) {
  const int esize = out_bf16 ? 2 : 4;
  if (m <= 0 || n <= 0 || k <= 0 || splits < 1 ||
      (splits > 1 && !workspace) || lda % 16 || ldb % 16 ||
      (ldc * esize) % 16 || ldc < n || (ldc * 4) % 16 ||
      reinterpret_cast<uintptr_t>(a) % 16 ||
      reinterpret_cast<uintptr_t>(b) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16 ||
      reinterpret_cast<uintptr_t>(workspace) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // The maps are encoded in the card's context, which a thread whose first
  // CUDA call this is has not bound yet.
  int current = 0;
  const cudaError_t bound = bind_device(device, &current);
  if (bound != cudaSuccess) return static_cast<int>(bound);
  const int rc = encode_and_launch(a, b, out, workspace, scale_a, scale_b, m,
                                   n, k, lda, ldb, ldc, a_e5m2, b_e5m2,
                                   out_bf16, splits,
                                   static_cast<cudaStream_t>(stream));
  if (current != device) cudaSetDevice(current);
  return rc;
}
