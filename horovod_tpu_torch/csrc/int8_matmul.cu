// int8-weight matrix product (W8A16) for Hopper (sm_90a) on bf16 wgmma fed
// by TMA, written by hand in CUDA C++.
//
// Replaces horovod_tpu/ops/pallas_kernels.py::_int8_matmul_kernel (through
// int8_matmul_pallas), the Pallas TPU kernel behind
// ops/quantization.int8_weight_matmul on the int8 serving path
// (ServePool(weight_dtype="int8")). It computes the same function:
//
//   out[m, n] = cast_to_x_dtype(scale[n] * sum_k x[m, k] * q[k, n])
//
// with x in bf16 or fp32, q int8 with one fp32 scale per output column, fp32
// sums, the scale applied once in the epilogue and one rounding to x's
// dtype; with a bias (x's dtype) the rounded value is added in fp32 and
// rounded again, which is bit for bit the separate `+ bias` of torch.
// No dequantized copy of the weight exists in device memory.
//
// Exactness. |q| <= 127 is exact in bf16, so the bf16 kernel converts each
// int8 weight tile to bf16 in shared memory and multiplies on the tensor
// cores in bf16 with fp32 accumulators chained across k: every product is
// exact and every sum an fp32 sum, as in the TPU kernel, which casts its
// weight tile to x's dtype and accumulates in fp32. The conversion is a
// byte permute into the mantissa of 2^23 (after flipping the sign bit, so
// the byte reads as q + 128), one fp32 subtraction of 2^23 + 128, and a
// permute of the two high halves into a bf16 pair: exact, with no
// int-to-float instruction. fp32 x takes a plain tiled FMA kernel (fp32
// products and sums, no TF32).
//
// The bf16 kernel. Persistent: one block an SM walks work items, an item
// being a 128 x 128 output tile over one range of K (row tiles grouped in
// eights, so the blocks working at one time share x row strips and weight
// column strips in L2). A block is three roles over a ring of kStages
// shared-memory stages, each stage one 64-deep k slice:
//
//   producer           one thread of its warpgroup issues the TMA loads of
//                      the x tile ([128 rows x 64 k] bf16, 128B swizzle) and
//                      the weight tile ([128 n x 64 k] int8, as stored);
//                      completion on full[s]
//   converter group    turns each landed int8 tile into a bf16 [128 n x 64 k]
//                      tile in the 128B-swizzled K-major layout wgmma's B
//                      descriptor reads, fences the generic stores into the
//                      async proxy and arrives on conv[s]; it runs ahead of
//                      the products by as many stages as the ring holds
//   2 consumer groups  each owns 64 rows of the tile and issues four
//                      wgmma.mma_async m64n128k16 a stage (A = its x rows, B
//                      = the converted tile, both from shared memory, fp32
//                      accumulators chained across k), releasing the
//                      previous stage (empty[s], one arrival a warp) once
//                      the products reading it are done
//
// setmaxnreg hands the producer's and the converter's registers to the
// consumers. The weight's bytes cross device memory once a tile and are
// converted once a block a stage; a consumer group whose 64 rows all lie
// past M issues no products. TMA's zero fill pads ragged M, N and K (int8
// and bf16 zero are exact zeros). x is read in place through its strides
// as a 4-D map over (K, 1, rows_inner, rows_outer), so a [B, S, K]
// activation, a column slice of a wider one or a batch-transposed view
// needs no copy. A consumer loads its columns' scales and bias values as
// its item starts; the epilogue applies them and stages the tile through
// 128B-swizzled shared memory for a TMA store where N is a multiple of 8;
// otherwise it stores from registers.
//
// Why this split (timed on an H100): done by the consumers one stage ahead
// of their products, the conversion's latency and proxy fence held the
// products back; a converter group of its own hides them behind the ring
// (a second one gained nothing). Reading the weight as wgmma's register A
// operand, converted in registers (no bf16 tile, no fence), was no faster
// at M = 8192 and slower at M = 8.
//
// Small M. With fewer tiles than two rounds of the card, the wrapper splits
// the contraction; each split writes its fp32 partial sums (unscaled) to a
// workspace, and a second kernel adds the splits in a fixed order, then
// applies the scale, the rounding, the bias and the second rounding:
// deterministic, no atomics.
//
// What bounds it on an H100 SXM (data-sheet peaks at its 700 W power limit:
// 989 TFLOP/s dense bf16, 3.35 TB/s of HBM3). A GPT-2-small serving batch
// (M = 8 x 1024 rows) runs 48 products of 1.39 TFLOP in all: 1.41 ms of bf16
// tensor-core time against 0.75 ms to move their 2.5 GB, so operations bound
// it. At decode-sized M (8 rows) the same 48 products move 85 MB of int8
// weights, 0.025 ms, and the weight bytes bound it; each launch then costs
// more than its bytes.
//
// What the design leaves on the table (builds with a part taken out): the
// conversion, its arithmetic and the proxy fence after every converted
// stage, costs about a quarter of the kernel's time at M = 8192 in every
// form tried (by the consumers, by one or two converter groups, in
// registers, with shifts and masks or int-to-float conversions in place of
// the byte permutes); the epilogue, which both consumer groups run at once
// while the tensor cores wait, about a sixth; and 128 x 128 tiles (a wider
// tile or a cluster multicast would halve the x tile's L2 traffic).

#include <string.h>

#include "sm90_common.cuh"

namespace {

constexpr int kBM = 128;  // output rows a tile (two 64-row consumer groups)
constexpr int kBN = 128;  // output columns a tile
constexpr int kBK = 64;   // contraction depth a stage: one 128-byte bf16 row
constexpr int kStages = 4;
constexpr int kConsumers = 2;               // warpgroups 0 and 1
constexpr int kConverter = kConsumers;      // warpgroup 2
constexpr int kProducer = kConverter + 1;   // warpgroup 3: one thread works
constexpr int kThreads = (kProducer + 1) * 128;
// Registers a thread of each role gets (setmaxnreg): the consumers hold
// 64 accumulators, the converter a few 16-byte chunks, the producer next
// to nothing. setmaxnreg only moves the block's launch allocation between
// its warps (a multiple of 8 a thread, at most 65,536 in all), so the
// roles' sum must fit in it, or an increase waits forever.
constexpr int kRegsLaunch = 65536 / kThreads / 8 * 8;
constexpr int kRegsConsumer = 200;
constexpr int kRegsConverter = 80;
constexpr int kRegsProducer = 24;
static_assert(128 * (kConsumers * kRegsConsumer + kRegsConverter +
                     kRegsProducer) <= kRegsLaunch * kThreads, "registers");
constexpr int kGroupM = 8;  // row tiles a raster group
constexpr int kXBytes = kBM * kBK * 2;  // a bf16 x tile
constexpr int kWBytes = kBN * kBK;      // an int8 weight tile
constexpr int kBBytes = kBN * kBK * 2;  // the converted bf16 weight tile
constexpr int kOutBytes = 64 * kBN * 2;  // a consumer's bf16 staging tile
constexpr int kSmemBytes = kStages * (kXBytes + kBBytes + kWBytes) +
                           kConsumers * kOutBytes + 3 * kStages * 8 + 1024;
static_assert(kBK * 2 == kRowBytes, "a stage is one swizzle row deep");

// fp32 FMA kernel: 64x64 outputs a block, 4x4 a thread, 16-deep k tiles.
constexpr int kFM = 64;
constexpr int kFN = 64;
constexpr int kFK = 16;
constexpr int kFThreads = 256;

struct Params {
  const float* scales;
  const __nv_bfloat16* bias;  // or null
  __nv_bfloat16* out;         // [M, N]; unused when splits > 1
  float* ws;                  // [splits, M, ldws] fp32 partial sums
  long long ldws;
  int m, n, k;
  int inner;  // rows a row-dim slice: row r = (r / inner, r % inner)
  int tiles_inner, tiles_m, tiles_n;
  int splits, k_tiles, k_tiles_per_split;
  int tma_store;  // the output's rows are 16-byte aligned
};

// One output tile of one contraction split: work item w of
// tiles_m * tiles_n * splits, the split slowest; inside a split, groups of
// kGroupM row tiles, the row tile fastest inside a group.
struct Work {
  int ob, s0, n0, z, kt0, nk;
};

__device__ __forceinline__ Work work_of(const Params& p, int w) {
  Work t;
  const int per = p.tiles_m * p.tiles_n;
  t.z = w / per;
  int r = w - t.z * per;
  const int group = kGroupM * p.tiles_n;
  const int g = r / group;
  r -= g * group;
  const int rows = min(kGroupM, p.tiles_m - g * kGroupM);
  const int tm = g * kGroupM + r % rows;
  t.n0 = (r / rows) * kBN;
  t.ob = tm / p.tiles_inner;
  t.s0 = (tm - t.ob * p.tiles_inner) * kBM;
  t.kt0 = t.z * p.k_tiles_per_split;
  t.nk = min(p.k_tiles, t.kt0 + p.k_tiles_per_split) - t.kt0;
  return t;
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// One box of the output from shared memory; rows and columns past the
// tensor's edge are not written.
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(src)),
         "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(wg + 1) : "memory");
}

// Four int8 (one word, the lowest k in the low byte) -> two bf16 pairs,
// exactly: u = q + 128 in the low mantissa byte of 2^23, minus 2^23 + 128.
__device__ __forceinline__ void i8x4_to_bf16x4(uint32_t w, uint32_t& lo,
                                               uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650)) - 8388736.f;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7651)) - 8388736.f;
  const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7652)) - 8388736.f;
  const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7653)) - 8388736.f;
  // The values are exact in bf16: the low halves are zero.
  lo = __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
  hi = __byte_perm(__float_as_uint(f2), __float_as_uint(f3), 0x7632);
}

// One stage's int8 weight tile into its bf16 tile, by the converter group
// (converter thread ct takes chunks ct, ct + 128, ...): 16-byte
// chunk c (row c / 4, k 16 (c % 4)..+15) becomes units 2 (c % 4)
// and + 1 of bf16 row c / 4, each unit at u ^ (row % 8) (the 128B swizzle).
// Every chunk is loaded before the first store: a store may alias a later
// load, which would otherwise serialise the chunks.
__device__ __forceinline__ void convert_tile(const uint8_t* src, uint8_t* dst,
                                             int ct) {
  constexpr int kChunks = kWBytes / 16 / 128;
  uint4 raw[kChunks];
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    raw[i] = *reinterpret_cast<const uint4*>(
        src + (ct + 128 * i) * 16);
  }
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const int c = ct + 128 * i;
    const int r = c >> 2, j = c & 3;
    uint4 a, b;
    i8x4_to_bf16x4(raw[i].x, a.x, a.y);
    i8x4_to_bf16x4(raw[i].y, a.z, a.w);
    i8x4_to_bf16x4(raw[i].z, b.x, b.y);
    i8x4_to_bf16x4(raw[i].w, b.z, b.w);
    uint8_t* row = dst + r * kRowBytes;
    *reinterpret_cast<uint4*>(row + (((2 * j) ^ (r & 7)) << 4)) = a;
    *reinterpret_cast<uint4*>(row + (((2 * j + 1) ^ (r & 7)) << 4)) = b;
  }
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// scale, round to bf16, and with a bias add it in fp32 and round again.
__device__ __forceinline__ __nv_bfloat16 finish(float acc, float scale,
                                                float bias, bool has_bias) {
  const float v = round_bf16(__fmul_rn(acc, scale));
  return __float2bfloat16_rn(has_bias ? __fadd_rn(v, bias) : v);
}

// The scales and bias values of a consumer thread's 32 accumulator
// columns, 8 (i / 2) + 2 (lane % 4) + i % 2 of the tile (zero past N),
// loaded when its item starts so that they have arrived by its epilogue.
struct Cols {
  float scale[32];
  float bias[32];
};

__device__ __forceinline__ void load_cols(const Params& p, int n0, int q,
                                          Cols& c) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int col = n0 + 8 * (i / 2) + 2 * q + i % 2;
    const bool in = col < p.n;
    c.scale[i] = in ? __ldg(p.scales + col) : 0.f;
    c.bias[i] = in && p.bias ? __bfloat162float(p.bias[col]) : 0.f;
  }
}

// finish() on a consumer group's accumulators in place (each then holds a
// bf16 value exactly). Accumulator i of a thread is row 16 warp + lane / 4
// (+ 8 for odd i / 2) of the group's 64, column 8 (i / 4) + 2 (lane % 4)
// + i % 2 of the tile.
__device__ __forceinline__ void finish_acc(const Params& p, const Cols& c,
                                           float (&acc)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int col = (i / 4) * 2 + i % 2;
    acc[i] = round_bf16(__fmul_rn(acc[i], c.scale[col]));
    if (p.bias) acc[i] = round_bf16(__fadd_rn(acc[i], c.bias[col]));
  }
}

// Stores one consumer group's accumulators from registers: a split's fp32
// partial sums, or the finished outputs (finish_acc) in bf16.
__device__ __forceinline__ void store_registers(const Params& p, const Work& t,
                                                const float (&acc)[64],
                                                int wg, int tw) {
  const int lane = tw & 31, q = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int s = t.s0 + wg * 64 + (tw / 32) * 16 + lane / 4 + 8 * h;
    if (s >= p.inner) continue;
    const long long row = static_cast<long long>(t.ob) * p.inner + s;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = t.n0 + 8 * j + 2 * q;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (col + e >= p.n) continue;
        const float v = acc[4 * j + 2 * h + e];
        if (p.splits > 1) {
          p.ws[(static_cast<long long>(t.z) * p.m + row) * p.ldws + col + e] = v;
        } else {
          p.out[row * p.n + col + e] = __float2bfloat16_rn(v);
        }
      }
    }
  }
}

__device__ __forceinline__ void advance(int& s, uint32_t& phase) {
  if (++s == kStages) {
    s = 0;
    phase ^= 1;
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    int8_matmul_kernel(const Params p, const __grid_constant__ CUtensorMap map_x,
                       const __grid_constant__ CUtensorMap map_w,
                       const __grid_constant__ CUtensorMap map_out) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint8_t* x_tiles = smem;
  uint8_t* b_tiles = x_tiles + kStages * kXBytes;
  uint8_t* w_tiles = b_tiles + kStages * kBBytes;
  uint8_t* outs = w_tiles + kStages * kWBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(outs + kConsumers * kOutBytes);
  uint64_t* conv = full + kStages;
  uint64_t* empty = conv + kStages;

  const int wg = threadIdx.x / 128;
  const int tw = threadIdx.x % 128;
  const int lane = threadIdx.x & 31;
  const int work = p.tiles_m * p.tiles_n * p.splits;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      bar_init(&full[s], 1);
      bar_init(&conv[s], 4);  // one arrival a converter warp
      bar_init(&empty[s], kConsumers * 4);  // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  int s = 0;
  uint32_t phase = 0;
  if (wg == kProducer) {
    // One thread keeps the ring full; the group hands its registers to
    // the consumers.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegsProducer));
    if (tw == 0) {
      for (int w = blockIdx.x; w < work; w += gridDim.x) {
        const Work t = work_of(p, w);
        for (int i = 0; i < t.nk; ++i) {
          bar_wait(&empty[s], phase ^ 1);
          bar_expect_tx(&full[s], kXBytes + kWBytes);
          const int k0 = (t.kt0 + i) * kBK;
          tma_load(x_tiles + s * kXBytes, &map_x, &full[s], k0, 0, t.s0, t.ob);
          tma_load_2d(w_tiles + s * kWBytes, &map_w, &full[s], k0, t.n0);
          advance(s, phase);
        }
      }
    }
    return;
  }
  if (wg == kConverter) {
    // Each stage's int8 tile into its bf16 tile as soon as it lands,
    // running ahead of the products by as many stages as the ring holds.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegsConverter));
    const int ct = tw;
    for (int w = blockIdx.x; w < work; w += gridDim.x) {
      const Work t = work_of(p, w);
      for (int i = 0; i < t.nk; ++i) {
        bar_wait(&full[s], phase);
        convert_tile(w_tiles + s * kWBytes, b_tiles + s * kBBytes, ct);
        // The generic stores must reach the async proxy wgmma reads from.
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        __syncwarp();
        if (lane == 0) bar_arrive(&conv[s]);
        advance(s, phase);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegsConsumer));
  float acc[64];
  for (int w = blockIdx.x; w < work; w += gridDim.x) {
    const Work t = work_of(p, w);
    if (t.s0 + wg * 64 >= p.inner) {
      // Every row of this group lies past the edge: no products, each
      // stage released once the converter is done with it.
      for (int i = 0; i < t.nk; ++i) {
        bar_wait(&conv[s], phase);
        if (lane == 0) bar_arrive(&empty[s]);
        advance(s, phase);
      }
      continue;
    }
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    Cols c;
    load_cols(p, t.n0, lane & 3, c);
    int prev = -1;
    for (int i = 0; i < t.nk; ++i) {
      bar_wait(&full[s], phase);  // the x tile
      bar_wait(&conv[s], phase);  // the converted weight tile
      const uint64_t da = desc_k(x_tiles + s * kXBytes + wg * 64 * kRowBytes);
      const uint64_t db = desc_k(b_tiles + s * kBBytes);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        wgmma_ss(acc, da + 2 * kk, db + 2 * kk, 1);
      }
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's products are done
      fence_regs(acc);
      if (prev >= 0 && lane == 0) bar_arrive(&empty[prev]);
      prev = s;
      advance(s, phase);
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if (lane == 0) bar_arrive(&empty[prev]);

    if (p.splits == 1) finish_acc(p, c, acc);
    if (!p.tma_store || p.splits > 1) {
      store_registers(p, t, acc, wg, tw);
      continue;
    }
    // Staged into two 128B-swizzled boxes of 64 columns (16-byte unit u
    // of row r at u ^ (r % 8): the eight rows a store instruction touches
    // fall in eight bank groups), then one thread stores them with TMA
    // while the group goes on to its next item.
    uint8_t* out = outs + wg * kOutBytes;
    const int q = lane & 3;
    if (tw == 0) {  // the last item's stores have read the staging tile
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    }
    wg_sync(wg);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = (tw / 32) * 16 + lane / 4 + 8 * h;
        const __nv_bfloat162 v =
            __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        uint8_t* box = out + (j / 8) * 64 * kRowBytes;
        *reinterpret_cast<__nv_bfloat162*>(
            box + r * kRowBytes + (((j % 8) ^ (r % 8)) * 16) + 4 * q) = v;
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    wg_sync(wg);
    if (tw == 0) {
      for (int b = 0; b < 2; ++b) {
        tma_store_3d(&map_out, out + b * 64 * kRowBytes, t.n0 + b * 64,
                     t.s0 + wg * 64, t.ob);
      }
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    }
  }
  if (tw == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// out = finish(sum over the splits, in split order); ws is [splits, M, ldws].
__global__ void int8_matmul_reduce_kernel(const Params p) {
  const long long total = static_cast<long long>(p.m) * p.n;
  const long long plane = static_cast<long long>(p.m) * p.ldws;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long row = i / p.n;
    const int col = static_cast<int>(i - row * p.n);
    const float* src = p.ws + row * p.ldws + col;
    float acc = src[0];
    for (int z = 1; z < p.splits; ++z) acc += src[z * plane];
    p.out[i] = finish(acc, p.scales[col],
                      p.bias ? __bfloat162float(p.bias[col]) : 0.f, p.bias);
  }
}

struct ParamsF32 {
  const float* x;
  const int8_t* w;
  const float* scales;
  const float* bias;  // or null
  float* out;
  long long x_so, x_si;  // x row strides (elements): see hvt_int8_matmul
  long long ldw;         // elements between weight rows
  int m, n, k;
  int rows_inner;
};

__device__ __forceinline__ long long x_row(const ParamsF32& p, int row) {
  return static_cast<long long>(row / p.rows_inner) * p.x_so +
         static_cast<long long>(row % p.rows_inner) * p.x_si;
}

// fp32 x: each thread accumulates a 4x4 block of outputs with fmaf over
// 16-deep tiles of x and of the weight converted to fp32 in shared memory.
__global__ void __launch_bounds__(kFThreads)
    int8_matmul_kernel_f32(const ParamsF32 p) {
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
  const float* xr[4];
  const int8_t* wr[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int lr = (tid >> 4) + 16 * i;
    xr[i] = m0 + lr < p.m ? p.x + x_row(p, m0 + lr) : nullptr;
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

#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = n0 + tn + j;
    if (col >= p.n) continue;
    const float s = p.scales[col];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = m0 + tm + i;
      if (row >= p.m) continue;
      float v = __fmul_rn(acc[i][j], s);
      if (p.bias) v = __fadd_rn(v, p.bias[col]);
      p.out[static_cast<long long>(row) * p.n + col] = v;
    }
  }
}

// The int8 weight [N rows, K] with row stride ldw bytes, in boxes of 64 k x
// 128 rows, unswizzled; out-of-bounds boxes read zeros.
bool make_weight_map(CUtensorMap* map, const void* w, int n, int k,
                     long long ldw) {
  const PFN_cuTensorMapEncodeTiled_v12000 encode = encode_fn();
  if (!encode) return false;
  cuuint64_t dims[2] = {static_cast<cuuint64_t>(k),
                        static_cast<cuuint64_t>(n)};
  cuuint64_t strides[1] = {static_cast<cuuint64_t>(ldw)};
  cuuint32_t box[2] = {kBK, kBN};
  cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(w),
                dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The bf16 output [outer, inner, N] (contiguous, N a multiple of 8) as a
// 3-D map of boxes of 64 columns x 64 rows under the 128B swizzle.
bool make_out_map(CUtensorMap* map, void* out, int n, int inner, int outer) {
  const PFN_cuTensorMapEncodeTiled_v12000 encode = encode_fn();
  if (!encode) return false;
  cuuint64_t dims[3] = {static_cast<cuuint64_t>(n),
                        static_cast<cuuint64_t>(inner),
                        static_cast<cuuint64_t>(outer)};
  cuuint64_t strides[2] = {static_cast<cuuint64_t>(n) * 2,
                           static_cast<cuuint64_t>(n) * 2 * inner};
  cuuint32_t box[3] = {64, 64, 1};
  cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, out, dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_NONE,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

int launch_bf16(const void* x, const void* w_map, const float* scales,
                const void* bias, void* out, void* ws, int m, int n, int k,
                int rows_inner, long long x_so, long long x_si, int splits,
                int k_tiles_per_split, cudaStream_t stream) {
  const int outer = m / rows_inner;
  // Strides of dimensions of length 1 are never stepped along: 16 bytes.
  const long long st[3] = {outer > 1 ? x_so : 8, rows_inner > 1 ? x_si : 8, 8};
  if (!aligned16(x) || st[0] % 8 || st[1] % 8 || st[0] <= 0 || st[1] <= 0 ||
      !w_map || (splits > 1 && !ws)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap map_x, map_w, map_out = {};
  memcpy(&map_w, w_map, sizeof(map_w));
  if (!make_map(&map_x, x, outer, rows_inner, 1, k, st, kBM)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.scales = scales;
  p.bias = static_cast<const __nv_bfloat16*>(bias);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.ws = static_cast<float*>(ws);
  p.ldws = n + (n & 1);
  p.m = m;
  p.n = n;
  p.k = k;
  p.inner = rows_inner;
  p.tiles_inner = (rows_inner + kBM - 1) / kBM;
  p.tiles_m = p.tiles_inner * outer;
  p.tiles_n = (n + kBN - 1) / kBN;
  p.splits = splits;
  p.k_tiles = (k + kBK - 1) / kBK;
  p.k_tiles_per_split = k_tiles_per_split;
  p.tma_store = splits == 1 && n % 8 == 0 && aligned16(out) &&
                make_out_map(&map_out, out, n, rows_inner, outer);
  const long long work =
      static_cast<long long>(p.tiles_m) * p.tiles_n * splits;
  // Every split holds at least one k tile, and the splits cover K.
  if (work > 0x7fffffffLL || k_tiles_per_split < 1 ||
      (splits - 1) * k_tiles_per_split >= p.k_tiles ||
      splits * k_tiles_per_split < p.k_tiles) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static std::atomic<uint64_t> done{0};
  cudaError_t err = opt_in(int8_matmul_kernel, kSmemBytes, done);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int sms = sm_count();
  if (sms <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  const unsigned blocks = static_cast<unsigned>(work < sms ? work : sms);
  int8_matmul_kernel<<<blocks, kThreads, kSmemBytes, stream>>>(p, map_x, map_w,
                                                               map_out);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const long long want = (static_cast<long long>(m) * n + 255) / 256;
  int8_matmul_reduce_kernel<<<static_cast<unsigned>(want < 4096 ? want : 4096),
                              256, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point for ctypes: encodes the tensor map of an int8 weight
// [N rows, K] on `device` with row stride ldw bytes (both 16-byte aligned)
// into the 128 bytes at `map`, which hvt_int8_matmul takes as `w_map` (the
// calling thread's current device is restored). A map holds the address,
// shape and strides and nothing else, so the caller may keep it for as
// long as those stay the same. Returns a cudaError_t.
extern "C" int hvt_int8_weight_map(void* map, const void* w, int n, int k,
                                   long long ldw, int device) {
  if (!map || n <= 0 || k <= 0 || !aligned16(w) || ldw % 16 || ldw < k) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int current = 0;
  const cudaError_t err = bind_device(device, &current);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap m;
  const bool made = make_weight_map(&m, w, n, k, ldw);
  if (current != device) cudaSetDevice(current);
  if (!made) return static_cast<int>(cudaErrorInvalidValue);
  memcpy(map, &m, sizeof(m));
  return 0;
}

// Plain C entry point for ctypes: launches on `stream` of `device` (the
// calling thread's current device is restored) and returns a cudaError_t
// (0 when every launch was accepted; cudaErrorInvalidValue when the
// arguments or a tensor map are refused).
//
// x: bf16 (x_bf16 = 1) or fp32 rows of K values, k contiguous, row r at
// (r / rows_inner) * x_so + (r % rows_inner) * x_si elements (M a multiple
// of rows_inner); w: [N][ldw] int8, k contiguous; scales: [N] fp32; bias:
// [N] in x's dtype, or null; out: [M][N] in x's dtype, contiguous.
// bf16 takes the TMA kernel: x's base and row strides 16-byte aligned,
// w_map from hvt_int8_weight_map, and with splits > 1 a workspace ws of
// splits * M * (N + N % 2) fp32 (each split k_tiles_per_split 64-deep k
// tiles, none empty). fp32 takes the FMA kernel, any alignment; w_map, ws
// and the split arguments are ignored.
extern "C" int hvt_int8_matmul(const void* x, const void* w, const void* w_map,
                               const void* scales, const void* bias, void* out,
                               void* ws, int m, int n, int k, int rows_inner,
                               long long x_so, long long x_si, long long ldw,
                               int x_bf16, int splits, int k_tiles_per_split,
                               int device, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || rows_inner <= 0 || m % rows_inner ||
      splits < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int current = 0;
  const cudaError_t err = bind_device(device, &current);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  if (x_bf16) {
    rc = launch_bf16(x, w_map, static_cast<const float*>(scales), bias, out,
                     ws, m, n, k, rows_inner, x_so, x_si, splits,
                     k_tiles_per_split, s);
  } else {
    ParamsF32 p;
    p.x = static_cast<const float*>(x);
    p.w = static_cast<const int8_t*>(w);
    p.scales = static_cast<const float*>(scales);
    p.bias = static_cast<const float*>(bias);
    p.out = static_cast<float*>(out);
    p.x_so = x_so;
    p.x_si = x_si;
    p.ldw = ldw;
    p.m = m;
    p.n = n;
    p.k = k;
    p.rows_inner = rows_inner;
    const dim3 grid((n + kFN - 1) / kFN, (m + kFM - 1) / kFM);
    int8_matmul_kernel_f32<<<grid, kFThreads, 0, s>>>(p);
    rc = static_cast<int>(cudaGetLastError());
  }
  if (current != device) cudaSetDevice(current);
  return rc;
}
