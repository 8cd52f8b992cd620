// W8A8 int8 GEMM with a fused f32 epilogue for Hopper (sm_90a): wgmma s8 on
// TMA-fed tiles in a persistent, warp-specialised kernel, and a row
// quantize pass that feeds it.
//
// Replaces aladin_tpu/ops/pallas/quant_matmul.py::_kernel (reached through
// w8a8_matmul) and ::_kernel_dynx (through w8a8_matmul_dynx, wrapped by
// w8a8_dense_apply). Both compute
//
//     y[m, n] = act(acc[m, n] * xscale[m] * wscale[n] + bias[n]),
//     acc[m, n] = sum_k xq[m, k] * wq[n, k]      (exact, int32, whole K)
//
// with the epilogue in f32 in _epilogue's order, each product and the add
// rounded on their own (no FMA contraction), act = none, exact-erf gelu
// (erff) or the tanh form, and y stored as bf16 or f32. The dynx variant
// takes bf16 or f32 x and quantizes each row over its full K, exactly as
// _kernel_dynx does:
//
//     scale = max(absmax, 1e-8) * (1/127)          (a reciprocal multiply)
//     q     = clip(rint(x / scale), -127, 127)     (IEEE divide, half to even)
//
// The TPU kernels hold a whole-N weight tile in VMEM and stream activation
// rows past it, one grid step after another on one core. Here 132 SMs with
// 227 KB of shared memory each run at once, so the work is cut into output
// tiles and the quantize is a pass of its own.
//
// Bound on an H100 SXM: at the encoder's shapes (M 1600-2688, K 768,
// N 2304-3072) the bytes (x read once, wq read once, y written once over
// 3.35 TB/s) and the 2*M*K*N int8 operations (over 1979 TOP/s) are about
// even, 3-7 us a call. The design:
//   * dynx: quantize_rows quantizes every row once (one warp a row, the row
//     read once into registers, the absmax by warp shuffle) into an int8
//     scratch xq (M, K) and its f32 scales, which the GEMM then reads like
//     K4's own xq: two launches on one stream, no sync, the GEMM launched
//     as a programmatic dependent so its prologue overlaps the quantize's
//     tail. Before, each column block quantized its 128 rows again (N / 128
//     times a row);
//   * the GEMM is persistent: one CTA an SM walks the 128 x kTileN output
//     tiles, row tiles fastest, so the CTAs resident together share their
//     weight columns (and all of x, 2 MB at M 2688) in L2;
//   * one producer thread issues TMA loads (128-byte swizzle, maps from
//     cuTensorMapEncodeTiled fetched with dlsym, so no -lcuda) of the
//     128-row x tile and the kTileN-row weight tile, 128 bytes of K a
//     stage, into a 4-stage mbarrier ring; it runs ahead into the next
//     tile, so a tile's epilogue overlaps the next one's loads. Both
//     operands are K-major, the only layout wgmma takes for 8-bit types: xq
//     (M, K) and wq (N, K) already are. Rows past M or N and bytes past K
//     arrive as TMA's zeros, so K need only be a multiple of 16 (the TMA
//     stride);
//   * two consumer warpgroups each run wgmma m64n128k32 s8 -> s32 over
//     their 64 rows of the tile (the producer warpgroup gives its registers
//     to them with setmaxnreg);
//   * the epilogue runs on the accumulator registers: the tile's row and
//     column scales and bias, loaded during the mainloop, are staged in
//     shared memory; each warp writes 64 columns of its 16 rows at a time
//     as bf16 / f32 into a padded staging strip, then stores the strip in
//     16-byte pieces, full rows at a time, masked at the M and N edges
//     (element by element where a row of y is not 16-byte aligned). The
//     activation is a template argument, so each instantiation's unrolled
//     epilogue holds the code of one activation only.
// The constants were chosen on an H100 with tools/k4_variants.py, which
// times the source with one of them changed (PERF.md):
//   * kTileN 128: of 128, 192 and 256 it gives the least time summed over
//     the encoder's four shapes (QKV and FFN-up at M 2688 and 1600). A
//     wider tile wins only where it saves a wave (192 at QKV M 2688, 256
//     at QKV M 1600) and loses where each warp's longer epilogue (gelu's
//     erff) dominates;
//   * a ring of 4 stages ran a few percent faster than the 6 that fit;
//   * what is left above the bound is mostly the epilogue (erff, ~27
//     instructions an output, at FFN-up), which does not overlap the
//     tile's own mainloop. Giving each warpgroup whole tiles of its own
//     (pingpong, the mainloops ordered by a named barrier) so that one's
//     epilogue overlaps the other's mainloop ran slower on an H100: each
//     tile's epilogue then has half the warps, and it is bound by each
//     warp's latency rather than by the SM's issue rate.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <limits.h>
#include <stdint.h>

#include "rowquant.cuh"

namespace {

constexpr int kConsumers = 2;                     // consumer warpgroups, 64 rows each
constexpr int kThreads = 128 * (kConsumers + 1);  // + the producer warpgroup
constexpr int kTileM = 64 * kConsumers;
constexpr int kTileN = 128;                       // the output tile width (note above)
constexpr int kChunk = 128;                       // bytes of K a stage (the swizzle width)
constexpr int kSlabCols = 64;                     // epilogue columns staged at a time
constexpr int kMaxStages = 4;                     // ring stages (note above)
constexpr bool kChainDynx = true;  // dynx's GEMM launches while the quantize drains (PDL)
constexpr int kAlign = 1024;                      // 128-byte swizzle atoms are 1024-byte aligned
constexpr int kSmemLimit = 232448;                // dynamic shared memory a block may use
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kMaxK = 1536;                       // quantize_rows holds a row in registers
constexpr int kQuantWarps = 8;                    // rows a quantize block
constexpr float kScaleFloor = static_cast<float>(1e-8);
constexpr float kInv127 = static_cast<float>(1.0 / 127.0);
constexpr float kSqrtHalf = 0.7071067811865476f;
constexpr float kGeluTanhC = 0.7978845608028654f;  // sqrt(2 / pi)

enum Activation { kNone = 0, kGelu = 1, kGeluTanh = 2 };

// Shared memory of one GEMM instantiation: the ring, the staging strips,
// the consumers' scales and the ring's barriers; kMaxStages stages, or as
// many as fit.
template <int BN, typename TO>
struct Cfg {
  static constexpr int kStageBytes = (kTileM + BN) * kChunk;
  static constexpr int kPitch = kSlabCols * sizeof(TO) + (sizeof(TO) == 2 ? 16 : 32);
  static constexpr int kStagingBytes = kConsumers * 4 * 16 * kPitch;
  static constexpr int kScaleFloats = 64 + 2 * BN;  // a consumer's row scales, col scales, bias
  static constexpr int kFixed =
      kAlign + kStagingBytes + kConsumers * kScaleFloats * 4 + 2 * kMaxStages * 8;
  static constexpr int kFit = (kSmemLimit - kFixed) / kStageBytes;
  static constexpr int kStages = kFit < kMaxStages ? kFit : kMaxStages;
  static constexpr int kSmemBytes = kFixed + kStages * kStageBytes;
  static_assert(kStages >= 2, "the ring needs two stages");
  static_assert(BN % kSlabCols == 0, "the epilogue stages whole 64-column slabs");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers and TMA -----------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_bytes(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// a (box rows x 128 bytes) tile at (byte x, row y) of a 2-D map; rows and
// bytes past the tensor arrive as zeros and still count their bytes
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int x, int y,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(smem_addr(bar))
      : "memory");
}

// ---- wgmma -----------------------------------------------------------------

// K-major operand of 128-byte rows written by TMA with the 128-byte
// swizzle: 8-row atoms of 1024 bytes (SBO); LBO is unused for this layout
__device__ __forceinline__ uint64_t smem_desc(const void* tile) {
  return (static_cast<uint64_t>((smem_addr(tile) & 0x3FFFF) >> 4)) |
         (static_cast<uint64_t>(1) << 16) | (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

#define Q8_D64                                                                  \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, " \
  "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, " \
  "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
#define Q8_D96                                                                  \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, " \
  "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, " \
  "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, " \
  "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, " \
  "%87, %88, %89, %90, %91, %92, %93, %94, %95}"
#define Q8_D128                                                                 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, " \
  "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, " \
  "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, " \
  "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, " \
  "%87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, " \
  "%103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, " \
  "%117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}"
#define Q8_OPS8(b) \
  "+r"(d[b]), "+r"(d[b + 1]), "+r"(d[b + 2]), "+r"(d[b + 3]), "+r"(d[b + 4]), "+r"(d[b + 5]), \
      "+r"(d[b + 6]), "+r"(d[b + 7])
#define Q8_OPS32(b) Q8_OPS8(b), Q8_OPS8(b + 8), Q8_OPS8(b + 16), Q8_OPS8(b + 24)

// d (+)= A(64 x 32) . B(N x 32)^T, s8 in, s32 accumulate, N = 128 / 192 / 256
__device__ __forceinline__ void wgmma(int (&d)[64], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " Q8_D64 ", %64, %65, p;\n}\n"
      : Q8_OPS32(0), Q8_OPS32(32)
      : "l"(a), "l"(b), "r"(accumulate));
}
__device__ __forceinline__ void wgmma(int (&d)[96], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k32.s32.s8.s8 " Q8_D96 ", %96, %97, p;\n}\n"
      : Q8_OPS32(0), Q8_OPS32(32), Q8_OPS32(64)
      : "l"(a), "l"(b), "r"(accumulate));
}
__device__ __forceinline__ void wgmma(int (&d)[128], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 " Q8_D128 ", %128, %129, p;\n}\n"
      : Q8_OPS32(0), Q8_OPS32(32), Q8_OPS32(64), Q8_OPS32(96)
      : "l"(a), "l"(b), "r"(accumulate));
}

// keeps the compiler from moving accumulator reads across wgmma.wait_group
template <int N>
__device__ __forceinline__ void fence_acc(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void consumer_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// ---- the epilogue ----------------------------------------------------------

template <int ACT>
__device__ __forceinline__ float epilogue(int acc, float xs, float ws, float b, bool has_bias) {
  float y = __fmul_rn(__fmul_rn(__int2float_rn(acc), xs), ws);
  if (has_bias) y = __fadd_rn(y, b);
  if (ACT == kGelu) {
    y = __fmul_rn(__fmul_rn(0.5f, y), __fadd_rn(1.0f, erff(__fmul_rn(y, kSqrtHalf))));
  } else if (ACT == kGeluTanh) {
    const float cube = __fmul_rn(__fmul_rn(__fmul_rn(0.044715f, y), y), y);
    y = __fmul_rn(__fmul_rn(0.5f, y),
                  __fadd_rn(1.0f, tanhf(__fmul_rn(kGeluTanhC, __fadd_rn(y, cube)))));
  }
  return y;
}

__device__ __forceinline__ void stage_pair(char* p, float y0, float y1, float*) {
  *reinterpret_cast<float2*>(p) = make_float2(y0, y1);
}
__device__ __forceinline__ void stage_pair(char* p, float y0, float y1, __nv_bfloat16*) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(y0, y1);
}

// ---- the GEMM ----------------------------------------------------------------

// (first row, first column) of output tile t, row tiles fastest
template <int BN>
__device__ __forceinline__ int2 tile_origin(int t, int row_tiles) {
  return make_int2((t % row_tiles) * kTileM, (t / row_tiles) * BN);
}

// Output tiles are 128 x BN, row tiles fastest. x: map of xq (M, K) int8,
// boxes of 128 rows; w: map of wq (N, K) int8, boxes of BN rows. chunks =
// ceil(K / 128). vec_store: rows of y are 16-byte aligned. ACT: the
// activation, a template argument so each instantiation holds only its own
// epilogue code (one copy a value of the unrolled epilogue).
template <int BN, typename TO, int ACT>
__global__ void __launch_bounds__(kThreads, 1)
w8a8_gemm(const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_w,
          const float* __restrict__ xscale, const float* __restrict__ wscale,
          const float* __restrict__ bias, TO* __restrict__ out, int m, int n, int chunks,
          int vec_store) {
  using C = Cfg<BN, TO>;
  constexpr int kStages = C::kStages;
  extern __shared__ char smem_raw[];
  char* ring = smem_raw + ((kAlign - (smem_addr(smem_raw) & (kAlign - 1))) & (kAlign - 1));
  char* staging = ring + kStages * C::kStageBytes;
  float* scales = reinterpret_cast<float*>(staging + C::kStagingBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(scales + kConsumers * C::kScaleFloats);
  uint64_t* empty = full + kStages;

  const int row_tiles = (m + kTileM - 1) / kTileM;
  const int tiles = row_tiles * ((n + BN - 1) / BN);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers * 4);  // lane 0 of every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // launched chained after the quantize pass: wait until its xq and xscale
  // are written (a no-op otherwise)
  asm volatile("griddepcontrol.wait;\n" ::: "memory");

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // producer: one thread keeps the ring full, running ahead across tiles
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) {
      int stage = 0, phase = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int2 o = tile_origin<BN>(t, row_tiles);
        for (int c = 0; c < chunks; ++c) {
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_expect_bytes(&full[stage], C::kStageBytes);
          char* st = ring + stage * C::kStageBytes;
          tma_load(st, &map_x, c * kChunk, o.x, &full[stage]);
          tma_load(st + kTileM * kChunk, &map_w, c * kChunk, o.y, &full[stage]);
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int q = wg - 1;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  const int r_lo = lane / 4, quad = lane % 4;  // accumulator rows r_lo, r_lo + 8; cols 8i + 2quad
  float* row_s = scales + q * C::kScaleFloats;
  float* col_s = row_s + 64;
  float* col_b = col_s + BN;
  char* strip = staging + (q * 4 + warp) * 16 * C::kPitch;
  const bool has_bias = bias != nullptr;
  constexpr int kColsPerThread = (BN + 127) / 128;
  int acc[BN / 2];
  int stage = 0, phase = 0;

  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int2 o = tile_origin<BN>(t, row_tiles);
    const int m0 = o.x + 64 * q, n0 = o.y;
    // this tile's scales, loaded now, stored to shared memory after the mainloop
    float rs = 0.f, cs[kColsPerThread], cb[kColsPerThread];
    if (tid < 64 && m0 + tid < m) rs = xscale[m0 + tid];
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) {
      const int col = n0 + tid + 128 * j;
      const bool valid = tid + 128 * j < BN && col < n;
      cs[j] = valid ? wscale[col] : 0.f;
      cb[j] = valid && has_bias ? bias[col] : 0.f;
    }

    for (int c = 0; c < chunks; ++c) {
      mbar_wait(&full[stage], phase);
      const char* st = ring + stage * C::kStageBytes;
      const uint64_t da = smem_desc(st + q * 64 * kChunk);
      const uint64_t db = smem_desc(st + kTileM * kChunk);
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < kChunk / 32; ++s)  // +32 bytes = +2 in the address field
        wgmma(acc, da + 2 * s, db + 2 * s, (c > 0 || s > 0) ? 1 : 0);
      wgmma_commit();
      wgmma_wait<0>();
      if (lane == 0) mbar_arrive(&empty[stage]);
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    fence_acc(acc);

    consumer_sync(1 + q);  // every warp is done with the previous tile's scales
    if (tid < 64) row_s[tid] = rs;
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j)
      if (tid + 128 * j < BN) {
        col_s[tid + 128 * j] = cs[j];
        col_b[tid + 128 * j] = cb[j];
      }
    consumer_sync(1 + q);

    const float xs[2] = {row_s[16 * warp + r_lo], row_s[16 * warp + r_lo + 8]};
    const int row0 = m0 + 16 * warp;
    constexpr int kPieceElems = 16 / sizeof(TO);
    constexpr int kPiecesRow = kSlabCols / kPieceElems;
#pragma unroll
    for (int slab = 0; slab < BN / kSlabCols; ++slab) {
#pragma unroll
      for (int j = 0; j < kSlabCols / 8; ++j) {
        const int i = slab * (kSlabCols / 8) + j;
        const int col = 8 * i + 2 * quad;
        const float2 ws = *reinterpret_cast<const float2*>(col_s + col);
        const float2 b = *reinterpret_cast<const float2*>(col_b + col);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float y0 = epilogue<ACT>(acc[4 * i + 2 * h], xs[h], ws.x, b.x, has_bias);
          const float y1 = epilogue<ACT>(acc[4 * i + 2 * h + 1], xs[h], ws.y, b.y, has_bias);
          stage_pair(strip + (r_lo + 8 * h) * C::kPitch + (8 * j + 2 * quad) * sizeof(TO), y0,
                     y1, static_cast<TO*>(nullptr));
        }
      }
      __syncwarp();
      // the strip's 16 rows x 64 columns, 16 bytes a lane, whole rows together
#pragma unroll
      for (int v = 0; v < 16 * kPiecesRow / 32; ++v) {
        const int idx = lane + 32 * v;
        const int r = idx / kPiecesRow, piece = idx % kPiecesRow;
        const int row = row0 + r, col = n0 + slab * kSlabCols + piece * kPieceElems;
        if (row < m && col < n) {
          const char* src = strip + r * C::kPitch + piece * 16;
          TO* dst = out + static_cast<long>(row) * n + col;
          if (vec_store && col + kPieceElems <= n) {
            *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
          } else {
            const TO* s = reinterpret_cast<const TO*>(src);
            for (int e = 0; e < kPieceElems && col + e < n; ++e) dst[e] = s[e];
          }
        }
      }
      __syncwarp();
    }
  }
}

// ---- the dynx quantize -------------------------------------------------------

// One warp a row: the row is read once into registers (K / 256 16-byte
// vectors a lane in bf16, at most 48 values), its absmax reduced by
// shuffle, then quantized with _kernel_dynx's scale and IEEE divide.
template <typename TX>
__global__ void __launch_bounds__(32 * kQuantWarps)
quantize_rows(const TX* __restrict__ x, signed char* __restrict__ xq, float* __restrict__ xscale,
              int m, int k) {
  constexpr int kVec = Vec<TX>::kElems;
  constexpr int kLaneVecs = kMaxK / kVec / 32;
  // the GEMM chained behind this kernel may start its launch now; it
  // reads xq and xscale only after this grid has finished
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int lane = threadIdx.x % 32;
  const long row = static_cast<long>(blockIdx.x) * kQuantWarps + threadIdx.x / 32;
  if (row >= m) return;
  const int vecs = k / kVec;
  const TX* src = x + row * k;
  float f[kLaneVecs][kVec];
  float amax = 0.f;
#pragma unroll
  for (int j = 0; j < kLaneVecs; ++j) {
    if (lane + 32 * j < vecs) {
      Vec<TX>::load(src + (lane + 32 * j) * kVec, f[j]);
#pragma unroll
      for (int i = 0; i < kVec; ++i) amax = fmaxf(amax, fabsf(f[j][i]));
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  const float scale = __fmul_rn(fmaxf(amax, kScaleFloor), kInv127);
  const float inv = __frcp_rn(scale);
  if (lane == 0) xscale[row] = scale;
#pragma unroll
  for (int j = 0; j < kLaneVecs; ++j) {
    const int v = lane + 32 * j;
    if (v >= vecs) continue;
    uint32_t packed[kVec / 4];
#pragma unroll
    for (int w = 0; w < kVec / 4; ++w) {
      uint32_t word = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float qv = fminf(fmaxf(rintf(quotient(f[j][4 * w + i], scale, inv)), -127.f), 127.f);
        word |= static_cast<uint32_t>(static_cast<int>(qv) & 0xff) << (8 * i);
      }
      packed[w] = word;
    }
    signed char* dst = xq + row * k + v * kVec;
    if constexpr (kVec == 8) {
      *reinterpret_cast<uint2*>(dst) = make_uint2(packed[0], packed[1]);
    } else {
      *reinterpret_cast<uint32_t*>(dst) = packed[0];
    }
  }
}

// ---- host side -----------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in libcuda.so.1, which the CUDA runtime
// has already loaded; fetching it here needs no -lcuda
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    if (lib != nullptr) fn = reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

// a row-major int8 (rows, k) map of 128-byte-wide, box_rows-high boxes
bool make_map(CUtensorMap* map, EncodeTiled encode, const void* base, int rows, int k,
              int box_rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(k), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(k)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kChunk), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem_strides[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims, strides,
                box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

bool valid_shape(int m, int n, int k, int activation) {
  return m >= 0 && n >= 1 && k >= 16 && k % 16 == 0 && k <= kMaxK && activation >= kNone &&
         activation <= kGeluTanh;
}

template <typename TO, int ACT>
int launch_gemm(const void* xq, const float* xscale, const void* wq, const float* wscale,
                const float* bias, void* out, int m, int n, int k, bool chained,
                cudaStream_t stream) {
  constexpr int BN = kTileN;
  using C = Cfg<BN, TO>;
  // TMA row coordinates are int32: the last box must start below INT_MAX
  if (static_cast<long>(m) + kTileM > INT_MAX || static_cast<long>(n) + BN > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const long tiles = static_cast<long>((m + kTileM - 1) / kTileM) * ((n + BN - 1) / BN);
  if (tiles > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorSharedObjectSymbolNotFound);
  CUtensorMap map_x, map_w;
  if (!make_map(&map_x, encode, xq, m, k, kTileM) || !make_map(&map_w, encode, wq, n, k, BN))
    return static_cast<int>(cudaErrorInvalidValue);

  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(w8a8_gemm<BN, TO, ACT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(tiles < sms ? tiles : sms));
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = C::kSmemBytes;
  config.stream = stream;
  cudaLaunchAttribute chain[1];
  chain[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  chain[0].val.programmaticStreamSerializationAllowed = 1;
  config.attrs = chain;
  config.numAttrs = chained ? 1 : 0;
  const int vec_store =
      (static_cast<long>(n) * sizeof(TO)) % 16 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  err = cudaLaunchKernelEx(&config, w8a8_gemm<BN, TO, ACT>, map_x, map_w, xscale, wscale, bias,
                           static_cast<TO*>(out), m, n, (k + kChunk - 1) / kChunk, vec_store);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename TO>
int launch_act(int activation, const void* xq, const float* xscale, const void* wq,
               const float* wscale, const float* bias, void* out, int m, int n, int k,
               bool chained, cudaStream_t stream) {
  if (activation == kNone)
    return launch_gemm<TO, kNone>(xq, xscale, wq, wscale, bias, out, m, n, k, chained, stream);
  if (activation == kGelu)
    return launch_gemm<TO, kGelu>(xq, xscale, wq, wscale, bias, out, m, n, k, chained, stream);
  return launch_gemm<TO, kGeluTanh>(xq, xscale, wq, wscale, bias, out, m, n, k, chained, stream);
}

int launch_out(int out_dtype, const void* xq, const float* xscale, const void* wq,
               const float* wscale, const float* bias, void* out, int m, int n, int k,
               int activation, bool chained, cudaStream_t stream) {
  if (!valid_shape(m, n, k, activation)) return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0) return 0;
  if (out_dtype == 0)
    return launch_act<__nv_bfloat16>(activation, xq, xscale, wq, wscale, bias, out, m, n, k,
                                     chained, stream);
  if (out_dtype == 1)
    return launch_act<float>(activation, xq, xscale, wq, wscale, bias, out, m, n, k, chained,
                             stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

int launch_quantize(const void* x, int x_dtype, void* xq, float* xscale, int m, int k,
                    cudaStream_t stream) {
  if (m < 0 || k < 16 || k % 16 != 0 || k > kMaxK) return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0) return 0;
  const unsigned grid = static_cast<unsigned>((m + kQuantWarps - 1) / kQuantWarps);
  signed char* q = static_cast<signed char*>(xq);
  if (x_dtype == 0)
    quantize_rows<__nv_bfloat16><<<grid, 32 * kQuantWarps, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(x), q, xscale, m, k);
  else if (x_dtype == 1)
    quantize_rows<float><<<grid, 32 * kQuantWarps, 0, stream>>>(static_cast<const float*>(x), q,
                                                                 xscale, m, k);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// xq (m, k) int8, xscale (m) f32, wq (n, k) int8, wscale (n) f32, bias (n)
// f32 or null, out (m, n) row-major: out_dtype 0 = bf16, 1 = f32;
// activation 0 none, 1 gelu (erf), 2 gelu (tanh). k a multiple of 16, at
// most 1536; every pointer 16-byte aligned. Returns a cudaError_t code.
int w8a8_matmul_launch(const void* xq, const float* xscale, const void* wq, const float* wscale,
                       const float* bias, void* out, int m, int n, int k, int activation,
                       int out_dtype, void* stream) {
  return launch_out(out_dtype, xq, xscale, wq, wscale, bias, out, m, n, k, activation, false,
                    static_cast<cudaStream_t>(stream));
}

// x (m, k): x_dtype 0 = bf16, 1 = f32 -> xq (m, k) int8 and xscale (m) f32,
// each row quantized over its full k. Returns a cudaError_t code.
int w8a8_quantize_launch(const void* x, int x_dtype, void* xq, float* xscale, int m, int k,
                         void* stream) {
  return launch_quantize(x, x_dtype, xq, xscale, m, k, static_cast<cudaStream_t>(stream));
}

// As w8a8_matmul_launch, with x (m, k) unquantized: w8a8_quantize_launch
// into the caller's scratch xq / xscale, then the GEMM on them, on one
// stream (two launches, the GEMM chained to the quantize).
int w8a8_matmul_dynx_launch(const void* x, int x_dtype, void* xq, float* xscale, const void* wq,
                            const float* wscale, const float* bias, void* out, int m, int n, int k,
                            int activation, int out_dtype, void* stream) {
  if (!valid_shape(m, n, k, activation) || (out_dtype != 0 && out_dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err = launch_quantize(x, x_dtype, xq, xscale, m, k, s);
  if (err != 0) return err;
  return launch_out(out_dtype, xq, xscale, wq, wscale, bias, out, m, n, k, activation,
                    kChainDynx, s);
}

const char* w8a8_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
