// Fused MrSw all-pairs alignment scorer for Hopper (sm_90a): wgmma on
// TMA-fed tiles in a persistent, warp-specialised kernel.
//
// Replaces aladin_tpu/ops/pallas/alignment_kernel.py::_mrsw_kernel (reached
// through mrsw_scores_pallas). It computes
//
//     score[i, c] = sum_w max_r <im[i, r], cap[c, w]>
//
// over token sets that the Python wrapper has already l2-normalised,
// stripped of special tokens, cast to the operand type (bf16, or int8 with
// per-tensor or per-bucket scales) and laid out for this kernel
// (ops/kernels/alignment_kernel.py::_kernel_operands and ::_plan):
//   * images in groups of 8, rows ordered (group, region slot j, image s),
//     so row 8j + s of a group is region j of image s (the Pallas kernel's
//     region packing); R is padded with zero rows to the group's slots
//     (whole slabs of 8, or two past them: the tail layout; `_group_slots`
//     picks the count), and regions past an image's length are zero rows;
//   * captions packed: only each caption's valid words, back to back, the
//     captions sorted by word count; a plan cuts them into tiles of 256
//     word columns that hold whole captions (a tile table: first word row,
//     first caption, caption count; a caption table: its column in the
//     tile, its word count, its output column);
//   * D padded with zeros to a multiple of 128 bytes.
// The (N_im, N_cap, R, W) alignment tensor never leaves the registers.
//
// Bound on an H100 SXM: the kernel is compute-bound. It performs
// 2 * N_im * slots * 256 * tiles * D tensor-core operations (the packed words
// fill about 98% of the columns of COCO-like captions; the rest are the
// next tile's first words, multiplied and ignored) against 989 TFLOP/s
// dense bf16 or 1979 TOP/s int8, while device memory need only carry the
// operands and the f32 output (about 1.2 GB at 5k x 25k, under 1 ms at
// 3.35 TB/s). What limits it is feeding the tensor cores: every operand
// byte is read from L2 into shared memory many times over. The design:
//   * one CTA per SM walks work units in a fixed banded order (kBand image
//     pairs sweep the caption tiles together, so the units in flight share
//     their operands in L2; at 5k x 25k a band of 4 pairs ran bf16 in
//     473-488 ms and one of 16, whose image slabs outgrow what L2 keeps, in
//     1004 ms: tools/k1_variants.py). A unit is two image groups (one per
//     consumer warpgroup) x one caption tile, whose captions are whole, so
//     the max over regions and the sum over words stay inside the CTA: no
//     split-K, no atomics;
//   * one producer thread issues TMA loads (128-byte swizzle, 128 bytes of D
//     per row per stage) of both 64-row image slabs and the 256-row caption
//     tile at the tile's first word row into a 4-stage mbarrier ring (3
//     stages: bf16 503 ms, int8 277 against 246-251; a bf16 consumer frees a
//     stage only once the next chunk's wgmma is issued); in the tail layout
//     slab 0's stages also carry each group's 16 tail rows; the producer
//     warpgroup gives its registers to the consumers (setmaxnreg);
//   * each consumer warpgroup runs wgmma m64n256 (bf16 -> f32 k16, or
//     s8 -> s32 k32) over D for each 64-row slab of its image group, then
//     folds the slab into a running max in registers. In the accumulator
//     layout a thread's two rows (16w + lane/4 and 16w + 8 + lane/4) are
//     region slots 2w and 2w + 1 of image lane/4, so the fold is a
//     per-register max; slots at or past R are excluded by index;
//   * the tail layout's last two slots (slot 32 of R 33) take no 64-row
//     slab. Slab 0's stages also carry both groups' 16 tail rows each (row
//     8j + s: tail slot j of image s), and beside slab 0's wgmma each
//     consumer issues the tail transposed: wgmma m64n32, its half of the
//     stage's caption chunk as M (two blocks of 64 words) and both groups'
//     32 tail rows as N. So the tail runs at wgmma's rate on operands
//     already in shared memory, each caption word read once for it
//     (tools/k1_variants.py at 5k x 25k, bf16, the tail's cost as a share
//     of the slab it replaces: 0.21-0.35; one consumer's rows a consumer,
//     m64n16 over all 256 words, 0.49-0.51; mma.sync, 0.58-0.61). Its 32
//     accumulators live through slab 0 only, before best[] is; their
//     maxima over the two slots go to both groups' column buffers between
//     two barriers of both consumers (one after the previous unit's sums,
//     one before the epilogue), where the warps' fold then maxes them in;
//   * per unit the ring carries slabs x (D / 128 bytes) stages of 48 KB (52
//     with the tail rows):
//     2 x 64 x 256 x 2 x 64 bf16 FLOP (85 FLOP a byte) or the same with 128
//     int8 values of D (171 OP a byte), against about 45 for the earlier
//     WMMA tiles, which streamed both operands for every 99 x 94 tile;
//   * the epilogue folds the four warps' maxima into one 8 x 256 buffer a
//     consumer (each warp a quarter of the columns at a time, rotating, so
//     no two warps touch one quarter together): a caption may straddle any
//     column, so the whole tile's column maxima are kept. Then a thread a
//     (image, caption) sums the caption's words and writes the score once,
//     to its output column; the producer is already loading the next
//     unit's operands. The 4-stage ring (208 KB with the tail rows) and the
//     two buffers (16.5 KB) fit the 227 KB an SM gives a block.
// Against a padded layout (each caption W16 words, a tile floor(256 /
// W16) whole captions, bucketed by width: 19.2 columns a COCO-like caption
// for 11.0 valid words), the packed tiles multiply 0.58 x the columns at
// 5k x 25k; the tail layout multiplies R 33 as 34 slots, not 40.
//
// Semantics kept from the reference:
//   * zero rows inside an image's R-row buffer (regions past its length)
//     are members of the max, in a slab or in the tail: that is the
//     reference's zero floor. The rows that the layout adds (slots R and
//     up, images past N_im) never join a max: slots are excluded by index
//     and padded images are not written, so an image with a full buffer
//     has no floor;
//   * a caption's sum reads only its own columns; a caption with no valid
//     word scores 0;
//   * every score is the same fixed-order computation whatever N_im, N_cap,
//     the other captions or the caption's place in its tile: D is
//     accumulated in order, each 16-word group of the caption's own word
//     index is summed by one tree (two 8-word trees and their sum; words
//     past the caption's length enter as 0) and the groups are added in
//     order, so a score equals that of the padded layout (whose trailing
//     zero words and zero groups leave the sum unchanged). Every image's
//     slot j takes the same path in a call (a slab, or the tail). int8 sums
//     are exact int32 sums (the tail's too); the descale is applied by the
//     wrapper. bf16 products in the tail may round their f32 sums over D
//     apart from wgmma's in the last bit.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kConsumers = 2;                     // consumer warpgroups, one image group each
constexpr int kThreads = 128 * (kConsumers + 1);  // + the producer warpgroup
constexpr int kImages = 8;                        // images interleaved in a group
constexpr int kSlabRows = 64;                     // wgmma M: 8 region slots x 8 images
constexpr int kTileCols = 256;                    // wgmma N: whole captions' words
constexpr int kWordGroup = 16;                    // words summed by one tree
constexpr int kRowBytes = 128;                    // bytes of D per row per stage
constexpr int kStages = 4;                        // 4 x 52 KB ring + the epilogue buffers
constexpr int kSlabSlots = kSlabRows / kImages;   // region slots a slab holds
constexpr int kTailRows = 16;                     // a group's tail: 2 region slots x 8 images
constexpr int kSlabBytes = kSlabRows * kRowBytes;
constexpr int kTailBytes = kTailRows * kRowBytes;
constexpr int kLoadBytes = kConsumers * kSlabBytes + kTileCols * kRowBytes;  // slabs + chunk
constexpr int kStageBytes = kLoadBytes + kConsumers * kTailBytes;            // + tail rows
// a layout whose slots end 2 past a multiple of 8 multiplies its last two in
// the tail pass (false: through one more 64-row slab, as tools/k1_variants.py times)
constexpr bool kTailPass = true;
// a row of column maxima an image; 264 = 8 mod 32, so the 8-byte stores of
// a half warp (4 images x 4 column pairs) hit 16 distinct bank pairs
constexpr int kColStride = kTileCols + 8;
constexpr int kColElems = kImages * kColStride;   // per consumer
constexpr int kBand = 4;  // image pairs sweeping the caption tiles together (16: L2 thrashes)
constexpr int kAlign = 1024;                       // 128-byte swizzle atoms are 1024-byte aligned
constexpr int kSmemBytes = kAlign + kStages * kStageBytes + kConsumers * kColElems * 4 +
                           2 * kStages * 8;
static_assert(kSmemBytes <= 232448, "a block has 227 KB of shared memory");
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;

template <typename T> struct AccOf;
template <> struct AccOf<__nv_bfloat16> { using type = float; };
template <> struct AccOf<signed char> { using type = int; };
template <typename A> struct PairOf;
template <> struct PairOf<float> { using type = float2; };
template <> struct PairOf<int> { using type = int2; };

__device__ __forceinline__ float lowest(float) { return -INFINITY; }
__device__ __forceinline__ int lowest(int) { return INT_MIN; }
__device__ __forceinline__ float acc_max(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ int acc_max(int a, int b) { return max(a, b); }

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

// a (box rows x 128 bytes) tile at (element x, row y) of a 2-D map; rows
// past the tensor arrive as zeros and still count their bytes
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

#define MRSW_D128                                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                   \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "          \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "          \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "          \
  "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "          \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "          \
  "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "    \
  "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, "      \
  "%125, %126, %127}"
#define MRSW_OPS8(T, b) \
  T(d[b]), T(d[b + 1]), T(d[b + 2]), T(d[b + 3]), T(d[b + 4]), T(d[b + 5]), T(d[b + 6]), T(d[b + 7])
#define MRSW_OPS128(T)                                                                       \
  MRSW_OPS8(T, 0), MRSW_OPS8(T, 8), MRSW_OPS8(T, 16), MRSW_OPS8(T, 24), MRSW_OPS8(T, 32),    \
      MRSW_OPS8(T, 40), MRSW_OPS8(T, 48), MRSW_OPS8(T, 56), MRSW_OPS8(T, 64),                \
      MRSW_OPS8(T, 72), MRSW_OPS8(T, 80), MRSW_OPS8(T, 88), MRSW_OPS8(T, 96),                \
      MRSW_OPS8(T, 104), MRSW_OPS8(T, 112), MRSW_OPS8(T, 120)

// d (+)= A(64 x 16) . B(256 x 16)^T, bf16 in, f32 accumulate
__device__ __forceinline__ void wgmma(float (&d)[128], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " MRSW_D128
      ", %128, %129, p, 1, 1, 0, 0;\n}\n"
      : MRSW_OPS128("+f")
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (+)= A(64 x 32) . B(256 x 32)^T, s8 in, s32 accumulate
__device__ __forceinline__ void wgmma(int (&d)[128], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 " MRSW_D128 ", %128, %129, p;\n}\n"
      : MRSW_OPS128("+r")
      : "l"(a), "l"(b), "r"(accumulate));
}

#define MRSW_D16 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define MRSW_OPS16(T) MRSW_OPS8(T, 0), MRSW_OPS8(T, 8)

// The tail pass, transposed: d (+)= W(64 words x 16) . T(32 tail rows x
// 16)^T, 64 words of the caption chunk as wgmma's M and both image groups'
// tail rows as N; bf16 in, f32 accumulate
__device__ __forceinline__ void wgmma_tail(float (&d)[16], uint64_t a, uint64_t b,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " MRSW_D16
      ", %16, %17, p, 1, 1, 0, 0;\n}\n"
      : MRSW_OPS16("+f")
      : "l"(a), "l"(b), "r"(accumulate));
}

// the same over 32 s8 values of D, s32 accumulate
__device__ __forceinline__ void wgmma_tail(int (&d)[16], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 " MRSW_D16 ", %16, %17, p;\n}\n"
      : MRSW_OPS16("+r")
      : "l"(a), "l"(b), "r"(accumulate));
}

// keeps the compiler from moving accumulator reads across wgmma.wait_group
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_acc(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
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

// both consumer warpgroups
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync %0, %1;\n" ::"n"(1 + kConsumers), "n"(128 * kConsumers) : "memory");
}

// ---- work order -------------------------------------------------------------

struct Unit {
  int pair;  // image groups 2 * pair and 2 * pair + 1
  int tile;  // caption tile
};

// kBand image pairs sweep all caption tiles, pairs fastest, then the next band
__device__ __forceinline__ Unit unit_at(long u, int pairs, long tiles) {
  const long band_units = static_cast<long>(kBand) * tiles;
  const int band = static_cast<int>(u / band_units);
  const long rem = u - band * band_units;
  const int width = min(kBand, pairs - band * kBand);
  return {band * kBand + static_cast<int>(rem % width), static_cast<int>(rem / width)};
}

// ---- the kernel --------------------------------------------------------------

// One 64-row slab of a consumer's image group over all of D: a chunk's four
// wgmma into acc and, with_tail, the tail's eight into t (the consumer's
// half of the stage's caption chunk, two blocks of 64 words, against both
// groups' tail rows, which slab 0's stages carry), each stage freed once
// its products are done.
template <typename T, typename Acc>
__device__ __forceinline__ void slab_pass(Acc (&acc)[128], Acc (&t)[2][16], bool with_tail,
                                          const char* ring, uint64_t* full, uint64_t* empty,
                                          int& stage, int& phase, int q, int lane, int n_chunks) {
  constexpr int kStepBytes = 32;  // wgmma depth: 16 bf16 or 32 int8
  constexpr int kBlockStep = kSlabRows * kRowBytes >> 4;  // 64 caption rows in a descriptor
  // bf16 keeps one chunk's wgmma in flight while it issues the next; int8
  // waits for each chunk (tools/k1_variants.py at 5k x 25k: int8 280 ms in
  // flight against 246-251 waiting; bf16 520 waiting against 473-488)
  constexpr bool kOverlap = sizeof(T) == 2;
  int prev = 0;
  for (int c = 0; c < n_chunks; ++c) {
    mbar_wait(&full[stage], phase);
    const char* st = ring + stage * kStageBytes;
    const uint64_t da = smem_desc(st + q * kSlabBytes);
    const uint64_t db = smem_desc(st + kConsumers * kSlabBytes);
    const uint64_t dw = db + 2 * q * kBlockStep;  // this consumer's 128 words
    const uint64_t dt = smem_desc(st + kLoadBytes);
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < kRowBytes / kStepBytes; ++s)  // +32 bytes = +2 in the address field
      wgmma(acc, da + 2 * s, db + 2 * s, (c > 0 || s > 0) ? 1 : 0);
    if (with_tail) {
#pragma unroll
      for (int s = 0; s < kRowBytes / kStepBytes; ++s)
#pragma unroll
        for (int blk = 0; blk < 2; ++blk)
          wgmma_tail(t[blk], dw + blk * kBlockStep + 2 * s, dt + 2 * s, (c > 0 || s > 0) ? 1 : 0);
    }
    wgmma_commit();
    if (kOverlap) {  // the previous chunk's products are done: free its stage
      wgmma_wait<1>();
      if (c > 0 && lane == 0) mbar_arrive(&empty[prev]);
    } else {
      wgmma_wait<0>();
      if (lane == 0) mbar_arrive(&empty[stage]);
    }
    prev = stage;
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
  }
  if (kOverlap) {
    wgmma_wait<0>();
    if (lane == 0) mbar_arrive(&empty[prev]);
  }
  fence_acc(acc);
  if (with_tail) {
#pragma unroll
    for (int blk = 0; blk < 2; ++blk) fence_acc(t[blk]);
  }
}

// fold a slab: a thread's rows 16 warp + lane / 4 and + 8 are slots `slot`
// and slot + 1 of image lane / 4
template <typename Acc>
__device__ __forceinline__ void fold_slab(Acc (&best)[64], const Acc (&acc)[128], int slot,
                                          int r) {
  const bool v0 = slot < r, v1 = slot + 1 < r;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      Acc m = best[2 * i + e];
      if (v0) m = acc_max(m, acc[4 * i + e]);
      if (v1) m = acc_max(m, acc[4 * i + 2 + e]);
      best[2 * i + e] = m;
    }
  }
}

// the tail's column maxima into both groups' colmax, where the epilogue's
// fold takes them in: block blk's rows are words 128q + 64 blk + 16 warp +
// lane / 4 (registers 4j, 4j + 1) and + 8 (4j + 2, 4j + 3), its columns 8j +
// 2 (lane % 4) + e: group j / 2, tail slot j % 2, image 2 (lane % 4) + e;
// slot 0 is always below R, slot 1 where `second`
template <typename Acc>
__device__ __forceinline__ void store_tail(Acc* colmax_all, const Acc (&t)[2][16], int q,
                                           int warp, int lane, bool second) {
  const int word = 128 * q + 16 * warp + lane / 4, image = 2 * (lane % 4);
#pragma unroll
  for (int g = 0; g < kConsumers; ++g) {
    Acc* colmax = colmax_all + g * kColElems;
#pragma unroll
    for (int blk = 0; blk < 2; ++blk) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          Acc m = t[blk][8 * g + 2 * h + e];
          if (second) m = acc_max(m, t[blk][8 * g + 4 + 2 * h + e]);
          colmax[(image + e) * kColStride + 64 * blk + word + 8 * h] = m;
        }
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
mrsw_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_t,
            const __grid_constant__ CUtensorMap map_b, float* __restrict__ out,
            const int4* __restrict__ tiles, const int4* __restrict__ caps, int n_im, int r,
            int slots, int n_cap, int n_tiles, int n_chunks) {
  using Acc = typename AccOf<T>::type;
  constexpr int kChunkElems = kRowBytes / sizeof(T);
  extern __shared__ char smem_raw[];
  char* ring = smem_raw + ((kAlign - (smem_addr(smem_raw) & (kAlign - 1))) & (kAlign - 1));
  Acc* colmax_all = reinterpret_cast<Acc*>(ring + kStages * kStageBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(colmax_all + kConsumers * kColElems);
  uint64_t* empty = full + kStages;

  const int groups = (n_im + kImages - 1) / kImages;
  const int pairs = (groups + kConsumers - 1) / kConsumers;
  const long units = static_cast<long>(pairs) * n_tiles;
  const int group_rows = kImages * slots;
  // slots 8 slabs .. slots - 1 through the tail pass, or all through slabs
  const bool tail = kTailPass && slots % kSlabSlots != 0;
  const int slabs = tail ? slots / kSlabSlots : (slots + kSlabSlots - 1) / kSlabSlots;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers * 4);  // lane 0 of every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) {
      int stage = 0, phase = 0;
      for (long u = blockIdx.x; u < units; u += gridDim.x) {
        const Unit unit = unit_at(u, pairs, n_tiles);
        const int a_row = unit.pair * kConsumers * group_rows;
        const int b_row = __ldg(&tiles[unit.tile]).x;
        for (int k = 0; k < slabs; ++k) {
          const bool with_tail = tail && k == 0;
          for (int c = 0; c < n_chunks; ++c) {
            mbar_wait(&empty[stage], phase ^ 1);
            mbar_expect_bytes(&full[stage], with_tail ? kStageBytes : kLoadBytes);
            char* st = ring + stage * kStageBytes;
#pragma unroll
            for (int q = 0; q < kConsumers; ++q)
              tma_load(st + q * kSlabBytes, &map_a, c * kChunkElems,
                       a_row + q * group_rows + k * kSlabRows, &full[stage]);
            tma_load(st + kConsumers * kSlabBytes, &map_b, c * kChunkElems, b_row, &full[stage]);
            if (with_tail) {
#pragma unroll
              for (int q = 0; q < kConsumers; ++q)
                tma_load(st + kLoadBytes + q * kTailBytes, &map_t, c * kChunkElems,
                         a_row + q * group_rows + slabs * kSlabRows, &full[stage]);
            }
            if (++stage == kStages) {
              stage = 0;
              phase ^= 1;
            }
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int q = wg - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int img = lane / 4, quad = lane % 4;  // accumulator rows: image img; columns 8i + 2quad
    Acc* colmax = colmax_all + q * kColElems;
    Acc acc[128];
    Acc best[64];
    int stage = 0, phase = 0;

    for (long u = blockIdx.x; u < units; u += gridDim.x) {
      const Unit unit = unit_at(u, pairs, n_tiles);
      Acc t[2][16];  // the tail's products: live through slab 0 only
      slab_pass<T>(acc, t, tail, ring, full, empty, stage, phase, q, lane, n_chunks);
#pragma unroll
      for (int i = 0; i < 64; ++i) best[i] = lowest(Acc());
      fold_slab(best, acc, 2 * warp, r);
      if (tail) {
        consumers_sync();  // both consumers' previous sums have read their colmax
        store_tail(colmax_all, t, q, warp, lane, slabs * kSlabSlots + 1 < r);
      }
      for (int k = 1; k < slabs; ++k) {
        slab_pass<T>(acc, t, false, ring, full, empty, stage, phase, q, lane, n_chunks);
        fold_slab(best, acc, kSlabSlots * k + 2 * warp, r);
      }
      if (tail) consumers_sync();  // both consumers' tails are in colmax

      // epilogue: the max over the 4 warps' slots (and the tail's, already
      // there) into colmax, each warp a quarter of the columns at a time,
      // rotating; a thread's pair of registers 2i, 2i + 1 is columns 8i +
      // 2quad and + 1 of image img
      using Pair = typename PairOf<Acc>::type;
      consumer_sync(1 + q);  // the previous unit's sums have read colmax
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int quarter = (warp + s) % 4;
#pragma unroll
        for (int qq = 0; qq < 4; ++qq) {
          if (qq != quarter) continue;
#pragma unroll
          for (int i = 8 * qq; i < 8 * qq + 8; ++i) {
            Pair* p = reinterpret_cast<Pair*>(colmax + img * kColStride + 8 * i + 2 * quad);
            Pair v = {best[2 * i], best[2 * i + 1]};
            if (s > 0 || tail) {
              const Pair o = *p;
              v.x = acc_max(v.x, o.x);
              v.y = acc_max(v.y, o.y);
            }
            *p = v;
          }
        }
        consumer_sync(1 + q);
      }

      // a thread an (image, caption): each 16-word group of the caption by
      // one tree (two 8-word trees and their sum, words past its length as
      // 0), the groups added in order, the score written to its column
      const int4 tile = __ldg(&tiles[unit.tile]);  // first row, first caption, captions
      const int image0 = (unit.pair * kConsumers + q) * kImages;
      for (int p = tid; p < kImages * tile.z; p += 128) {
        const int im_s = p % kImages;
        const int4 cap = __ldg(&caps[tile.y + p / kImages]);  // column, words, output column
        const Acc* row = colmax + im_s * kColStride + cap.x;
        Acc sum = 0;
        for (int g = 0; g < cap.y; g += kWordGroup) {
          Acc half[2];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            Acc m[kWordGroup / 2];
#pragma unroll
            for (int j = 0; j < kWordGroup / 2; ++j) {
              const int word = g + h * (kWordGroup / 2) + j;
              m[j] = 0;
              if (word < cap.y) m[j] = row[word];
            }
#pragma unroll
            for (int width = kWordGroup / 4; width >= 1; width /= 2)
#pragma unroll
              for (int j = 0; j < width; ++j) m[j] = m[2 * j] + m[2 * j + 1];
            half[h] = m[0];
          }
          const Acc group = half[0] + half[1];
          sum = g == 0 ? group : sum + group;
        }
        if (image0 + im_s < n_im)
          out[static_cast<long>(image0 + im_s) * n_cap + cap.z] = static_cast<float>(sum);
      }
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

// a row-major (rows, cols) map of 128-byte-wide, box_rows-high boxes
bool make_map(CUtensorMap* map, EncodeTiled encode, CUtensorMapDataType type, int elem_bytes,
              const void* base, long rows, int cols, int box_rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * elem_bytes};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kRowBytes / elem_bytes),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem_strides[2] = {1, 1};
  return encode(map, type, 2, const_cast<void*>(base), dims, strides, box, elem_strides,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T>
int launch(const void* im, const void* cap, const void* plan, float* out, int n_im, int r,
           int slots, int n_cap, int n_tiles, long b_rows, int d, CUtensorMapDataType type,
           cudaStream_t stream) {
  constexpr int kChunkElems = kRowBytes / sizeof(T);
  if (r < 1 || r > 128 || d < kChunkElems || d % kChunkElems != 0 || n_im < 0 || n_cap < 0 ||
      n_tiles < 0 || b_rows < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  // the bounds the kernel needs of the caller's layout: every slot below r
  // held, and slots past whole slabs only as a tail, which rides slab 0 and
  // whose first slot is below r
  const int tail_slots = slots % kSlabSlots;
  if (slots < r || (tail_slots != 0 && (tail_slots != kTailRows / kImages ||
                                        slots < kSlabSlots || slots - tail_slots >= r)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_im == 0 || n_cap == 0 || n_tiles == 0) return 0;
  const long a_rows = static_cast<long>((n_im + kImages - 1) / kImages) * kImages * slots;
  if (a_rows + kConsumers * kImages * slots + kSlabRows > INT_MAX || b_rows + kTileCols > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);  // TMA row coordinates are int32
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorSharedObjectSymbolNotFound);
  CUtensorMap map_a, map_t, map_b;
  if (!make_map(&map_a, encode, type, sizeof(T), im, a_rows, d, kSlabRows) ||
      !make_map(&map_t, encode, type, sizeof(T), im, a_rows, d, kTailRows) ||
      !make_map(&map_b, encode, type, sizeof(T), cap, b_rows, d, kTileCols))
    return static_cast<int>(cudaErrorInvalidValue);

  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(mrsw_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long groups = (n_im + kImages - 1) / kImages;
  const long units = (groups + kConsumers - 1) / kConsumers * n_tiles;
  const unsigned grid = static_cast<unsigned>(units < sms ? units : sms);
  const int4* tiles = static_cast<const int4*>(plan);
  mrsw_kernel<T><<<grid, kThreads, kSmemBytes, stream>>>(map_a, map_t, map_b, out, tiles,
                                                         tiles + n_tiles, n_im, r, slots, n_cap,
                                                         n_tiles, d / kChunkElems);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = bf16 operands (f32 scores), 1 = int8 operands (integer scores,
// returned as f32 before the wrapper's descale). im: the image operand in
// the kernel's layout, (ceil(n_im / 8) * 8 * slots, d) row-major with rows
// ordered (group of 8 images, region slot, image); cap: the packed caption
// words, (b_rows, d) row-major; plan: int32 on the device, n_tiles rows of
// {first word row, first caption, caption count, 0}, then n_cap rows of
// {column in the tile, word count (at most 128), output column, first word
// row}, the captions of a tile consecutive and whole within its 256
// columns; out: (n_im, n_cap) f32 row-major. r is the real region count;
// slots the region slots a group holds in im (at least r; a count two past
// whole slabs takes its last two through the tail pass). d must be a
// multiple of 128 bytes of operand. Returns a cudaError_t code.
int mrsw_scores_launch(int dtype, const void* im, const void* cap, const void* plan, float* out,
                       int n_im, int r, int slots, int n_cap, int n_tiles, long b_rows, int d,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<__nv_bfloat16>(im, cap, plan, out, n_im, r, slots, n_cap, n_tiles, b_rows, d,
                                 CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, s);
  if (dtype == 1)
    return launch<signed char>(im, cap, plan, out, n_im, r, slots, n_cap, n_tiles, b_rows, d,
                               CU_TENSOR_MAP_DATA_TYPE_UINT8, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* mrsw_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
