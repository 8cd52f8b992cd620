// Fused MrSw all-pairs alignment scorer for Hopper (sm_90a).
//
// Replaces aladin_tpu/ops/pallas/alignment_kernel.py::_mrsw_kernel (reached
// through mrsw_scores_pallas). It computes
//
//     score[i, c] = sum_w max_r <im[i, r], cap[c, w]>
//
// over token sets that the Python wrapper has already l2-normalised,
// stripped of special tokens, zeroed past each length and cast to the
// operand type (bf16, or int8 with per-tensor scales). The (N_im, N_cap, R, W)
// alignment tensor is never written to device memory: each block reduces its
// alignment tile in shared memory and writes only its (BI, BC) scores.
//
// Bound on an H100 SXM: the kernel is compute-bound. It performs
// 2 * N_im * R * N_cap * W * D tensor-core operations (R, W = stripped buffer
// widths) against 989 TFLOP/s dense bf16 or 1979 TOP/s int8, while it must
// move only the operands and the f32 output (about 2.6 GB at 5k x 25k,
// under 1 ms at 3.35 TB/s). The design therefore keeps the tensor cores fed
// from shared memory and spends no device-memory traffic on the alignment
// tensor:
//   * a 1-D grid over (image tile, caption tile) pairs, visited in groups of
//     8 image tiles so that the blocks resident at one time share a few
//     image and caption tiles in L2;
//   * one block = up to 128 flattened image rows (BI whole images of R rows)
//     x up to 128 flattened word columns (BC whole captions of W words),
//     so that the max over regions and the sum over words stay inside the
//     block and need no atomics;
//   * D is consumed in 128-byte chunks through a two-stage cp.async ring;
//   * two blocks per SM (registers capped at 128, a few bytes spill), which
//     measured faster than one block per SM with the same scores (PERF.md);
//   * WMMA fragments (mma.sync): bf16 x bf16 -> f32, s8 x s8 -> s32;
//   * the epilogue stores the accumulators to shared memory (aliasing the
//     ring), takes each image's max over exactly its R rows and sums the W
//     word maxima of each caption in word order.
// wgmma and TMA are left for a later revision.
//
// Semantics kept from the reference:
//   * zero rows inside an image's R-row buffer (regions past its length)
//     are members of the max: that is the reference's zero floor. Rows that
//     the tiling adds past an image's R rows belong to the next image or to
//     the zero-filled tail and never join its max, so an image with a full
//     buffer has no floor;
//   * padded words are zero and contribute exactly 0 to the word sum;
//   * every score is the same fixed-order computation whatever N_im, N_cap
//     or the bucket: D is accumulated chunk by chunk in order, no split-K,
//     no atomics, and words are summed sequentially. int8 sums are exact
//     int32 sums; the descale is applied by the wrapper.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kWarpsM = 4;
constexpr int kWarpsN = 2;
constexpr int kTileRows = 128;  // flattened image rows per block (at most)
constexpr int kTileCols = 128;  // flattened word columns per block (at most)
constexpr int kFragM = kTileRows / 16 / kWarpsM;  // fragments per warp along M
constexpr int kFragN = kTileCols / 16 / kWarpsN;  // fragments per warp along N
constexpr int kChunkBytes = 128;                  // bytes of D per row per stage
constexpr int kStages = 2;     // cp.async ring depth (a third stage measured no faster)
constexpr int kMinBlocks = 2;  // resident blocks per SM: caps registers at 128
constexpr int kStageBytes = (kTileRows + kTileCols) * kChunkBytes;
constexpr int kLdc = kTileCols + 4;  // epilogue tile row stride, in elements
constexpr int kEpilogueBytes = kTileRows * kLdc * 4;
constexpr int kSmemBytes =
    (kStages * kStageBytes > kEpilogueBytes) ? kStages * kStageBytes : kEpilogueBytes;
constexpr int kGroup = 8;  // image tiles per block-order group
static_assert(kTileRows == kTileCols, "both operands share the stage plane stride");

template <typename T> struct AccOf;
template <> struct AccOf<__nv_bfloat16> { using type = float; };
template <> struct AccOf<signed char> { using type = int; };

__device__ __forceinline__ float acc_max(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ int acc_max(int a, int b) { return max(a, b); }

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  int n = valid ? 16 : 0;  // 0 source bytes: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Shared-memory stage layout: the chunk of each operand is cut into planes
// of 16 elements of D; plane p holds [row][16] contiguously, so a 16x16
// WMMA fragment is 256 contiguous elements with a leading dimension of 16.
template <typename T>
__device__ __forceinline__ void load_stage(char* stage, const char* a, const char* b,
                                           long a_row0, long a_rows, long b_row0, long b_rows,
                                           int rows_a, int rows_b, long row_bytes, int chunk) {
  constexpr int e = sizeof(T);
  constexpr int kVecPerRow = kChunkBytes / 16;
  const int total = (rows_a + rows_b) * kVecPerRow;
  for (int idx = threadIdx.x; idx < total; idx += kThreads) {
    const int row = idx / kVecPerRow;
    const int v = idx % kVecPerRow;
    const bool is_a = row < rows_a;
    const int r = is_a ? row : row - rows_a;
    const long grow = (is_a ? a_row0 : b_row0) + r;
    const bool valid = grow < (is_a ? a_rows : b_rows);
    const char* base = is_a ? a : b;
    const char* src = base + (valid ? grow : 0) * row_bytes + (long)chunk * kChunkBytes + v * 16;
    char* dst = stage + (is_a ? 0 : kTileRows * kChunkBytes) + (v / e) * (kTileRows * 16 * e) +
                r * 16 * e + (v % e) * 16;
    cp_async16(dst, src, valid);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
mrsw_kernel(const T* __restrict__ im, const T* __restrict__ cap, float* __restrict__ out,
            int n_im, int r, int n_cap, int w, int d, int bi, int bc) {
  using Acc = typename AccOf<T>::type;
  constexpr int e = sizeof(T);
  constexpr int kChunkElems = kChunkBytes / e;
  constexpr int kPlanes = kChunkElems / 16;
  extern __shared__ __align__(128) char smem[];

  // grouped block order: kGroup image tiles sweep the caption tiles together
  const int n_im_tiles = (n_im + bi - 1) / bi;
  const int n_cap_tiles = (n_cap + bc - 1) / bc;
  const long per_group = (long)kGroup * n_cap_tiles;
  const long bid = blockIdx.x;
  const int first = (int)(bid / per_group) * kGroup;
  const int group_size = min(kGroup, n_im_tiles - first);
  const long local = bid % per_group;
  const int img0 = (first + (int)(local % group_size)) * bi;
  const int cap0 = (int)(local / group_size) * bc;

  const int mt = (bi * r + 15) / 16;  // fragment rows in use
  const int nt = (bc * w + 15) / 16;  // fragment columns in use
  const int warp = threadIdx.x / 32;
  const int wm = warp % kWarpsM;
  const int wn = warp / kWarpsM;

  wmma::fragment<wmma::accumulator, 16, 16, 16, Acc> acc[kFragM][kFragN];
#pragma unroll
  for (int i = 0; i < kFragM; ++i)
#pragma unroll
    for (int j = 0; j < kFragN; ++j) wmma::fill_fragment(acc[i][j], Acc(0));

  const char* a = reinterpret_cast<const char*>(im);
  const char* b = reinterpret_cast<const char*>(cap);
  const long row_bytes = (long)d * e;
  const long a_row0 = (long)img0 * r, a_rows = (long)n_im * r;
  const long b_row0 = (long)cap0 * w, b_rows = (long)n_cap * w;
  const int n_chunks = d / kChunkElems;

  // ring of kStages chunks: chunk c lives in stage c % kStages; one commit
  // group per chunk (empty past the end) keeps the wait count uniform
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_chunks)
      load_stage<T>(smem + s * kStageBytes, a, b, a_row0, a_rows, b_row0, b_rows, mt * 16,
                    nt * 16, row_bytes, s);
    cp_async_commit();
  }
  for (int chunk = 0; chunk < n_chunks; ++chunk) {
    const int next = chunk + kStages - 1;
    if (next < n_chunks)
      load_stage<T>(smem + (next % kStages) * kStageBytes, a, b, a_row0, a_rows, b_row0,
                    b_rows, mt * 16, nt * 16, row_bytes, next);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const char* stage = smem + (chunk % kStages) * kStageBytes;
    const T* sa = reinterpret_cast<const T*>(stage);
    const T* sb = reinterpret_cast<const T*>(stage + kTileRows * kChunkBytes);
#pragma unroll
    for (int p = 0; p < kPlanes; ++p) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> af[kFragM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::col_major> bf[kFragN];
#pragma unroll
      for (int i = 0; i < kFragM; ++i) {
        const int mi = wm + i * kWarpsM;
        if (mi < mt) wmma::load_matrix_sync(af[i], sa + p * kTileRows * 16 + mi * 256, 16);
      }
#pragma unroll
      for (int j = 0; j < kFragN; ++j) {
        const int ni = wn + j * kWarpsN;
        if (ni < nt) wmma::load_matrix_sync(bf[j], sb + p * kTileCols * 16 + ni * 256, 16);
      }
#pragma unroll
      for (int i = 0; i < kFragM; ++i)
#pragma unroll
        for (int j = 0; j < kFragN; ++j)
          if (wm + i * kWarpsM < mt && wn + j * kWarpsN < nt)
            wmma::mma_sync(acc[i][j], af[i], bf[j], acc[i][j]);
    }
    __syncthreads();
  }

  // epilogue: the alignment tile goes to shared memory (over the ring)
  cp_async_wait<0>();
  __syncthreads();
  Acc* c = reinterpret_cast<Acc*>(smem);
#pragma unroll
  for (int i = 0; i < kFragM; ++i)
#pragma unroll
    for (int j = 0; j < kFragN; ++j) {
      const int mi = wm + i * kWarpsM, ni = wn + j * kWarpsN;
      if (mi < mt && ni < nt)
        wmma::store_matrix_sync(c + mi * 16 * kLdc + ni * 16, acc[i][j], kLdc,
                                wmma::mem_row_major);
    }
  __syncthreads();

  // max over each image's R rows, written over the image's first row
  const int cols = bc * w;
  for (int idx = threadIdx.x; idx < bi * cols; idx += kThreads) {
    const int i = idx / cols, col = idx % cols;
    if (img0 + i >= n_im || cap0 + col / w >= n_cap) continue;
    Acc* p = c + i * r * kLdc + col;
    Acc m = p[0];
    for (int rr = 1; rr < r; ++rr) m = acc_max(m, p[rr * kLdc]);
    p[0] = m;
  }
  __syncthreads();

  // sum of each caption's word maxima, in word order
  for (int idx = threadIdx.x; idx < bi * bc; idx += kThreads) {
    const int i = idx / bc, cc = idx % bc;
    if (img0 + i >= n_im || cap0 + cc >= n_cap) continue;
    const Acc* p = c + i * r * kLdc + cc * w;
    Acc s = Acc(0);
    for (int ww = 0; ww < w; ++ww) s += p[ww];
    out[(long)(img0 + i) * n_cap + cap0 + cc] = static_cast<float>(s);
  }
}

template <typename T>
int launch(const void* im, const void* cap, float* out, int n_im, int r, int n_cap, int w, int d,
           cudaStream_t stream) {
  constexpr int kChunkElems = kChunkBytes / sizeof(T);
  if (r < 1 || r > kTileRows || w < 1 || w > kTileCols || d < kChunkElems ||
      d % kChunkElems != 0 || n_im < 0 || n_cap < 0)
    return (int)cudaErrorInvalidValue;
  if (n_im == 0 || n_cap == 0) return 0;
  const int bi = min(kTileRows / r, n_im);
  const int bc = min(kTileCols / w, n_cap);
  const long blocks = (long)((n_im + bi - 1) / bi) * ((n_cap + bc - 1) / bc);
  if (blocks > 0x7fffffffL) return (int)cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(mrsw_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  mrsw_kernel<T><<<(unsigned)blocks, kThreads, kSmemBytes, stream>>>(
      static_cast<const T*>(im), static_cast<const T*>(cap), out, n_im, r, n_cap, w, d, bi, bc);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = bf16 operands (f32 scores), 1 = int8 operands (integer scores,
// returned as f32 before the wrapper's descale). im: (n_im * r, d) row-major,
// cap: (n_cap * w, d) row-major, out: (n_im, n_cap) f32 row-major; d must be
// a multiple of 128 bytes of operand. Returns a cudaError_t code.
int mrsw_scores_launch(int dtype, const void* im, const void* cap, float* out, int n_im, int r,
                       int n_cap, int w, int d, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<__nv_bfloat16>(im, cap, out, n_im, r, n_cap, w, d, s);
  if (dtype == 1) return launch<signed char>(im, cap, out, n_im, r, n_cap, w, d, s);
  return (int)cudaErrorInvalidValue;
}

const char* mrsw_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
