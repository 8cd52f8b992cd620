// W8A8 int8 GEMM with a fused f32 epilogue for Hopper (sm_90a).
//
// Replaces aladin_tpu/ops/pallas/quant_matmul.py::_kernel (reached through
// w8a8_matmul) and ::_kernel_dynx (through w8a8_matmul_dynx). Both compute
//
//     y[m, n] = act(acc[m, n] * xscale[m] * wscale[n] + bias[n]),
//     acc[m, n] = sum_k xq[m, k] * wq[n, k]      (exact, int32, whole K)
//
// with the epilogue in f32 in _epilogue's order, each product and the add
// rounded on their own (no FMA contraction), act = none, exact-erf gelu
// (erff) or the tanh form, and y stored as bf16 or f32. The dynx variant
// takes bf16 or f32 x and quantizes each row over its full K inside the
// kernel, exactly as _kernel_dynx does:
//
//     scale = max(absmax, 1e-8) * (1/127)          (a reciprocal multiply)
//     q     = clip(rint(x / scale), -127, 127)     (IEEE divide, half to even)
//
// The weights are in the nn.Linear layout, wq (N, K) int8 row-major, which
// is the column-major B operand of the int8 tensor-core op.
//
// Bound on an H100 SXM: at the encoder's shapes (M 1600-2688, K 768,
// N 2304-3072) the bytes (x read once, wq read once, y written once over
// 3.35 TB/s) and the 2*M*K*N int8 operations (over 1979 TOP/s) are about
// even, ~5 us each. A first, simple design:
//   * one block of 8 warps owns a 128 x 128 output tile (grid: N tiles
//     fastest, so the blocks resident together share their x rows in L2);
//   * the block's 128 activation rows stay in shared memory as int8 for the
//     whole K (K <= 1536): copied with cp.async (xq given) or quantized by
//     the block from x (dynx: one warp per row, the absmax by warp shuffle,
//     then the quantize), so every row scale covers the full K;
//   * the weight tile streams through a three-stage cp.async ring in chunks
//     of 64 bytes of K;
//   * WMMA s8 x s8 -> s32 16x16x16 fragments (mma.sync); each warp holds a
//     32 x 64 accumulator tile;
//   * the epilogue stages the int32 tile in shared memory (over the
//     activation rows) and writes y row by row, coalesced.
// Every block of a row tile quantizes its rows again (N / 128 times a row).
// wgmma, TMA and a persistent schedule are left for a later revision.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

using namespace nvcuda;

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kWarpsM = 4;
constexpr int kWarpsN = 2;
constexpr int kTileM = 128;
constexpr int kTileN = 128;
constexpr int kFragM = kTileM / 16 / kWarpsM;  // 2 fragments a warp along M
constexpr int kFragN = kTileN / 16 / kWarpsN;  // 4 along N
constexpr int kChunkBytes = 64;                // bytes of K per ring stage
constexpr int kChunkPlanes = kChunkBytes / 16;
constexpr int kStages = 3;
constexpr int kStageBytes = kTileN * kChunkBytes;
constexpr int kLdc = kTileN + 4;  // epilogue tile row stride, in int32
constexpr int kMaxK = 1536;       // activation rows held whole in shared memory
constexpr float kScaleFloor = static_cast<float>(1e-8);
constexpr float kInv127 = static_cast<float>(1.0 / 127.0);
constexpr float kSqrtHalf = 0.7071067811865476f;
constexpr float kGeluTanhC = 0.7978845608028654f;  // sqrt(2 / pi)

enum Activation { kNone = 0, kGelu = 1, kGeluTanh = 2 };

// Shared-memory layout of an int8 operand: planes of 16 bytes of K; plane p
// holds [row][16] contiguously, so a 16x16 fragment is 256 contiguous bytes
// (aligned for WMMA) with a leading dimension of 16.
__host__ __device__ size_t smem_bytes(int k) {
  const size_t a = (size_t)kTileM * k;
  const size_t c = (size_t)kTileM * kLdc * 4;
  return (a > c ? a : c) + (size_t)kStages * kStageBytes + 3 * 128 * sizeof(float);
}

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

// One ring stage: chunk c of the weight tile (rows n0 .. n0 + 127).
__device__ __forceinline__ void load_b_chunk(char* stage, const signed char* wq, int n0, int n,
                                             int k, int planes, int c) {
  for (int idx = threadIdx.x; idx < kTileN * kChunkPlanes; idx += kThreads) {
    const int row = idx / kChunkPlanes, pp = idx % kChunkPlanes;
    const int plane = c * kChunkPlanes + pp;
    if (plane >= planes) continue;
    const bool valid = n0 + row < n;
    const signed char* src = wq + (valid ? (long)(n0 + row) * k : 0) + plane * 16;
    cp_async16(stage + pp * kTileN * 16 + row * 16, src, valid);
  }
}

// The xq variant: the block's rows of int8 activations, whole K.
__device__ __forceinline__ void load_a_int8(char* a, const signed char* xq, int m0, int m, int k) {
  const int planes = k / 16;
  for (int idx = threadIdx.x; idx < kTileM * planes; idx += kThreads) {
    const int row = idx / planes, plane = idx % planes;
    const bool valid = m0 + row < m;
    const signed char* src = xq + (valid ? (long)(m0 + row) * k : 0) + plane * 16;
    cp_async16(a + plane * kTileM * 16 + row * 16, src, valid);
  }
}

template <typename T> struct Vec;
template <> struct Vec<__nv_bfloat16> {
  static constexpr int kElems = 8;  // 16 bytes
  __device__ static void load(const __nv_bfloat16* p, float* f) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(h[i]);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
};
template <> struct Vec<float> {
  static constexpr int kElems = 4;
  __device__ static void load(const float* p, float* f) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    f[0] = t.x; f[1] = t.y; f[2] = t.z; f[3] = t.w;
  }
};

// The dynx variant: quantize the block's rows of x into shared memory, one
// warp per row, and keep each row's scale (rows past M: zeros).
template <typename TX>
__device__ void quantize_a(char* a, float* row_scale, const TX* x, int m0, int m, int k) {
  constexpr int kVec = Vec<TX>::kElems;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int vecs = k / kVec;
  for (int row = warp; row < kTileM; row += kWarps) {
    const bool valid = m0 + row < m;
    const TX* src = x + (valid ? (long)(m0 + row) * k : 0);
    float amax = 0.f;
    if (valid) {
      for (int v = lane; v < vecs; v += 32) {
        float f[kVec];
        Vec<TX>::load(src + v * kVec, f);
#pragma unroll
        for (int i = 0; i < kVec; ++i) amax = fmaxf(amax, fabsf(f[i]));
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off /= 2)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
    const float scale = __fmul_rn(fmaxf(amax, kScaleFloor), kInv127);
    if (lane == 0) row_scale[row] = scale;
    for (int v = lane; v < vecs; v += 32) {
      float f[kVec];
      if (valid) {
        Vec<TX>::load(src + v * kVec, f);
      } else {
#pragma unroll
        for (int i = 0; i < kVec; ++i) f[i] = 0.f;
      }
      uint32_t packed[kVec / 4];
#pragma unroll
      for (int w = 0; w < kVec / 4; ++w) {
        uint32_t word = 0;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float q = fminf(fmaxf(rintf(__fdiv_rn(f[4 * w + i], scale)), -127.f), 127.f);
          word |= (uint32_t)((int)q & 0xff) << (8 * i);
        }
        packed[w] = word;
      }
      const int kk = v * kVec;  // kVec divides 16: the vector sits inside one plane
      char* dst = a + (kk / 16) * kTileM * 16 + row * 16 + kk % 16;
      if constexpr (kVec == 8) {
        *reinterpret_cast<uint2*>(dst) = make_uint2(packed[0], packed[1]);
      } else {
        *reinterpret_cast<uint32_t*>(dst) = packed[0];
      }
    }
  }
}

__device__ __forceinline__ float epilogue(int acc, float xs, float ws, const float* bias, int col,
                                          int activation) {
  float y = __fmul_rn(__fmul_rn(__int2float_rn(acc), xs), ws);
  if (bias != nullptr) y = __fadd_rn(y, bias[col]);
  if (activation == kGelu) {
    y = __fmul_rn(__fmul_rn(0.5f, y), __fadd_rn(1.0f, erff(__fmul_rn(y, kSqrtHalf))));
  } else if (activation == kGeluTanh) {
    const float cube = __fmul_rn(__fmul_rn(__fmul_rn(0.044715f, y), y), y);
    y = __fmul_rn(__fmul_rn(0.5f, y),
                  __fadd_rn(1.0f, tanhf(__fmul_rn(kGeluTanhC, __fadd_rn(y, cube)))));
  }
  return y;
}

__device__ __forceinline__ void store_out(float* out, long i, float y) { out[i] = y; }
__device__ __forceinline__ void store_out(__nv_bfloat16* out, long i, float y) {
  out[i] = __float2bfloat16_rn(y);
}

// TX: signed char (xq given, with xscale) or bf16 / float (dynx).
template <typename TX, typename TO>
__global__ void __launch_bounds__(kThreads, 1)
w8a8_kernel(const TX* __restrict__ x, const float* __restrict__ xscale,
            const signed char* __restrict__ wq, const float* __restrict__ wscale,
            const float* __restrict__ bias, TO* __restrict__ out, int m, int n, int k,
            int activation) {
  extern __shared__ __align__(128) char smem[];
  const size_t a_bytes = smem_bytes(k) - (size_t)kStages * kStageBytes - 3 * 128 * sizeof(float);
  char* a = smem;
  char* ring = smem + a_bytes;
  float* row_scale = reinterpret_cast<float*>(ring + kStages * kStageBytes);
  float* col_scale = row_scale + kTileM;
  float* col_bias = col_scale + kTileN;

  const int n0 = blockIdx.x * kTileN, m0 = blockIdx.y * kTileM;
  const int planes = k / 16;
  const int chunks = (planes + kChunkPlanes - 1) / kChunkPlanes;
  const int warp = threadIdx.x / 32;
  const int wm = warp % kWarpsM, wn = warp / kWarpsM;

  for (int i = threadIdx.x; i < kTileN; i += kThreads) {
    const bool valid = n0 + i < n;
    col_scale[i] = valid ? wscale[n0 + i] : 0.f;
    col_bias[i] = (valid && bias != nullptr) ? bias[n0 + i] : 0.f;
  }
  constexpr bool kDynx = !std::is_same<TX, signed char>::value;
  if constexpr (!kDynx) {
    load_a_int8(a, reinterpret_cast<const signed char*>(x), m0, m, k);
    for (int i = threadIdx.x; i < kTileM; i += kThreads)
      row_scale[i] = m0 + i < m ? xscale[m0 + i] : 0.f;
  }
  // ring prologue: one commit group a chunk (the int8 rows join the first)
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < chunks) load_b_chunk(ring + s * kStageBytes, wq, n0, n, k, planes, s);
    cp_async_commit();
  }
  // the dynx quantize overlaps the ring's first loads
  if constexpr (kDynx) quantize_a<TX>(a, row_scale, x, m0, m, k);

  wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[kFragM][kFragN];
#pragma unroll
  for (int i = 0; i < kFragM; ++i)
#pragma unroll
    for (int j = 0; j < kFragN; ++j) wmma::fill_fragment(acc[i][j], 0);

  for (int c = 0; c < chunks; ++c) {
    const int next = c + kStages - 1;
    if (next < chunks)
      load_b_chunk(ring + (next % kStages) * kStageBytes, wq, n0, n, k, planes, next);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const char* stage = ring + (c % kStages) * kStageBytes;
#pragma unroll
    for (int pp = 0; pp < kChunkPlanes; ++pp) {
      const int plane = c * kChunkPlanes + pp;
      if (plane >= planes) break;
      wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> af[kFragM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::col_major> bf[kFragN];
      const signed char* pa = reinterpret_cast<const signed char*>(a + plane * kTileM * 16);
      const signed char* pb = reinterpret_cast<const signed char*>(stage + pp * kTileN * 16);
#pragma unroll
      for (int i = 0; i < kFragM; ++i)
        wmma::load_matrix_sync(af[i], pa + (wm * kFragM + i) * 256, 16);
#pragma unroll
      for (int j = 0; j < kFragN; ++j)
        wmma::load_matrix_sync(bf[j], pb + (wn * kFragN + j) * 256, 16);
#pragma unroll
      for (int i = 0; i < kFragM; ++i)
#pragma unroll
        for (int j = 0; j < kFragN; ++j) wmma::mma_sync(acc[i][j], af[i], bf[j], acc[i][j]);
    }
    __syncthreads();
  }
  cp_async_wait<0>();
  __syncthreads();

  // epilogue: the int32 tile goes to shared memory over the activation rows
  int* tile = reinterpret_cast<int*>(a);
#pragma unroll
  for (int i = 0; i < kFragM; ++i)
#pragma unroll
    for (int j = 0; j < kFragN; ++j)
      wmma::store_matrix_sync(tile + (wm * kFragM + i) * 16 * kLdc + (wn * kFragN + j) * 16,
                              acc[i][j], kLdc, wmma::mem_row_major);
  __syncthreads();
  for (int idx = threadIdx.x; idx < kTileM * kTileN; idx += kThreads) {
    const int r = idx / kTileN, col = idx % kTileN;
    if (m0 + r >= m || n0 + col >= n) continue;
    const float y = epilogue(tile[r * kLdc + col], row_scale[r], col_scale[col],
                             bias != nullptr ? col_bias : nullptr, col, activation);
    store_out(out, (long)(m0 + r) * n + n0 + col, y);
  }
}

template <typename TX, typename TO>
int launch(const void* x, const float* xscale, const void* wq, const float* wscale,
           const float* bias, void* out, int m, int n, int k, int activation,
           cudaStream_t stream) {
  if (m < 0 || n < 1 || k < 16 || k % 16 != 0 || k > kMaxK || activation < kNone ||
      activation > kGeluTanh)
    return (int)cudaErrorInvalidValue;
  if (m == 0) return 0;
  const long row_tiles = (m + kTileM - 1) / kTileM;
  if (row_tiles > 65535) return (int)cudaErrorInvalidConfiguration;
  const size_t smem = smem_bytes(k);
  cudaError_t err = cudaFuncSetAttribute(w8a8_kernel<TX, TO>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n + kTileN - 1) / kTileN, (unsigned)row_tiles);
  w8a8_kernel<TX, TO><<<grid, kThreads, smem, stream>>>(
      static_cast<const TX*>(x), xscale, static_cast<const signed char*>(wq), wscale, bias,
      static_cast<TO*>(out), m, n, k, activation);
  return (int)cudaGetLastError();
}

template <typename TX>
int launch_out(int out_dtype, const void* x, const float* xscale, const void* wq,
               const float* wscale, const float* bias, void* out, int m, int n, int k,
               int activation, cudaStream_t stream) {
  if (out_dtype == 0)
    return launch<TX, __nv_bfloat16>(x, xscale, wq, wscale, bias, out, m, n, k, activation, stream);
  if (out_dtype == 1)
    return launch<TX, float>(x, xscale, wq, wscale, bias, out, m, n, k, activation, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// xq (m, k) int8, xscale (m) f32, wq (n, k) int8, wscale (n) f32, bias (n)
// f32 or null, out (m, n) row-major: out_dtype 0 = bf16, 1 = f32;
// activation 0 none, 1 gelu (erf), 2 gelu (tanh). k a multiple of 16, at
// most 1536. Returns a cudaError_t code.
int w8a8_matmul_launch(const void* xq, const float* xscale, const void* wq, const float* wscale,
                       const float* bias, void* out, int m, int n, int k, int activation,
                       int out_dtype, void* stream) {
  return launch_out<signed char>(out_dtype, xq, xscale, wq, wscale, bias, out, m, n, k,
                                 activation, static_cast<cudaStream_t>(stream));
}

// As w8a8_matmul_launch, with x (m, k) unquantized: x_dtype 0 = bf16,
// 1 = f32; each row is quantized over its full k inside the kernel.
int w8a8_matmul_dynx_launch(const void* x, int x_dtype, const void* wq, const float* wscale,
                            const float* bias, void* out, int m, int n, int k, int activation,
                            int out_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0)
    return launch_out<__nv_bfloat16>(out_dtype, x, nullptr, wq, wscale, bias, out, m, n, k,
                                     activation, s);
  if (x_dtype == 1)
    return launch_out<float>(out_dtype, x, nullptr, wq, wscale, bias, out, m, n, k, activation, s);
  return (int)cudaErrorInvalidValue;
}

const char* w8a8_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
