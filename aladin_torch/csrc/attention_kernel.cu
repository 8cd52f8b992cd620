// Fused all-heads self-attention, forward and backward, for Hopper (sm_90a).
//
// Replaces aladin_tpu/ops/pallas/attention_kernel.py::_fwd_kernel and
// ::_bwd_kernel (reached through fused_attention). For one (batch row, head)
// the forward computes
//
//     p   = softmax(q k^T / sqrt(d) + bias)          (f32)
//     pd  = keep ? p * scale : 0                     (dropout, scale = 1/(1-rate))
//     ctx = round_to_T(pd) v                         (f32 accumulation, stored as T)
//
// and the backward recomputes p from (q, k, v, bias), regenerates the same
// keep mask from the same seed, and returns dq, dk, dv in T, computing wholly
// in f32 from the T inputs: dv = pd^T g, dp = keep ? (g v^T) * scale : 0,
// ds = p * (dp - rowsum(dp * p)) / sqrt(d), dq = ds k, dk = ds^T q. The
// softmax VJP uses the undropped p, as the JAX kernel does. bias and seed get
// no gradient.
//
// Layout: q, k, v, g, ctx, dq, dk, dv are (B, S, H, d) row-major, read and
// written in place with a stride of H * d elements between tokens, so the
// wrapper never transposes. bias is f32 (B, Q, S) with Q = 1 (a 1-D key mask,
// broadcast over the queries) or Q = S (a 2-D mask). T is bf16 or f32; d is 64.
//
// Dropout: the TPU's hardware PRNG has no counterpart here. The keep bit of
// element (b, h, q, k) is a counter-based hash of (seed, b * H + h, q * S + k)
// in 32-bit integer arithmetic,
//     bits = mix32(mix32(mix32(seed) ^ (b * H + h)) ^ (q * S + k)),
//     keep = bits >= threshold, threshold = uint32(rate * 2^32),
// which the plain PyTorch version in ops/kernels/attention_kernel.py computes
// identically, so kernel and plain version agree with dropout on as well.
//
// Bound on an H100 SXM: at this backbone's sequence lengths (S <= 134) the
// work is small. The forward needs 4 * B * H * S^2 * d operations against
// 989 TFLOP/s bf16 and moves 4 * B * S * H * d elements (q, k, v read, ctx
// written) at 3.35 TB/s; at B = 128, S = 84 in bf16 the two bounds are 2.8 us
// and 19.7 us, so by the definition used in PERF.md the forward is
// bytes-bound, and so is the backward (10 * B * H * S^2 * d operations,
// 7 tensors moved).
// The design therefore keeps the (S, S) scores out of device memory: one
// block per (batch row, head) stages that head's K and V (and Q and the
// cotangent in the backward) in shared memory once and never writes the
// probabilities out. The arithmetic is plain f32 FMA on CUDA cores: a simple
// first kernel. Tensor-core mma for QK^T and PV is left for a later revision.
//
// Limits: d == 64, S <= 160 (five key columns per lane), and the backward's
// shared memory (four (S, d) tiles plus the (S, S) f32 matrix) within the
// 227 KB a block may opt into; above 48 KB the launch raises the kernel's
// dynamic shared-memory limit with cudaFuncSetAttribute first.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kHeadDim = 64;
constexpr int kMaxSeq = 160;
constexpr int kPerLane = kMaxSeq / 32;  // key columns each lane owns in a row
constexpr int kMaxSmem = 232448;        // opt-in shared memory of one block on sm_90

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7feb352du;
  x ^= x >> 15;
  x *= 0x846ca68bu;
  x ^= x >> 16;
  return x;
}

template <typename T>
struct Elem;

template <>
struct Elem<__nv_bfloat16> {
  // 66 bf16 = 33 words a row: lanes reading rows lane + 32 i hit distinct banks
  static constexpr int kPitch = kHeadDim + 2;
  __device__ static float load(__nv_bfloat16 v) { return __bfloat162float(v); }
  __device__ static __nv_bfloat16 store(float f) { return __float2bfloat16(f); }
};

template <>
struct Elem<float> {
  static constexpr int kPitch = kHeadDim + 1;
  __device__ static float load(float v) { return v; }
  __device__ static float store(float f) { return f; }
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__host__ __device__ constexpr size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

template <typename T>
__host__ __device__ constexpr size_t tile_bytes(int s) {
  return align16((size_t)s * Elem<T>::kPitch * sizeof(T));
}

template <typename T>
size_t fwd_smem_bytes(int s) {
  return 2 * tile_bytes<T>(s) + (size_t)kWarps * (kHeadDim + s) * sizeof(float);
}

template <typename T>
size_t bwd_smem_bytes(int s) {
  return 4 * tile_bytes<T>(s) + align16((size_t)s * s * sizeof(float)) +
         (size_t)s * kPerLane * sizeof(uint32_t);
}

// Stage the (S, d) slice of head h of batch row b into a padded shared tile.
template <typename T>
__device__ void load_tile(const T* __restrict__ src, T* dst, int b, int h, int s_len, int n_heads) {
  constexpr int P = Elem<T>::kPitch;
  const long tok = (long)n_heads * kHeadDim;
  for (int idx = threadIdx.x; idx < s_len * kHeadDim; idx += kThreads) {
    const int s = idx / kHeadDim, j = idx % kHeadDim;
    dst[s * P + j] = src[((long)b * s_len + s) * tok + (long)h * kHeadDim + j];
  }
}

// Scores of query row `row` against the lane's key columns, softmax over the
// row: p[i] is the probability of column lane + 32 i (0 past S).
template <typename T, typename QRow>
__device__ void softmax_row(QRow qv, const T* ks, const float* brow, int s_len, float inv_sqrt_d,
                            float p[kPerLane]) {
  constexpr int P = Elem<T>::kPitch;
  const int lane = threadIdx.x & 31;
  float mx = -INFINITY;
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const int col = lane + 32 * i;
    float acc = -INFINITY;
    if (col < s_len) {
      const T* kr = ks + col * P;
      acc = 0.f;
#pragma unroll 16
      for (int j = 0; j < kHeadDim; ++j) acc = fmaf(qv(j), Elem<T>::load(kr[j]), acc);
      acc = acc * inv_sqrt_d + brow[col];
    }
    p[i] = acc;
    mx = fmaxf(mx, acc);
  }
  mx = warp_max(mx);
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const float e = (lane + 32 * i < s_len) ? expf(p[i] - mx) : 0.f;
    p[i] = e;
    sum += e;
  }
  sum = warp_sum(sum);
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) p[i] = p[i] / sum;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const float* __restrict__ bias, T* __restrict__ out, int s_len, int n_heads,
                int bias_q, uint32_t seed, uint32_t threshold, float scale, float inv_sqrt_d,
                int dropout) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int P = Elem<T>::kPitch;
  const int bh = blockIdx.x;
  const int b = bh / n_heads, h = bh % n_heads;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = reinterpret_cast<T*>(smem + tile_bytes<T>(s_len));
  float* qrow = reinterpret_cast<float*>(smem + 2 * tile_bytes<T>(s_len)) +
                warp * (kHeadDim + s_len);
  float* prow = qrow + kHeadDim;
  load_tile(k, ks, b, h, s_len, n_heads);
  load_tile(v, vs, b, h, s_len, n_heads);
  __syncthreads();

  const uint32_t key = mix32(mix32(seed) ^ (uint32_t)bh);
  const long tok = (long)n_heads * kHeadDim;
  for (int row = warp; row < s_len; row += kWarps) {
    const long g = ((long)b * s_len + row) * tok + (long)h * kHeadDim;
    qrow[lane] = Elem<T>::load(q[g + lane]);
    qrow[lane + 32] = Elem<T>::load(q[g + lane + 32]);
    __syncwarp();
    const float* brow = bias + ((long)b * bias_q + (bias_q == 1 ? 0 : row)) * s_len;
    float p[kPerLane];
    softmax_row<T>([&](int j) { return qrow[j]; }, ks, brow, s_len, inv_sqrt_d, p);
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      const int col = lane + 32 * i;
      if (col >= s_len) continue;
      float pd = p[i];
      if (dropout) {
        const uint32_t bits = mix32(key ^ (uint32_t)(row * s_len + col));
        pd = bits >= threshold ? pd * scale : 0.f;
      }
      prow[col] = Elem<T>::load(Elem<T>::store(pd));  // probs rounded to v's type
    }
    __syncwarp();
    float a0 = 0.f, a1 = 0.f;
    for (int c = 0; c < s_len; ++c) {
      const float pc = prow[c];
      a0 = fmaf(pc, Elem<T>::load(vs[c * P + lane]), a0);
      a1 = fmaf(pc, Elem<T>::load(vs[c * P + lane + 32]), a1);
    }
    out[g + lane] = Elem<T>::store(a0);
    out[g + lane + 32] = Elem<T>::store(a1);
    __syncwarp();
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
attn_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const float* __restrict__ bias, const T* __restrict__ gy, T* __restrict__ dq,
                T* __restrict__ dk, T* __restrict__ dv, int s_len, int n_heads, int bias_q,
                uint32_t seed, uint32_t threshold, float scale, float inv_sqrt_d, int dropout) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int P = Elem<T>::kPitch;
  const int bh = blockIdx.x;
  const int b = bh / n_heads, h = bh % n_heads;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t tb = tile_bytes<T>(s_len);
  T* qs = reinterpret_cast<T*>(smem);
  T* ks = reinterpret_cast<T*>(smem + tb);
  T* vs = reinterpret_cast<T*>(smem + 2 * tb);
  T* gs = reinterpret_cast<T*>(smem + 3 * tb);
  float* ps = reinterpret_cast<float*>(smem + 4 * tb);  // p, then ds, row-major (S, S)
  uint32_t* keep_bits =
      reinterpret_cast<uint32_t*>(smem + 4 * tb + align16((size_t)s_len * s_len * sizeof(float)));
  load_tile(q, qs, b, h, s_len, n_heads);
  load_tile(k, ks, b, h, s_len, n_heads);
  load_tile(v, vs, b, h, s_len, n_heads);
  load_tile(gy, gs, b, h, s_len, n_heads);
  __syncthreads();

  // 1. undropped probabilities and the keep mask (one bit per element)
  const uint32_t key = mix32(mix32(seed) ^ (uint32_t)bh);
  for (int row = warp; row < s_len; row += kWarps) {
    const float* brow = bias + ((long)b * bias_q + (bias_q == 1 ? 0 : row)) * s_len;
    const T* qr = qs + row * P;
    float p[kPerLane];
    softmax_row<T>([&](int j) { return Elem<T>::load(qr[j]); }, ks, brow, s_len, inv_sqrt_d, p);
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      const int col = lane + 32 * i;
      if (col < s_len) ps[row * s_len + col] = p[i];
      if (dropout) {
        const bool kept =
            col < s_len && mix32(key ^ (uint32_t)(row * s_len + col)) >= threshold;
        const uint32_t word = __ballot_sync(0xffffffffu, kept);
        if (lane == 0) keep_bits[row * kPerLane + i] = word;
      }
    }
  }
  __syncthreads();

  const long tok = (long)n_heads * kHeadDim;
  auto kept = [&](int row, int col) {
    return (keep_bits[row * kPerLane + (col >> 5)] >> (col & 31)) & 1u;
  };
  // 2. dv[c, j] = sum_r pd[r, c] g[r, j]
  for (int idx = threadIdx.x; idx < s_len * kHeadDim; idx += kThreads) {
    const int c = idx / kHeadDim, j = idx % kHeadDim;
    float acc = 0.f;
    for (int r = 0; r < s_len; ++r) {
      float pd = ps[r * s_len + c];
      if (dropout) pd = kept(r, c) ? pd * scale : 0.f;
      acc = fmaf(pd, Elem<T>::load(gs[r * P + j]), acc);
    }
    dv[((long)b * s_len + c) * tok + (long)h * kHeadDim + j] = Elem<T>::store(acc);
  }
  __syncthreads();

  // 3. ds over each row (in place of p), then dq[r, j] = sum_c ds[r, c] k[c, j]
  for (int row = warp; row < s_len; row += kWarps) {
    const T* gr = gs + row * P;
    float dp[kPerLane];
    float rsum = 0.f;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      const int col = lane + 32 * i;
      dp[i] = 0.f;
      if (col >= s_len) continue;
      const T* vr = vs + col * P;
      float acc = 0.f;
#pragma unroll 16
      for (int j = 0; j < kHeadDim; ++j) acc = fmaf(Elem<T>::load(gr[j]), Elem<T>::load(vr[j]), acc);
      if (dropout) acc = kept(row, col) ? acc * scale : 0.f;
      dp[i] = acc;
      rsum += acc * ps[row * s_len + col];
    }
    rsum = warp_sum(rsum);
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      const int col = lane + 32 * i;
      if (col < s_len) {
        const float pv = ps[row * s_len + col];
        ps[row * s_len + col] = pv * (dp[i] - rsum) * inv_sqrt_d;
      }
    }
    __syncwarp();
    float a0 = 0.f, a1 = 0.f;
    for (int c = 0; c < s_len; ++c) {
      const float ds = ps[row * s_len + c];
      a0 = fmaf(ds, Elem<T>::load(ks[c * P + lane]), a0);
      a1 = fmaf(ds, Elem<T>::load(ks[c * P + lane + 32]), a1);
    }
    const long g = ((long)b * s_len + row) * tok + (long)h * kHeadDim;
    dq[g + lane] = Elem<T>::store(a0);
    dq[g + lane + 32] = Elem<T>::store(a1);
    __syncwarp();
  }
  __syncthreads();

  // 4. dk[c, j] = sum_r ds[r, c] q[r, j]
  for (int idx = threadIdx.x; idx < s_len * kHeadDim; idx += kThreads) {
    const int c = idx / kHeadDim, j = idx % kHeadDim;
    float acc = 0.f;
    for (int r = 0; r < s_len; ++r) acc = fmaf(ps[r * s_len + c], Elem<T>::load(qs[r * P + j]), acc);
    dk[((long)b * s_len + c) * tok + (long)h * kHeadDim + j] = Elem<T>::store(acc);
  }
}

bool shape_ok(int b, int s, int h, int d, int bias_q) {
  return b > 0 && h > 0 && s > 0 && s <= kMaxSeq && d == kHeadDim && (bias_q == 1 || bias_q == s) &&
         (long)b * h <= 0x7fffffffL && (long)s * s < 0x7fffffffL;
}

template <typename T>
int launch_fwd(const void* q, const void* k, const void* v, const float* bias, void* out, int b,
               int s, int h, int bias_q, uint32_t seed, uint32_t threshold, float scale,
               float inv_sqrt_d, int dropout, cudaStream_t stream) {
  const size_t smem = fwd_smem_bytes<T>(s);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(attn_fwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  attn_fwd_kernel<T><<<(unsigned)(b * h), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), bias,
      static_cast<T*>(out), s, h, bias_q, seed, threshold, scale, inv_sqrt_d, dropout);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* q, const void* k, const void* v, const float* bias, const void* g,
               void* dq, void* dk, void* dv, int b, int s, int h, int bias_q, uint32_t seed,
               uint32_t threshold, float scale, float inv_sqrt_d, int dropout,
               cudaStream_t stream) {
  const size_t smem = bwd_smem_bytes<T>(s);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(attn_bwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  attn_bwd_kernel<T><<<(unsigned)(b * h), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), bias,
      static_cast<const T*>(g), static_cast<T*>(dq), static_cast<T*>(dk), static_cast<T*>(dv), s,
      h, bias_q, seed, threshold, scale, inv_sqrt_d, dropout);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = bf16, 1 = f32 (q, k, v, out alike). q, k, v, out: (B, S, H, d)
// row-major; bias: f32 (B, bias_q, S). dropout != 0 applies the keep mask of
// (seed, threshold) and scales kept probabilities by `scale`. Returns a
// cudaError_t code.
int attn_fwd_launch(int dtype, const void* q, const void* k, const void* v, const float* bias,
                    void* out, int b, int s, int h, int d, int bias_q, unsigned seed,
                    unsigned threshold, float scale, float inv_sqrt_d, int dropout, void* stream) {
  if (!shape_ok(b, s, h, d, bias_q)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_fwd<__nv_bfloat16>(q, k, v, bias, out, b, s, h, bias_q, seed, threshold, scale,
                                     inv_sqrt_d, dropout, st);
  if (dtype == 1)
    return launch_fwd<float>(q, k, v, bias, out, b, s, h, bias_q, seed, threshold, scale,
                             inv_sqrt_d, dropout, st);
  return (int)cudaErrorInvalidValue;
}

// The same arguments plus g (the cotangent of out) and the three outputs
// dq, dk, dv, all (B, S, H, d) in the input type.
int attn_bwd_launch(int dtype, const void* q, const void* k, const void* v, const float* bias,
                    const void* g, void* dq, void* dk, void* dv, int b, int s, int h, int d,
                    int bias_q, unsigned seed, unsigned threshold, float scale, float inv_sqrt_d,
                    int dropout, void* stream) {
  if (!shape_ok(b, s, h, d, bias_q)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_bwd<__nv_bfloat16>(q, k, v, bias, g, dq, dk, dv, b, s, h, bias_q, seed,
                                     threshold, scale, inv_sqrt_d, dropout, st);
  if (dtype == 1)
    return launch_bwd<float>(q, k, v, bias, g, dq, dk, dv, b, s, h, bias_q, seed, threshold,
                             scale, inv_sqrt_d, dropout, st);
  return (int)cudaErrorInvalidValue;
}

// Shared memory (bytes) the forward / backward kernel needs at sequence
// length s: the wrapper refuses shapes above the opt-in limit.
unsigned long attn_smem_bytes(int dtype, int backward, int s) {
  if (dtype == 0) return backward ? bwd_smem_bytes<__nv_bfloat16>(s) : fwd_smem_bytes<__nv_bfloat16>(s);
  return backward ? bwd_smem_bytes<float>(s) : fwd_smem_bytes<float>(s);
}

const char* attn_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
