// Kimi Delta Attention's recurrence for Hopper (sm_90a): the prefill over
// documents packed end to end (K5, kda_prefill_k5) and the decode step (K6,
// kda_step_k6). Wrapped by aladin_torch/ops/kernels/kda.py, whose plain
// versions define the function; no TPU kernel is replaced (the JAX package
// has no linear attention).
//
// Both take a KDA layer's raw projections in bf16, before the short
// convolutions: q, k, v, f (N, H x 128), b (N, H). Per head n, channel c and
// token t (conv causal and depthwise, width 4, w[c, 3] on the token itself):
//
//     q_t = silu(conv_q)_t / sqrt(|silu(conv_q)_t|^2 + eps) / sqrt(128)
//     k_t = silu(conv_k)_t / sqrt(|silu(conv_k)_t|^2 + eps)
//     v_t = silu(conv_v)_t
//     alpha_t[c] = exp(-exp(A_log[n]) softplus(f_t[c] + dt_bias[c]))
//     beta_t = sigmoid(b_t[n])
//     S <- Diag(alpha_t) S;  S <- S + beta_t k_t (v_t - S^T k_t)^T;  o_t = S^T q_t
//
// with S (128 x 128) float32, zero at a document's first token, and the
// convolutions starting from zeros there. A state buffer holds S transposed
// (B, H, d_v, d_k), so a row of it is one value column's 128 key channels.
//
// Bound on an H100 SXM: per token and head, 4 x 128 bf16 values in and 128
// out against 4 x 128 x 128 multiply-adds, so bytes over 3.35 TB/s bound
// both kernels (h100_bench/lib/kda_bounds.py). K5 cannot reach that bound
// in this form: a document is a chain of dependent token steps, each a
// matrix-vector update of the state on the CUDA cores (the chunked
// tensor-core form is the next step). The design keeps that chain short
// and the state on chip:
//   * one warp owns a block of 16 value columns of one head's state, held
//     in registers along the whole document: lane l keeps key channels
//     4l .. 4l + 3 of each of the 16 columns (64 floats), so q, k and f
//     arrive as one 8-byte load a lane, coalesced;
//   * a token needs two products of the decayed state, S'k and S'q, each a
//     16-vector summed over the 128 key channels. Both come from one
//     reduce-scatter of the lanes' 32 partial sums (halving exchanges by
//     xor shuffle, 31 shuffles): lane m < 16 ends with (S'k)[m], lane 16 + m
//     with (S'q)[m]. The partial sums use the unnormalised silu(conv)
//     vectors, so the norms' reductions (one more butterfly) run beside
//     them, not before. With u = beta (v - S'k) the new state's output is
//     o = S'q + u (k.q), so the update S = S' + u k^T and o need no second
//     reduction; u goes to every lane through 64 bytes of shared memory;
//   * the convolutions, norms, decay and beta are computed in registers
//     from the raw projections, each token's inputs loaded one token ahead;
//   * K5: one block of 4 warps (64 value columns) a (document, head, half);
//     the grid walks documents longest first, so the longest chain starts
//     at once. A block stages its head's q / k convolution taps in shared
//     memory. At a document's end each warp writes its block of the final
//     state into the decode cache's row of that document and the raw
//     projections of the last 3 tokens (the convolutions' tails; the first
//     warp of a head writes q's and k's);
//   * K6: one block of 8 warps a (row, head), the same token step on the
//     state loaded from and stored back to the cache in place (16-byte
//     accesses, all of a lane's loads in flight at once), and the tails
//     shifted in place, so a CUDA graph replays it with no host read.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kDim = 128;                 // d_k = d_v
constexpr int kCols = 16;                 // value columns a warp
constexpr int kPrefillWarps = 4;          // K5: warps (value blocks) a block
constexpr int kStepWarps = kDim / kCols;  // K6: the whole head a block
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const __nv_bfloat16* q;  // (N, D) raw projections
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const __nv_bfloat16* f;
  const __nv_bfloat16* b;     // (N, H)
  const __nv_bfloat16* conv;  // (3, D, 4): q, k, v taps
  const float* a_log;         // (H)
  const float* dt_bias;       // (D)
  __nv_bfloat16* o;           // (N, D)
  float* state;               // (B, H, 128, 128), S transposed
  __nv_bfloat16* tails;       // (B, 3, 3D): raw q | k | v of the last 3 tokens
  const int* cu;              // K5: (docs + 1) token offsets
  const int64_t* rows;        // K5: (docs) cache row of each document
  const int64_t* order;       // K5: (docs) documents longest first
  int d, h;
  float eps, scale;
};

__device__ __forceinline__ float silu(float x) { return x / (1.0f + __expf(-x)); }

__device__ __forceinline__ uint2 raw4(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint2*>(p);
}

__device__ __forceinline__ void unpack4(uint2 raw, float (&x)[4]) {
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  x[0] = lo.x;
  x[1] = lo.y;
  x[2] = hi.x;
  x[3] = hi.y;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&x)[4]) {
  unpack4(raw4(p), x);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&x)[4]) {
  uint2 raw;
  *reinterpret_cast<__nv_bfloat162*>(&raw.x) = __floats2bfloat162_rn(x[0], x[1]);
  *reinterpret_cast<__nv_bfloat162*>(&raw.y) = __floats2bfloat162_rn(x[2], x[3]);
  *reinterpret_cast<uint2*>(p) = raw;
}

__device__ __forceinline__ float4 taps(const __nv_bfloat16* conv, int channel) {
  float w[4];
  load4(conv + 4 * channel, w);
  return make_float4(w[0], w[1], w[2], w[3]);
}

// One lane's share of a warp's value block: the state, the convolution
// windows (raw inputs of the 3 tokens before this one, oldest first) and
// the per-channel constants.
struct Lane {
  float st[kCols][4];  // st[m][j] = S[4 lane + j, column m]
  float wq[3][4], wk[3][4], wv[3];
  float dtb[4];
  float4 cv;  // this lane's value column's taps (column lane mod 16)
  float a;    // -exp(A_log[n])
};

// One token through the convolutions, norms, decay and the state update
// (file comment). pq, pk, pf: the raw bf16 inputs of the lane's 4 key
// channels; rv: of its value column; cq / ck: the taps of its 4 key
// channels. Shifts the windows. Returns o of value column lane - 16 on
// lanes 16..31.
__device__ __forceinline__ float token(Lane& s, uint2 pq, uint2 pk, uint2 pf, float rv, float rb,
                                       const float4* cq, const float4* ck, float* ubuf, int lane,
                                       float eps, float scale) {
  float rq[4], rk[4], rf[4], qs[4], ks[4], aq[4], ak[4], al[4];
  unpack4(pq, rq);
  unpack4(pk, rk);
  unpack4(pf, rf);
  float nq = 0.0f, nk = 0.0f, qk = 0.0f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float4 wq = cq[j], wk = ck[j];
    qs[j] = silu(wq.x * s.wq[0][j] + wq.y * s.wq[1][j] + wq.z * s.wq[2][j] + wq.w * rq[j]);
    ks[j] = silu(wk.x * s.wk[0][j] + wk.y * s.wk[1][j] + wk.z * s.wk[2][j] + wk.w * rk[j]);
    nq += qs[j] * qs[j];
    nk += ks[j] * ks[j];
    qk += qs[j] * ks[j];
    const float x = rf[j] + s.dtb[j];
    const float sp = x > 20.0f ? x : log1pf(__expf(x));
    al[j] = __expf(s.a * sp);
    aq[j] = al[j] * qs[j];
    ak[j] = al[j] * ks[j];
    s.wq[0][j] = s.wq[1][j];
    s.wq[1][j] = s.wq[2][j];
    s.wq[2][j] = rq[j];
    s.wk[0][j] = s.wk[1][j];
    s.wk[1][j] = s.wk[2][j];
    s.wk[2][j] = rk[j];
  }
  const float vs = silu(s.cv.x * s.wv[0] + s.cv.y * s.wv[1] + s.cv.z * s.wv[2] + s.cv.w * rv);
  s.wv[0] = s.wv[1];
  s.wv[1] = s.wv[2];
  s.wv[2] = rv;
  const float beta = 1.0f / (1.0f + __expf(-rb));
  // the lanes' partial sums of S'k (values 0..15) and S'q (16..31), reduced
  // and scattered: after the exchange over xor w a lane keeps the half of
  // its values whose index has the lane's bit w, so lane l ends with value l
  float r[16];
  const bool upper = lane & 16;
#pragma unroll
  for (int m = 0; m < kCols; ++m) {
    float pk = 0.0f, pq = 0.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      pk = fmaf(s.st[m][j], ak[j], pk);
      pq = fmaf(s.st[m][j], aq[j], pq);
    }
    r[m] = (upper ? pq : pk) + __shfl_xor_sync(kFull, upper ? pk : pq, 16);
  }
#pragma unroll
  for (int w = 8; w >= 1; w >>= 1) {
    const bool up = lane & w;
#pragma unroll
    for (int i = 0; i < w; ++i)
      r[i] = (up ? r[i + w] : r[i]) + __shfl_xor_sync(kFull, up ? r[i] : r[i + w], w);
  }
#pragma unroll
  for (int w = 16; w >= 1; w >>= 1) {
    nq += __shfl_xor_sync(kFull, nq, w);
    nk += __shfl_xor_sync(kFull, nk, w);
    qk += __shfl_xor_sync(kFull, qk, w);
  }
  const float rnk = rsqrtf(nk + eps), rnq = rsqrtf(nq + eps);
  const float u = beta * (vs - rnk * r[0]);  // u[lane] on lanes 0..15
  if (lane < kCols) ubuf[lane] = u;
  __syncwarp();
  float kh[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) kh[j] = ks[j] * rnk;
#pragma unroll
  for (int i = 0; i < kCols / 4; ++i) {
    const float4 x = reinterpret_cast<const float4*>(ubuf)[i];
    const float us[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        s.st[4 * i + m][j] = fmaf(us[m], kh[j], s.st[4 * i + m][j] * al[j]);
  }
  return rnq * scale * (r[0] + ubuf[lane & (kCols - 1)] * rnk * qk);
}

__device__ __forceinline__ void load_constants(Lane& s, const Args& a, int n, int col) {
  const int ck = n * kDim + 4 * (threadIdx.x & 31);
#pragma unroll
  for (int j = 0; j < 4; ++j) s.dtb[j] = a.dt_bias[ck + j];
  s.cv = taps(a.conv, 2 * a.d + col);
  s.a = -expf(a.a_log[n]);
}

// K5: grid (H x 2, docs), block 4 warps; blockIdx.y walks the documents in
// `order` (longest first), blockIdx.x the (head, half of the value columns).
__global__ void __launch_bounds__(32 * kPrefillWarps, 3) kda_prefill_k5(Args a) {
  __shared__ float4 sconv[2][kDim];  // the head's q and k taps
  __shared__ __align__(16) float ubuf[kPrefillWarps][2][kCols];
  constexpr int kHalves = kDim / (kCols * kPrefillWarps);
  const int n = blockIdx.x / kHalves;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int vb = (blockIdx.x % kHalves) * kPrefillWarps + warp;  // value block of the head
  const int64_t doc = a.order[blockIdx.y];
  const int start = a.cu[doc], end = a.cu[doc + 1];
  const int64_t row = a.rows[doc];
  for (int i = threadIdx.x; i < 2 * kDim; i += blockDim.x)
    sconv[i / kDim][i % kDim] = taps(a.conv, (i / kDim) * a.d + n * kDim + i % kDim);
  Lane s;
  const int col = n * kDim + vb * kCols + (lane & (kCols - 1));  // this lane's value column
  const int ck = n * kDim + 4 * lane;                             // its first key channel
  load_constants(s, a, n, col);
#pragma unroll
  for (int m = 0; m < kCols; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) s.st[m][j] = 0.0f;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    s.wv[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j) s.wq[i][j] = s.wk[i][j] = 0.0f;
  }
  __syncthreads();
  const float4* cq = &sconv[0][4 * lane];  // read from shared memory at each token
  const float4* ckt = &sconv[1][4 * lane];
  uint2 rq = {0, 0}, rk = {0, 0}, rf = {0, 0};
  float rv = 0.0f, rb = 0.0f;
  if (start < end) {
    const int64_t base = static_cast<int64_t>(start) * a.d;
    rq = raw4(a.q + base + ck);
    rk = raw4(a.k + base + ck);
    rf = raw4(a.f + base + ck);
    rv = __bfloat162float(a.v[base + col]);
    rb = __bfloat162float(a.b[static_cast<int64_t>(start) * a.h + n]);
  }
  for (int t = start; t < end; ++t) {
    uint2 nq = {0, 0}, nk = {0, 0}, nf = {0, 0};
    float nv = 0.0f, nb = 0.0f;
    if (t + 1 < end) {  // the next token's inputs, in flight during this one
      const int64_t base = static_cast<int64_t>(t + 1) * a.d;
      nq = raw4(a.q + base + ck);
      nk = raw4(a.k + base + ck);
      nf = raw4(a.f + base + ck);
      nv = __bfloat162float(a.v[base + col]);
      nb = __bfloat162float(a.b[static_cast<int64_t>(t + 1) * a.h + n]);
    }
    const float o = token(s, rq, rk, rf, rv, rb, cq, ckt, ubuf[warp][t & 1], lane, a.eps,
                          a.scale);
    if (lane >= kCols) a.o[static_cast<int64_t>(t) * a.d + col] = __float2bfloat16_rn(o);
    rq = nq;
    rk = nk;
    rf = nf;
    rv = nv;
    rb = nb;
  }
  float* st = a.state + ((row * a.h + n) * kDim + vb * kCols) * kDim + 4 * lane;
#pragma unroll
  for (int m = 0; m < kCols; ++m)
    *reinterpret_cast<float4*>(st + m * kDim) =
        make_float4(s.st[m][0], s.st[m][1], s.st[m][2], s.st[m][3]);
  __nv_bfloat16* tail = a.tails + row * 9 * a.d;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    if (vb == 0) {
      store4(tail + i * 3 * a.d + ck, s.wq[i]);
      store4(tail + i * 3 * a.d + a.d + ck, s.wk[i]);
    }
    if (lane < kCols) tail[i * 3 * a.d + 2 * a.d + col] = __float2bfloat16_rn(s.wv[i]);
  }
}

// K6: grid (B, H), block 8 warps (the head's 128 value columns); one token
// a row, the state and the tails updated in place.
__global__ void __launch_bounds__(32 * kStepWarps) kda_step_k6(Args a) {
  __shared__ __align__(16) float ubuf[kStepWarps][kCols];
  const int64_t r = blockIdx.x;
  const int n = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int col = n * kDim + warp * kCols + (lane & (kCols - 1));
  const int ck = n * kDim + 4 * lane;
  float* st = a.state + ((r * a.h + n) * kDim + warp * kCols) * kDim + 4 * lane;
  Lane s;
#pragma unroll
  for (int m = 0; m < kCols; ++m) {
    const float4 x = *reinterpret_cast<const float4*>(st + m * kDim);
    s.st[m][0] = x.x;
    s.st[m][1] = x.y;
    s.st[m][2] = x.z;
    s.st[m][3] = x.w;
  }
  __nv_bfloat16* tail = a.tails + r * 9 * a.d;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    load4(tail + i * 3 * a.d + ck, s.wq[i]);
    load4(tail + i * 3 * a.d + a.d + ck, s.wk[i]);
    s.wv[i] = __bfloat162float(tail[i * 3 * a.d + 2 * a.d + col]);
  }
  const uint2 rq = raw4(a.q + r * a.d + ck), rk = raw4(a.k + r * a.d + ck);
  const uint2 rf = raw4(a.f + r * a.d + ck);
  const float rv = __bfloat162float(a.v[r * a.d + col]);
  const float rb = __bfloat162float(a.b[r * a.h + n]);
  load_constants(s, a, n, col);
  float4 cq[4], ckt[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    cq[j] = taps(a.conv, ck + j);
    ckt[j] = taps(a.conv, a.d + ck + j);
  }
  const float o = token(s, rq, rk, rf, rv, rb, cq, ckt, ubuf[warp], lane, a.eps, a.scale);
  if (lane >= kCols) a.o[r * a.d + col] = __float2bfloat16_rn(o);
#pragma unroll
  for (int m = 0; m < kCols; ++m)
    *reinterpret_cast<float4*>(st + m * kDim) =
        make_float4(s.st[m][0], s.st[m][1], s.st[m][2], s.st[m][3]);
  __syncthreads();  // every warp has read the tails it shares with warp 0
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    if (warp == 0) {
      store4(tail + i * 3 * a.d + ck, s.wq[i]);
      store4(tail + i * 3 * a.d + a.d + ck, s.wk[i]);
    }
    if (lane < kCols) tail[i * 3 * a.d + 2 * a.d + col] = __float2bfloat16_rn(s.wv[i]);
  }
}

Args make_args(const void* q, const void* k, const void* v, const void* f, const void* b,
               const void* conv, const float* a_log, const float* dt_bias, void* o, float* state,
               void* tails, int heads, float eps) {
  Args a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.f = static_cast<const __nv_bfloat16*>(f);
  a.b = static_cast<const __nv_bfloat16*>(b);
  a.conv = static_cast<const __nv_bfloat16*>(conv);
  a.a_log = a_log;
  a.dt_bias = dt_bias;
  a.o = static_cast<__nv_bfloat16*>(o);
  a.state = state;
  a.tails = static_cast<__nv_bfloat16*>(tails);
  a.cu = nullptr;
  a.rows = nullptr;
  a.order = nullptr;
  a.h = heads;
  a.d = heads * kDim;
  a.eps = eps;
  a.scale = 1.0f / std::sqrt(static_cast<float>(kDim));
  return a;
}

}  // namespace

extern "C" {

// K5 over `docs` documents packed end to end; every tensor as in Args, the
// head width 128. Returns a cudaError_t code.
int kda_prefill_launch(const void* q, const void* k, const void* v, const void* f, const void* b,
                       const void* conv, const float* a_log, const float* dt_bias, const int* cu,
                       const int64_t* rows, const int64_t* order, void* o, float* state,
                       void* tails, int docs, int heads, float eps, void* stream) {
  if (docs < 0 || heads < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (docs == 0) return 0;
  Args a = make_args(q, k, v, f, b, conv, a_log, dt_bias, o, state, tails, heads, eps);
  a.cu = cu;
  a.rows = rows;
  a.order = order;
  const dim3 grid(heads * (kDim / (kCols * kPrefillWarps)), docs);
  kda_prefill_k5<<<grid, 32 * kPrefillWarps, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// K6 over `batch` rows, one token each. Returns a cudaError_t code.
int kda_step_launch(const void* q, const void* k, const void* v, const void* f, const void* b,
                    const void* conv, const float* a_log, const float* dt_bias, void* o,
                    float* state, void* tails, int batch, int heads, float eps, void* stream) {
  if (batch < 0 || heads < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return 0;
  const Args a = make_args(q, k, v, f, b, conv, a_log, dt_bias, o, state, tails, heads, eps);
  kda_step_k6<<<dim3(batch, heads), 32 * kStepWarps, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

const char* kda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
