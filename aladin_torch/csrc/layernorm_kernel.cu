// Residual LayerNorm kernels for Hopper (sm_90a): the backward of the fused
// residual LayerNorm (K3a's VJP) and K3b, the forward that also writes the
// per-row int8 of its output. K3a's forward stays a Triton kernel
// (ops/kernels/layernorm.py).
//
// Replaces, in aladin_tpu/ops/pallas/layernorm.py:
//   * _rln_bwd, the VJP of residual_layernorm (XLA there), for rows of
//     h = f32(x) + f32(res) with the forward's mean and rstd:
//         xhat = (h - mean) * rstd,  g = f32(gy),  gg = g * gamma
//         dh = rstd * (gg - mean_row(gg) - xhat * mean_row(gg * xhat))
//         dx = dh in x's dtype, dres = dh in res's dtype
//         dgamma = sum_rows g * xhat, dbeta = sum_rows g       (f32)
//   * _fwd_kernel_q8 via residual_layernorm_q8:
//         mean = E[h], var = max(E[h^2] - mean^2, 0), rstd = rsqrt(var + eps)
//         y = (h - mean) * rstd * gamma + beta               (stored in x's dtype)
//         s = max(absmax(f32 y), 1e-8) / 127,  q = clip(rint(f32 y / s), -127, 127)
//     with both divisions IEEE, as quantize_rowwise computes them.
//
// Bound on an H100 SXM: ~10 f32 operations an element and no tensor-core
// work, so both are bound by bytes over 3.35 TB/s: the backward reads g, x
// and res once and writes dh once (one tensor when x and res share a dtype:
// dx and dres are the same values, and the wrapper returns it as both); K3b
// reads x and res once and writes y and q once. The design keeps every
// intermediate out of device memory:
//   * one warp a row. A lane holds the 8-value chunks (lane + 32 j) * 8 of
//     the row, j < NC = ceil(D / 256), in registers: 16-byte loads and
//     stores (three chunks a lane at D 768), the row's sums by warp shuffle,
//     no block barrier in the row pass. The loads fetch raw bits and convert
//     only when all of a row's loads are in flight, so one kernel serves
//     bf16, f16 and f32 in any mix (a uniform branch on the type code; the
//     backward has a narrower instantiation for when no input is f32);
//   * K3b: mean and E[h^2] in one shuffle reduction, y normalised in
//     registers and stored, the absmax of the f32 y a second one, the scale
//     one IEEE divide a row, q from the f32 y by the correctly rounded
//     quotient of rowquant.cuh, packed 8 to a 64-bit store (an IEEE divide
//     a value instead costs 1.3 us more at M 2688, tools/ln_variants.py).
//     One warp a row over 4-warp blocks: 672 blocks at M 2688, one wave;
//   * backward: a persistent grid, each warp striding over rows, each lane
//     keeping its columns' dgamma / dbeta sums in registers across the rows
//     its warp visits, and loading its next row while it reduces and stores
//     the current one. At the end the warps of a block fold the sums
//     through shared memory in a fixed tree and the block writes one
//     partial row; a second kernel, launched as a programmatic dependent so
//     that its launch overlaps the first's tail, sums the partial rows in
//     index order. No atomics: two calls on the same inputs give bitwise
//     equal dgamma / dbeta;
//   * the registers bound the rows in flight: 195 a thread at D 768 in
//     bf16, one block of 8 warps an SM (tools/ln_variants.py: capping them
//     at 128 for two blocks spills and runs 1.5x slower; the prefetch of
//     the next row saves ~8%, the bf16 / f16 chunk layout ~7%, the
//     chaining ~1 us at M 10752);
//   * D above 256 * kMaxChunks does not fit the registers: a warp then
//     walks its row twice (the second pass re-reads it, from L2), and the
//     backward's dgamma / dbeta come from a column kernel over blocks of
//     rows. Any D up to the wrapper's limit, including D not a multiple of 8
//     (chunks at a row's end, and rows not 16-byte aligned, move value by
//     value).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "rowquant.cuh"

namespace {

enum DType { kBF16 = 0, kF16 = 1, kF32 = 2 };

constexpr int kMaxChunks = 4;   // register path: D <= 1024
constexpr int kQ8Warps = 4;     // rows a K3b block
constexpr int kBwdWarps = 8;    // warps a backward block
constexpr bool kPrefetchRow = true;  // backward: load the next row while storing this one
constexpr int kBwdBlocksPerSM = 1;   // backward: the register bound's blocks an SM (note above)
constexpr int kColRows = 64;    // rows a partial of the column kernel (long rows)
constexpr int kSumGroups = 32;  // partial rows summed in index order by this many threads
constexpr float kScaleFloor = static_cast<float>(1e-8);
constexpr unsigned kFull = 0xffffffffu;

// a row-major (m, d) tensor of bf16, f16 or f32; vec: every row starts
// 16-byte aligned, so whole chunks move as 16-byte vectors
struct In {
  const void* p;
  int dt;
  bool vec;
};
struct Out {
  void* p;
  int dt;
  bool vec;
};

// 8 values as raw bits: a 2-byte type in w[0], f32 in w[0] and w[1];
// without kWide the tensor is bf16 or f16 and w[1] does not exist, which
// saves the registers of the unused half
template <bool kWide = true>
struct Chunk {
  uint4 w[kWide ? 2 : 1];
};

__host__ __device__ __forceinline__ bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

__device__ __forceinline__ uint4 ldg16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// values [off, off + n) of t, 0 <= n <= 8 (zeros past n): raw bits only,
// so a row's loads are all issued before the first conversion waits
template <bool kWide = true>
__device__ __forceinline__ Chunk<kWide> load_chunk(In t, long off, int n) {
  Chunk<kWide> c;
  c.w[0] = make_uint4(0u, 0u, 0u, 0u);
  if constexpr (kWide) {
    c.w[1] = c.w[0];
    if (t.dt == kF32) {
      const float* p = static_cast<const float*>(t.p) + off;
      if (t.vec && n == 8) {
        c.w[0] = ldg16(p);
        c.w[1] = ldg16(p + 4);
      } else {
        uint32_t v[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) v[i] = i < n ? __float_as_uint(__ldg(p + i)) : 0u;
        c.w[0] = make_uint4(v[0], v[1], v[2], v[3]);
        c.w[1] = make_uint4(v[4], v[5], v[6], v[7]);
      }
      return c;
    }
  }
  const unsigned short* p = static_cast<const unsigned short*>(t.p) + off;
  if (t.vec && n == 8) {
    c.w[0] = ldg16(p);
  } else {
    uint32_t v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t lo = 2 * i < n ? __ldg(p + 2 * i) : 0u;
      const uint32_t hi = 2 * i + 1 < n ? __ldg(p + 2 * i + 1) : 0u;
      v[i] = lo | hi << 16;
    }
    c.w[0] = make_uint4(v[0], v[1], v[2], v[3]);
  }
  return c;
}

template <bool kWide>
__device__ __forceinline__ void unpack(const Chunk<kWide>& c, int dt, float (&f)[8]) {
  if constexpr (kWide) {
    if (dt == kF32) {
      const uint32_t v[8] = {c.w[0].x, c.w[0].y, c.w[0].z, c.w[0].w,
                             c.w[1].x, c.w[1].y, c.w[1].z, c.w[1].w};
#pragma unroll
      for (int i = 0; i < 8; ++i) f[i] = __uint_as_float(v[i]);
      return;
    }
  }
  const uint32_t v[4] = {c.w[0].x, c.w[0].y, c.w[0].z, c.w[0].w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (dt == kBF16) {
      f[2 * i] = __uint_as_float(v[i] << 16);
      f[2 * i + 1] = __uint_as_float(v[i] & 0xffff0000u);
    } else {
      f[2 * i] = __half2float(__ushort_as_half(static_cast<unsigned short>(v[i] & 0xffffu)));
      f[2 * i + 1] = __half2float(__ushort_as_half(static_cast<unsigned short>(v[i] >> 16)));
    }
  }
}

// values [off, off + n) of t from f, rounded to nearest even into t's type
__device__ __forceinline__ void store_chunk(Out t, long off, int n, const float (&f)[8]) {
  if (n <= 0) return;
  if (t.dt == kF32) {
    float* p = static_cast<float*>(t.p) + off;
    if (t.vec && n == 8) {
      Vec<float>::store(p, f);
      Vec<float>::store(p + 4, f + 4);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (i < n) p[i] = f[i];
    }
  } else if (t.dt == kBF16) {
    __nv_bfloat16* p = static_cast<__nv_bfloat16*>(t.p) + off;
    if (t.vec && n == 8) {
      Vec<__nv_bfloat16>::store(p, f);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (i < n) p[i] = __float2bfloat16_rn(f[i]);
    }
  } else {
    __half* p = static_cast<__half*>(t.p) + off;
    if (t.vec && n == 8) {
      Vec<__half>::store(p, f);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (i < n) p[i] = __float2half_rn(f[i]);
    }
  }
}

__device__ __forceinline__ float load_one(In t, long i) {
  if (t.dt == kF32) return __ldg(static_cast<const float*>(t.p) + i);
  const unsigned short b = __ldg(static_cast<const unsigned short*>(t.p) + i);
  return t.dt == kBF16 ? __uint_as_float(static_cast<uint32_t>(b) << 16)
                       : __half2float(__ushort_as_half(b));
}

// the values of a row at chunk slot j of this lane: first column, count
__device__ __forceinline__ int chunk_col(int lane, int j) { return (lane + 32 * j) * 8; }
__device__ __forceinline__ int chunk_len(int col, int d) {
  return col >= d ? 0 : (d - col < 8 ? d - col : 8);
}

// xor butterflies: every lane ends with the same bits (each step adds the
// same two values on both lanes of a pair)
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2) v += __shfl_xor_sync(kFull, v, off);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2) v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

// ---- K3b: LayerNorm(x + res) and the int8 of its f32 rows ------------------------

struct Q8Args {
  In x, res;
  const float* gamma;  // (d) f32
  const float* beta;
  bool vec_gb;  // gamma and beta 16-byte aligned
  Out y;        // x's dtype
  signed char* q;
  bool vec_q;   // rows of q 8-byte aligned
  float* s;
  int m, d;
  float eps;
};

// y = (h - mean) * rstd * gamma + beta with each step rounded as the plain
// version's torch ops round it (no contraction)
__device__ __forceinline__ void normalise(float (&h)[8], const Q8Args& a, int col, int n,
                                          float mean, float rstd) {
  float g[8], b[8];
  unpack(load_chunk(In{a.gamma, kF32, a.vec_gb}, col, n), kF32, g);
  unpack(load_chunk(In{a.beta, kF32, a.vec_gb}, col, n), kF32, b);
#pragma unroll
  for (int i = 0; i < 8; ++i)
    h[i] = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(h[i], mean), rstd), g[i]), b[i]);
}

// the (mean, rstd) of a row from its sum and sum of squares
__device__ __forceinline__ float2 row_stats(float sum, float sq, int d, float eps) {
  const float mean = __fdiv_rn(sum, static_cast<float>(d));
  const float var =
      fmaxf(__fsub_rn(__fdiv_rn(sq, static_cast<float>(d)), __fmul_rn(mean, mean)), 0.f);
  return make_float2(mean, rsqrtf(var + eps));
}

// q of the f32 y (zeros past n give 0) into q[off, off + n)
__device__ __forceinline__ void store_q(const Q8Args& a, long off, int n, const float (&y)[8],
                                        float scale, float inv) {
  if (n <= 0) return;
  uint32_t word[2];
#pragma unroll
  for (int w = 0; w < 2; ++w) {
    word[w] = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float qv = fminf(fmaxf(rintf(quotient(y[4 * w + i], scale, inv)), -127.f), 127.f);
      word[w] |= static_cast<uint32_t>(static_cast<int>(qv) & 0xff) << (8 * i);
    }
  }
  if (a.vec_q && n == 8) {
    *reinterpret_cast<uint2*>(a.q + off) = make_uint2(word[0], word[1]);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (i < n) a.q[off + i] = static_cast<signed char>((word[i / 4] >> (8 * (i % 4))) & 0xff);
  }
}

// one warp a row, the row's NC chunks a lane in registers (d <= 256 * NC)
template <int NC>
__global__ void __launch_bounds__(32 * kQ8Warps) rln_q8_regs(Q8Args a) {
  const int lane = threadIdx.x % 32;
  const long row = static_cast<long>(blockIdx.x) * kQ8Warps + threadIdx.x / 32;
  if (row >= a.m) return;
  const long base = row * a.d;
  Chunk<> cx[NC], cr[NC];
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    const int col = chunk_col(lane, j), n = chunk_len(col, a.d);
    cx[j] = load_chunk(a.x, base + col, n);
    cr[j] = load_chunk(a.res, base + col, n);
  }
  float h[NC][8], sum = 0.f, sq = 0.f;
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    float r[8];
    unpack(cx[j], a.x.dt, h[j]);
    unpack(cr[j], a.res.dt, r);
#pragma unroll
    for (int i = 0; i < 8; ++i) {  // values past the row are 0 and add nothing
      h[j][i] += r[i];
      sum += h[j][i];
      sq += h[j][i] * h[j][i];
    }
  }
  const float2 st = row_stats(warp_sum(sum), warp_sum(sq), a.d, a.eps);
  float amax = 0.f;
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    const int col = chunk_col(lane, j), n = chunk_len(col, a.d);
    normalise(h[j], a, col, n, st.x, st.y);  // past the row: gamma = beta = 0, so y = 0
#pragma unroll
    for (int i = 0; i < 8; ++i) amax = fmaxf(amax, fabsf(h[j][i]));
    store_chunk(a.y, base + col, n, h[j]);
  }
  const float scale = __fdiv_rn(fmaxf(warp_max(amax), kScaleFloor), 127.f);
  const float inv = __frcp_rn(scale);
  if (lane == 0) a.s[row] = scale;
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    const int col = chunk_col(lane, j);
    store_q(a, base + col, chunk_len(col, a.d), h[j], scale, inv);
  }
}

// a warp a row, D past the registers: three passes over the row (sums; y
// and its absmax; q), the later two re-reading x and res from L2
__global__ void __launch_bounds__(32 * kQ8Warps) rln_q8_long(Q8Args a) {
  const int lane = threadIdx.x % 32;
  const long row = static_cast<long>(blockIdx.x) * kQ8Warps + threadIdx.x / 32;
  if (row >= a.m) return;
  const long base = row * a.d;
  auto row_h = [&](int col, int n, float (&h)[8]) {
    float r[8];
    unpack(load_chunk(a.x, base + col, n), a.x.dt, h);
    unpack(load_chunk(a.res, base + col, n), a.res.dt, r);
#pragma unroll
    for (int i = 0; i < 8; ++i) h[i] += r[i];
  };
  float sum = 0.f, sq = 0.f;
  for (int col = lane * 8; col < a.d; col += 256) {
    float h[8];
    row_h(col, chunk_len(col, a.d), h);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      sum += h[i];
      sq += h[i] * h[i];
    }
  }
  const float2 st = row_stats(warp_sum(sum), warp_sum(sq), a.d, a.eps);
  float amax = 0.f;
  for (int col = lane * 8; col < a.d; col += 256) {
    const int n = chunk_len(col, a.d);
    float h[8];
    row_h(col, n, h);
    normalise(h, a, col, n, st.x, st.y);
#pragma unroll
    for (int i = 0; i < 8; ++i) amax = fmaxf(amax, fabsf(h[i]));
    store_chunk(a.y, base + col, n, h);
  }
  const float scale = __fdiv_rn(fmaxf(warp_max(amax), kScaleFloor), 127.f);
  const float inv = __frcp_rn(scale);
  if (lane == 0) a.s[row] = scale;
  for (int col = lane * 8; col < a.d; col += 256) {
    const int n = chunk_len(col, a.d);
    float h[8];
    row_h(col, n, h);
    normalise(h, a, col, n, st.x, st.y);
    store_q(a, base + col, n, h, scale, inv);
  }
}

// ---- K3a's backward ------------------------------------------------------------

struct BwdArgs {
  In x, res, g;
  const float* gamma;  // (d) f32
  const float* mean;   // (m) f32, the forward's statistics
  const float* rstd;
  Out dx;
  Out dres;  // dres.p null: dx serves both
  int m, d;
};

// the row's (xhat, gg) at one chunk from its loaded bits
template <bool kWide>
__device__ __forceinline__ void row_terms(const BwdArgs& a, const Chunk<kWide>& cx,
                                          const Chunk<kWide>& cr,
                                          const float (&gam)[8], float mu, float rs,
                                          float (&g)[8], float (&xh)[8], float (&gg)[8]) {
  float r[8];
  unpack(cx, a.x.dt, xh);
  unpack(cr, a.res.dt, r);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    xh[i] = __fmul_rn(__fsub_rn(xh[i] + r[i], mu), rs);
    gg[i] = __fmul_rn(g[i], gam[i]);
  }
}

// dh = rstd * (gg - m1 - xhat * m2), each step rounded as the plain version's
__device__ __forceinline__ void store_dh(const BwdArgs& a, long off, int n, const float (&xh)[8],
                                         const float (&gg)[8], float rs, float m1, float m2) {
  float dh[8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
    dh[i] = __fmul_rn(rs, __fsub_rn(__fsub_rn(gg[i], m1), __fmul_rn(xh[i], m2)));
  store_chunk(a.dx, off, n, dh);
  if (a.dres.p != nullptr) store_chunk(a.dres, off, n, dh);
}

// One warp a row, NC chunks a lane in registers (d <= 256 * NC), the
// warps of a persistent grid striding over the rows. Writes the block's
// dgamma / dbeta partial row: partial[blockIdx.x] = (dgamma (d), dbeta (d)).
// kWide: some input is f32 (two 16-byte words a raw chunk); without it
// the chunks take half the registers and no f32 branch is compiled in.
template <int NC, bool kWide>
__global__ void __launch_bounds__(32 * kBwdWarps, kBwdBlocksPerSM)
    rln_bwd_regs(BwdArgs a, float* partial) {
  // the partial-row sum chained behind this kernel may launch now; it
  // reads the partial rows only after this grid has finished
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  __shared__ __align__(16) float gamma_s[NC * 256];
  __shared__ float fold[kBwdWarps / 2][2 * NC * 8][32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int i = threadIdx.x; i < NC * 256; i += blockDim.x) gamma_s[i] = i < a.d ? a.gamma[i] : 0.f;
  __syncthreads();

  float dg[NC][8], db[NC][8];
#pragma unroll
  for (int j = 0; j < NC; ++j)
#pragma unroll
    for (int i = 0; i < 8; ++i) dg[j][i] = db[j][i] = 0.f;

  // the raw chunks and statistics of the row a warp works on next: with
  // kPrefetchRow they are loaded while the current row is reduced and
  // stored, into the registers its own chunks freed
  Chunk<kWide> cx[NC], cr[NC], cg[NC];
  float mu = 0.f, rs = 0.f;
  auto load_row = [&](long r) {
    const long base = r * a.d;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int col = chunk_col(lane, j), n = chunk_len(col, a.d);
      cx[j] = load_chunk<kWide>(a.x, base + col, n);
      cr[j] = load_chunk<kWide>(a.res, base + col, n);
      cg[j] = load_chunk<kWide>(a.g, base + col, n);
    }
    mu = a.mean[r];
    rs = a.rstd[r];
  };
  const long stride = static_cast<long>(gridDim.x) * kBwdWarps;
  long row = static_cast<long>(blockIdx.x) * kBwdWarps + warp;
  if (row < a.m) load_row(row);
  for (; row < a.m; row += stride) {
    const float row_rs = rs;
    float xh[NC][8], gg[NC][8], s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      float g[8], gam[8];
      unpack(cg[j], a.g.dt, g);
      const float4* gp = reinterpret_cast<const float4*>(gamma_s + chunk_col(lane, j));
      const float4 g0 = gp[0], g1 = gp[1];
      gam[0] = g0.x; gam[1] = g0.y; gam[2] = g0.z; gam[3] = g0.w;
      gam[4] = g1.x; gam[5] = g1.y; gam[6] = g1.z; gam[7] = g1.w;
      row_terms(a, cx[j], cr[j], gam, mu, row_rs, g, xh[j], gg[j]);
#pragma unroll
      for (int i = 0; i < 8; ++i) {  // past the row g = gamma = 0: nothing is added
        db[j][i] += g[i];
        dg[j][i] += g[i] * xh[j][i];
        s1 += gg[j][i];
        s2 += gg[j][i] * xh[j][i];
      }
    }
    const long next = row + stride;
    if (kPrefetchRow && next < a.m) load_row(next);
    const float m1 = __fdiv_rn(warp_sum(s1), static_cast<float>(a.d));
    const float m2 = __fdiv_rn(warp_sum(s2), static_cast<float>(a.d));
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int col = chunk_col(lane, j);
      store_dh(a, row * a.d + col, chunk_len(col, a.d), xh[j], gg[j], row_rs, m1, m2);
    }
    if (!kPrefetchRow && next < a.m) load_row(next);
  }

  // fold the warps' sums in a fixed tree: warp w += warp w + half
  for (int half = kBwdWarps / 2; half > 0; half /= 2) {
    if (warp >= half && warp < 2 * half) {
#pragma unroll
      for (int j = 0; j < NC; ++j)
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          fold[warp - half][8 * j + i][lane] = dg[j][i];
          fold[warp - half][8 * (NC + j) + i][lane] = db[j][i];
        }
    }
    __syncthreads();
    if (warp < half) {
#pragma unroll
      for (int j = 0; j < NC; ++j)
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          dg[j][i] += fold[warp][8 * j + i][lane];
          db[j][i] += fold[warp][8 * (NC + j) + i][lane];
        }
    }
    __syncthreads();
  }
  if (warp == 0) {
    float* out = partial + static_cast<long>(blockIdx.x) * 2 * a.d;
#pragma unroll
    for (int j = 0; j < NC; ++j)
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int col = chunk_col(lane, j) + i;
        if (col < a.d) {
          out[col] = dg[j][i];
          out[a.d + col] = db[j][i];
        }
      }
  }
}

// D past the registers: a warp a row, the row walked twice (the row sums,
// then dh, re-reading x, res and g from L2); dgamma / dbeta are
// rln_bwd_cols's
__global__ void __launch_bounds__(32 * kBwdWarps) rln_bwd_rows_long(BwdArgs a) {
  const int lane = threadIdx.x % 32;
  const In gamma{a.gamma, kF32, aligned16(a.gamma)};
  const long stride = static_cast<long>(gridDim.x) * kBwdWarps;
  for (long row = static_cast<long>(blockIdx.x) * kBwdWarps + threadIdx.x / 32; row < a.m;
       row += stride) {
    const long base = row * a.d;
    const float mu = a.mean[row], rs = a.rstd[row];
    auto terms = [&](int col, int n, float (&xh)[8], float (&gg)[8]) {
      float g[8], gam[8];
      unpack(load_chunk(a.g, base + col, n), a.g.dt, g);
      unpack(load_chunk(gamma, col, n), kF32, gam);
      row_terms(a, load_chunk(a.x, base + col, n), load_chunk(a.res, base + col, n), gam, mu, rs,
                g, xh, gg);
    };
    float s1 = 0.f, s2 = 0.f;
    for (int col = lane * 8; col < a.d; col += 256) {
      float xh[8], gg[8];
      terms(col, chunk_len(col, a.d), xh, gg);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        s1 += gg[i];
        s2 += gg[i] * xh[i];
      }
    }
    const float m1 = __fdiv_rn(warp_sum(s1), static_cast<float>(a.d));
    const float m2 = __fdiv_rn(warp_sum(s2), static_cast<float>(a.d));
    for (int col = lane * 8; col < a.d; col += 256) {
      const int n = chunk_len(col, a.d);
      float xh[8], gg[8];
      terms(col, n, xh, gg);
      store_dh(a, base + col, n, xh, gg, rs, m1, m2);
    }
  }
}

// dgamma / dbeta partials over blocks of kColRows rows, a thread a column:
// partial[blockIdx.y] = (dgamma (d), dbeta (d)) of rows [kColRows * y, ...)
__global__ void rln_bwd_cols(BwdArgs a, float* partial) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= a.d) return;
  const long r0 = static_cast<long>(blockIdx.y) * kColRows;
  const long r1 = r0 + kColRows < a.m ? r0 + kColRows : a.m;
  float dg = 0.f, db = 0.f;
  for (long row = r0; row < r1; ++row) {
    const long i = row * a.d + col;
    const float g = load_one(a.g, i);
    const float xh = __fmul_rn(__fsub_rn(load_one(a.x, i) + load_one(a.res, i), a.mean[row]),
                               a.rstd[row]);
    db += g;
    dg += g * xh;
  }
  float* out = partial + static_cast<long>(blockIdx.y) * 2 * a.d;
  out[col] = dg;
  out[a.d + col] = db;
}

// out[c] = sum over the partial rows p of partial[p][c], in index order:
// kSumGroups threads a column each sum a run of consecutive rows, then the
// runs are added in order
__global__ void __launch_bounds__(32 * kSumGroups)
sum_partials(const float* __restrict__ partial, int parts, int cols, float* __restrict__ out) {
  __shared__ float runs[kSumGroups][33];
  // launched chained after the row pass: wait until its partial rows are
  // written (a no-op otherwise)
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int col = blockIdx.x * 32 + threadIdx.x, grp = threadIdx.y;
  const int per = (parts + kSumGroups - 1) / kSumGroups;
  const int p0 = grp * per, p1 = p0 + per < parts ? p0 + per : parts;
  float s = 0.f;
  if (col < cols)
    for (int p = p0; p < p1; ++p) s += partial[static_cast<long>(p) * cols + col];
  runs[grp][threadIdx.x] = s;
  __syncthreads();
  if (grp == 0 && col < cols) {
    float total = runs[0][threadIdx.x];
    for (int r = 1; r < kSumGroups; ++r) total += runs[r][threadIdx.x];
    out[col] = total;
  }
}

// ---- the quotient, for its test ----------------------------------------------

__global__ void quotient_rows(const float* __restrict__ y, const float* __restrict__ s,
                             float* __restrict__ out, long n) {
  const long i = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < n) out[i] = quotient(y[i], s[i], __frcp_rn(s[i]));
}

// ---- host side -------------------------------------------------------------------

bool valid_dtype(int dt) { return dt == kBF16 || dt == kF16 || dt == kF32; }

int elem_bytes(int dt) { return dt == kF32 ? 4 : 2; }

bool rows_vec(const void* p, int dt, int d) {
  return aligned16(p) && static_cast<long>(d) * elem_bytes(dt) % 16 == 0;
}

int chunks(int d) { return (d + 255) / 256; }

// the register path's grid: blocks resident at once, cut so that every
// warp walks the same number of rows
template <int NC, bool kWide>
int regs_grid(int m, int* grid) {
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, rln_bwd_regs<NC, kWide>,
                                                        32 * kBwdWarps, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long slots = static_cast<long>(sms) * (per_sm > 0 ? per_sm : 1) * kBwdWarps;
  const long rows_per_warp = (m + slots - 1) / slots;
  *grid = static_cast<int>((m + rows_per_warp * kBwdWarps - 1) / (rows_per_warp * kBwdWarps));
  return 0;
}

template <bool kWide>
int partial_rows(int m, int d, int* rows) {
  switch (chunks(d)) {
    case 1: return regs_grid<1, kWide>(m, rows);
    case 2: return regs_grid<2, kWide>(m, rows);
    case 3: return regs_grid<3, kWide>(m, rows);
    case 4: return regs_grid<4, kWide>(m, rows);
    default: *rows = (m + kColRows - 1) / kColRows; return 0;
  }
}

template <bool kWide>
void launch_bwd_regs(int nc, unsigned grid, cudaStream_t st, const BwdArgs& a, float* partial) {
  switch (nc) {
    case 1: rln_bwd_regs<1, kWide><<<grid, 32 * kBwdWarps, 0, st>>>(a, partial); break;
    case 2: rln_bwd_regs<2, kWide><<<grid, 32 * kBwdWarps, 0, st>>>(a, partial); break;
    case 3: rln_bwd_regs<3, kWide><<<grid, 32 * kBwdWarps, 0, st>>>(a, partial); break;
    default: rln_bwd_regs<4, kWide><<<grid, 32 * kBwdWarps, 0, st>>>(a, partial);
  }
}

}  // namespace

extern "C" {

// x, res (m, d) with type codes 0 bf16, 1 f16, 2 f32; gamma, beta (d) f32 ->
// y (m, d) in x's type, q (m, d) int8, s (m) f32. Returns a cudaError_t code.
int rln_q8_launch(const void* x, int x_dtype, const void* res, int res_dtype, const float* gamma,
                  const float* beta, void* y, void* q, float* s, int m, int d, float eps,
                  void* stream) {
  if (m < 0 || d < 1 || !valid_dtype(x_dtype) || !valid_dtype(res_dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0) return 0;
  Q8Args a;
  a.x = In{x, x_dtype, rows_vec(x, x_dtype, d)};
  a.res = In{res, res_dtype, rows_vec(res, res_dtype, d)};
  a.gamma = gamma;
  a.beta = beta;
  a.vec_gb = aligned16(gamma) && aligned16(beta);
  a.y = Out{y, x_dtype, rows_vec(y, x_dtype, d)};
  a.q = static_cast<signed char*>(q);
  a.vec_q = reinterpret_cast<uintptr_t>(q) % 8 == 0 && d % 8 == 0;
  a.s = s;
  a.m = m;
  a.d = d;
  a.eps = eps;
  const unsigned grid = static_cast<unsigned>((m + kQ8Warps - 1) / kQ8Warps);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  static_assert(kMaxChunks == 4, "one K3b instantiation a chunk count");
  switch (chunks(d)) {
    case 1: rln_q8_regs<1><<<grid, 32 * kQ8Warps, 0, st>>>(a); break;
    case 2: rln_q8_regs<2><<<grid, 32 * kQ8Warps, 0, st>>>(a); break;
    case 3: rln_q8_regs<3><<<grid, 32 * kQ8Warps, 0, st>>>(a); break;
    case 4: rln_q8_regs<4><<<grid, 32 * kQ8Warps, 0, st>>>(a); break;
    default: rln_q8_long<<<grid, 32 * kQ8Warps, 0, st>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

// the number of (2d) f32 partial rows rln_bwd_launch needs as scratch for
// (m, d) on the current device; wide: x, res or gy is f32
int rln_bwd_partial_rows(int m, int d, int wide, int* rows) {
  if (m < 1 || d < 1) return static_cast<int>(cudaErrorInvalidValue);
  return wide ? partial_rows<true>(m, d, rows) : partial_rows<false>(m, d, rows);
}

// The backward: x, res, gy (m, d) with type codes as above; gamma (d),
// mean, rstd (m) f32 -> dx (m, d) in x's type, dres in res's type (null
// when res's type is x's: dx serves both), dgb (2d) f32 = (dgamma, dbeta).
// partial: scratch of parts rows of 2d f32, parts = rln_bwd_partial_rows.
// Two launches (three for d > 1024). Returns a cudaError_t code.
int rln_bwd_launch(const void* x, int x_dtype, const void* res, int res_dtype, const void* gy,
                   int gy_dtype, const float* gamma, const float* mean, const float* rstd,
                   void* dx, void* dres, float* dgb, float* partial, int parts, int m, int d,
                   void* stream) {
  if (m < 1 || d < 1 || parts < 1 || !valid_dtype(x_dtype) || !valid_dtype(res_dtype) ||
      !valid_dtype(gy_dtype) || (dres == nullptr && res_dtype != x_dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  BwdArgs a;
  a.x = In{x, x_dtype, rows_vec(x, x_dtype, d)};
  a.res = In{res, res_dtype, rows_vec(res, res_dtype, d)};
  a.g = In{gy, gy_dtype, rows_vec(gy, gy_dtype, d)};
  a.gamma = gamma;
  a.mean = mean;
  a.rstd = rstd;
  a.dx = Out{dx, x_dtype, rows_vec(dx, x_dtype, d)};
  a.dres = Out{dres, res_dtype, dres != nullptr && rows_vec(dres, res_dtype, d)};
  a.m = m;
  a.d = d;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nc = chunks(d);
  if (nc <= kMaxChunks) {
    const bool wide = x_dtype == kF32 || res_dtype == kF32 || gy_dtype == kF32;
    if (wide)
      launch_bwd_regs<true>(nc, static_cast<unsigned>(parts), st, a, partial);
    else
      launch_bwd_regs<false>(nc, static_cast<unsigned>(parts), st, a, partial);
  } else {
    if (parts != (m + kColRows - 1) / kColRows) return static_cast<int>(cudaErrorInvalidValue);
    const unsigned row_grid = static_cast<unsigned>((m + kBwdWarps - 1) / kBwdWarps);
    rln_bwd_rows_long<<<row_grid, 32 * kBwdWarps, 0, st>>>(a);
    rln_bwd_cols<<<dim3((d + 255) / 256, parts), 256, 0, st>>>(a, partial);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((2 * d + 31) / 32);
  config.blockDim = dim3(32, kSumGroups);
  config.stream = st;
  cudaLaunchAttribute chain[1];
  chain[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  chain[0].val.programmaticStreamSerializationAllowed = 1;
  config.attrs = chain;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, sum_partials, static_cast<const float*>(partial), parts, 2 * d,
                           dgb);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// out[i] = quotient(y[i], s[i], 1 / s[i]) as K3b and the dynx quantize
// compute it (the test of rowquant.cuh). Returns a cudaError_t code.
int rln_quotient_launch(const float* y, const float* s, float* out, long n, void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  quotient_rows<<<static_cast<unsigned>((n + 255) / 256), 256, 0,
                  static_cast<cudaStream_t>(stream)>>>(y, s, out, n);
  return static_cast<int>(cudaGetLastError());
}

const char* rln_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
