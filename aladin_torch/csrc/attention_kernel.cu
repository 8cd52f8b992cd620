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
// keep mask from the same seed, and returns dq, dk, dv in T: dv = pd^T g,
// dp = keep ? (g v^T) * scale : 0, ds = p * (dp - rowsum(dp * p)) / sqrt(d),
// dq = ds k, dk = ds^T q. The softmax VJP uses the undropped p, as the JAX
// kernel does. bias and seed get no gradient.
//
// Layout: q, k, v, g, ctx, dq, dk, dv are (B, S, H, d) row-major, read and
// written in place with a stride of H * d elements between tokens, so the
// wrapper never transposes. bias is f32 (B, Q, S) with Q = 1 (a 1-D key mask,
// broadcast over the queries) or Q = S (a 2-D mask). T is bf16 or f32; d is 64.
//
// Dropout: the TPU's hardware PRNG has no counterpart here. The keep bit of
// element (b, h, q, k) is a counter-based hash of
// (seed, b * heads_total + head_offset + h, q * S + k) in 32-bit integer
// arithmetic, with the unpadded S,
//     bits = mix32(mix32(mix32(seed) ^ (b * heads_total + head_offset + h)) ^ (q * S + k)),
//     keep = bits >= threshold, threshold = uint32(rate * 2^32),
// which the plain PyTorch version in ops/kernels/attention_kernel.py computes
// identically, so kernel and plain version agree with dropout on as well.
// heads_total is H and head_offset 0 for a launch over a layer's heads; a
// tensor-parallel rank that holds heads [head_offset, head_offset + H) of a
// layer of heads_total passes both and draws those heads' masks of the
// unsharded launch.
// The seed is read on the card, through a pointer to an int64 whose low 32
// bits are used: the model draws a layer's seeds on the card, so a CUDA
// graph that replays the kernel reads a new seed every replay.
//
// Bound on an H100 SXM: at this backbone's sequence lengths (S <= 160) the
// work is small. The forward needs 4 * B * H * S^2 * d operations against
// 989 TFLOP/s bf16 and moves 4 * B * S * H * d elements (q, k, v read, ctx
// written) at 3.35 TB/s; at B = 128, S = 84 in bf16 the two bounds are 2.8 us
// and 19.7 us, so the forward is bytes-bound, and so is the backward
// (10 * B * H * S^2 * d operations, 7 tensors moved). Neither writes the
// (S, S) scores to device memory.
//
// bf16 design (the training path's type). One warp per 16 query rows,
// S_pad = 16 * ceil(S / 16) rows in all:
//   * q, k, v (and g) rows of a head are staged into shared memory with
//     16-byte cp.async, at a pitch of 72 bf16 (144 bytes: 16-byte aligned,
//     and the 8 rows an ldmatrix reads fall on 8 distinct 4-bank groups).
//     Rows S..S_pad are zero-filled, never left stale: 0 x NaN bits would
//     poison the products. q and k form the first cp.async group, so the
//     scores start while the rest is still in flight.
//   * Scores: mma.sync m16n8k16 bf16 -> f32, A = the warp's q rows and
//     B = k rows, both through ldmatrix (k not transposed). The warp keeps
//     its whole 16 x S_pad strip in registers (S_pad / 2 f32 a thread, 80 at
//     S_pad = 160; the kernel is instantiated for each S_pad / 16 so the
//     strip is a register array), masks the padded keys to -inf, and takes
//     the row max and sum with quad shuffles. No online (flash) rescaling: a
//     whole row fits, and the contract rounds the normalised p.
//   * p = e / sum is the IEEE quotient without the divide's subroutine: one
//     correctly rounded reciprocal a row and two fma an element (Markstein's
//     theorem, bit for bit wherever p is normal, above 2^-126). The divide's
//     call had held the 2-D forward at 208 registers a thread.
//   * The bias is staged in shared memory and read as one float2 a key pair:
//     a 1-D bias (the model's key mask) as one f32 row, -inf on the padded
//     keys; a 2-D bias (bias_q == S: the captioning step's and the decoder's
//     block masks) as the block's real query rows at a pitch of S_pad + 8
//     f32 (float2 reads of 8 rows fall on distinct banks), -inf on the
//     padded keys, padded query rows reading the last real row (computed,
//     never stored). Its cp.async copies take 16 bytes where S % 4 == 0, else
//     8 (S even) or 4: a row starts (b S + r) S floats into the tensor.
//   * Forward, 1-D bias: one block per (batch row, head).
//   * Forward, 2-D bias: all heads of a batch row share the bias, so a block
//     stages it once, in a cp.async group of its own after the first heads'
//     q and k, for several heads of one row that `plan_fwd` picks from B, H
//     and the SM count: one wave of blocks, and warp groups that compute two
//     heads at once (each group its own q / k / v sets, its own named
//     barrier; the whole block syncs once, for the bias). Where a group takes
//     a second head, its tiles load into a second set once the first heads'
//     bias is in. Where the SM would hold two heads at most (the decoder's
//     B 16), each head's rows are cut in two and each half taken by a group
//     of 4 warps. Two groups of 8 warps need at most 128 registers a thread:
//     the 2-D kernel's launch bound asks for 2 S_pad / 16 warps up to S_pad
//     128. Shared memory at S 120 (B 32: 3 heads a block, 2 groups, 3 sets):
//     3 x 55,296 bytes of tiles + 65,280 of bias = 231,168, within the
//     232,448 a block may use; at S_pad 160 (one group, one set) 176,640.
//     tools/k2_variants.py times each cut against the others and against
//     one block a head, bit for bit equal to each other.
//   * Forward: the keep mask is computed per accumulator from its own (row,
//     key); p * scale is rounded to bf16 and the C fragments are repacked in
//     registers as the A fragments of PV (the m16n8 C-to-A reuse), with v
//     through ldmatrix.trans. ctx goes through the warp's own q rows in
//     shared memory and out as 16-byte stores; padded rows are not stored.
//   * Backward, one block per (batch row, head) under a 1-D bias, per
//     (batch row, the heads of one wave of blocks) in turn under a 2-D one:
//     each warp recomputes its p strip and keep bits (one mask for p and
//     dp: their C layouts coincide), writes pd to shared memory, then computes dp = g v^T with
//     mma twice over key tiles of 16 (once for the row sum of dp * p, once
//     for ds), which keeps p, one dp tile and the g fragments in registers
//     (104 values a thread at S_pad = 160, not the 176 of a whole dp strip
//     beside p). ds goes to shared memory and, from registers, into dq = ds k
//     (k through ldmatrix.trans). After one __syncthreads each warp owns 16
//     key rows: dv = pd^T g and dk = ds^T q, with pd^T and ds^T read by
//     ldmatrix.trans from the row-major pd / ds tiles (pitch S_pad + 8). No
//     atomics: one block holds the whole head. Shared memory is 4 (S_pad, 72)
//     bf16 tiles, 2 (S_pad, S_pad + 8) bf16 tiles and a 1-D bias row,
//     200,320 bytes at S_pad = 160. A 2-D bias, S_pad rows at a pitch of
//     S_pad + 8 f32, comes in the first cp.async group. Up to S_pad 128 it
//     has a region of its own (212,992 bytes in all at S_pad 128) and is
//     staged once for the block's heads (`plan_bwd`: 3 at B 32, 2 at B 16,
//     S 120); above, it is exactly as large as the pd and ds tiles together
//     and lies over them, one head a block, until every warp has read its
//     rows (one __syncthreads before pd is written).
//   * Precision: the forward's tensor-core operands are the bf16 inputs and
//     the bf16-rounded pd the contract itself rounds, so it is exact up to
//     the order of f32 sums. The backward's pd and ds are f32 in the
//     contract; they enter the dq, dk, dv products as plain bf16, a relative
//     rounding of at most 2^-8 on each term. That moves an f32 sum by far
//     less than one bf16 ulp of the largest output, so the bf16 result can
//     differ from the plain version's by a one-ulp rounding flip at most,
//     which the card tolerance (one bf16 ulp of the largest output) admits.
//     The card tests and chip_smoke.py hold it at S 7..160, both bias
//     shapes (the 2-D one also under captioning block masks at B 16 and 32),
//     dropout 0 and 0.1, and logits of +-40, so pd and ds are not
//     split into bf16 high and low halves (two mmas each), the way to
//     tighten it should a case need it.
//   * Why mma.sync and not wgmma or TMA: wgmma takes 64-row tiles, which at
//     S 84 pads the rows to 128 (34% waste, against 12.5% at 16-row
//     granularity), and the kernel is bound by bytes and latency, not by the
//     tensor-core peak, so wgmma's rate buys nothing here. A TMA descriptor
//     would have to be encoded on the host (cuTensorMapEncodeTiled) for
//     each call's pointers; cp.async with a zero-filled ragged edge needs
//     none.
//
// f32 design: plain f32 FMA on CUDA cores (each lane owns five key columns
// of a row; the backward round-trips the (S, S) f32 matrix through shared
// memory), the only route that holds the f32 tolerance of 1e-5; TF32 tensor
// cores would not. It serves tests and callers that pass f32; the training
// path passes bf16.
//
// Limits: d == 64, S <= 160, and the shared memory within the 227 KB a block
// may opt into (the f32 backward's (S, S) matrix exceeds it from S = 143);
// above 48 KB the launch raises the kernel's dynamic shared-memory limit with
// cudaFuncSetAttribute first.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <array>
#include <utility>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kHeadDim = 64;
constexpr int kMaxSeq = 160;
constexpr int kMaxWarps = kMaxSeq / 16;  // bf16: one warp per 16 query rows
constexpr int kMaxSmem = 232448;         // opt-in shared memory of one block on sm_90

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7feb352du;
  x ^= x >> 15;
  x *= 0x846ca68bu;
  x ^= x >> 16;
  return x;
}

__host__ __device__ constexpr size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync m16n8k16), cp.async staging.

constexpr int kPitch = kHeadDim + 8;  // bf16 elements in a staged head row
constexpr int kBiasPad = 8;           // a staged 2-D bias row: S_pad + 8 f32

constexpr int seq_warps(int s) { return (s + 15) / 16; }

// How a forward launch is cut into blocks: a block computes `heads` heads of
// one batch row on `1 / parts` of their query rows (one warp a 16-row tile)
// in `groups` warp groups, group w taking the block's heads w, w + groups,
// ... in turn, with up to `buffers` q / k / v tile sets (2: its next head's
// tiles load while this head computes). A 2-D bias is staged once a block.
struct FwdPlan {
  int heads, parts, buffers, groups;
};

__host__ __device__ constexpr int part_warps(int nw, int parts) { return (nw + parts - 1) / parts; }

// The q / k / v sets of warp group w: one a head it takes, at most `buffers`.
__host__ __device__ constexpr int group_sets(int heads, int groups, int buffers, int w) {
  return (heads - w + groups - 1) / groups < buffers ? (heads - w + groups - 1) / groups : buffers;
}

// The groups' q rows, k and v, then the bias: a 1-D row (f32, -inf past S)
// or the block's real 2-D rows at a pitch of S_pad + 8 f32
size_t bf16_fwd_smem_bytes(int s, int bias_q, FwdPlan p) {
  const size_t sp = 16 * (size_t)seq_warps(s);
  const size_t rows = 16 * (size_t)part_warps(seq_warps(s), p.parts);
  size_t sets = 0;
  for (int w = 0; w < p.groups; ++w) sets += group_sets(p.heads, p.groups, p.buffers, w);
  const size_t bias = bias_q == 1 ? sp : std::min(rows, (size_t)s) * (sp + kBiasPad);
  return sets * (rows + 2 * sp) * kPitch * sizeof(bf16) + bias * sizeof(float);
}

// q, k, v, g tiles, the pd and ds tiles, and a 1-D bias row. A 2-D bias
// (S_pad rows at a pitch of S_pad + 8 f32) has a region of its own where a
// block takes more than one head; else it lies over the pd and ds tiles,
// which hold exactly as many bytes, until every warp has read its rows.
size_t bf16_bwd_smem_bytes(int s, int bias_q, int heads) {
  const size_t sp = 16 * (size_t)seq_warps(s);
  const size_t bias = bias_q != 1 && heads > 1 ? sp * (sp + 8) : sp;
  return (4 * sp * kPitch + 2 * sp * (sp + 8)) * sizeof(bf16) + bias * sizeof(float);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Named barrier `id` over `threads` threads of the block (0 is __syncthreads's).
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Four 8x8 b16 matrices; lane i gives the address of row i % 8 of matrix i / 8.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// c += a b: a 16x16 (row), b 16x8 (col), c 16x8 f32.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The A fragment of key chunk kc (keys 16 kc .. 16 kc + 15) from a strip of
// C fragments: C tile j holds keys 8 j .. 8 j + 7.
template <int NT>
__device__ __forceinline__ void strip_to_a(const float (&c)[NT][4], int kc, uint32_t (&a)[4]) {
  a[0] = pack_bf16(c[2 * kc][0], c[2 * kc][1]);
  a[1] = pack_bf16(c[2 * kc][2], c[2 * kc][3]);
  a[2] = pack_bf16(c[2 * kc + 1][0], c[2 * kc + 1][1]);
  a[3] = pack_bf16(c[2 * kc + 1][2], c[2 * kc + 1][3]);
}

// Where lane `lane` points an ldmatrix x4 (row, column offsets within a
// 16 x 16 tile of a row-major shared matrix):
//   a_*:  an A tile stored as M rows of K (q, g): matrices (m 0-7, k 0-7),
//         (m 8-15, k 0-7), (m 0-7, k 8-15), (m 8-15, k 8-15) are a0..a3.
//   bn_*: B stored as N rows of K (k, v as they lie): (n 0-7, k 0-7),
//         (n 0-7, k 8-15), (n 8-15, k 0-7), (n 8-15, k 8-15) are b0, b1 of
//         n-tile 0, then of n-tile 1. With .trans, the same addressing of a
//         row-major (K, M) tile gives the A fragment of its transpose (pd^T,
//         ds^T): (k 0-7, m 0-7) transposed is a0, (k 0-7, m 8-15) a1, ...
//   bt_*: B stored as K rows of N (v in PV, k in ds k, g and q for dv, dk),
//         read with .trans: (k 0-7, n 0-7), (k 8-15, n 0-7), (k 0-7, n 8-15),
//         (k 8-15, n 8-15) are b0, b1 of n-tile 0, then of n-tile 1.
__device__ __forceinline__ int a_row(int lane) { return lane & 15; }
__device__ __forceinline__ int a_col(int lane) { return (lane >> 4) << 3; }
__device__ __forceinline__ int bn_row(int lane) { return (lane & 7) + ((lane >> 4) << 3); }
__device__ __forceinline__ int bn_col(int lane) { return ((lane >> 3) & 1) << 3; }
__device__ __forceinline__ int bt_row(int lane) { return (lane & 7) + (((lane >> 3) & 1) << 3); }
__device__ __forceinline__ int bt_col(int lane) { return (lane >> 4) << 3; }

// Stage rows [row0, row0 + rows) of head h of batch row b into rows [0, rows)
// of a shared tile of pitch kPitch, thread `tid` of `threads`: 16-byte
// cp.async for rows < s_len, zeros for the padding rows.
__device__ __forceinline__ void stage_tile(const bf16* __restrict__ src, bf16* dst, int b, int h,
                                           int s_len, int n_heads, int row0, int rows, int tid,
                                           int threads) {
  const long tok = (long)n_heads * kHeadDim;
  for (int idx = tid; idx < rows * 8; idx += threads) {
    const int r = idx >> 3, c = (idx & 7) << 3;
    bf16* d = dst + r * kPitch + c;
    if (row0 + r < s_len)
      cp_async16(d, src + ((long)b * s_len + row0 + r) * tok + (long)h * kHeadDim + c);
    else
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// A 1-D bias row (bias_q == 1) into shared memory, -inf on the padded keys.
__device__ __forceinline__ void stage_bias_row(const float* __restrict__ bias_b, float* dst,
                                               int s_len, int sp) {
  for (int c = threadIdx.x; c < sp; c += blockDim.x) dst[c] = c < s_len ? bias_b[c] : -INFINITY;
}

// Rows [row0, row0 + rows) of batch row b's 2-D bias (bias_q == S; bias_b
// points at the batch row) into shared memory at a pitch of sp + kBiasPad f32
// by cp.async, a warp a row: -inf on the padded keys, 0 on the padded query
// rows (computed, never stored). A bias row starts (b S + r) S floats into
// the tensor, 16-byte aligned only where S % 4 == 0 (and the base is): the
// copies then take 16 bytes, else 8 (S even) or 4.
__device__ __forceinline__ void stage_bias_rows(const float* __restrict__ bias_b, float* dst,
                                                int s_len, int sp, int row0, int rows) {
  const int lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  const uintptr_t a = reinterpret_cast<uintptr_t>(bias_b);
  const int vec = (s_len % 4 == 0 && a % 16 == 0) ? 4 : (s_len % 2 == 0 && a % 8 == 0) ? 2 : 1;
  for (int r = threadIdx.x >> 5; r < rows; r += warps) {
    const int gr = row0 + r;
    float* d = dst + r * (sp + kBiasPad);
    const float* src = bias_b + (long)gr * s_len;
    for (int c = lane * vec; c < sp; c += 32 * vec) {
      if (gr < s_len && c < s_len) {  // s_len % vec == 0: the whole chunk is real
        if (vec == 4)
          cp_async16(d + c, src + c);
        else if (vec == 2)
          cp_async8(d + c, src + c);
        else
          cp_async4(d + c, src + c);
      } else {
        for (int e = 0; e < vec; ++e) d[c + e] = c + e < s_len ? 0.f : -INFINITY;
      }
    }
  }
}

// A warp's 16 x 64 f32 result (C fragments of 8 dim tiles) into 16 rows of a
// shared tile (`stage`, the warp's own rows) as bf16, then out to rows
// [r0, r0 + 16) of head h of dst as 16-byte stores, skipping rows >= s_len.
__device__ __forceinline__ void store_strip(const float (&acc)[8][4], bf16* stage,
                                            bf16* __restrict__ dst, int b, int h, int s_len,
                                            int n_heads, int r0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    *reinterpret_cast<uint32_t*>(stage + g * kPitch + 8 * n + 2 * t) =
        pack_bf16(acc[n][0], acc[n][1]);
    *reinterpret_cast<uint32_t*>(stage + (g + 8) * kPitch + 8 * n + 2 * t) =
        pack_bf16(acc[n][2], acc[n][3]);
  }
  __syncwarp();
  const long tok = (long)n_heads * kHeadDim;
#pragma unroll
  for (int it = 0; it < 4; ++it) {  // 16 rows x 8 chunks of 16 bytes
    const int i = lane + 32 * it, r = i >> 3, c = (i & 7) << 3;
    if (r0 + r < s_len)
      *reinterpret_cast<uint4*>(dst + ((long)b * s_len + r0 + r) * tok + (long)h * kHeadDim + c) =
          *reinterpret_cast<const uint4*>(stage + r * kPitch + c);
  }
  __syncwarp();
}

// Scores of the warp's 16 query rows (q rows at qw) against all keys:
// s[j][e] is q.k of row g + 8 (e >> 1), key 8 j + 2 t + (e & 1), with
// g = lane / 4, t = lane % 4 (the mma C layout).
template <int NT>
__device__ __forceinline__ void scores(const bf16* qw, const bf16* ks, float (&s)[NT][4]) {
  const int lane = threadIdx.x & 31;
  uint32_t qa[4][4];
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) ldsm_x4(qa[kc], qw + a_row(lane) * kPitch + 16 * kc + a_col(lane));
#pragma unroll
  for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int jp = 0; jp < NT / 2; ++jp) {
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      uint32_t kb[4];
      ldsm_x4(kb, ks + (16 * jp + bn_row(lane)) * kPitch + 16 * kc + bn_col(lane));
      mma(s[2 * jp], qa[kc], kb[0], kb[1]);
      mma(s[2 * jp + 1], qa[kc], kb[2], kb[3]);
    }
  }
}

// The scores into probabilities, in place: s = q.k / sqrt(d) + bias, p =
// exp(s - max) / sum, 0 for keys >= s_len. The bias of rows g and g + 8 is
// read from shared memory at brow0 and brow1 (the one staged row for a 1-D
// bias), -inf on the padded keys.
template <int NT>
__device__ __forceinline__ void softmax_rows(const float* brow0, const float* brow1,
                                             float inv_sqrt_d, float (&s)[NT][4]) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const float2 b0 = *reinterpret_cast<const float2*>(brow0 + 8 * j + 2 * t);
    const float2 b1 = *reinterpret_cast<const float2*>(brow1 + 8 * j + 2 * t);
    s[j][0] = __fadd_rn(__fmul_rn(s[j][0], inv_sqrt_d), b0.x);
    s[j][1] = __fadd_rn(__fmul_rn(s[j][1], inv_sqrt_d), b0.y);
    s[j][2] = __fadd_rn(__fmul_rn(s[j][2], inv_sqrt_d), b1.x);
    s[j][3] = __fadd_rn(__fmul_rn(s[j][3], inv_sqrt_d), b1.y);
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
  }
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] = expf(s[j][e] - mx[e >> 1]);  // exp(-inf) = 0 for the padded keys
      sum[e >> 1] += s[j][e];
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
    sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
  }
  // p = e / sum as the IEEE divide rounds it, without its subroutine: with
  // r = 1 / sum correctly rounded, q0 = e r is within an ulp of the
  // quotient, the fma gives the remainder e - sum q0 exactly, and one more
  // fma rounds q0 + rem r to the correctly rounded quotient (Markstein's
  // theorem: every quotient in the normal range, so every p above 2^-126;
  // sum >= 1, and e = 0 gives +0)
  const float inv[2] = {__frcp_rn(sum[0]), __frcp_rn(sum[1])};
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float q0 = __fmul_rn(s[j][e], inv[e >> 1]);
      s[j][e] = __fmaf_rn(__fmaf_rn(-sum[e >> 1], q0, s[j][e]), inv[e >> 1], q0);
    }
  }
}

// Forward. Block (b, `heads_blk` heads, part of the query rows) in `wgs`
// warp groups of W = blockDim / 32 / wgs warps: group w takes heads w,
// w + wgs, ... of the block in turn, its warps the row tiles
// [part * W, part * W + W) (a warp whose tile starts at or past S_pad
// idles). A group syncs over its own threads, except once over the block
// for the 2-D bias, which all the block's threads stage. M2D: the bias is
// 2-D (bias_q == S); a 1-D bias takes one head a block, all its rows, one
// group and one q / k / v set. Two groups need at most 128 registers a
// thread at S_pad 128: the launch bound asks for it up to there.
template <int NW, bool M2D>
__global__ void __launch_bounds__((M2D && NW <= 8 ? 2 : 1) * NW * 32)
attn_fwd_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
              const float* __restrict__ bias, bf16* __restrict__ out, int s_len, int n_heads,
              int heads_total, int head_offset, const long long* __restrict__ seed_ptr,
              uint32_t threshold, float scale, float inv_sqrt_d, int dropout, int heads_blk,
              int parts, int buffers, int wgs) {
  const uint32_t seed = dropout ? static_cast<uint32_t>(*seed_ptr) : 0u;  // device-drawn
  constexpr int SP = 16 * NW, NT = 2 * NW, BP = SP + kBiasPad;
  if constexpr (!M2D) heads_blk = parts = buffers = wgs = 1;
  extern __shared__ __align__(16) unsigned char smem[];
  const int wthreads = M2D ? blockDim.x / wgs : blockDim.x, rows = M2D ? wthreads / 2 : SP;
  const int part = blockIdx.x % parts, groups = (n_heads + heads_blk - 1) / heads_blk;
  const int b = blockIdx.x / parts / groups, h0 = blockIdx.x / parts % groups * heads_blk;
  const int nh = M2D ? min(heads_blk, n_heads - h0) : 1;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wg = M2D ? threadIdx.x / wthreads : 0, wtid = threadIdx.x - wg * wthreads;
  const int row0 = rows * part, lr0 = 16 * (wtid >> 5), r0 = row0 + lr0;
  const bool active = !M2D || r0 < SP;
  const int set = (rows + 2 * SP) * kPitch;  // bf16 elements of one q / k / v set
  int first_set = 0, sets = 0;
  for (int w = 0; w < wgs; ++w) {
    first_set += w < wg ? group_sets(heads_blk, wgs, buffers, w) : 0;
    sets += group_sets(heads_blk, wgs, buffers, w);
  }
  const int my_sets = max(1, group_sets(heads_blk, wgs, buffers, wg));
  bf16* tiles = reinterpret_cast<bf16*>(smem) + first_set * set;
  float* bs = reinterpret_cast<float*>(reinterpret_cast<bf16*>(smem) + sets * set);
  const float* bias_b = bias + (long)b * (M2D ? s_len : 1) * s_len;
  const int nb = M2D ? min(rows, s_len - row0) : 1;  // real query rows: their bias is staged

  auto stage_qk = [&](int i, int n) {  // head i of the block into the group's set n % my_sets
    bf16* qs = tiles + (n % my_sets) * set;
    stage_tile(q, qs, b, h0 + i, s_len, n_heads, row0, rows, wtid, wthreads);
    stage_tile(k, qs + rows * kPitch, b, h0 + i, s_len, n_heads, 0, SP, wtid, wthreads);
  };
  auto stage_v = [&](int i, int n) {
    stage_tile(v, tiles + (n % my_sets) * set + (rows + SP) * kPitch, b, h0 + i, s_len, n_heads,
               0, SP, wtid, wthreads);
  };
  auto sync = [&] { bar_sync(1 + wg, wthreads); };  // the group's tiles are its own
  // the first heads' q and k, the 2-D bias, then v, one group each: the
  // scores start before the bias and v have landed
  if (wg < nh) stage_qk(wg, 0);
  cp_async_commit();
  if constexpr (M2D) stage_bias_rows(bias_b, bs, s_len, SP, row0, nb);
  cp_async_commit();
  if (wg < nh) stage_v(wg, 0);
  cp_async_commit();
  if constexpr (!M2D) stage_bias_row(bias_b, bs, s_len, SP);
  // padded query rows read the last real row: computed, never stored
  const float* brow0 = M2D ? bs + min(lr0 + g, nb - 1) * BP : bs;
  const float* brow1 = M2D ? bs + min(lr0 + g + 8, nb - 1) * BP : bs;

  for (int n = 0;; ++n) {
    const int i = wg + n * wgs, h = h0 + i;
    const bool have = i < nh;  // false only for a group without a first head
    if (!have && n > 0) break;
    bf16* qs = tiles + (n % my_sets) * set;
    bf16* ks = qs + rows * kPitch;
    bf16* vs = ks + SP * kPitch;
    const bool ahead = my_sets > 1 && i + wgs < nh;  // the group's next head, one cp.async group
    if (n > 0 && my_sets == 1) {
      stage_qk(i, n);
      cp_async_commit();
      stage_v(i, n);
      cp_async_commit();
    }
    auto prefetch = [&] {  // the group's next head into its other set
      stage_qk(i + wgs, n + 1);
      stage_v(i + wgs, n + 1);
      cp_async_commit();
    };
    // q and k of head i have landed
    if (n == 0)
      cp_async_wait<2>();
    else if (my_sets == 1)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    sync();
    if (ahead && n > 0) prefetch();
    float s[NT][4];
    if (have && active) scores<NT>(qs + lr0 * kPitch, ks, s);
    if (M2D && n == 0) {  // the bias, staged by the whole block
      cp_async_wait<1>();
      __syncthreads();
    }
    // the first heads' loads have the card's bandwidth to themselves: the
    // prefetch starts once their bias is in
    if (ahead && n == 0) prefetch();
    if (have && active) {
      softmax_rows<NT>(brow0, brow1, inv_sqrt_d, s);
      if (dropout) {
        const uint32_t key = mix32(mix32(seed) ^ (uint32_t)(b * heads_total + head_offset + h));
        const uint32_t base[2] = {(uint32_t)((r0 + g) * s_len + 2 * t),
                                  (uint32_t)((r0 + g + 8) * s_len + 2 * t)};
#pragma unroll
        for (int j = 0; j < NT; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const uint32_t bits = mix32(key ^ (base[e >> 1] + 8 * j + (e & 1)));
            s[j][e] = bits >= threshold ? s[j][e] * scale : 0.f;
          }
        }
      }
    }
    if (n == 0 || my_sets == 1) {  // v of head i
      if (ahead) cp_async_wait<1>(); else cp_async_wait<0>();
      sync();
    }
    if (have && active) {
      float acc[8][4] = {};
#pragma unroll
      for (int kc = 0; kc < NW; ++kc) {
        uint32_t pa[4];
        strip_to_a(s, kc, pa);  // probs rounded to v's type
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t vb[4];
          ldsm_x4_trans(vb, vs + (16 * kc + bt_row(lane)) * kPitch + 16 * np + bt_col(lane));
          mma(acc[2 * np], pa, vb[0], vb[1]);
          mma(acc[2 * np + 1], pa, vb[2], vb[3]);
        }
      }
      store_strip(acc, qs + lr0 * kPitch, out, b, h, s_len, n_heads, r0);  // the warp's q rows
    }
    if (i + wgs < nh) sync();  // the set is refilled next or after next
  }
}

// Backward. Block (b, `heads_blk` heads) computing its heads in turn. M2D:
// the bias is 2-D (bias_q == S); a 1-D bias takes one head a block.
template <int W, bool M2D>
__global__ void __launch_bounds__(W * 32)
attn_bwd_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
              const float* __restrict__ bias, const bf16* __restrict__ gy, bf16* __restrict__ dq,
              bf16* __restrict__ dk, bf16* __restrict__ dv, int s_len, int n_heads,
              int heads_total, int head_offset, const long long* __restrict__ seed_ptr,
              uint32_t threshold, float scale, float inv_sqrt_d, int dropout, int heads_blk) {
  const uint32_t seed = dropout ? static_cast<uint32_t>(*seed_ptr) : 0u;  // device-drawn
  constexpr int SP = 16 * W, NT = 2 * W, PP = SP + 8;  // PP: pitch of the pd / ds tiles
  if constexpr (!M2D) heads_blk = 1;
  constexpr int kWords = (4 * NT + 31) / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + SP * kPitch;
  bf16* vs = ks + SP * kPitch;
  bf16* gs = vs + SP * kPitch;
  bf16* pds = gs + SP * kPitch;  // pd, (query, key) row-major
  bf16* dss = pds + SP * PP;     // ds
  float* bs = reinterpret_cast<float*>(dss + SP * PP);  // a 1-D bias row
  const int groups = (n_heads + heads_blk - 1) / heads_blk;
  const int b = blockIdx.x / groups, h0 = blockIdx.x % groups * heads_blk;
  const int nh = M2D ? min(heads_blk, n_heads - h0) : 1;
  // a 2-D bias, pitch PP f32: staged once where the block takes several
  // heads, else for its head over the pd and ds tiles until pd is written
  const bool own = M2D && heads_blk > 1;
  float* b2 = own ? bs : reinterpret_cast<float*>(pds);
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = 16 * (threadIdx.x >> 5);
  const float* bias_b = bias + (long)b * (M2D ? s_len : 1) * s_len;

  for (int i = 0; i < nh; ++i) {
    const int h = h0 + i;
    if (i > 0) __syncthreads();  // the last head's tiles are read no more
    stage_tile(q, qs, b, h, s_len, n_heads, 0, SP, threadIdx.x, blockDim.x);
    stage_tile(k, ks, b, h, s_len, n_heads, 0, SP, threadIdx.x, blockDim.x);
    if (M2D && (i == 0 || !own)) stage_bias_rows(bias_b, b2, s_len, SP, 0, SP);
    cp_async_commit();
    stage_tile(v, vs, b, h, s_len, n_heads, 0, SP, threadIdx.x, blockDim.x);
    stage_tile(gy, gs, b, h, s_len, n_heads, 0, SP, threadIdx.x, blockDim.x);
    cp_async_commit();
    if (!M2D) stage_bias_row(bias_b, bs, s_len, SP);
    cp_async_wait<1>();
    __syncthreads();

    // 1. the warp's strip of undropped p (0 on padded query rows), its keep
    //    bits (bit 4 j + e), and pd into shared memory
    float s[NT][4];
    scores<NT>(qs + r0 * kPitch, ks, s);
    {
      const float* brow0 = M2D ? b2 + (r0 + g) * PP : bs;
      softmax_rows<NT>(brow0, M2D ? brow0 + 8 * PP : bs, inv_sqrt_d, s);
    }
    // every warp has read its 2-D bias rows: pd may overwrite them
    if (M2D && !own) __syncthreads();
    uint32_t keep[kWords];
#pragma unroll
    for (int w = 0; w < kWords; ++w) keep[w] = 0xffffffffu;
    const uint32_t key = mix32(mix32(seed) ^ (uint32_t)(b * heads_total + head_offset + h));
    const uint32_t base[2] = {(uint32_t)((r0 + g) * s_len + 2 * t),
                              (uint32_t)((r0 + g + 8) * s_len + 2 * t)};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int bit = 4 * j + e;
        if (r0 + g + 8 * (e >> 1) >= s_len) s[j][e] = 0.f;
        if (dropout && 8 * j < s_len && mix32(key ^ (base[e >> 1] + 8 * j + (e & 1))) < threshold)
          keep[bit >> 5] &= ~(1u << (bit & 31));
      }
    }
    auto kept = [&](int j, int e) { return (keep[(4 * j + e) >> 5] >> ((4 * j + e) & 31)) & 1u; };
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      float pd[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) pd[e] = dropout ? (kept(j, e) ? s[j][e] * scale : 0.f) : s[j][e];
      *reinterpret_cast<uint32_t*>(pds + (r0 + g) * PP + 8 * j + 2 * t) = pack_bf16(pd[0], pd[1]);
      *reinterpret_cast<uint32_t*>(pds + (r0 + g + 8) * PP + 8 * j + 2 * t) =
          pack_bf16(pd[2], pd[3]);
    }
    cp_async_wait<0>();
    __syncthreads();

    // 2. dp = g v^T a key tile pair at a time, twice: the row sums of dp * p,
    //    then ds = p * (dp - rowsum) / sqrt(d) in place of p
    uint32_t ga[4][4];
#pragma unroll
    for (int kc = 0; kc < 4; ++kc)
      ldsm_x4(ga[kc], gs + (r0 + a_row(lane)) * kPitch + 16 * kc + a_col(lane));
    auto dp_pair = [&](int jp, float (&dp)[2][4]) {
#pragma unroll
      for (int i = 0; i < 2; ++i) dp[i][0] = dp[i][1] = dp[i][2] = dp[i][3] = 0.f;
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) {
        uint32_t vb[4];
        ldsm_x4(vb, vs + (16 * jp + bn_row(lane)) * kPitch + 16 * kc + bn_col(lane));
        mma(dp[0], ga[kc], vb[0], vb[1]);
        mma(dp[1], ga[kc], vb[2], vb[3]);
      }
      if (dropout) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
#pragma unroll
          for (int e = 0; e < 4; ++e) dp[i][e] = kept(2 * jp + i, e) ? dp[i][e] * scale : 0.f;
        }
      }
    };
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int jp = 0; jp < NT / 2; ++jp) {
      float dp[2][4];
      dp_pair(jp, dp);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) rs[e >> 1] += dp[i][e] * s[2 * jp + i][e];
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 1);
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 2);
    }
#pragma unroll
    for (int jp = 0; jp < NT / 2; ++jp) {
      float dp[2][4];
      dp_pair(jp, dp);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float& x = s[2 * jp + i][e];
          x = __fmul_rn(__fmul_rn(x, __fsub_rn(dp[i][e], rs[e >> 1])), inv_sqrt_d);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      *reinterpret_cast<uint32_t*>(dss + (r0 + g) * PP + 8 * j + 2 * t) =
          pack_bf16(s[j][0], s[j][1]);
      *reinterpret_cast<uint32_t*>(dss + (r0 + g + 8) * PP + 8 * j + 2 * t) =
          pack_bf16(s[j][2], s[j][3]);
    }

    // 3. dq = ds k, ds from registers, k rows through ldmatrix.trans
    float acc[8][4] = {};
#pragma unroll
    for (int kc = 0; kc < W; ++kc) {
      uint32_t da[4];
      strip_to_a(s, kc, da);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t kb[4];
        ldsm_x4_trans(kb, ks + (16 * kc + bt_row(lane)) * kPitch + 16 * np + bt_col(lane));
        mma(acc[2 * np], da, kb[0], kb[1]);
        mma(acc[2 * np + 1], da, kb[2], kb[3]);
      }
    }
    __syncthreads();  // pd and ds complete; k and v no longer read
    store_strip(acc, ks + r0 * kPitch, dq, b, h, s_len, n_heads, r0);

    // 4. the warp's 16 key rows c0 = r0: dv = pd^T g and dk = ds^T q
    float dva[8][4] = {}, dka[8][4] = {};
#pragma unroll
    for (int rc = 0; rc < W; ++rc) {
      uint32_t pa[4], da[4];
      ldsm_x4_trans(pa, pds + (16 * rc + bn_row(lane)) * PP + r0 + bn_col(lane));
      ldsm_x4_trans(da, dss + (16 * rc + bn_row(lane)) * PP + r0 + bn_col(lane));
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bb[4];
        ldsm_x4_trans(bb, gs + (16 * rc + bt_row(lane)) * kPitch + 16 * np + bt_col(lane));
        mma(dva[2 * np], pa, bb[0], bb[1]);
        mma(dva[2 * np + 1], pa, bb[2], bb[3]);
        ldsm_x4_trans(bb, qs + (16 * rc + bt_row(lane)) * kPitch + 16 * np + bt_col(lane));
        mma(dka[2 * np], da, bb[0], bb[1]);
        mma(dka[2 * np + 1], da, bb[2], bb[3]);
      }
    }
    store_strip(dva, vs + r0 * kPitch, dv, b, h, s_len, n_heads, r0);
    store_strip(dka, ks + r0 * kPitch, dk, b, h, s_len, n_heads, r0);
  }
}

using FwdBf16 = decltype(&attn_fwd_bf16<1, false>);
using BwdBf16 = decltype(&attn_bwd_bf16<1, false>);

template <bool M2D, int... I>
std::array<FwdBf16, sizeof...(I)> fwd_bf16_table(std::integer_sequence<int, I...>) {
  return {&attn_fwd_bf16<I + 1, M2D>...};
}

template <bool M2D, int... I>
std::array<BwdBf16, sizeof...(I)> bwd_bf16_table(std::integer_sequence<int, I...>) {
  return {&attn_bwd_bf16<I + 1, M2D>...};
}

// ---------------------------------------------------------------------------
// f32: CUDA-core FMA, one row of scores a warp.

constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kPerLane = kMaxSeq / 32;  // key columns each lane owns in a row
constexpr int kPitchF32 = kHeadDim + 1;

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

__host__ __device__ constexpr size_t f32_tile_bytes(int s) {
  return align16((size_t)s * kPitchF32 * sizeof(float));
}

size_t f32_fwd_smem_bytes(int s) {
  return 2 * f32_tile_bytes(s) + (size_t)kWarps * (kHeadDim + s) * sizeof(float);
}

size_t f32_bwd_smem_bytes(int s) {
  return 4 * f32_tile_bytes(s) + align16((size_t)s * s * sizeof(float)) +
         (size_t)s * kPerLane * sizeof(uint32_t);
}

// Stage the (S, d) slice of head h of batch row b into a padded shared tile.
__device__ void load_tile(const float* __restrict__ src, float* dst, int b, int h, int s_len,
                          int n_heads) {
  const long tok = (long)n_heads * kHeadDim;
  for (int idx = threadIdx.x; idx < s_len * kHeadDim; idx += kThreads) {
    const int s = idx / kHeadDim, j = idx % kHeadDim;
    dst[s * kPitchF32 + j] = src[((long)b * s_len + s) * tok + (long)h * kHeadDim + j];
  }
}

// Scores of query row `row` against the lane's key columns, softmax over the
// row: p[i] is the probability of column lane + 32 i (0 past S).
__device__ void softmax_row(const float* qv, const float* ks, const float* brow, int s_len,
                            float inv_sqrt_d, float p[kPerLane]) {
  const int lane = threadIdx.x & 31;
  float mx = -INFINITY;
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const int col = lane + 32 * i;
    float acc = -INFINITY;
    if (col < s_len) {
      const float* kr = ks + col * kPitchF32;
      acc = 0.f;
#pragma unroll 16
      for (int j = 0; j < kHeadDim; ++j) acc = fmaf(qv[j], kr[j], acc);
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

__global__ void __launch_bounds__(kThreads)
attn_fwd_f32(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
             const float* __restrict__ bias, float* __restrict__ out, int s_len, int n_heads,
             int bias_q, int heads_total, int head_offset,
             const long long* __restrict__ seed_ptr, uint32_t threshold, float scale,
             float inv_sqrt_d, int dropout) {
  const uint32_t seed = dropout ? static_cast<uint32_t>(*seed_ptr) : 0u;  // device-drawn
  extern __shared__ __align__(16) unsigned char smem[];
  const int bh = blockIdx.x;
  const int b = bh / n_heads, h = bh % n_heads;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* ks = reinterpret_cast<float*>(smem);
  float* vs = reinterpret_cast<float*>(smem + f32_tile_bytes(s_len));
  float* qrow = reinterpret_cast<float*>(smem + 2 * f32_tile_bytes(s_len)) +
                warp * (kHeadDim + s_len);
  float* prow = qrow + kHeadDim;
  load_tile(k, ks, b, h, s_len, n_heads);
  load_tile(v, vs, b, h, s_len, n_heads);
  __syncthreads();

  const uint32_t key = mix32(mix32(seed) ^ (uint32_t)(b * heads_total + head_offset + h));
  const long tok = (long)n_heads * kHeadDim;
  for (int row = warp; row < s_len; row += kWarps) {
    const long g = ((long)b * s_len + row) * tok + (long)h * kHeadDim;
    qrow[lane] = q[g + lane];
    qrow[lane + 32] = q[g + lane + 32];
    __syncwarp();
    const float* brow = bias + ((long)b * bias_q + (bias_q == 1 ? 0 : row)) * s_len;
    float p[kPerLane];
    softmax_row(qrow, ks, brow, s_len, inv_sqrt_d, p);
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      const int col = lane + 32 * i;
      if (col >= s_len) continue;
      float pd = p[i];
      if (dropout) {
        const uint32_t bits = mix32(key ^ (uint32_t)(row * s_len + col));
        pd = bits >= threshold ? pd * scale : 0.f;
      }
      prow[col] = pd;
    }
    __syncwarp();
    float a0 = 0.f, a1 = 0.f;
    for (int c = 0; c < s_len; ++c) {
      const float pc = prow[c];
      a0 = fmaf(pc, vs[c * kPitchF32 + lane], a0);
      a1 = fmaf(pc, vs[c * kPitchF32 + lane + 32], a1);
    }
    out[g + lane] = a0;
    out[g + lane + 32] = a1;
    __syncwarp();
  }
}

__global__ void __launch_bounds__(kThreads)
attn_bwd_f32(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
             const float* __restrict__ bias, const float* __restrict__ gy, float* __restrict__ dq,
             float* __restrict__ dk, float* __restrict__ dv, int s_len, int n_heads, int bias_q,
             int heads_total, int head_offset, const long long* __restrict__ seed_ptr,
             uint32_t threshold, float scale, float inv_sqrt_d, int dropout) {
  const uint32_t seed = dropout ? static_cast<uint32_t>(*seed_ptr) : 0u;  // device-drawn
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int P = kPitchF32;
  const int bh = blockIdx.x;
  const int b = bh / n_heads, h = bh % n_heads;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t tb = f32_tile_bytes(s_len);
  float* qs = reinterpret_cast<float*>(smem);
  float* ks = reinterpret_cast<float*>(smem + tb);
  float* vs = reinterpret_cast<float*>(smem + 2 * tb);
  float* gs = reinterpret_cast<float*>(smem + 3 * tb);
  float* ps = reinterpret_cast<float*>(smem + 4 * tb);  // p, then ds, row-major (S, S)
  uint32_t* keep_bits =
      reinterpret_cast<uint32_t*>(smem + 4 * tb + align16((size_t)s_len * s_len * sizeof(float)));
  load_tile(q, qs, b, h, s_len, n_heads);
  load_tile(k, ks, b, h, s_len, n_heads);
  load_tile(v, vs, b, h, s_len, n_heads);
  load_tile(gy, gs, b, h, s_len, n_heads);
  __syncthreads();

  // 1. undropped probabilities and the keep mask (one bit per element)
  const uint32_t key = mix32(mix32(seed) ^ (uint32_t)(b * heads_total + head_offset + h));
  for (int row = warp; row < s_len; row += kWarps) {
    const float* brow = bias + ((long)b * bias_q + (bias_q == 1 ? 0 : row)) * s_len;
    float p[kPerLane];
    softmax_row(qs + row * P, ks, brow, s_len, inv_sqrt_d, p);
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
      acc = fmaf(pd, gs[r * P + j], acc);
    }
    dv[((long)b * s_len + c) * tok + (long)h * kHeadDim + j] = acc;
  }
  __syncthreads();

  // 3. ds over each row (in place of p), then dq[r, j] = sum_c ds[r, c] k[c, j]
  for (int row = warp; row < s_len; row += kWarps) {
    const float* gr = gs + row * P;
    float dp[kPerLane];
    float rsum = 0.f;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      const int col = lane + 32 * i;
      dp[i] = 0.f;
      if (col >= s_len) continue;
      const float* vr = vs + col * P;
      float acc = 0.f;
#pragma unroll 16
      for (int j = 0; j < kHeadDim; ++j) acc = fmaf(gr[j], vr[j], acc);
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
      a0 = fmaf(ds, ks[c * P + lane], a0);
      a1 = fmaf(ds, ks[c * P + lane + 32], a1);
    }
    const long g = ((long)b * s_len + row) * tok + (long)h * kHeadDim;
    dq[g + lane] = a0;
    dq[g + lane + 32] = a1;
    __syncwarp();
  }
  __syncthreads();

  // 4. dk[c, j] = sum_r ds[r, c] q[r, j]
  for (int idx = threadIdx.x; idx < s_len * kHeadDim; idx += kThreads) {
    const int c = idx / kHeadDim, j = idx % kHeadDim;
    float acc = 0.f;
    for (int r = 0; r < s_len; ++r) acc = fmaf(ps[r * s_len + c], qs[r * P + j], acc);
    dk[((long)b * s_len + c) * tok + (long)h * kHeadDim + j] = acc;
  }
}

// ---------------------------------------------------------------------------

bool shape_ok(int b, int s, int h, int d, int bias_q, int heads_total, int head_offset) {
  return b > 0 && h > 0 && s > 0 && s <= kMaxSeq && d == kHeadDim && (bias_q == 1 || bias_q == s) &&
         head_offset >= 0 && (long)head_offset + h <= heads_total &&
         (long)b * heads_total <= 0x7fffffffL && (long)s * s < 0x7fffffffL;
}

int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || n < 1)
    return 132;  // an H100 SXM's
  return n;
}

// The fewest heads a block that keep a grid of b * ceil(h / heads) * parts
// blocks within one wave of one block an SM, spread evenly over a row's heads.
int wave_heads(int b, int h, int parts, int sms) {
  const long units = (long)b * h * parts;
  const int heads = (int)std::min<long>(h, std::max<long>(1, (units + sms - 1) / sms));
  const int row_blocks = (h + heads - 1) / heads;
  return (h + row_blocks - 1) / row_blocks;
}

// The cut of a bf16 forward launch. A 1-D bias keeps one block a head, all
// its rows. A 2-D bias, which all heads of a batch row share, is staged
// once a block for the heads of one wave of blocks, computed two at a time
// by two warp groups of a head's rows, with a second q / k / v set for a
// group's next head where it fits (tools/k2_variants.py: B 32 x 12 heads at
// S 120 takes {3, 1, 2, 2}). Where the SM would hold two heads at most, each
// head's rows are cut in two and each half taken by a group of its own, up
// to the launch bound's 2 S_pad / 16 warps (B 16: {3, 2, 1, 3}).
FwdPlan plan_fwd(int b, int h, int s, int bias_q) {
  if (bias_q == 1) return {1, 1, 1, 1};
  const int sms = sm_count(), nw = seq_warps(s);
  const int max_warps = nw <= 8 ? 2 * nw : nw;  // attn_fwd_bf16's launch bound
  FwdPlan p{wave_heads(b, h, 1, sms), 1, 1, 1};
  const int halves = wave_heads(b, h, 2, sms);
  if (p.heads <= 2 && nw > 1 && halves * part_warps(nw, 2) <= max_warps)
    p = {halves, 2, 1, halves};
  else
    p.groups = std::min(p.heads, 2);
  while (p.groups > 1 && p.groups * part_warps(nw, p.parts) > max_warps) --p.groups;
  p.buffers = p.heads > p.groups ? 2 : 1;
  if (bf16_fwd_smem_bytes(s, bias_q, p) > (size_t)kMaxSmem) p.buffers = 1;
  if (bf16_fwd_smem_bytes(s, bias_q, p) > (size_t)kMaxSmem) p.groups = 1;
  return p;
}

// The heads a backward block takes in turn: one, or, for a 2-D bias, those
// of one wave of blocks where the bias fits in a region of its own beside
// the tiles (S_pad <= 128), so that the block stages it once.
int plan_bwd(int b, int h, int s, int bias_q) {
  const int heads = bias_q == 1 ? 1 : wave_heads(b, h, 1, sm_count());
  return bf16_bwd_smem_bytes(s, bias_q, heads) <= (size_t)kMaxSmem ? heads : 1;
}

size_t smem_bytes(int dtype, int backward, int s) {
  if (dtype == 0)  // the forward at its largest: a 2-D bias, one head a block
    return backward ? bf16_bwd_smem_bytes(s, 1, 1) : bf16_fwd_smem_bytes(s, s, {1, 1, 1, 1});
  return backward ? f32_bwd_smem_bytes(s) : f32_fwd_smem_bytes(s);
}

// Raise the kernel's dynamic shared-memory limit to `smem`, then launch.
template <typename Kernel, typename... Args>
int launch(Kernel kernel, unsigned grid, unsigned threads, size_t smem, cudaStream_t stream,
           Args... args) {
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(reinterpret_cast<const void*>(kernel),
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, threads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = bf16 (tensor-core kernel), 1 = f32 (CUDA-core kernel); q, k, v,
// out alike. The H heads are [head_offset, head_offset + H) of heads_total
// for the dropout hash (H and 0 for a whole layer). q, k, v, out: (B, S, H, d)
// row-major, bf16 pointers 16-byte aligned; bias: f32 (B, bias_q, S).
// dropout != 0 applies the keep mask of (*seed, threshold) and scales kept
// probabilities by `scale`; seed points to one int64 on the card and is not
// read (it may be null) when dropout is 0. Returns a cudaError_t code.
int attn_fwd_launch(int dtype, const void* q, const void* k, const void* v, const float* bias,
                    void* out, int b, int s, int h, int d, int bias_q, int heads_total,
                    int head_offset, const long long* seed, unsigned threshold, float scale,
                    float inv_sqrt_d, int dropout, void* stream) {
  if (!shape_ok(b, s, h, d, bias_q, heads_total, head_offset)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned grid = (unsigned)(b * h);
  if (dtype == 0) {
    static const auto keys = fwd_bf16_table<false>(std::make_integer_sequence<int, kMaxWarps>());
    static const auto rows = fwd_bf16_table<true>(std::make_integer_sequence<int, kMaxWarps>());
    const int w = seq_warps(s);
    const FwdPlan p = plan_fwd(b, h, s, bias_q);
    const unsigned blocks = (unsigned)(b * ((h + p.heads - 1) / p.heads) * p.parts);
    return launch((bias_q == 1 ? keys : rows)[w - 1], blocks,
                  32 * part_warps(w, p.parts) * p.groups,
                  bf16_fwd_smem_bytes(s, bias_q, p), st, static_cast<const bf16*>(q),
                  static_cast<const bf16*>(k), static_cast<const bf16*>(v), bias,
                  static_cast<bf16*>(out), s, h, heads_total, head_offset, seed,
                  (uint32_t)threshold, scale, inv_sqrt_d, dropout, p.heads, p.parts, p.buffers,
                  p.groups);
  }
  if (dtype == 1)
    return launch(attn_fwd_f32, grid, kThreads, f32_fwd_smem_bytes(s), st,
                  static_cast<const float*>(q), static_cast<const float*>(k),
                  static_cast<const float*>(v), bias, static_cast<float*>(out), s, h, bias_q,
                  heads_total, head_offset, seed, (uint32_t)threshold, scale, inv_sqrt_d,
                  dropout);
  return (int)cudaErrorInvalidValue;
}

// The same arguments plus g (the cotangent of out) and the three outputs
// dq, dk, dv, all (B, S, H, d) in the input type.
int attn_bwd_launch(int dtype, const void* q, const void* k, const void* v, const float* bias,
                    const void* g, void* dq, void* dk, void* dv, int b, int s, int h, int d,
                    int bias_q, int heads_total, int head_offset, const long long* seed,
                    unsigned threshold, float scale, float inv_sqrt_d, int dropout,
                    void* stream) {
  if (!shape_ok(b, s, h, d, bias_q, heads_total, head_offset)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned grid = (unsigned)(b * h);
  if (dtype == 0) {
    static const auto keys = bwd_bf16_table<false>(std::make_integer_sequence<int, kMaxWarps>());
    static const auto rows = bwd_bf16_table<true>(std::make_integer_sequence<int, kMaxWarps>());
    const int w = seq_warps(s), heads = plan_bwd(b, h, s, bias_q);
    return launch((bias_q == 1 ? keys : rows)[w - 1], (unsigned)(b * ((h + heads - 1) / heads)),
                  32 * w,
                  bf16_bwd_smem_bytes(s, bias_q, heads), st,
                  static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                  static_cast<const bf16*>(v), bias, static_cast<const bf16*>(g),
                  static_cast<bf16*>(dq), static_cast<bf16*>(dk), static_cast<bf16*>(dv), s, h,
                  heads_total, head_offset, seed, (uint32_t)threshold, scale, inv_sqrt_d,
                  dropout, heads);
  }
  if (dtype == 1)
    return launch(attn_bwd_f32, grid, kThreads, f32_bwd_smem_bytes(s), st,
                  static_cast<const float*>(q), static_cast<const float*>(k),
                  static_cast<const float*>(v), bias, static_cast<const float*>(g),
                  static_cast<float*>(dq), static_cast<float*>(dk), static_cast<float*>(dv), s, h,
                  bias_q, heads_total, head_offset, seed, (uint32_t)threshold, scale,
                  inv_sqrt_d, dropout);
  return (int)cudaErrorInvalidValue;
}

// Shared memory (bytes) the forward / backward kernel needs at sequence
// length s: the wrapper refuses shapes above the opt-in limit.
unsigned long attn_smem_bytes(int dtype, int backward, int s) {
  return smem_bytes(dtype, backward, s);
}

const char* attn_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
