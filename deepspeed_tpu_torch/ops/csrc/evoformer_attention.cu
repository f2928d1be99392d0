// Evoformer attention (DS4Sci_EvoformerAttention): the biased flash forward
// and its backward with both bias gradients, for Hopper (sm_90a).
//
// Plain C interface (loaded with ctypes by ops/_build.py); every launcher
// returns the cudaError_t of its launch and never synchronises.
//
// What it replaces (deepspeed_tpu/ops/pallas/evoformer_attention.py):
//   ds_evo_fwd      -> _evo_fwd_impl (:113): out and lse = m + log(l)
//   ds_evo_bwd_dq   -> _evo_bwd_impl's dq_kernel (:231)
//   (each entry point has an _fp32 twin: the route of fp32 q/k/v)
//   ds_evo_bwd_dkdv -> dkdv_kernel (:265) and db1_kernel (:346): one CTA per
//                      (key tile, sequence row n) walks every head and query
//                      tile, writes dk / dv per head and sums db1 over
//                      (head, query) in registers, written once
//   ds_evo_bwd_db2  -> db2_kernel (:306): one CTA per (query tile, key tile,
//                      head, group, row chunk) walks its chunk of the
//                      group's n_seq rows; a second pass sums the chunks
// The TPU package runs db1 and db2 as passes of their own only because a
// TPU grid runs in order and an output block accumulates across consecutive
// revisits alone. Here every sum is a loop inside one CTA, or a fixed-order
// sum of such loops' partials (db2's row chunks): no atomics, and the
// results do not depend on scheduling.
//
// Semantics copied from the TPU kernels. q, k, v, out, dout are [N, R, H, D]
// (read in that layout, no transposes); bias1 [N, R] fp32 (the mask bias)
// and bias2 [G, H, R, R] fp32 (the pair bias, shared by the n_seq = N / G
// rows of a group: row n reads group n / n_seq) may each be absent.
// Forward: q is pre-scaled by 1/sqrt(D) (:145); s = (q.k + b2) + b1 in that
// order (:149); the online softmax starts at m = -1e30, l = 0; the output is
// acc / max(l, 1e-30) and lse = m + log(max(l, 1e-30)) (:160-162), so a row
// whose biases are all -inf writes 0. The tensor-core forward takes q
// unscaled (the products read the 16-bit inputs as they are) and scales the
// fp32 score, scale * (q.k): one fp32 rounding away from the TPU kernel's
// (q * scale).k, far inside the bf16 output's tolerance. Backward (block_math, :214-228):
// s = scale * (q.k) + b2 + b1, p = exp(s - lse), delta = rowsum(dO * O) from
// the tiles the CTA loads, dp = dO.v, ds = p * (dp - delta); dq = scale *
// sum_k ds k, dv = sum_q p^T dO, dk = scale * sum_q ds^T q, db2[g] = sum over
// the group's rows of ds, db1[n, k] = sum over (head, query) of ds. Ragged R:
// positions past R are masked inside the kernels (zero-loaded tiles, p = 0),
// so any R >= 1 works.
//
// What bounds it on the H100: at the Evoformer's widths (D 32, R 384-512)
// each kernel does 2-8 D FLOPs per (row, head, query, key) over inputs of
// about 4-6 x N R H D bf16 elements, so the data bound is the bytes, and the
// tensor cores' operations bound come close to it. Below both lies one more
// floor: every kernel exponentiates each (row, head, query, key) once, and
// at MUFU's 16 a clock an SM the MSA-row call's 604 M exponentials take
// ~0.16 ms. Two routes, chosen by q/k/v's dtype
// (ops/evoformer_attention.py: route):
// - bf16 / fp16: every kernel runs every product on the tensor cores,
//   mma.sync m16n8k16 with fp32 accumulators from 16-bit [64][D + 8]
//   shared tiles filled by a two-stage cp.async ring (the helpers of
//   mma_sm90.cuh, as the flash kernels). 128 threads, four warps of 16 rows.
//   * forward (evo_fwd_mma_kernel) and dq (evo_bwd_dq_mma_kernel), after
//     the flash forward and dq: a warp's rows are queries; q (and for dq
//     O and dO, from which delta comes, each quad lane D / 4 columns) are
//     staged once; K, V, the pair-bias tile [64 q][64 k] and b1's 64 keys
//     stream through the ring. S = Q.K^T (and dq's dP = dO.V^T) straight
//     from the inputs; the forward's online softmax stays in registers and
//     P enters P.V as a split hi + lo pair; dq's dS = P (dP - delta)
//     enters dS.K the same way (K read with ldmatrix.trans), each tile pair
//     summed from zero and added once. The pair-bias tile is read in the
//     query-row fragment layout as float2 pairs from rows of 72 floats
//     (kLBQ: each half-warp's 16 pairs fall in 32 different banks; 68, the
//     key-row layout's pad, would put two in one bank). A CTA serves one
//     row n: with kBiasRows 2 a d 32 CTA walks two rows of one group with
//     each staged bias tile, halving the bias's L2 reads (twice the bytes
//     of a row's K and V per CTA), and runs slower: three one-row CTAs an
//     SM beat two two-row ones, so occupancy, not L2, sets the time. dq
//     walks each key tile in two halves of 32 keys to stay under its
//     register cap.
//   * db2 (evo_bwd_db2_mma_kernel): a warp's rows are queries; s = q.k^T
//     and dp = dO.v^T straight from the inputs (exact products), ds summed
//     over the chunk's rows in the C-fragment layout. The pair-bias tile is
//     the same for every row of a group: it is read once, into registers.
//     Each row's five tiles (q, O, dO; k, v) and its lse and b1 stream
//     through the ring, the next row's in flight while this one computes;
//     delta comes from the O and dO tiles (each quad lane D / 4 columns).
//     The rows of a group are split into chunks (the wrapper's
//     db2_row_chunks) so that the grid gives every SM several CTAs; each
//     chunk's fp32 partial goes to a scratch [chunks, G, H, R, R], and
//     evo_db2_sum_kernel adds them in chunk order (one chunk writes db2).
//   * dk/dv (evo_bwd_dkdv_mma_kernel), after the flash dk/dv kernel: a
//     warp's rows are keys, S^T = K.Q^T and dP^T = V.dO^T, so P^T and dS^T
//     are the A fragments of dv += P^T dO and dk += dS^T Q as split hi + lo
//     pairs (read with ldmatrix.trans), each tile pair summed from zero and
//     added once. The CTA walks (head, query tile) items; K and V of the
//     next head and the next item's q, O, dO and lse are in flight while
//     the current item computes. The pair bias [64 q][64 k] is staged in
//     shared memory with coalesced copies along k and read in the key-row
//     fragment layout (a row of 68 floats: conflict-free); its one buffer
//     is refilled for the next item as soon as every warp has its p.
//     db1 stays in registers and is reduced over the quad at the end.
//   At d 32 (the Evoformer's width) an item is short (a quarter of the
//   flash kernels' products per 64 x 64 tile pair, the same exponentials,
//   masks and barriers), so the one-row kernels are held to 170 registers
//   for three CTAs an SM: the latencies of one CTA hide behind the others'.
//   p = exp2((x - lse) log2 e), as in the flash kernels.
// - fp32: the first version, on the CUDA cores in fp32 (67 TFLOP/s peak),
//   from fp32 tiles of 64 query rows x 64 key rows staged in shared memory;
//   each of 256 threads owns a 4 x 4 block of the score tile (rows
//   ty + 16 i, keys tx + 16 j) and D / 16 rows of one float4 column of the
//   output tile. Its tolerance (2^-16 relative) is beyond what bf16 or TF32
//   tensor-core products can hold. Entry points ds_evo_*_fp32.
//
// Offsets are int64 throughout.

#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "mma_sm90.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;        // query rows per tile
constexpr int kBK = 64;        // key rows per tile
constexpr int kLP = kBK + 4;   // padded row of a [kBQ][kBK] probability tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f(float x) { return x; }
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <>
__device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half(x);
}
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}

// 8 consecutive elements (16 bytes of bf16 / fp16, 32 of fp32) as floats.
template <typename T>
__device__ __forceinline__ void load8(const T* p, float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const T* h = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) out[i] = to_f(h[i]);
}
template <>
__device__ __forceinline__ void load8<float>(const float* p, float* out) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

__device__ __forceinline__ void store8(float* dst, const float* f) {
  reinterpret_cast<float4*>(dst)[0] = make_float4(f[0], f[1], f[2], f[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(f[4], f[5], f[6], f[7]);
}

// Every kernel takes this struct by value. Keep it as it is: two more
// fields here made ptxas compile the fp32 route's forward to 104 registers
// instead of 122 and its forward and dq run 8-9% slower on the H100, so a
// tensor-core kernel takes any extra argument as a parameter of its own.
struct Args {
  const void* q;     // [N, R, H, D]
  const void* k;
  const void* v;
  const void* o;     // [N, R, H, D] (backward)
  const void* dout;  // [N, R, H, D] (backward)
  const float* b1;   // [N, R] or null
  const float* b2;   // [G, H, R, R] or null
  float* lse;        // [N, H, R] (written by fwd, read by the backward)
  void* out;         // fwd: out; dq pass: dq   [N, R, H, D]
  void* dk;          // [N, R, H, D]
  void* dv;
  float* db1;        // [N, R] or null (dk/dv pass)
  float* db2;        // [G, H, R, R] (db2 pass)
  int N, R, H, n_seq;
  float scale;
};

// (s + b2) + b1 at a real (query, key) position, the TPU kernel's order.
__device__ __forceinline__ float biased(const Args& a, float s, int n, int h, int qpos, int kpos) {
  if (a.b2 != nullptr)
    s += a.b2[(((long long)(n / a.n_seq) * a.H + h) * a.R + qpos) * a.R + kpos];
  if (a.b1 != nullptr) s += a.b1[(long long)n * a.R + kpos];
  return s;
}

// Element offset of (n, row 0, head h, column 0); rows are H * D apart.
template <int D>
__device__ __forceinline__ long long head_base(const Args& a, int n, int h) {
  return (long long)n * a.R * a.H * D + (long long)h * D;
}

// Stage 64 rows from row r0 of one head (row stride `ld` elements) into an
// fp32 [64][D + 4] tile, times `mul`; rows past R are zero.
template <int D, typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src, long long ld, int r0, int R,
                                          float mul) {
  constexpr int LD = D + 4;
  for (int c = threadIdx.x; c < kBQ * (D / 8); c += kThreads) {
    const int r = c / (D / 8), c8 = (c % (D / 8)) * 8;
    float f[8];
    if (r0 + r < R) {
      load8(src + (long long)(r0 + r) * ld + c8, f);
#pragma unroll
      for (int e = 0; e < 8; ++e) f[e] *= mul;
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) f[e] = 0.f;
    }
    store8(dst + r * LD + c8, f);
  }
}

// The backward's query side of one (n, head, query tile): q and dO as fp32
// tiles, lse, and delta = rowsum(dO * O) from the output tile (block_math's
// :225), each row reduced over the D / 8 consecutive threads that load it.
template <int D, typename T>
__device__ __forceinline__ void load_q_side(const Args& a, int n, int h, int q0, float* sQ,
                                            float* sdO, float* sLse, float* sDelta) {
  constexpr int LD = D + 4;
  const long long ld = (long long)a.H * D;
  const long long base = head_base<D>(a, n, h);
  const T* qp = reinterpret_cast<const T*>(a.q) + base;
  const T* op = reinterpret_cast<const T*>(a.o) + base;
  const T* dp = reinterpret_cast<const T*>(a.dout) + base;
  const float* lse = a.lse + ((long long)n * a.H + h) * a.R;
  for (int c = threadIdx.x; c < kBQ * (D / 8); c += kThreads) {
    const int r = c / (D / 8), c8 = (c % (D / 8)) * 8;
    const int qpos = q0 + r;
    float fq[8], fo[8], fd[8];
    if (qpos < a.R) {
      load8(qp + qpos * ld + c8, fq);
      load8(op + qpos * ld + c8, fo);
      load8(dp + qpos * ld + c8, fd);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) fq[e] = fo[e] = fd[e] = 0.f;
    }
    float part = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) part += fd[e] * fo[e];
#pragma unroll
    for (int off = D / 16; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
    store8(sQ + r * LD + c8, fq);
    store8(sdO + r * LD + c8, fd);
    if (c % (D / 8) == 0) {
      sDelta[r] = part;
      sLse[r] = qpos < a.R ? lse[qpos] : 0.f;
    }
  }
}

// acc[i][j] += sum_d A[ty + 16 i][d] * B[tx + 16 j][d] over fp32 tiles of
// row length D + 4.
template <int D>
__device__ __forceinline__ void tile_dot(float (&acc)[4][4], const float* A, const float* Bm,
                                         int ty, int tx) {
  constexpr int LD = D + 4;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = *reinterpret_cast<const float4*>(A + (ty + 16 * i) * LD + d);
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = *reinterpret_cast<const float4*>(Bm + (tx + 16 * j) * LD + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][j] = fmaf(av[i].x, bv[j].x, acc[i][j]);
        acc[i][j] = fmaf(av[i].y, bv[j].y, acc[i][j]);
        acc[i][j] = fmaf(av[i].z, bv[j].z, acc[i][j]);
        acc[i][j] = fmaf(av[i].w, bv[j].w, acc[i][j]);
      }
  }
}

// The output side: thread tid owns the float4 at column out_col(tid) of the
// D / 16 rows out_row(tid, i) of a [64][D] tile.
template <int D>
__device__ __forceinline__ int out_col(int tid) { return (tid % (D / 4)) * 4; }
template <int D>
__device__ __forceinline__ int out_row(int tid, int i) {
  return tid / (D / 4) + (kThreads / (D / 4)) * i;
}

// out[i] += sum_r W * M[r][col] over the 64 rows r, with W = W[row_i][r]
// or, transposed, W[r][row_i] ([64][kLP] tiles).
template <int D, bool TRANS>
__device__ __forceinline__ void tile_mm(float4 (&out)[D / 16], const float* W, const float* M,
                                        int tid) {
  constexpr int LD = D + 4;
  const int col = out_col<D>(tid);
#pragma unroll 4
  for (int r = 0; r < 64; ++r) {
    const float4 mv = *reinterpret_cast<const float4*>(M + r * LD + col);
#pragma unroll
    for (int i = 0; i < D / 16; ++i) {
      const int row = out_row<D>(tid, i);
      const float w = TRANS ? W[r * kLP + row] : W[row * kLP + r];
      out[i].x = fmaf(w, mv.x, out[i].x);
      out[i].y = fmaf(w, mv.y, out[i].y);
      out[i].z = fmaf(w, mv.z, out[i].z);
      out[i].w = fmaf(w, mv.w, out[i].w);
    }
  }
}

// Store the thread's rows of a [64][D] tile from row r0 of one head, times
// `mul`; rows past R are not written.
template <int D, typename T>
__device__ __forceinline__ void store_rows(void* dst, long long base, long long ld, int r0, int R,
                                           const float4 (&acc)[D / 16], float mul, int tid) {
  T* p = reinterpret_cast<T*>(dst) + base;
  const int col = out_col<D>(tid);
#pragma unroll
  for (int i = 0; i < D / 16; ++i) {
    const int row = r0 + out_row<D>(tid, i);
    if (row >= R) continue;
    T* q = p + (long long)row * ld + col;
    q[0] = from_f<T>(acc[i].x * mul);
    q[1] = from_f<T>(acc[i].y * mul);
    q[2] = from_f<T>(acc[i].z * mul);
    q[3] = from_f<T>(acc[i].w * mul);
  }
}

template <int D>
__device__ __forceinline__ void zero(float4 (&acc)[D / 16]) {
#pragma unroll
  for (int i = 0; i < D / 16; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
}

// ---------------------------------------------------------------------------
// forward: one CTA per (query tile, head, row n), walking the key tiles
// ---------------------------------------------------------------------------
template <int D, typename T>
__global__ void __launch_bounds__(kThreads) evo_fwd_kernel(const Args a) {
  constexpr int LD = D + 4;
  const int nqt = (a.R + kBQ - 1) / kBQ;
  const int qt = blockIdx.x % nqt, h = (blockIdx.x / nqt) % a.H, n = blockIdx.x / nqt / a.H;
  const int q0 = qt * kBQ;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;                // [kBQ][LD], pre-scaled q
  float* sK = sQ + kBQ * LD;       // [kBK][LD]
  float* sV = sK + kBK * LD;       // [kBK][LD]
  float* sP = sV + kBK * LD;       // [kBQ][kLP]
  float* sRow = sP + kBQ * kLP;    // [kBQ]: alpha per row, then max(l, 1e-30)

  const long long ld = (long long)a.H * D;
  const long long base = head_base<D>(a, n, h);
  const T* kp = reinterpret_cast<const T*>(a.k) + base;
  const T* vp = reinterpret_cast<const T*>(a.v) + base;
  load_tile<D, T>(sQ, reinterpret_cast<const T*>(a.q) + base, ld, q0, a.R, a.scale);

  float m[4], l[4];
  float4 acc[D / 16];
  zero<D>(acc);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
  }
  for (int k0 = 0; k0 < a.R; k0 += kBK) {
    __syncthreads();  // the previous tile's readers of sK, sV, sP and sRow are done
    load_tile<D, T>(sK, kp, ld, k0, a.R, 1.f);
    load_tile<D, T>(sV, vp, ld, k0, a.R, 1.f);
    __syncthreads();
    float s[4][4] = {};
    tile_dot<D>(s, sQ, sK, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i, qpos = q0 + r;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        s[i][j] = (qpos < a.R && kpos < a.R) ? biased(a, s[i][j], n, h, qpos, kpos) : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // a key past R is not a position: it never enters the sums
        const float p = k0 + tx + 16 * j < a.R ? expf(s[i][j] - m_new) : 0.f;
        sP[r * kLP + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
      if (tx == 0) sRow[r] = alpha;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < D / 16; ++i) {
      const float alpha = sRow[out_row<D>(tid, i)];
      acc[i].x *= alpha;
      acc[i].y *= alpha;
      acc[i].z *= alpha;
      acc[i].w *= alpha;
    }
    tile_mm<D, false>(acc, sP, sV, tid);
  }
  __syncthreads();  // every reader of sRow (as alpha) is done
  float* lse = a.lse + ((long long)n * a.H + h) * a.R;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const float l_safe = fmaxf(l[i], 1e-30f);
    if (tx == 0) {
      sRow[r] = l_safe;
      if (q0 + r < a.R) lse[q0 + r] = m[i] + logf(l_safe);
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < D / 16; ++i) {
    const float l_safe = sRow[out_row<D>(tid, i)];
    acc[i].x /= l_safe;
    acc[i].y /= l_safe;
    acc[i].z /= l_safe;
    acc[i].w /= l_safe;
  }
  store_rows<D, T>(a.out, base, ld, q0, a.R, acc, 1.f, tid);
}

// p and ds of one (query tile, key tile) pair, rows ty + 16 i, keys
// tx + 16 j; positions past R get p = 0. Returns ds in ds[i][j].
template <int D>
__device__ __forceinline__ void tile_probs(const Args& a, int n, int h, int q0, int k0,
                                           const float* sQ, const float* sdO, const float* sK,
                                           const float* sV, const float* sLse,
                                           const float* sDelta, float (&p)[4][4],
                                           float (&ds)[4][4], int ty, int tx) {
  float s[4][4] = {}, dp[4][4] = {};
  tile_dot<D>(s, sQ, sK, ty, tx);
  tile_dot<D>(dp, sdO, sV, ty, tx);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i, qpos = q0 + r;
    const float lse = sLse[r], delta = sDelta[r];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kpos = k0 + tx + 16 * j;
      const bool ok = qpos < a.R && kpos < a.R;
      p[i][j] = ok ? expf(biased(a, a.scale * s[i][j], n, h, qpos, kpos) - lse) : 0.f;
      ds[i][j] = p[i][j] * (dp[i][j] - delta);
    }
  }
}

// ---------------------------------------------------------------------------
// dq: one CTA per (query tile, head, row n), walking the key tiles
// ---------------------------------------------------------------------------
template <int D, typename T>
__global__ void __launch_bounds__(kThreads) evo_bwd_dq_kernel(const Args a) {
  constexpr int LD = D + 4;
  const int nqt = (a.R + kBQ - 1) / kBQ;
  const int qt = blockIdx.x % nqt, h = (blockIdx.x / nqt) % a.H, n = blockIdx.x / nqt / a.H;
  const int q0 = qt * kBQ;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;
  float* sdO = sQ + kBQ * LD;
  float* sK = sdO + kBQ * LD;
  float* sV = sK + kBK * LD;
  float* sdS = sV + kBK * LD;  // [kBQ][kLP]
  float* sLse = sdS + kBQ * kLP;
  float* sDelta = sLse + kBQ;

  load_q_side<D, T>(a, n, h, q0, sQ, sdO, sLse, sDelta);
  const long long ld = (long long)a.H * D;
  const long long base = head_base<D>(a, n, h);
  const T* kp = reinterpret_cast<const T*>(a.k) + base;
  const T* vp = reinterpret_cast<const T*>(a.v) + base;
  float4 dq[D / 16];
  zero<D>(dq);
  for (int k0 = 0; k0 < a.R; k0 += kBK) {
    __syncthreads();
    load_tile<D, T>(sK, kp, ld, k0, a.R, 1.f);
    load_tile<D, T>(sV, vp, ld, k0, a.R, 1.f);
    __syncthreads();
    float p[4][4], ds[4][4];
    tile_probs<D>(a, n, h, q0, k0, sQ, sdO, sK, sV, sLse, sDelta, p, ds, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sdS[(ty + 16 * i) * kLP + tx + 16 * j] = ds[i][j];
    __syncthreads();
    tile_mm<D, false>(dq, sdS, sK, tid);  // dq[q] += sum_k ds[q][k] k[k]
  }
  store_rows<D, T>(a.out, base, ld, q0, a.R, dq, a.scale, tid);
}

// ---------------------------------------------------------------------------
// dk / dv (and db1): one CTA per (key tile, row n), walking heads and their
// query tiles; db1's sum over (head, query) stays in registers
// ---------------------------------------------------------------------------
template <int D, typename T>
__global__ void __launch_bounds__(kThreads) evo_bwd_dkdv_kernel(const Args a) {
  constexpr int LD = D + 4;
  const int nkt = (a.R + kBK - 1) / kBK;
  const int kt = blockIdx.x % nkt, n = blockIdx.x / nkt;
  const int k0 = kt * kBK;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  extern __shared__ __align__(16) float smem[];
  float* sK = smem;
  float* sV = sK + kBK * LD;
  float* sQ = sV + kBK * LD;
  float* sdO = sQ + kBQ * LD;
  float* sP = sdO + kBQ * LD;   // [kBQ][kLP]; db1's partial sums at the end
  float* sdS = sP + kBQ * kLP;  // [kBQ][kLP]
  float* sLse = sdS + kBQ * kLP;
  float* sDelta = sLse + kBQ;

  const long long ld = (long long)a.H * D;
  float colsum[4] = {0.f, 0.f, 0.f, 0.f};  // db1 over this thread's rows, keys tx + 16 j
  for (int h = 0; h < a.H; ++h) {
    const long long base = head_base<D>(a, n, h);
    __syncthreads();  // the previous head's readers of sK / sV are done
    load_tile<D, T>(sK, reinterpret_cast<const T*>(a.k) + base, ld, k0, a.R, 1.f);
    load_tile<D, T>(sV, reinterpret_cast<const T*>(a.v) + base, ld, k0, a.R, 1.f);
    float4 dk[D / 16], dv[D / 16];
    zero<D>(dk);
    zero<D>(dv);
    for (int q0 = 0; q0 < a.R; q0 += kBQ) {
      __syncthreads();  // the previous pair's readers are done
      load_q_side<D, T>(a, n, h, q0, sQ, sdO, sLse, sDelta);
      __syncthreads();
      float p[4][4], ds[4][4];
      tile_probs<D>(a, n, h, q0, k0, sQ, sdO, sK, sV, sLse, sDelta, p, ds, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          sP[(ty + 16 * i) * kLP + tx + 16 * j] = p[i][j];
          sdS[(ty + 16 * i) * kLP + tx + 16 * j] = ds[i][j];
          colsum[j] += ds[i][j];
        }
      __syncthreads();
      tile_mm<D, true>(dv, sP, sdO, tid);  // dv[k] += sum_q p[q][k] dO[q]
      tile_mm<D, true>(dk, sdS, sQ, tid);  // dk[k] += sum_q ds[q][k] q[q]
    }
    store_rows<D, T>(a.dk, base, ld, k0, a.R, dk, a.scale, tid);
    store_rows<D, T>(a.dv, base, ld, k0, a.R, dv, 1.f, tid);
  }
  if (a.db1 == nullptr) return;
  __syncthreads();  // every reader of sP is done
#pragma unroll
  for (int j = 0; j < 4; ++j) sP[ty * kBK + tx + 16 * j] = colsum[j];
  __syncthreads();
  if (tid < kBK && k0 + tid < a.R) {
    float sum = 0.f;
    for (int r = 0; r < kThreads / 16; ++r) sum += sP[r * kBK + tid];
    a.db1[(long long)n * a.R + k0 + tid] = sum;
  }
}

// ---------------------------------------------------------------------------
// db2: one CTA per (query tile, key tile, head, group), walking the group's
// n_seq rows; the [64][64] tile of db2 stays in registers
// ---------------------------------------------------------------------------
template <int D, typename T>
__global__ void __launch_bounds__(kThreads) evo_bwd_db2_kernel(const Args a) {
  constexpr int LD = D + 4;
  const int nt = (a.R + kBQ - 1) / kBQ;
  int idx = blockIdx.x;
  const int qt = idx % nt;
  idx /= nt;
  const int kt = idx % nt;
  idx /= nt;
  const int h = idx % a.H, g = idx / a.H;
  const int q0 = qt * kBQ, k0 = kt * kBK;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;
  float* sdO = sQ + kBQ * LD;
  float* sK = sdO + kBQ * LD;
  float* sV = sK + kBK * LD;
  float* sLse = sV + kBK * LD;
  float* sDelta = sLse + kBQ;

  const long long ld = (long long)a.H * D;
  float acc[4][4] = {};
  for (int nn = 0; nn < a.n_seq; ++nn) {
    const int n = g * a.n_seq + nn;
    const long long base = head_base<D>(a, n, h);
    __syncthreads();  // the previous row's readers are done
    load_q_side<D, T>(a, n, h, q0, sQ, sdO, sLse, sDelta);
    load_tile<D, T>(sK, reinterpret_cast<const T*>(a.k) + base, ld, k0, a.R, 1.f);
    load_tile<D, T>(sV, reinterpret_cast<const T*>(a.v) + base, ld, k0, a.R, 1.f);
    __syncthreads();
    float p[4][4], ds[4][4];
    tile_probs<D>(a, n, h, q0, k0, sQ, sdO, sK, sV, sLse, sDelta, p, ds, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] += ds[i][j];
  }
  float* out = a.db2 + ((long long)g * a.H + h) * a.R * a.R;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty + 16 * i;
    if (qpos >= a.R) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kpos = k0 + tx + 16 * j;
      if (kpos < a.R) out[(long long)qpos * a.R + kpos] = acc[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// The tensor-core route (bf16 / fp16 q/k/v): dk/dv with db1, and db2
// ---------------------------------------------------------------------------

constexpr int kMmaThreads = ds_mma::kTileThreads;  // 4 warps x 16 rows of a 64-row tile
using ds_mma::stage_tile;
using ds_mma::store_frags;
constexpr int kLB = kBK + 4;      // fp32 row of a staged [kBQ][kBK] pair-bias tile

// sum over d < len of a[d] * b[d], two 16-bit rows in shared memory
template <typename T>
__device__ __forceinline__ float dot16(const T* a, const T* b, int len) {
  float part = 0.f;
  for (int u = 0; u < len; u += 8) {
    const uint4 ra = *reinterpret_cast<const uint4*>(a + u);
    const uint4 rb = *reinterpret_cast<const uint4*>(b + u);
    const T* ha = reinterpret_cast<const T*>(&ra);
    const T* hb = reinterpret_cast<const T*>(&rb);
#pragma unroll
    for (int e = 0; e < 8; ++e) part += ds_mma::to_f(ha[e]) * ds_mma::to_f(hb[e]);
  }
  return part;
}

// The pair-bias tile b2[g, h, q0 .., k0 ..] into a shared [kBQ][LB] fp32
// tile, copied along k (rows of R floats) in 16-byte chunks where R allows;
// positions past R are zeros.
template <int LB>
__device__ __forceinline__ void stage_pair_bias(float* dst, const Args& a, int g, int h, int q0,
                                                int k0) {
  const float* src = a.b2 + (((long long)g * a.H + h) * a.R + q0) * a.R + k0;
  if (a.R % 4 == 0) {  // 16-byte rows: whole chunks inside or past R
    for (int c = threadIdx.x; c < kBQ * (kBK / 4); c += kMmaThreads) {
      const int r = c / (kBK / 4), c4 = (c % (kBK / 4)) * 4;
      const bool ok = q0 + r < a.R && k0 + c4 < a.R;
      ds_mma::cp_async16(dst + r * LB + c4, ok ? src + (long long)r * a.R + c4 : a.b2, ok);
    }
  } else {
    for (int c = threadIdx.x; c < kBQ * kBK; c += kMmaThreads) {
      const int r = c / kBK, cc = c % kBK;
      const bool ok = q0 + r < a.R && k0 + cc < a.R;
      ds_mma::cp_async4(dst + r * LB + cc, ok ? src + (long long)r * a.R + cc : a.b2, ok);
    }
  }
}

// ---------------------------------------------------------------------------
// The forward and dq on the tensor cores: one CTA per (query tile, head,
// kBiasRows rows n of one group), walking the key tiles through a two-stage
// ring; a warp's rows are queries r0 + lane / 4 + 8 (e / 2), its C-fragment
// columns the keys 8 j + 2 (lane % 4) + e % 2
// ---------------------------------------------------------------------------
constexpr int kLBQ = kBK + 8;  // fp32 row of a pair-bias tile read in the query-row layout
// Rows n of one group that a forward / dq CTA walks with each staged
// pair-bias tile at d 32 (wider heads take one: their accumulators leave no
// registers for a second row's). One: two rows halve the bias's L2 reads
// but hold a CTA to 218 registers and 89-110 KB, two CTAs an SM, and ran
// 13% (forward) and 29% (dq) slower than one row at three CTAs an SM
// on the H100 (PERF.md; chip_smoke.py --ablation evo_bias_two_rows)
constexpr int kBiasRows = 1;
__host__ __device__ constexpr int rows_per_cta(int d) { return d == 32 ? kBiasRows : 1; }

// Dynamic shared memory of the forward (nq = 1: q) and dq (nq = 3: q, O,
// dO): rows x nq 16-bit query tiles, then two ring stages of rows x (K, V),
// one pair-bias tile and rows x 64 b1
__host__ __device__ constexpr size_t qrow_smem_bytes(int d, int rows, int nq) {
  return (size_t)(rows * nq + 4 * rows) * 64 * (d + ds_mma::kPad) * 2 +
         (size_t)2 * (kBQ * kLBQ + rows * kBK) * sizeof(float);
}

// Where a query-row CTA's pieces live in shared memory (see qrow_smem_bytes)
template <int D, typename T, int ROWS, int NQ>
struct QRowSmem {
  static constexpr int TILE = ds_mma::Tile16<D>::ELEMS;
  T* q;       // row rr, tile i: q + (NQ rr + i) TILE
  T* kv;      // stage s, row rr: K at kv + 2 (ROWS s + rr) TILE, V after it
  float* b2;  // stage s: [kBQ][kLBQ] at b2 + s kBQ kLBQ
  float* b1;  // stage s, row rr: [kBK] at b1 + (ROWS s + rr) kBK
  __device__ explicit QRowSmem(unsigned char* raw)
      : q(reinterpret_cast<T*>(raw)),
        kv(q + NQ * ROWS * TILE),
        b2(reinterpret_cast<float*>(kv + 4 * ROWS * TILE)),
        b1(b2 + 2 * kBQ * kLBQ) {}
  __device__ const T* k(int s, int rr) const { return kv + 2 * (ROWS * s + rr) * TILE; }
  __device__ const float* bias1(int s, int rr) const { return b1 + (ROWS * s + rr) * kBK; }

  // key tile k0 of rows n0 .. n0 + nrows - 1 (head h, group g) into stage
  // s: K, V and b1 per row (b1 zeros without the mask bias) and, with the
  // pair bias, its [q0 ..][k0 ..] tile once for all the rows
  __device__ void stage_keys(const Args& a, int n0, int nrows, int g, int h, int q0, int k0,
                             int s) {
    const long long ld = (long long)a.H * D;
#pragma unroll
    for (int rr = 0; rr < ROWS; ++rr) {
      if (rr >= nrows) break;
      const long long base = head_base<D>(a, n0 + rr, h);
      T* dst = kv + 2 * (ROWS * s + rr) * TILE;
      stage_tile<D, T>(dst, reinterpret_cast<const T*>(a.k) + base, ld, k0, a.R);
      stage_tile<D, T>(dst + TILE, reinterpret_cast<const T*>(a.v) + base, ld, k0, a.R);
    }
    const int rr = threadIdx.x / kBK, i = threadIdx.x % kBK;
    if (rr < nrows) {
      const bool ok = a.b1 != nullptr && k0 + i < a.R;
      ds_mma::cp_async4(b1 + (ROWS * s + rr) * kBK + i,
                        ok ? a.b1 + (long long)(n0 + rr) * a.R + k0 + i : a.lse, ok);
    }
    if (a.b2 != nullptr) stage_pair_bias<kLBQ>(b2 + s * kBQ * kLBQ, a, g, h, q0, k0);
  }
};

// The CTA's (query tile, head) and its rows n0 .. n0 + nrows - 1, all of
// group g: blockIdx.x runs over the query tiles, then heads, then each
// group's ceil(n_seq / ROWS) row sets
template <int ROWS>
struct QRowCta {
  int q0, h, g, n0, nrows;
  __device__ explicit QRowCta(const Args& a) {
    const int nqt = (a.R + kBQ - 1) / kBQ, per_group = (a.n_seq + ROWS - 1) / ROWS;
    const int set = blockIdx.x / nqt / a.H;
    q0 = (blockIdx.x % nqt) * kBQ;
    h = (blockIdx.x / nqt) % a.H;
    g = set / per_group;
    n0 = g * a.n_seq + (set % per_group) * ROWS;
    // one at an odd group's last set; a constant at ROWS 1 (a register
    // fewer, which keeps one-row dq under 170 without a spill)
    nrows = ROWS == 1 ? 1 : min(ROWS, (g + 1) * a.n_seq - n0);
  }
};

// forward: s = (scale * q.k + b2) + b1 in the C fragments, keys past R at
// -1e30 (never entering the sums); the online softmax in registers; P as a
// split pair into acc += P . V
template <int D, typename T, int ROWS>
__global__ void __launch_bounds__(kMmaThreads, D == 32 && ROWS == 1 ? 3 : 1)
    evo_fwd_mma_kernel(const Args a) {
  constexpr int LDS = ds_mma::Tile16<D>::LDS, TILE = ds_mma::Tile16<D>::ELEMS;
  const QRowCta<ROWS> c(a);
  const int n_kt = (a.R + kBK - 1) / kBK;  // key tiles of the forward's walk
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, r0 = 16 * warp, t = lane % 4;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  QRowSmem<D, T, ROWS, 1> sm(smem_raw);
  const long long ld = (long long)a.H * D;
#pragma unroll
  for (int rr = 0; rr < ROWS; ++rr)
    if (rr < c.nrows)
      stage_tile<D, T>(sm.q + rr * TILE,
                       reinterpret_cast<const T*>(a.q) + head_base<D>(a, c.n0 + rr, c.h), ld, c.q0,
                       a.R);
  sm.stage_keys(a, c.n0, c.nrows, c.g, c.h, c.q0, 0, 0);
  ds_mma::cp_async_commit();

  const bool pair = a.b2 != nullptr;
  float m[ROWS][2], l[ROWS][2], acc[ROWS][D / 8][4];
#pragma unroll
  for (int rr = 0; rr < ROWS; ++rr) {
    m[rr][0] = m[rr][1] = kNegInf;
    l[rr][0] = l[rr][1] = 0.f;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) acc[rr][n][0] = acc[rr][n][1] = acc[rr][n][2] = acc[rr][n][3] = 0.f;
  }
  for (int it = 0; it < n_kt; ++it) {
    const int st = it & 1, k0 = it * kBK;
    ds_mma::cp_async_wait_all();
    __syncthreads();  // tile it has landed; every reader of the other stage is done
    if (it + 1 < n_kt) sm.stage_keys(a, c.n0, c.nrows, c.g, c.h, c.q0, k0 + kBK, st ^ 1);
    ds_mma::cp_async_commit();
    const bool full = k0 + kBK <= a.R;
    const float* bt = sm.b2 + st * kBQ * kLBQ;
#pragma unroll
    for (int rr = 0; rr < ROWS; ++rr) {
      if (rr >= c.nrows) break;
      const T* sK = sm.k(st, rr);
      const float* b1 = sm.bias1(st, rr);
      float s[8][4];
      ds_mma::mma_abt<D, T>(s, sm.q + rr * TILE + r0 * LDS, sK, lane);  // q . k
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = r0 + lane / 4 + 8 * i;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = 8 * j + 2 * t;
          const float2 b = pair ? *reinterpret_cast<const float2*>(bt + r * kLBQ + col)
                                : make_float2(0.f, 0.f);
          const float2 w = *reinterpret_cast<const float2*>(b1 + col);
          float x0 = a.scale * s[j][2 * i], x1 = a.scale * s[j][2 * i + 1];
          if (pair) {
            x0 += b.x;
            x1 += b.y;
          }
          x0 += w.x;
          x1 += w.y;
          s[j][2 * i] = full || k0 + col < a.R ? x0 : kNegInf;
          s[j][2 * i + 1] = full || k0 + col + 1 < a.R ? x1 : kNegInf;
        }
        // a key past R never enters: it is not a position
        const float alpha = ds_mma::online_softmax_row(s, i, m[rr][i], l[rr][i], [&](int j, int e) {
          return full || k0 + 8 * j + 2 * t + e < a.R;
        });
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          acc[rr][n][2 * i] *= alpha;
          acc[rr][n][2 * i + 1] *= alpha;
        }
      }
      ds_mma::SplitFrags p;
      ds_mma::split_frags<T>(p, s);
      ds_mma::mma_wm<D, T>(acc[rr], p, sK + TILE, lane);  // acc += p . v
    }
  }
#pragma unroll
  for (int rr = 0; rr < ROWS; ++rr) {
    if (rr >= c.nrows) break;
    const int n = c.n0 + rr;
    float* lse = a.lse + ((long long)n * a.H + c.h) * a.R;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float l_safe = fmaxf(ds_mma::quad_sum(l[rr][i]), 1e-30f);
#pragma unroll
      for (int nn = 0; nn < D / 8; ++nn) {
        acc[rr][nn][2 * i] /= l_safe;
        acc[rr][nn][2 * i + 1] /= l_safe;
      }
      const int qpos = c.q0 + r0 + lane / 4 + 8 * i;
      if (t == 0 && qpos < a.R) lse[qpos] = m[rr][i] + logf(l_safe);
    }
    store_frags<D, T>(reinterpret_cast<T*>(a.out) + head_base<D>(a, n, c.h), ld, c.q0 + r0, a.R,
                      acc[rr], 1.f, lane);
  }
}

// sum += W . M for a warp: W its 16 x 16 NC fp32 tile w (2 NC C tiles) as
// split hi + lo pairs, made one depth-16 chunk at a time; M 16 NC rows of a
// shared [.][D] tile read with ldmatrix.trans. Each output tile takes
// mma_sm90.cuh's mma_wm products in its order; the caller adds sum to its
// long-run accumulator once per tile pair
template <int D, typename T, int NC>
__device__ __forceinline__ void mma_split_sum(float (&sum)[D / 8][4], const float (&w)[2 * NC][4],
                                              const T* sM, int lane) {
  constexpr int LDS = ds_mma::Tile16<D>::LDS;
  const T* pm = sM + ((lane & 7) + ((lane >> 3) & 1) * 8) * LDS + (lane >> 4) * 8;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    unsigned hi[4], lo[4];
#pragma unroll
    for (int jj = 0; jj < 2; ++jj)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float x = w[2 * c + jj][2 * h], y = w[2 * c + jj][2 * h + 1];
        const T hx = ds_mma::from_f<T>(x), hy = ds_mma::from_f<T>(y);
        hi[2 * jj + h] = ds_mma::pack2(hx, hy);
        lo[2 * jj + h] = ds_mma::pack2(ds_mma::from_f<T>(x - ds_mma::to_f(hx)),
                                       ds_mma::from_f<T>(y - ds_mma::to_f(hy)));
      }
#pragma unroll
    for (int n = 0; n < D / 8; n += 2) {
      unsigned b[4];
      ds_mma::ldsm4_t(b, pm + c * 16 * LDS + n * 8);
      ds_mma::mma16816(sum[n], hi, b[0], b[1], T());
      ds_mma::mma16816(sum[n], lo, b[0], b[1], T());
      ds_mma::mma16816(sum[n + 1], hi, b[2], b[3], T());
      ds_mma::mma16816(sum[n + 1], lo, b[2], b[3], T());
    }
  }
}

// dq: p = exp2((scale * q.k + b2 + b1 - lse) log2 e) (0 for keys past R),
// dp = dO . v, ds = p (dp - delta) as a split pair into dq += ds . k; dq is
// stored times scale. A query row past R has dO = 0 and delta = 0, and is
// never stored, so its p needs no mask. Each 64-key tile is walked in two
// halves of 32 keys by a loop kept rolled (S, dP and dS of 32 keys live at
// a time, the split pairs one chunk at a time): at 64 keys a time, or with
// the halves unrolled and interleaved, the one-row kernel, held to 170
// registers for three CTAs an SM, spilled (PERF.md)
template <int D, typename T, int ROWS>
__global__ void __launch_bounds__(kMmaThreads, D == 32 && ROWS == 1 ? 3 : 1)
    evo_bwd_dq_mma_kernel(const Args a) {
  constexpr int LDS = ds_mma::Tile16<D>::LDS, TILE = ds_mma::Tile16<D>::ELEMS;
  const QRowCta<ROWS> c(a);
  const int n_kt = (a.R + kBK - 1) / kBK;  // key tiles of dq's walk
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, r0 = 16 * warp, t = lane % 4;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  QRowSmem<D, T, ROWS, 3> sm(smem_raw);
  const long long ld = (long long)a.H * D;
#pragma unroll
  for (int rr = 0; rr < ROWS; ++rr) {
    if (rr >= c.nrows) break;
    const long long base = head_base<D>(a, c.n0 + rr, c.h);
    T* dst = sm.q + 3 * rr * TILE;
    stage_tile<D, T>(dst, reinterpret_cast<const T*>(a.q) + base, ld, c.q0, a.R);
    stage_tile<D, T>(dst + TILE, reinterpret_cast<const T*>(a.o) + base, ld, c.q0, a.R);
    stage_tile<D, T>(dst + 2 * TILE, reinterpret_cast<const T*>(a.dout) + base, ld, c.q0, a.R);
  }
  sm.stage_keys(a, c.n0, c.nrows, c.g, c.h, c.q0, 0, 0);
  ds_mma::cp_async_commit();

  // lse of the warp's rows (0 past R), while the tiles land
  float lse[ROWS][2], delta[ROWS][2], dq[ROWS][D / 8][4];
#pragma unroll
  for (int rr = 0; rr < ROWS; ++rr) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qpos = c.q0 + r0 + lane / 4 + 8 * i;
      lse[rr][i] = rr < c.nrows && qpos < a.R
                       ? a.lse[((long long)(c.n0 + rr) * a.H + c.h) * a.R + qpos]
                       : 0.f;
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) dq[rr][n][0] = dq[rr][n][1] = dq[rr][n][2] = dq[rr][n][3] = 0.f;
  }
  ds_mma::cp_async_wait_all();
  __syncthreads();
  // delta = rowsum(dO * O) of the warp's rows g and g + 8: each lane of the
  // quad sums D / 4 columns
#pragma unroll
  for (int rr = 0; rr < ROWS; ++rr)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const T* sO = sm.q + (3 * rr + 1) * TILE;
      const int off = (r0 + lane / 4 + 8 * i) * LDS + t * (D / 4);
      delta[rr][i] = rr < c.nrows ? ds_mma::quad_sum(dot16<T>(sO + TILE + off, sO + off, D / 4))
                                  : 0.f;
    }

  const bool pair = a.b2 != nullptr;
  for (int it = 0; it < n_kt; ++it) {
    const int st = it & 1, k0 = it * kBK;
    ds_mma::cp_async_wait_all();
    __syncthreads();  // tile it has landed; every reader of the other stage is done
    if (it + 1 < n_kt) sm.stage_keys(a, c.n0, c.nrows, c.g, c.h, c.q0, k0 + kBK, st ^ 1);
    ds_mma::cp_async_commit();
    const bool full = k0 + kBK <= a.R;
    const float* bt = sm.b2 + st * kBQ * kLBQ;
#pragma unroll
    for (int rr = 0; rr < ROWS; ++rr) {
      if (rr >= c.nrows) break;
      const T* sQ = sm.q + 3 * rr * TILE;
      const float* b1 = sm.bias1(st, rr);
      float sum[D / 8][4];  // the tile pair's ds . k, summed from zero
#pragma unroll
      for (int n = 0; n < D / 8; ++n) sum[n][0] = sum[n][1] = sum[n][2] = sum[n][3] = 0.f;
#pragma unroll 1
      for (int hk = 0; hk < 2; ++hk) {  // the tile's keys in two halves of 32
        const T* sK = sm.k(st, rr) + 32 * hk * LDS;
        float s[4][4], dp[4][4];
        ds_mma::mma_abt<D, T, 4>(s, sQ + r0 * LDS, sK, lane);                  // q . k
        ds_mma::mma_abt<D, T, 4>(dp, sQ + 2 * TILE + r0 * LDS, sK + TILE, lane);  // dO . v
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = r0 + lane / 4 + 8 * i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int col = 32 * hk + 8 * j + 2 * t;
            const float2 b = pair ? *reinterpret_cast<const float2*>(bt + r * kLBQ + col)
                                  : make_float2(0.f, 0.f);
            const float2 w = *reinterpret_cast<const float2*>(b1 + col);
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float x = a.scale * s[j][2 * i + e];
              if (pair) x += e ? b.y : b.x;
              x += e ? w.y : w.x;
              const float p = full || k0 + col + e < a.R
                                  ? exp2f((x - lse[rr][i]) * ds_mma::kLog2e)
                                  : 0.f;
              dp[j][2 * i + e] = p * (dp[j][2 * i + e] - delta[rr][i]);  // ds
            }
          }
        }
        mma_split_sum<D, T, 2>(sum, dp, sK, lane);  // sum += ds . k
      }
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) dq[rr][n][e] += sum[n][e];
    }
  }
#pragma unroll
  for (int rr = 0; rr < ROWS; ++rr) {
    if (rr >= c.nrows) break;
    store_frags<D, T>(reinterpret_cast<T*>(a.out) + head_base<D>(a, c.n0 + rr, c.h), ld,
                      c.q0 + r0, a.R, dq[rr], a.scale, lane);
  }
}

// ---------------------------------------------------------------------------
// db2: one CTA per (query tile, key tile, head, row chunk, group), walking
// the chunk's rows; the [64][64] tile of db2 and the pair-bias tile stay in
// registers in the C-fragment layout (element e of n-tile j: query row
// r0 + lane / 4 + 8 (e / 2), key 8 j + 2 (lane % 4) + e % 2). With more
// than one chunk, chunk c writes its partial to part [n_chunks][G][H][R][R].
// At d 32, at most 170 registers, so three CTAs share an SM (wider heads
// are held to fewer by shared memory, and the cap would only make them
// spill).
// ---------------------------------------------------------------------------
template <int D, typename T>
__global__ void __launch_bounds__(kMmaThreads, D == 32 ? 3 : 1)
    evo_bwd_db2_mma_kernel(const Args a, float* part, int n_chunks) {
  constexpr int LDS = ds_mma::Tile16<D>::LDS, TILE = ds_mma::Tile16<D>::ELEMS;
  const int nt = (a.R + kBQ - 1) / kBQ;
  int idx = blockIdx.x;
  const int qt = idx % nt;
  idx /= nt;
  const int kt = idx % nt;
  idx /= nt;
  const int h = idx % a.H;
  idx /= a.H;
  const int c = idx % n_chunks, g = idx / n_chunks;
  const int q0 = qt * kBQ, k0 = kt * kBK;
  // chunk c holds rows [c n_seq / n_chunks, (c + 1) n_seq / n_chunks) of the group
  const int row_lo = (int)((long long)c * a.n_seq / n_chunks);
  const int n_rows = (int)((long long)(c + 1) * a.n_seq / n_chunks) - row_lo;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, r0 = 16 * warp;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s16 = reinterpret_cast<T*>(smem_raw);  // stage s: q, O, dO, k, v at s16 + (5 s + i) TILE
  float* s32 = reinterpret_cast<float*>(s16 + 10 * TILE);  // stage s: lse [64], b1 [64]

  const long long ld = (long long)a.H * D;
  auto stage_row = [&](int nn, int st) {
    const int n = g * a.n_seq + nn;
    const long long base = head_base<D>(a, n, h);
    T* dst = s16 + 5 * st * TILE;
    stage_tile<D, T>(dst, reinterpret_cast<const T*>(a.q) + base, ld, q0, a.R);
    stage_tile<D, T>(dst + TILE, reinterpret_cast<const T*>(a.o) + base, ld, q0, a.R);
    stage_tile<D, T>(dst + 2 * TILE, reinterpret_cast<const T*>(a.dout) + base, ld, q0, a.R);
    stage_tile<D, T>(dst + 3 * TILE, reinterpret_cast<const T*>(a.k) + base, ld, k0, a.R);
    stage_tile<D, T>(dst + 4 * TILE, reinterpret_cast<const T*>(a.v) + base, ld, k0, a.R);
    float* f = s32 + 128 * st;
    const int i = threadIdx.x % 64;
    if (threadIdx.x < 64) {  // lse of the query tile
      const bool ok = q0 + i < a.R;
      const float* src = a.lse + ((long long)n * a.H + h) * a.R + q0 + i;
      ds_mma::cp_async4(f + i, ok ? src : a.lse, ok);
    } else {  // b1 of the key tile, zeros without the mask bias
      const bool ok = a.b1 != nullptr && k0 + i < a.R;
      ds_mma::cp_async4(f + 64 + i, ok ? a.b1 + (long long)n * a.R + k0 + i : a.lse, ok);
    }
  };
  if (n_rows > 0) stage_row(row_lo, 0);
  ds_mma::cp_async_commit();

  // the pair-bias tile of (group, head, query tile, key tile), the same for
  // every row: read once, while the first row lands
  float bias[8][4];
  {
    const float* b2 = a.b2 + ((long long)g * a.H + h) * a.R * a.R;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qpos = q0 + r0 + lane / 4 + 8 * i;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kpos = k0 + 8 * j + 2 * (lane % 4) + e;
          bias[j][2 * i + e] = qpos < a.R && kpos < a.R ? b2[(long long)qpos * a.R + kpos] : 0.f;
        }
    }
  }
  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int it = 0; it < n_rows; ++it) {
    const int st = it & 1;
    ds_mma::cp_async_wait_all();
    __syncthreads();  // row it has landed; every reader of the other stage is done
    if (it + 1 < n_rows) stage_row(row_lo + it + 1, st ^ 1);  // the next row, in flight
    ds_mma::cp_async_commit();
    const T* sQ = s16 + 5 * st * TILE;
    const T* sO = sQ + TILE;
    const T* sdO = sQ + 2 * TILE;
    const T* sK = sQ + 3 * TILE;
    const T* sV = sQ + 4 * TILE;
    const float* sLse = s32 + 128 * st;
    const float* sB1 = sLse + 64;
    // delta = rowsum(dO * O) of the warp's rows g and g + 8: each lane of
    // the quad sums D / 4 columns
    float delta[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int off = (r0 + lane / 4 + 8 * i) * LDS + (lane % 4) * (D / 4);
      delta[i] = ds_mma::quad_sum(dot16<T>(sdO + off, sO + off, D / 4));
    }
    float s[8][4], dp[8][4];
    ds_mma::mma_abt<D, T>(s, sQ + r0 * LDS, sK, lane);    // q . k
    ds_mma::mma_abt<D, T>(dp, sdO + r0 * LDS, sV, lane);  // dO . v
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r0 + lane / 4 + 8 * i;
      const bool q_ok = q0 + r < a.R;
      const float lse = sLse[r];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * j + 2 * (lane % 4) + e;
          const float x = (a.scale * s[j][2 * i + e] + bias[j][2 * i + e]) + sB1[col];
          const float p = q_ok && k0 + col < a.R ? exp2f((x - lse) * ds_mma::kLog2e) : 0.f;
          acc[j][2 * i + e] += p * (dp[j][2 * i + e] - delta[i]);
        }
    }
  }
  const long long plane = (long long)a.R * a.R;
  float* out = n_chunks > 1 ? part + (long long)c * (a.N / a.n_seq) * a.H * plane : a.db2;
  out += ((long long)g * a.H + h) * plane;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qpos = q0 + r0 + lane / 4 + 8 * i;
    if (qpos >= a.R) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kpos = k0 + 8 * j + 2 * (lane % 4) + e;
        if (kpos < a.R) out[(long long)qpos * a.R + kpos] = acc[j][2 * i + e];
      }
  }
}

// db2 = the row chunks' partials [n_chunks][total] summed in chunk order
__global__ void __launch_bounds__(256) evo_db2_sum_kernel(const float* part, float* db2,
                                                          long long total, int n_chunks) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (total % 4 == 0) {
    const long long n4 = total / 4;
    const float4* p = reinterpret_cast<const float4*>(part);
    for (long long i = first; i < n4; i += stride) {
      float4 sum = p[i];
      for (int c = 1; c < n_chunks; ++c) {
        const float4 t = p[c * n4 + i];
        sum.x += t.x;
        sum.y += t.y;
        sum.z += t.z;
        sum.w += t.w;
      }
      reinterpret_cast<float4*>(db2)[i] = sum;
    }
  } else {
    for (long long i = first; i < total; i += stride) {
      float sum = part[i];
      for (int c = 1; c < n_chunks; ++c) sum += part[c * total + i];
      db2[i] = sum;
    }
  }
}

// ---------------------------------------------------------------------------
// dk / dv (and db1): one CTA per (key tile, row n), walking the items
// (head, query tile), heads outermost; a warp's rows are the keys
// r0 + lane / 4 + 8 (e / 2), its C-fragment columns the queries
// 8 j + 2 (lane % 4) + e % 2. At d 32 three CTAs share an SM: at most 170
// registers, and one pair-bias buffer (68 KB in all), refilled for the next
// item once every warp has read it
// ---------------------------------------------------------------------------
template <int D, typename T>
__global__ void __launch_bounds__(kMmaThreads, D == 32 ? 3 : 1)
    evo_bwd_dkdv_mma_kernel(const Args a) {
  constexpr int LDS = ds_mma::Tile16<D>::LDS, TILE = ds_mma::Tile16<D>::ELEMS;
  const int nkt = (a.R + kBK - 1) / kBK;
  const int kt = blockIdx.x % nkt, n = blockIdx.x / nkt;
  const int k0 = kt * kBK, g = n / a.n_seq;
  const int n_qt = (a.R + kBQ - 1) / kBQ;  // query tiles of each head
  const int n_items = a.H * n_qt;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, r0 = 16 * warp;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sKV = reinterpret_cast<T*>(smem_raw);  // head parity s: K at sKV + 2 s TILE, V after it
  T* sQOD = sKV + 4 * TILE;                 // stage s: q, O, dO at sQOD + 3 s TILE
  float* sBias = reinterpret_cast<float*>(sQOD + 6 * TILE);  // [kBQ][kLB], one item's
  float* sStat = sBias + kBQ * kLB;  // stage s: lse [64], then delta [64]

  const long long ld = (long long)a.H * D;
  const bool pair = a.b2 != nullptr;
  auto stage_item = [&](int item, int st) {
    const int h = item / n_qt, q0 = (item % n_qt) * kBQ;
    const long long base = head_base<D>(a, n, h);
    if (q0 == 0) {  // a new head: its K and V tiles
      T* kv = sKV + 2 * (h & 1) * TILE;
      stage_tile<D, T>(kv, reinterpret_cast<const T*>(a.k) + base, ld, k0, a.R);
      stage_tile<D, T>(kv + TILE, reinterpret_cast<const T*>(a.v) + base, ld, k0, a.R);
    }
    T* dst = sQOD + 3 * st * TILE;
    stage_tile<D, T>(dst, reinterpret_cast<const T*>(a.q) + base, ld, q0, a.R);
    stage_tile<D, T>(dst + TILE, reinterpret_cast<const T*>(a.o) + base, ld, q0, a.R);
    stage_tile<D, T>(dst + 2 * TILE, reinterpret_cast<const T*>(a.dout) + base, ld, q0, a.R);
    if (threadIdx.x < 64) {
      const int i = threadIdx.x;
      const bool ok = q0 + i < a.R;
      const float* src = a.lse + ((long long)n * a.H + h) * a.R + q0 + i;
      ds_mma::cp_async4(sStat + 128 * st + i, ok ? src : a.lse, ok);
    }
  };
  // the pair-bias tile of an item
  auto stage_bias = [&](int item) {
    stage_pair_bias<kLB>(sBias, a, g, item / n_qt, (item % n_qt) * kBQ, k0);
  };
  stage_item(0, 0);
  if (pair) stage_bias(0);
  ds_mma::cp_async_commit();

  float b1v[2];     // b1 of the warp's key rows (0 without the mask bias)
  float colsum[2];  // db1 of those rows: this lane's share
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int kpos = k0 + r0 + lane / 4 + 8 * i;
    b1v[i] = a.b1 != nullptr && kpos < a.R ? a.b1[(long long)n * a.R + kpos] : 0.f;
    colsum[i] = 0.f;
  }
  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int c = 0; c < D / 8; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[c][e] = dv[c][e] = 0.f;

  for (int it = 0; it < n_items; ++it) {
    const int st = it & 1, h = it / n_qt, q0 = (it % n_qt) * kBQ;
    ds_mma::cp_async_wait_all();
    __syncthreads();  // item it has landed; every reader of the other stage is done
    if (it + 1 < n_items) stage_item(it + 1, st ^ 1);  // the next item, in flight
    ds_mma::cp_async_commit();
    const T* sK = sKV + 2 * (h & 1) * TILE;
    const T* sV = sK + TILE;
    const T* sQ = sQOD + 3 * st * TILE;
    const T* sdO = sQ + 2 * TILE;
    const float* bt = sBias;
    const float* lse = sStat + 128 * st;
    float* delta = sStat + 128 * st + 64;
    {  // delta = rowsum(dO * O) of the item's 64 queries, two threads a row
      const int r = threadIdx.x / 2, off = r * LDS + (threadIdx.x % 2) * (D / 2);
      float part = dot16<T>(sdO + off, sQ + TILE + off, D / 2);
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      if (threadIdx.x % 2 == 0) delta[r] = part;
    }
    __syncthreads();

    ds_mma::SplitFrags p;  // p^T, kept only as its split pair
    {
      float s[8][4];
      ds_mma::mma_abt<D, T>(s, sK + r0 * LDS, sQ, lane);  // s^T = k . q
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kr = r0 + lane / 4 + 8 * (e / 2), col = 8 * j + 2 * (lane % 4) + e % 2;
          float x = a.scale * s[j][e];
          if (pair) x += bt[col * kLB + kr];
          x += b1v[e / 2];
          s[j][e] = q0 + col < a.R && k0 + kr < a.R ? exp2f((x - lse[col]) * ds_mma::kLog2e) : 0.f;
        }
      ds_mma::split_frags<T>(p, s);
    }
    __syncthreads();  // every warp has read the pair-bias tile: the next item's, in flight
    if (pair && it + 1 < n_items) stage_bias(it + 1);
    ds_mma::cp_async_commit();
    ds_mma::mma_wm<D, T>(dv, p, sdO, lane);  // dv += p^T . dO
    ds_mma::SplitFrags ds;
    {
      float dp[8][4];
      ds_mma::mma_abt<D, T>(dp, sV + r0 * LDS, sdO, lane);  // dp^T = v . dO
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {  // ds^T = p^T (dp^T - delta)
          const float x = ds_mma::split_value<T>(p, j, e) *
                          (dp[j][e] - delta[8 * j + 2 * (lane % 4) + e % 2]);
          colsum[e / 2] += x;
          dp[j][e] = x;
        }
      ds_mma::split_frags<T>(ds, dp);
    }
    ds_mma::mma_wm<D, T>(dk, ds, sQ, lane);  // dk += ds^T . q
    if (it % n_qt == n_qt - 1) {  // the head's last query tile: its dk and dv
      const long long base = head_base<D>(a, n, h);
      store_frags<D, T>(reinterpret_cast<T*>(a.dk) + base, ld, k0 + r0, a.R, dk, a.scale, lane);
      store_frags<D, T>(reinterpret_cast<T*>(a.dv) + base, ld, k0 + r0, a.R, dv, 1.f, lane);
#pragma unroll
      for (int c = 0; c < D / 8; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) dk[c][e] = dv[c][e] = 0.f;
    }
  }
  if (a.db1 == nullptr) return;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float sum = ds_mma::quad_sum(colsum[i]);
    const int kpos = k0 + r0 + lane / 4 + 8 * i;
    if (lane % 4 == 0 && kpos < a.R) a.db1[(long long)n * a.R + kpos] = sum;
  }
}

// kinds 0-3: the fp32 route's forward, dq, dk/dv and db2 (CUDA cores);
// 4-7: the tensor-core route's dk/dv, db2, forward and dq
enum Kind {
  kFwd = 0, kDq = 1, kDkdv = 2, kDb2 = 3, kDkdvMma = 4, kDb2Mma = 5, kFwdMma = 6, kDqMma = 7
};

__host__ __device__ inline size_t smem_bytes(int kind, int d) {
  const size_t tile = (size_t)64 * (d + 4);
  const size_t ptile = (size_t)kBQ * kLP;
  const size_t tile16 = (size_t)64 * (d + ds_mma::kPad) * 2;  // bytes of a 16-bit tile
  if (kind == kFwd) return (3 * tile + ptile + kBQ) * sizeof(float);
  if (kind == kDq) return (4 * tile + ptile + 2 * kBQ) * sizeof(float);
  if (kind == kDkdv) return (4 * tile + 2 * ptile + 2 * kBQ) * sizeof(float);
  if (kind == kDb2) return (4 * tile + 2 * kBQ) * sizeof(float);
  // two stages: K, V (by head parity) and q, O, dO; the pair-bias tile;
  // lse and delta
  if (kind == kDkdvMma) return 10 * tile16 + (kBQ * kLB + 4 * kBQ) * sizeof(float);
  if (kind == kFwdMma) return qrow_smem_bytes(d, rows_per_cta(d), 1);
  if (kind == kDqMma) return qrow_smem_bytes(d, rows_per_cta(d), 3);
  // two stages of q, O, dO, k, v and of lse, b1
  return 10 * tile16 + 4 * kBQ * sizeof(float);
}

// Launch kern on the stream with `bytes` of dynamic shared memory.
template <typename... P, typename... A>
cudaError_t launch_kernel(void (*kern)(P...), long long blocks, int threads, size_t bytes,
                          cudaStream_t stream, A... args) {
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (bytes > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return e;
  }
  kern<<<(unsigned)blocks, threads, bytes, stream>>>(args...);
  return cudaGetLastError();
}

// part / n_chunks: the tensor-core db2's row chunks (ignored by the rest).
template <int D, typename T>
cudaError_t launch(int kind, const Args& a, float* part, int n_chunks, cudaStream_t stream) {
  constexpr bool k16 = !std::is_same<T, float>::value;
  const size_t bytes = smem_bytes(kind, D);
  const long long nt = (a.R + kBQ - 1) / kBQ, groups = a.N / a.n_seq;
  switch (kind) {
    case kFwd:  // the fp32 route
    case kDq:
    case kDkdv:
    case kDb2:
      if constexpr (k16) {
        return cudaErrorInvalidValue;
      } else {
        if (kind == kFwd)
          return launch_kernel(evo_fwd_kernel<D, T>, nt * a.H * a.N, kThreads, bytes, stream, a);
        if (kind == kDq)
          return launch_kernel(evo_bwd_dq_kernel<D, T>, nt * a.H * a.N, kThreads, bytes, stream,
                               a);
        if (kind == kDkdv)
          return launch_kernel(evo_bwd_dkdv_kernel<D, T>, nt * a.N, kThreads, bytes, stream, a);
        return launch_kernel(evo_bwd_db2_kernel<D, T>, nt * nt * a.H * groups, kThreads, bytes,
                             stream, a);
      }
    case kDkdvMma:  // the tensor-core route
    case kDb2Mma:
    case kFwdMma:
    case kDqMma:
      if constexpr (!k16) {
        return cudaErrorInvalidValue;
      } else {
        constexpr int rows = rows_per_cta(D);
        const long long q_ctas = nt * a.H * groups * ((a.n_seq + rows - 1) / rows);
        if (kind == kFwdMma)
          return launch_kernel(evo_fwd_mma_kernel<D, T, rows>, q_ctas, kMmaThreads, bytes, stream,
                               a);
        if (kind == kDqMma)
          return launch_kernel(evo_bwd_dq_mma_kernel<D, T, rows>, q_ctas, kMmaThreads, bytes,
                               stream, a);
        if (kind == kDkdvMma)
          return launch_kernel(evo_bwd_dkdv_mma_kernel<D, T>, nt * a.N, kMmaThreads, bytes, stream,
                               a);
        return launch_kernel(evo_bwd_db2_mma_kernel<D, T>, nt * nt * a.H * n_chunks * groups,
                             kMmaThreads, bytes, stream, a, part, n_chunks);
      }
    default:
      return cudaErrorInvalidValue;
  }
}

// dtype: 0 bf16, 1 fp16, 2 fp32.
template <int D>
cudaError_t by_dtype(int kind, const Args& a, float* part, int n_chunks, int dtype,
                     cudaStream_t stream) {
  if (dtype == 0) return launch<D, __nv_bfloat16>(kind, a, part, n_chunks, stream);
  if (dtype == 1) return launch<D, __half>(kind, a, part, n_chunks, stream);
  if (dtype == 2) return launch<D, float>(kind, a, part, n_chunks, stream);
  return cudaErrorInvalidValue;
}

cudaError_t dispatch(int kind, const Args& a, int d, int dtype, cudaStream_t stream,
                     float* part = nullptr, int n_chunks = 1) {
  if (a.N < 1 || a.R < 1 || a.H < 1 || a.n_seq < 1 || a.N % a.n_seq != 0)
    return cudaErrorInvalidValue;
  if (d == 32) return by_dtype<32>(kind, a, part, n_chunks, dtype, stream);
  if (d == 64) return by_dtype<64>(kind, a, part, n_chunks, dtype, stream);
  if (d == 128) return by_dtype<128>(kind, a, part, n_chunks, dtype, stream);
  return cudaErrorInvalidValue;
}

Args make_args(const void* q, const void* k, const void* v, const float* b1, const float* b2,
               float* lse, int N, int R, int H, int d, int n_seq) {
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.b1 = b1;
  a.b2 = b2;
  a.lse = lse;
  a.N = N;
  a.R = R;
  a.H = H;
  a.n_seq = n_seq;
  a.scale = 1.0f / sqrtf((float)d);
  return a;
}

}  // namespace

extern "C" {

// out [N, R, H, d] in q's dtype, lse [N, H, R] fp32. b1 / b2 may be null;
// n_seq = N / G (rows per bias2 group; N when b2 is null). On the tensor
// cores: bf16 / fp16 (dtype 0 / 1) only.
int ds_evo_fwd(const void* q, const void* k, const void* v, const float* b1, const float* b2,
               void* out, float* lse, int N, int R, int H, int d, int n_seq, int dtype,
               void* stream) {
  Args a = make_args(q, k, v, b1, b2, lse, N, R, H, d, n_seq);
  a.out = out;
  return (int)dispatch(kFwdMma, a, d, dtype, (cudaStream_t)stream);
}

// The same on the CUDA cores in fp32: fp32 (dtype 2) only.
int ds_evo_fwd_fp32(const void* q, const void* k, const void* v, const float* b1,
                    const float* b2, void* out, float* lse, int N, int R, int H, int d, int n_seq,
                    int dtype, void* stream) {
  Args a = make_args(q, k, v, b1, b2, lse, N, R, H, d, n_seq);
  a.out = out;
  return (int)dispatch(kFwd, a, d, dtype, (cudaStream_t)stream);
}

// dq [N, R, H, d] in q's dtype, on the tensor cores (bf16 / fp16 only).
int ds_evo_bwd_dq(const void* q, const void* k, const void* v, const void* o, const void* dout,
                  const float* lse, const float* b1, const float* b2, void* dq, int N, int R,
                  int H, int d, int n_seq, int dtype, void* stream) {
  Args a = make_args(q, k, v, b1, b2, const_cast<float*>(lse), N, R, H, d, n_seq);
  a.o = o;
  a.dout = dout;
  a.out = dq;
  return (int)dispatch(kDqMma, a, d, dtype, (cudaStream_t)stream);
}

// The same on the CUDA cores in fp32: fp32 (dtype 2) only.
int ds_evo_bwd_dq_fp32(const void* q, const void* k, const void* v, const void* o,
                       const void* dout, const float* lse, const float* b1, const float* b2,
                       void* dq, int N, int R, int H, int d, int n_seq, int dtype, void* stream) {
  Args a = make_args(q, k, v, b1, b2, const_cast<float*>(lse), N, R, H, d, n_seq);
  a.o = o;
  a.dout = dout;
  a.out = dq;
  return (int)dispatch(kDq, a, d, dtype, (cudaStream_t)stream);
}

// dk, dv [N, R, H, d] in k's dtype; db1 [N, R] fp32 when not null (the
// mask bias's gradient, summed over heads and queries). On the tensor
// cores: bf16 / fp16 (dtype 0 / 1) only.
int ds_evo_bwd_dkdv(const void* q, const void* k, const void* v, const void* o, const void* dout,
                    const float* lse, const float* b1, const float* b2, void* dk, void* dv,
                    float* db1, int N, int R, int H, int d, int n_seq, int dtype, void* stream) {
  Args a = make_args(q, k, v, b1, b2, const_cast<float*>(lse), N, R, H, d, n_seq);
  a.o = o;
  a.dout = dout;
  a.dk = dk;
  a.dv = dv;
  a.db1 = db1;
  return (int)dispatch(kDkdvMma, a, d, dtype, (cudaStream_t)stream);
}

// The same on the CUDA cores in fp32: fp32 (dtype 2) only.
int ds_evo_bwd_dkdv_fp32(const void* q, const void* k, const void* v, const void* o,
                         const void* dout, const float* lse, const float* b1, const float* b2,
                         void* dk, void* dv, float* db1, int N, int R, int H, int d, int n_seq,
                         int dtype, void* stream) {
  Args a = make_args(q, k, v, b1, b2, const_cast<float*>(lse), N, R, H, d, n_seq);
  a.o = o;
  a.dout = dout;
  a.dk = dk;
  a.dv = dv;
  a.db1 = db1;
  return (int)dispatch(kDkdv, a, d, dtype, (cudaStream_t)stream);
}

// db2 [G, H, R, R] fp32, G = N / n_seq: the pair bias's gradient, summed
// over each group's rows, on the tensor cores (bf16 / fp16 only). The rows
// of a group are split into n_chunks (1 .. n_seq) chunks; with more than
// one, each chunk's partial goes to scratch [n_chunks, G, H, R, R] fp32
// and a second launch on the same stream sums them in chunk order.
int ds_evo_bwd_db2(const void* q, const void* k, const void* v, const void* o, const void* dout,
                   const float* lse, const float* b1, const float* b2, float* db2,
                   float* scratch, int N, int R, int H, int d, int n_seq, int n_chunks,
                   int dtype, void* stream) {
  if (b2 == nullptr || n_chunks < 1 || n_chunks > n_seq || (n_chunks > 1 && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  Args a = make_args(q, k, v, b1, b2, const_cast<float*>(lse), N, R, H, d, n_seq);
  a.o = o;
  a.dout = dout;
  a.db2 = db2;
  const cudaError_t e = dispatch(kDb2Mma, a, d, dtype, (cudaStream_t)stream, scratch, n_chunks);
  if (e != cudaSuccess || n_chunks == 1) return (int)e;
  const long long total = (long long)(N / n_seq) * H * R * R;
  const long long work = total % 4 == 0 ? total / 4 : total;
  return (int)launch_kernel(evo_db2_sum_kernel, std::min(work / 256 + 1, 132LL * 16), 256, 0,
                            (cudaStream_t)stream, (const float*)scratch, db2, total, n_chunks);
}

// The first version on the CUDA cores in fp32 (fp32 only): one CTA per
// (query tile, key tile, head, group) walks all the group's rows.
int ds_evo_bwd_db2_fp32(const void* q, const void* k, const void* v, const void* o,
                        const void* dout, const float* lse, const float* b1, const float* b2,
                        float* db2, int N, int R, int H, int d, int n_seq, int dtype,
                        void* stream) {
  Args a = make_args(q, k, v, b1, b2, const_cast<float*>(lse), N, R, H, d, n_seq);
  a.o = o;
  a.dout = dout;
  a.db2 = db2;
  return (int)dispatch(kDb2, a, d, dtype, (cudaStream_t)stream);
}

const char* ds_evo_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// Dynamic shared memory of one CTA: kind 0 forward, 1 dq, 2 dk/dv and 3 db2
// (fp32 route), 4 dk/dv, 5 db2, 6 forward and 7 dq (tensor cores).
long long ds_evo_smem_bytes(int kind, int d) { return (long long)smem_bytes(kind, d); }

}  // extern "C"
