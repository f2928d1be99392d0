// Evoformer attention (DS4Sci_EvoformerAttention): the biased flash forward
// and its backward with both bias gradients, for Hopper (sm_90a).
//
// Plain C interface (loaded with ctypes by ops/_build.py); every launcher
// returns the cudaError_t of its launch and never synchronises.
//
// What it replaces (deepspeed_tpu/ops/pallas/evoformer_attention.py):
//   ds_evo_fwd      -> _evo_fwd_impl (:113): out and lse = m + log(l)
//   ds_evo_bwd_dq   -> _evo_bwd_impl's dq_kernel (:231)
//   ds_evo_bwd_dkdv -> dkdv_kernel (:265) and db1_kernel (:346): one CTA per
//                      (sequence row n, key tile) walks every head and query
//                      tile, writes dk / dv per head and sums db1 over
//                      (head, query) in registers, written once
//   ds_evo_bwd_db2  -> db2_kernel (:306): one CTA per (group, head, query
//                      tile, key tile) walks the group's n_seq rows
// The TPU package runs db1 and db2 as passes of their own only because a
// TPU grid runs in order and an output block accumulates across consecutive
// revisits alone. Here every sum is a loop inside one CTA: no atomics, and
// the results do not depend on scheduling.
//
// Semantics copied from the TPU kernels. q, k, v, out, dout are [N, R, H, D]
// (read in that layout, no transposes); bias1 [N, R] fp32 (the mask bias)
// and bias2 [G, H, R, R] fp32 (the pair bias, shared by the n_seq = N / G
// rows of a group: row n reads group n / n_seq) may each be absent.
// Forward: q is pre-scaled by 1/sqrt(D) (:145); s = (q.k + b2) + b1 in that
// order (:149); the online softmax starts at m = -1e30, l = 0; the output is
// acc / max(l, 1e-30) and lse = m + log(max(l, 1e-30)) (:160-162), so a row
// whose biases are all -inf writes 0. Backward (block_math, :214-228):
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
// tensor cores' operations bound come close to it. This first version is
// deliberately simple: it runs its products on the CUDA cores in fp32 (67
// TFLOP/s peak), from tiles of 64 query rows x 64 key rows staged in shared
// memory as fp32; each of 256 threads owns a 4 x 4 block of the score tile
// (rows ty + 16 i, keys tx + 16 j) and D / 16 rows of one float4 column of
// the output tile. mma / wgmma products and TMA-fed tiles are later work.
//
// Offsets are int64 throughout.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

enum Kind { kFwd = 0, kDq = 1, kDkdv = 2, kDb2 = 3 };

__host__ __device__ inline size_t smem_bytes(int kind, int d) {
  const size_t tile = (size_t)64 * (d + 4);
  const size_t ptile = (size_t)kBQ * kLP;
  if (kind == kFwd) return (3 * tile + ptile + kBQ) * sizeof(float);
  if (kind == kDq) return (4 * tile + ptile + 2 * kBQ) * sizeof(float);
  if (kind == kDkdv) return (4 * tile + 2 * ptile + 2 * kBQ) * sizeof(float);
  return (4 * tile + 2 * kBQ) * sizeof(float);
}

template <int D, typename T>
cudaError_t launch(int kind, const Args& a, cudaStream_t stream) {
  const size_t bytes = smem_bytes(kind, D);
  const long long nt = (a.R + kBQ - 1) / kBQ;
  void (*kern)(const Args);
  long long blocks;
  if (kind == kFwd) {
    kern = evo_fwd_kernel<D, T>;
    blocks = nt * a.H * a.N;
  } else if (kind == kDq) {
    kern = evo_bwd_dq_kernel<D, T>;
    blocks = nt * a.H * a.N;
  } else if (kind == kDkdv) {
    kern = evo_bwd_dkdv_kernel<D, T>;
    blocks = nt * a.N;
  } else {
    kern = evo_bwd_db2_kernel<D, T>;
    blocks = nt * nt * a.H * (a.N / a.n_seq);
  }
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (bytes > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return e;
  }
  kern<<<(unsigned)blocks, kThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

// dtype: 0 bf16, 1 fp16, 2 fp32.
template <int D>
cudaError_t by_dtype(int kind, const Args& a, int dtype, cudaStream_t stream) {
  if (dtype == 0) return launch<D, __nv_bfloat16>(kind, a, stream);
  if (dtype == 1) return launch<D, __half>(kind, a, stream);
  if (dtype == 2) return launch<D, float>(kind, a, stream);
  return cudaErrorInvalidValue;
}

cudaError_t dispatch(int kind, const Args& a, int d, int dtype, cudaStream_t stream) {
  if (a.N < 1 || a.R < 1 || a.H < 1 || a.n_seq < 1 || a.N % a.n_seq != 0)
    return cudaErrorInvalidValue;
  if (d == 32) return by_dtype<32>(kind, a, dtype, stream);
  if (d == 64) return by_dtype<64>(kind, a, dtype, stream);
  if (d == 128) return by_dtype<128>(kind, a, dtype, stream);
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
// n_seq = N / G (rows per bias2 group; N when b2 is null).
int ds_evo_fwd(const void* q, const void* k, const void* v, const float* b1, const float* b2,
               void* out, float* lse, int N, int R, int H, int d, int n_seq, int dtype,
               void* stream) {
  Args a = make_args(q, k, v, b1, b2, lse, N, R, H, d, n_seq);
  a.out = out;
  return (int)dispatch(kFwd, a, d, dtype, (cudaStream_t)stream);
}

// dq [N, R, H, d] in q's dtype.
int ds_evo_bwd_dq(const void* q, const void* k, const void* v, const void* o, const void* dout,
                  const float* lse, const float* b1, const float* b2, void* dq, int N, int R,
                  int H, int d, int n_seq, int dtype, void* stream) {
  Args a = make_args(q, k, v, b1, b2, const_cast<float*>(lse), N, R, H, d, n_seq);
  a.o = o;
  a.dout = dout;
  a.out = dq;
  return (int)dispatch(kDq, a, d, dtype, (cudaStream_t)stream);
}

// dk, dv [N, R, H, d] in k's dtype; db1 [N, R] fp32 when not null (the
// mask bias's gradient, summed over heads and queries).
int ds_evo_bwd_dkdv(const void* q, const void* k, const void* v, const void* o, const void* dout,
                    const float* lse, const float* b1, const float* b2, void* dk, void* dv,
                    float* db1, int N, int R, int H, int d, int n_seq, int dtype, void* stream) {
  Args a = make_args(q, k, v, b1, b2, const_cast<float*>(lse), N, R, H, d, n_seq);
  a.o = o;
  a.dout = dout;
  a.dk = dk;
  a.dv = dv;
  a.db1 = db1;
  return (int)dispatch(kDkdv, a, d, dtype, (cudaStream_t)stream);
}

// db2 [G, H, R, R] fp32, G = N / n_seq: the pair bias's gradient, summed
// over each group's rows.
int ds_evo_bwd_db2(const void* q, const void* k, const void* v, const void* o, const void* dout,
                   const float* lse, const float* b1, const float* b2, float* db2, int N, int R,
                   int H, int d, int n_seq, int dtype, void* stream) {
  Args a = make_args(q, k, v, b1, b2, const_cast<float*>(lse), N, R, H, d, n_seq);
  a.o = o;
  a.dout = dout;
  a.db2 = db2;
  return (int)dispatch(kDb2, a, d, dtype, (cudaStream_t)stream);
}

const char* ds_evo_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// Dynamic shared memory of one CTA: kind 0 forward, 1 dq, 2 dk/dv, 3 db2.
long long ds_evo_smem_bytes(int kind, int d) { return (long long)smem_bytes(kind, d); }

}  // extern "C"
