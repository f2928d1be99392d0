// Flash attention for training (forward and both backward passes), for
// Hopper (sm_90a).
//
// Plain C interface (loaded with ctypes by ops/_build.py); every launcher
// returns the cudaError_t of its launch and never synchronises.
//
// What it replaces (deepspeed_tpu/ops/pallas/flash_attention.py):
//   ds_flash_fwd      -> _flash_fwd_impl (:237): out and lse = m + log(l)
//   ds_flash_bwd_dkdv -> _flash_bwd_impl's dkdv_kernel (:414), GQA group sum
//                        done inside the CTA instead of fp32 per-q-head
//                        buffers summed afterwards (:472-473, :536-538)
//   ds_flash_bwd_dq   -> _flash_bwd_impl's dq_kernel (:483)
//
// Semantics copied from the TPU kernels. q, k, v are [B, S, n, D] (GQA: the
// g = nq / nkv query heads of kv head h / g share it), read in that order
// with no transposes. Forward: q is pre-scaled by 1/sqrt(D) (:285); masked
// scores are -1e30, the online softmax starts at m = -1e30, l = 0, and the
// output is acc / max(l, 1e-30) with lse = m + log(max(l, 1e-30)) (:318).
// Backward: s = scale * q.k (:396), p = exp(s - lse), dp = dO.v,
// delta = rowsum(dO * O) from the stored output, ds = p * (dp - delta);
// dv = sum p^T dO, dk = scale * sum ds^T q, dq = scale * sum ds k. ALiBi adds
// slope[head] * (k_pos - q_pos) before the mask; causal keeps k <= q and a
// window keeps q - k < window. Tiles that hold no visible position are not
// visited (the TPU kernels' pl.when predicates and kv_index clamps become
// loop bounds). Ragged S: positions past S are masked inside the kernels
// (zero-loaded tiles, p = 0), so any length works.
//
// What bounds it on the H100: at the training shapes (S 4096, d 128) every
// kernel does ~64 FLOPs per byte it must move, so the bound is the tensor
// cores' 989 TFLOP/s. This first version is deliberately simple: it runs
// its products on the CUDA cores in fp32 (67 TFLOP/s peak), from tiles of
// 64 query rows x 64 key rows staged in shared memory as fp32; each of 256
// threads owns a 4 x 4 block of the score tile and a 4-row slice of the
// output tile, with 16-byte shared-memory reads. Tensor-core (mma / wgmma)
// products and TMA-fed tiles are later work, measured against the bound.
//
// Offsets are int64 throughout.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;  // query rows per tile
constexpr int kBK = 64;  // key rows per tile
constexpr int kLP = kBK + 4;  // padded row of a [kBQ][kBK] probability tile
constexpr float kMask = -1e30f;

__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }
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

template <typename T>
__device__ __forceinline__ void load8(const T* p, float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const T* h = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) out[i] = to_f(h[i]);
}

__device__ __forceinline__ void store8(float* dst, const float* f) {
  reinterpret_cast<float4*>(dst)[0] = make_float4(f[0], f[1], f[2], f[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(f[4], f[5], f[6], f[7]);
}

struct Args {
  const void* q;     // [B, S, nq, D]
  const void* k;     // [B, S, nkv, D]
  const void* v;
  const void* o;     // [B, S, nq, D] (backward)
  const void* dout;  // [B, S, nq, D] (backward)
  float* lse;        // [B, nq, S] fp32 (written by fwd, read by bwd)
  const float* slopes;  // [nq] ALiBi slopes or null
  void* out;         // fwd: out [B, S, nq, D]; dq: dq
  void* dk;          // [B, S, nkv, D]
  void* dv;
  int B, S, nq, nkv, causal, window;
  float scale;
};

// Live tile ranges (inclusive) of the causal / window predicates.
__device__ __forceinline__ void live_k_tiles(const Args& a, int q0, int* lo, int* hi) {
  *lo = 0;
  *hi = (a.S - 1) / kBK;
  if (a.causal) {
    *hi = min(*hi, (min(q0 + kBQ, a.S) - 1) / kBK);
    if (a.window > 0) {
      const int x = q0 - (a.window - 1);
      *lo = x > 0 ? x / kBK : 0;
    }
  }
}

__device__ __forceinline__ void live_q_tiles(const Args& a, int k0, int* lo, int* hi) {
  *lo = 0;
  *hi = (a.S - 1) / kBQ;
  if (a.causal) {
    *lo = k0 / kBQ;
    if (a.window > 0) *hi = min(*hi, (k0 + kBK - 1 + a.window - 1) / kBQ);
  }
}

// Score of (query qpos, key kpos): the ALiBi bias, then the mask.
__device__ __forceinline__ float mask_score(const Args& a, float s, float slope, int qpos,
                                            int kpos, bool* vis) {
  if (a.slopes != nullptr) s += slope * (float)(kpos - qpos);
  bool ok = kpos < a.S && qpos < a.S;
  if (a.causal) {
    ok = ok && kpos <= qpos;
    if (a.window > 0) ok = ok && (qpos - kpos < a.window);
  }
  *vis = ok;
  return ok ? s : kMask;
}

// Stage `rows` rows of a [.., n, D] tensor (row stride `ld` elements), from
// row r0, into an fp32 [kBQ][D + 4] tile, times `mul`; rows past S are zero.
template <int D, typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src, long long ld, int r0, int S,
                                          float mul) {
  constexpr int LD = D + 4;
  for (int c = threadIdx.x; c < kBQ * (D / 8); c += kThreads) {
    const int r = c / (D / 8), c8 = (c % (D / 8)) * 8;
    float f[8];
    if (r0 + r < S) {
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

// The backward's query side of one (head, q-tile): q and dO as fp32 tiles,
// lse, and delta = rowsum(dO * O) from the stored output (the TPU kernels'
// :395), each row reduced over the D / 8 consecutive threads that load it.
template <int D, typename T>
__device__ __forceinline__ void load_q_side(const Args& a, int b, int h, int q0, float* sQ,
                                            float* sdO, float* sLse, float* sDelta) {
  constexpr int LD = D + 4;
  const long long ld = (long long)a.nq * D;
  const long long base = (long long)b * a.S * ld + (long long)h * D;
  const T* qp = reinterpret_cast<const T*>(a.q) + base;
  const T* op = reinterpret_cast<const T*>(a.o) + base;
  const T* dp = reinterpret_cast<const T*>(a.dout) + base;
  const float* lse = a.lse + ((long long)b * a.nq + h) * a.S;
  for (int c = threadIdx.x; c < kBQ * (D / 8); c += kThreads) {
    const int r = c / (D / 8), c8 = (c % (D / 8)) * 8;
    const int qpos = q0 + r;
    float fq[8], fo[8], fd[8];
    if (qpos < a.S) {
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
      sLse[r] = qpos < a.S ? lse[qpos] : 0.f;
    }
  }
}

// acc[i][j] += sum_d A[ra_i][d] * B[rb_j][d] over fp32 tiles of row length
// D + 4, rows ra_i = ty + 16 i, rb_j = tx + 16 j.
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

// out[i][n] (float4 at column tx*4 + 64 n of row ro_i = ty + 16 i) +=
// sum_r W[r][ro_i] (transposed) or W[ro_i][r] * M[r][col], over 64 rows r.
template <int D, bool TRANS>
__device__ __forceinline__ void tile_mm(float4 (&out)[4][D / 64], const float* W, const float* M,
                                        int ty, int tx) {
  constexpr int LD = D + 4;
  constexpr int NC = D / 64;
#pragma unroll 2
  for (int r = 0; r < 64; ++r) {
    float4 mv[NC];
#pragma unroll
    for (int n = 0; n < NC; ++n) mv[n] = *reinterpret_cast<const float4*>(M + r * LD + tx * 4 + 64 * n);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float w = TRANS ? W[r * kLP + ty + 16 * i] : W[(ty + 16 * i) * kLP + r];
#pragma unroll
      for (int n = 0; n < NC; ++n) {
        out[i][n].x = fmaf(w, mv[n].x, out[i][n].x);
        out[i][n].y = fmaf(w, mv[n].y, out[i][n].y);
        out[i][n].z = fmaf(w, mv[n].z, out[i][n].z);
        out[i][n].w = fmaf(w, mv[n].w, out[i][n].w);
      }
    }
  }
}

template <int D, typename T>
__device__ __forceinline__ void store_rows(void* dst, long long ld, long long base, int r0, int S,
                                           float4 (&acc)[4][D / 64], float mul, int ty, int tx) {
  T* p = reinterpret_cast<T*>(dst) + base;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + ty + 16 * i;
    if (row >= S) continue;
#pragma unroll
    for (int n = 0; n < D / 64; ++n) {
      T* q = p + (long long)row * ld + tx * 4 + 64 * n;
      q[0] = from_f<T>(acc[i][n].x * mul);
      q[1] = from_f<T>(acc[i][n].y * mul);
      q[2] = from_f<T>(acc[i][n].z * mul);
      q[3] = from_f<T>(acc[i][n].w * mul);
    }
  }
}

// ---------------------------------------------------------------------------
// forward: one CTA per (q-tile, q-head, batch); heavy (late) q-tiles first
// ---------------------------------------------------------------------------
template <int D, typename T>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(const Args a) {
  constexpr int LD = D + 4;
  constexpr int NC = D / 64;
  const int qt = gridDim.x - 1 - blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (a.nq / a.nkv);
  const int q0 = qt * kBQ;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;             // [kBQ][LD], pre-scaled q
  float* sK = sQ + kBQ * LD;    // [kBK][LD]; reused for P [kBQ][kLP]
  float* sV = sK + kBK * LD;    // [kBK][LD]

  const long long ldq = (long long)a.nq * D, ldk = (long long)a.nkv * D;
  const long long qbase = (long long)b * a.S * ldq + (long long)h * D;
  const long long kbase = (long long)b * a.S * ldk + (long long)kvh * D;
  const T* kp = reinterpret_cast<const T*>(a.k) + kbase;
  const T* vp = reinterpret_cast<const T*>(a.v) + kbase;
  load_tile<D, T>(sQ, reinterpret_cast<const T*>(a.q) + qbase, ldq, q0, a.S, a.scale);
  const float slope = a.slopes != nullptr ? a.slopes[h] : 0.f;

  float m[4], l[4];
  float4 acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kMask;
    l[i] = 0.f;
#pragma unroll
    for (int n = 0; n < NC; ++n) acc[i][n] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  int kt_lo, kt_hi;
  live_k_tiles(a, q0, &kt_lo, &kt_hi);

  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's readers of sK (as P) and sV are done
    load_tile<D, T>(sK, kp, ldk, k0, a.S, 1.f);
    load_tile<D, T>(sV, vp, ldk, k0, a.S, 1.f);
    __syncthreads();
    float s[4][4] = {};
    tile_dot<D>(s, sQ, sK, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float mx = kMask;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        bool vis;
        s[i][j] = mask_score(a, s[i][j], slope, qpos, k0 + tx + 16 * j, &vis);
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // a key past S never enters: it is not a position (a masked real
        // key does, with weight exp(-1e30 - m), as in the TPU kernel)
        s[i][j] = k0 + tx + 16 * j < a.S ? expf(s[i][j] - m_new) : 0.f;
        sum += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int n = 0; n < NC; ++n) {
        acc[i][n].x *= alpha;
        acc[i][n].y *= alpha;
        acc[i][n].z *= alpha;
        acc[i][n].w *= alpha;
      }
    }
    __syncthreads();  // every thread is done reading sK
    float* sP = sK;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sP[(ty + 16 * i) * kLP + tx + 16 * j] = s[i][j];
    __syncthreads();
    tile_mm<D, false>(acc, sP, sV, ty, tx);
  }

  T* op = reinterpret_cast<T*>(a.out) + qbase;
  float* lse = a.lse + ((long long)b * a.nq + h) * a.S;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty + 16 * i;
    if (qpos >= a.S) continue;
    const float l_safe = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      T* dst = op + (long long)qpos * ldq + tx * 4 + 64 * n;
      dst[0] = from_f<T>(acc[i][n].x / l_safe);
      dst[1] = from_f<T>(acc[i][n].y / l_safe);
      dst[2] = from_f<T>(acc[i][n].z / l_safe);
      dst[3] = from_f<T>(acc[i][n].w / l_safe);
    }
    if (tx == 0) lse[qpos] = m[i] + logf(l_safe);
  }
}

// p and ds of one (q-tile, k-tile) pair into sP / sdS, rows q = ty + 16 i,
// columns k = tx + 16 j. Positions past S, and masked ones, get p = 0.
template <int D>
__device__ __forceinline__ void bwd_tile_probs(const Args& a, float slope, int q0, int k0,
                                               const float* sQ, const float* sdO, const float* sK,
                                               const float* sV, const float* sLse,
                                               const float* sDelta, float* sP, float* sdS, int ty,
                                               int tx) {
  float s[4][4] = {}, dp[4][4] = {};
  tile_dot<D>(s, sQ, sK, ty, tx);
  tile_dot<D>(dp, sdO, sV, ty, tx);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const float lse = sLse[r], delta = sDelta[r];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      bool vis;
      const float x = mask_score(a, a.scale * s[i][j], slope, q0 + r, k0 + tx + 16 * j, &vis);
      const float p = vis ? expf(x - lse) : 0.f;
      if (sP != nullptr) sP[r * kLP + tx + 16 * j] = p;
      sdS[r * kLP + tx + 16 * j] = p * (dp[i][j] - delta);
    }
  }
}

// ---------------------------------------------------------------------------
// dk/dv: one CTA per (k-tile, kv-head, batch), looping over the group's
// q-heads and their live q-tiles
// ---------------------------------------------------------------------------
template <int D, typename T>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkdv_kernel(const Args a) {
  constexpr int LD = D + 4;
  constexpr int NC = D / 64;
  const int kt = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int g = a.nq / a.nkv;
  const int k0 = kt * kBK;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  extern __shared__ __align__(16) float smem[];
  float* sK = smem;
  float* sV = sK + kBK * LD;
  float* sQ = sV + kBK * LD;
  float* sdO = sQ + kBQ * LD;
  float* sP = sdO + kBQ * LD;   // [kBQ][kLP]
  float* sdS = sP + kBQ * kLP;  // [kBQ][kLP]
  float* sLse = sdS + kBQ * kLP;
  float* sDelta = sLse + kBQ;

  const long long ldk = (long long)a.nkv * D;
  const long long kbase = (long long)b * a.S * ldk + (long long)kvh * D;
  load_tile<D, T>(sK, reinterpret_cast<const T*>(a.k) + kbase, ldk, k0, a.S, 1.f);
  load_tile<D, T>(sV, reinterpret_cast<const T*>(a.v) + kbase, ldk, k0, a.S, 1.f);

  float4 dk[4][NC], dv[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int n = 0; n < NC; ++n) dk[i][n] = dv[i][n] = make_float4(0.f, 0.f, 0.f, 0.f);
  int qt_lo, qt_hi;
  live_q_tiles(a, k0, &qt_lo, &qt_hi);

  for (int hh = 0; hh < g; ++hh) {
    const int h = kvh * g + hh;
    const float slope = a.slopes != nullptr ? a.slopes[h] : 0.f;
    for (int qt = qt_lo; qt <= qt_hi; ++qt) {
      const int q0 = qt * kBQ;
      __syncthreads();  // the previous pair's readers are done
      load_q_side<D, T>(a, b, h, q0, sQ, sdO, sLse, sDelta);
      __syncthreads();
      bwd_tile_probs<D>(a, slope, q0, k0, sQ, sdO, sK, sV, sLse, sDelta, sP, sdS, ty, tx);
      __syncthreads();
      tile_mm<D, true>(dv, sP, sdO, ty, tx);   // dv[k] += sum_q p[q][k] dO[q]
      tile_mm<D, true>(dk, sdS, sQ, ty, tx);   // dk[k] += sum_q ds[q][k] q[q]
    }
  }
  store_rows<D, T>(a.dk, ldk, kbase, k0, a.S, dk, a.scale, ty, tx);
  store_rows<D, T>(a.dv, ldk, kbase, k0, a.S, dv, 1.f, ty, tx);
}

// ---------------------------------------------------------------------------
// dq: one CTA per (q-tile, q-head, batch), looping over live k-tiles
// ---------------------------------------------------------------------------
template <int D, typename T>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(const Args a) {
  constexpr int LD = D + 4;
  constexpr int NC = D / 64;
  const int qt = gridDim.x - 1 - blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (a.nq / a.nkv);
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

  load_q_side<D, T>(a, b, h, q0, sQ, sdO, sLse, sDelta);
  const float slope = a.slopes != nullptr ? a.slopes[h] : 0.f;
  const long long ldk = (long long)a.nkv * D, ldq = (long long)a.nq * D;
  const long long kbase = (long long)b * a.S * ldk + (long long)kvh * D;
  const T* kp = reinterpret_cast<const T*>(a.k) + kbase;
  const T* vp = reinterpret_cast<const T*>(a.v) + kbase;

  float4 dq[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int n = 0; n < NC; ++n) dq[i][n] = make_float4(0.f, 0.f, 0.f, 0.f);
  int kt_lo, kt_hi;
  live_k_tiles(a, q0, &kt_lo, &kt_hi);

  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();
    load_tile<D, T>(sK, kp, ldk, k0, a.S, 1.f);
    load_tile<D, T>(sV, vp, ldk, k0, a.S, 1.f);
    __syncthreads();
    bwd_tile_probs<D>(a, slope, q0, k0, sQ, sdO, sK, sV, sLse, sDelta, nullptr, sdS, ty, tx);
    __syncthreads();
    tile_mm<D, false>(dq, sdS, sK, ty, tx);  // dq[q] += sum_k ds[q][k] k[k]
  }
  store_rows<D, T>(a.out, ldq, (long long)b * a.S * ldq + (long long)h * D, q0, a.S, dq,
                   a.scale, ty, tx);
}

enum Kind { kFwd = 0, kDkdv = 1, kDq = 2 };

__host__ __device__ inline size_t smem_bytes(int kind, int d) {
  const size_t tile = (size_t)64 * (d + 4);
  const size_t ptile = (size_t)kBQ * kLP;
  if (kind == kFwd) return 3 * tile * sizeof(float);
  if (kind == kDkdv) return (4 * tile + 2 * ptile + 2 * kBQ) * sizeof(float);
  return (4 * tile + ptile + 2 * kBQ) * sizeof(float);
}

template <int D, typename T>
cudaError_t launch(int kind, const Args& a, cudaStream_t stream) {
  const size_t bytes = smem_bytes(kind, D);
  void (*kern)(const Args);
  dim3 grid;
  if (kind == kFwd) {
    kern = flash_fwd_kernel<D, T>;
    grid = dim3((a.S + kBQ - 1) / kBQ, a.nq, a.B);
  } else if (kind == kDkdv) {
    kern = flash_bwd_dkdv_kernel<D, T>;
    grid = dim3((a.S + kBK - 1) / kBK, a.nkv, a.B);
  } else {
    kern = flash_bwd_dq_kernel<D, T>;
    grid = dim3((a.S + kBQ - 1) / kBQ, a.nq, a.B);
  }
  if (bytes > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return e;
  }
  kern<<<grid, kThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t dispatch(int kind, const Args& a, int d, int half, cudaStream_t stream) {
  if (a.S < 1 || a.B < 1 || a.nkv < 1 || a.nq % a.nkv != 0 || a.B > 65535 || a.nq > 65535)
    return cudaErrorInvalidValue;
  if (d == 128) return half ? launch<128, __half>(kind, a, stream)
                            : launch<128, __nv_bfloat16>(kind, a, stream);
  if (d == 64) return half ? launch<64, __half>(kind, a, stream)
                           : launch<64, __nv_bfloat16>(kind, a, stream);
  return cudaErrorInvalidValue;
}

Args make_args(const void* q, const void* k, const void* v, const float* slopes, int B, int S,
               int nq, int nkv, int d, int causal, int window) {
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.slopes = slopes;
  a.B = B;
  a.S = S;
  a.nq = nq;
  a.nkv = nkv;
  a.causal = causal;
  a.window = causal ? window : 0;
  a.scale = 1.0f / sqrtf((float)d);
  return a;
}

}  // namespace

extern "C" {

// out [B, S, nq, d] in q's dtype, lse [B, nq, S] fp32. half = 1 for fp16,
// 0 for bf16; window <= 0 is no window (and is ignored without causal).
int ds_flash_fwd(const void* q, const void* k, const void* v, const float* slopes, void* out,
                 float* lse, int B, int S, int nq, int nkv, int d, int causal, int window,
                 int half, void* stream) {
  Args a = make_args(q, k, v, slopes, B, S, nq, nkv, d, causal, window);
  a.out = out;
  a.lse = lse;
  return (int)dispatch(kFwd, a, d, half, (cudaStream_t)stream);
}

// dk, dv [B, S, nkv, d] in k's dtype, each the sum over the kv head's group.
int ds_flash_bwd_dkdv(const void* q, const void* k, const void* v, const void* o,
                      const void* dout, const float* lse, const float* slopes, void* dk, void* dv,
                      int B, int S, int nq, int nkv, int d, int causal, int window, int half,
                      void* stream) {
  Args a = make_args(q, k, v, slopes, B, S, nq, nkv, d, causal, window);
  a.o = o;
  a.dout = dout;
  a.lse = const_cast<float*>(lse);
  a.dk = dk;
  a.dv = dv;
  return (int)dispatch(kDkdv, a, d, half, (cudaStream_t)stream);
}

// dq [B, S, nq, d] in q's dtype.
int ds_flash_bwd_dq(const void* q, const void* k, const void* v, const void* o, const void* dout,
                    const float* lse, const float* slopes, void* dq, int B, int S, int nq, int nkv,
                    int d, int causal, int window, int half, void* stream) {
  Args a = make_args(q, k, v, slopes, B, S, nq, nkv, d, causal, window);
  a.o = o;
  a.dout = dout;
  a.lse = const_cast<float*>(lse);
  a.out = dq;
  return (int)dispatch(kDq, a, d, half, (cudaStream_t)stream);
}

const char* ds_flash_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// Dynamic shared memory of one CTA: kind 0 forward, 1 dk/dv, 2 dq.
long long ds_flash_smem_bytes(int kind, int d) { return (long long)smem_bytes(kind, d); }

}  // extern "C"
